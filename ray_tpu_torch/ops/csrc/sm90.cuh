// Hopper (sm_90a) building blocks shared by the bf16 flash kernels:
// mbarriers, TMA tile loads, wgmma shared-memory descriptors and the
// wgmma instructions themselves, all as inline PTX; on the host, the
// routes' names and the tensor map of a strided [B, L, H, D] bf16 view.
//
// Shared-memory tiles are 64 rows of 128 bytes (64 bf16), written by TMA
// with the 128-byte swizzle (the 16-byte chunk c of row r lands at chunk
// c ^ (r % 8)), each tile 1024-byte aligned.  A head dimension of 128 is
// two such tiles ("slabs") side by side: columns 0-63, then 64-127.  The
// wgmma descriptors below describe exactly that layout.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

constexpr int kTileRows = 64;                    // rows of every tile
constexpr int kSlabBytes = kTileRows * 128;      // one 64 x 64 bf16 slab
constexpr uint32_t kSwizzleAtomBytes = 1024;     // 8 rows of 128 bytes

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------- mbarrier
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arrive once and add `bytes` to the transaction count that the TMA
// copies of this phase will complete.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// Wait until the phase with this parity has completed.  A copy that never
// lands (a tensor map the hardware refused) traps after ~4M tries, far
// beyond any real wait, so the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  for (uint32_t tries = 0;; ++tries) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (done) return;
    if (tries == (1u << 22)) __trap();
  }
}

// --------------------------------------------------------------------- TMA
// One box of the 4-D tensor map (coordinates innermost first: d, h, l, b)
// into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// A contiguous run of `bytes` (a multiple of 16, both ends 16-byte
// aligned) into shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// ------------------------------------------------------------------- wgmma
// Shared-memory matrix descriptor, 128-byte swizzle.  Offsets in bytes.
__device__ __forceinline__ uint64_t make_desc(uint32_t smem_addr,
                                              uint32_t lbo, uint32_t sbo) {
  uint64_t desc = (smem_addr & 0x3FFFF) >> 4;
  desc |= static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16;
  desc |= static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32;
  desc |= 1ull << 62;  // 128-byte swizzle
  return desc;
}

// Operand whose K runs along the 128-byte rows (K-major): rows are M or N.
// Step k (16 columns, 32 bytes) of a tile whose D = 64 * slabs columns lie
// in `slabs` slabs of kSlabBytes.  The swizzle is a function of the
// address, so a step inside the 128-byte row is a plain byte offset.
__device__ __forceinline__ uint64_t desc_kmajor(const void* tile, int k) {
  const uint32_t addr = smem_u32(tile) + (k / 4) * kSlabBytes + (k % 4) * 32;
  return make_desc(addr, 16, kSwizzleAtomBytes);
}

// Operand whose K runs down the rows (MN-major): the rows are K and the
// 128-byte row holds 64 of N; N beyond 64 is the next slab (leading byte
// offset), K beyond 8 rows the next swizzle atom (stride byte offset).
// Step k covers rows 16k .. 16k + 15.
__device__ __forceinline__ uint64_t desc_mnmajor(const void* tile, int k) {
  const uint32_t addr = smem_u32(tile) + k * 16 * 128;
  return make_desc(addr, kSlabBytes, kSwizzleAtomBytes);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N committed groups are still in flight (groups
// complete in order).
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// 2^x on the special-function unit (flush-to-zero; relative error about
// 2^-22), as the softmax of both bf16 kernels uses it.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it (it cannot see the dependency).
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

template <int N>
__device__ __forceinline__ void fence_operands(uint32_t (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(a[i]) :: "memory");
}

// Two fp32 values as one bf16x2 register, the first in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64], A and B in shared memory, both
// K-major.  scale_d == 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_m64n64k16(float (&d)[32], uint64_t desc_a,
                                                  uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 }, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64], A from registers (the m64k16
// fragment, four bf16x2 a thread), B in shared memory, MN-major.
__device__ __forceinline__ void wgmma_rs_m64n64k16_bmn(float (&d)[32],
                                                      const uint32_t (&a)[4],
                                                      uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 }, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// D[64 x 128] (+)= A[64 x 16] B[16 x 128], A from registers (the m64k16
// fragment, four bf16x2 a thread), B in shared memory, MN-major.
__device__ __forceinline__ void wgmma_rs_m64n128k16_bmn(float (&d)[64],
                                                      const uint32_t (&a)[4],
                                                      uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 }, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// D[64 x N] += A[64 x 16] B[16 x N] for N = 64 or 128 (a head dimension),
// A from registers, B MN-major.
template <int N>
__device__ __forceinline__ void wgmma_rs_bmn(float (&d)[N / 2], const uint32_t (&a)[4],
                                             uint64_t desc_b);
template <>
__device__ __forceinline__ void wgmma_rs_bmn<64>(float (&d)[32], const uint32_t (&a)[4],
                                                 uint64_t desc_b) {
  wgmma_rs_m64n64k16_bmn(d, a, desc_b, 1);
}
template <>
__device__ __forceinline__ void wgmma_rs_bmn<128>(float (&d)[64], const uint32_t (&a)[4],
                                                  uint64_t desc_b) {
  wgmma_rs_m64n128k16_bmn(d, a, desc_b, 1);
}

}  // namespace sm90

// ------------------------------------------------------------- host side
// The kernel a C entry dispatches a dtype to; each entry's
// rtt_<kernel>_route export names it.
enum Route { kFma = 0, kWgmma = 1, kNone = -1 };

inline const char* route_name(Route r) {
  return r == kWgmma ? "wgmma" : r == kFma ? "fma" : "";
}

// The tensor map of a bf16 [B, L, H, D] view with element strides
// (sb, sl, sh) and a contiguous last dimension: dims (D, H, L, B), boxes
// of 64 x 1 x 64 x 1 (one 64-row slab), 128-byte swizzle.  TMA needs a
// 16-byte-aligned base and strides that are multiples of 16 bytes.
// Returns 0, or -1 for a view it cannot describe.
inline int make_bhld_tensor_map(CUtensorMap* map, const void* base, int B,
                                int H, int L, int D, long long sb,
                                long long sl, long long sh) {
  if (reinterpret_cast<uintptr_t>(base) % 16 || sb % 8 || sl % 8 || sh % 8)
    return -1;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)L,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)sl * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, 1, sm90::kTileRows, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const CUresult r = cuTensorMapEncodeTiled(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
      strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -1;
}
