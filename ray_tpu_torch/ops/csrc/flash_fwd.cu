// Flash-attention forward for Hopper (sm_90a), CUDA C++, plain C entry.
//
// Replaces: _flash_fwd_kernel in ray_tpu/ops/attention.py (the Pallas TPU
// kernel launched by _flash_fwd's pl.pallas_call).  It computes the same
// function: O = softmax(Q K^T * scale, mask) V by an online softmax over
// K/V tiles (fp32 running max m, denominator l and accumulator), with
//   - the causal mask aligned to the diagonal (row >= col), applied only
//     to the tiles that cross it;
//   - masked scores zeroed as in the TPU kernel (s <= NEG_INF/2 -> p = 0);
//   - the causal loop bound clamped to the number of K tiles;
//   - O = o / max(l, 1e-30), and optionally the fp32 row log-sum-exp
//     m + log(max(l, 1e-30)) written as [B*H, Lq] (the TPU kernel's
//     8-sublane broadcast is a TPU layout artefact and is not kept);
//   - P rounded to the storage dtype before P.V, as p.astype(v.dtype).
//
// Layout: q, k, v are read in the public [B, L, H, D] layout through their
// strides (no [B*H, L, D] transpose is materialised); the last dimension
// must be contiguous and every pointer and stride a multiple of 4
// elements (the wrapper checks).  O is written contiguous [B, Lq, H, D].
//
// Design: one thread block of 256 threads per (Q tile of 64 rows,
// batch*head).  Q, K^T and V tiles are staged through shared memory as
// fp32 and every product is a plain fp32 FMA (a 4x4 register micro-tile
// per thread, float4 shared-memory reads); the row max and sum reduce
// over the 16 threads of a half-warp with shuffles.
//
// What bounds it on this card: at GPT-2's L = 1024, D = 64, the work is
// ~1.6 GFLOP against ~6.3 MB of Q/K/V/O traffic, so the H100 bound is
// bytes (~1.9 us at 3.35 TB/s) over tensor-core FLOPs (~1.6 us at 989
// TFLOP/s bf16); at long L the FLOPs grow as L^2 and bound it.  This
// kernel uses no tensor core, so it is bound instead by the fp32 FMA rate
// (67 TFLOP/s peak) and by shared-memory bandwidth.  Left on the table:
// wgmma (or mma.sync) on bf16 tiles, TMA loads with an mbarrier pipeline
// that overlaps the next K/V tile with this tile's math, keeping P in
// registers instead of shared memory, and a persistent schedule that
// balances the causal triangle.  Those are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;     // a 16 x 16 grid of 4 x 4 micro-tiles
constexpr int kPad = 4;           // keeps float4 rows aligned, spreads banks
constexpr float kNegInf = -1e30f;  // as NEG_INF in the JAX package

__device__ __forceinline__ void load4(const float* p, float out[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float out[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  out[0] = a.x; out[1] = a.y; out[2] = b.x; out[3] = b.y;
}

__device__ __forceinline__ void store4(float* p, const float in[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float in[4]) {
  __nv_bfloat162 a = __floats2bfloat162_rn(in[0], in[1]);
  __nv_bfloat162 b = __floats2bfloat162_rn(in[2], in[3]);
  uint2 v;
  v.x = *reinterpret_cast<unsigned int*>(&a);
  v.y = *reinterpret_cast<unsigned int*>(&b);
  *reinterpret_cast<uint2*>(p) = v;
}

// Round to the storage dtype and back (identity for fp32).
__device__ __forceinline__ float round_to(float x, const float*) { return x; }
__device__ __forceinline__ float round_to(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Reduce over the 16 lanes of a half-warp (one row's threads).
__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int D>
constexpr int smem_floats() {
  // sQT [D][64+pad], sKT [D][64+pad], sV [64][D], sPT [64][64+pad]
  return 2 * D * (kBlockQ + kPad) + kBlockK * D + kBlockK * (kBlockQ + kPad);
}

template <typename T, int D, bool kCausal, bool kWithLse>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int H, int Lq, int Lk,
                 long long sqb, long long sql, long long sqh,
                 long long skb, long long skl, long long skh,
                 long long svb, long long svl, long long svh, float scale) {
  constexpr int kLd = kBlockQ + kPad;  // row length of the transposed tiles
  constexpr int kColGroups = D / 64;   // float4 column groups per thread in O
  extern __shared__ float4 smem_raw[];
  float* sQT = reinterpret_cast<float*>(smem_raw);  // [D][kLd]: Q^T
  float* sKT = sQT + D * kLd;                       // [D][kLd]: K^T
  float* sV = sKT + D * kLd;                        // [kBlockK][D]
  float* sPT = sV + kBlockK * D;                    // [kBlockK][kLd]: P^T

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // column group: S cols 4tx..4tx+3
  const int ty = tid / 16;  // row group: rows 4ty..4ty+3
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q_off = blockIdx.x * kBlockQ;

  const T* qb = q + b * sqb + h * sqh;
  const T* kbase = k + b * skb + h * skh;
  const T* vbase = v + b * svb + h * svh;

  // Stage this block's Q tile, transposed, as fp32.
  for (int idx = tid; idx < kBlockQ * D / 4; idx += kThreads) {
    const int r = idx / (D / 4), d = (idx % (D / 4)) * 4;
    float x[4];
    load4(qb + (long long)(q_off + r) * sql + d, x);
#pragma unroll
    for (int j = 0; j < 4; ++j) sQT[(d + j) * kLd + r] = x[j];
  }

  float m[4], l[4], acc[4][4 * kColGroups];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * kColGroups; ++c) acc[i][c] = 0.f;
  }

  const int num_k_tiles = Lk / kBlockK;
  int num_full = num_k_tiles, num_iter = num_k_tiles;
  if (kCausal) {
    // Tiles wholly below the diagonal skip the mask; the rest are masked.
    // Clamp to the K tiles that exist (lq > lk would read past K/V).
    num_full = min(q_off / kBlockK, num_k_tiles);
    num_iter = min((q_off + kBlockQ + kBlockK - 1) / kBlockK, num_k_tiles);
  }

  for (int kt = 0; kt < num_iter; ++kt) {
    const int k_off = kt * kBlockK;
    const bool masked = kCausal && kt >= num_full;
    __syncthreads();  // the previous tile's readers are done
    for (int idx = tid; idx < kBlockK * D / 4; idx += kThreads) {
      const int r = idx / (D / 4), d = (idx % (D / 4)) * 4;
      float x[4];
      load4(kbase + (long long)(k_off + r) * skl + d, x);
#pragma unroll
      for (int j = 0; j < 4; ++j) sKT[(d + j) * kLd + r] = x[j];
      load4(vbase + (long long)(k_off + r) * svl + d, x);
      store4(sV + r * D + d, x);
    }
    __syncthreads();

    // S = Q K^T for rows 4ty.., cols 4tx.. (fp32 accumulation).
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[4], bk[4];
      load4(sQT + d * kLd + 4 * ty, a);
      load4(sKT + d * kLd + 4 * tx, bk);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }

    // Online softmax update for this thread's four rows.
    float p_t[4][4];  // P^T staging: p_t[j][i] = p[row i][col j]
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float row_max = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] *= scale;
        if (masked && !(q_off + 4 * ty + i >= k_off + 4 * tx + j)) s[i][j] = kNegInf;
        row_max = fmaxf(row_max, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(row_max));
      const float corr = expf(m[i] - m_new);
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float p = expf(s[i][j] - m_new);
        if (masked && s[i][j] <= kNegInf / 2) p = 0.f;
        row_sum += p;
        p_t[j][i] = round_to(p, q);
      }
      l[i] = l[i] * corr + half_warp_sum(row_sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * kColGroups; ++c) acc[i][c] *= corr;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) store4(sPT + (4 * tx + j) * kLd + 4 * ty, p_t[j]);
    __syncthreads();

    // O += P V: this thread's rows 4ty.. and columns 4tx.. (+64).
#pragma unroll 4
    for (int kk = 0; kk < kBlockK; ++kk) {
      float p[4];
      load4(sPT + kk * kLd + 4 * ty, p);
#pragma unroll
      for (int g = 0; g < kColGroups; ++g) {
        float vv[4];
        load4(sV + kk * D + 64 * g + 4 * tx, vv);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][4 * g + j] = fmaf(p[i], vv[j], acc[i][4 * g + j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q_off + 4 * ty + i;
    const float l_safe = fmaxf(l[i], 1e-30f);
    T* orow = o + (((long long)b * Lq + row) * H + h) * D;
#pragma unroll
    for (int g = 0; g < kColGroups; ++g) {
      float out[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) out[j] = acc[i][4 * g + j] / l_safe;
      store4(orow + 64 * g + 4 * tx, out);
    }
    if (kWithLse && tx == 0) lse[(long long)bh * Lq + row] = m[i] + logf(l_safe);
  }
}

template <typename T, int D, bool kCausal, bool kWithLse>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int H, int Lq, int Lk, const long long* st, float scale,
           cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<T, D, kCausal, kWithLse>;
  const int smem = smem_floats<D>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(Lq / kBlockQ, B * H);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, H, Lq, Lk,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int dispatch_flags(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int H, int Lq, int Lk,
                   const long long* st, float scale, int causal,
                   cudaStream_t s) {
  if (causal) {
    return lse ? launch<T, D, true, true>(q, k, v, o, lse, B, H, Lq, Lk, st, scale, s)
               : launch<T, D, true, false>(q, k, v, o, lse, B, H, Lq, Lk, st, scale, s);
  }
  return lse ? launch<T, D, false, true>(q, k, v, o, lse, B, H, Lq, Lk, st, scale, s)
             : launch<T, D, false, false>(q, k, v, o, lse, B, H, Lq, Lk, st, scale, s);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  strides: 9 element strides
// (q b/l/h, k b/l/h, v b/l/h).  lse may be null.  Returns a cudaError_t
// code (0 on success) or -1 for arguments the kernel does not take.
int rtt_flash_fwd(const void* q, const void* k, const void* v, void* o,
                  float* lse, int dtype, int B, int H, int Lq, int Lk, int D,
                  const long long* strides, float scale, int causal,
                  void* stream) {
  if (Lq % kBlockQ || Lk % kBlockK || B < 1 || H < 1 || B * H > 65535) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64)
    return dispatch_flags<float, 64>(q, k, v, o, lse, B, H, Lq, Lk, strides, scale, causal, s);
  if (dtype == 0 && D == 128)
    return dispatch_flags<float, 128>(q, k, v, o, lse, B, H, Lq, Lk, strides, scale, causal, s);
  if (dtype == 1 && D == 64)
    return dispatch_flags<__nv_bfloat16, 64>(q, k, v, o, lse, B, H, Lq, Lk, strides, scale, causal, s);
  if (dtype == 1 && D == 128)
    return dispatch_flags<__nv_bfloat16, 128>(q, k, v, o, lse, B, H, Lq, Lk, strides, scale, causal, s);
  return -1;
}

const char* rtt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
