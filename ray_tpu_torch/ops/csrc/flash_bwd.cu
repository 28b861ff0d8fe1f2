// Flash-attention backward for Hopper (sm_90a), CUDA C++, plain C entries.
//
// Replaces: _flash_dq_kernel and _flash_dkv_kernel in
// ray_tpu/ops/attention.py (the two Pallas TPU kernels launched by
// _flash_bwd's pl.pallas_call).  They compute the same functions:
//   P  = exp(S * scale - LSE), recomputed from the forward's fp32 row
//        log-sum-exp and not renormalised;
//   dP = dO V^T;
//   dS = P * (dP - Delta) * scale, rounded to the storage dtype, where
//        Delta = rowsum(dO * O) in fp32 is computed by the caller;
//   dQ = dS K                       (rtt_flash_dq, one block per Q tile);
//   dV = round(P)^T dO, dK = dS^T Q (rtt_flash_dkv, one block per K tile);
// with
//   - the causal mask aligned to the diagonal (row >= col), applied only
//     to the tiles that cross it, and masked scores zeroed there
//     (s <= NEG_INF/2 -> p = 0);
//   - the dq loop over K tiles clamped as in the forward, and the dkv loop
//     over Q tiles starting at the diagonal's tile, masked up to the first
//     fully visible tile and unmasked after;
//   - dq, dk, dv written in the storage dtype, contiguous [B, L, H, D].
// The JAX split into two kernels is kept, so each output tile has one
// owner and no atomics are needed.
//
// Layout: q, k, v and dO are read in the public [B, L, H, D] layout
// through their strides (the last dimension contiguous, every pointer and
// stride a multiple of 4 elements; the wrapper checks).  LSE and Delta are
// fp32 [B*H, Lq], row b*H + h.
//
// Design: as the forward (csrc/flash_fwd.cu), 256 threads per block in a
// 16 x 16 grid of 4 x 4 register micro-tiles, 64-row tiles, operands
// staged through shared memory as fp32, every product a plain fp32 FMA.
//   dq:  Q^T and dO^T stay in shared memory; each K tile is staged as
//        K^T, V^T (for S and dP) and K (for dS K); dS goes through shared
//        memory transposed.  ~103 KB at D = 64, ~189 KB at D = 128.
//   dkv: K^T and V^T stay; each Q tile is staged first as Q^T, dO^T (for
//        S^T and dP^T), then, in the same buffer, as Q and dO row-major
//        (for dK and dV), which keeps D = 128 at ~174 KB (staging both
//        layouts at once would need ~240 KB, past the 227 KB a block may
//        have).  round(P) and dS go through shared memory.
//
// What bounds it on this card: at GPT-2's training shapes the work is
// 6*D (dq) and 8*D (dkv) FLOPs per visible (q, k) pair against a few
// hundred bytes per row, so the H100 bound is operations at the bf16
// tensor-core rate (989 TFLOP/s).  These kernels use no tensor core, so
// they are bound instead by the fp32 FMA rate (67 TFLOP/s peak) and by
// shared-memory reads.  Left on the table: wgmma on bf16 tiles with the
// score tiles kept in registers, TMA loads with an mbarrier pipeline, and
// one fused kernel that accumulates dQ with atomics or a second pass so
// that S and dP are computed once instead of twice.  Those are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 64;        // rows of a Q tile and of a K tile
constexpr int kThreads = 256;     // a 16 x 16 grid of 4 x 4 micro-tiles
constexpr int kPad = 4;           // keeps float4 rows aligned, spreads banks
constexpr int kLd = kBlock + kPad;  // row length of the transposed tiles
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

// Stage a [kBlock, D] tile of a strided [L, D] head into shared memory as
// fp32: transposed ([D][kLd]) or row-major ([kBlock][D]).
template <typename T, int D>
__device__ __forceinline__ void stage_t(float* dst, const T* src, long long ld,
                                        int tid) {
  for (int idx = tid; idx < kBlock * D / 4; idx += kThreads) {
    const int r = idx / (D / 4), d = (idx % (D / 4)) * 4;
    float x[4];
    load4(src + (long long)r * ld + d, x);
#pragma unroll
    for (int j = 0; j < 4; ++j) dst[(d + j) * kLd + r] = x[j];
  }
}

template <typename T, int D>
__device__ __forceinline__ void stage_rows(float* dst, const T* src,
                                           long long ld, int tid) {
  for (int idx = tid; idx < kBlock * D / 4; idx += kThreads) {
    const int r = idx / (D / 4), d = (idx % (D / 4)) * 4;
    float x[4];
    load4(src + (long long)r * ld + d, x);
    store4(dst + r * D + d, x);
  }
}

template <int D>
constexpr int dq_smem_floats() {
  // sQT, sdOT, sKT, sVT [D][kLd]; sK [kBlock][D]; sdST [kBlock][kLd]
  return 4 * D * kLd + kBlock * D + kBlock * kLd;
}

template <int D>
constexpr int dkv_smem_floats() {
  // sKT, sVT [D][kLd]; sA [2][D][kLd] (Q^T, dO^T, then Q, dO row-major);
  // sP, sdS [kBlock][kLd]
  return 4 * D * kLd + 2 * kBlock * kLd;
}

struct Strides {
  long long qb, ql, qh, kb, kl, kh, vb, vl, vh, ob, ol, oh;
};

// dQ for one (Q tile, batch*head).  Thread (ty, tx) holds S and dP for
// rows 4ty.. and keys 4tx.., and dQ for rows 4ty.. and columns 4tx.. (+64).
template <typename T, int D, bool kCausal>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                T* __restrict__ dq, int H, int Lq, int Lk, Strides st,
                float scale) {
  constexpr int kColGroups = D / 64;
  extern __shared__ float4 smem_raw[];
  float* sQT = reinterpret_cast<float*>(smem_raw);  // [D][kLd]: Q^T
  float* sdOT = sQT + D * kLd;                      // [D][kLd]: dO^T
  float* sKT = sdOT + D * kLd;                      // [D][kLd]: K^T
  float* sVT = sKT + D * kLd;                       // [D][kLd]: V^T
  float* sK = sVT + D * kLd;                        // [kBlock][D]: K
  float* sdST = sK + kBlock * D;                    // [kBlock][kLd]: dS^T

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q_off = blockIdx.x * kBlock;

  const T* kbase = k + b * st.kb + h * st.kh;
  const T* vbase = v + b * st.vb + h * st.vh;
  stage_t<T, D>(sQT, q + b * st.qb + h * st.qh + (long long)q_off * st.ql,
                st.ql, tid);
  stage_t<T, D>(sdOT, dout + b * st.ob + h * st.oh + (long long)q_off * st.ol,
                st.ol, tid);
  float row_lse[4], row_delta[4];
  load4(lse + (long long)bh * Lq + q_off + 4 * ty, row_lse);
  load4(delta + (long long)bh * Lq + q_off + 4 * ty, row_delta);

  float acc[4][4 * kColGroups];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4 * kColGroups; ++c) acc[i][c] = 0.f;

  const int num_k_tiles = Lk / kBlock;
  int num_full = num_k_tiles, num_iter = num_k_tiles;
  if (kCausal) {
    // As _flash_dq_kernel: tiles wholly below the diagonal skip the mask,
    // and the bound is clamped to the K tiles that exist.
    num_full = min(q_off / kBlock, num_k_tiles);
    num_iter = min((q_off + kBlock + kBlock - 1) / kBlock, num_k_tiles);
  }

  for (int kt = 0; kt < num_iter; ++kt) {
    const int k_off = kt * kBlock;
    const bool masked = kCausal && kt >= num_full;
    __syncthreads();  // the previous tile's readers are done
    stage_t<T, D>(sKT, kbase + (long long)k_off * st.kl, st.kl, tid);
    stage_rows<T, D>(sK, kbase + (long long)k_off * st.kl, st.kl, tid);
    stage_t<T, D>(sVT, vbase + (long long)k_off * st.vl, st.vl, tid);
    __syncthreads();

    // S = Q K^T and dP = dO V^T (fp32 accumulation).
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[4], bk[4], g[4], bv[4];
      load4(sQT + d * kLd + 4 * ty, a);
      load4(sKT + d * kLd + 4 * tx, bk);
      load4(sdOT + d * kLd + 4 * ty, g);
      load4(sVT + d * kLd + 4 * tx, bv);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i], bk[j], s[i][j]);
          dp[i][j] = fmaf(g[i], bv[j], dp[i][j]);
        }
    }

    float ds_t[4][4];  // dS^T staging: ds_t[j][i] = dS[row i][key j]
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float sv = s[i][j] * scale;
        if (masked && !(q_off + 4 * ty + i >= k_off + 4 * tx + j)) sv = kNegInf;
        float p = expf(sv - row_lse[i]);
        if (masked && sv <= kNegInf / 2) p = 0.f;
        ds_t[j][i] = round_to(p * (dp[i][j] - row_delta[i]) * scale, q);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) store4(sdST + (4 * tx + j) * kLd + 4 * ty, ds_t[j]);
    __syncthreads();

    // dQ += dS K.
#pragma unroll 4
    for (int kk = 0; kk < kBlock; ++kk) {
      float a[4];
      load4(sdST + kk * kLd + 4 * ty, a);
#pragma unroll
      for (int gi = 0; gi < kColGroups; ++gi) {
        float bk[4];
        load4(sK + kk * D + 64 * gi + 4 * tx, bk);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][4 * gi + j] = fmaf(a[i], bk[j], acc[i][4 * gi + j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q_off + 4 * ty + i;
    T* out = dq + (((long long)b * Lq + row) * H + h) * D;
#pragma unroll
    for (int gi = 0; gi < kColGroups; ++gi) store4(out + 64 * gi + 4 * tx, &acc[i][4 * gi]);
  }
}

// dK and dV for one (K tile, batch*head).  Thread (ty, tx) holds S^T and
// dP^T for keys 4ty.. and query rows 4tx.., and dK, dV for keys 4ty.. and
// columns 4tx.. (+64).
template <typename T, int D, bool kCausal>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dk,
                 T* __restrict__ dv, int H, int Lq, int Lk, Strides st,
                 float scale) {
  constexpr int kColGroups = D / 64;
  extern __shared__ float4 smem_raw[];
  float* sKT = reinterpret_cast<float*>(smem_raw);  // [D][kLd]: K^T
  float* sVT = sKT + D * kLd;                       // [D][kLd]: V^T
  float* sA = sVT + D * kLd;                        // Q^T, dO^T | Q, dO
  float* sP = sA + 2 * D * kLd;                     // [kBlock][kLd]: round(P)
  float* sdS = sP + kBlock * kLd;                   // [kBlock][kLd]: dS
  float* sQT = sA;                                  // [D][kLd]
  float* sdOT = sA + D * kLd;                       // [D][kLd]
  float* sQ = sA;                                   // [kBlock][D]
  float* sdO = sA + kBlock * D;                     // [kBlock][D]

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int k_off = blockIdx.x * kBlock;

  const T* qbase = q + b * st.qb + h * st.qh;
  const T* obase = dout + b * st.ob + h * st.oh;
  stage_t<T, D>(sKT, k + b * st.kb + h * st.kh + (long long)k_off * st.kl,
                st.kl, tid);
  stage_t<T, D>(sVT, v + b * st.vb + h * st.vh + (long long)k_off * st.vl,
                st.vl, tid);

  float acc_k[4][4 * kColGroups], acc_v[4][4 * kColGroups];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int c = 0; c < 4 * kColGroups; ++c) acc_k[j][c] = acc_v[j][c] = 0.f;

  const int num_q_tiles = Lq / kBlock;
  int first = 0, first_full = 0;
  if (kCausal) {
    // As _flash_dkv_kernel: only Q tiles from the diagonal's on see this
    // K tile; those up to first_full cross the diagonal and are masked.
    first = k_off / kBlock;
    first_full = min((k_off + kBlock + kBlock - 1) / kBlock, num_q_tiles);
  }

  for (int qt = first; qt < num_q_tiles; ++qt) {
    const int q_off = qt * kBlock;
    const bool masked = kCausal && qt < first_full;
    __syncthreads();  // the previous tile's readers of sA, sP, sdS are done
    stage_t<T, D>(sQT, qbase + (long long)q_off * st.ql, st.ql, tid);
    stage_t<T, D>(sdOT, obase + (long long)q_off * st.ol, st.ol, tid);
    float col_lse[4], col_delta[4];
    load4(lse + (long long)bh * Lq + q_off + 4 * tx, col_lse);
    load4(delta + (long long)bh * Lq + q_off + 4 * tx, col_delta);
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T (fp32 accumulation).
    float s[4][4], dp[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = dp[j][i] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[4], bq[4], g[4], bo[4];
      load4(sKT + d * kLd + 4 * ty, a);
      load4(sQT + d * kLd + 4 * tx, bq);
      load4(sVT + d * kLd + 4 * ty, g);
      load4(sdOT + d * kLd + 4 * tx, bo);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[j][i] = fmaf(a[j], bq[i], s[j][i]);
          dp[j][i] = fmaf(g[j], bo[i], dp[j][i]);
        }
    }

    // p_rows[i][j] = round(P)[query i][key j]; ds_rows likewise for dS.
    float p_rows[4][4], ds_rows[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float sv = s[j][i] * scale;
        if (masked && !(q_off + 4 * tx + i >= k_off + 4 * ty + j)) sv = kNegInf;
        float p = expf(sv - col_lse[i]);
        if (masked && sv <= kNegInf / 2) p = 0.f;
        p_rows[i][j] = round_to(p, q);
        ds_rows[i][j] = round_to(p * (dp[j][i] - col_delta[i]) * scale, q);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      store4(sP + (4 * tx + i) * kLd + 4 * ty, p_rows[i]);
      store4(sdS + (4 * tx + i) * kLd + 4 * ty, ds_rows[i]);
    }
    __syncthreads();  // S^T/dP^T readers of sQT, sdOT are done
    stage_rows<T, D>(sQ, qbase + (long long)q_off * st.ql, st.ql, tid);
    stage_rows<T, D>(sdO, obase + (long long)q_off * st.ol, st.ol, tid);
    __syncthreads();

    // dV += round(P)^T dO and dK += dS^T Q.
#pragma unroll 2
    for (int qq = 0; qq < kBlock; ++qq) {
      float p[4], ds[4];
      load4(sP + qq * kLd + 4 * ty, p);
      load4(sdS + qq * kLd + 4 * ty, ds);
#pragma unroll
      for (int gi = 0; gi < kColGroups; ++gi) {
        float go[4], gq[4];
        load4(sdO + qq * D + 64 * gi + 4 * tx, go);
        load4(sQ + qq * D + 64 * gi + 4 * tx, gq);
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            acc_v[j][4 * gi + c] = fmaf(p[j], go[c], acc_v[j][4 * gi + c]);
            acc_k[j][4 * gi + c] = fmaf(ds[j], gq[c], acc_k[j][4 * gi + c]);
          }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const long long row = ((long long)b * Lk + k_off + 4 * ty + j) * H + h;
#pragma unroll
    for (int gi = 0; gi < kColGroups; ++gi) {
      store4(dk + row * D + 64 * gi + 4 * tx, &acc_k[j][4 * gi]);
      store4(dv + row * D + 64 * gi + 4 * tx, &acc_v[j][4 * gi]);
    }
  }
}

template <typename Kernel>
int set_smem(Kernel kernel, int bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

Strides unpack(const long long* s) {
  return Strides{s[0], s[1], s[2], s[3], s[4], s[5],
                 s[6], s[7], s[8], s[9], s[10], s[11]};
}

template <typename T, int D, bool kCausal>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dq, int B, int H,
              int Lq, int Lk, const long long* st, float scale,
              cudaStream_t stream) {
  auto kernel = flash_dq_kernel<T, D, kCausal>;
  const int smem = dq_smem_floats<D>() * (int)sizeof(float);
  const int err = set_smem(kernel, smem);
  if (err != 0) return err;
  const dim3 grid(Lq / kBlock, B * H);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), H, Lq, Lk, unpack(st), scale);
  return (int)cudaGetLastError();
}

template <typename T, int D, bool kCausal>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dk, void* dv,
               int B, int H, int Lq, int Lk, const long long* st, float scale,
               cudaStream_t stream) {
  auto kernel = flash_dkv_kernel<T, D, kCausal>;
  const int smem = dkv_smem_floats<D>() * (int)sizeof(float);
  const int err = set_smem(kernel, smem);
  if (err != 0) return err;
  const dim3 grid(Lk / kBlock, B * H);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), H, Lq, Lk, unpack(st), scale);
  return (int)cudaGetLastError();
}

bool bad_args(int B, int H, int Lq, int Lk) {
  return Lq % kBlock || Lk % kBlock || Lq < kBlock || Lk < kBlock || B < 1 ||
         H < 1 || B * H > 65535;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  strides: 12 element strides
// (q b/l/h, k b/l/h, v b/l/h, dO b/l/h).  lse and delta: fp32 [B*H, Lq].
// dq: contiguous [B, Lq, H, D].  Returns a cudaError_t code (0 on
// success) or -1 for arguments the kernel does not take.
int rtt_flash_dq(const void* q, const void* k, const void* v,
                 const void* dout, const float* lse, const float* delta,
                 void* dq, int dtype, int B, int H, int Lq, int Lk, int D,
                 const long long* strides, float scale, int causal,
                 void* stream) {
  if (bad_args(B, H, Lq, Lk)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RTT_DQ(T, DIM, C) \
  launch_dq<T, DIM, C>(q, k, v, dout, lse, delta, dq, B, H, Lq, Lk, strides, scale, s)
  if (dtype == 0 && D == 64) return causal ? RTT_DQ(float, 64, true) : RTT_DQ(float, 64, false);
  if (dtype == 0 && D == 128) return causal ? RTT_DQ(float, 128, true) : RTT_DQ(float, 128, false);
  if (dtype == 1 && D == 64)
    return causal ? RTT_DQ(__nv_bfloat16, 64, true) : RTT_DQ(__nv_bfloat16, 64, false);
  if (dtype == 1 && D == 128)
    return causal ? RTT_DQ(__nv_bfloat16, 128, true) : RTT_DQ(__nv_bfloat16, 128, false);
#undef RTT_DQ
  return -1;
}

// As rtt_flash_dq; dk and dv: contiguous [B, Lk, H, D].
int rtt_flash_dkv(const void* q, const void* k, const void* v,
                  const void* dout, const float* lse, const float* delta,
                  void* dk, void* dv, int dtype, int B, int H, int Lq, int Lk,
                  int D, const long long* strides, float scale, int causal,
                  void* stream) {
  if (bad_args(B, H, Lq, Lk)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RTT_DKV(T, DIM, C) \
  launch_dkv<T, DIM, C>(q, k, v, dout, lse, delta, dk, dv, B, H, Lq, Lk, strides, scale, s)
  if (dtype == 0 && D == 64) return causal ? RTT_DKV(float, 64, true) : RTT_DKV(float, 64, false);
  if (dtype == 0 && D == 128) return causal ? RTT_DKV(float, 128, true) : RTT_DKV(float, 128, false);
  if (dtype == 1 && D == 64)
    return causal ? RTT_DKV(__nv_bfloat16, 64, true) : RTT_DKV(__nv_bfloat16, 64, false);
  if (dtype == 1 && D == 128)
    return causal ? RTT_DKV(__nv_bfloat16, 128, true) : RTT_DKV(__nv_bfloat16, 128, false);
#undef RTT_DKV
  return -1;
}

const char* rtt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
