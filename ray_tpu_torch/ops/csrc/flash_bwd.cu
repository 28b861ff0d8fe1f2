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
// through their strides (the last dimension contiguous).  LSE and Delta
// are fp32 [B*H, Lq], row b*H + h.
//
// Routes, chosen by dtype in the C entries (rtt_flash_dq_route and
// rtt_flash_dkv_route name them); none falls back to another:
//   dq:  wgmma in bf16 (flash_dq_wgmma), FMA in fp32 (flash_dq_kernel).
//   dkv: wgmma in bf16 (flash_dkv_wgmma), FMA in fp32 (flash_dkv_kernel).
// The bf16 kernels read q, k, v and dO through TMA tensor maps of the
// strided views, so base pointers and strides must be multiples of 16
// bytes; an entry returns -1 for a view the hardware cannot describe.
//
// bf16 dq on the tensor cores, in the forward's frame: one warpgroup per
// (64-row Q tile, batch*head); the Q rows are wgmma's M rows.
//   - Q and dO are loaded once by TMA, and each thread reads the LSE and
//     Delta of its two rows into registers.  K tiles stream through a
//     3-slot ring and V tiles through a 2-slot ring of TMA loads that
//     complete on an mbarrier per slot (128-byte swizzle).  K tile t is
//     read by S_t and by dQ += dS_t K_t, which runs during the next
//     iteration, hence its third slot; V is read by dP_t alone.  Thread 0
//     starts tile t + 2 of both as soon as the block is done with iteration
//     t, a whole iteration ahead of its use.  Under causal, the blocks of
//     the last Q tiles (the most K tiles) are started first.
//   - S = Q K^T and dP = dO V^T: wgmma m64n64k16, A = the Q or dO tile,
//     B = the K or V tile, all K-major in shared memory (the forward's S).
//   - dS = P (dP - Delta) * scale is formed on the fp32 accumulators, in
//     log2 units (one FFMA and one ex2 a score, LSE taken to log2 units; a
//     masked score is -inf, so its p is exactly 0), rounded to bf16 and
//     packed pairwise into A fragments.
//   - dQ += round(dS) K: wgmma m64nDk16 with A from registers and B = the
//     same K tile read MN-major, as the forward reads V for P V; so one
//     bf16 copy of each K tile serves both its uses.  dQ accumulates in
//     fp32 registers and is written once, in bf16.
//   - S and dP of tile t are started together with dQ += dS K of tile
//     t - 1, and dS of tile t is formed while that product runs.
//   Shared memory: 2 x 8 + 3 x 8 + 2 x 8 KB at D = 64, twice that at D = 128
//   (plus 1 KB of alignment slack).
// bf16 dkv on the tensor cores, in the transposed frame: one warpgroup per
// (64-key K tile, batch*head); the keys are wgmma's M rows.
//   - K and V are loaded once by TMA; the Q and dO tiles, with their 64
//     LSE and 64 Delta values (bulk copies), stream through a 2-stage ring
//     of TMA loads that complete on an mbarrier per stage.  Thread 0 starts
//     tile i + 2 as soon as the block is done with tile i.
//   - Scores in log2 units, as for dq.
//   - S^T = K Q^T and dP^T = V dO^T: wgmma m64n64k16, A = K or V, B = the
//     Q or dO tile, both K-major in shared memory.
//   - P^T = exp(S^T * scale - LSE) and dS^T = P^T (dP^T - Delta) * scale
//     are formed on the fp32 accumulators (LSE and Delta are per column
//     there, read from the staged 64 + 64 floats), rounded to bf16 and
//     packed pairwise into A fragments.
//   - dV += round(P^T) dO and dK += round(dS^T) Q: wgmma m64nDk16 with A
//     from registers and B = the same Q and dO tiles read MN-major, so one
//     bf16 copy of each tile serves both of its uses (the fp32 FMA kernel
//     restages each Q tile transposed, then row-major).  dK and dV
//     accumulate in fp32 registers and are written once, in bf16.
//   Shared memory: 16 + 2 x 16.5 KB at D = 64, 32 + 2 x 32.5 KB at D = 128.
// fp32 FMA kernels: 256 threads per block in a 16 x 16 grid of 4 x 4
// register micro-tiles, 64-row tiles, operands staged through shared
// memory, every product a plain fp32 FMA.
//   dq:  Q^T and dO^T stay in shared memory; each K tile is staged as
//        K^T, V^T (for S and dP) and K (for dS K); dS goes through shared
//        memory transposed.  ~103 KB at D = 64, ~189 KB at D = 128.
//   dkv: K^T and V^T stay; each Q tile is staged first as Q^T, dO^T (for
//        S^T and dP^T), then, in the same buffer, as Q and dO row-major
//        (for dK and dV), which keeps D = 128 at ~174 KB.  P and dS go
//        through shared memory.
// fp32 keeps FMA on purpose: it is the reference-precision route (TF32 on
// the tensor cores keeps about 3 digits), which the card-vs-CPU fp32
// training step holds at 1e-4.
//
// What bounds them on this card: at GPT-2's training shapes the work is
// 6*D (dq) and 8*D (dkv) FLOPs per visible (q, k) pair against a few
// hundred bytes per row, so the H100 bound is operations at the bf16
// tensor-core rate (989 TFLOP/s).  The FMA kernels are bound instead by
// the fp32 FMA rate (67 TFLOP/s peak) and by shared-memory reads.  Each
// wgmma kernel keeps one warpgroup a block, so its producer is a thread of
// the consumers and each refill waits for a block barrier, and dkv
// serialises its score products, its elementwise pass and its gradient
// products; other blocks on the SM fill the tensor cores meanwhile.  The
// split recomputes S and dP in both kernels (4*D of their 14*D FLOPs a
// pair) to keep one writer per output tile and sums in a fixed order.
// Left on the table: warp specialisation (a producer warp with setmaxnreg,
// two consumer warpgroups in ping-pong), 128-wide K tiles, a persistent
// schedule over the causal triangle, TMA stores of the outputs; and dQ
// accumulated inside the dkv loop (atomics, or a partial per K tile and a
// second pass), which would compute S and dP once.
#include "sm90.cuh"

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

__device__ __forceinline__ void store4(float* p, const float in[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
}

// Round to the storage dtype and back: the identity, as the FMA kernels
// are instantiated for fp32 only (bf16 takes the wgmma kernels).
__device__ __forceinline__ float round_to(float x, const float*) { return x; }

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

// ----------------------------------------------------- bf16 dkv: wgmma
// In the transposed frame: the 64 keys of the block's K tile are wgmma's
// M rows, so every product has its operands where wgmma takes them.
//   S^T = K Q^T, dP^T = V dO^T  (A = K or V, B = the Q or dO tile, both
//                                K-major in shared memory);
//   dV += round(P^T) dO, dK += round(dS^T) Q  (A = P^T or dS^T from
//                                registers, B = the same Q and dO tiles
//                                read MN-major).
// One bf16 copy of each Q and dO tile serves both its uses.  The
// accumulator layout and the A fragment are as in flash_fwd.cu's
// softmax_tile; LSE[q] and Delta[q] are per column here.
constexpr int kWgThreads = 128;  // one warpgroup
constexpr int kStages = 2;       // Q/dO/LSE/Delta ring depth

template <int D>
constexpr int dkv_wgmma_smem_bytes() {
  // 1024 bytes of alignment slack, K, V, then kStages x (Q, dO).
  return 1024 + (D / 64) * sm90::kSlabBytes * (2 + 2 * kStages);
}

template <int D, bool kCausal>
__global__ void __launch_bounds__(kWgThreads)
flash_dkv_wgmma(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                const __grid_constant__ CUtensorMap tdo,
                const float* __restrict__ lse, const float* __restrict__ delta,
                __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                int H, int Lq, int Lk, float scale) {
  constexpr int kTileBytes = (D / 64) * sm90::kSlabBytes;
  extern __shared__ float4 smem_raw[];  // as the FMA kernel declares it
  __shared__ uint64_t bar_kv, bar_q[kStages];
  __shared__ __align__(16) float s_lse[kStages][kBlock];
  __shared__ __align__(16) float s_delta[kStages][kBlock];
  uint8_t* smem = reinterpret_cast<uint8_t*>(smem_raw);
  smem += (1024 - (sm90::smem_u32(smem) & 1023)) & 1023;  // swizzle atoms
  uint8_t* sK = smem;
  uint8_t* sV = smem + kTileBytes;
  uint8_t* sQdO = smem + 2 * kTileBytes;  // stage s: Q at 2 s, dO at 2 s + 1

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int k_off = blockIdx.y * kBlock;  // the first K tiles see the most Q tiles

  const int num_q_tiles = Lq / kBlock;
  int first = 0, first_full = 0;
  if (kCausal) {
    // As _flash_dkv_kernel: only Q tiles from the diagonal's on see this
    // K tile; those up to first_full cross the diagonal and are masked.
    first = k_off / kBlock;
    first_full = min((k_off + kBlock + kBlock - 1) / kBlock, num_q_tiles);
  }
  const int num_iter = num_q_tiles - first;
  const float* lse_bh = lse + (long long)bh * Lq;
  const float* delta_bh = delta + (long long)bh * Lq;

  auto load_q = [&](int stage, int qt) {
    uint8_t* sq = sQdO + 2 * stage * kTileBytes;
    sm90::mbar_expect_tx(&bar_q[stage], 2 * kTileBytes + 2 * kBlock * 4);
#pragma unroll
    for (int sl = 0; sl < D / 64; ++sl) {
      sm90::tma_load_4d(sq + sl * sm90::kSlabBytes, &tq, &bar_q[stage], 64 * sl,
                        h, qt * kBlock, b);
      sm90::tma_load_4d(sq + kTileBytes + sl * sm90::kSlabBytes, &tdo,
                        &bar_q[stage], 64 * sl, h, qt * kBlock, b);
    }
    sm90::bulk_load(s_lse[stage], lse_bh + qt * kBlock, kBlock * 4, &bar_q[stage]);
    sm90::bulk_load(s_delta[stage], delta_bh + qt * kBlock, kBlock * 4,
                    &bar_q[stage]);
  };

  if (tid == 0) {
    sm90::mbar_init(&bar_kv, 1);
    for (int s = 0; s < kStages; ++s) sm90::mbar_init(&bar_q[s], 1);
    sm90::fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    sm90::mbar_expect_tx(&bar_kv, 2 * kTileBytes);
#pragma unroll
    for (int sl = 0; sl < D / 64; ++sl) {
      sm90::tma_load_4d(sK + sl * sm90::kSlabBytes, &tk, &bar_kv, 64 * sl, h,
                        k_off, b);
      sm90::tma_load_4d(sV + sl * sm90::kSlabBytes, &tv, &bar_kv, 64 * sl, h,
                        k_off, b);
    }
    for (int s = 0; s < kStages && s < num_iter; ++s) load_q(s, first + s);
  }

  const int r0 = 16 * warp + lane / 4;  // this thread's keys: r0, r0 + 8
  const float scale_log2 = scale * sm90::kLog2e;
  float acc_k[D / 2], acc_v[D / 2];
#pragma unroll
  for (int e = 0; e < D / 2; ++e) acc_k[e] = acc_v[e] = 0.f;

  sm90::mbar_wait(&bar_kv, 0);
  for (int i = 0; i < num_iter; ++i) {
    const int qt = first + i;
    const int q_off = qt * kBlock;
    const int stage = i % kStages;
    const uint8_t* sQ = sQdO + 2 * stage * kTileBytes;
    const uint8_t* sdO = sQ + kTileBytes;
    sm90::mbar_wait(&bar_q[stage], (i / kStages) & 1);

    // S^T = K Q^T and dP^T = V dO^T.
    float s[32], dp[32];
    sm90::wgmma_fence();
#pragma unroll
    for (int k = 0; k < D / 16; ++k)
      sm90::wgmma_ss_m64n64k16(s, sm90::desc_kmajor(sK, k),
                               sm90::desc_kmajor(sQ, k), k);
#pragma unroll
    for (int k = 0; k < D / 16; ++k)
      sm90::wgmma_ss_m64n64k16(dp, sm90::desc_kmajor(sV, k),
                               sm90::desc_kmajor(sdO, k), k);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_operands(s);
    sm90::fence_operands(dp);

    // P^T and dS^T on the accumulators, packed into A fragments.  P is
    // exp2(s * scale * log2(e) - LSE * log2(e)): one FFMA and one ex2; a
    // masked score is -inf, so its p is exactly 0.
    const bool masked = kCausal && qt < first_full;
    uint32_t pf[4][4], dsf[4][4];
#pragma unroll
    for (int e = 0; e < 32; e += 2) {
      const int key = k_off + r0 + 8 * ((e / 2) % 2);
      const int c = 8 * (e / 4) + 2 * (lane % 4);  // columns c, c + 1
      const float2 col_lse = *reinterpret_cast<const float2*>(&s_lse[stage][c]);
      const float2 col_delta = *reinterpret_cast<const float2*>(&s_delta[stage][c]);
      float p[2], ds[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        float sv = s[e + u];
        if (masked && !(q_off + c + u >= key)) sv = sm90::neg_inf();
        p[u] = sm90::ex2(fmaf(sv, scale_log2,
                              -(u ? col_lse.y : col_lse.x) * sm90::kLog2e));
        ds[u] = p[u] * (dp[e + u] - (u ? col_delta.y : col_delta.x)) * scale;
      }
      pf[e / 8][(e % 8) / 2] = sm90::pack_bf16(p[0], p[1]);
      dsf[e / 8][(e % 8) / 2] = sm90::pack_bf16(ds[0], ds[1]);
    }

    // dV += round(P^T) dO and dK += round(dS^T) Q.
    sm90::fence_operands(acc_v);
    sm90::fence_operands(acc_k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      sm90::fence_operands(pf[kk]);
      sm90::fence_operands(dsf[kk]);
    }
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      sm90::wgmma_rs_bmn<D>(acc_v, pf[kk], sm90::desc_mnmajor(sdO, kk));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      sm90::wgmma_rs_bmn<D>(acc_k, dsf[kk], sm90::desc_mnmajor(sQ, kk));
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_operands(acc_v);
    sm90::fence_operands(acc_k);

    // Every warp's products on this stage have completed: refill it.
    __syncthreads();
    if (tid == 0 && i + kStages < num_iter) load_q(stage, qt + kStages);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long row = ((long long)b * Lk + k_off + r0 + 8 * r) * H + h;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + 2 * (lane % 4);
      *reinterpret_cast<uint32_t*>(dk + row * D + col) =
          sm90::pack_bf16(acc_k[4 * j + 2 * r], acc_k[4 * j + 2 * r + 1]);
      *reinterpret_cast<uint32_t*>(dv + row * D + col) =
          sm90::pack_bf16(acc_v[4 * j + 2 * r], acc_v[4 * j + 2 * r + 1]);
    }
  }
}

// ------------------------------------------------------ bf16 dq: wgmma
// In the forward's frame: the 64 rows of the block's Q tile are wgmma's M
// rows, so every product has its operands where wgmma takes them.
//   S = Q K^T, dP = dO V^T  (A = the Q or dO tile, B = the K or V tile,
//                            all K-major in shared memory);
//   dQ += round(dS) K       (A = dS from registers, B = the same K tile
//                            read MN-major, as the forward reads V).
// The accumulator layout and the A fragment are as in flash_fwd.cu's
// softmax_tile; LSE[q] and Delta[q] are per row here, two rows a thread,
// held in registers.  K tile t is read by S_t and by dQ_t, which runs
// during iteration t + 1, so the K ring has one slot more than V's.
constexpr int kDqKStages = 3;
constexpr int kDqVStages = 2;

template <int D>
constexpr int dq_wgmma_smem_bytes() {
  // 1024 bytes of alignment slack, Q, dO, then the K and V rings.
  return 1024 + (D / 64) * sm90::kSlabBytes * (2 + kDqKStages + kDqVStages);
}

// dS = P (dP - Delta) * scale for one tile, on the S and dP accumulators
// (element e of a thread: row q_row0 + 8 * ((e / 2) % 2), column k_col0 +
// 8 * (e / 4) + 2 * (lane % 4) + e % 2), rounded to bf16 and packed
// pairwise into the A fragments of dS K: register j of k-step kk is the
// pair e = 8 kk + 2 j.  P is exp2(s * scale * log2(e) - LSE * log2(e)):
// one FFMA and one ex2; a masked score is -inf, so its p is exactly 0.
__device__ __forceinline__ void ds_tile(const float (&s)[32], const float (&dp)[32],
                                        uint32_t (&dsf)[4][4],
                                        const float (&neg_lse2)[2],
                                        const float (&delta)[2], bool masked,
                                        int q_row0, int k_col0, int lane,
                                        float scale_log2, float scale) {
#pragma unroll
  for (int e = 0; e < 32; e += 2) {
    const int r = (e / 2) % 2;
    float ds[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      float sv = s[e + u];
      if (masked && !(q_row0 + 8 * r >= k_col0 + 8 * (e / 4) + 2 * (lane % 4) + u))
        sv = sm90::neg_inf();
      const float p = sm90::ex2(fmaf(sv, scale_log2, neg_lse2[r]));
      ds[u] = p * (dp[e + u] - delta[r]) * scale;
    }
    dsf[e / 8][(e % 8) / 2] = sm90::pack_bf16(ds[0], ds[1]);
  }
}

// Software pipeline inside the warpgroup: S and dP of tile t are started
// together with dQ += dS K of tile t - 1, so dS of tile t is formed while
// the tensor cores do that product.  After iteration t, K slot (t - 1) % 3
// (dQ of tile t - 1 done) and V slot t % 2 (dP of tile t done) are refilled
// with tile t + 2, a whole iteration ahead of its use.
template <int D, bool kCausal>
__global__ void __launch_bounds__(kWgThreads)
flash_dq_wgmma(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv,
               const __grid_constant__ CUtensorMap tdo,
               const float* __restrict__ lse, const float* __restrict__ delta,
               __nv_bfloat16* __restrict__ dq, int H, int Lq, int Lk,
               float scale) {
  constexpr int kTileBytes = (D / 64) * sm90::kSlabBytes;
  extern __shared__ float4 smem_raw[];  // as the FMA kernel declares it
  __shared__ uint64_t bar_qdo, bar_k[kDqKStages], bar_v[kDqVStages];
  uint8_t* smem = reinterpret_cast<uint8_t*>(smem_raw);
  smem += (1024 - (sm90::smem_u32(smem) & 1023)) & 1023;  // swizzle atoms
  uint8_t* sQ = smem;
  uint8_t* sdO = smem + kTileBytes;
  uint8_t* sK = smem + 2 * kTileBytes;           // slot s at s * tile
  uint8_t* sV = sK + kDqKStages * kTileBytes;     // slot s at s * tile

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  // The last Q tiles see the most K tiles under causal: start them first.
  const int q_off = (gridDim.y - 1 - blockIdx.y) * kBlock;

  const int num_k_tiles = Lk / kBlock;
  int num_full = num_k_tiles, num_iter = num_k_tiles;
  if (kCausal) {
    // As _flash_dq_kernel: tiles wholly below the diagonal skip the mask,
    // and the bound is clamped to the K tiles that exist.
    num_full = min(q_off / kBlock, num_k_tiles);
    num_iter = min((q_off + kBlock + kBlock - 1) / kBlock, num_k_tiles);
  }

  // One tile (a 4-D box per 64-column slab) into slot kt % stages.
  auto load = [&](const CUtensorMap* map, uint8_t* ring, uint64_t* bars,
                  int stages, int kt) {
    uint64_t* bar = &bars[kt % stages];
    uint8_t* dst = ring + (kt % stages) * kTileBytes;
    sm90::mbar_expect_tx(bar, kTileBytes);
#pragma unroll
    for (int sl = 0; sl < D / 64; ++sl)
      sm90::tma_load_4d(dst + sl * sm90::kSlabBytes, map, bar, 64 * sl, h,
                        kt * kBlock, b);
  };

  if (tid == 0) {
    sm90::mbar_init(&bar_qdo, 1);
    for (int s = 0; s < kDqKStages; ++s) sm90::mbar_init(&bar_k[s], 1);
    for (int s = 0; s < kDqVStages; ++s) sm90::mbar_init(&bar_v[s], 1);
    sm90::fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    sm90::mbar_expect_tx(&bar_qdo, 2 * kTileBytes);
#pragma unroll
    for (int sl = 0; sl < D / 64; ++sl) {
      sm90::tma_load_4d(sQ + sl * sm90::kSlabBytes, &tq, &bar_qdo, 64 * sl, h,
                        q_off, b);
      sm90::tma_load_4d(sdO + sl * sm90::kSlabBytes, &tdo, &bar_qdo, 64 * sl,
                        h, q_off, b);
    }
    for (int kt = 0; kt < kDqKStages && kt < num_iter; ++kt)
      load(&tk, sK, bar_k, kDqKStages, kt);
    for (int kt = 0; kt < kDqVStages && kt < num_iter; ++kt)
      load(&tv, sV, bar_v, kDqVStages, kt);
  }

  const int r0 = 16 * warp + lane / 4;  // this thread's rows: r0, r0 + 8
  const float scale_log2 = scale * sm90::kLog2e;
  float neg_lse2[2], row_delta[2];  // the LSE in log2 units, negated
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long row = (long long)bh * Lq + q_off + r0 + 8 * r;
    neg_lse2[r] = -lse[row] * sm90::kLog2e;
    row_delta[r] = delta[row];
  }
  float acc[D / 2];
#pragma unroll
  for (int e = 0; e < D / 2; ++e) acc[e] = 0.f;
  float s[32], dp[32];
  uint32_t dsf[4][4];

  // S and dP of tile kt: four (D = 64) or eight k-steps of 16 over D each.
  auto mma_s_dp = [&](int kt) {
    const uint8_t* k_tile = sK + (kt % kDqKStages) * kTileBytes;
    const uint8_t* v_tile = sV + (kt % kDqVStages) * kTileBytes;
#pragma unroll
    for (int k = 0; k < D / 16; ++k)
      sm90::wgmma_ss_m64n64k16(s, sm90::desc_kmajor(sQ, k),
                               sm90::desc_kmajor(k_tile, k), k);
#pragma unroll
    for (int k = 0; k < D / 16; ++k)
      sm90::wgmma_ss_m64n64k16(dp, sm90::desc_kmajor(sdO, k),
                               sm90::desc_kmajor(v_tile, k), k);
  };
  // dQ += round(dS) K of tile kt: four k-steps of 16 keys.
  auto mma_dq = [&](int kt) {
    const uint8_t* k_tile = sK + (kt % kDqKStages) * kTileBytes;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      sm90::wgmma_rs_bmn<D>(acc, dsf[kk], sm90::desc_mnmajor(k_tile, kk));
  };
  auto wait_kv = [&](int kt) {
    sm90::mbar_wait(&bar_k[kt % kDqKStages], (kt / kDqKStages) & 1);
    sm90::mbar_wait(&bar_v[kt % kDqVStages], (kt / kDqVStages) & 1);
  };
  // After iteration kt (every warp past it): V tile kt + 2 into the slot
  // dP of tile kt read, K tile kt + 2 into the slot dQ of tile kt - 1 read
  // (K tiles 0-2 were loaded up front).
  auto refill = [&](int kt) {
    if (tid != 0 || kt + 2 >= num_iter) return;
    load(&tv, sV, bar_v, kDqVStages, kt + 2);
    if (kt >= 1) load(&tk, sK, bar_k, kDqKStages, kt + 2);
  };

  sm90::mbar_wait(&bar_qdo, 0);
  wait_kv(0);
  sm90::wgmma_fence();
  mma_s_dp(0);
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
  sm90::fence_operands(s);
  sm90::fence_operands(dp);
  ds_tile(s, dp, dsf, neg_lse2, row_delta, kCausal && 0 >= num_full,
          q_off + r0, 0, lane, scale_log2, scale);
  __syncthreads();
  refill(0);

  for (int kt = 1; kt < num_iter; ++kt) {
    wait_kv(kt);
    sm90::fence_operands(acc);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) sm90::fence_operands(dsf[kk]);
    sm90::wgmma_fence();
    mma_s_dp(kt);
    sm90::wgmma_commit();
    mma_dq(kt - 1);
    sm90::wgmma_commit();

    // dS of tile kt while dQ += dS K of tile kt - 1 runs.
    sm90::wgmma_wait<1>();
    sm90::fence_operands(s);
    sm90::fence_operands(dp);
    uint32_t dsn[4][4];
    ds_tile(s, dp, dsn, neg_lse2, row_delta, kCausal && kt >= num_full,
            q_off + r0, kt * kBlock, lane, scale_log2, scale);
    sm90::wgmma_wait<0>();
    sm90::fence_operands(acc);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) sm90::fence_operands(dsf[kk]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) dsf[kk][j] = dsn[kk][j];

    __syncthreads();
    refill(kt);
  }

  // dQ += dS K of the last tile.
  sm90::fence_operands(acc);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) sm90::fence_operands(dsf[kk]);
  sm90::wgmma_fence();
  mma_dq(num_iter - 1);
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
  sm90::fence_operands(acc);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    __nv_bfloat16* out = dq + (((long long)b * Lq + q_off + r0 + 8 * r) * H + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(out + 8 * j + 2 * (lane % 4)) =
          sm90::pack_bf16(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
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

template <int D, bool kCausal>
int launch_dkv_wgmma(const void* q, const void* k, const void* v,
                     const void* dout, const float* lse, const float* delta,
                     void* dk, void* dv, int B, int H, int Lq, int Lk,
                     const long long* st, float scale, cudaStream_t stream) {
  if (reinterpret_cast<uintptr_t>(lse) % 16 || reinterpret_cast<uintptr_t>(delta) % 16)
    return -1;
  CUtensorMap tq, tk, tv, tdo;
  if (make_bhld_tensor_map(&tq, q, B, H, Lq, D, st[0], st[1], st[2]) ||
      make_bhld_tensor_map(&tk, k, B, H, Lk, D, st[3], st[4], st[5]) ||
      make_bhld_tensor_map(&tv, v, B, H, Lk, D, st[6], st[7], st[8]) ||
      make_bhld_tensor_map(&tdo, dout, B, H, Lq, D, st[9], st[10], st[11]))
    return -1;
  auto kernel = flash_dkv_wgmma<D, kCausal>;
  const int smem = dkv_wgmma_smem_bytes<D>();
  const int err = set_smem(kernel, smem);
  if (err != 0) return err;
  const dim3 grid(B * H, Lk / kBlock);
  kernel<<<grid, kWgThreads, smem, stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), H, Lq, Lk, scale);
  return (int)cudaGetLastError();
}

template <int D, bool kCausal>
int launch_dq_wgmma(const void* q, const void* k, const void* v,
                    const void* dout, const float* lse, const float* delta,
                    void* dq, int B, int H, int Lq, int Lk,
                    const long long* st, float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  if (make_bhld_tensor_map(&tq, q, B, H, Lq, D, st[0], st[1], st[2]) ||
      make_bhld_tensor_map(&tk, k, B, H, Lk, D, st[3], st[4], st[5]) ||
      make_bhld_tensor_map(&tv, v, B, H, Lk, D, st[6], st[7], st[8]) ||
      make_bhld_tensor_map(&tdo, dout, B, H, Lq, D, st[9], st[10], st[11]))
    return -1;
  auto kernel = flash_dq_wgmma<D, kCausal>;
  const int smem = dq_wgmma_smem_bytes<D>();
  const int err = set_smem(kernel, smem);
  if (err != 0) return err;
  const dim3 grid(B * H, Lq / kBlock);
  kernel<<<grid, kWgThreads, smem, stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<__nv_bfloat16*>(dq), H, Lq,
      Lk, scale);
  return (int)cudaGetLastError();
}

// Both entries: wgmma in bf16, FMA in fp32.
Route route_of(int dtype) {
  return dtype == 0 ? kFma : dtype == 1 ? kWgmma : kNone;
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
#define RTT_DQ_WG(DIM, C) \
  launch_dq_wgmma<DIM, C>(q, k, v, dout, lse, delta, dq, B, H, Lq, Lk, strides, scale, s)
  const Route route = route_of(dtype);
  if (route == kFma && D == 64) return causal ? RTT_DQ(float, 64, true) : RTT_DQ(float, 64, false);
  if (route == kFma && D == 128) return causal ? RTT_DQ(float, 128, true) : RTT_DQ(float, 128, false);
  if (route == kWgmma && D == 64) return causal ? RTT_DQ_WG(64, true) : RTT_DQ_WG(64, false);
  if (route == kWgmma && D == 128) return causal ? RTT_DQ_WG(128, true) : RTT_DQ_WG(128, false);
#undef RTT_DQ_WG
#undef RTT_DQ
  return -1;
}

// As rtt_flash_dq; dk and dv: contiguous [B, Lk, H, D].  bf16 takes the
// wgmma kernel, whose base pointers and strides must be multiples of 16
// bytes (TMA), as must lse and delta.
int rtt_flash_dkv(const void* q, const void* k, const void* v,
                  const void* dout, const float* lse, const float* delta,
                  void* dk, void* dv, int dtype, int B, int H, int Lq, int Lk,
                  int D, const long long* strides, float scale, int causal,
                  void* stream) {
  if (bad_args(B, H, Lq, Lk)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RTT_DKV(T, DIM, C) \
  launch_dkv<T, DIM, C>(q, k, v, dout, lse, delta, dk, dv, B, H, Lq, Lk, strides, scale, s)
#define RTT_DKV_WG(DIM, C) \
  launch_dkv_wgmma<DIM, C>(q, k, v, dout, lse, delta, dk, dv, B, H, Lq, Lk, strides, scale, s)
  const Route route = route_of(dtype);
  if (route == kFma && D == 64) return causal ? RTT_DKV(float, 64, true) : RTT_DKV(float, 64, false);
  if (route == kFma && D == 128) return causal ? RTT_DKV(float, 128, true) : RTT_DKV(float, 128, false);
  if (route == kWgmma && D == 64) return causal ? RTT_DKV_WG(64, true) : RTT_DKV_WG(64, false);
  if (route == kWgmma && D == 128) return causal ? RTT_DKV_WG(128, true) : RTT_DKV_WG(128, false);
#undef RTT_DKV_WG
#undef RTT_DKV
  return -1;
}

// The route each entry takes for a dtype code: "fma", "wgmma" or "".
const char* rtt_flash_dq_route(int dtype) { return route_name(route_of(dtype)); }
const char* rtt_flash_dkv_route(int dtype) { return route_name(route_of(dtype)); }

const char* rtt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
