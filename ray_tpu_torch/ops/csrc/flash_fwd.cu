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
//     m + log(max(l, 1e-30)) (natural log) written as [B*H, Lq] (the TPU
//     kernel's 8-sublane broadcast is a TPU layout artefact, not kept);
//   - P rounded to the storage dtype before P.V, as p.astype(v.dtype).
// Fully masked rows give O = 0.
//
// Layout: q, k, v are read in the public [B, L, H, D] layout through their
// strides (no [B*H, L, D] transpose is materialised; the last dimension
// contiguous).  O is written contiguous [B, Lq, H, D].
//
// Two routes, chosen by dtype in rtt_flash_fwd (rtt_flash_fwd_route names
// them); neither falls back to the other.
//
// bf16: wgmma, fed by TMA (flash_fwd_wgmma).  One warpgroup (128 threads)
// per (64-row Q tile, batch*head); wgmma's M is the Q tile.
//   - Q is loaded once by TMA; K and V tiles stream through rings of 2
//     stages each, filled by TMA (cp.async.bulk.tensor, 128-byte swizzle)
//     that completes on an mbarrier per slot.  Thread 0 starts the copies:
//     K tile t + 2 as soon as S of tile t is done, V tile t + 1 as soon as
//     P V of tile t - 1 is, so each copy has a whole tile of lead.  The
//     tensor maps describe the strided view itself: dims (D, H, L, B),
//     strides (1, s_h, s_l, s_b), so base and strides must be multiples of
//     16 bytes (the wrapper checks).
//   - S = Q K^T is wgmma m64n64k16, bf16 in, fp32 accumulate, Q and K both
//     K-major in shared memory.  The fp32 S accumulator is scaled, masked
//     and exponentiated in registers (in log2 units: one FFMA and one ex2 a
//     score; a row lives in a quad of threads, so its max and sum take two
//     shuffles) and packed pairwise into the bf16 A fragments of
//     O += P V, a second wgmma (m64nDk16) whose B operand is V read
//     MN-major from shared memory.  Neither S nor P touches shared memory.
//   - S of tile t is started together with P V of tile t - 1, and the
//     softmax of tile t runs while the tensor cores do that P V.
//   - Under causal, the blocks of the last Q tiles (the most K tiles) are
//     started first.  Shared memory: 8 + 2 x 16 KB at D = 64, 16 + 2 x 32 KB
//     at D = 128.
// fp32: FMA (flash_fwd_fma), the reference-precision route.  256 threads
// per (64-row Q tile, batch*head); Q, K^T and V staged through shared
// memory; every product a plain fp32 FMA on 4 x 4 register micro-tiles;
// row max and sum over the 16 threads of a half-warp.  Kept on purpose:
// TF32 on the tensor cores keeps about 3 digits, and the fp32 route
// carries NaiveLM's token identity and the card-vs-CPU training step.
//
// What bounds it on this card: at GPT-2's L = 1024, D = 64, the work is
// 4*D FLOPs a visible (q, k) pair against a few hundred bytes a row, so
// the bound is the bf16 tensor-core rate (989 TFLOP/s) at long L and HBM
// bytes at short L.  The FMA route is bound by the fp32 FMA rate (67
// TFLOP/s).  The wgmma route keeps one warpgroup a block, so its producer
// is a thread of the consumers and each refill waits for a block barrier;
// other blocks on the SM (2 to 5 fit) fill the gaps.  Left on the table:
// warp specialisation (a producer warp with setmaxnreg, two consumer
// warpgroups in ping-pong), 128-wide K tiles, a persistent schedule over
// the causal triangle, and TMA stores of O.
#include "sm90.cuh"

namespace {

// ------------------------------------------------------ fp32: FMA route

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;     // a 16 x 16 grid of 4 x 4 micro-tiles
constexpr int kPad = 4;           // keeps float4 rows aligned, spreads banks
constexpr float kNegInf = -1e30f;  // as NEG_INF in the JAX package

__device__ __forceinline__ void load4(const float* p, float out[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}

__device__ __forceinline__ void store4(float* p, const float in[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
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

template <int D, bool kCausal, bool kWithLse>
__global__ void __launch_bounds__(kThreads)
flash_fwd_fma(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
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

  const float* qb = q + b * sqb + h * sqh;
  const float* kbase = k + b * skb + h * skh;
  const float* vbase = v + b * svb + h * svh;

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
        p_t[j][i] = p;  // fp32: P.V takes P as it is
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
    float* orow = o + (((long long)b * Lq + row) * H + h) * D;
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

// ----------------------------------------------------- bf16: wgmma route
constexpr int kWgThreads = 128;  // one warpgroup
constexpr int kStages = 2;       // depth of the K ring and of the V ring

template <int D>
constexpr int wgmma_smem_bytes() {
  // 1024 bytes of alignment slack, Q, then kStages x (K, V).
  return 1024 + (D / 64) * sm90::kSlabBytes * (1 + 2 * kStages);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// O += round(P) V for one K/V tile: four k-steps of 16 keys.
template <int D>
__device__ __forceinline__ void mma_pv(float (&o)[D / 2], const uint32_t (&pf)[4][4],
                                         const uint8_t* sV) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) sm90::wgmma_rs_bmn<D>(o, pf[kk], sm90::desc_mnmajor(sV, kk));
}

// The online-softmax step on one tile's S accumulator (element e of a
// thread: row 16 * warp + lane / 4 + 8 * ((e / 2) % 2), column 8 * (e / 4) +
// 2 * (lane % 4) + e % 2).  Scores are kept in log2 units, s * scale *
// log2(e), so each p is one FFMA and one ex2; a masked score is -inf, so
// its p is exactly 0.  Updates the running max m (log2 units) and sum l,
// returns the correction of the running O in corr, and packs P, rounded
// to bf16, into the A fragments of the P V product: register j of k-step
// kk is the pair e = 8 kk + 2 j.
__device__ __forceinline__ void softmax_tile(float (&s)[32], uint32_t (&pf)[4][4],
                                             float (&m)[2], float (&l)[2],
                                             float (&corr)[2], bool masked,
                                             int q_row0, int k_col0, int lane,
                                             float scale_log2) {
  float mx[2] = {sm90::neg_inf(), sm90::neg_inf()};
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    const int r = (e / 2) % 2;
    if (masked && !(q_row0 + 8 * r >= k_col0 + 8 * (e / 4) + 2 * (lane % 4) + e % 2))
      s[e] = sm90::neg_inf();
    mx[r] = fmaxf(mx[r], s[e]);
  }
  float m_new[2], neg_m[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m_new[r] = fmaxf(m[r], quad_max(mx[r]) * scale_log2);
    corr[r] = sm90::ex2(m[r] - m_new[r]);
    neg_m[r] = -m_new[r];
  }
#pragma unroll
  for (int e = 0; e < 32; e += 2) {
    const int r = (e / 2) % 2;
    const float p0 = sm90::ex2(fmaf(s[e], scale_log2, neg_m[r]));
    const float p1 = sm90::ex2(fmaf(s[e + 1], scale_log2, neg_m[r]));
    sum[r] += p0 + p1;
    pf[e / 8][(e % 8) / 2] = sm90::pack_bf16(p0, p1);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = l[r] * corr[r] + quad_sum(sum[r]);
    m[r] = m_new[r];
  }
}

// Software pipeline inside the warpgroup: S of tile t is started together
// with P V of tile t - 1, so the softmax of tile t runs while the tensor
// cores do P V.  K and V have rings of their own: K slot t % 2 is refilled
// with tile t + 2 once S of tile t has completed, V slot with tile t + 1
// once P V of tile t - 1 has.
template <int D, bool kCausal, bool kWithLse>
__global__ void __launch_bounds__(kWgThreads)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int H,
                int Lq, int Lk, float scale) {
  constexpr int kTileBytes = (D / 64) * sm90::kSlabBytes;
  extern __shared__ float4 smem_raw[];  // as the FMA kernel declares it
  __shared__ uint64_t bar_q, bar_k[kStages], bar_v[kStages];
  uint8_t* smem = reinterpret_cast<uint8_t*>(smem_raw);
  smem += (1024 - (sm90::smem_u32(smem) & 1023)) & 1023;  // swizzle atoms
  uint8_t* sQ = smem;
  uint8_t* sK = smem + kTileBytes;                    // slot s at s * tile
  uint8_t* sV = sK + kStages * kTileBytes;            // slot s at s * tile

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  // The last Q tiles see the most K tiles under causal: start them first.
  const int q_off = (gridDim.y - 1 - blockIdx.y) * kBlockQ;

  const int num_k_tiles = Lk / kBlockK;
  int num_full = num_k_tiles, num_iter = num_k_tiles;
  if (kCausal) {
    num_full = min(q_off / kBlockK, num_k_tiles);
    num_iter = min((q_off + kBlockQ + kBlockK - 1) / kBlockK, num_k_tiles);
  }

  // One tile of K or V (a 4-D box per 64-column slab) into its ring slot.
  auto load = [&](const CUtensorMap* map, uint8_t* ring, uint64_t* bars, int kt) {
    uint64_t* bar = &bars[kt % kStages];
    uint8_t* dst = ring + (kt % kStages) * kTileBytes;
    sm90::mbar_expect_tx(bar, kTileBytes);
#pragma unroll
    for (int sl = 0; sl < D / 64; ++sl)
      sm90::tma_load_4d(dst + sl * sm90::kSlabBytes, map, bar, 64 * sl, h,
                        kt * kBlockK, b);
  };

  if (tid == 0) {
    sm90::mbar_init(&bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&bar_k[s], 1);
      sm90::mbar_init(&bar_v[s], 1);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    sm90::mbar_expect_tx(&bar_q, kTileBytes);
#pragma unroll
    for (int sl = 0; sl < D / 64; ++sl)
      sm90::tma_load_4d(sQ + sl * sm90::kSlabBytes, &tq, &bar_q, 64 * sl, h,
                        q_off, b);
    for (int kt = 0; kt < kStages && kt < num_iter; ++kt) {
      load(&tk, sK, bar_k, kt);
      load(&tv, sV, bar_v, kt);
    }
  }

  const int r0 = 16 * warp + lane / 4;  // this thread's rows: r0, r0 + 8
  const float scale_log2 = scale * sm90::kLog2e;
  float acc[D / 2];
#pragma unroll
  for (int e = 0; e < D / 2; ++e) acc[e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, corr[2];
  float s[32];
  uint32_t pf[4][4];

  // S of tile t: four (D = 64) or eight k-steps of 16 over D.
  auto mma_s = [&](int kt) {
    const uint8_t* k_tile = sK + (kt % kStages) * kTileBytes;
#pragma unroll
    for (int k = 0; k < D / 16; ++k)
      sm90::wgmma_ss_m64n64k16(s, sm90::desc_kmajor(sQ, k),
                               sm90::desc_kmajor(k_tile, k), k);
  };

  sm90::mbar_wait(&bar_q, 0);
  sm90::mbar_wait(&bar_k[0], 0);
  sm90::wgmma_fence();
  mma_s(0);
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
  sm90::fence_operands(s);
  softmax_tile(s, pf, m, l, corr, kCausal && 0 >= num_full, q_off + r0, 0,
               lane, scale_log2);
  __syncthreads();
  if (tid == 0 && kStages < num_iter) load(&tk, sK, bar_k, kStages);

  for (int kt = 1; kt < num_iter; ++kt) {
    sm90::mbar_wait(&bar_k[kt % kStages], (kt / kStages) & 1);
    sm90::mbar_wait(&bar_v[(kt - 1) % kStages], ((kt - 1) / kStages) & 1);
    sm90::fence_operands(acc);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) sm90::fence_operands(pf[kk]);
    sm90::wgmma_fence();
    mma_s(kt);
    sm90::wgmma_commit();
    mma_pv<D>(acc, pf, sV + ((kt - 1) % kStages) * kTileBytes);
    sm90::wgmma_commit();

    // The softmax of tile kt while P V of tile kt - 1 runs.
    sm90::wgmma_wait<1>();
    sm90::fence_operands(s);
    uint32_t pn[4][4];
    softmax_tile(s, pn, m, l, corr, kCausal && kt >= num_full, q_off + r0,
                 kt * kBlockK, lane, scale_log2);
    sm90::wgmma_wait<0>();
    sm90::fence_operands(acc);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) sm90::fence_operands(pf[kk]);
#pragma unroll
    for (int e = 0; e < D / 2; ++e) acc[e] *= corr[(e / 2) % 2];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) pf[kk][j] = pn[kk][j];

    // Every warp is done with K tile kt and V tile kt - 1: refill.
    __syncthreads();
    if (tid == 0) {
      if (kt + kStages < num_iter) load(&tk, sK, bar_k, kt + kStages);
      if (kt + 1 < num_iter) load(&tv, sV, bar_v, kt + 1);
    }
  }

  // P V of the last tile.
  const int last = num_iter - 1;
  sm90::mbar_wait(&bar_v[last % kStages], (last / kStages) & 1);
  sm90::fence_operands(acc);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) sm90::fence_operands(pf[kk]);
  sm90::wgmma_fence();
  mma_pv<D>(acc, pf, sV + (last % kStages) * kTileBytes);
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
  sm90::fence_operands(acc);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q_off + r0 + 8 * r;
    const float l_safe = fmaxf(l[r], 1e-30f);
    __nv_bfloat16* orow = o + (((long long)b * Lq + row) * H + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const uint32_t v = sm90::pack_bf16(acc[4 * j + 2 * r] / l_safe,
                                         acc[4 * j + 2 * r + 1] / l_safe);
      *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * (lane % 4)) = v;
    }
    // The running max is in log2 units: back to natural log.
    if (kWithLse && lane % 4 == 0)
      lse[(long long)bh * Lq + row] = m[r] * sm90::kLn2 + logf(l_safe);
  }
}

// ---------------------------------------------------------------- launch
Route route_of(int dtype) {
  return dtype == 0 ? kFma : dtype == 1 ? kWgmma : kNone;
}

template <typename Kernel>
int set_smem(Kernel kernel, int bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int D, bool kCausal, bool kWithLse>
int launch_fma(const void* q, const void* k, const void* v, void* o, float* lse,
               int B, int H, int Lq, int Lk, const long long* st, float scale,
               cudaStream_t stream) {
  auto kernel = flash_fwd_fma<D, kCausal, kWithLse>;
  const int smem = smem_floats<D>() * (int)sizeof(float);
  const int err = set_smem(kernel, smem);
  if (err != 0) return err;
  const dim3 grid(Lq / kBlockQ, B * H);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, H, Lq, Lk,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], scale);
  return (int)cudaGetLastError();
}

template <int D, bool kCausal, bool kWithLse>
int launch_wgmma(const void* q, const void* k, const void* v, void* o,
                 float* lse, int B, int H, int Lq, int Lk, const long long* st,
                 float scale, cudaStream_t stream) {
  if (Lk < kBlockK) return -1;  // the pipeline starts with one K tile
  CUtensorMap tq, tk, tv;
  if (make_bhld_tensor_map(&tq, q, B, H, Lq, D, st[0], st[1], st[2]) ||
      make_bhld_tensor_map(&tk, k, B, H, Lk, D, st[3], st[4], st[5]) ||
      make_bhld_tensor_map(&tv, v, B, H, Lk, D, st[6], st[7], st[8]))
    return -1;
  auto kernel = flash_fwd_wgmma<D, kCausal, kWithLse>;
  const int smem = wgmma_smem_bytes<D>();
  const int err = set_smem(kernel, smem);
  if (err != 0) return err;
  const dim3 grid(B * H, Lq / kBlockQ);
  kernel<<<grid, kWgThreads, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, H, Lq, Lk, scale);
  return (int)cudaGetLastError();
}

template <int D>
int dispatch(Route route, const void* q, const void* k, const void* v, void* o,
             float* lse, int B, int H, int Lq, int Lk, const long long* st,
             float scale, int causal, cudaStream_t s) {
#define RTT_FWD(LAUNCH, C, L) LAUNCH<D, C, L>(q, k, v, o, lse, B, H, Lq, Lk, st, scale, s)
  if (route == kWgmma) {
    if (causal) return lse ? RTT_FWD(launch_wgmma, true, true) : RTT_FWD(launch_wgmma, true, false);
    return lse ? RTT_FWD(launch_wgmma, false, true) : RTT_FWD(launch_wgmma, false, false);
  }
  if (causal) return lse ? RTT_FWD(launch_fma, true, true) : RTT_FWD(launch_fma, true, false);
  return lse ? RTT_FWD(launch_fma, false, true) : RTT_FWD(launch_fma, false, false);
#undef RTT_FWD
}

}  // namespace

extern "C" {

// dtype: 0 = float32 (the FMA route), 1 = bfloat16 (the wgmma route).
// strides: 9 element strides (q b/l/h, k b/l/h, v b/l/h); for bf16 the
// base pointers and strides must be multiples of 16 bytes (TMA).  lse may
// be null.  Returns a cudaError_t code (0 on success) or -1 for arguments
// the kernel does not take.
int rtt_flash_fwd(const void* q, const void* k, const void* v, void* o,
                  float* lse, int dtype, int B, int H, int Lq, int Lk, int D,
                  const long long* strides, float scale, int causal,
                  void* stream) {
  if (Lq % kBlockQ || Lk % kBlockK || B < 1 || H < 1 || B * H > 65535) return -1;
  const Route route = route_of(dtype);
  if (route == kNone) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) return dispatch<64>(route, q, k, v, o, lse, B, H, Lq, Lk, strides, scale, causal, s);
  if (D == 128) return dispatch<128>(route, q, k, v, o, lse, B, H, Lq, Lk, strides, scale, causal, s);
  return -1;
}

// The route rtt_flash_fwd takes for a dtype code: "fma", "wgmma" or "".
const char* rtt_flash_fwd_route(int dtype) { return route_name(route_of(dtype)); }

const char* rtt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
