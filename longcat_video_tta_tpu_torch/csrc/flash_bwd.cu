// Flash-attention backward for Hopper (sm_90a), with the LongCat
// conditioning-prefix mask: two kernels, dQ and dK/dV.
//
// Replaces: longcat_video_tta_tpu/ops/flash_attention.py::_bwd_dq_kernel
// (driven by _flash_bwd_dq_impl, pallas_call at :443) and ::_bwd_dkv_kernel
// (_flash_bwd_dkv_impl, pallas_call at :396); public entries
// flash_chunk_dq :673 and flash_chunk_dkv :705, and the custom VJP of
// flash_attention (_flash_core_bwd :515).
//
// What they compute, per (batch b, head h), from the forward's lse and
// delta_i = rowsum(dO_i * O_i) (fp32, computed by the caller as the
// reference computes it outside its kernels, _flash_bwd_impl :472):
//   s_ij  = (q_i . k_j) * scale                          (fp32)
//   p_ij  = allowed(i, j) ? exp(s_ij - lse_i) : 0        (selected, never
//            multiplied by the mask: a row with no visible key has
//            lse = -1e30 and gets exactly 0, not inf * 0)
//   dp_ij = dO_i . v_j ;  ds_ij = p_ij (dp_ij - delta_i)
//   dV_j  = sum_i p_ij dO_i          (p rounded to the dtype of dO)
//   dK_j  = scale * sum_i ds_ij q_i  (ds rounded to the dtype of q)
//   dQ_i  = scale * sum_j ds_ij k_j  (ds rounded to the dtype of k)
// with allowed(i, j) the forward's rule (flash_fwd.cu). The TPU split is
// kept: the dK/dV kernel runs one CTA per (key tile, b*h) and loops over
// the query tiles, the dQ kernel one CTA per (query tile, b*h) looping
// over the key tiles. Each output element is owned by one CTA, so there
// are no atomics and the result is deterministic.
//
// Layout: q, dO, dQ are [B, Sq, H, D]; k, v, dK, dV are [B, Sk, H, D]
// (merged [B, S, H*D] rows addressed with batch and token strides, so
// q/k/v may be strided views of a fused projection); lse and delta are
// [B, Sq, H] fp32. Outputs are in the input dtype, contiguous.
//
// Bound on an H100 (989 TFLOP/s bf16 dense, 3.35 TB/s): per allowed
// (q, k) pair the dK/dV kernel does 8*D FLOP (S, dP, dV and dK products)
// and the dQ kernel 6*D (S, dP and dQ). At the training shape (one
// sequence of 10 920 tokens with a 6240-token conditioning prefix, 32
// heads of 128) that is ~2.95e15 and ~2.2e15 FLOP per call against ~1e8
// bytes: tens of thousands of FLOP per byte, so both are bound by
// tensor-core operations (bounds 2.98 ms and 2.24 ms).
//
// Design (FlashAttention-2 style on the sm_80+ warp-level tensor cores,
// like the forward):
//  - every product is mma.sync.m16n8k16 with ldmatrix fragments from
//    shared tiles padded by 16 bytes (conflict-free); S, dP, P and dS
//    never leave registers: an fp32 score block becomes the 16-bit A
//    operand of the next product by a pack (flash_common.cuh);
//  - dQ: 8 warps x 16 query rows = 128 rows per CTA. Q and dO are staged
//    once; 64-key K and V tiles stream in by cp.async into two buffers.
//    S = Q K^T and dP = dO V^T share the loop over D, then
//    dQ += dS K accumulates in fp32 registers;
//  - dK/dV: 8 warps x 16 key rows = 128 keys per CTA. K and V are staged
//    once; 32-query Q and dO tiles (with their lse and delta) stream in
//    by cp.async into two buffers. S^T = K Q^T and dP^T = V dO^T give
//    P^T and dS^T in the layout that feeds dV += P^T dO and
//    dK += dS^T Q directly, with both accumulators in fp32 registers;
//  - tile skipping with CTA-uniform decisions: key tiles past kv_valid
//    are never visited (a dK/dV CTA whose keys are all past it writes
//    zeros), a dQ CTA of conditioning rows only stops at the first noise
//    key tile, a dK/dV CTA of noise keys only starts at the first query
//    tile that holds a noise row; element masks run only on tiles that
//    straddle a bound.
// Later work: wgmma with TMA loads and warp specialisation.

#include <math.h>

#include "flash_common.cuh"

namespace {

using namespace flash;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* delta;
  void* dq;
  void* dk;
  void* dv;
  int H, Sq, Sk;
  long long q_bs, q_ts, k_bs, k_ts, v_bs, v_ts, do_bs, do_ts;
  int ncond, kv_valid, q_off, k_off;
  float scale;
};

// keys [0, k_end) of this chunk are valid: the ragged edge and kv_valid
__device__ __forceinline__ int key_end(const Params& p) {
  int k_end = p.Sk;
  if ((long long)p.kv_valid - p.k_off < k_end) k_end = max(0, p.kv_valid - p.k_off);
  return k_end;
}

// ---------------------------------------------------------------------------
// dQ: one CTA per (128 query rows, b*h), looping over 64-key tiles
// ---------------------------------------------------------------------------

constexpr int DQ_BQ = 128;
constexpr int DQ_BK = 64;
constexpr int DQ_THREADS = (DQ_BQ / 16) * 32;

template <int D>
struct DqSmem {
  static constexpr int LD = D + 8;
  static constexpr int Q = DQ_BQ * LD;   // Q, and dO
  static constexpr int KV = DQ_BK * LD;  // one stage of K or V
  static constexpr size_t BYTES = size_t(2 * Q + 4 * KV) * 2;
};

template <typename T, int D>
__global__ void __launch_bounds__(DQ_THREADS, 1) flash_bwd_dq_kernel(const Params p) {
  using L = DqSmem<D>;
  constexpr int LD = L::LD;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sdO = sQ + L::Q;
  T* sK = sdO + L::Q;      // two stages of K
  T* sV = sK + 2 * L::KV;  // two stages of V

  const int q0 = blockIdx.x * DQ_BQ;
  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int row0 = q0 + warp * 16 + g;  // this lane's rows: row0, row0 + 8
  const int q_glob[2] = {p.q_off + row0, p.q_off + row0 + 8};

  const T* qh = static_cast<const T*>(p.q) + b * p.q_bs + (long long)h * D;
  const T* kh = static_cast<const T*>(p.k) + b * p.k_bs + (long long)h * D;
  const T* vh = static_cast<const T*>(p.v) + b * p.v_bs + (long long)h * D;
  const T* doh = static_cast<const T*>(p.dout) + b * p.do_bs + (long long)h * D;

  const int ncond = p.ncond;
  const int k_end = key_end(p);
  const int q_rows = min(DQ_BQ, p.Sq - q0);
  const bool rows_all_cond = ncond > 0 && p.q_off + q0 + q_rows <= ncond;
  const bool rows_any_cond = ncond > 0 && p.q_off + q0 < ncond;
  int k_stop = k_end;
  if (rows_all_cond) k_stop = min(k_stop, max(0, ncond - p.k_off));
  const int n_tiles = (k_stop + DQ_BK - 1) / DQ_BK;

  // lse (in log2 units) and delta of the lane's two rows; rows past Sq
  // have zero Q and dO, so their (unstored) dS is 0 whatever P is
  float lse2[2], row_delta[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    const long long at = ((long long)b * p.Sq + row) * p.H + h;
    lse2[i] = row < p.Sq ? p.lse[at] * LOG2E : 0.f;
    row_delta[i] = row < p.Sq ? p.delta[at] : 0.f;
  }

  load_tile_async<T, D, DQ_BQ, DQ_THREADS>(sQ, qh, p.q_ts, q0, p.Sq);
  load_tile_async<T, D, DQ_BQ, DQ_THREADS>(sdO, doh, p.do_ts, q0, p.Sq);
  if (n_tiles > 0) {
    load_tile_async<T, D, DQ_BK, DQ_THREADS>(sK, kh, p.k_ts, 0, p.Sk);
    load_tile_async<T, D, DQ_BK, DQ_THREADS>(sV, vh, p.v_ts, 0, p.Sk);
  }
  cp_async_commit();

  const float sl2 = p.scale * LOG2E;
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait_all();
    __syncthreads();  // tile t visible; every warp is done with tile t-1
    const int stage = t & 1;
    if (t + 1 < n_tiles) {
      load_tile_async<T, D, DQ_BK, DQ_THREADS>(sK + (stage ^ 1) * L::KV, kh, p.k_ts,
                                               (t + 1) * DQ_BK, p.Sk);
      load_tile_async<T, D, DQ_BK, DQ_THREADS>(sV + (stage ^ 1) * L::KV, vh, p.v_ts,
                                               (t + 1) * DQ_BK, p.Sk);
    }
    cp_async_commit();
    const T* cK = sK + stage * L::KV;
    const T* cV = sV + stage * L::KV;
    const int k0 = t * DQ_BK;

    // S = Q K^T and dP = dO V^T, [16 x 64] per warp
    float s[DQ_BK / 8][4], dp[DQ_BK / 8][4];
#pragma unroll
    for (int n = 0; n < DQ_BK / 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qa[4], da[4];
      ldsm_x4(qa, a_frag_ptr<LD>(sQ, warp * 16, kk * 16, lane));
      ldsm_x4(da, a_frag_ptr<LD>(sdO, warp * 16, kk * 16, lane));
#pragma unroll
      for (int n2 = 0; n2 < DQ_BK / 16; ++n2) {
        uint32_t kb[4], vb[4];
        ldsm_x4(kb, b_frag_ptr<LD>(cK, n2 * 16, kk * 16, lane));
        ldsm_x4(vb, b_frag_ptr<LD>(cV, n2 * 16, kk * 16, lane));
        Mma<T>::run(s[2 * n2], qa, kb[0], kb[1]);
        Mma<T>::run(s[2 * n2 + 1], qa, kb[2], kb[3]);
        Mma<T>::run(dp[2 * n2], da, vb[0], vb[1]);
        Mma<T>::run(dp[2 * n2 + 1], da, vb[2], vb[3]);
      }
    }

    // P = exp(S - lse) under the mask, dS = P (dP - delta), kept in s
    const bool need_mask =
        (rows_any_cond && p.k_off + k0 + DQ_BK > ncond) || (k0 + DQ_BK > k_end);
#pragma unroll
    for (int n = 0; n < DQ_BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const bool ok = !need_mask ||
                        allowed(q_glob[i], k0 + n * 8 + tig * 2 + (e & 1), p.k_off, ncond, k_end);
        const float pr = ok ? exp2f(s[n][e] * sl2 - lse2[i]) : 0.f;
        s[n][e] = pr * (dp[n][e] - row_delta[i]);
      }
    }

    // dQ[16 x D] += dS[16 x 64] K[64 x D]; dS is rounded to T here
#pragma unroll
    for (int kk = 0; kk < DQ_BK / 16; ++kk) {
      uint32_t a[4];
      to_a_frag<T>(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int n2 = 0; n2 < D / 16; ++n2) {
        uint32_t kb[4];
        ldsm_x4_trans(kb, bt_frag_ptr<LD>(cK, kk * 16, n2 * 16, lane));
        Mma<T>::run(acc[2 * n2], a, kb[0], kb[1]);
        Mma<T>::run(acc[2 * n2 + 1], a, kb[2], kb[3]);
      }
    }
  }
  cp_async_wait_all();  // nothing may be in flight when the CTA exits

  T* dq = static_cast<T*>(p.dq);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    if (row >= p.Sq) continue;
    T* out = dq + (((long long)b * p.Sq + row) * p.H + h) * D + tig * 2;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<uint32_t*>(out + n * 8) =
          Mma<T>::pack(acc[n][2 * i] * p.scale, acc[n][2 * i + 1] * p.scale);
    }
  }
}

// ---------------------------------------------------------------------------
// dK/dV: one CTA per (128 keys, b*h), looping over 32-query tiles
// ---------------------------------------------------------------------------

constexpr int KV_BK = 128;
constexpr int KV_BQ = 32;
constexpr int KV_THREADS = (KV_BK / 16) * 32;

template <int D>
struct KvSmem {
  static constexpr int LD = D + 8;
  static constexpr int KV = KV_BK * LD;  // K, and V
  static constexpr int QT = KV_BQ * LD;  // one stage of Q or dO
  static constexpr size_t BYTES = size_t(2 * KV + 4 * QT) * 2 + 4 * KV_BQ * 4;
};

// Start copying the lse and delta of query rows [q0, q0 + KV_BQ) (zero
// past Sq) into one stage of the shared row buffers.
__device__ __forceinline__ void load_rows_async(float* s_lse, float* s_delta, const Params& p,
                                                int b, int h, int q0) {
  for (int i = threadIdx.x; i < KV_BQ; i += KV_THREADS) {
    const int row = q0 + i;
    const bool ok = row < p.Sq;
    const long long at = ok ? ((long long)b * p.Sq + row) * p.H + h : 0;
    cp_async4(s_lse + i, p.lse + at, ok);
    cp_async4(s_delta + i, p.delta + at, ok);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(KV_THREADS, 1) flash_bwd_dkv_kernel(const Params p) {
  using L = KvSmem<D>;
  constexpr int LD = L::LD;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sK = reinterpret_cast<T*>(smem);
  T* sV = sK + L::KV;
  T* sQ = sV + L::KV;       // two stages of Q
  T* sdO = sQ + 2 * L::QT;  // two stages of dO
  float* sLse = reinterpret_cast<float*>(sdO + 2 * L::QT);  // two stages
  float* sDelta = sLse + 2 * KV_BQ;                         // two stages

  const int k0 = blockIdx.x * KV_BK;
  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int key0 = k0 + warp * 16 + g;  // this lane's keys: key0, key0 + 8

  const T* qh = static_cast<const T*>(p.q) + b * p.q_bs + (long long)h * D;
  const T* kh = static_cast<const T*>(p.k) + b * p.k_bs + (long long)h * D;
  const T* vh = static_cast<const T*>(p.v) + b * p.v_bs + (long long)h * D;
  const T* doh = static_cast<const T*>(p.dout) + b * p.do_bs + (long long)h * D;

  const int ncond = p.ncond;
  const int k_end = key_end(p);
  const int n_qt = (p.Sq + KV_BQ - 1) / KV_BQ;
  // a CTA of noise keys only: query tiles of conditioning rows only see
  // none of them, so the loop starts at the first tile with a noise row
  const bool keys_all_noise = ncond > 0 && p.k_off + k0 >= ncond;
  const bool keys_any_noise = ncond > 0 && p.k_off + k0 + KV_BK > ncond;
  const int t_begin = keys_all_noise ? min(n_qt, max(0, ncond - p.q_off) / KV_BQ) : 0;
  const int t_end = k0 < k_end ? n_qt : t_begin;  // keys all past kv_valid: no work

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    dk[n][0] = dk[n][1] = dk[n][2] = dk[n][3] = 0.f;
    dv[n][0] = dv[n][1] = dv[n][2] = dv[n][3] = 0.f;
  }

  if (t_begin < t_end) {
    load_tile_async<T, D, KV_BK, KV_THREADS>(sK, kh, p.k_ts, k0, p.Sk);
    load_tile_async<T, D, KV_BK, KV_THREADS>(sV, vh, p.v_ts, k0, p.Sk);
    load_tile_async<T, D, KV_BQ, KV_THREADS>(sQ, qh, p.q_ts, t_begin * KV_BQ, p.Sq);
    load_tile_async<T, D, KV_BQ, KV_THREADS>(sdO, doh, p.do_ts, t_begin * KV_BQ, p.Sq);
    load_rows_async(sLse, sDelta, p, b, h, t_begin * KV_BQ);
  }
  cp_async_commit();

  const float sl2 = p.scale * LOG2E;
  for (int t = t_begin; t < t_end; ++t) {
    cp_async_wait_all();
    __syncthreads();  // tile t visible; every warp is done with tile t-1
    const int stage = (t - t_begin) & 1;
    if (t + 1 < t_end) {
      const int nq0 = (t + 1) * KV_BQ;
      load_tile_async<T, D, KV_BQ, KV_THREADS>(sQ + (stage ^ 1) * L::QT, qh, p.q_ts, nq0, p.Sq);
      load_tile_async<T, D, KV_BQ, KV_THREADS>(sdO + (stage ^ 1) * L::QT, doh, p.do_ts, nq0,
                                               p.Sq);
      load_rows_async(sLse + (stage ^ 1) * KV_BQ, sDelta + (stage ^ 1) * KV_BQ, p, b, h, nq0);
    }
    cp_async_commit();
    const T* cQ = sQ + stage * L::QT;
    const T* cdO = sdO + stage * L::QT;
    const float* cLse = sLse + stage * KV_BQ;
    const float* cDelta = sDelta + stage * KV_BQ;
    const int q0 = t * KV_BQ;

    // S^T = K Q^T and dP^T = V dO^T, [16 keys x 32 queries] per warp
    float s[KV_BQ / 8][4], dp[KV_BQ / 8][4];
#pragma unroll
    for (int n = 0; n < KV_BQ / 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t ka[4], va[4];
      ldsm_x4(ka, a_frag_ptr<LD>(sK, warp * 16, kk * 16, lane));
      ldsm_x4(va, a_frag_ptr<LD>(sV, warp * 16, kk * 16, lane));
#pragma unroll
      for (int n2 = 0; n2 < KV_BQ / 16; ++n2) {
        uint32_t qb[4], db[4];
        ldsm_x4(qb, b_frag_ptr<LD>(cQ, n2 * 16, kk * 16, lane));
        ldsm_x4(db, b_frag_ptr<LD>(cdO, n2 * 16, kk * 16, lane));
        Mma<T>::run(s[2 * n2], ka, qb[0], qb[1]);
        Mma<T>::run(s[2 * n2 + 1], ka, qb[2], qb[3]);
        Mma<T>::run(dp[2 * n2], va, db[0], db[1]);
        Mma<T>::run(dp[2 * n2 + 1], va, db[2], db[3]);
      }
    }

    // P^T = exp(S^T - lse) under the mask (kept in s), dS^T = P^T (dP^T -
    // delta) (kept in dp); rows of the transposed tile are keys, columns
    // are queries
    const bool need_mask = q0 + KV_BQ > p.Sq || k0 + KV_BK > k_end ||
                           (keys_any_noise && p.q_off + q0 < ncond);
#pragma unroll
    for (int n = 0; n < KV_BQ / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n * 8 + tig * 2 + (e & 1);  // query within the tile
        const bool ok = !need_mask || (q0 + c < p.Sq && allowed(p.q_off + q0 + c,
                                                                key0 + 8 * (e >> 1), p.k_off,
                                                                ncond, k_end));
        const float pr = ok ? exp2f(s[n][e] * sl2 - cLse[c] * LOG2E) : 0.f;
        const float row_delta = cDelta[c];
        s[n][e] = pr;
        dp[n][e] = pr * (dp[n][e] - row_delta);
      }
    }

    // dV[16 x D] += P^T[16 x 32] dO[32 x D]; dK += dS^T Q (P and dS
    // rounded to T here)
#pragma unroll
    for (int kk = 0; kk < KV_BQ / 16; ++kk) {
      uint32_t pa[4], da[4];
      to_a_frag<T>(pa, s[2 * kk], s[2 * kk + 1]);
      to_a_frag<T>(da, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int n2 = 0; n2 < D / 16; ++n2) {
        uint32_t ob[4], qb[4];
        ldsm_x4_trans(ob, bt_frag_ptr<LD>(cdO, kk * 16, n2 * 16, lane));
        ldsm_x4_trans(qb, bt_frag_ptr<LD>(cQ, kk * 16, n2 * 16, lane));
        Mma<T>::run(dv[2 * n2], pa, ob[0], ob[1]);
        Mma<T>::run(dv[2 * n2 + 1], pa, ob[2], ob[3]);
        Mma<T>::run(dk[2 * n2], da, qb[0], qb[1]);
        Mma<T>::run(dk[2 * n2 + 1], da, qb[2], qb[3]);
      }
    }
  }
  cp_async_wait_all();

  T* dk_out = static_cast<T*>(p.dk);
  T* dv_out = static_cast<T*>(p.dv);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = key0 + 8 * i;
    if (key >= p.Sk) continue;
    const long long at = (((long long)b * p.Sk + key) * p.H + h) * D + tig * 2;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<uint32_t*>(dk_out + at + n * 8) =
          Mma<T>::pack(dk[n][2 * i] * p.scale, dk[n][2 * i + 1] * p.scale);
      *reinterpret_cast<uint32_t*>(dv_out + at + n * 8) =
          Mma<T>::pack(dv[n][2 * i], dv[n][2 * i + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

template <typename T, int D>
cudaError_t launch(bool dkv, const Params& p, int B, cudaStream_t stream) {
  const size_t smem = dkv ? KvSmem<D>::BYTES : DqSmem<D>::BYTES;
  auto kernel = dkv ? flash_bwd_dkv_kernel<T, D> : flash_bwd_dq_kernel<T, D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int rows = dkv ? p.Sk : p.Sq;
  const int tile = dkv ? KV_BK : DQ_BQ;
  dim3 grid((rows + tile - 1) / tile, B * p.H);
  kernel<<<grid, dkv ? KV_THREADS : DQ_THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(bool dkv, int D, const Params& p, int B, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32>(dkv, p, B, stream);
    case 64:
      return launch<T, 64>(dkv, p, B, stream);
    case 128:
      return launch<T, 128>(dkv, p, B, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

int run(bool dkv, const void* q, const void* k, const void* v, const void* dout,
        const void* lse, const void* delta, void* dq, void* dk, void* dv, int B, int H, int Sq,
        int Sk, int D, int dtype, long long q_bs, long long q_ts, long long k_bs,
        long long k_ts, long long v_bs, long long v_ts, long long do_bs, long long do_ts,
        int ncond, int kv_valid, int q_off, int k_off, float scale, void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.H = H;
  p.Sq = Sq;
  p.Sk = Sk;
  p.q_bs = q_bs;
  p.q_ts = q_ts;
  p.k_bs = k_bs;
  p.k_ts = k_ts;
  p.v_bs = v_bs;
  p.v_ts = v_ts;
  p.do_bs = do_bs;
  p.do_ts = do_ts;
  p.ncond = ncond;
  p.kv_valid = kv_valid;
  p.q_off = q_off;
  p.k_off = k_off;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch_d<__nv_bfloat16>(dkv, D, p, B, s);
  if (dtype == 1) return (int)dispatch_d<__half>(dkv, D, p, B, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry points (bound with ctypes). dtype: 0 = bf16, 1 = fp16.
// Each returns the cudaError_t of its launch (0 on success).
extern "C" int lc_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                               const void* lse, const void* delta, void* dq, int B, int H,
                               int Sq, int Sk, int D, int dtype, long long q_bs, long long q_ts,
                               long long k_bs, long long k_ts, long long v_bs, long long v_ts,
                               long long do_bs, long long do_ts, int ncond, int kv_valid,
                               int q_off, int k_off, float scale, void* stream) {
  return run(false, q, k, v, dout, lse, delta, dq, nullptr, nullptr, B, H, Sq, Sk, D, dtype,
             q_bs, q_ts, k_bs, k_ts, v_bs, v_ts, do_bs, do_ts, ncond, kv_valid, q_off, k_off,
             scale, stream);
}

extern "C" int lc_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                const void* lse, const void* delta, void* dk, void* dv, int B,
                                int H, int Sq, int Sk, int D, int dtype, long long q_bs,
                                long long q_ts, long long k_bs, long long k_ts, long long v_bs,
                                long long v_ts, long long do_bs, long long do_ts, int ncond,
                                int kv_valid, int q_off, int k_off, float scale, void* stream) {
  return run(true, q, k, v, dout, lse, delta, nullptr, dk, dv, B, H, Sq, Sk, D, dtype, q_bs,
             q_ts, k_bs, k_ts, v_bs, v_ts, do_bs, do_ts, ncond, kv_valid, q_off, k_off, scale,
             stream);
}
