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
// (merged [B, S, H*D] rows addressed with batch and token strides in
// bytes, so q/k/v may be strided views of a fused projection). lse and
// delta come as fp32 rows, `rows` = [2, B*H, ld]: row (b*H + h) holds
// lse_i * log2(e) of (b, h) at column i, row (B*H + b*H + h) its delta_i;
// ld is a multiple of 4 (16-byte rows, which a TMA box needs; [B, Sq, H]
// strided by H floats is not). Outputs are in the input dtype, contiguous.
//
// Bound on an H100 (989 TFLOP/s bf16 dense, 3.35 TB/s): per allowed
// (q, k) pair the dK/dV kernel does 8*D FLOP (S, dP, dV and dK products)
// and the dQ kernel 6*D (S, dP and dQ). At the training shape (one
// sequence of 10 920 tokens with a 6240-token conditioning prefix, 32
// heads of 128) that is ~2.95e15 and ~2.2e15 FLOP per call against ~1e8
// bytes: tens of thousands of FLOP per byte, so both are bound by
// tensor-core operations (bounds 2.98 ms and 2.24 ms), which only wgmma
// reaches.
//
// Design: FlashAttention-3's backward without its atomic dQ, on
// hopper_common.cuh's TMA, mbarrier and wgmma helpers. 384 threads per
// CTA: warpgroup 0 is the producer (setmaxnreg 24), one elected thread
// issuing every TMA load; warpgroups 1 and 2 are consumers (setmaxnreg
// 240) that run every product on wgmma.
//  - dK/dV: one CTA per (128 keys, b*h). K and V are loaded once; 64-query
//    tiles of Q and dO, each with its 64 lse and delta values, stream
//    through a ring of KV_STAGES slots (a full and an empty mbarrier per
//    slot, the row values on the Q slot's barrier). Each consumer owns 64
//    keys: S^T = K Q^T and dP^T = V dO^T are ss products (m64n64k16, both
//    operands K-major); P^T and dS^T stay in registers; dV += P^T dO and
//    dK += dS^T Q are register-A products (m64nDk16), the S^T and dP^T
//    accumulators packed to 16 bits as their A fragments, with dO and Q
//    read MN-major from the same swizzled tiles (as attn_cta reads V).
//    Each thread reads its 16 query columns' lse and delta from the slot.
//  - dQ: one CTA per (128 queries, b*h). Q and dO are loaded once;
//    DQ_BK-key tiles of K and V stream through the ring (K and V on
//    barriers of their own). Each consumer owns 64 rows: S = Q K^T and
//    dP = dO V^T are ss products, dS stays in registers, dQ += dS K is a
//    register-A product with K read MN-major. A thread's two rows' lse
//    and delta are read once, before the loop.
//  - Within a consumer, a tile's S and dP products are issued together
//    and P is computed while dP runs; the tile's last product (dV and
//    dK, or dQ) is waited for before the next tile's S and dP are issued.
//    The two consumers fill each other's gaps at the tensor cores.
//    Queueing the next tile's products behind the last one instead made
//    ptxas serialize the wgmma pipeline (C7515: P and dS are written into
//    accumulator registers while a product is open) and both kernels
//    slower on the H100 (scripts/torch_kernel_variants.py bwd_queued).
//  - The scale folds into one FMA in the exp2 domain, P = 2^(s * scale *
//    log2 e - lse * log2 e), and is applied to dK and dQ once, at the
//    store.
//  - Tile skipping with CTA-uniform decisions: key tiles past kv_valid
//    are never visited (a dK/dV CTA whose keys are all past it writes
//    zeros), a dQ CTA of conditioning rows only stops at the first noise
//    key tile, a dK/dV CTA of noise keys only starts at the first query
//    tile that holds a noise row; element masks run only on tiles that
//    straddle a bound. Rows past Sq load as zeros (Q, dO, lse, delta), so
//    their P is finite and their terms vanish without a mask.
//  - Tile counts: the producer and the consumers walk one schedule object
//    (count / next), so they agree on every tile; a mismatch would hang
//    the card instead of failing a gate.
//  - Launch order: grid (b*h, tile), x fastest, so the first tiles of
//    every head go first. The CTAs that walk the most tiles come first:
//    dK/dV's conditioning keys (key tile 0 up) and dQ's noise rows (the
//    dQ grid's tile order is reversed); at the train shape 171 against 74
//    query tiles, and 86 against 49 key tiles.
//  - Registers: a dK/dV consumer thread holds dK and dV (2 x D/2 fp32),
//    S^T and dP^T (2 x 32) and their packed forms; a dQ consumer thread
//    dQ (D/2), S and dP (2 x DQ_BK/2) and packed dS. Every accumulator and
//    packed operand is fenced around wgmma so the compiler cannot move
//    its reads or reuse its registers across the asynchronous product.

#include "hopper_common.cuh"

namespace {

using namespace hopper;

constexpr int BWD_PRODUCER_REGS = 24;
constexpr int BWD_CONSUMER_REGS = 240;  // (24 + 2 * 240) * 128 <= 65536

// dS = P (dP - delta), fp32
__device__ __forceinline__ float grad_s(float p, float dp, float delta) {
  return p * (dp - delta);
}

// keys [0, k_end) of this chunk are valid: the ragged edge and kv_valid
__device__ __forceinline__ int key_end(int Sk, int kv_valid, int k_off) {
  int k_end = Sk;
  if ((long long)kv_valid - k_off < k_end) k_end = max(0, kv_valid - k_off);
  return k_end;
}

// The LongCat mask on chunk-local indices: a conditioning query (global
// index < ncond) sees only conditioning keys; keys at or past k_end are
// invalid.
struct Mask {
  int ncond, q_off, k_off, k_end;
  __device__ bool allowed(int q, int k) const {
    return k < k_end && (ncond == 0 || q_off + q >= ncond || k_off + k < ncond);
  }
};

// ---------------------------------------------------------------------------
// dK/dV: one CTA per (128 keys, b*h), looping over 64-query tiles
// ---------------------------------------------------------------------------

constexpr int KV_BK = 128;  // keys per CTA
constexpr int KV_BQ = 64;   // queries per tile
constexpr int KV_STAGES = 2;

// Shared layout: K, V (128 rows each), KV_STAGES slots of Q and of dO (64
// rows each), of lse and of delta (64 values each), then the barriers.
// A row is cut into boxes of its swizzle span, box after box.
template <int D>
struct DkvSmem {
  static constexpr int ROW = 2 * D;  // bytes of a 16-bit row
  static constexpr int SW = sw16<D>();
  static constexpr int K_BYTES = KV_BK * ROW;  // K, and V
  static constexpr int Q_BYTES = KV_BQ * ROW;  // one slot of Q, or of dO
  static constexpr int R_BYTES = KV_BQ * 4;    // one slot of lse, or of delta
  static constexpr int OFF_V = K_BYTES;
  static constexpr int OFF_Q = 2 * K_BYTES;
  static constexpr int OFF_DO = OFF_Q + KV_STAGES * Q_BYTES;
  static constexpr int OFF_LSE = OFF_DO + KV_STAGES * Q_BYTES;
  static constexpr int OFF_DELTA = OFF_LSE + KV_STAGES * R_BYTES;
  static constexpr int OFF_BAR = OFF_DELTA + KV_STAGES * R_BYTES;
  static constexpr int N_BARS = 1 + 2 * KV_STAGES;  // K and V; Q slots full, empty
  static constexpr size_t BYTES = OFF_BAR + N_BARS * 8 + 1024;  // + alignment slack
};

// The query tiles one dK/dV CTA visits: KV_BQ-row tiles from t_begin on.
struct DkvSched {
  int b, h, bh, BH, k0, t_begin, n_tiles;
  bool keys_any_noise;
  Mask m;

  __device__ int count() const { return n_tiles; }
  __device__ void next(Cursor& c, int& q0) const { q0 = (t_begin + c.a++) * KV_BQ; }
  // CTA-uniform: element masks only on a tile at a bound
  __device__ bool need_mask(int q0) const {
    return k0 + KV_BK > m.k_end || (keys_any_noise && m.q_off + q0 < m.ncond);
  }
};

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                     const __grid_constant__ CUtensorMap trows, T* __restrict__ dk_out,
                     T* __restrict__ dv_out, int H, int Sq, int Sk, int ncond, int kv_valid,
                     int q_off, int k_off, float scale) {
  using L = DkvSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::OFF_BAR);
  uint64_t* q_full = kv_full + 1;
  uint64_t* q_empty = q_full + KV_STAGES;

  DkvSched sc;
  sc.bh = blockIdx.x;
  sc.BH = gridDim.x;
  sc.b = sc.bh / H;
  sc.h = sc.bh % H;
  sc.k0 = blockIdx.y * KV_BK;
  sc.m = Mask{ncond, q_off, k_off, key_end(Sk, kv_valid, k_off)};
  const int n_qt = (Sq + KV_BQ - 1) / KV_BQ;
  // a CTA of noise keys only: query tiles of conditioning rows only see
  // none of them, so the walk starts at the first tile with a noise row
  const bool keys_all_noise = ncond > 0 && k_off + sc.k0 >= ncond;
  sc.keys_any_noise = ncond > 0 && k_off + sc.k0 + KV_BK > ncond;
  sc.t_begin = keys_all_noise ? min(n_qt, max(0, ncond - q_off) / KV_BQ) : 0;
  // keys all past kv_valid: no work, the CTA writes zeros
  sc.n_tiles = sc.k0 < sc.m.k_end ? n_qt - sc.t_begin : 0;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
#pragma unroll
    for (int st = 0; st < KV_STAGES; ++st) {
      mbar_init(q_full + st, 1);
      mbar_init(q_empty + st, 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer: one thread issues every load
    reg_dealloc<BWD_PRODUCER_REGS>();
    if (threadIdx.x == 0 && sc.count() > 0) {
      mbar_expect_tx(kv_full, 2 * L::K_BYTES);
#pragma unroll
      for (int c = 0; c < L::ROW / L::SW; ++c) {
        tma_load_4d(smem + c * KV_BK * L::SW, tk, kv_full, c * L::SW / 2, sc.h, sc.k0, sc.b);
        tma_load_4d(smem + L::OFF_V + c * KV_BK * L::SW, tv, kv_full, c * L::SW / 2, sc.h,
                    sc.k0, sc.b);
      }
      Cursor cur;
      for (int t = 0; t < sc.count(); ++t) {
        const int st = t % KV_STAGES;
        int q0;
        sc.next(cur, q0);
        mbar_wait(q_empty + st, ((t / KV_STAGES) & 1) ^ 1);
        mbar_expect_tx(q_full + st, 2 * L::Q_BYTES + 2 * L::R_BYTES);
#pragma unroll
        for (int c = 0; c < L::ROW / L::SW; ++c) {
          tma_load_4d(smem + L::OFF_Q + st * L::Q_BYTES + c * KV_BQ * L::SW, tq, q_full + st,
                      c * L::SW / 2, sc.h, q0, sc.b);
          tma_load_4d(smem + L::OFF_DO + st * L::Q_BYTES + c * KV_BQ * L::SW, tdo, q_full + st,
                      c * L::SW / 2, sc.h, q0, sc.b);
        }
        tma_load_2d(smem + L::OFF_LSE + st * L::R_BYTES, trows, q_full + st, q0, sc.bh);
        tma_load_2d(smem + L::OFF_DELTA + st * L::R_BYTES, trows, q_full + st, q0,
                    sc.BH + sc.bh);
      }
    }
  } else {
    // consumers: 64 keys per warpgroup
    reg_alloc<BWD_CONSUMER_REGS>();
    const int cw = threadIdx.x / 128 - 1;
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32;
    const int tig = lane & 3;
    const int r_lo = 64 * cw + 16 * warp + (lane >> 2);  // keys r_lo and r_lo + 8
    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

    if (sc.count() > 0) {
      const float sl2 = scale * LOG2E;
      const uint32_t sk = smem_u32(smem) + cw * 64 * L::SW;
      const uint32_t sv = smem_u32(smem + L::OFF_V) + cw * 64 * L::SW;
      float s[32], dp[32];
      int q0 = 0;
      Cursor cur;
      // S^T = K Q^T and dP^T = V dO^T of tile t, [64 keys x 64 queries]
      // each, as two commit groups
      auto issue_sdp = [&](int t) {
        const int st = t % KV_STAGES;
        sc.next(cur, q0);
        mbar_wait(q_full + st, (t / KV_STAGES) & 1);
        issue_ss<T, D, KV_BK, KV_BQ>(s, sk, smem_u32(smem + L::OFF_Q + st * L::Q_BYTES));
        wgmma_commit();
        issue_ss<T, D, KV_BK, KV_BQ>(dp, sv, smem_u32(smem + L::OFF_DO + st * L::Q_BYTES));
        wgmma_commit();
      };
      mbar_wait(kv_full, 0);
      for (int t = 0; t < sc.count(); ++t) {
        const int st = t % KV_STAGES;
        fence_regs(dk);
        fence_regs(dv);
        wgmma_fence();
        issue_sdp(t);
        const uint32_t sq = smem_u32(smem + L::OFF_Q + st * L::Q_BYTES);
        const uint32_t sdo = smem_u32(smem + L::OFF_DO + st * L::Q_BYTES);
        const float* lse2 = reinterpret_cast<const float*>(smem + L::OFF_LSE + st * L::R_BYTES);
        const float* dlt = reinterpret_cast<const float*>(smem + L::OFF_DELTA + st * L::R_BYTES);
        wgmma_wait<1>();  // S^T is done, dP^T may still run
        fence_regs(s);
        // P^T of key row r, query column c, selected to 0 where masked
        const bool masked = sc.need_mask(q0);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = 8 * j + 2 * tig + (e & 1);
            const float p = ex2(fmaf(s[4 * j + e], sl2, -lse2[c]));
            s[4 * j + e] =
                masked && !sc.m.allowed(q0 + c, sc.k0 + r_lo + 8 * (e >> 1)) ? 0.f : p;
          }
        }
        wgmma_wait<0>();
        fence_regs(dp);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            dp[4 * j + e] = grad_s(s[4 * j + e], dp[4 * j + e], dlt[8 * j + 2 * tig + (e & 1)]);
          }
        }
        // dV += P^T dO and dK += dS^T Q, P and dS rounded to T
        uint32_t pp[16], pd[16];
        pack_acc<T, 32>(pp, s);
        pack_acc<T, 32>(pd, dp);
        fence_regs(pp);
        fence_regs(pd);
        fence_regs(dk);
        fence_regs(dv);
        wgmma_fence();
        issue_rs<T, D, KV_BQ>(dv, pp, sdo);
        issue_rs<T, D, KV_BQ>(dk, pd, sq);
        wgmma_commit();
        // the slot is free once these products are done; the next tile's
        // S^T and dP^T are issued after them (queueing them behind these
        // made ptxas serialize the products: the bwd_queued variant)
        wgmma_wait<0>();
        fence_regs(dk);
        fence_regs(dv);
        fence_regs(pp);
        fence_regs(pd);
        __syncwarp();
        if (lane == 0) mbar_arrive(q_empty + st);
      }
    }

    // epilogue: dK * scale and dV of keys r_lo and r_lo + 8
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int key = sc.k0 + r_lo + 8 * i;
      if (key >= Sk) continue;
      const long long at = (((long long)sc.b * Sk + key) * H + sc.h) * D + 2 * tig;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<uint32_t*>(dk_out + at + 8 * j) =
            pack2<T>(dk[4 * j + 2 * i] * scale, dk[4 * j + 2 * i + 1] * scale);
        *reinterpret_cast<uint32_t*>(dv_out + at + 8 * j) =
            pack2<T>(dv[4 * j + 2 * i], dv[4 * j + 2 * i + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// dQ: one CTA per (128 query rows, b*h), looping over DQ_BK-key tiles
// ---------------------------------------------------------------------------

constexpr int DQ_BQ = 128;  // query rows per CTA
constexpr int DQ_BK = 128;  // keys per tile
constexpr int DQ_STAGES = 2;

// Shared layout: Q and dO (128 rows each), DQ_STAGES slots of K and of V
// (DQ_BK rows each), then the barriers.
template <int D>
struct DqSmem {
  static constexpr int ROW = 2 * D;
  static constexpr int SW = sw16<D>();
  static constexpr int Q_BYTES = DQ_BQ * ROW;  // Q, and dO
  static constexpr int K_BYTES = DQ_BK * ROW;  // one slot of K, or of V
  static constexpr int OFF_DO = Q_BYTES;
  static constexpr int OFF_K = 2 * Q_BYTES;
  static constexpr int OFF_V = OFF_K + DQ_STAGES * K_BYTES;
  static constexpr int OFF_BAR = OFF_V + DQ_STAGES * K_BYTES;
  static constexpr int N_BARS = 1 + 4 * DQ_STAGES;  // Q and dO; K, V full; K, V empty
  static constexpr size_t BYTES = OFF_BAR + N_BARS * 8 + 1024;
};

// The key tiles one dQ CTA visits: DQ_BK-key tiles from 0 on.
struct DqSched {
  int b, h, q0, n_tiles;
  bool rows_any_cond;
  Mask m;

  __device__ int count() const { return n_tiles; }
  __device__ void next(Cursor& c, int& k0) const { k0 = c.a++ * DQ_BK; }
  // CTA-uniform: element masks only on a tile at a bound
  __device__ bool need_mask(int k0) const {
    return (rows_any_cond && m.k_off + k0 + DQ_BK > m.ncond) || k0 + DQ_BK > m.k_end;
  }
};

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                    const float* __restrict__ rows, int ld, T* __restrict__ dq_out, int H, int Sq,
                    int Sk, int ncond, int kv_valid, int q_off, int k_off, float scale) {
  using L = DqSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::OFF_BAR);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + DQ_STAGES;
  uint64_t* k_empty = v_full + DQ_STAGES;
  uint64_t* v_empty = k_empty + DQ_STAGES;

  const int bh = blockIdx.x;
  DqSched sc;
  sc.b = bh / H;
  sc.h = bh % H;
  sc.q0 = (gridDim.y - 1 - blockIdx.y) * DQ_BQ;  // the noise rows' long walks first
  sc.m = Mask{ncond, q_off, k_off, key_end(Sk, kv_valid, k_off)};
  // keys visited: [0, k_stop) — the ragged edge, the kv_valid bound, and
  // for an all-conditioning CTA the end of the conditioning keys
  const int q_rows = min(DQ_BQ, Sq - sc.q0);
  const bool rows_all_cond = ncond > 0 && q_off + sc.q0 + q_rows <= ncond;
  sc.rows_any_cond = ncond > 0 && q_off + sc.q0 < ncond;
  int k_stop = sc.m.k_end;
  if (rows_all_cond) k_stop = min(k_stop, max(0, ncond - k_off));
  sc.n_tiles = (k_stop + DQ_BK - 1) / DQ_BK;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int st = 0; st < DQ_STAGES; ++st) {
      mbar_init(k_full + st, 1);
      mbar_init(v_full + st, 1);
      mbar_init(k_empty + st, 8);  // one arrival per consumer warp
      mbar_init(v_empty + st, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer: one thread issues every load
    reg_dealloc<BWD_PRODUCER_REGS>();
    if (threadIdx.x == 0 && sc.count() > 0) {
      mbar_expect_tx(q_full, 2 * L::Q_BYTES);
#pragma unroll
      for (int c = 0; c < L::ROW / L::SW; ++c) {
        tma_load_4d(smem + c * DQ_BQ * L::SW, tq, q_full, c * L::SW / 2, sc.h, sc.q0, sc.b);
        tma_load_4d(smem + L::OFF_DO + c * DQ_BQ * L::SW, tdo, q_full, c * L::SW / 2, sc.h,
                    sc.q0, sc.b);
      }
      Cursor cur;
      for (int t = 0; t < sc.count(); ++t) {
        const int st = t % DQ_STAGES;
        const uint32_t ph = (t / DQ_STAGES) & 1;
        int k0;
        sc.next(cur, k0);
        mbar_wait(k_empty + st, ph ^ 1);
        mbar_expect_tx(k_full + st, L::K_BYTES);
#pragma unroll
        for (int c = 0; c < L::ROW / L::SW; ++c) {
          tma_load_4d(smem + L::OFF_K + st * L::K_BYTES + c * DQ_BK * L::SW, tk, k_full + st,
                      c * L::SW / 2, sc.h, k0, sc.b);
        }
        mbar_wait(v_empty + st, ph ^ 1);
        mbar_expect_tx(v_full + st, L::K_BYTES);
#pragma unroll
        for (int c = 0; c < L::ROW / L::SW; ++c) {
          tma_load_4d(smem + L::OFF_V + st * L::K_BYTES + c * DQ_BK * L::SW, tv, v_full + st,
                      c * L::SW / 2, sc.h, k0, sc.b);
        }
      }
    }
  } else {
    // consumers: 64 query rows per warpgroup
    reg_alloc<BWD_CONSUMER_REGS>();
    const int cw = threadIdx.x / 128 - 1;
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32;
    const int tig = lane & 3;
    const int r_lo = 64 * cw + 16 * warp + (lane >> 2);  // rows r_lo and r_lo + 8
    // lse (log2 units) and delta of the two rows; rows past Sq have zero
    // Q and dO, so their (unstored) dS is 0 whatever P is
    float lse2[2], dlt[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = sc.q0 + r_lo + 8 * i;
      const bool ok = row < Sq;
      lse2[i] = ok ? rows[(long long)bh * ld + row] : 0.f;
      dlt[i] = ok ? rows[((long long)gridDim.x + bh) * ld + row] : 0.f;
    }
    float dq[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

    if (sc.count() > 0) {
      const float sl2 = scale * LOG2E;
      const uint32_t sq = smem_u32(smem) + cw * 64 * L::SW;
      const uint32_t sdo = smem_u32(smem + L::OFF_DO) + cw * 64 * L::SW;
      float s[DQ_BK / 2], dp[DQ_BK / 2];
      int k0 = 0;
      Cursor cur;
      // S = Q K^T and dP = dO V^T of tile t, [64 rows x DQ_BK keys] each,
      // as two commit groups
      auto issue_sdp = [&](int t) {
        const int st = t % DQ_STAGES;
        const uint32_t ph = (t / DQ_STAGES) & 1;
        sc.next(cur, k0);
        mbar_wait(k_full + st, ph);
        issue_ss<T, D, DQ_BQ, DQ_BK>(s, sq, smem_u32(smem + L::OFF_K + st * L::K_BYTES));
        wgmma_commit();
        mbar_wait(v_full + st, ph);
        issue_ss<T, D, DQ_BQ, DQ_BK>(dp, sdo, smem_u32(smem + L::OFF_V + st * L::K_BYTES));
        wgmma_commit();
      };
      mbar_wait(q_full, 0);
      for (int t = 0; t < sc.count(); ++t) {
        const int st = t % DQ_STAGES;
        fence_regs(dq);
        wgmma_fence();
        issue_sdp(t);
        const uint32_t sk = smem_u32(smem + L::OFF_K + st * L::K_BYTES);
        wgmma_wait<1>();  // S is done, dP may still run
        fence_regs(s);
        // P of row r, key column c, selected to 0 where masked
        const bool masked = sc.need_mask(k0);
#pragma unroll
        for (int j = 0; j < DQ_BK / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = ex2(fmaf(s[4 * j + e], sl2, -lse2[e >> 1]));
            s[4 * j + e] = masked && !sc.m.allowed(sc.q0 + r_lo + 8 * (e >> 1),
                                                   k0 + 8 * j + 2 * tig + (e & 1))
                               ? 0.f
                               : p;
          }
        }
        wgmma_wait<0>();
        fence_regs(dp);
        __syncwarp();
        if (lane == 0) mbar_arrive(v_empty + st);
#pragma unroll
        for (int j = 0; j < DQ_BK / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            dp[4 * j + e] = grad_s(s[4 * j + e], dp[4 * j + e], dlt[e >> 1]);
          }
        }
        // dQ += dS K, dS rounded to T
        uint32_t a[DQ_BK / 4];
        pack_acc<T, DQ_BK / 2>(a, dp);
        fence_regs(a);
        fence_regs(dq);
        wgmma_fence();
        issue_rs<T, D, DQ_BK>(dq, a, sk);
        wgmma_commit();
        // the K slot is free once this product is done
        wgmma_wait<0>();
        fence_regs(dq);
        fence_regs(a);
        __syncwarp();
        if (lane == 0) mbar_arrive(k_empty + st);
      }
    }

    // epilogue: dQ * scale of rows r_lo and r_lo + 8
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = sc.q0 + r_lo + 8 * i;
      if (row >= Sq) continue;
      T* out = dq_out + (((long long)sc.b * Sq + row) * H + sc.h) * D + 2 * tig;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<uint32_t*>(out + 8 * j) =
            pack2<T>(dq[4 * j + 2 * i] * scale, dq[4 * j + 2 * i + 1] * scale);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *dout, *rows;
  void *dq, *dk, *dv;
  int B, H, Sq, Sk, ld;
  long long q_bs, q_ts, k_bs, k_ts, v_bs, v_ts, do_bs, do_ts;
  int ncond, kv_valid, q_off, k_off;
  float scale;
};

template <typename T, int D>
int launch_d(bool dkv, const Args& a, cudaStream_t stream) {
  const CUtensorMapDataType dt = std::is_same<T, __half>::value
                                     ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const int q_rows = dkv ? KV_BQ : DQ_BQ, k_rows = dkv ? KV_BK : DQ_BK;
  CUtensorMap tq, tk, tv, tdo, trows;
  int rc = encode_rows(&tq, a.q, dt, 2, a.B, a.Sq, a.H, D, a.q_ts, a.q_bs, q_rows);
  if (rc == 0) rc = encode_rows(&tdo, a.dout, dt, 2, a.B, a.Sq, a.H, D, a.do_ts, a.do_bs, q_rows);
  if (rc == 0) rc = encode_rows(&tk, a.k, dt, 2, a.B, a.Sk, a.H, D, a.k_ts, a.k_bs, k_rows);
  if (rc == 0) rc = encode_rows(&tv, a.v, dt, 2, a.B, a.Sk, a.H, D, a.v_ts, a.v_bs, k_rows);
  if (rc == 0 && dkv) rc = encode_f32_rows(&trows, a.rows, 2 * a.B * a.H, a.Sq, a.ld, KV_BQ);
  if (rc != 0) return rc;
  if (dkv) {
    dim3 grid(a.B * a.H, (a.Sk + KV_BK - 1) / KV_BK);
    return (int)launch(flash_bwd_dkv_kernel<T, D>, grid, DkvSmem<D>::BYTES, stream, tq, tk, tv,
                       tdo, trows, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.H, a.Sq,
                       a.Sk, a.ncond, a.kv_valid, a.q_off, a.k_off, a.scale);
  }
  dim3 grid(a.B * a.H, (a.Sq + DQ_BQ - 1) / DQ_BQ);
  return (int)launch(flash_bwd_dq_kernel<T, D>, grid, DqSmem<D>::BYTES, stream, tq, tk, tv,
                     tdo, static_cast<const float*>(a.rows), a.ld, static_cast<T*>(a.dq), a.H,
                     a.Sq, a.Sk, a.ncond, a.kv_valid, a.q_off, a.k_off, a.scale);
}

template <typename T>
int dispatch_d(bool dkv, int D, const Args& a, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch_d<T, 32>(dkv, a, stream);
    case 64:
      return launch_d<T, 64>(dkv, a, stream);
    case 128:
      return launch_d<T, 128>(dkv, a, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

int run(bool dkv, const Args& a, int D, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_d<__nv_bfloat16>(dkv, D, a, s);
  if (dtype == 1) return dispatch_d<__half>(dkv, D, a, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry points (bound with ctypes). dtype: 0 = bf16, 1 = fp16.
// rows: the [2, B*H, ld] fp32 lse (log2 units) and delta rows. Strides
// are in bytes: batch (bs) and token (ts) of each operand, whose [H, D]
// rows are contiguous. Each returns the cudaError_t of its launch (0 on
// success), or hopper::ENCODE_ERROR + the driver's CUresult when a tensor
// map cannot be encoded.
extern "C" int lc_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                               const void* rows, void* dq, int B, int H, int Sq, int Sk, int D,
                               int dtype, int ld, long long q_bs, long long q_ts, long long k_bs,
                               long long k_ts, long long v_bs, long long v_ts, long long do_bs,
                               long long do_ts, int ncond, int kv_valid, int q_off, int k_off,
                               float scale, void* stream) {
  const Args a{q,    k,    v,    dout, rows,  dq,    nullptr, nullptr, B,     H,     Sq,
               Sk,   ld,   q_bs, q_ts, k_bs,  k_ts,  v_bs,    v_ts,    do_bs, do_ts, ncond,
               kv_valid, q_off, k_off, scale};
  return run(false, a, D, dtype, stream);
}

extern "C" int lc_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                const void* rows, void* dk, void* dv, int B, int H, int Sq,
                                int Sk, int D, int dtype, int ld, long long q_bs, long long q_ts,
                                long long k_bs, long long k_ts, long long v_bs, long long v_ts,
                                long long do_bs, long long do_ts, int ncond, int kv_valid,
                                int q_off, int k_off, float scale, void* stream) {
  const Args a{q,    k,    v,    dout, rows,  nullptr, dk,    dv,   B,     H,     Sq,
               Sk,   ld,   q_bs, q_ts, k_bs,  k_ts,    v_bs,  v_ts, do_bs, do_ts, ncond,
               kv_valid, q_off, k_off, scale};
  return run(true, a, D, dtype, stream);
}
