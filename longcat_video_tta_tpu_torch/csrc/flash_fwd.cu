// Flash-attention forward for Hopper (sm_90a), with the LongCat
// conditioning-prefix mask.
//
// Replaces: longcat_video_tta_tpu/ops/flash_attention.py::_fwd_kernel
// (the Pallas TPU kernel driven by _flash_fwd_impl, pallas_call at :226;
// public entries flash_attention :534 and flash_chunk_fwd :640).
//
// What it computes, per (batch b, head h, query row i):
//   s_ij   = (q_i . k_j) * scale                       (fp32)
//   allowed(i, j) = (ncond == 0 || q_off+i >= ncond || k_off+j < ncond)
//                   && j < Sk && k_off+j < kv_valid
//   o_i    = sum_j softmax_j(s_ij | allowed) v_j       (fp32 accumulation,
//            P rounded to the dtype of v before the PV product)
//   lse_i  = m_i + log(l_i)
// A row that sees no key gives o = 0 and lse = -1e30 (the reference's
// l_safe rule). q is [B, Sq, H, D]; k, v are [B, Sk, H, D]: the merged
// [B, S, H*D] layout the projections produce, addressed with a batch
// stride and a token stride so strided views (v sliced out of a fused
// qkv output) need no copy. o is [B, Sq, H, D] in the input dtype and
// lse is [B, Sq, H] fp32.
//
// Bound on an H100 (989 TFLOP/s bf16 dense, 3.35 TB/s): at the LongCat
// decode shapes (Sq, Sk in the thousands, D = 128) the work is
// 4*Sq*Sk*D*H*B FLOP against (2*Sq + 2*Sk)*H*D*B*2 bytes, i.e. hundreds
// of FLOP per byte, far above the card's ~295 FLOP/byte ridge: the
// kernel is bound by tensor-core operations. Cross-attention (Sk = 512
// text tokens) has ~4x fewer FLOP per byte but is still above the ridge.
//
// Design (FlashAttention-2 style on the sm_80+ warp-level tensor cores):
//  - one CTA of 8 warps per (128-query tile, b*h); each warp owns 16
//    query rows, whose Q fragments stay in registers for the whole loop;
//  - a loop over 64-key tiles. K and V are staged in shared memory by
//    cp.async into two buffers, so tile t+1 streams in while tile t is
//    computed. Rows past Sk are zero-filled by the copy itself (source
//    size 0), so the caller never pads. Shared rows are padded by 16
//    bytes, which makes every ldmatrix conflict-free;
//  - S = Q K^T and O += P V run on mma.sync.m16n8k16 (bf16 or fp16 in,
//    fp32 accumulate) with ldmatrix / ldmatrix.trans fragments. S, P and
//    the O accumulator never leave registers: the S accumulator layout
//    of two adjacent n8 blocks is exactly the A-fragment layout of P;
//  - online softmax in the exp2 domain (scores pre-multiplied by
//    scale*log2 e), with the running max per row shared by the 4 lanes
//    that hold it and the row sum kept per lane, reduced once at the end;
//  - masks are static-shape logic on global indices: only a tile that
//    straddles the ncond or kv bound evaluates element masks (a
//    CTA-uniform branch); a CTA whose rows are all conditioning stops at
//    the first noise key tile, and tiles past kv_valid are never loaded.
// Later work: TMA loads, wgmma, warp specialisation.

#include <math.h>

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int BQ = 128;  // query rows per CTA
constexpr int BK = 64;   // keys per tile
constexpr int NWARPS = BQ / 16;
constexpr int NTHREADS = NWARPS * 32;
constexpr float LSE_EMPTY = -1e30f;
constexpr float LN2 = 0.6931471805599453f;

template <int D>
struct Smem {
  static constexpr int LD = D + 8;  // elements per padded row
  static constexpr int Q = BQ * LD;
  static constexpr int KV = BK * LD;
  static constexpr size_t BYTES = size_t(Q + 4 * KV) * 2;  // Q, 2 x K, 2 x V
};

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int H, int Sq, int Sk,
                 long long q_bs, long long q_ts, long long k_bs, long long k_ts,
                 long long v_bs, long long v_ts, int ncond, int kv_valid,
                 int q_off, int k_off, float scale) {
  using L = Smem<D>;
  constexpr int LD = L::LD;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sK = sQ + L::Q;       // two stages of K
  T* sV = sK + 2 * L::KV;  // two stages of V

  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;  // fragment row group
  const int tig = lane & 3;  // thread in group: fragment column pair
  // global indices of this lane's two rows (g and g + 8 of the warp's 16)
  const int q_glob0 = q_off + q0 + warp * 16 + g;
  const int q_glob1 = q_glob0 + 8;

  const T* qh = q + b * q_bs + (long long)h * D;
  const T* kh = k + b * k_bs + (long long)h * D;
  const T* vh = v + b * v_bs + (long long)h * D;

  // keys visited: [0, k_stop) — the ragged edge, the kv_valid bound, and
  // for an all-conditioning CTA the end of the conditioning keys
  int k_end = Sk;
  if ((long long)kv_valid - k_off < k_end) k_end = max(0, kv_valid - k_off);
  const int q_rows = min(BQ, Sq - q0);
  const bool rows_all_cond = ncond > 0 && q_off + q0 + q_rows <= ncond;
  const bool rows_any_cond = ncond > 0 && q_off + q0 < ncond;
  int k_stop = k_end;
  if (rows_all_cond) k_stop = min(k_stop, max(0, ncond - k_off));
  const int n_tiles = (k_stop + BK - 1) / BK;

  load_tile_async<T, D, BQ, NTHREADS>(sQ, qh, q_ts, q0, Sq);
  if (n_tiles > 0) {
    load_tile_async<T, D, BK, NTHREADS>(sK, kh, k_ts, 0, Sk);
    load_tile_async<T, D, BK, NTHREADS>(sV, vh, v_ts, 0, Sk);
  }
  cp_async_commit();

  const float sl2 = scale * LOG2E;
  uint32_t qf[D / 16][4];
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  }
  float m_r[2] = {-INFINITY, -INFINITY};  // running max (log2 units)
  float l_r[2] = {0.f, 0.f};              // this lane's part of the row sum

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait_all();
    __syncthreads();  // tile t visible; every warp is done with tile t-1
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        ldsm_x4(qf[kk], sQ + (warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
      }
    }
    const int stage = t & 1;
    if (t + 1 < n_tiles) {
      load_tile_async<T, D, BK, NTHREADS>(sK + (stage ^ 1) * L::KV, kh, k_ts, (t + 1) * BK, Sk);
      load_tile_async<T, D, BK, NTHREADS>(sV + (stage ^ 1) * L::KV, vh, v_ts, (t + 1) * BK, Sk);
    }
    cp_async_commit();
    const T* cK = sK + stage * L::KV;
    const T* cV = sV + stage * L::KV;
    const int k0 = t * BK;

    // S[16 x 64] = Q K^T for this warp's rows
    float s[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int n2 = 0; n2 < BK / 16; ++n2) {
        uint32_t kb[4];
        ldsm_x4(kb, cK + (n2 * 16 + (lane & 7) + (lane >> 4) * 8) * LD + kk * 16 +
                        ((lane >> 3) & 1) * 8);
        Mma<T>::run(s[2 * n2], qf[kk], kb[0], kb[1]);
        Mma<T>::run(s[2 * n2 + 1], qf[kk], kb[2], kb[3]);
      }
    }

    // masks, then the online softmax (exp2 domain)
    const bool need_mask = (rows_any_cond && k_off + k0 + BK > ncond) || (k0 + BK > k_end);
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * sl2;
        if (need_mask) {
          const int col = k0 + n * 8 + tig * 2 + (e & 1);
          const int qg = e < 2 ? q_glob0 : q_glob1;
          const bool ok = col < k_end && (ncond == 0 || qg >= ncond || k_off + col < ncond);
          if (!ok) x = -INFINITY;
        }
        s[n][e] = x;
      }
    }
    float alpha[2], base[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = m_r[i];
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * i], s[n][2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      // a row with no allowed key so far keeps max -inf: subtract 0 so
      // its probabilities are exp2(-inf) = 0, not NaN
      base[i] = mx == -INFINITY ? 0.f : mx;
      alpha[i] = exp2f(m_r[i] - base[i]);
      m_r[i] = mx;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = exp2f(s[n][e] - base[e >> 1]);
        rs[e >> 1] += s[n][e];
      }
    }
    l_r[0] = l_r[0] * alpha[0] + rs[0];
    l_r[1] = l_r[1] * alpha[1] + rs[1];
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // O[16 x D] += P[16 x 64] V[64 x D]; P is rounded to T here
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = Mma<T>::pack(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = Mma<T>::pack(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = Mma<T>::pack(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = Mma<T>::pack(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int n2 = 0; n2 < D / 16; ++n2) {
        uint32_t vb[4];
        ldsm_x4_trans(vb, cV + (kk * 16 + (lane & 15)) * LD + n2 * 16 + (lane >> 4) * 8);
        Mma<T>::run(acc[2 * n2], pa, vb[0], vb[1]);
        Mma<T>::run(acc[2 * n2 + 1], pa, vb[2], vb[3]);
      }
    }
  }
  cp_async_wait_all();  // nothing may be in flight when the CTA exits

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_r[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = q0 + warp * 16 + g + 8 * i;
    if (row >= Sq) continue;
    const float l_safe = l == 0.f ? 1.f : l;
    const float inv = 1.f / l_safe;
    T* og = o + ((long long)b * Sq + row) * H * D + (long long)h * D + tig * 2;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<uint32_t*>(og + n * 8) =
          Mma<T>::pack(acc[n][2 * i] * inv, acc[n][2 * i + 1] * inv);
    }
    if (tig == 0) {
      lse[((long long)b * Sq + row) * H + h] = l == 0.f ? LSE_EMPTY : m_r[i] * LN2 + logf(l);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse,
                   int B, int H, int Sq, int Sk, long long q_bs, long long q_ts,
                   long long k_bs, long long k_ts, long long v_bs, long long v_ts,
                   int ncond, int kv_valid, int q_off, int k_off, float scale,
                   cudaStream_t stream) {
  const size_t smem = Smem<D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<T, D><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, H, Sq, Sk, q_bs, q_ts, k_bs, k_ts, v_bs, v_ts, ncond,
      kv_valid, q_off, k_off, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v, void* o,
                       float* lse, int B, int H, int Sq, int Sk, long long q_bs,
                       long long q_ts, long long k_bs, long long k_ts, long long v_bs,
                       long long v_ts, int ncond, int kv_valid, int q_off, int k_off,
                       float scale, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, o, lse, B, H, Sq, Sk, q_bs, q_ts, k_bs, k_ts, v_bs,
                           v_ts, ncond, kv_valid, q_off, k_off, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, lse, B, H, Sq, Sk, q_bs, q_ts, k_bs, k_ts, v_bs,
                           v_ts, ncond, kv_valid, q_off, k_off, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, lse, B, H, Sq, Sk, q_bs, q_ts, k_bs, k_ts, v_bs,
                            v_ts, ncond, kv_valid, q_off, k_off, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). dtype: 0 = bf16, 1 = fp16.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int lc_flash_fwd(const void* q, const void* k, const void* v, void* o,
                            void* lse, int B, int H, int Sq, int Sk, int D, int dtype,
                            long long q_bs, long long q_ts, long long k_bs,
                            long long k_ts, long long v_bs, long long v_ts, int ncond,
                            int kv_valid, int q_off, int k_off, float scale,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* lse_f = static_cast<float*>(lse);
  if (dtype == 0) {
    return (int)dispatch_d<__nv_bfloat16>(D, q, k, v, o, lse_f, B, H, Sq, Sk, q_bs, q_ts,
                                          k_bs, k_ts, v_bs, v_ts, ncond, kv_valid, q_off,
                                          k_off, scale, s);
  }
  if (dtype == 1) {
    return (int)dispatch_d<__half>(D, q, k, v, o, lse_f, B, H, Sq, Sk, q_bs, q_ts, k_bs,
                                   k_ts, v_bs, v_ts, ncond, kv_valid, q_off, k_off, scale,
                                   s);
  }
  return (int)cudaErrorInvalidValue;
}
