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
// stride and a token stride (in bytes) so strided views (k and v sliced
// out of a fused projection) need no copy. o is [B, Sq, H, D] in the
// input dtype and lse is [B, Sq, H] fp32.
//
// Bound on an H100 (989 TFLOP/s bf16 dense, 3.35 TB/s): at the LongCat
// decode shapes (Sq, Sk in the thousands, D = 128) the work is
// 4*Sq*Sk*D*H*B FLOP against (2*Sq + 2*Sk)*H*D*B*2 bytes, i.e. hundreds
// of FLOP per byte, far above the card's ~295 FLOP/byte ridge: the
// kernel is bound by tensor-core operations, which only wgmma reaches.
//
// Design: hopper_common.cuh's attn_cta (one TMA producer warpgroup, two
// wgmma consumer warpgroups of 64 query rows, K/V in a two-slot ring of
// 128-key tiles, the softmax of tile t overlapping the PV product of
// tile t-1). This file gives it the schedule:
//  - key tiles [0, k_stop) in order: k_stop is the ragged edge Sk, the
//    kv_valid bound, and for a CTA whose rows are all conditioning the
//    end of the conditioning keys, so that CTA stops at the first noise
//    key tile; tiles past kv_valid are never loaded;
//  - element masks on global indices only where a tile straddles the
//    ncond or the key bound (a CTA-uniform branch). With 128-key tiles
//    the 6240- and 3120-token prefixes fall inside a tile.

#include "hopper_common.cuh"

namespace {

using namespace hopper;

template <typename T, int D>
struct FlashSched {
  int b, h, q0, Sq, H, ncond, q_off, k_off, k_end, n_tiles, bh = 0;
  bool rows_any_cond;
  T* o;
  float* lse;

  __device__ int count() const { return n_tiles; }
  __device__ void next(Cursor& c, int& k0, int& kend) const {
    k0 = c.a++ * BK;
    kend = k_end;
  }
  __device__ bool need_mask(int k0, int kend) const {
    return (rows_any_cond && k_off + k0 + BK > ncond) || k0 + BK > kend;
  }
  __device__ bool allowed(int r, int col, int kend) const {
    return col < kend && (ncond == 0 || q_off + q0 + r >= ncond || k_off + col < ncond);
  }
  __device__ float qscale(int) const { return 1.f; }
  __device__ T* o_row(int r) const {
    return q0 + r < Sq ? o + ((long long)(b * Sq + q0 + r) * H + h) * D : nullptr;
  }
  __device__ float* lse_row(int r) const {
    return q0 + r < Sq ? lse + (long long)(b * Sq + q0 + r) * H + h : nullptr;
  }
};

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, T* __restrict__ o,
                 float* __restrict__ lse, int H, int Sq, int Sk, int ncond, int kv_valid,
                 int q_off, int k_off, float scale) {
  FlashSched<T, D> sc;
  sc.q0 = blockIdx.x * BQ;
  sc.b = blockIdx.y / H;
  sc.h = blockIdx.y % H;
  sc.Sq = Sq;
  sc.H = H;
  sc.ncond = ncond;
  sc.q_off = q_off;
  sc.k_off = k_off;
  sc.o = o;
  sc.lse = lse;
  // keys visited: [0, k_stop) — the ragged edge, the kv_valid bound, and
  // for an all-conditioning CTA the end of the conditioning keys
  int k_end = Sk;
  if ((long long)kv_valid - k_off < k_end) k_end = max(0, kv_valid - k_off);
  const int q_rows = min(BQ, Sq - sc.q0);
  const bool rows_all_cond = ncond > 0 && q_off + sc.q0 + q_rows <= ncond;
  sc.rows_any_cond = ncond > 0 && q_off + sc.q0 < ncond;
  int k_stop = k_end;
  if (rows_all_cond) k_stop = min(k_stop, max(0, ncond - k_off));
  sc.k_end = k_end;
  sc.n_tiles = (k_stop + BK - 1) / BK;
  attn_cta<T, D, false>(tq, tk, tv, tv, sc, scale);
}

template <typename T, int D>
int launch_d(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H,
             int Sq, int Sk, long long q_bs, long long q_ts, long long k_bs, long long k_ts,
             long long v_bs, long long v_ts, int ncond, int kv_valid, int q_off, int k_off,
             float scale, cudaStream_t stream) {
  const CUtensorMapDataType dt = std::is_same<T, __half>::value
                                     ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap tq, tk, tv;
  int rc = encode_rows(&tq, q, dt, 2, B, Sq, H, D, q_ts, q_bs, BQ);
  if (rc == 0) rc = encode_rows(&tk, k, dt, 2, B, Sk, H, D, k_ts, k_bs, BK);
  if (rc == 0) rc = encode_rows(&tv, v, dt, 2, B, Sk, H, D, v_ts, v_bs, BK);
  if (rc != 0) return rc;
  dim3 grid((Sq + BQ - 1) / BQ, B * H);
  return (int)launch(flash_fwd_kernel<T, D>, grid, AttnSmem<D, false>::BYTES, stream, tq, tk,
                     tv, static_cast<T*>(o), lse, H, Sq, Sk, ncond, kv_valid, q_off, k_off,
                     scale);
}

template <typename T>
int dispatch_d(int D, const void* q, const void* k, const void* v, void* o, float* lse, int B,
               int H, int Sq, int Sk, long long q_bs, long long q_ts, long long k_bs,
               long long k_ts, long long v_bs, long long v_ts, int ncond, int kv_valid,
               int q_off, int k_off, float scale, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch_d<T, 32>(q, k, v, o, lse, B, H, Sq, Sk, q_bs, q_ts, k_bs, k_ts, v_bs,
                             v_ts, ncond, kv_valid, q_off, k_off, scale, stream);
    case 64:
      return launch_d<T, 64>(q, k, v, o, lse, B, H, Sq, Sk, q_bs, q_ts, k_bs, k_ts, v_bs,
                             v_ts, ncond, kv_valid, q_off, k_off, scale, stream);
    case 128:
      return launch_d<T, 128>(q, k, v, o, lse, B, H, Sq, Sk, q_bs, q_ts, k_bs, k_ts, v_bs,
                              v_ts, ncond, kv_valid, q_off, k_off, scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). dtype: 0 = bf16, 1 = fp16.
// Strides are in bytes: batch (bs) and token (ts) of each operand, whose
// [H, D] rows are contiguous. Returns the cudaError_t of the launch (0 on
// success), or hopper::ENCODE_ERROR + the driver's CUresult when a tensor
// map cannot be encoded.
extern "C" int lc_flash_fwd(const void* q, const void* k, const void* v, void* o,
                            void* lse, int B, int H, int Sq, int Sk, int D, int dtype,
                            long long q_bs, long long q_ts, long long k_bs,
                            long long k_ts, long long v_bs, long long v_ts, int ncond,
                            int kv_valid, int q_off, int k_off, float scale,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* lse_f = static_cast<float*>(lse);
  if (dtype == 0) {
    return dispatch_d<__nv_bfloat16>(D, q, k, v, o, lse_f, B, H, Sq, Sk, q_bs, q_ts, k_bs,
                                     k_ts, v_bs, v_ts, ncond, kv_valid, q_off, k_off, scale,
                                     s);
  }
  if (dtype == 1) {
    return dispatch_d<__half>(D, q, k, v, o, lse_f, B, H, Sq, Sk, q_bs, q_ts, k_bs, k_ts,
                              v_bs, v_ts, ncond, kv_valid, q_off, k_off, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}
