// Block-sparse attention (BSA) for Hopper (sm_90a): the token-block sum
// that feeds block selection, and the gathered flash-attention forward
// over the selected key blocks, in 16-bit and with int8 QK^T.
//
// Replaces:
//  - longcat_video_tta_tpu/ops/bsa.py::_block_sum_kernel (:120; driven by
//    _block_sum :124, pallas_call :130) -> block_sum_kernel below;
//  - longcat_video_tta_tpu/ops/bsa.py::_bsa_kernel (:159; driven by
//    bsa_attention :229, pallas_call :357), both its 16-bit and its
//    qk_int8 variant -> bsa_fwd_kernel<T, D, INT8> below.
//
// Kernel 4, block sum: x [B, S, H, D] (16-bit, addressed with a batch and
// a token stride) -> out fp32 [B, nb, H, D], out[b, j] = sum of x[b, t]
// over the tokens t of block j (the last block sums only its real
// tokens; the caller never pads). Bound on an H100: bytes. It reads
// B*S*H*D*2 bytes and writes B*nb*H*D*4, at a few FLOP per byte. Design:
// one CTA per (256 columns of H*D, block, batch); each of its 8 warps
// sums every 8th token of the block, each lane 16 bytes (8 values) per
// token, in fp32 registers; the 8 partial sums meet in shared memory.
// Hundreds of CTAs with many independent 16-byte loads each keep enough
// bytes in flight to stream at memory rate.
//
// Kernel 5, gathered attention, per (batch b, head h, query row i of
// q-block qb = i / block_q): keys j of the blocks idx[b*H+h, qb, :] (each
// block_k keys), j < bound = min(Sk, kv_valid):
//   16-bit: s = (q_i . k_j) * scale (fp32), o_i = sum_j softmax(s) v_j with
//           P rounded to v's dtype before the PV product;
//   int8:   q, k int8 with fp32 scales qs [B, Sq, H], ks [B*H, Sk];
//           s = (float(int32 q_i . k_j) * (qs_i * scale)) * ks_j,
//           p = bf16(exp(bf16(s - m))) at the running max m, l summed in
//           fp32 from the bf16 p, PV in the 16-bit type.
// Masked keys get s = -inf, so p = 0 in both modes (the TPU kernel left p
// unmasked in int8 mode and relied on a later tile's alpha = 0; the
// result is the same for every row that sees an allowed key). A row that
// sees no key gives o = 0. No lse is written (the TPU kernel has none).
// Bound on an H100: at the decode shapes (1024-token blocks, top_k 6-10,
// D = 128) there are 4*D FLOP per selected (query, key) pair against
// q, o and the gathered K/V bytes, hundreds of FLOP per byte: tensor-core
// operations (int8 QK^T at twice the 16-bit rate).
// Design: the B1 forward kernel's mainloop (hopper_common.cuh attn_cta:
// a TMA producer warpgroup, two wgmma consumer warpgroups, K/V in a
// two-slot ring of 128-key tiles), walking the selected blocks: the CTA
// reads its q-block's row of idx (what scalar prefetch did on the TPU)
// and the producer issues each selected block's tiles, which is only
// another tile coordinate for TMA. int8 QK^T runs on wgmma .s8.s8.s32
// (k32 steps, both operands K-major: int8 wgmma has no transpose) and PV
// on the 16-bit form. The per-key scales are strided by H floats in
// [B, Sk, H], which no TMA box can take (its inner extent must be a
// multiple of 16 bytes): the wrapper passes them as [B*H, Sk] rows
// padded to 4 values, and each tile's 128 scales come in by TMA on the
// K slot's barrier.

#include <math.h>

#include "hopper_common.cuh"

namespace {

using namespace hopper;

template <typename T> __device__ __forceinline__ float to_float(T x);
template <> __device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <> __device__ __forceinline__ float to_float(__half x) { return __half2float(x); }

// ---------------------------------------------------------------------------
// Kernel 4: token-block sums
// ---------------------------------------------------------------------------

constexpr int SUM_WARPS = 8;
constexpr int SUM_COLS = 256;  // 32 lanes x 8 values

template <typename T>
__global__ void __launch_bounds__(SUM_WARPS * 32)
block_sum_kernel(const T* __restrict__ x, float* __restrict__ out, int S, int HD, int bs,
                 int nb, long long x_bs, long long x_ts) {
  __shared__ float part[SUM_WARPS][SUM_COLS];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int blk = blockIdx.y;
  const int b = blockIdx.z;
  const int col = blockIdx.x * SUM_COLS + lane * 8;
  const int t0 = blk * bs;
  const int t1 = min(S, t0 + bs);
  float acc[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) acc[e] = 0.f;
  if (col < HD) {
    const T* base = x + (long long)b * x_bs + col;
#pragma unroll 4
    for (int t = t0 + warp; t < t1; t += SUM_WARPS) {
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(base + (long long)t * x_ts));
      const T* vals = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] += to_float(vals[e]);
    }
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) part[warp][lane * 8 + e] = acc[e];
  __syncthreads();
  const int c = blockIdx.x * SUM_COLS + threadIdx.x;
  if (c < HD) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < SUM_WARPS; ++w) s += part[w][threadIdx.x];
    out[((long long)b * nb + blk) * HD + c] = s;
  }
}

template <typename T>
cudaError_t launch_block_sum(const void* x, float* out, int B, int S, int HD, int bs,
                             int nb, long long x_bs, long long x_ts, cudaStream_t stream) {
  dim3 grid((HD + SUM_COLS - 1) / SUM_COLS, nb, B);
  block_sum_kernel<T><<<grid, SUM_WARPS * 32, 0, stream>>>(static_cast<const T*>(x), out,
                                                           S, HD, bs, nb, x_bs, x_ts);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Kernel 5: gathered attention over the selected key blocks
// ---------------------------------------------------------------------------

// The key tiles of one CTA: for each selected block (idx order, skipping
// negative entries), its 128-key tiles below min(block end, bound). A tile
// never spans two blocks; a block shorter than a tile, or cut by the
// bound, is masked past its end.
template <typename T, int D, bool INT8>
struct BsaSched {
  int b, h, bh, q0, rows, Sq, H, top_k, block_k, bound, tpb, n_tiles;
  const int* sel;
  const float* qs;
  T* o;

  __device__ void init() {
    tpb = (block_k + BK - 1) / BK;
    n_tiles = 0;
    for (int j = 0; j < top_k; ++j) {
      const int blk = __ldg(sel + j);
      if (blk < 0) continue;
      const long long start = (long long)blk * block_k;
      const long long e = min(start + block_k, (long long)bound);
      if (e > start) n_tiles += (int)((e - start + BK - 1) / BK);
    }
  }
  __device__ int count() const { return n_tiles; }
  // c.a: entry of idx, c.b: tile within its block
  __device__ void next(Cursor& c, int& k0, int& kend) const {
    for (;;) {
      const int blk = __ldg(sel + c.a);
      const long long start = (long long)blk * block_k;
      const long long e = min(start + block_k, (long long)bound);
      const long long s0 = start + (long long)c.b * BK;
      if (++c.b == tpb) {
        c.b = 0;
        ++c.a;
      }
      if (blk >= 0 && s0 < e) {
        k0 = (int)s0;
        kend = (int)e;
        return;
      }
    }
  }
  __device__ bool need_mask(int k0, int kend) const { return k0 + BK > kend; }
  __device__ bool allowed(int, int col, int kend) const { return col < kend; }
  __device__ float qscale(int r) const {
    return q0 + r < Sq ? qs[((long long)b * Sq + q0 + r) * H + h] : 0.f;
  }
  __device__ T* o_row(int r) const {
    return r < rows ? o + ((long long)(b * Sq + q0 + r) * H + h) * D : nullptr;
  }
  __device__ float* lse_row(int) const { return nullptr; }
};

// Grid x runs over (q-block, 128-row tile of it): tiles_per_qb =
// ceil(block_q / 128) tiles per q-block, so the CTAs of one (b*h,
// q-block), which gather the same K/V, are launched next to each other
// and L2 serves their repeats. A tile's rows past its q-block's end are
// computed on that q-block's selection and not stored; a tile past the
// end of a ragged last q-block exits at once.
template <typename T, int D, bool INT8>
__global__ void __launch_bounds__(NTHREADS, 1)
bsa_fwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tks,
               const float* __restrict__ qs, const int* __restrict__ idx, T* __restrict__ o,
               int H, int Sq, int nQb, int top_k, int block_q, int block_k, int bound,
               int tiles_per_qb, float scale) {
  const int qb = blockIdx.x / tiles_per_qb;
  const int q0 = qb * block_q + (blockIdx.x % tiles_per_qb) * BQ;
  const int rows = min(BQ, min(Sq, (qb + 1) * block_q) - q0);
  if (rows <= 0) return;  // CTA-uniform, before any barrier exists
  BsaSched<T, D, INT8> sc;
  sc.bh = blockIdx.y;
  sc.b = blockIdx.y / H;
  sc.h = blockIdx.y % H;
  sc.q0 = q0;
  sc.rows = rows;
  sc.Sq = Sq;
  sc.H = H;
  sc.top_k = top_k;
  sc.block_k = block_k;
  sc.bound = bound;
  sc.sel = idx + ((long long)blockIdx.y * nQb + qb) * top_k;
  sc.qs = qs;
  sc.o = o;
  sc.init();
  attn_cta<T, D, INT8>(tq, tk, tv, tks, sc, scale);
}

struct FwdArgs {
  const void *q, *k, *v, *qs, *ks;
  const int* idx;
  void* o;
  int B, H, Sq, Sk;
  long long q_bs, q_ts, k_bs, k_ts, v_bs, v_ts;  // bytes
  int nQb, top_k, block_q, block_k, bound, ks_ld;
  float scale;
};

template <typename T, int D, bool INT8>
int launch_fwd(const FwdArgs& a, cudaStream_t stream) {
  const CUtensorMapDataType dt = std::is_same<T, __half>::value
                                     ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const CUtensorMapDataType qk_dt = INT8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : dt;
  const int qk_esz = INT8 ? 1 : 2;
  CUtensorMap tq, tk, tv, tks;
  int rc = encode_rows(&tq, a.q, qk_dt, qk_esz, a.B, a.Sq, a.H, D, a.q_ts, a.q_bs, BQ);
  if (rc == 0) rc = encode_rows(&tk, a.k, qk_dt, qk_esz, a.B, a.Sk, a.H, D, a.k_ts, a.k_bs, BK);
  if (rc == 0) rc = encode_rows(&tv, a.v, dt, 2, a.B, a.Sk, a.H, D, a.v_ts, a.v_bs, BK);
  if (rc == 0) {
    if (INT8) {
      rc = encode_f32_rows(&tks, a.ks, a.B * a.H, a.ks_ld, a.ks_ld, BK);
    } else {
      tks = tv;  // not read
    }
  }
  if (rc != 0) return rc;
  const int tiles_per_qb = (a.block_q + BQ - 1) / BQ;
  dim3 grid(a.nQb * tiles_per_qb, a.B * a.H);
  return (int)launch(bsa_fwd_kernel<T, D, INT8>, grid, AttnSmem<D, INT8>::BYTES, stream, tq, tk,
                     tv, tks, static_cast<const float*>(a.qs), a.idx, static_cast<T*>(a.o), a.H,
                     a.Sq, a.nQb, a.top_k, a.block_q, a.block_k, a.bound, tiles_per_qb,
                     a.scale);
}

template <typename T, bool INT8>
int dispatch_d(int D, const FwdArgs& a, cudaStream_t stream) {
  switch (D) {
    case 32: return launch_fwd<T, 32, INT8>(a, stream);
    case 64: return launch_fwd<T, 64, INT8>(a, stream);
    case 128: return launch_fwd<T, 128, INT8>(a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry points (bound with ctypes). dtype: 0 = bf16, 1 = fp16.
// Each returns the cudaError_t of the launch (0 on success).

extern "C" int lc_bsa_block_sum(const void* x, void* out, int B, int S, int HD, int bs,
                                int nb, int dtype, long long x_bs, long long x_ts,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (dtype == 0)
    return (int)launch_block_sum<__nv_bfloat16>(x, o, B, S, HD, bs, nb, x_bs, x_ts, s);
  if (dtype == 1) return (int)launch_block_sum<__half>(x, o, B, S, HD, bs, nb, x_bs, x_ts, s);
  return (int)cudaErrorInvalidValue;
}

// q, k: 16-bit [B, S, H, D], or int8 when qk_int8 (then qs is the fp32
// query scales [B, Sq, H] and ks the fp32 key scales [B*H, ks_ld], row
// (b, h) holding key j at column j, ks_ld a multiple of 4); strides in
// bytes. v: [B, Sk, H, D] of type dtype. idx: int32 [B*H, nQb, top_k].
// o: contiguous [B, Sq, H, D] of type dtype. Returns the cudaError_t of
// the launch (0 on success), or hopper::ENCODE_ERROR + the driver's
// CUresult when a tensor map cannot be encoded.
extern "C" int lc_bsa_fwd(const void* q, const void* k, const void* v, const void* qs,
                          const void* ks, const void* idx, void* o, int B, int H, int Sq,
                          int Sk, int D, int dtype, int qk_int8, long long q_bs,
                          long long q_ts, long long k_bs, long long k_ts, long long v_bs,
                          long long v_ts, int nQb, int top_k, int block_q, int block_k,
                          int bound, int ks_ld, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (block_q % 32 || block_k <= 0) return (int)cudaErrorInvalidValue;
  FwdArgs a{q,    k,     v,    qs,   ks,   static_cast<const int*>(idx),
            o,    B,     H,    Sq,   Sk,   q_bs,
            q_ts, k_bs,  k_ts, v_bs, v_ts, nQb,
            top_k, block_q, block_k, bound, ks_ld, scale};
  if (dtype == 0) {
    return qk_int8 ? dispatch_d<__nv_bfloat16, true>(D, a, s)
                   : dispatch_d<__nv_bfloat16, false>(D, a, s);
  }
  if (dtype == 1) {
    return qk_int8 ? dispatch_d<__half, true>(D, a, s) : dispatch_d<__half, false>(D, a, s);
  }
  return (int)cudaErrorInvalidValue;
}
