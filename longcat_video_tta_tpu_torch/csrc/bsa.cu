// Block-sparse attention (BSA) for Hopper (sm_90a): the token-block sum
// that feeds block selection, and the gathered flash-attention forward
// over the selected key blocks, in 16-bit and with int8 QK^T.
//
// Replaces:
//  - longcat_video_tta_tpu/ops/bsa.py::_block_sum_kernel (:120; driven by
//    _block_sum :124, pallas_call :130) -> block_sum_kernel below;
//  - longcat_video_tta_tpu/ops/bsa.py::_bsa_kernel (:159; driven by
//    bsa_attention :229, pallas_call :357), both its 16-bit and its
//    qk_int8 variant -> bsa_fwd_kernel<T, D, NW, INT8> below.
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
//   int8:   q, k int8 with fp32 scales qs [B, Sq, H], ks [B, Sk, H];
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
// Design: the B1 forward kernel's (flash_fwd.cu) pieces from
// flash_common.cuh: one CTA per (query tile, b*h), whose warps own 16 rows
// each with Q fragments in registers; a loop over the selected blocks in
// 64-key tiles, K/V (and the int8 key scales) double-buffered in shared
// memory by cp.async, rows past a block's valid end zero-filled by the
// copy; S, P and O in registers (mma.sync m16n8k16 bf16/fp16; int8 QK^T on
// mma.sync m16n8k32 .s8.s8.s32, whose fragments have the byte layout of
// the 16-bit ones, so the same ldmatrix loads serve both). The CTA loads
// its own block indices (what scalar prefetch did on the TPU). The query
// tile is 128 rows (8 warps) when block_q is a multiple of 128, else 32
// rows (2 warps), so a tile never spans two q-blocks. Grid x runs over
// query tiles, so the CTAs of one (b*h, q-block), which gather the same
// K/V, are launched next to each other and L2 serves their repeats.
// Later work: TMA loads, wgmma, warp specialisation.

#include <math.h>

#include "flash_common.cuh"

namespace {

using namespace flash;

template <typename T> __device__ __forceinline__ float to_float(T x);
template <> __device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <> __device__ __forceinline__ float to_float(__half x) { return __half2float(x); }

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

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

constexpr int BK = 64;  // keys per tile

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Shared layout. q and k rows are held as 16-bit units: D values in
// 16-bit mode, D bytes (D/2 units) in int8 mode; each row is padded by 16
// bytes so every ldmatrix is conflict-free.
template <int D, int NW, bool INT8>
struct BsaSmem {
  static constexpr int BQ = 16 * NW;
  static constexpr int DQ = INT8 ? D / 2 : D;  // 16-bit units of a q/k row
  static constexpr int QK_LD = DQ + 8;
  static constexpr int V_LD = D + 8;
  static constexpr int Q = BQ * QK_LD;
  static constexpr int K = BK * QK_LD;
  static constexpr int V = BK * V_LD;
  static constexpr size_t BYTES = size_t(Q + 2 * K + 2 * V) * 2 + (INT8 ? 2 * BK * 4 : 0);
};

template <typename T, int D, int NW, bool INT8>
__global__ void __launch_bounds__(NW * 32)
bsa_fwd_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
               const T* __restrict__ v, const float* __restrict__ qs,
               const float* __restrict__ ks, const int* __restrict__ idx,
               T* __restrict__ o, int H, int Sq, int Sk, long long q_bs, long long q_ts,
               long long k_bs, long long k_ts, long long v_bs, long long v_ts, int nQb,
               int top_k, int block_q, int block_k, int bound, float scale) {
  using L = BsaSmem<D, NW, INT8>;
  constexpr int BQ = L::BQ;
  constexpr int NTHREADS = NW * 32;
  constexpr int DQ = L::DQ;
  constexpr int LD = L::QK_LD;
  constexpr int VLD = L::V_LD;
  constexpr int KSTEPS = INT8 ? D / 32 : D / 16;  // k-steps of the QK^T product
  extern __shared__ __align__(128) unsigned char smem[];
  uint16_t* sQ = reinterpret_cast<uint16_t*>(smem);
  uint16_t* sK = sQ + L::Q;                        // two stages
  T* sV = reinterpret_cast<T*>(sK + 2 * L::K);     // two stages
  float* sKs = reinterpret_cast<float*>(sV + 2 * L::V);  // two stages (int8 only)

  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int* sel = idx + ((long long)bh * nQb + q0 / block_q) * top_k;

  const uint16_t* qh = q + b * q_bs + (long long)h * DQ;
  const uint16_t* kh = k + b * k_bs + (long long)h * DQ;
  const T* vh = v + b * v_bs + (long long)h * D;
  const float* ksh = INT8 ? ks + (long long)b * Sk * H + h : nullptr;

  const int tpb = (block_k + BK - 1) / BK;  // tiles per selected block
  const int n_iter = top_k * tpb;
  // key range [k0, kend) of iteration `it` (empty when k0 >= kend)
  auto tile_range = [&](int it, int& k0, int& kend) {
    const int j = it / tpb;
    const int blk = __ldg(sel + j);
    const long long start = (long long)blk * block_k;
    const long long s0 = start + (long long)(it - j * tpb) * BK;
    const long long e0 = min(start + block_k, (long long)bound);
    k0 = (int)min(s0, (long long)bound);
    kend = blk < 0 ? k0 : (int)max(e0, (long long)k0);
  };
  auto load_kv = [&](int it, int stage) {
    int k0, kend;
    tile_range(it, k0, kend);
    load_tile_async<uint16_t, DQ, BK, NTHREADS>(sK + stage * L::K, kh, k_ts, k0, kend);
    load_tile_async<T, D, BK, NTHREADS>(sV + stage * L::V, vh, v_ts, k0, kend);
    if constexpr (INT8) {
      for (int r = threadIdx.x; r < BK; r += NTHREADS) {
        const bool ok = k0 + r < kend;
        cp_async4(sKs + stage * BK + r, ok ? ksh + (long long)(k0 + r) * H : ksh, ok);
      }
    }
  };

  load_tile_async<uint16_t, DQ, BQ, NTHREADS>(sQ, qh, q_ts, q0, Sq);
  if (n_iter > 0) load_kv(0, 0);
  cp_async_commit();

  float qsc[2] = {0.f, 0.f};  // int8: q scale * softmax scale of this lane's two rows
  if constexpr (INT8) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = q0 + warp * 16 + g + 8 * i;
      if (row < Sq) qsc[i] = qs[((long long)b * Sq + row) * H + h] * scale;
    }
  }
  const float sl2 = scale * LOG2E;
  uint32_t qf[KSTEPS][4];
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  // running max: log2 units in 16-bit mode, natural units in int8 mode
  float m_r[2] = {-INFINITY, -INFINITY};
  float l_r[2] = {0.f, 0.f};

  for (int it = 0; it < n_iter; ++it) {
    cp_async_wait_all();
    __syncthreads();  // tile `it` visible; every warp is done with tile it-1
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        ldsm_x4(qf[kk], sQ + (warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
      }
    }
    const int stage = it & 1;
    if (it + 1 < n_iter) load_kv(it + 1, stage ^ 1);
    cp_async_commit();
    int k0, kend;
    tile_range(it, k0, kend);
    if (k0 >= kend) continue;  // CTA-uniform: a ragged block's empty tile
    const uint16_t* cK = sK + stage * L::K;
    const T* cV = sV + stage * L::V;

    float s[BK / 8][4];
    if constexpr (INT8) {
      int si[BK / 8][4];
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) si[n][0] = si[n][1] = si[n][2] = si[n][3] = 0;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
        for (int n2 = 0; n2 < BK / 16; ++n2) {
          uint32_t kb[4];
          ldsm_x4(kb, cK + (n2 * 16 + (lane & 7) + (lane >> 4) * 8) * LD + kk * 16 +
                          ((lane >> 3) & 1) * 8);
          mma_s8(si[2 * n2], qf[kk], kb[0], kb[1]);
          mma_s8(si[2 * n2 + 1], qf[kk], kb[2], kb[3]);
        }
      }
      const float* cKs = sKs + stage * BK;
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[n][e] = ((float)si[n][e] * qsc[e >> 1]) * cKs[n * 8 + tig * 2 + (e & 1)];
        }
      }
    } else {
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
        for (int n2 = 0; n2 < BK / 16; ++n2) {
          uint32_t kb[4];
          ldsm_x4(kb, cK + (n2 * 16 + (lane & 7) + (lane >> 4) * 8) * LD + kk * 16 +
                          ((lane >> 3) & 1) * 8);
          Mma<T>::run(s[2 * n2], qf[kk], kb[0], kb[1]);
          Mma<T>::run(s[2 * n2 + 1], qf[kk], kb[2], kb[3]);
        }
      }
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] *= sl2;
      }
    }

    // keys past the block's valid end (a ragged tail, kv_valid)
    if (k0 + BK > kend) {
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (k0 + n * 8 + tig * 2 + (e & 1) >= kend) s[n][e] = -INFINITY;
        }
      }
    }

    // online softmax
    float alpha[2], base[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = m_r[i];
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * i], s[n][2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      // a row with no allowed key so far keeps max -inf: subtract 0 so
      // its probabilities are exp(-inf) = 0, not NaN
      base[i] = mx == -INFINITY ? 0.f : mx;
      alpha[i] = exp2f(INT8 ? (m_r[i] - base[i]) * LOG2E : m_r[i] - base[i]);
      m_r[i] = mx;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p;
        if constexpr (INT8) {
          // exp of the bf16 argument as exp2(x * log2 e): the same bf16 p
          // as exp(x) but for the last bits of the fp32 intermediate
          p = round_bf16(exp2f(round_bf16(s[n][e] - base[e >> 1]) * LOG2E));
        } else {
          p = exp2f(s[n][e] - base[e >> 1]);
        }
        s[n][e] = p;
        rs[e >> 1] += p;
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

    // O[16 x D] += P[16 x 64] V[64 x D]; P is rounded to T here (exact
    // for the bf16 p of int8 mode)
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pa[4];
      to_a_frag<T>(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int n2 = 0; n2 < D / 16; ++n2) {
        uint32_t vb[4];
        ldsm_x4_trans(vb, cV + (kk * 16 + (lane & 15)) * VLD + n2 * 16 + (lane >> 4) * 8);
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
    const float inv = 1.f / (l == 0.f ? 1.f : l);
    T* og = o + ((long long)b * Sq + row) * H * D + (long long)h * D + tig * 2;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<uint32_t*>(og + n * 8) =
          Mma<T>::pack(acc[n][2 * i] * inv, acc[n][2 * i + 1] * inv);
    }
  }
}

struct FwdArgs {
  const void *q, *k, *v, *qs, *ks;
  const int* idx;
  void* o;
  int B, H, Sq, Sk;
  long long q_bs, q_ts, k_bs, k_ts, v_bs, v_ts;  // q/k in 16-bit units
  int nQb, top_k, block_q, block_k, bound;
  float scale;
};

template <typename T, int D, int NW, bool INT8>
cudaError_t launch_fwd(const FwdArgs& a, cudaStream_t stream) {
  const size_t smem = BsaSmem<D, NW, INT8>::BYTES;
  auto kernel = bsa_fwd_kernel<T, D, NW, INT8>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  constexpr int BQ = 16 * NW;
  dim3 grid((a.Sq + BQ - 1) / BQ, a.B * a.H);
  kernel<<<grid, NW * 32, smem, stream>>>(
      static_cast<const uint16_t*>(a.q), static_cast<const uint16_t*>(a.k),
      static_cast<const T*>(a.v), static_cast<const float*>(a.qs),
      static_cast<const float*>(a.ks), a.idx, static_cast<T*>(a.o), a.H, a.Sq, a.Sk,
      a.q_bs, a.q_ts, a.k_bs, a.k_ts, a.v_bs, a.v_ts, a.nQb, a.top_k, a.block_q,
      a.block_k, a.bound, a.scale);
  return cudaGetLastError();
}

template <typename T, int NW, bool INT8>
cudaError_t dispatch_d(int D, const FwdArgs& a, cudaStream_t stream) {
  switch (D) {
    case 32: return launch_fwd<T, 32, NW, INT8>(a, stream);
    case 64: return launch_fwd<T, 64, NW, INT8>(a, stream);
    case 128: return launch_fwd<T, 128, NW, INT8>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, bool INT8>
cudaError_t dispatch_tile(int D, const FwdArgs& a, cudaStream_t stream) {
  if (a.block_q % 128 == 0) return dispatch_d<T, 8, INT8>(D, a, stream);
  if (a.block_q % 32 == 0) return dispatch_d<T, 2, INT8>(D, a, stream);
  return cudaErrorInvalidValue;
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

// q, k: 16-bit [B, S, H, D], or int8 when qk_int8 (then qs, ks are the
// fp32 scales [B, Sq, H] and [B, Sk, H]); strides in elements of q's and
// k's own type. v: [B, Sk, H, D] of type dtype. idx: int32
// [B*H, nQb, top_k]. o: contiguous [B, Sq, H, D] of type dtype.
extern "C" int lc_bsa_fwd(const void* q, const void* k, const void* v, const void* qs,
                          const void* ks, const void* idx, void* o, int B, int H, int Sq,
                          int Sk, int D, int dtype, int qk_int8, long long q_bs,
                          long long q_ts, long long k_bs, long long k_ts, long long v_bs,
                          long long v_ts, int nQb, int top_k, int block_q, int block_k,
                          int bound, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // int8 rows are addressed in 16-bit units (pairs of int8 values)
  const int div = qk_int8 ? 2 : 1;
  if (qk_int8 && (q_bs % 2 || q_ts % 2 || k_bs % 2 || k_ts % 2 || D % 32))
    return (int)cudaErrorInvalidValue;
  FwdArgs a{q,     k,     v,      qs,    ks,    static_cast<const int*>(idx),
            o,     B,     H,      Sq,    Sk,    q_bs / div,
            q_ts / div, k_bs / div, k_ts / div, v_bs, v_ts, nQb,
            top_k, block_q, block_k, bound, scale};
  if (dtype == 0) {
    return (int)(qk_int8 ? dispatch_tile<__nv_bfloat16, true>(D, a, s)
                         : dispatch_tile<__nv_bfloat16, false>(D, a, s));
  }
  if (dtype == 1) {
    return (int)(qk_int8 ? dispatch_tile<__half, true>(D, a, s)
                         : dispatch_tile<__half, false>(D, a, s));
  }
  return (int)cudaErrorInvalidValue;
}
