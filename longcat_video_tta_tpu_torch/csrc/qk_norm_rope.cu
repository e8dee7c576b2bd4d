// The q/k prologue of LongCat's attention for Hopper (sm_90a): per-head
// RMSNorm and half-split RoPE in one pass over q and k, forward and
// backward.
//
// Replaces no TPU kernel: the JAX package writes rms_norm followed by
// apply_rope (longcat_video_tta_tpu/ops/layers.py) and leaves their fusion
// to XLA. In PyTorch the two ran as about fourteen elementwise kernels per
// tensor, each a pass over device memory with fp32 temporaries in between.
//
// Forward, per row x (one head of one token: DH contiguous 16-bit values,
// the rows addressed with a batch and a token stride, so q and k are read
// straight out of the fused qkv projection):
//   rstd = rsqrt(mean(x^2) + eps), v = x * rstd * w   (w: row of batch b
//   takes lane b % V of a [V, DH] fp32 weight),
//   y = [va * c - vb * s, vb * c + va * s]            (ROPE: the token's
//   fp32 cos/sin of the [T, DH/2] tables; without ROPE y = v),
// all in fp32 registers and rounded once, at the store into a contiguous
// [B, T, H, DH] output.
// Backward, per row: rstd again from x (which it reads anyway, with the
// forward's instructions, so the same value: nothing but x is kept between
// the two), du = R^T dy, xh = x * rstd, g = w * du,
//   dx = rstd * (g - xh * mean(xh * g)), written in the 16-bit type;
//   dw = sum over the rows of xh * du, as per-CTA fp32 partials that a
//   second kernel sums in a fixed order (deterministic, no atomics).
//
// Bound on an H100: bytes. The forward reads 2 and writes 2 bytes per
// element (the cos/sin rows, DH fp32 per token, are shared by the token's
// H heads and come from L1/L2); the backward reads x and dy and writes dx,
// 6 bytes per element. Design: a row per DH/8 lanes, 8 values (16 bytes)
// per lane, so that every load and store is one 16-byte access and a warp
// covers 32 / (DH/8) neighbouring rows. The sum of squares is a shuffle
// over the row's lanes; the rotation pairs element i with i + DH/2, which
// sits DH/16 lanes away: one __shfl_xor. A CTA walks ROWS consecutive
// rows of one batch row (2 tokens x 32 heads at DH 128), so a token's
// cos/sin row is fetched from device memory once. q and k go in one
// launch, their CTAs side by side along the grid's x.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int ROWS = 64;  // rows per CTA
constexpr unsigned FULL = 0xffffffffu;

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <> __device__ __forceinline__ float to_f(__half x) { return __half2float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ __nv_bfloat16 from_f(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half from_f(float x) { return __float2half_rn(x); }

template <typename T>
__device__ __forceinline__ void load8(const T* p, float (&f)[8]) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int e = 0; e < 8; ++e) f[e] = to_f(v[e]);
}

template <typename T>
__device__ __forceinline__ void store8(T* p, const float (&f)[8]) {
  uint4 raw;
  T* v = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = from_f<T>(f[e]);
  *reinterpret_cast<uint4*>(p) = raw;
}

__device__ __forceinline__ void load8f(const float* p, float (&f)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

// One of q and k.
struct Side {
  const void* x;   // element (b, t, h, i) at b * x_bs + t * x_ts + h * DH + i
  const void* dy;  // backward: contiguous [B, T, H, DH]
  void* out;       // y (forward) or dx (backward): contiguous [B, T, H, DH]
  const float* w;  // [V, DH]
  float* part;     // backward: dw partials [B, nblk, DH], or null (no dw)
  long long x_bs, x_ts;
  int T, V, nblk;  // tokens per batch row, weight lanes, CTAs per batch row
};

struct Args {
  Side s0, s1;
  const float* cos;  // [T, DH/2] (ROPE: both sides have T tokens)
  const float* sin;
  int H;
  float eps;
};

// The rotation's cos/sin for the 8 values of lane l of a row: pair index
// (l % (LPR/2)) * 8 + e of the token's table row.
template <int DH>
__device__ __forceinline__ void load_rot(const Args& a, int t, int l, float (&c)[8],
                                         float (&s)[8]) {
  constexpr int HL = DH / 16;
  const long long off = (long long)t * (DH / 2) + (l % HL) * 8;
  load8f(a.cos + off, c);
  load8f(a.sin + off, s);
}

template <int DH>
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = DH / 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// rsqrt(mean(x^2) + eps) of the row whose 8 values of this lane are v.
template <int DH>
__device__ __forceinline__ float row_rstd(const float (&v)[8], float eps) {
  float ss = 0.f;
#pragma unroll
  for (int e = 0; e < 8; ++e) ss += v[e] * v[e];
  return rsqrtf(row_sum<DH>(ss) * (1.f / DH) + eps);
}

template <typename T, int DH, bool ROPE>
__global__ void __launch_bounds__(THREADS) lc_qk_norm_rope_fwd(const Args a) {
  constexpr int LPR = DH / 8, HL = LPR / 2, GROUPS = THREADS / LPR, ITER = ROWS / GROUPS;
  const bool second = blockIdx.x >= a.s0.nblk;
  const Side s = second ? a.s1 : a.s0;
  const int blk = second ? blockIdx.x - a.s0.nblk : blockIdx.x;
  const int b = blockIdx.y;
  const int g = threadIdx.x / LPR, l = threadIdx.x % LPR;
  const int rows = s.T * a.H;
  float w[8];
  load8f(s.w + (b % s.V) * DH + l * 8, w);
  const T* x = static_cast<const T*>(s.x) + (long long)b * s.x_bs + l * 8;
  T* y = static_cast<T*>(s.out) + (long long)b * rows * DH + l * 8;
#pragma unroll
  for (int it = 0; it < ITER; ++it) {
    // every lane runs the shuffles: a row past the end reads the last
    // row and stores nothing
    const int r = blk * ROWS + it * GROUPS + g;
    const bool valid = r < rows;
    const int rr = valid ? r : rows - 1;
    const int t = rr / a.H, h = rr - t * a.H;
    float v[8];
    load8(x + (long long)t * s.x_ts + h * DH, v);
    const float rs = row_rstd<DH>(v, a.eps);
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = v[e] * rs * w[e];
    if (ROPE) {
      float c[8], sn[8];
      load_rot<DH>(a, t, l, c, sn);
      const bool lo = l < HL;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float p = __shfl_xor_sync(FULL, v[e], HL);
        v[e] = lo ? v[e] * c[e] - p * sn[e] : v[e] * c[e] + p * sn[e];
      }
    }
    if (valid) store8(y + (long long)r * DH, v);
  }
}

template <typename T, int DH, bool ROPE>
__global__ void __launch_bounds__(THREADS) lc_qk_norm_rope_bwd(const Args a) {
  constexpr int LPR = DH / 8, HL = LPR / 2, GROUPS = THREADS / LPR, ITER = ROWS / GROUPS;
  __shared__ float red[GROUPS * DH];
  const bool second = blockIdx.x >= a.s0.nblk;
  const Side s = second ? a.s1 : a.s0;
  const int blk = second ? blockIdx.x - a.s0.nblk : blockIdx.x;
  const int b = blockIdx.y;
  const int g = threadIdx.x / LPR, l = threadIdx.x % LPR;
  const int rows = s.T * a.H;
  float w[8], acc[8];
  load8f(s.w + (b % s.V) * DH + l * 8, w);
#pragma unroll
  for (int e = 0; e < 8; ++e) acc[e] = 0.f;
  const T* x = static_cast<const T*>(s.x) + (long long)b * s.x_bs + l * 8;
  const T* dy = static_cast<const T*>(s.dy) + (long long)b * rows * DH + l * 8;
  T* dx = static_cast<T*>(s.out) + (long long)b * rows * DH + l * 8;
#pragma unroll
  for (int it = 0; it < ITER; ++it) {
    const int r = blk * ROWS + it * GROUPS + g;
    const bool valid = r < rows;
    const int rr = valid ? r : rows - 1;
    const int t = rr / a.H, h = rr - t * a.H;
    float xv[8], d[8];
    load8(x + (long long)t * s.x_ts + h * DH, xv);
    load8(dy + (long long)rr * DH, d);
    const float rs = row_rstd<DH>(xv, a.eps);
    if (ROPE) {  // d <- R^T d
      float c[8], sn[8];
      load_rot<DH>(a, t, l, c, sn);
      const bool lo = l < HL;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float p = __shfl_xor_sync(FULL, d[e], HL);
        d[e] = lo ? d[e] * c[e] + p * sn[e] : d[e] * c[e] - p * sn[e];
      }
    }
    float gv[8], dot = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      xv[e] *= rs;  // xh
      gv[e] = w[e] * d[e];
      dot += xv[e] * gv[e];
    }
    const float m = row_sum<DH>(dot) * (1.f / DH);
#pragma unroll
    for (int e = 0; e < 8; ++e) gv[e] = rs * (gv[e] - xv[e] * m);
    if (valid) {
      store8(dx + (long long)r * DH, gv);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] += xv[e] * d[e];
    }
  }
  if (s.part == nullptr) return;  // the same for the whole CTA
#pragma unroll
  for (int e = 0; e < 8; ++e) red[g * DH + l * 8 + e] = acc[e];
  __syncthreads();
  for (int i = threadIdx.x; i < DH; i += THREADS) {
    float sum = 0.f;
    for (int k = 0; k < GROUPS; ++k) sum += red[k * DH + i];
    s.part[((long long)b * s.nblk + blk) * DH + i] = sum;
  }
}

// dw[v, j] = the sum of the partials of the batch rows b with b % V == v,
// in a fixed order: each of a CTA's STRIPES threads of a column sums every
// STRIPES-th (b, CTA) pair, then the stripes are added in turn. A CTA takes
// DW_COLS columns of one lane; blockIdx.z picks q's (0) or k's (1) side.
struct DwArgs {
  const float* part[2];
  float* dw[2];
  int V[2], nblk[2];
  int B, D;
};

constexpr int DW_COLS = 32;

__global__ void __launch_bounds__(THREADS) lc_qk_norm_rope_dw(const DwArgs a) {
  constexpr int STRIPES = THREADS / DW_COLS;
  __shared__ float red[THREADS];
  const int side = blockIdx.z, v = blockIdx.x;
  const float* part = side ? a.part[1] : a.part[0];
  const int V = side ? a.V[1] : a.V[0], nblk = side ? a.nblk[1] : a.nblk[0];
  if (part == nullptr || v >= V) return;
  const int c = threadIdx.x % DW_COLS, st = threadIdx.x / DW_COLS;
  const int j = blockIdx.y * DW_COLS + c;
  const int n = (a.B / V) * nblk;
  float sum = 0.f;
#pragma unroll 4
  for (int i = st; i < n; i += STRIPES)
    sum += part[((long long)(v + V * (i / nblk)) * nblk + i % nblk) * a.D + j];
  red[threadIdx.x] = sum;
  __syncthreads();
  if (st == 0) {
    float tot = 0.f;
    for (int k = 0; k < STRIPES; ++k) tot += red[k * DW_COLS + c];
    (side ? a.dw[1] : a.dw[0])[v * a.D + j] = tot;
  }
}

int cdiv(int a, int b) { return (a + b - 1) / b; }

template <typename T, int DH>
cudaError_t launch(bool bwd, bool rope, const Args& a, int B, cudaStream_t stream) {
  dim3 grid(a.s0.nblk + a.s1.nblk, B);
  if (grid.x == 0 || B == 0) return cudaSuccess;
  if (bwd) {
    if (rope)
      lc_qk_norm_rope_bwd<T, DH, true><<<grid, THREADS, 0, stream>>>(a);
    else
      lc_qk_norm_rope_bwd<T, DH, false><<<grid, THREADS, 0, stream>>>(a);
  } else {
    if (rope)
      lc_qk_norm_rope_fwd<T, DH, true><<<grid, THREADS, 0, stream>>>(a);
    else
      lc_qk_norm_rope_fwd<T, DH, false><<<grid, THREADS, 0, stream>>>(a);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int D, bool bwd, bool rope, const Args& a, int B, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32>(bwd, rope, a, B, stream);
    case 64: return launch<T, 64>(bwd, rope, a, B, stream);
    case 128: return launch<T, 128>(bwd, rope, a, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

Side make_side(const void* x, const void* dy, void* out, const void* w, void* part,
               long long x_bs, long long x_ts, int T, int V, int H) {
  Side s{x, dy, out, static_cast<const float*>(w), static_cast<float*>(part), x_bs, x_ts, T, V,
         out == nullptr ? 0 : cdiv(T * H, ROWS)};
  return s;
}

}  // namespace

// Rows of one batch row per CTA: the dw partials are [B, ceil(T*H / rows), D].
extern "C" int lc_qk_norm_rope_rows_per_cta() { return ROWS; }

// xq, xk: 16-bit rows as above (element strides x_bs, x_ts; [H, D] rows
// contiguous); yq, yk: contiguous [B, T, H, D] of the same type; wq, wk:
// fp32 [V, D]; cos, sin: fp32 [T, D/2] or null
// (no rotation; then Tq and Tk may differ). A side with a null output is
// skipped. Returns the cudaError_t of the launch.
extern "C" int lc_qk_norm_rope_fwd_launch(
    const void* xq, const void* xk, void* yq, void* yk, const void* wq, const void* wk,
    const void* cos, const void* sin, int B, int H, int D, int Tq, int Tk, int Vq, int Vk,
    long long q_bs, long long q_ts, long long k_bs, long long k_ts, float eps, int dtype,
    void* stream) {
  Args a{make_side(xq, nullptr, yq, wq, nullptr, q_bs, q_ts, Tq, Vq, H),
         make_side(xk, nullptr, yk, wk, nullptr, k_bs, k_ts, Tk, Vk, H),
         static_cast<const float*>(cos), static_cast<const float*>(sin), H, eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool rope = cos != nullptr;
  if (dtype == 0) return (int)dispatch<__nv_bfloat16>(D, false, rope, a, B, s);
  if (dtype == 1) return (int)dispatch<__half>(D, false, rope, a, B, s);
  return (int)cudaErrorInvalidValue;
}

// The backward of the above: dyq, dyk contiguous [B, T, H, D]; dxq, dxk
// the same (a null dx skips its side); pq, pk the dw partials
// [B, ceil(T*H / rows_per_cta), D] fp32 and dwq, dwk fp32 [V, D], or null
// where the weight needs no gradient. Returns the first failing launch's
// cudaError_t.
extern "C" int lc_qk_norm_rope_bwd_launch(
    const void* xq, const void* xk, const void* dyq, const void* dyk, void* dxq, void* dxk,
    const void* wq, const void* wk, const void* cos, const void* sin, void* pq, void* pk,
    void* dwq, void* dwk, int B, int H, int D, int Tq, int Tk, int Vq, int Vk, long long q_bs,
    long long q_ts, long long k_bs, long long k_ts, float eps, int dtype, void* stream) {
  Args a{make_side(xq, dyq, dxq, wq, pq, q_bs, q_ts, Tq, Vq, H),
         make_side(xk, dyk, dxk, wk, pk, k_bs, k_ts, Tk, Vk, H),
         static_cast<const float*>(cos), static_cast<const float*>(sin), H, eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool rope = cos != nullptr;
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0) err = dispatch<__nv_bfloat16>(D, true, rope, a, B, s);
  if (dtype == 1) err = dispatch<__half>(D, true, rope, a, B, s);
  if (err != cudaSuccess || (pq == nullptr && pk == nullptr)) return (int)err;
  DwArgs d{{a.s0.part, a.s1.part}, {static_cast<float*>(dwq), static_cast<float*>(dwk)},
           {Vq, Vk}, {a.s0.nblk, a.s1.nblk}, B, D};
  lc_qk_norm_rope_dw<<<dim3(Vq > Vk ? Vq : Vk, D / DW_COLS, 2), THREADS, 0, s>>>(d);
  return (int)cudaGetLastError();
}
