// Hopper (sm_90a) building blocks of the attention kernels: TMA tensor
// maps and loads, mbarriers, wgmma descriptors and products, register
// rebalancing, and the one attention mainloop both forward kernels
// (flash_fwd.cu, bsa.cu) run (attn_cta below). The backward kernels
// (flash_bwd.cu) have mainloops of their own on the same pieces: their
// 64-row ss products (issue_ss with N = 64: S^T and dP^T of 64 keys by a
// 64-query tile) and register-A products over tiles of 64 or 128 rows
// read MN-major (issue_rs: dV, dK and dQ), fp32 row maps of lse and
// delta (encode_f32_rows), and the producer/consumer split of attn_cta
// with a 24/240 register split (flash_bwd.cu describes them).
//
// Design of attn_cta, per CTA of 384 threads (3 warpgroups) and one
// 128-row query tile of one (batch, head):
//  - warpgroup 0 is the producer: it gives up registers (setmaxnreg 40)
//    and one elected thread issues every TMA load: Q once, then K and V in
//    128-key tiles through a ring of STAGES slots, each with a full and an
//    empty mbarrier for K and for V (transaction bytes on the full ones);
//  - warpgroups 1 and 2 are consumers (setmaxnreg 232), 64 query rows
//    each. S = Q K^T runs on wgmma m64n128k16 (16-bit) or m64n128k32
//    (.s8.s8.s32) with both operands K-major in shared memory; O += P V on
//    the register-A form, P converted pairwise from the S accumulator and
//    V read MN-major (the transpose bit of 16-bit wgmma);
//  - within a consumer, tile t's S product and tile t-1's PV product are
//    in flight together while nothing else waits: the softmax of tile t
//    (exp2 domain, the scale folded into one FMA) overlaps the PV
//    product of tile t-1. The two consumers are not made to take turns
//    at the tensor cores (ping-pong on named barriers): measured on the
//    H100, that made the decode shape 1.4x slower;
//  - every operand row lands in shared memory through TMA with the 128-,
//    64- or 32-byte swizzle of its row length (a 16-bit row of D = 128 is
//    256 bytes: two 64-column boxes, and the descriptors step across
//    them), which is the layout wgmma reads without bank conflicts.
// Places where trouble is likely, and what the code does about each:
//  - tile counts: the producer and the consumers walk the same schedule
//    object (Sched::count / Sched::next), so they agree on every tile; a
//    mismatch would deadlock the card instead of failing a gate;
//  - descriptors: K-major operands step 32 bytes along K inside a swizzle
//    atom and jump a whole box past it; the MN-major V operand has its
//    8-key groups at SBO = 8 rows and its 64-column boxes at LBO = one
//    box (an O right only in its first 64 columns means LBO is wrong);
//  - registers: each consumer thread holds O (D / 2 fp32), S (64) and P
//    (32 packed pairs); every accumulator is fenced around wgmma so the
//    compiler cannot move its reads across the asynchronous product;
//  - tensor maps: encoded on the host by the driver's
//    cuTensorMapEncodeTiled, fetched with cudaGetDriverEntryPoint (no
//    -lcuda), passed as __grid_constant__ kernel parameters, 4-D (D, H,
//    S, B) with byte strides so strided views need no copy.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace hopper {

constexpr float LOG2E = 1.4426950408889634f;
constexpr int BQ = 128;  // query rows per CTA
constexpr int BK = 128;  // keys per tile
constexpr int STAGES = 2;
constexpr int NTHREADS = 384;
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;  // (40 + 2 * 232) * 128 <= 65536
constexpr float LSE_EMPTY = -1e30f;  // lse of a row that sees no key

// Two fp32 values rounded to T (to nearest even) and packed into one
// 32-bit register, lo in the low half: an element pair of a 16-bit
// wgmma A fragment, or of an output row.
template <typename T> __device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <> __device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
template <> __device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---------------------------------------------------------------------------
// Shared memory, barriers, TMA
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Wait until the barrier's phase differs from `parity`.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap& map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(&map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap& map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(&map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

template <int R>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// Shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units) and the swizzle of the layout (128, 64 or
// 32 bytes). Every tile starts on a 1024-byte boundary, so the base
// offset field stays 0.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              int swizzle_bytes) {
  const uint64_t layout = swizzle_bytes == 128 ? 1 : swizzle_bytes == 64 ? 2 : 3;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of registers that an
// asynchronous wgmma owns across the fence, commit and wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(int (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// Accumulator layout of m64nN (per warp w of the warpgroup, lane = 4 g +
// tig): d[4 j + e] holds row 16 w + g + 8 (e >> 1), column 8 j + 2 tig +
// (e & 1). The register-A operand of a k16 step is the mma.sync A
// fragment, so the S accumulator of n8 blocks 2 kk and 2 kk + 1 is the
// A operand of the PV product's step kk after a pack to 16 bits.
template <typename T> struct Wgmma;

template <> struct Wgmma<__nv_bfloat16> {
  // d[32] (+)= A[64 x 16] . B[64 x 16]^T; A, B K-major in shared memory
  static __device__ __forceinline__ void ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                                int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
        " %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d));
  }
  // d[64] (+)= A[64 x 16] . B[128 x 16]^T; A, B K-major in shared memory
  static __device__ __forceinline__ void ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                                 int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
        " %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43,"
        " %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57,"
        " %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(scale_d));
  }
  // d[16] += A[64 x 16] (registers) . B[16 x 32]; B MN-major in shared memory
  static __device__ __forceinline__ void rs_n32(float (&d)[16], const uint32_t (&a)[4],
                                                uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
  // d[32] += A[64 x 16] (registers) . B[16 x 64]; B MN-major in shared memory
  static __device__ __forceinline__ void rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                                uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
        " %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
  // d[64] += A[64 x 16] (registers) . B[16 x 128]; B MN-major in shared memory
  static __device__ __forceinline__ void rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                                uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
        " %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43,"
        " %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57,"
        " %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
};

template <> struct Wgmma<__half> {
  // d[32] (+)= A[64 x 16] . B[64 x 16]^T; A, B K-major in shared memory
  static __device__ __forceinline__ void ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                                int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
        " %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d));
  }
  // d[64] (+)= A[64 x 16] . B[128 x 16]^T; A, B K-major in shared memory
  static __device__ __forceinline__ void ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                                 int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
        " %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43,"
        " %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57,"
        " %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(scale_d));
  }
  // d[16] += A[64 x 16] (registers) . B[16 x 32]; B MN-major in shared memory
  static __device__ __forceinline__ void rs_n32(float (&d)[16], const uint32_t (&a)[4],
                                                uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.f16.f16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
  // d[32] += A[64 x 16] (registers) . B[16 x 64]; B MN-major in shared memory
  static __device__ __forceinline__ void rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                                uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
        " %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
  // d[64] += A[64 x 16] (registers) . B[16 x 128]; B MN-major in shared memory
  static __device__ __forceinline__ void rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                                uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
        " %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43,"
        " %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57,"
        " %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
};

// d[64] (+)= A[64 x 32] . B[128 x 32]^T in int8 (s32 sums); A, B K-major in
// shared memory
__device__ __forceinline__ void wgmma_s8_ss_n128(int (&d)[64], uint64_t da, uint64_t db,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// x rounded to bf16 (to nearest, ties to even) and back, on the integer
// pipes: the same value as __bfloat162float(__float2bfloat16(x)) for
// every non-NaN x, without the conversion unit's quarter rate.
__device__ __forceinline__ float round_bf16(float x) {
  uint32_t u = __float_as_uint(x);
  u += 0x7FFFu + ((u >> 16) & 1u);
  return __uint_as_float(u & 0xFFFF0000u);
}

// float(x), exact for |x| < 2^22 (an int8 product over D <= 128 keys is
// at most 128 * 127^2 < 2^21), on the integer and fp32 pipes.
__device__ __forceinline__ float small_int_to_float(int x) {
  return __int_as_float(x + 0x4B400000) - 12582912.f;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---------------------------------------------------------------------------
// The attention mainloop
// ---------------------------------------------------------------------------

// Shared layout: Q (128 rows), STAGES slots of K and of V (128 keys
// each), STAGES slots of the int8 key scales, then the barriers. A q/k row
// is QK_ROW bytes (D 16-bit values, or D int8), a v row 2 D bytes; each is
// cut into boxes of its swizzle span (at most 128 bytes), box after box.
template <int D, bool INT8>
struct AttnSmem {
  static constexpr int QK_ROW = INT8 ? D : 2 * D;
  static constexpr int QK_SW = QK_ROW < 128 ? QK_ROW : 128;
  static constexpr int QK_ESZ = INT8 ? 1 : 2;
  static constexpr int V_ROW = 2 * D;
  static constexpr int V_SW = V_ROW < 128 ? V_ROW : 128;
  static constexpr int Q_BYTES = BQ * QK_ROW;
  static constexpr int K_BYTES = BK * QK_ROW;
  static constexpr int V_BYTES = BK * V_ROW;
  static constexpr int KS_BYTES = INT8 ? BK * 4 : 0;
  static constexpr int OFF_K = Q_BYTES;
  static constexpr int OFF_V = OFF_K + STAGES * K_BYTES;
  static constexpr int OFF_KS = OFF_V + STAGES * V_BYTES;
  static constexpr int OFF_BAR = OFF_KS + STAGES * KS_BYTES;
  static constexpr int N_BARS = 1 + 4 * STAGES;  // Q; K, V full; K, V empty
  static constexpr size_t BYTES = OFF_BAR + N_BARS * 8 + 1024;  // + alignment slack
};

// Position of a schedule's walk over its key tiles.
struct Cursor {
  int a = 0, b = 0;
};

// The swizzle span of a 16-bit row of D values: the whole row up to 128
// bytes, and a row of D = 128 (256 bytes) is cut into two boxes.
template <int D>
__host__ __device__ constexpr int sw16() {
  return 2 * D < 128 ? 2 * D : 128;
}

// acc (+)= A B^T over D, 16-bit, both operands K-major in shared memory
// (rows of D values cut into boxes of the swizzle span, box after box):
// A is the 64 rows at sa inside a tile of RA rows per box (a consumer's
// rows), B the N rows (64 or 128) of a tile at sb; K steps of 32 bytes.
template <typename T, int D, int RA, int N>
__device__ __forceinline__ void issue_ss(float (&acc)[N / 2], uint32_t sa, uint32_t sb) {
  constexpr int SW = sw16<D>();
#pragma unroll
  for (int kk = 0; kk < 2 * D / 32; ++kk) {
    const uint32_t box = kk * 32 / SW, within = kk * 32 % SW;
    const uint64_t da = make_desc(sa + box * RA * SW + within, 16, 8 * SW, SW);
    const uint64_t db = make_desc(sb + box * N * SW + within, 16, 8 * SW, SW);
    if constexpr (N == 128) {
      Wgmma<T>::ss_n128(acc, da, db, kk > 0);
    } else {
      static_assert(N == 64, "wgmma ss products of 64 or 128 columns");
      Wgmma<T>::ss_n64(acc, da, db, kk > 0);
    }
  }
}

// acc[64 x D] += A[64 x R] B[R x D], A in registers (R / 4 packed pairs,
// the accumulator layout of a 64 x R product after pack2), B a tile of R
// rows read MN-major: 8-row groups SBO = 8 rows apart, boxes of 64
// columns LBO = one box (R rows) apart.
template <typename T, int D, int R>
__device__ __forceinline__ void issue_rs(float (&acc)[D / 2], const uint32_t (&a)[R / 4],
                                         uint32_t sb) {
  constexpr int SW = sw16<D>();
#pragma unroll
  for (int kk = 0; kk < R / 16; ++kk) {
    const uint32_t ak[4] = {a[4 * kk], a[4 * kk + 1], a[4 * kk + 2], a[4 * kk + 3]};
    const uint64_t db = make_desc(sb + kk * 16 * SW, R * SW, 8 * SW, SW);
    if constexpr (D == 128) {
      Wgmma<T>::rs_n128(acc, ak, db, 1);
    } else if constexpr (D == 64) {
      Wgmma<T>::rs_n64(acc, ak, db, 1);
    } else {
      Wgmma<T>::rs_n32(acc, ak, db, 1);
    }
  }
}

// S (+)= Q K^T for one consumer's 64 rows: sq points at its rows of box 0
// of Q, sk at box 0 of a K slot; K steps of 32 bytes.
template <typename T, int D, bool INT8, typename Acc>
__device__ __forceinline__ void issue_qk(Acc (&acc)[64], uint32_t sq, uint32_t sk) {
  using L = AttnSmem<D, INT8>;
  if constexpr (!INT8) {
    issue_ss<T, D, BQ, BK>(acc, sq, sk);
  } else {
#pragma unroll
    for (int kk = 0; kk < L::QK_ROW / 32; ++kk) {
      const uint32_t box = kk * 32 / L::QK_SW, within = kk * 32 % L::QK_SW;
      const uint64_t da =
          make_desc(sq + box * BQ * L::QK_SW + within, 16, 8 * L::QK_SW, L::QK_SW);
      const uint64_t db =
          make_desc(sk + box * BK * L::QK_SW + within, 16, 8 * L::QK_SW, L::QK_SW);
      wgmma_s8_ss_n128(acc, da, db, kk > 0);
    }
  }
}

// Scores of this thread's 64 (row, key) entries, from the S accumulator:
// q.k unscaled (16-bit; the softmax folds the scale into its exp2) or
// natural units (int8: the int32 sum times the query's and the key's
// scales); masked entries are -inf.
template <bool INT8, typename Acc, class Sched>
__device__ __forceinline__ void scores(float (&s)[64], const Acc (&acc)[64], const Sched& sc,
                                       const float (&qsc)[2], const float* sks, int k0,
                                       int kend, int r_lo, int tig) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if constexpr (INT8) {
        s[4 * j + e] = (small_int_to_float(acc[4 * j + e]) * qsc[e >> 1]) *
                       sks[8 * j + 2 * tig + (e & 1)];
      } else {
        s[4 * j + e] = acc[4 * j + e];
      }
    }
  }
  if (sc.need_mask(k0, kend)) {  // CTA-uniform: only a tile at a bound
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (!sc.allowed(r_lo + 8 * (e >> 1), k0 + 8 * j + 2 * tig + (e & 1), kend)) {
          s[4 * j + e] = -INFINITY;
        }
      }
    }
  }
}

// Online softmax over one tile: s becomes p, (m, l) move to the new
// maximum, alpha is the factor for O. `unit` turns a score difference
// into log2 units: scale * log2 e for the unscaled 16-bit scores, log2 e
// for int8 mode, which keeps the bf16 roundings p = bf16(exp(bf16(s -
// m))).
template <bool INT8>
__device__ __forceinline__ void online_softmax(float (&s)[64], float (&m_r)[2], float (&l_r)[2],
                                               float (&alpha)[2], float unit) {
  float base[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mx = m_r[i];
#pragma unroll
    for (int j = 0; j < 16; ++j) mx = fmaxf(mx, fmaxf(s[4 * j + 2 * i], s[4 * j + 2 * i + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    // a row with no allowed key so far keeps max -inf: subtract 0 so its
    // probabilities are exp(-inf) = 0, not NaN
    base[i] = mx == -INFINITY ? 0.f : mx;
    alpha[i] = ex2((m_r[i] - base[i]) * unit);
    m_r[i] = mx;
  }
  const float nb[2] = {-base[0] * unit, -base[1] * unit};
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float p;
      if constexpr (INT8) {
        p = round_bf16(ex2(round_bf16(s[4 * j + e] - base[e >> 1]) * unit));
      } else {
        p = ex2(fmaf(s[4 * j + e], unit, nb[e >> 1]));
      }
      s[4 * j + e] = p;
      rs[e >> 1] += p;
    }
  }
  l_r[0] = l_r[0] * alpha[0] + rs[0];
  l_r[1] = l_r[1] * alpha[1] + rs[1];
}

// An accumulator's N fp32 values rounded to T in pairs: the A operand of
// a register-A product (issue_rs).
template <typename T, int N>
__device__ __forceinline__ void pack_acc(uint32_t (&p)[N / 2], const float (&s)[N]) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) p[i] = pack2<T>(s[2 * i], s[2 * i + 1]);
}

// One CTA of the attention forward: the producer warpgroup and the two
// consumer warpgroups described at the top of this file. Sched gives the
// tile's (b, h, q0), its key tiles (count, next), the masks, the int8
// query scales and where each row's output goes. tks (the int8 key
// scales, [B*H, Sk] fp32) is read only when INT8.
template <typename T, int D, bool INT8, class Sched>
__device__ __forceinline__ void attn_cta(const CUtensorMap& tq, const CUtensorMap& tk,
                                         const CUtensorMap& tv, const CUtensorMap& tks,
                                         const Sched& sc, float scale) {
  using L = AttnSmem<D, INT8>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::OFF_BAR);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + STAGES;
  uint64_t* k_empty = v_full + STAGES;
  uint64_t* v_empty = k_empty + STAGES;
  const int n_tiles = sc.count();
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int st = 0; st < STAGES; ++st) {
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
    reg_dealloc<PRODUCER_REGS>();
    if (threadIdx.x == 0 && n_tiles > 0) {
      mbar_expect_tx(q_full, L::Q_BYTES);
#pragma unroll
      for (int c = 0; c < L::QK_ROW / L::QK_SW; ++c) {
        tma_load_4d(smem + c * BQ * L::QK_SW, tq, q_full, c * L::QK_SW / L::QK_ESZ, sc.h,
                    sc.q0, sc.b);
      }
      Cursor cur;
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % STAGES;
        const uint32_t ph = (t / STAGES) & 1;
        int k0, kend;
        sc.next(cur, k0, kend);
        mbar_wait(k_empty + st, ph ^ 1);
        mbar_expect_tx(k_full + st, L::K_BYTES + L::KS_BYTES);
#pragma unroll
        for (int c = 0; c < L::QK_ROW / L::QK_SW; ++c) {
          tma_load_4d(smem + L::OFF_K + st * L::K_BYTES + c * BK * L::QK_SW, tk, k_full + st,
                      c * L::QK_SW / L::QK_ESZ, sc.h, k0, sc.b);
        }
        if constexpr (INT8) {
          tma_load_2d(smem + L::OFF_KS + st * L::KS_BYTES, tks, k_full + st, k0, sc.bh);
        }
        mbar_wait(v_empty + st, ph ^ 1);
        mbar_expect_tx(v_full + st, L::V_BYTES);
#pragma unroll
        for (int c = 0; c < L::V_ROW / L::V_SW; ++c) {
          tma_load_4d(smem + L::OFF_V + st * L::V_BYTES + c * BK * L::V_SW, tv, v_full + st,
                      c * L::V_SW / 2, sc.h, k0, sc.b);
        }
      }
    }
  } else {
    // consumers: 64 query rows per warpgroup
    reg_alloc<CONSUMER_REGS>();
    const int cw = threadIdx.x / 128 - 1;
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32;
    const int tig = lane & 3;
    const int r_lo = 64 * cw + 16 * warp + (lane >> 2);  // rows r_lo and r_lo + 8
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m_r[2] = {-INFINITY, -INFINITY};  // unscaled (16-bit), natural (int8)
    float l_r[2] = {0.f, 0.f};              // this lane's part of the row sum
    float qsc[2] = {0.f, 0.f};
    if constexpr (INT8) {
      qsc[0] = sc.qscale(r_lo) * scale;
      qsc[1] = sc.qscale(r_lo + 8) * scale;
    }
    const float unit = INT8 ? LOG2E : scale * LOG2E;
    const uint32_t sq = smem_u32(smem) + cw * 64 * L::QK_SW;
    const uint32_t sk = smem_u32(smem + L::OFF_K);
    const uint32_t sv = smem_u32(smem + L::OFF_V);
    const float* sks = reinterpret_cast<const float*>(smem + L::OFF_KS);
    using Acc = typename std::conditional<INT8, int, float>::type;

    if (n_tiles > 0) {
      uint32_t p[32];
      Cursor cur;
      int k0, kend;
      mbar_wait(q_full, 0);
      // tile 0: S, softmax, P
      {
        sc.next(cur, k0, kend);
        mbar_wait(k_full, 0);
        Acc acc[64];
        wgmma_fence();
        issue_qk<T, D, INT8>(acc, sq, sk);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
        float s[64], alpha[2];
        scores<INT8>(s, acc, sc, qsc, sks, k0, kend, r_lo, tig);
        __syncwarp();
        if (lane == 0) mbar_arrive(k_empty);
        online_softmax<INT8>(s, m_r, l_r, alpha, unit);
        pack_acc<T, 64>(p, s);
      }
      // tile t: S_t and PV_{t-1} in flight together, then softmax of t
      for (int t = 1; t < n_tiles; ++t) {
        const int st = t % STAGES, pst = (t - 1) % STAGES;
        sc.next(cur, k0, kend);
        mbar_wait(k_full + st, (t / STAGES) & 1);
        Acc acc[64];
        fence_regs(o);
        fence_regs(p);
        wgmma_fence();
        issue_qk<T, D, INT8>(acc, sq, sk + st * L::K_BYTES);
        wgmma_commit();
        mbar_wait(v_full + pst, ((t - 1) / STAGES) & 1);
        issue_rs<T, D, BK>(o, p, sv + pst * L::V_BYTES);
        wgmma_commit();
        wgmma_wait<1>();  // S_t is done, PV_{t-1} may still run
        fence_regs(acc);
        float s[64], alpha[2];
        scores<INT8>(s, acc, sc, qsc, sks + st * BK, k0, kend, r_lo, tig);
        __syncwarp();
        if (lane == 0) mbar_arrive(k_empty + st);
        online_softmax<INT8>(s, m_r, l_r, alpha, unit);
        wgmma_wait<0>();
        fence_regs(o);
        fence_regs(p);
        __syncwarp();
        if (lane == 0) mbar_arrive(v_empty + pst);
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          o[4 * j] *= alpha[0];
          o[4 * j + 1] *= alpha[0];
          o[4 * j + 2] *= alpha[1];
          o[4 * j + 3] *= alpha[1];
        }
        pack_acc<T, 64>(p, s);
      }
      // the last tile's PV
      const int lst = (n_tiles - 1) % STAGES;
      mbar_wait(v_full + lst, ((n_tiles - 1) / STAGES) & 1);
      fence_regs(o);
      fence_regs(p);
      wgmma_fence();
      issue_rs<T, D, BK>(o, p, sv + lst * L::V_BYTES);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
    }

    // epilogue: o = O / l (0 for a row with no key), lse = m + log l
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float l = l_r[i];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const int r = r_lo + 8 * i;
      T* orow = sc.o_row(r);
      if (orow != nullptr) {
        const float inv = 1.f / (l == 0.f ? 1.f : l);
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * tig) =
              pack2<T>(o[4 * j + 2 * i] * inv, o[4 * j + 2 * i + 1] * inv);
        }
      }
      float* lrow = sc.lse_row(r);
      if (lrow != nullptr && tig == 0) {
        *lrow = l == 0.f ? LSE_EMPTY : m_r[i] * scale + logf(l);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Host: tensor maps
// ---------------------------------------------------------------------------

// Returned by the entry points when the driver cannot encode a map:
// ENCODE_ERROR + the driver's CUresult (no entry point: + 0).
constexpr int ENCODE_ERROR = 10000;

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled through the runtime, so the
// libraries need no -lcuda.
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &q);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiledFn>(p);
    }
  }
  return fn;
}

// A [B, S, H, D] tensor with contiguous [H, D] rows of esz-byte values,
// as the 4-D map (D, H, S, B) with byte strides (row, ts, bs); a box is
// one swizzle span of a row (at most 128 bytes) by `rows` tokens. Rows
// past S read as zeros.
inline int encode_rows(CUtensorMap* map, const void* base, CUtensorMapDataType dtype, int esz,
                       int B, int S, int H, int D, long long ts, long long bs, int rows) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return ENCODE_ERROR;
  const int row = D * esz, sw = row < 128 ? row : 128;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)row, (cuuint64_t)ts, (cuuint64_t)bs};
  const cuuint32_t box[4] = {(cuuint32_t)(sw / esz), 1, (cuuint32_t)rows, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swz = sw == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : sw == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                            : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = fn(map, dtype, 4, const_cast<void*>(base), dims, strides, box, estr,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swz, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ENCODE_ERROR + (int)r;
}

// fp32 rows of `cols` values, `ld` apart (a multiple of 4: 16-byte
// rows), as a 2-D map with boxes of `box` values of one row; columns past
// `cols` read as zeros.
inline int encode_f32_rows(CUtensorMap* map, const void* base, int rows, int cols, int ld,
                           int box_cols) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return ENCODE_ERROR;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 4};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, 1};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(base), dims,
                        strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ENCODE_ERROR + (int)r;
}

// Sets the kernel's shared memory and launches it on 384 threads per CTA.
template <typename Kernel, typename... Args>
inline cudaError_t launch(Kernel kernel, dim3 grid, size_t smem, cudaStream_t stream,
                          Args... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, NTHREADS, smem, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace hopper
