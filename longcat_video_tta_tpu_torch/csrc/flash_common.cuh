// Building blocks shared by the flash-attention kernels (flash_fwd.cu,
// flash_bwd.cu): the warp-level tensor-core product (mma.sync m16n8k16,
// bf16 or fp16 in, fp32 accumulate), ldmatrix fragment loads, and
// cp.async copies into padded shared tiles.
//
// Fragment layouts of mma.m16n8k16 (lane = 4 * g + tig):
//   A 16x16 row-major: a0 = A[g][2tig..], a1 = A[g+8][2tig..],
//                      a2 = A[g][2tig+8..], a3 = A[g+8][2tig+8..];
//   B 16x8 "col":      b0 = B[2tig..][g], b1 = B[2tig+8..][g];
//   C 16x8 fp32:       c0,c1 = C[g][2tig..], c2,c3 = C[g+8][2tig..].
// The C layout of two adjacent n8 blocks is exactly the A layout of a
// 16x16 operand, so a score tile turns into the A operand of the next
// product with a pack to 16 bits and no shuffle.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

constexpr float LOG2E = 1.4426950408889634f;

template <typename T> struct Mma;

template <> struct Mma<__nv_bfloat16> {
  static __device__ __forceinline__ void run(float (&c)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};

template <> struct Mma<__half> {
  static __device__ __forceinline__ void run(float (&c)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};

// A 16x16 score block (accumulators of n8 blocks n and n + 1) rounded
// to T as the A operand of the next product.
template <typename T>
__device__ __forceinline__ void to_a_frag(uint32_t (&a)[4], const float (&lo)[4],
                                          const float (&hi)[4]) {
  a[0] = Mma<T>::pack(lo[0], lo[1]);
  a[1] = Mma<T>::pack(lo[2], lo[3]);
  a[2] = Mma<T>::pack(hi[0], hi[1]);
  a[3] = Mma<T>::pack(hi[2], hi[3]);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// Fragment addresses into a padded [rows][LD] shared tile. For the A
// operand of rows [r0, r0+16) x cols [c0, c0+16) (non-transposed load):
template <int LD, typename T>
__device__ __forceinline__ const T* a_frag_ptr(const T* tile, int r0, int c0, int lane) {
  return tile + (r0 + (lane & 15)) * LD + c0 + (lane >> 4) * 8;
}
// For the B operand of two n8 blocks whose "n" runs along the tile's rows
// [n0, n0+16) and whose "k" runs along its columns [k0, k0+16)
// (non-transposed load; regs 0,1 = block n0, regs 2,3 = block n0+8):
template <int LD, typename T>
__device__ __forceinline__ const T* b_frag_ptr(const T* tile, int n0, int k0, int lane) {
  return tile + (n0 + (lane & 7) + (lane >> 4) * 8) * LD + k0 + ((lane >> 3) & 1) * 8;
}
// For the B operand whose "k" runs along the tile's rows [k0, k0+16) and
// whose "n" runs along its columns [n0, n0+16) (transposed load):
template <int LD, typename T>
__device__ __forceinline__ const T* bt_frag_ptr(const T* tile, int k0, int n0, int lane) {
  return tile + (k0 + (lane & 15)) * LD + n0 + (lane >> 4) * 8;
}

// 16-byte global -> shared copy; with valid == false nothing is read and
// the 16 shared bytes are zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

// 4-byte global -> shared copy, zero-filled when valid == false.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Start copying rows [row0, row0 + ROWS) of one head into a shared tile
// padded to D + 8 elements per row (16 bytes: every ldmatrix is then
// conflict-free); rows at or past `nrows` are zero-filled.
template <typename T, int D, int ROWS, int NTHREADS>
__device__ __forceinline__ void load_tile_async(T* dst, const T* src, long long tstride,
                                                int row0, int nrows) {
  constexpr int CHUNKS = D / 8;  // 16-byte chunks per row
  constexpr int LD = D + 8;
#pragma unroll
  for (int c = threadIdx.x; c < ROWS * CHUNKS; c += NTHREADS) {
    const int r = c / CHUNKS;
    const int cc = c % CHUNKS;
    const bool ok = row0 + r < nrows;
    const T* g = ok ? src + (long long)(row0 + r) * tstride + cc * 8 : src;
    cp_async16(dst + r * LD + cc * 8, g, ok);
  }
}

// The LongCat mask on global indices: a conditioning query (index <
// ncond) sees only conditioning keys; key indices >= k_end are invalid.
__device__ __forceinline__ bool allowed(int q_glob, int k_loc, int k_off, int ncond,
                                        int k_end) {
  return k_loc < k_end && (ncond == 0 || q_glob >= ncond || k_off + k_loc < ncond);
}

}  // namespace flash
