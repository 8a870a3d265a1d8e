// Tensor-core building blocks for the port's bf16 kernels on Hopper
// (sm_90a): 16-byte cp.async copies into XOR-swizzled shared-memory tiles,
// ldmatrix fragment loads, and the m16n8k16 bf16 mma.sync with fp32
// accumulators.
//
// Fragment layouts of mma.sync.m16n8k16 (g = lane / 4, t = lane % 4):
// - A (16 x 16, row-major): a0 = (row g, cols 2t, 2t+1), a1 = (row g+8,
//   same cols), a2 = (row g, cols 2t+8, 2t+9), a3 = (row g+8, same cols);
// - B (16 x 8, k x n): b0 = (k 2t, 2t+1; col g), b1 = (k 2t+8, 2t+9; col g);
// - C (16 x 8, fp32): c0, c1 = (row g, cols 2t, 2t+1), c2, c3 = (row g+8,
//   same cols).
// So the C tiles of two neighbouring 8-column blocks, rounded to bf16 in
// pairs, are the A fragment of the next product over those 16 columns
// (pack_a_fragment): a probability tile never goes through shared memory.
//
// Tiles are 64 rows of D bf16 values (D = 64 or 128), row-major, each row
// cut into D / 8 chunks of 16 bytes.  Chunk c of row r is stored at chunk
// c ^ (r % 8) of that row, so the 8 row addresses of one ldmatrix (8 rows,
// one chunk each) fall in 8 different 16-byte bank groups: no bank
// conflicts, with or without .trans.

#pragma once

#include <cuda_bf16.h>
#include <cstdint>

namespace tc {

constexpr int kTileRows = 64;

__device__ __forceinline__ uint32_t smem_address(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; with valid false nothing is read and the 16
// bytes are zero-filled (src-size 0)
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_address(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared, zero-filled when not valid
__device__ __forceinline__ void cp_async_4(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_address(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8 x 8 b16 matrices; lanes 8i .. 8i+7 give the row addresses of
// matrix i, and r[i] is this lane's pair of matrix i (row g, cols 2t, 2t+1;
// with .trans: rows 2t, 2t+1 of col g)
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_address(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_address(p)));
}

// c += a * b on the tensor cores: bf16 operands, fp32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two fp32 values rounded to bf16 (nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A fragment over 16 columns from the fp32 C tiles of its two 8-column
// halves, each value rounded to bf16
__device__ __forceinline__ void pack_a_fragment(uint32_t (&a)[4],
                                                const float (&lo)[4],
                                                const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// element offset of chunk `chunk` (8 values) of row `row` in a swizzled
// [64, D] tile
template <int D>
__device__ __forceinline__ int swizzle(int row, int chunk) {
  return row * D + ((chunk ^ (row & 7)) << 3);
}

// Per-lane ldmatrix addresses (element offsets into a swizzled tile).
//
// A operand, rows row0 .. row0+15, k columns 16 ks .. 16 ks + 15:
// matrices (rows 0-7, k 0-7), (rows 8-15, k 0-7), (rows 0-7, k 8-15),
// (rows 8-15, k 8-15) are a0 .. a3.
template <int D>
__device__ __forceinline__ int a_offset(int row0, int ks, int lane) {
  return swizzle<D>(row0 + (lane & 15), 2 * ks + (lane >> 4));
}

// B operand read as B[k][n] = tile[n][k] (a product with the tile
// transposed, e.g. Q K^T from row-major K): tile rows n0 .. n0+15 are the
// n index, columns 16 ks .. 16 ks + 15 the k index; r[0], r[1] are b0, b1
// of n0 .. n0+7 and r[2], r[3] those of n0+8 .. n0+15.
template <int D>
__device__ __forceinline__ int b_offset(int n0, int ks, int lane) {
  return swizzle<D>(n0 + (lane & 7) + ((lane >> 4) << 3),
                    2 * ks + ((lane >> 3) & 1));
}

// B operand read as B[k][n] = tile[k][n] through ldmatrix .trans (e.g.
// dS K from row-major K): tile rows k0 .. k0+15 are the k index, columns
// 16 nb .. 16 nb + 15 the n index; r[0], r[1] are b0, b1 of columns
// 16 nb .. +7 and r[2], r[3] those of 16 nb + 8 .. +15.
template <int D>
__device__ __forceinline__ int bt_offset(int k0, int nb, int lane) {
  return swizzle<D>(k0 + (lane & 7) + (((lane >> 3) & 1) << 3),
                    2 * nb + (lane >> 4));
}

// Start copying rows first .. first+63 of a [len, D] bf16 matrix (row
// stride `stride` elements, rows 16-byte aligned) into a swizzled tile;
// rows past len are zero-filled.  kThreads threads share the copy; the
// caller commits and waits.
template <int D, int kThreads>
__device__ __forceinline__ void load_tile_async(__nv_bfloat16* tile,
                                                const __nv_bfloat16* base,
                                                long long stride, int first,
                                                int len) {
  constexpr int kChunks = D / 8;
  static_assert(kTileRows * kChunks % kThreads == 0, "whole copies a thread");
#pragma unroll
  for (int i = 0; i < kTileRows * kChunks / kThreads; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int r = e / kChunks, c = e % kChunks;
    const int row = first + r;
    const bool valid = row < len;
    // an invalid row reads nothing; its address stays inside the matrix
    const __nv_bfloat16* src = base + (valid ? row : 0) * stride + c * 8;
    cp_async_16(tile + swizzle<D>(r, c), src, valid);
  }
}

}  // namespace tc
