// What the flash-attention sources (flash_fwd.cu, flash_bwd.cu) share:
// - the tile geometry: the problem's strides and sizes, which (row, key)
//   pairs the causal mask, the window and the ragged edge leave visible,
//   and the live key range of a q tile, so that the forward's live range
//   and the backward's come from one definition;
// - the table behind each library's <source>_kernel_count and
//   <source>_kernel_attributes entry points (what the compiler gave every
//   instantiation).

#pragma once

#include <cuda_runtime.h>

namespace flash {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;

struct Strides {
  long long b, h, s;  // in elements; the last dim is contiguous
};

struct Problem {
  int H, H_kv, groups, S_q, S_k, causal, window, q_shift;
  float scale;
};

inline Problem make_problem(int H, int H_kv, int S_q, int S_k, int causal,
                            int window, int q_shift, float scale) {
  return Problem{H, H_kv, H / H_kv, S_q, S_k, causal, window, q_shift, scale};
}

// Whether q row r (at causal position r + q_shift) sees key c, whatever
// S_q: the key lies inside S_k and, under causality, at or before the
// row's position and inside its window
__device__ __forceinline__ bool sees_key(int r, int c, const Problem& p) {
  if (c >= p.S_k) return false;
  if (p.causal) {
    const int pos = r + p.q_shift;
    if (c > pos) return false;
    if (p.window > 0 && c <= pos - p.window) return false;
  }
  return true;
}

// Whether q row r sees key c: inside both lengths, and under causality at
// or before the row's position r + q_shift and inside its window
__device__ __forceinline__ bool visible(int r, int c, const Problem& p) {
  return r < p.S_q && sees_key(r, c, p);
}

// Whether every (row, key) pair of the tile at rows q0.., keys k0.. is
// visible, so no element needs the mask
__device__ __forceinline__ bool tile_is_full(int q0, int k0,
                                             const Problem& p) {
  if (q0 + kBlockQ > p.S_q || k0 + kBlockK > p.S_k) return false;
  if (!p.causal) return true;
  if (k0 + kBlockK - 1 > q0 + p.q_shift) return false;
  return p.window <= 0 || k0 > q0 + kBlockQ - 1 + p.q_shift - p.window;
}

// Live keys [begin, end) of the q tile at q_start, begin a tile boundary
__device__ __forceinline__ void live_keys(int q_start, const Problem& p,
                                          int& begin, int& end) {
  const int q_last = min(q_start + kBlockQ, p.S_q) - 1;
  begin = 0;
  end = p.S_k;
  if (p.causal) {
    end = min(q_last + p.q_shift + 1, p.S_k);
    if (p.window > 0) {
      begin = max(q_start + p.q_shift - p.window + 1, 0) / kBlockK * kBlockK;
    }
  }
}

// One instantiation of a library's kernel table
struct KernelInfo {
  const char* name;  // "<kernel> <dtype> <D>"
  cudaError_t (*attributes)(cudaFuncAttributes*);
  int dynamic_smem;  // what its launch asks for, in bytes
};

// Fills in entry `which` of `table`: its name, registers a thread, local
// memory a thread (spills), static shared memory and the dynamic shared
// memory its launch asks for, all in bytes.  Returns a cudaError_t.
template <int N>
int kernel_attributes(const KernelInfo (&table)[N], int which,
                      const char** name, int* registers, int* local_bytes,
                      int* static_smem, int* dynamic_smem) {
  if (which < 0 || which >= N) return cudaErrorInvalidValue;
  cudaFuncAttributes a;
  const cudaError_t err = table[which].attributes(&a);
  if (err != cudaSuccess) return err;
  *name = table[which].name;
  *registers = a.numRegs;
  *local_bytes = static_cast<int>(a.localSizeBytes);
  *static_smem = static_cast<int>(a.sharedSizeBytes);
  *dynamic_smem = table[which].dynamic_smem;
  return cudaSuccess;
}

}  // namespace flash

// The plain C entry points <PREFIX>_kernel_count() and
// <PREFIX>_kernel_attributes(which, &name, &registers, &local_bytes,
// &static_smem, &dynamic_smem) over the kernel table TABLE
#define FLASH_KERNEL_ATTRIBUTE_ENTRIES(PREFIX, TABLE)                         \
  extern "C" int PREFIX##_kernel_count() {                                    \
    return static_cast<int>(sizeof(TABLE) / sizeof(TABLE[0]));                \
  }                                                                           \
  extern "C" int PREFIX##_kernel_attributes(                                  \
      int which, const char** name, int* registers, int* local_bytes,         \
      int* static_smem, int* dynamic_smem) {                                  \
    return flash::kernel_attributes(TABLE, which, name, registers,            \
                                    local_bytes, static_smem, dynamic_smem);  \
  }
