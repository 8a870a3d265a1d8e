// Cached decode attention for Hopper (sm_90a): one query position a row,
// q [B, H, 1, D], against a KV cache k/v [B, H_kv, S, D] (GQA: query head h
// reads kv head h / (H / H_kv)), each row only over its valid keys.
//
// What it replaces: no TPU kernel.  The JAX package computes this attention
// in plain jnp (kube_sqs_autoscaler_tpu/workloads/decode.py:
// _cached_attention -> _chunk_cached_attention), and the port's plain
// version (workloads/decode.py: _masked_cache_attention) upcast the whole
// cache to fp32 at every step, scored all S positions and masked all but a
// row's valid ones away.  This kernel computes the same function at T = 1.
//
// Valid keys, as _chunk_valid at T = 1: with len = length[b] (the position
// just written), hi = min(len, S - 1) and lo = max(0, hi - window + 1) with
// a window, else 0; row b attends keys lo..hi.  A row at or past the end of
// the cache keeps its last window keys (or all of them) and a finite
// softmax.
//
// What bounds it on this card: bytes.  A decode step does 2 * D multiply-
// adds a (query head, key) for 2 * D * sizeof(T) bytes of K and V a (kv
// head, key): at most 2 * G flops a byte, far below the ~295 a byte where
// the H100's bf16 rate would bind.  So the floor is the valid keys' K and V
// read once at 3.35 TB/s, and the design reads each valid position once and
// nothing else:
// - a block serves one (row, kv head) and all G query heads of its group
//   (up to kGroupMax; more only in further blocks), so a K/V element is read
//   once for G queries;
// - the row's valid range is cut into chunks of chunk_len positions
//   (grid.y), chosen by the wrapper from S and B * H_kv so that enough
//   blocks fill the card; a chunk wholly outside [lo, hi] exits after
//   reading length[b], so no position past a row's length is read;
// - K and V tiles of kTileBytes each stream through a two-stage ring of
//   16-byte cp.async copies into shared memory (a row's tail past hi is
//   zero-filled, not read), tile i + 1's copy running under tile i's
//   arithmetic;
// - the arithmetic is fp32: each thread converts its 16-byte slice of a K
//   row to fp32 in registers and dots it with its slice of the G queries
//   (fp32, in registers), the row's threads summing by shuffles; the tile's
//   scores go to shared memory, where one warp a query head takes the tile
//   max, the probabilities exp2(s - m) in fp32 and their sum (an online
//   softmax, one rescale a tile), and each thread adds p * v over its rows
//   to fp32 accumulators; the row-slices' accumulators are summed through
//   shared memory at the end;
// - with one chunk the block writes the output (acc / l, rounded once to
//   the output dtype); with more, it writes its fp32 partial (acc, m, l)
//   and decode_attn_merge_kernel combines each (row, head)'s live chunks.
// Nothing is synchronised with the host: the grid is fixed by S.
//
// Numerics against the plain version: the same fp32 products and the same
// fp32 softmax; the probabilities stay fp32 into the value product, where
// the plain version rounds them to the cache dtype first (one rounding
// fewer); the output is the only rounding to the working dtype.  exp(x)
// is taken as exp2(x log2 e), log2 e folded into the 1/sqrt(D) scale.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <cstdint>

#include "flash_common.cuh"
#include "tensor_core.cuh"

namespace {

using bf16 = __nv_bfloat16;
using flash::KernelInfo;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 2;
constexpr int kTileBytes = 8192;  // a tile's K (and its V) in shared memory
constexpr int kGroupMax = 8;      // query heads a block serves at most

// Where a 16-byte slice of a row sits: kVec elements, kLanes threads a row,
// kRowsPerPass rows for the block's threads at once, kTile rows a tile
template <typename T, int D>
struct Geometry {
  static constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  static constexpr int kLanes = D / kVec;
  static constexpr int kRowsPerPass = kThreads / kLanes;
  static constexpr int kTile = kTileBytes / (D * static_cast<int>(sizeof(T)));
  static constexpr int kPasses = kTile / kRowsPerPass;
  static constexpr int kSlices = kTile * kLanes;  // 16-byte slices a tile
  static_assert(32 % kLanes == 0, "a row's threads lie in one warp");
  static_assert(kTile % kRowsPerPass == 0, "whole passes a tile");
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const long long* length;
  void* out;        // [B, H, 1, D] contiguous, q's dtype
  float* part_acc;  // [B, H, chunks, D] fp32 (chunks > 1 only)
  float* part_ml;   // [B, H, chunks, 2] fp32: m (log2 domain), l
  long long q_sb, q_sh, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, len_stride;
  int H, H_kv, G, S, window, chunk_len, chunks;
  float scale_log2;  // log2(e) / sqrt(D)
};

__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(float x) { return x; }

// a 16-byte slice as fp32: bf16 widens exactly by a shift
__device__ __forceinline__ void widen(const uint4& raw, float (&x)[8]) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void widen(const uint4& raw, float (&x)[4]) {
  x[0] = __uint_as_float(raw.x);
  x[1] = __uint_as_float(raw.y);
  x[2] = __uint_as_float(raw.z);
  x[3] = __uint_as_float(raw.w);
}

template <typename T>
__device__ __forceinline__ T narrow(float x);
template <>
__device__ __forceinline__ bf16 narrow<bf16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ float narrow<float>(float x) {
  return x;
}

// The live keys [begin, end) of row b inside chunk c; empty when the chunk
// lies wholly outside the row's [lo, hi]
__device__ __forceinline__ void chunk_range(const Args& a, int b, int c,
                                            int& begin, int& end) {
  const long long len = a.length[b * a.len_stride];
  const int hi = static_cast<int>(min(len, static_cast<long long>(a.S - 1)));
  const int lo = a.window > 0 ? max(0, hi - a.window + 1) : 0;
  begin = max(lo, c * a.chunk_len);
  end = min(hi + 1, (c + 1) * a.chunk_len);
}

template <typename T, int D, int GMAX>
__global__ void __launch_bounds__(kThreads)
    decode_attn_kernel(const Args a) {
  using Geo = Geometry<T, D>;
  constexpr int kVec = Geo::kVec, kTile = Geo::kTile, kLanes = Geo::kLanes;
  constexpr int kRpp = Geo::kRowsPerPass;
  static_assert(kRpp * GMAX * D * 4 <= kStages * 2 * kTileBytes,
                "the final sum fits in the ring");

  const int pair = blockIdx.x;  // b * H_kv + kv head
  const int chunk = blockIdx.y;
  const int b = pair / a.H_kv, kvh = pair % a.H_kv;
  int begin, end;
  chunk_range(a, b, chunk, begin, end);
  if (begin >= end) return;
  const int g0 = blockIdx.z * GMAX;
  const int groups = min(GMAX, a.G - g0);
  const int head0 = kvh * a.G + g0;  // first query head of this block

  const int tid = threadIdx.x;
  const int lane_in_row = tid % kLanes;
  const int row_in_pass = tid / kLanes;
  const int d0 = lane_in_row * kVec;

  __shared__ __align__(16) unsigned char ring[kStages * 2 * kTileBytes];
  __shared__ float prob[GMAX][kTile];
  __shared__ float m_s[GMAX], l_s[GMAX], alpha_s[GMAX];
  T* k_ring = reinterpret_cast<T*>(ring);
  T* v_ring = k_ring + kStages * kTile * D;

  const T* kp = static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const T* vp = static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_sh;
  auto load_tile = [&](int t) {
    const int base = begin + t * kTile;
    T* kt = k_ring + (t % kStages) * kTile * D;
    T* vt = v_ring + (t % kStages) * kTile * D;
#pragma unroll
    for (int i = tid; i < Geo::kSlices; i += kThreads) {
      const int r = i / kLanes, col = (i % kLanes) * kVec;
      const bool live = base + r < end;
      const long long pos = live ? base + r : begin;
      tc::cp_async_16(kt + r * D + col, kp + pos * a.k_ss + col, live);
      tc::cp_async_16(vt + r * D + col, vp + pos * a.v_ss + col, live);
    }
  };
  const int tiles = (end - begin + kTile - 1) / kTile;
  load_tile(0);
  tc::cp_async_commit();

  // this thread's slice of the group's queries, fp32
  float q[GMAX][kVec];
  const T* qp = static_cast<const T*>(a.q) + b * a.q_sb;
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      q[g][i] = g < groups ? to_float(qp[(head0 + g) * a.q_sh + d0 + i]) : 0.f;
    }
  }
  if (tid < GMAX) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  float acc[GMAX][kVec];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
#pragma unroll
    for (int i = 0; i < kVec; ++i) acc[g][i] = 0.f;
  }

  for (int t = 0; t < tiles; ++t) {
    // tile t has landed, and every thread is done with tile t - 1: its
    // stage and the probabilities are free
    tc::cp_async_wait<0>();
    __syncthreads();
    if (t + 1 < tiles) load_tile(t + 1);
    tc::cp_async_commit();

    const T* kt = k_ring + (t % kStages) * kTile * D;
    const T* vt = v_ring + (t % kStages) * kTile * D;
    const int base = begin + t * kTile;
    // scores of this thread's rows, summed over the row's threads
#pragma unroll
    for (int p = 0; p < Geo::kPasses; ++p) {
      const int r = p * kRpp + row_in_pass;
      float kf[kVec];
      widen(*reinterpret_cast<const uint4*>(kt + r * D + d0), kf);
      float s[GMAX];
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < kVec; ++i) dot = fmaf(q[g][i], kf[i], dot);
#pragma unroll
        for (int off = kLanes / 2; off > 0; off >>= 1) {
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        }
        s[g] = dot;
      }
      if (lane_in_row == 0) {
        const bool live = base + r < end;
#pragma unroll
        for (int g = 0; g < GMAX; ++g) {
          if (g < groups) prob[g][r] = live ? s[g] * a.scale_log2 : -INFINITY;
        }
      }
    }
    __syncthreads();
    // the online softmax: a warp a query head
    const int warp = tid / 32, lane = tid % 32;
    for (int g = warp; g < groups; g += kWarps) {
      float mx = -INFINITY;
      for (int r = lane; r < kTile; r += 32) mx = fmaxf(mx, prob[g][r]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      }
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);  // finite: a tile holds a live row
      float sum = 0.f;
      for (int r = lane; r < kTile; r += 32) {
        const float p = exp2f(prob[g][r] - m_new);
        prob[g][r] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      }
      if (lane == 0) {
        const float alpha = exp2f(m_old - m_new);  // 0 on the first tile
        alpha_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();
    // acc = acc * alpha + p . v over this thread's rows
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      const float alpha = g < groups ? alpha_s[g] : 0.f;
#pragma unroll
      for (int i = 0; i < kVec; ++i) acc[g][i] *= alpha;
    }
#pragma unroll
    for (int p = 0; p < Geo::kPasses; ++p) {
      const int r = p * kRpp + row_in_pass;
      float vf[kVec];
      widen(*reinterpret_cast<const uint4*>(vt + r * D + d0), vf);
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        const float pr = g < groups ? prob[g][r] : 0.f;
#pragma unroll
        for (int i = 0; i < kVec; ++i) acc[g][i] = fmaf(pr, vf[i], acc[g][i]);
      }
    }
  }

  // sum the row slices' accumulators through the (now idle) ring
  tc::cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(ring);  // [kRpp][GMAX][D]
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    if (g < groups) {
#pragma unroll
      for (int i = 0; i < kVec; i += 4) {
        *reinterpret_cast<float4*>(red + (row_in_pass * GMAX + g) * D + d0 +
                                   i) =
            make_float4(acc[g][i], acc[g][i + 1], acc[g][i + 2],
                        acc[g][i + 3]);
      }
    }
  }
  __syncthreads();
  for (int idx = tid; idx < groups * D; idx += kThreads) {
    const int g = idx / D, d = idx % D;
    float sum = 0.f;
#pragma unroll
    for (int rr = 0; rr < kRpp; ++rr) sum += red[(rr * GMAX + g) * D + d];
    const long long bh = static_cast<long long>(b) * a.H + head0 + g;
    if (a.chunks == 1) {
      static_cast<T*>(a.out)[bh * D + d] = narrow<T>(sum / l_s[g]);
    } else {
      const long long at = bh * a.chunks + chunk;
      a.part_acc[at * D + d] = sum;
      if (d == 0) {
        a.part_ml[2 * at] = m_s[g];
        a.part_ml[2 * at + 1] = l_s[g];
      }
    }
  }
}

// One block a (row, query head), a thread a d: the live chunks' partials
// rescaled to their common max and summed
template <typename T, int D>
__global__ void __launch_bounds__(D) decode_attn_merge_kernel(const Args a) {
  const int bh = blockIdx.x;
  const int b = bh / a.H, d = threadIdx.x;
  const long long len = a.length[b * a.len_stride];
  const int hi = static_cast<int>(min(len, static_cast<long long>(a.S - 1)));
  const int lo = a.window > 0 ? max(0, hi - a.window + 1) : 0;
  const int first = lo / a.chunk_len, last = hi / a.chunk_len;
  const float* ml = a.part_ml + 2LL * bh * a.chunks;
  const float* acc = a.part_acc + static_cast<long long>(bh) * a.chunks * D;
  float m = -INFINITY;
  for (int c = first; c <= last; ++c) m = fmaxf(m, ml[2 * c]);
  float l = 0.f, o = 0.f;
  for (int c = first; c <= last; ++c) {
    const float w = exp2f(ml[2 * c] - m);
    l = fmaf(ml[2 * c + 1], w, l);
    o = fmaf(acc[c * D + d], w, o);
  }
  static_cast<T*>(a.out)[static_cast<long long>(bh) * D + d] = narrow<T>(o / l);
}

template <typename T, int D, int GMAX>
cudaError_t launch(const Args& a, int pairs, int qgroups, int B,
                   cudaStream_t stream) {
  decode_attn_kernel<T, D, GMAX>
      <<<dim3(pairs, a.chunks, qgroups), kThreads, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.chunks == 1) return err;
  decode_attn_merge_kernel<T, D><<<B * a.H, D, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_groups(const Args& a, int B, cudaStream_t stream) {
  const int pairs = B * a.H_kv;
  if (a.G <= 1) return launch<T, D, 1>(a, pairs, 1, B, stream);
  if (a.G <= 2) return launch<T, D, 2>(a, pairs, 1, B, stream);
  if (a.G <= 4) return launch<T, D, 4>(a, pairs, 1, B, stream);
  return launch<T, D, kGroupMax>(
      a, pairs, (a.G + kGroupMax - 1) / kGroupMax, B, stream);
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* length,
             void* out, void* part_acc, void* part_ml, int B, int H,
             int H_kv, int S, int D, long long q_sb, long long q_sh,
             long long k_sb, long long k_sh, long long k_ss, long long v_sb,
             long long v_sh, long long v_ss, long long len_stride,
             int window, int chunk_len, int chunks, float scale,
             void* stream) {
  if (B < 1 || H_kv < 1 || H % H_kv || S < 1 || chunk_len < 1 ||
      chunks < 1 || chunks > 65535) {
    return cudaErrorInvalidValue;
  }
  const Args a{q, k, v, static_cast<const long long*>(length), out,
               static_cast<float*>(part_acc), static_cast<float*>(part_ml),
               q_sb, q_sh, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, len_stride,
               H, H_kv, H / H_kv, S, window, chunk_len, chunks,
               scale * 1.4426950408889634f};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch_groups<T, 64>(a, B, st);
    case 128:
      return launch_groups<T, 128>(a, B, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// Every instantiation, for decode_attn_kernel_attributes
template <typename T, int D, int GMAX>
cudaError_t split_attributes(cudaFuncAttributes* a) {
  return cudaFuncGetAttributes(a, decode_attn_kernel<T, D, GMAX>);
}
template <typename T, int D>
cudaError_t merge_attributes(cudaFuncAttributes* a) {
  return cudaFuncGetAttributes(a, decode_attn_merge_kernel<T, D>);
}

#define DECODE_ATTN_SPLIT(T, NAME, D)                                    \
  {"decode_attn_g1 " NAME " " #D, split_attributes<T, D, 1>, 0},           \
      {"decode_attn_g2 " NAME " " #D, split_attributes<T, D, 2>, 0},       \
      {"decode_attn_g4 " NAME " " #D, split_attributes<T, D, 4>, 0},       \
      {"decode_attn_g8 " NAME " " #D, split_attributes<T, D, kGroupMax>, 0}, \
      {"decode_attn_merge " NAME " " #D, merge_attributes<T, D>, 0}

const KernelInfo kKernels[] = {
    DECODE_ATTN_SPLIT(bf16, "bf16", 64),  DECODE_ATTN_SPLIT(bf16, "bf16", 128),
    DECODE_ATTN_SPLIT(float, "f32", 64), DECODE_ATTN_SPLIT(float, "f32", 128),
};

}  // namespace

// Plain C entry points for ctypes.  Pointers are device pointers: q
// [B, H, 1, D] and k, v [B, H_kv, S, D] with the given strides (in
// elements, the last dim contiguous; k and v 16-byte aligned rows); length
// int64 [B] at stride len_stride; out [B, H, 1, D] contiguous in the input
// dtype; part_acc fp32 [B, H, chunks, D] and part_ml fp32 [B, H, chunks, 2]
// (unused, and may be null, when chunks is 1).  window <= 0 means none;
// chunk_len positions a chunk, chunks * chunk_len >= S.  Each returns
// cudaGetLastError() after its launches (0 = launched).
#define DECODE_ATTN_ENTRY(NAME, T)                                           \
  extern "C" int NAME(                                                       \
      const void* q, const void* k, const void* v, const void* length,      \
      void* out, void* part_acc, void* part_ml, int B, int H, int H_kv,      \
      int S, int D, long long q_sb, long long q_sh, long long k_sb,          \
      long long k_sh, long long k_ss, long long v_sb, long long v_sh,        \
      long long v_ss, long long len_stride, int window, int chunk_len,       \
      int chunks, float scale, void* stream) {                               \
    return dispatch<T>(q, k, v, length, out, part_acc, part_ml, B, H, H_kv,  \
                       S, D, q_sb, q_sh, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, \
                       len_stride, window, chunk_len, chunks, scale,         \
                       stream);                                              \
  }

DECODE_ATTN_ENTRY(decode_attn_bf16, bf16)
DECODE_ATTN_ENTRY(decode_attn_f32, float)

extern "C" const char* decode_attn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

FLASH_KERNEL_ATTRIBUTE_ENTRIES(decode_attn, kKernels)
