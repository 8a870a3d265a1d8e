// Flash-attention forward for Hopper (sm_90a): causal or full attention on
// [B, H, S, D], GQA k/v ([B, H_kv, S, D]), optional sliding window.
//
// Replaces the TPU kernel kube_sqs_autoscaler_tpu/workloads/flash.py:_fwd_kernel
// in its no-lse mode (_fwd_call(need_lse=False)), the prompt pass of the
// serving worker (classify forward and generate prefill).
//
// What bounds it on this card: at the serving shapes (S <= 1024, D = 64) the
// bytes it must move (q, k, v read once, out written once) take longer at
// 3.35 TB/s than the causal score and PV products take at the bf16
// tensor-core rate, so the floor is the memory.  This first version does not
// reach that floor: it runs the products as scalar fp32 FMAs, not on the
// tensor cores, so it is bound by its own FMA and shared-memory issue rate.
// What the design does about the bytes: one block owns a 64-row q tile of one
// (batch, head) and streams only the live K/V tiles through shared memory
// (up to the diagonal, and from the window's first live tile), so each
// block reads its q tile once and never writes the [S, S] scores to device
// memory; the running max, sum and output accumulator stay in registers.
// mma.sync / wgmma, TMA and warp specialisation are later work.
//
// Semantics copied from the TPU kernel:
// - scores, running max, running sum and accumulator in fp32; the 1/sqrt(D)
//   scale multiplies the score after the q.k product;
// - probabilities are rounded to the input dtype before the PV product
//   (flash.py:241), the running sum adds them unrounded;
// - masks: -inf without a window; -1e30 plus a live-row guard with one
//   (flash.py:215-234), so a row whose whole tile lies below its window
//   gets zero probabilities instead of exp(-inf - -inf) = NaN;
// - the kv head of query head h is h / (H / H_kv) (flash.py:277-280).
// The TPU's sequential grid axis, whose VMEM scratch carried the
// accumulators across K/V blocks, becomes the loop inside the block: blocks
// run in any order on the GPU and share nothing.  Rows and keys past S (the
// service's 16- and 32-long buckets against 64-row tiles) are masked here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kLanesPerRow = 4;                     // threads per q row
constexpr int kThreads = kBlockQ * kLanesPerRow;    // 256
constexpr int kColsPerLane = kBlockK / kLanesPerRow;  // 16 scores a thread

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Strides {
  long long b, h, s;  // in elements; the last dim is contiguous
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, Strides qs,
                 Strides ks, Strides vs, int H, int groups, int S, int causal,
                 int window, float scale) {
  constexpr int kStride = D + 1;         // padded rows: no bank conflicts
  constexpr int kPStride = kBlockK + 1;
  constexpr int kDimsPerLane = D / kLanesPerRow;
  extern __shared__ float smem[];
  float* q_tile = smem;                         // [kBlockQ][kStride]
  float* k_tile = q_tile + kBlockQ * kStride;   // [kBlockK][kStride]
  float* v_tile = k_tile + kBlockK * kStride;   // [kBlockK][kStride]
  float* p_tile = v_tile + kBlockK * kStride;   // [kBlockQ][kPStride]

  const int q_start = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kv_h = h / groups;
  const int tid = threadIdx.x;
  const int row = tid / kLanesPerRow;  // the 4 lanes of a row share a warp
  const int lane = tid % kLanesPerRow;
  const int q_row = q_start + row;

  const T* q_base = q + b * qs.b + h * qs.h;
  const T* k_base = k + b * ks.b + kv_h * ks.h;
  const T* v_base = v + b * vs.b + kv_h * vs.h;

  for (int e = tid; e < kBlockQ * D; e += kThreads) {
    const int r = e / D, d = e % D;
    const int gr = q_start + r;
    q_tile[r * kStride + d] = gr < S ? to_float(q_base[gr * qs.s + d]) : 0.f;
  }

  // live K/V tiles: up to this q tile's last row under causality, and from
  // the tile holding its first row's oldest in-window key
  const int q_last = min(q_start + kBlockQ, S) - 1;
  const int k_end = causal ? q_last + 1 : S;
  int k_begin = 0;
  if (window > 0 && q_start - window + 1 > 0) {
    k_begin = ((q_start - window + 1) / kBlockK) * kBlockK;
  }
  const float mask_value = window > 0 ? -1e30f : -INFINITY;

  float run_max = -INFINITY;
  float run_sum = 0.f;
  float acc[kDimsPerLane];
#pragma unroll
  for (int i = 0; i < kDimsPerLane; ++i) acc[i] = 0.f;

  for (int kt = k_begin; kt < k_end; kt += kBlockK) {
    __syncthreads();  // the previous tile's K/V reads are done
    for (int e = tid; e < kBlockK * D; e += kThreads) {
      const int r = e / D, d = e % D;
      const int gk = kt + r;
      const bool in = gk < S;
      k_tile[r * kStride + d] = in ? to_float(k_base[gk * ks.s + d]) : 0.f;
      v_tile[r * kStride + d] = in ? to_float(v_base[gk * vs.s + d]) : 0.f;
    }
    __syncthreads();

    float s[kColsPerLane];
#pragma unroll
    for (int j = 0; j < kColsPerLane; ++j) s[j] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float qd = q_tile[row * kStride + d];
#pragma unroll
      for (int j = 0; j < kColsPerLane; ++j) {
        s[j] = fmaf(qd, k_tile[(lane + j * kLanesPerRow) * kStride + d], s[j]);
      }
    }

    float block_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < kColsPerLane; ++j) {
      const int col = kt + lane + j * kLanesPerRow;
      float x = s[j] * scale;
      if (causal) {
        if (col > q_row) x = mask_value;
        if (window > 0 && col <= q_row - window) x = mask_value;
      }
      if (col >= S) x = mask_value;
      s[j] = x;
      block_max = fmaxf(block_max, x);
    }
    block_max = fmaxf(block_max, __shfl_xor_sync(0xffffffffu, block_max, 1));
    block_max = fmaxf(block_max, __shfl_xor_sync(0xffffffffu, block_max, 2));
    const float new_max = fmaxf(run_max, block_max);
    const bool row_live = window <= 0 || new_max > -1e29f;

    float tile_sum = 0.f;
#pragma unroll
    for (int j = 0; j < kColsPerLane; ++j) {
      const float p = row_live ? expf(s[j] - new_max) : 0.f;
      tile_sum += p;
      p_tile[row * kPStride + lane + j * kLanesPerRow] =
          to_float(from_float<T>(p));
    }
    tile_sum += __shfl_xor_sync(0xffffffffu, tile_sum, 1);
    tile_sum += __shfl_xor_sync(0xffffffffu, tile_sum, 2);
    const float correction = expf(run_max - new_max);
    run_max = new_max;
    run_sum = run_sum * correction + tile_sum;
    __syncwarp();  // the row's probabilities, written by its 4 lanes

#pragma unroll
    for (int i = 0; i < kDimsPerLane; ++i) acc[i] *= correction;
    for (int c = 0; c < kBlockK; ++c) {
      const float p = p_tile[row * kPStride + c];
#pragma unroll
      for (int i = 0; i < kDimsPerLane; ++i) {
        acc[i] = fmaf(p, v_tile[c * kStride + lane + i * kLanesPerRow], acc[i]);
      }
    }
  }

  if (q_row < S) {
    T* o_row = o + ((static_cast<long long>(b) * H + h) * S + q_row) * D;
#pragma unroll
    for (int i = 0; i < kDimsPerLane; ++i) {
      o_row[lane + i * kLanesPerRow] = from_float<T>(acc[i] / run_sum);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int H, int H_kv, int S, Strides qs, Strides ks,
                   Strides vs, int causal, int window, float scale,
                   cudaStream_t stream) {
  const size_t smem =
      (3 * kBlockQ * (D + 1) + kBlockQ * (kBlockK + 1)) * sizeof(float);
  auto kernel = flash_fwd_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBlockQ - 1) / kBlockQ, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), qs, ks, vs, H, H / H_kv,
      S, causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int B,
             int H, int H_kv, int S, int D, long long q_sb, long long q_sh,
             long long q_ss, long long k_sb, long long k_sh, long long k_ss,
             long long v_sb, long long v_sh, long long v_ss, int causal,
             int window, float scale, void* stream) {
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss},
      vs{v_sb, v_sh, v_ss};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch<T, 64>(q, k, v, o, B, H, H_kv, S, qs, ks, vs, causal,
                           window, scale, st);
    case 128:
      return launch<T, 128>(q, k, v, o, B, H, H_kv, S, qs, ks, vs, causal,
                            window, scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry points for ctypes.  Pointers are device pointers; strides
// are in elements; window <= 0 means none.  Each returns cudaGetLastError()
// after the launch (0 = launched).
extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v,
                              void* o, int B, int H, int H_kv, int S, int D,
                              long long q_sb, long long q_sh, long long q_ss,
                              long long k_sb, long long k_sh, long long k_ss,
                              long long v_sb, long long v_sh, long long v_ss,
                              int causal, int window, float scale,
                              void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, o, B, H, H_kv, S, D, q_sb, q_sh,
                                 q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
                                 causal, window, scale, stream);
}

extern "C" int flash_fwd_f32(const void* q, const void* k, const void* v,
                             void* o, int B, int H, int H_kv, int S, int D,
                             long long q_sb, long long q_sh, long long q_ss,
                             long long k_sb, long long k_sh, long long k_ss,
                             long long v_sb, long long v_sh, long long v_ss,
                             int causal, int window, float scale,
                             void* stream) {
  return dispatch<float>(q, k, v, o, B, H, H_kv, S, D, q_sb, q_sh, q_ss,
                         k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, causal, window,
                         scale, stream);
}

extern "C" const char* flash_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
