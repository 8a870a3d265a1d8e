// Flash-attention backward for Hopper (sm_90a): dq, and dk with dv, of
// causal or full attention on q [B, H, S_q, D] against k/v [B, H_kv, S_k, D]
// (GQA), optional sliding window, optional causal shift.
//
// Replaces the TPU kernels kube_sqs_autoscaler_tpu/workloads/flash.py:
// _bwd_dq_kernel (flash_bwd_dq here) and _bwd_dkv_kernel (flash_bwd_dkv),
// both launched by _bwd_call.  Like them, each recomputes the probability
// tile from the forward's per-row logsumexp, p = exp(s * q.k - lse), so no
// [S_q, S_k] matrix is ever stored, and reads Delta = rowsum(dO * O) - dlse,
// which the caller computes as a plain tensor op.
//
// What bounds them on this card: at the training shape (S = 2048, D = 64)
// the products (three of D multiply-adds per live (row, key) pair for dq,
// four for dk/dv) take longer at the bf16 tensor-core rate than the bytes
// take at 3.35 TB/s, so the floor is the operations.  This first version
// runs them as scalar fp32 FMAs out of shared memory, as the forward does,
// so it is bound by its own FMA and shared-memory issue rate, far above
// that floor.  mma.sync / wgmma and TMA are later work.
//
// Design:
// - flash_bwd_dq: one block owns a 64-row q tile of one (batch, head) and
//   loops over its live K/V tiles (the forward's loop), keeping dq in fp32
//   registers; the TPU's sequential k grid axis becomes that loop.
// - flash_bwd_dkv: one block owns a 64-key tile of one (batch, kv head) and
//   loops over the query heads of its group and, for each, over the live q
//   tiles of that key tile, keeping dk and dv in fp32 registers.  The TPU
//   folds the group into its innermost grid axis (flash.py:500-514) so that
//   each compact dk/dv block is written once; here the loop inside the
//   block does the same, with no atomics.  The live q tiles are the inverse
//   of the TPU's q-side predicate (flash.py:339-343, 402-406): causal rows
//   r see key c when c <= r + q_shift, so the first live row is
//   c_first - q_shift; a window keeps c > r + q_shift - window, so the last
//   live row is c_last + window - 1 - q_shift.
// - Rows past S_q and keys past S_k are masked (ragged S is supported, as
//   in the forward): their probabilities are 0 and they are not written.
//
// Numerics copied from the TPU kernels:
// - the 1/sqrt(D) scale multiplies the score after the q.k product;
// - masked scores give p = exp(-inf - lse) = 0 (the lse is finite because
//   every row sees its diagonal key), here written as an explicit 0;
// - ds = p * (dp - Delta) * scale in fp32, rounded to k's dtype before
//   ds @ k (flash.py:371-373) and to q's dtype before ds^T @ q (:432-434);
// - p rounded to dO's dtype before p^T @ dO (:427-429);
// - fp32 accumulators, outputs in the input dtype.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kLanesPerRow = 4;                    // threads per tile row
constexpr int kThreads = 64 * kLanesPerRow;        // 256
constexpr int kColsPerLane = 64 / kLanesPerRow;    // 16 columns a thread
constexpr int kPStride = 64 + 1;                   // padded score rows

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

// x rounded to T and widened back: the TPU kernels' .astype before a dot
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

struct Strides {
  long long b, h, s;  // in elements; the last dim is contiguous
};

struct Problem {
  int H, H_kv, groups, S_q, S_k, causal, window, q_shift;
  float scale;
};

// Whether q row r sees key c: inside both lengths, and under causality at
// or before the row's position r + q_shift and inside its window
__device__ __forceinline__ bool visible(int r, int c, const Problem& p) {
  if (r >= p.S_q || c >= p.S_k) return false;
  if (p.causal) {
    const int pos = r + p.q_shift;
    if (c > pos) return false;
    if (p.window > 0 && c <= pos - p.window) return false;
  }
  return true;
}

// rows first .. first + 63 of a [len, D] head (row stride `stride`) into a
// padded fp32 shared tile; rows past len are zeros
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* tile, const T* base,
                                          long long stride, int first,
                                          int len) {
  for (int e = threadIdx.x; e < 64 * D; e += kThreads) {
    const int r = e / D, d = e % D;
    const int g = first + r;
    tile[r * (D + 1) + d] = g < len ? to_float(base[g * stride + d]) : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    Strides qs, Strides ks, Strides vs, Strides dos,
                    Problem p) {
  constexpr int kStride = D + 1;
  constexpr int kDimsPerLane = D / kLanesPerRow;
  extern __shared__ float smem[];
  float* q_tile = smem;                          // [kBlockQ][kStride]
  float* do_tile = q_tile + kBlockQ * kStride;   // [kBlockQ][kStride]
  float* k_tile = do_tile + kBlockQ * kStride;   // [kBlockK][kStride]
  float* v_tile = k_tile + kBlockK * kStride;    // [kBlockK][kStride]
  float* ds_tile = v_tile + kBlockK * kStride;   // [kBlockQ][kPStride]

  const int q_start = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kv_h = h / p.groups;
  const int row = threadIdx.x / kLanesPerRow;  // a row's lanes share a warp
  const int lane = threadIdx.x % kLanesPerRow;
  const int q_row = q_start + row;

  const T* k_base = k + b * ks.b + kv_h * ks.h;
  const T* v_base = v + b * vs.b + kv_h * vs.h;
  load_tile<T, D>(q_tile, q + b * qs.b + h * qs.h, qs.s, q_start, p.S_q);
  load_tile<T, D>(do_tile, dout + b * dos.b + h * dos.h, dos.s, q_start,
                  p.S_q);
  const long long stat = (static_cast<long long>(b) * p.H + h) * p.S_q;
  const float row_lse = q_row < p.S_q ? lse[stat + q_row] : 0.f;
  const float row_delta = q_row < p.S_q ? delta[stat + q_row] : 0.f;

  // live K/V tiles, as in the forward
  const int q_last = min(q_start + kBlockQ, p.S_q) - 1;
  int k_begin = 0, k_end = p.S_k;
  if (p.causal) {
    k_end = min(q_last + p.q_shift + 1, p.S_k);
    if (p.window > 0) {
      k_begin = max(q_start + p.q_shift - p.window + 1, 0) / kBlockK * kBlockK;
    }
  }

  float acc[kDimsPerLane];
#pragma unroll
  for (int i = 0; i < kDimsPerLane; ++i) acc[i] = 0.f;

  for (int kt = k_begin; kt < k_end; kt += kBlockK) {
    __syncthreads();  // the previous tile's reads are done
    load_tile<T, D>(k_tile, k_base, ks.s, kt, p.S_k);
    load_tile<T, D>(v_tile, v_base, vs.s, kt, p.S_k);
    __syncthreads();

    float s[kColsPerLane], dp[kColsPerLane];
#pragma unroll
    for (int j = 0; j < kColsPerLane; ++j) s[j] = dp[j] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float qd = q_tile[row * kStride + d];
      const float od = do_tile[row * kStride + d];
#pragma unroll
      for (int j = 0; j < kColsPerLane; ++j) {
        const int c = (lane + j * kLanesPerRow) * kStride + d;
        s[j] = fmaf(qd, k_tile[c], s[j]);
        dp[j] = fmaf(od, v_tile[c], dp[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kColsPerLane; ++j) {
      const int c = lane + j * kLanesPerRow;
      float ds = 0.f;
      if (visible(q_row, kt + c, p)) {
        const float prob = expf(s[j] * p.scale - row_lse);
        ds = prob * (dp[j] - row_delta) * p.scale;
      }
      ds_tile[row * kPStride + c] = round_to<T>(ds);
    }
    __syncwarp();  // the row's ds, written by its 4 lanes

    for (int c = 0; c < kBlockK; ++c) {
      const float ds = ds_tile[row * kPStride + c];
#pragma unroll
      for (int i = 0; i < kDimsPerLane; ++i) {
        acc[i] = fmaf(ds, k_tile[c * kStride + lane + i * kLanesPerRow],
                      acc[i]);
      }
    }
  }

  if (q_row < p.S_q) {
    T* dq_row = dq + (stat + q_row) * D;
#pragma unroll
    for (int i = 0; i < kDimsPerLane; ++i) {
      dq_row[lane + i * kLanesPerRow] = from_float<T>(acc[i]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, Strides qs, Strides ks, Strides vs,
                     Strides dos, Problem p) {
  constexpr int kStride = D + 1;
  constexpr int kDimsPerLane = D / kLanesPerRow;
  extern __shared__ float smem[];
  float* k_tile = smem;                          // [kBlockK][kStride]
  float* v_tile = k_tile + kBlockK * kStride;    // [kBlockK][kStride]
  float* q_tile = v_tile + kBlockK * kStride;    // [kBlockQ][kStride]
  float* do_tile = q_tile + kBlockQ * kStride;   // [kBlockQ][kStride]
  float* pt_tile = do_tile + kBlockQ * kStride;  // [kBlockK][kPStride]
  float* dst_tile = pt_tile + kBlockK * kPStride;  // [kBlockK][kPStride]
  float* lse_tile = dst_tile + kBlockK * kPStride;  // [kBlockQ]
  float* delta_tile = lse_tile + kBlockQ;           // [kBlockQ]

  const int k_start = blockIdx.x * kBlockK;
  const int kv_h = blockIdx.y;
  const int b = blockIdx.z;
  const int row = threadIdx.x / kLanesPerRow;  // this thread's key
  const int lane = threadIdx.x % kLanesPerRow;
  const int key = k_start + row;

  load_tile<T, D>(k_tile, k + b * ks.b + kv_h * ks.h, ks.s, k_start, p.S_k);
  load_tile<T, D>(v_tile, v + b * vs.b + kv_h * vs.h, vs.s, k_start, p.S_k);

  // live q tiles of this key tile: from the one holding the first row that
  // sees key k_start, up to the last row whose window holds the last key
  int q_begin = 0, q_end = p.S_q;
  if (p.causal) {
    q_begin = max(k_start - p.q_shift, 0) / kBlockQ * kBlockQ;
    if (p.window > 0) {
      const int k_last = min(k_start + kBlockK, p.S_k) - 1;
      q_end = min(p.S_q, k_last + p.window - p.q_shift);
    }
  }

  float dk_acc[kDimsPerLane], dv_acc[kDimsPerLane];
#pragma unroll
  for (int i = 0; i < kDimsPerLane; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  for (int g = 0; g < p.groups; ++g) {
    const int h = kv_h * p.groups + g;
    const T* q_base = q + b * qs.b + h * qs.h;
    const T* do_base = dout + b * dos.b + h * dos.h;
    const long long stat = (static_cast<long long>(b) * p.H + h) * p.S_q;
    for (int qt = q_begin; qt < q_end; qt += kBlockQ) {
      __syncthreads();  // the previous tile's reads are done
      load_tile<T, D>(q_tile, q_base, qs.s, qt, p.S_q);
      load_tile<T, D>(do_tile, do_base, dos.s, qt, p.S_q);
      for (int e = threadIdx.x; e < kBlockQ; e += kThreads) {
        const bool in = qt + e < p.S_q;
        lse_tile[e] = in ? lse[stat + qt + e] : 0.f;
        delta_tile[e] = in ? delta[stat + qt + e] : 0.f;
      }
      __syncthreads();

      // s and dp transposed: this thread's key against 16 q rows
      float s[kColsPerLane], dp[kColsPerLane];
#pragma unroll
      for (int j = 0; j < kColsPerLane; ++j) s[j] = dp[j] = 0.f;
      for (int d = 0; d < D; ++d) {
        const float kd = k_tile[row * kStride + d];
        const float vd = v_tile[row * kStride + d];
#pragma unroll
        for (int j = 0; j < kColsPerLane; ++j) {
          const int c = (lane + j * kLanesPerRow) * kStride + d;
          s[j] = fmaf(kd, q_tile[c], s[j]);
          dp[j] = fmaf(vd, do_tile[c], dp[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < kColsPerLane; ++j) {
        const int c = lane + j * kLanesPerRow;
        float prob = 0.f, ds = 0.f;
        if (visible(qt + c, key, p)) {
          prob = expf(s[j] * p.scale - lse_tile[c]);
          ds = prob * (dp[j] - delta_tile[c]) * p.scale;
        }
        pt_tile[row * kPStride + c] = round_to<T>(prob);
        dst_tile[row * kPStride + c] = round_to<T>(ds);
      }
      __syncwarp();  // the key's p and ds, written by its 4 lanes

      for (int c = 0; c < kBlockQ; ++c) {
        const float pc = pt_tile[row * kPStride + c];
        const float dsc = dst_tile[row * kPStride + c];
#pragma unroll
        for (int i = 0; i < kDimsPerLane; ++i) {
          const int at = c * kStride + lane + i * kLanesPerRow;
          dv_acc[i] = fmaf(pc, do_tile[at], dv_acc[i]);
          dk_acc[i] = fmaf(dsc, q_tile[at], dk_acc[i]);
        }
      }
    }
  }

  if (key < p.S_k) {
    const long long at =
        ((static_cast<long long>(b) * p.H_kv + kv_h) * p.S_k + key) * D;
#pragma unroll
    for (int i = 0; i < kDimsPerLane; ++i) {
      dk[at + lane + i * kLanesPerRow] = from_float<T>(dk_acc[i]);
      dv[at + lane + i * kLanesPerRow] = from_float<T>(dv_acc[i]);
    }
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      void* dq, int B, Strides qs, Strides ks, Strides vs,
                      Strides dos, const Problem& p, cudaStream_t stream) {
  const size_t smem =
      (4 * 64 * (D + 1) + kBlockQ * kPStride) * sizeof(float);
  auto kernel = flash_bwd_dq_kernel<T, D>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.S_q + kBlockQ - 1) / kBlockQ, p.H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), qs, ks, vs, dos, p);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse,
                       const float* delta, void* dk, void* dv, int B,
                       Strides qs, Strides ks, Strides vs, Strides dos,
                       const Problem& p, cudaStream_t stream) {
  const size_t smem = (4 * 64 * (D + 1) + 2 * kBlockK * kPStride +
                       2 * kBlockQ) * sizeof(float);
  auto kernel = flash_bwd_dkv_kernel<T, D>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.S_k + kBlockK - 1) / kBlockK, p.H_kv, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), qs, ks, vs, dos, p);
  return cudaGetLastError();
}

Problem make_problem(int H, int H_kv, int S_q, int S_k, int causal,
                     int window, int q_shift, float scale) {
  return Problem{H, H_kv, H / H_kv, S_q, S_k, causal, window, q_shift, scale};
}

template <typename T>
int dq_dispatch(const void* q, const void* k, const void* v,
                const void* dout, const void* lse, const void* delta,
                void* dq, int B, int H, int H_kv, int S_q, int S_k, int D,
                const long long* st, int causal, int window, int q_shift,
                float scale, void* stream) {
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, dos{st[9], st[10], st[11]};
  const Problem p =
      make_problem(H, H_kv, S_q, S_k, causal, window, q_shift, scale);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch_dq<T, 64>(q, k, v, dout, l, dl, dq, B, qs, ks, vs, dos,
                              p, s);
    case 128:
      return launch_dq<T, 128>(q, k, v, dout, l, dl, dq, B, qs, ks, vs, dos,
                               p, s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
int dkv_dispatch(const void* q, const void* k, const void* v,
                 const void* dout, const void* lse, const void* delta,
                 void* dk, void* dv, int B, int H, int H_kv, int S_q,
                 int S_k, int D, const long long* st, int causal, int window,
                 int q_shift, float scale, void* stream) {
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, dos{st[9], st[10], st[11]};
  const Problem p =
      make_problem(H, H_kv, S_q, S_k, causal, window, q_shift, scale);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch_dkv<T, 64>(q, k, v, dout, l, dl, dk, dv, B, qs, ks, vs,
                               dos, p, s);
    case 128:
      return launch_dkv<T, 128>(q, k, v, dout, l, dl, dk, dv, B, qs, ks, vs,
                                dos, p, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry points for ctypes.  Pointers are device pointers: q, dout
// [B, H, S_q, D] and k, v [B, H_kv, S_k, D] with the given strides (in
// elements, the last dim contiguous); lse and delta contiguous fp32
// [B, H, S_q]; dq, dk, dv contiguous outputs in the input dtype.  window <= 0
// means none.  Each returns cudaGetLastError() after the launch (0 =
// launched).
#define FLASH_BWD_ENTRIES(SUFFIX, T)                                          \
  extern "C" int flash_bwd_dq_##SUFFIX(                                       \
      const void* q, const void* k, const void* v, const void* dout,          \
      const void* lse, const void* delta, void* dq, int B, int H, int H_kv,   \
      int S_q, int S_k, int D, long long q_sb, long long q_sh,                \
      long long q_ss, long long k_sb, long long k_sh, long long k_ss,         \
      long long v_sb, long long v_sh, long long v_ss, long long do_sb,        \
      long long do_sh, long long do_ss, int causal, int window, int q_shift,  \
      float scale, void* stream) {                                            \
    const long long st[12] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,             \
                              v_sb, v_sh, v_ss, do_sb, do_sh, do_ss};         \
    return dq_dispatch<T>(q, k, v, dout, lse, delta, dq, B, H, H_kv, S_q,     \
                          S_k, D, st, causal, window, q_shift, scale,         \
                          stream);                                            \
  }                                                                           \
  extern "C" int flash_bwd_dkv_##SUFFIX(                                      \
      const void* q, const void* k, const void* v, const void* dout,          \
      const void* lse, const void* delta, void* dk, void* dv, int B, int H,   \
      int H_kv, int S_q, int S_k, int D, long long q_sb, long long q_sh,      \
      long long q_ss, long long k_sb, long long k_sh, long long k_ss,         \
      long long v_sb, long long v_sh, long long v_ss, long long do_sb,        \
      long long do_sh, long long do_ss, int causal, int window, int q_shift,  \
      float scale, void* stream) {                                            \
    const long long st[12] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,             \
                              v_sb, v_sh, v_ss, do_sb, do_sh, do_ss};         \
    return dkv_dispatch<T>(q, k, v, dout, lse, delta, dk, dv, B, H, H_kv,     \
                           S_q, S_k, D, st, causal, window, q_shift, scale,   \
                           stream);                                           \
  }

FLASH_BWD_ENTRIES(bf16, __nv_bfloat16)
FLASH_BWD_ENTRIES(f32, float)

extern "C" const char* flash_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
