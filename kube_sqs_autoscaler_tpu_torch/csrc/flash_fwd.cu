// Flash-attention forward for Hopper (sm_90a): causal or full attention on
// q [B, H, S_q, D] against k/v [B, H_kv, S_k, D] (GQA), optional sliding
// window, optional per-row logsumexp.
//
// What it replaces: the TPU kernel
// kube_sqs_autoscaler_tpu/workloads/flash.py:_fwd_kernel, in both modes.
// - Without the lse (_fwd_call(need_lse=False)): the prompt pass of the
//   serving worker and the trainer's eval forward.  The lse pointer is
//   null and nothing is written there.
// - With the lse (need_lse=True; _flash_fwd and _flash_lse): every training
//   forward, whose backward reads the lse.  It is fp32 [B, H, S_q] (the
//   TPU's [.., 128] lane replication is a Mosaic tiling artefact), written
//   as run_max + log(run_sum) at the end of the row.  q_shift >= 0 places q
//   row 0 at that causal position relative to k column 0 (row i attends
//   columns <= i + q_shift), as for the rectangular hops of ring attention.
//
// What bounds it on this card: at the serving shapes (S <= 1024, D = 64) the
// bytes it must move (q, k, v read once, out written once) take longer at
// 3.35 TB/s than the causal QK^T and PV products take at the bf16
// tensor-core rate, so the floor is the memory; at the training shape
// (S = 2048, D = 64) the products take longer, so the floor is the
// operations.  Either way the [S_q, S_k] scores never reach device memory:
// the running max, the running sum and the output accumulator stay in
// registers, and each block reads its q tile once and only the live K/V
// tiles (up to the diagonal, and from the window's first live tile).
//
// Which dtype takes which design (one kernel template, flash_fwd_kernel<T,
// D>, the dtype picks the body, as in flash_bwd.cu):
// - bf16 runs on the tensor cores (fwd_tensor_cores).  A block of 4 warps
//   owns a 64-row q tile of one (batch, head), 16 rows a warp.  The Q tile
//   is copied once; the live K/V tiles, 64 keys each, stream through a
//   two-stage ring of 16-byte cp.async copies into XOR-swizzled tiles
//   (tensor_core.cuh), so tile i+1's copy runs under tile i's products.
//   S = Q K^T is mma.sync.m16n8k16 (bf16 operands, fp32 accumulators) with K
//   as the B operand through ldmatrix; the scale, the mask and the online
//   softmax work in the accumulator layout, each thread holding rows g and
//   g + 8 of its warp's 16 (row max and sum across the lane quad); p,
//   rounded to bf16 in pairs, is the A fragment of O += P V with V through
//   ldmatrix.trans, so no probability tile goes through shared memory.
//   Q's A fragments are read once and held in registers across the loop.
//   Blocks take the q tiles in reverse, so under causality the longest tiles
//   start first and the launch's tail is short.  Every bf16 row must start
//   on a 16-byte boundary (the wrapper refuses other inputs).
//   With the products on the tensor cores, the softmax's instructions
//   between them set the pace, so it spends few: exp2 is one
//   special-function instruction (ex2.approx.ftz), and a tile wholly inside
//   the mask keeps its raw scores, the scale folded into the exp2's
//   multiply-add and into the max.  Two alternatives were timed and not
//   kept: 128-row blocks of 8 warps, and Q re-read from shared memory each
//   tile (PERF.md).
// - f32 keeps the scalar fp32-FMA design (fwd_scalar): the tensor cores take
//   fp32 only as TF32, which keeps about 3 decimal digits and would break the
//   f32 path's 1e-5 agreement with its plain version, the f32 prefill's
//   agreement with dense attention and the f32 train step's.
//
// Numerics copied from the TPU kernel (both designs):
// - scores, running max, running sum and accumulator in fp32; the 1/sqrt(D)
//   scale multiplies the score after the q.k product (flash.py:205-207);
// - masks in that scaled-score domain: -inf without a window; -1e30 plus a
//   live-row guard (new_max > -1e29) with one (flash.py:215-234), so a row
//   whose whole tile lies below its window gets zero probabilities instead of
//   exp(-inf - -inf) = NaN; a row's first tile starts from run_max = -inf and
//   its correction is an explicit 0;
// - probabilities are rounded to the input dtype before the PV product
//   (flash.py:241), the running sum adds them unrounded (:237-239);
// - the kv head of query head h is h / (H / H_kv) (flash.py:277-280).
// The bf16 design takes exp(x - m) as exp2(x log2 e - m log2 e), log2 e
// folded into one multiply-add inside the exp2: the same value to about an
// fp32 rounding (ex2.approx), with results below 2^-126 flushed to 0.
// The TPU's sequential grid axis, whose VMEM scratch carried the
// accumulators across K/V blocks, becomes the loop inside the block.  Rows
// past S_q read zero-filled q and are never stored; keys past S_k are
// zero-filled and masked.  The live range and the masks come from
// flash_common.cuh, which the backward shares.
//
// What it still leaves on the table: wgmma (the only way to the card's full
// bf16 rate; mma.sync reaches part of it) fed by TMA with a producer warp,
// and a persistent grid of one block per SM that walks the tiles longest
// first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <cstdint>
#include <type_traits>

#include "flash_common.cuh"
#include "tensor_core.cuh"

namespace {

using namespace flash;
using bf16 = __nv_bfloat16;

constexpr float kLog2e = 1.4426950408889634f;

// Which design each dtype takes: its q rows and threads a block
template <typename T>
struct Path;
template <>
struct Path<float> {
  static constexpr int kRows = kBlockQ;
  static constexpr int kThreads = 256;  // scalar fp32: 4 lanes per q row
};
template <>
struct Path<bf16> {  // tensor cores: 16 q rows a warp
  static constexpr int kRows = tc::kTileRows;
  static constexpr int kThreads = kRows / 16 * 32;
};

// ---------------------------------------------------------------------------
// f32: scalar fp32 FMAs out of padded fp32 shared-memory tiles
// ---------------------------------------------------------------------------

constexpr int kScalarThreads = Path<float>::kThreads;
constexpr int kLanesPerRow = kScalarThreads / kBlockQ;  // threads per q row
constexpr int kColsPerLane = kBlockK / kLanesPerRow;    // 16 scores a thread
constexpr int kPStride = kBlockK + 1;                   // padded score rows

template <int D>
__device__ __forceinline__ void fwd_scalar(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ o,
    float* __restrict__ lse, const Strides& qs, const Strides& ks,
    const Strides& vs, const Problem& p) {
  constexpr int kStride = D + 1;  // padded rows: no bank conflicts
  constexpr int kDimsPerLane = D / kLanesPerRow;
  extern __shared__ float smem[];
  float* q_tile = smem;                        // [kBlockQ][kStride]
  float* k_tile = q_tile + kBlockQ * kStride;  // [kBlockK][kStride]
  float* v_tile = k_tile + kBlockK * kStride;  // [kBlockK][kStride]
  float* p_tile = v_tile + kBlockK * kStride;  // [kBlockQ][kPStride]

  const int q_start = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kv_h = h / p.groups;
  const int tid = threadIdx.x;
  const int row = tid / kLanesPerRow;  // the 4 lanes of a row share a warp
  const int lane = tid % kLanesPerRow;
  const int q_row = q_start + row;

  const float* q_base = q + b * qs.b + h * qs.h;
  const float* k_base = k + b * ks.b + kv_h * ks.h;
  const float* v_base = v + b * vs.b + kv_h * vs.h;

  for (int e = tid; e < kBlockQ * D; e += kScalarThreads) {
    const int r = e / D, d = e % D;
    const int gr = q_start + r;
    q_tile[r * kStride + d] = gr < p.S_q ? q_base[gr * qs.s + d] : 0.f;
  }

  int k_begin, k_end;
  live_keys(q_start, p, k_begin, k_end);
  const float mask_value = p.window > 0 ? -1e30f : -INFINITY;

  float run_max = -INFINITY;
  float run_sum = 0.f;
  float acc[kDimsPerLane];
#pragma unroll
  for (int i = 0; i < kDimsPerLane; ++i) acc[i] = 0.f;

  for (int kt = k_begin; kt < k_end; kt += kBlockK) {
    __syncthreads();  // the previous tile's K/V reads are done
    for (int e = tid; e < kBlockK * D; e += kScalarThreads) {
      const int r = e / D, d = e % D;
      const int gk = kt + r;
      const bool in = gk < p.S_k;
      k_tile[r * kStride + d] = in ? k_base[gk * ks.s + d] : 0.f;
      v_tile[r * kStride + d] = in ? v_base[gk * vs.s + d] : 0.f;
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
      const float x = sees_key(q_row, col, p) ? s[j] * p.scale : mask_value;
      s[j] = x;
      block_max = fmaxf(block_max, x);
    }
    block_max = fmaxf(block_max, __shfl_xor_sync(0xffffffffu, block_max, 1));
    block_max = fmaxf(block_max, __shfl_xor_sync(0xffffffffu, block_max, 2));
    const float new_max = fmaxf(run_max, block_max);
    const bool row_live = p.window <= 0 || new_max > -1e29f;

    float tile_sum = 0.f;
#pragma unroll
    for (int j = 0; j < kColsPerLane; ++j) {
      const float prob = row_live ? expf(s[j] - new_max) : 0.f;
      tile_sum += prob;
      p_tile[row * kPStride + lane + j * kLanesPerRow] = prob;
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
      const float prob = p_tile[row * kPStride + c];
#pragma unroll
      for (int i = 0; i < kDimsPerLane; ++i) {
        acc[i] = fmaf(prob, v_tile[c * kStride + lane + i * kLanesPerRow],
                      acc[i]);
      }
    }
  }

  if (q_row < p.S_q) {
    const long long row_index =
        (static_cast<long long>(b) * p.H + h) * p.S_q + q_row;
    float* o_row = o + row_index * D;
#pragma unroll
    for (int i = 0; i < kDimsPerLane; ++i) {
      o_row[lane + i * kLanesPerRow] = acc[i] / run_sum;
    }
    // the backward's softmax residual (flash.py:247-251)
    if (lse != nullptr && lane == 0) lse[row_index] = run_max + logf(run_sum);
  }
}

// ---------------------------------------------------------------------------
// bf16: mma.sync on the tensor cores, cp.async ring, swizzled tiles
// ---------------------------------------------------------------------------

// exp2 on the special-function unit; subnormal results flush to 0 (a
// probability below 2^-126 of the row max adds nothing to a sum >= 1)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

constexpr int kTcRows = Path<bf16>::kRows;
constexpr int kTcThreads = Path<bf16>::kThreads;

template <int D>
struct TcLayout {
  static constexpr int kTile = tc::kTileRows * D;  // elements of a tile
  static constexpr int kTileBytes = kTile * 2;
  // the Q tile, then two stages of (K, V)
  static constexpr int kSmem = 5 * kTileBytes;
  static constexpr int kSteps = D / 16;  // k steps over the head dim
};

template <int D>
__device__ __forceinline__ void fwd_tensor_cores(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, bf16* __restrict__ o,
    float* __restrict__ lse, const Strides& qs, const Strides& ks,
    const Strides& vs, const Problem& p) {
  using L = TcLayout<D>;
  extern __shared__ __align__(128) unsigned char tc_smem[];
  bf16* q_s = reinterpret_cast<bf16*>(tc_smem);
  bf16* kv_s = q_s + L::kTile;  // stage i: K at 2 i kTile, V after it

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q_start = (gridDim.x - 1 - blockIdx.x) * kTcRows;
  const int h = blockIdx.y, b = blockIdx.z, kv_h = h / p.groups;
  const bf16* k_base = k + b * ks.b + kv_h * ks.h;
  const bf16* v_base = v + b * vs.b + kv_h * vs.h;
  int k_begin, k_end;
  live_keys(q_start, p, k_begin, k_end);
  const int n_tiles =
      k_end > k_begin ? (k_end - k_begin + kBlockK - 1) / kBlockK : 0;

  auto load_kv = [&](int tile, int stage) {
    bf16* k_dst = kv_s + 2 * stage * L::kTile;
    const int first = k_begin + tile * kBlockK;
    tc::load_tile_async<D, kTcThreads>(k_dst, k_base, ks.s, first, p.S_k);
    tc::load_tile_async<D, kTcThreads>(k_dst + L::kTile, v_base, vs.s, first,
                                       p.S_k);
  };
  tc::load_tile_async<D, kTcThreads>(q_s, q + b * qs.b + h * qs.h, qs.s,
                                     q_start, p.S_q);
  if (n_tiles > 0) load_kv(0, 0);
  tc::cp_async_commit();

  // this warp's 16 rows: rows row0 .. row0 + 15 of the Q tile; this
  // thread's two rows: g and g + 8 of them
  const int row0 = warp * 16;
  const int w_first = q_start + row0;
  const int r_lo = w_first + g, r_hi = r_lo + 8;
  const float mask_value = p.window > 0 ? -1e30f : -INFINITY;

  uint32_t q_frag[L::kSteps][4];  // Q's A fragments, read at the first tile
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  }
  // per row (lo, hi): the running max, and this thread's share of the
  // running sum (its 16 of each tile's 64 keys; the quad adds them at the
  // end, all four scaled by the same corrections)
  float run_max[2] = {-INFINITY, -INFINITY};
  float run_sum[2] = {0.f, 0.f};

  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) load_kv(it + 1, (it + 1) & 1);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();  // this tile (and Q) has landed
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int ks_ = 0; ks_ < L::kSteps; ++ks_) {
        tc::ldmatrix_x4(q_frag[ks_], q_s + tc::a_offset<D>(row0, ks_, lane));
      }
    }
    const bf16* k_s = kv_s + 2 * (it & 1) * L::kTile;
    const bf16* v_s = k_s + L::kTile;
    const int kt = k_begin + it * kBlockK;
    // a tile that every row of this warp masks (above its diagonal, below
    // its window) or a warp wholly past S_q changes nothing: skip it
    const int w_pos = w_first + p.q_shift;
    const bool warp_idle =
        w_first >= p.S_q ||
        (p.causal && (kt > w_pos + 15 ||
                      (p.window > 0 && kt + kBlockK - 1 <= w_pos - p.window)));
    if (!warp_idle) {
      // S = Q K^T: this warp's 16 rows x 64 keys, fp32
      float s[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
      }
#pragma unroll
      for (int ks_ = 0; ks_ < L::kSteps; ++ks_) {
#pragma unroll
        for (int nb = 0; nb < 4; ++nb) {
          uint32_t kb[4];
          tc::ldmatrix_x4(kb, k_s + tc::b_offset<D>(16 * nb, ks_, lane));
          tc::mma_bf16(s[2 * nb], q_frag[ks_], kb[0], kb[1]);
          tc::mma_bf16(s[2 * nb + 1], q_frag[ks_], kb[2], kb[3]);
        }
      }

      // element e of block j is row (e < 2 ? lo : hi), key kt + 8 j + 2 t +
      // e % 2.  A tile wholly inside the mask keeps its raw scores: the
      // scale folds into the exp2 and, being positive, into the max.  Any
      // other tile is scaled, then masked in the scaled-score domain.
      const bool full = tile_is_full(q_start, kt, p);
      if (!full) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = kt + 8 * j + 2 * t + (e & 1);
            const float x = s[j][e] * p.scale;
            s[j][e] = sees_key(e < 2 ? r_lo : r_hi, c, p) ? x : mask_value;
          }
        }
      }
      const float to_log2 = full ? p.scale * kLog2e : kLog2e;
      float max_log2[2], correction[2];
      bool live[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float tile_max = -INFINITY;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          tile_max = fmaxf(tile_max, fmaxf(s[j][2 * i], s[j][2 * i + 1]));
        }
        tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
        tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 2));
        if (full) tile_max *= p.scale;
        const float new_max = fmaxf(run_max[i], tile_max);
        live[i] = p.window <= 0 || new_max > -1e29f;
        // a row's first tile: nothing to correct (never exp(-inf - -inf))
        correction[i] = run_max[i] == -INFINITY
                            ? 0.f
                            : exp2_approx((run_max[i] - new_max) * kLog2e);
        run_max[i] = new_max;
        max_log2[i] = new_max * kLog2e;
      }

      // p = exp(x - max) in fp32 (0 in a dead row), summed unrounded
      float tile_sum[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          const float prob =
              live[i] ? exp2_approx(fmaf(s[j][e], to_log2, -max_log2[i]))
                      : 0.f;
          s[j][e] = prob;
          tile_sum[i] += prob;
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        run_sum[i] = run_sum[i] * correction[i] + tile_sum[i];
      }
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        acc[j][0] *= correction[0];
        acc[j][1] *= correction[0];
        acc[j][2] *= correction[1];
        acc[j][3] *= correction[1];
      }

      // O += P V: p rounded to bf16 in pairs as the A fragments, V as the
      // B operand through ldmatrix.trans
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t pa[4];
        tc::pack_a_fragment(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
        for (int nb = 0; nb < D / 16; ++nb) {
          uint32_t vb[4];
          tc::ldmatrix_x4_trans(vb, v_s + tc::bt_offset<D>(16 * kk, nb, lane));
          tc::mma_bf16(acc[2 * nb], pa, vb[0], vb[1]);
          tc::mma_bf16(acc[2 * nb + 1], pa, vb[2], vb[3]);
        }
      }
    }
    __syncthreads();  // this stage is read; the next copy may refill it
  }
  tc::cp_async_wait<0>();

  // rows r_lo and r_hi, columns 8 j + 2 t and + 1, as bf16 pairs; the lse
  // by one lane a row
  const long long stat = (static_cast<long long>(b) * p.H + h) * p.S_q;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = i ? r_hi : r_lo;
    float sum = run_sum[i] + __shfl_xor_sync(0xffffffffu, run_sum[i], 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    if (r >= p.S_q) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<uint32_t*>(o + (stat + r) * D + 8 * j + 2 * t) =
          tc::pack_bf16(acc[j][2 * i] / sum, acc[j][2 * i + 1] / sum);
    }
    // the backward's softmax residual (flash.py:247-251)
    if (lse != nullptr && t == 0) lse[stat + r] = run_max[i] + logf(sum);
  }
}

// ---------------------------------------------------------------------------
// the kernel: one template, the dtype picks the design
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(Path<T>::kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, Strides qs, Strides ks, Strides vs,
                 Problem p) {
  if constexpr (std::is_same<T, bf16>::value) {
    fwd_tensor_cores<D>(q, k, v, o, lse, qs, ks, vs, p);
  } else {
    fwd_scalar<D>(q, k, v, o, lse, qs, ks, vs, p);
  }
}

// dynamic shared memory of each instantiation, in bytes
template <typename T, int D>
constexpr int fwd_smem_bytes() {
  if constexpr (std::is_same<T, bf16>::value) {
    return TcLayout<D>::kSmem;
  } else {
    return (3 * kBlockQ * (D + 1) + kBlockQ * kPStride) * 4;
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, Strides qs, Strides ks, Strides vs,
                   const Problem& p, cudaStream_t stream) {
  constexpr int smem = fwd_smem_bytes<T, D>();
  auto kernel = flash_fwd_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.S_q + Path<T>::kRows - 1) / Path<T>::kRows, p.H, B);
  kernel<<<grid, Path<T>::kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, qs, ks, vs, p);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o,
             void* lse, int B, int H, int H_kv, int S_q, int S_k, int D,
             long long q_sb, long long q_sh, long long q_ss, long long k_sb,
             long long k_sh, long long k_ss, long long v_sb, long long v_sh,
             long long v_ss, int causal, int window, int q_shift,
             float scale, void* stream) {
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss},
      vs{v_sb, v_sh, v_ss};
  const Problem p =
      make_problem(H, H_kv, S_q, S_k, causal, window, q_shift, scale);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  switch (D) {
    case 64:
      return launch<T, 64>(q, k, v, o, l, B, qs, ks, vs, p, st);
    case 128:
      return launch<T, 128>(q, k, v, o, l, B, qs, ks, vs, p, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// Every instantiation, for flash_fwd_kernel_attributes
template <typename T, int D>
cudaError_t fwd_attributes(cudaFuncAttributes* a) {
  return cudaFuncGetAttributes(a, flash_fwd_kernel<T, D>);
}

const KernelInfo kKernels[] = {
    {"flash_fwd bf16 64", fwd_attributes<bf16, 64>, fwd_smem_bytes<bf16, 64>()},
    {"flash_fwd bf16 128", fwd_attributes<bf16, 128>,
     fwd_smem_bytes<bf16, 128>()},
    {"flash_fwd f32 64", fwd_attributes<float, 64>,
     fwd_smem_bytes<float, 64>()},
    {"flash_fwd f32 128", fwd_attributes<float, 128>,
     fwd_smem_bytes<float, 128>()},
};

}  // namespace

// Plain C entry points for ctypes.  Pointers are device pointers: q
// [B, H, S_q, D] and k, v [B, H_kv, S_k, D] with the given strides (in
// elements, the last dim contiguous; for bf16 every row 16-byte aligned);
// o contiguous in the input dtype; lse contiguous fp32 [B, H, S_q], or null
// (no lse is written).  window <= 0 means none; q_shift only moves the
// causal diagonal and the window.  Each returns cudaGetLastError() after
// the launch (0 = launched).
extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v,
                              void* o, void* lse, int B, int H, int H_kv,
                              int S_q, int S_k, int D, long long q_sb,
                              long long q_sh, long long q_ss, long long k_sb,
                              long long k_sh, long long k_ss, long long v_sb,
                              long long v_sh, long long v_ss, int causal,
                              int window, int q_shift, float scale,
                              void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, o, lse, B, H, H_kv, S_q, S_k, D,
                                 q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb,
                                 v_sh, v_ss, causal, window, q_shift, scale,
                                 stream);
}

extern "C" int flash_fwd_f32(const void* q, const void* k, const void* v,
                             void* o, void* lse, int B, int H, int H_kv,
                             int S_q, int S_k, int D, long long q_sb,
                             long long q_sh, long long q_ss, long long k_sb,
                             long long k_sh, long long k_ss, long long v_sb,
                             long long v_sh, long long v_ss, int causal,
                             int window, int q_shift, float scale,
                             void* stream) {
  return dispatch<float>(q, k, v, o, lse, B, H, H_kv, S_q, S_k, D, q_sb,
                         q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
                         causal, window, q_shift, scale, stream);
}

extern "C" const char* flash_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

FLASH_KERNEL_ATTRIBUTE_ENTRIES(flash_fwd, kKernels)
