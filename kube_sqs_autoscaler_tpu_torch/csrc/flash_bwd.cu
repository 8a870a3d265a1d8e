// Flash-attention backward for Hopper (sm_90a): dq, and dk with dv, of
// causal or full attention on q [B, H, S_q, D] against k/v [B, H_kv, S_k, D]
// (GQA), optional sliding window, optional causal shift.
//
// What each kernel replaces: the TPU kernels of
// kube_sqs_autoscaler_tpu/workloads/flash.py, _bwd_dq_kernel (here
// flash_bwd_dq_kernel) and _bwd_dkv_kernel (flash_bwd_dkv_kernel), both
// launched by _bwd_call.  Like them, each recomputes the probability tile
// from the forward's per-row logsumexp, p = exp(s * q.k - lse), so no
// [S_q, S_k] matrix is ever stored, and reads Delta = rowsum(dO * O) - dlse,
// which the caller computes as a plain tensor op.  The two-kernel structure
// stays: dq in one, dk and dv in the other, every output element written
// once, no atomics, so the result is deterministic as on the TPU.
//
// What bounds them on this card: at the training shape (S = 2048, D = 64)
// the products (three of D multiply-adds per live (row, key) pair for dq,
// four for dk/dv) take longer at the bf16 tensor-core rate than the bytes
// take at 3.35 TB/s, so the floor is the operations.
//
// Which dtype takes which design:
// - bf16 runs on the tensor cores (dq_tensor_cores, dkv_tensor_cores).
//   Every product is mma.sync.m16n8k16 with bf16 operands and fp32
//   accumulators, its operands read from shared memory by ldmatrix (.trans
//   where the tile is the product's right side untransposed).  Shared
//   memory is fed by 16-byte cp.async copies into XOR-swizzled tiles
//   (tensor_core.cuh), in a two-stage ring: the next tile's copy runs while
//   the current tile is computed.  Rows past S_q / keys past S_k are
//   zero-filled by the copy, masked in registers and not stored.
// - f32 keeps the scalar fp32 design (dq_scalar, dkv_scalar): the tensor
//   cores take fp32 only as TF32, which keeps about 3 decimal digits and
//   would break the f32 path's 1e-5 agreement with its plain version and
//   the f32 train step's agreement with dense attention.
//
// The tensor-core design:
// - flash_bwd_dq: a block of 4 warps owns a 64-row q tile of one (batch,
//   head), each warp 16 rows, and loops over the live K/V tiles (the TPU's
//   sequential k grid axis).  Per tile a warp computes S = Q K^T and
//   dP = dO V^T, then p and ds in the accumulator layout, and dq += dS K
//   with K through ldmatrix.trans.  Q and dO are copied once; their
//   fragments are re-read from shared memory each tile, which at D = 64
//   fits three blocks on an SM (168 registers, no spills) and ran faster
//   on the card than holding them in registers at two blocks.  dq stays in
//   fp32 registers and is written once.  Blocks run the q tiles in reverse, so under causality
//   the longest tiles start first and the launch's tail is short.
// - flash_bwd_dkv: a block owns a 64-key tile of one (batch, kv head) and
//   loops over the query heads of its group and, for each, the live q
//   tiles; the TPU folds the group into its innermost grid axis
//   (flash.py:500-514) so that each compact dk/dv block is written once,
//   and the loop does the same.  A warp computes S^T = K Q^T and
//   dP^T = V dO^T, so P^T and dS^T come out in the accumulator layout and
//   feed dv += P^T dO and dk += dS^T Q directly (dO, Q through
//   ldmatrix.trans).  At D = 64 the K and V fragments are read once and
//   held in registers; at D = 128 they are re-read each tile (registers).
//   The Q, dO tiles and their 64 lse and Delta values stream through the
//   ring.  Key tiles run in launch order: under
//   causality the first have the most live q tiles.
// - p and ds never go through shared memory: the fp32 accumulator tiles,
//   rounded to bf16 in pairs, are the next product's A fragments.
// - Live tiles are the TPU's: causal rows r see key c when
//   c <= r + q_shift, and with a window when c > r + q_shift - window; the
//   dk/dv loop takes the inverse range (flash.py:339-343, 402-406): from
//   the q tile holding row c_first - q_shift to row
//   c_last + window - 1 - q_shift.  Tiles wholly inside the mask skip the
//   per-element test.
//
// Numerics copied from the TPU kernels (both designs):
// - the 1/sqrt(D) scale multiplies the score after the q.k product;
// - masked scores give p = exp(-inf - lse) = 0 (the lse is finite because
//   every row sees its diagonal key), here written as an explicit 0;
// - ds = p * (dp - Delta) * scale in fp32, rounded to k's dtype before
//   ds @ k (flash.py:371-373) and to q's dtype before ds^T @ q (:432-434);
// - p rounded to dO's dtype before p^T @ dO (:427-429);
// - fp32 accumulators, outputs in the input dtype.
// The bf16 design takes exp(x) as exp2(x * log2 e), with the scale and the
// lse folded into one multiply-add: the same value to an fp32 rounding.
//
// What it still leaves on the table: wgmma (the only way to the card's full
// bf16 rate; mma.sync reaches part of it) fed by TMA with a producer warp,
// larger tiles, and a persistent grid of one block per SM that walks the
// tiles longest first.

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

// Live rows [begin, end) of the key tile at k_start: from the tile holding
// the first row that sees key k_start, up to the last row whose window
// holds the tile's last key; begin a tile boundary
__device__ __forceinline__ void live_rows(int k_start, const Problem& p,
                                          int& begin, int& end) {
  begin = 0;
  end = p.S_q;
  if (p.causal) {
    begin = max(k_start - p.q_shift, 0) / kBlockQ * kBlockQ;
    if (p.window > 0) {
      const int k_last = min(k_start + kBlockK, p.S_k) - 1;
      end = min(p.S_q, k_last + p.window - p.q_shift);
    }
  }
}

// Which design each dtype takes, and its threads per block
template <typename T>
struct Path;
template <>
struct Path<float> {
  static constexpr int kThreads = 256;  // scalar fp32: 4 lanes per tile row
};
template <>
struct Path<bf16> {
  static constexpr int kThreads = 128;  // tensor cores: 4 warps, 16 rows each
};

// Blocks of the dq kernel that must fit on one SM (a register cap): three
// for bf16 at D = 64, which fits them in 168 registers without spills
template <typename T, int D>
struct DqMinBlocks {
  static constexpr int value = 1;
};
template <>
struct DqMinBlocks<bf16, 64> {
  static constexpr int value = 3;
};

// ---------------------------------------------------------------------------
// f32: scalar fp32 FMAs out of padded fp32 shared-memory tiles
// ---------------------------------------------------------------------------

constexpr int kScalarThreads = Path<float>::kThreads;
constexpr int kLanesPerRow = kScalarThreads / 64;  // threads per tile row
constexpr int kColsPerLane = 64 / kLanesPerRow;    // 16 columns a thread
constexpr int kPStride = 64 + 1;                   // padded score rows

// rows first .. first + 63 of a [len, D] head (row stride `stride`) into a
// padded fp32 shared tile; rows past len are zeros
template <int D>
__device__ __forceinline__ void load_tile(float* tile, const float* base,
                                          long long stride, int first,
                                          int len) {
  for (int e = threadIdx.x; e < 64 * D; e += kScalarThreads) {
    const int r = e / D, d = e % D;
    const int g = first + r;
    tile[r * (D + 1) + d] = g < len ? base[g * stride + d] : 0.f;
  }
}

template <int D>
__device__ __forceinline__ void dq_scalar(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dq, const Strides& qs, const Strides& ks,
    const Strides& vs, const Strides& dos, const Problem& p) {
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

  const float* k_base = k + b * ks.b + kv_h * ks.h;
  const float* v_base = v + b * vs.b + kv_h * vs.h;
  load_tile<D>(q_tile, q + b * qs.b + h * qs.h, qs.s, q_start, p.S_q);
  load_tile<D>(do_tile, dout + b * dos.b + h * dos.h, dos.s, q_start, p.S_q);
  const long long stat = (static_cast<long long>(b) * p.H + h) * p.S_q;
  const float row_lse = q_row < p.S_q ? lse[stat + q_row] : 0.f;
  const float row_delta = q_row < p.S_q ? delta[stat + q_row] : 0.f;

  int k_begin, k_end;
  live_keys(q_start, p, k_begin, k_end);

  float acc[kDimsPerLane];
#pragma unroll
  for (int i = 0; i < kDimsPerLane; ++i) acc[i] = 0.f;

  for (int kt = k_begin; kt < k_end; kt += kBlockK) {
    __syncthreads();  // the previous tile's reads are done
    load_tile<D>(k_tile, k_base, ks.s, kt, p.S_k);
    load_tile<D>(v_tile, v_base, vs.s, kt, p.S_k);
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
      ds_tile[row * kPStride + c] = ds;
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
    float* dq_row = dq + (stat + q_row) * D;
#pragma unroll
    for (int i = 0; i < kDimsPerLane; ++i) {
      dq_row[lane + i * kLanesPerRow] = acc[i];
    }
  }
}

template <int D>
__device__ __forceinline__ void dkv_scalar(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dk, float* __restrict__ dv, const Strides& qs,
    const Strides& ks, const Strides& vs, const Strides& dos,
    const Problem& p) {
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

  load_tile<D>(k_tile, k + b * ks.b + kv_h * ks.h, ks.s, k_start, p.S_k);
  load_tile<D>(v_tile, v + b * vs.b + kv_h * vs.h, vs.s, k_start, p.S_k);

  int q_begin, q_end;
  live_rows(k_start, p, q_begin, q_end);

  float dk_acc[kDimsPerLane], dv_acc[kDimsPerLane];
#pragma unroll
  for (int i = 0; i < kDimsPerLane; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  for (int g = 0; g < p.groups; ++g) {
    const int h = kv_h * p.groups + g;
    const float* q_base = q + b * qs.b + h * qs.h;
    const float* do_base = dout + b * dos.b + h * dos.h;
    const long long stat = (static_cast<long long>(b) * p.H + h) * p.S_q;
    for (int qt = q_begin; qt < q_end; qt += kBlockQ) {
      __syncthreads();  // the previous tile's reads are done
      load_tile<D>(q_tile, q_base, qs.s, qt, p.S_q);
      load_tile<D>(do_tile, do_base, dos.s, qt, p.S_q);
      for (int e = threadIdx.x; e < kBlockQ; e += kScalarThreads) {
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
        pt_tile[row * kPStride + c] = prob;
        dst_tile[row * kPStride + c] = ds;
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
      dk[at + lane + i * kLanesPerRow] = dk_acc[i];
      dv[at + lane + i * kLanesPerRow] = dv_acc[i];
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: mma.sync on the tensor cores, cp.async ring, swizzled tiles
// ---------------------------------------------------------------------------

constexpr int kTcThreads = Path<bf16>::kThreads;
static_assert(kTcThreads == 2 * kBlockQ, "one thread per lse or Delta value");

template <int D>
struct TcLayout {
  static constexpr int kTile = kBlockQ * D;  // elements of a 64-row tile
  static constexpr int kTileBytes = kTile * 2;
  // dq: Q, dO, then two stages of (K, V)
  static constexpr int kDqSmem = 6 * kTileBytes;
  // dk/dv: K, V, then two stages of (Q, dO, lse[64], Delta[64])
  static constexpr int kStageBytes = 2 * kTileBytes + 2 * kBlockQ * 4;
  static constexpr int kDkvSmem = 2 * kTileBytes + 2 * kStageBytes;
  // dk/dv holds the K and V A fragments in registers at D = 64; at
  // D = 128 they would crowd its accumulators out of the register file, so
  // they are re-read each tile
  static constexpr bool kHoldKV = D == 64;
  static constexpr int kSteps = D / 16;  // k steps over the head dim
};

// p and ds of one accumulator element, 0 where masked
struct ProbGrad {
  float p, ds;
};

__device__ __forceinline__ ProbGrad prob_grad(float s, float dp,
                                              float lse_log2, float delta,
                                              float scale_log2, float scale,
                                              bool live) {
  if (!live) return {0.f, 0.f};
  const float prob = exp2f(fmaf(s, scale_log2, -lse_log2));
  return {prob, prob * (dp - delta) * scale};
}

template <int D>
__device__ __forceinline__ void dq_tensor_cores(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dq, const Strides& qs, const Strides& ks,
    const Strides& vs, const Strides& dos, const Problem& p) {
  using L = TcLayout<D>;
  extern __shared__ __align__(128) unsigned char tc_smem[];
  bf16* q_s = reinterpret_cast<bf16*>(tc_smem);
  bf16* do_s = q_s + L::kTile;
  bf16* kv_s = do_s + L::kTile;  // stage i: K at kv_s + 2 i kTile, then V

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q_start = (gridDim.x - 1 - blockIdx.x) * kBlockQ;
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
  tc::load_tile_async<D, kTcThreads>(do_s, dout + b * dos.b + h * dos.h,
                                     dos.s, q_start, p.S_q);
  if (n_tiles > 0) load_kv(0, 0);
  tc::cp_async_commit();

  // this thread's two rows: g and g + 8 of the warp's 16
  const int row0 = warp * 16;
  const int r_lo = q_start + row0 + g, r_hi = r_lo + 8;
  const long long stat = (static_cast<long long>(b) * p.H + h) * p.S_q;
  const float lse_lo = r_lo < p.S_q ? lse[stat + r_lo] * kLog2e : 0.f;
  const float lse_hi = r_hi < p.S_q ? lse[stat + r_hi] * kLog2e : 0.f;
  const float delta_lo = r_lo < p.S_q ? delta[stat + r_lo] : 0.f;
  const float delta_hi = r_hi < p.S_q ? delta[stat + r_hi] : 0.f;
  const float scale_log2 = p.scale * kLog2e;

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  }

  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) load_kv(it + 1, (it + 1) & 1);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();  // this tile (and Q, dO) has landed
    __syncthreads();
    const bf16* k_s = kv_s + 2 * (it & 1) * L::kTile;
    const bf16* v_s = k_s + L::kTile;
    const int kt = k_begin + it * kBlockK;

    // S = Q K^T and dP = dO V^T: this warp's 16 rows x 64 keys
    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    }
#pragma unroll
    for (int ks_ = 0; ks_ < L::kSteps; ++ks_) {
      uint32_t qa[4], oa[4];
      tc::ldmatrix_x4(qa, q_s + tc::a_offset<D>(row0, ks_, lane));
      tc::ldmatrix_x4(oa, do_s + tc::a_offset<D>(row0, ks_, lane));
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) {
        uint32_t kb[4], vb[4];
        tc::ldmatrix_x4(kb, k_s + tc::b_offset<D>(16 * nb, ks_, lane));
        tc::mma_bf16(s[2 * nb], qa, kb[0], kb[1]);
        tc::mma_bf16(s[2 * nb + 1], qa, kb[2], kb[3]);
        tc::ldmatrix_x4(vb, v_s + tc::b_offset<D>(16 * nb, ks_, lane));
        tc::mma_bf16(dp[2 * nb], oa, vb[0], vb[1]);
        tc::mma_bf16(dp[2 * nb + 1], oa, vb[2], vb[3]);
      }
    }

    // ds in the accumulator layout (kept in s), then bf16 A fragments
    const bool full = tile_is_full(q_start, kt, p);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool hi = e >= 2;
        const int c = kt + 8 * j + 2 * t + (e & 1);
        s[j][e] = prob_grad(s[j][e], dp[j][e], hi ? lse_hi : lse_lo,
                            hi ? delta_hi : delta_lo, scale_log2, p.scale,
                            full || visible(hi ? r_hi : r_lo, c, p))
                      .ds;
      }
    }
    uint32_t ds_frag[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      tc::pack_a_fragment(ds_frag[kk], s[2 * kk], s[2 * kk + 1]);
    }

    // dq += dS K, K as the B operand through ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int nb = 0; nb < D / 16; ++nb) {
        uint32_t kb[4];
        tc::ldmatrix_x4_trans(kb, k_s + tc::bt_offset<D>(16 * kk, nb, lane));
        tc::mma_bf16(acc[2 * nb], ds_frag[kk], kb[0], kb[1]);
        tc::mma_bf16(acc[2 * nb + 1], ds_frag[kk], kb[2], kb[3]);
      }
    }
    __syncthreads();  // this stage is read; the next copy may refill it
  }
  tc::cp_async_wait<0>();

  // rows r_lo and r_hi, columns 8 j + 2 t and + 1, as bf16 pairs
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + 2 * t;
    if (r_lo < p.S_q) {
      *reinterpret_cast<uint32_t*>(dq + (stat + r_lo) * D + col) =
          tc::pack_bf16(acc[j][0], acc[j][1]);
    }
    if (r_hi < p.S_q) {
      *reinterpret_cast<uint32_t*>(dq + (stat + r_hi) * D + col) =
          tc::pack_bf16(acc[j][2], acc[j][3]);
    }
  }
}

template <int D>
__device__ __forceinline__ void dkv_tensor_cores(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dk, bf16* __restrict__ dv, const Strides& qs,
    const Strides& ks, const Strides& vs, const Strides& dos,
    const Problem& p) {
  using L = TcLayout<D>;
  extern __shared__ __align__(128) unsigned char tc_smem[];
  bf16* k_s = reinterpret_cast<bf16*>(tc_smem);
  bf16* v_s = k_s + L::kTile;
  unsigned char* stages = tc_smem + 2 * L::kTileBytes;
  // stage i: Q, dO tiles, then the tile's lse and Delta rows
  auto stage_q = [&](int stage) {
    return reinterpret_cast<bf16*>(stages + stage * L::kStageBytes);
  };
  auto stage_rows = [&](int stage) {
    return reinterpret_cast<float*>(stages + stage * L::kStageBytes +
                                    2 * L::kTileBytes);
  };

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int k_start = blockIdx.x * kBlockK;
  const int kv_h = blockIdx.y, b = blockIdx.z;
  int q_begin, q_end;
  live_rows(k_start, p, q_begin, q_end);
  const int n_q = q_end > q_begin ? (q_end - q_begin + kBlockQ - 1) / kBlockQ
                                  : 0;
  const int n_tiles = p.groups * n_q;  // (head of the group, q tile) pairs

  auto load_q = [&](int tile, int stage) {
    const int h = kv_h * p.groups + tile / n_q;
    const int first = q_begin + (tile % n_q) * kBlockQ;
    bf16* q_dst = stage_q(stage);
    tc::load_tile_async<D, kTcThreads>(q_dst, q + b * qs.b + h * qs.h, qs.s,
                                       first, p.S_q);
    tc::load_tile_async<D, kTcThreads>(q_dst + L::kTile,
                                       dout + b * dos.b + h * dos.h, dos.s,
                                       first, p.S_q);
    // threads 0-63 copy the lse values, 64-127 the Delta values
    const long long stat = (static_cast<long long>(b) * p.H + h) * p.S_q;
    const int e = threadIdx.x & (kBlockQ - 1);
    const bool is_lse = threadIdx.x < kBlockQ;
    const bool valid = first + e < p.S_q;
    tc::cp_async_4(stage_rows(stage) + (is_lse ? 0 : kBlockQ) + e,
                   (is_lse ? lse : delta) + stat + (valid ? first + e : 0),
                   valid);
  };
  tc::load_tile_async<D, kTcThreads>(k_s, k + b * ks.b + kv_h * ks.h, ks.s,
                                     k_start, p.S_k);
  tc::load_tile_async<D, kTcThreads>(v_s, v + b * vs.b + kv_h * vs.h, vs.s,
                                     k_start, p.S_k);
  if (n_tiles > 0) load_q(0, 0);
  tc::cp_async_commit();

  // this thread's two keys: g and g + 8 of the warp's 16
  const int key0 = warp * 16;
  const int key_lo = k_start + key0 + g, key_hi = key_lo + 8;
  const float scale_log2 = p.scale * kLog2e;

  uint32_t k_frag[L::kHoldKV ? L::kSteps : 1][4];
  uint32_t v_frag[L::kHoldKV ? L::kSteps : 1][4];
  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;
  }

  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) load_q(it + 1, (it + 1) & 1);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();  // this tile (and K, V) has landed
    __syncthreads();
    if constexpr (L::kHoldKV) {
      if (it == 0) {
#pragma unroll
        for (int ks_ = 0; ks_ < L::kSteps; ++ks_) {
          tc::ldmatrix_x4(k_frag[ks_], k_s + tc::a_offset<D>(key0, ks_, lane));
          tc::ldmatrix_x4(v_frag[ks_], v_s + tc::a_offset<D>(key0, ks_, lane));
        }
      }
    }
    const bf16* q_st = stage_q(it & 1);
    const bf16* do_st = q_st + L::kTile;
    const float* rows = stage_rows(it & 1);
    const int qt = q_begin + (it % n_q) * kBlockQ;

    // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys x 64 rows
    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    }
#pragma unroll
    for (int ks_ = 0; ks_ < L::kSteps; ++ks_) {
      uint32_t ka[4], va[4];
      if constexpr (L::kHoldKV) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ka[i] = k_frag[ks_][i];
          va[i] = v_frag[ks_][i];
        }
      } else {
        tc::ldmatrix_x4(ka, k_s + tc::a_offset<D>(key0, ks_, lane));
        tc::ldmatrix_x4(va, v_s + tc::a_offset<D>(key0, ks_, lane));
      }
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) {
        uint32_t qb[4], ob[4];
        tc::ldmatrix_x4(qb, q_st + tc::b_offset<D>(16 * nb, ks_, lane));
        tc::mma_bf16(s[2 * nb], ka, qb[0], qb[1]);
        tc::mma_bf16(s[2 * nb + 1], ka, qb[2], qb[3]);
        tc::ldmatrix_x4(ob, do_st + tc::b_offset<D>(16 * nb, ks_, lane));
        tc::mma_bf16(dp[2 * nb], va, ob[0], ob[1]);
        tc::mma_bf16(dp[2 * nb + 1], va, ob[2], ob[3]);
      }
    }

    // P^T (kept in s) and dS^T (kept in dp) in the accumulator layout:
    // element e of block j is key (e < 2 ? lo : hi), row 8 j + 2 t + e % 2
    const bool full = tile_is_full(qt, k_start, p);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 lse2 = reinterpret_cast<const float2*>(rows)[4 * j + t];
      const float2 delta2 =
          reinterpret_cast<const float2*>(rows + kBlockQ)[4 * j + t];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool odd = e & 1;
        const int row = qt + 8 * j + 2 * t + (e & 1);
        const ProbGrad pg = prob_grad(
            s[j][e], dp[j][e], (odd ? lse2.y : lse2.x) * kLog2e,
            odd ? delta2.y : delta2.x, scale_log2, p.scale,
            full || visible(row, e >= 2 ? key_hi : key_lo, p));
        s[j][e] = pg.p;
        dp[j][e] = pg.ds;
      }
    }
    uint32_t p_frag[4][4], ds_frag[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      tc::pack_a_fragment(p_frag[kk], s[2 * kk], s[2 * kk + 1]);
      tc::pack_a_fragment(ds_frag[kk], dp[2 * kk], dp[2 * kk + 1]);
    }

    // dv += P^T dO and dk += dS^T Q: dO, Q as B operands through .trans
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int nb = 0; nb < D / 16; ++nb) {
        uint32_t ob[4], qb[4];
        tc::ldmatrix_x4_trans(ob, do_st + tc::bt_offset<D>(16 * kk, nb, lane));
        tc::mma_bf16(dv_acc[2 * nb], p_frag[kk], ob[0], ob[1]);
        tc::mma_bf16(dv_acc[2 * nb + 1], p_frag[kk], ob[2], ob[3]);
        tc::ldmatrix_x4_trans(qb, q_st + tc::bt_offset<D>(16 * kk, nb, lane));
        tc::mma_bf16(dk_acc[2 * nb], ds_frag[kk], qb[0], qb[1]);
        tc::mma_bf16(dk_acc[2 * nb + 1], ds_frag[kk], qb[2], qb[3]);
      }
    }
    __syncthreads();  // this stage is read; the next copy may refill it
  }
  tc::cp_async_wait<0>();

  // keys key_lo and key_hi, columns 8 j + 2 t and + 1, as bf16 pairs
  const long long out = (static_cast<long long>(b) * p.H_kv + kv_h) * p.S_k;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + 2 * t;
    if (key_lo < p.S_k) {
      const long long at = (out + key_lo) * D + col;
      *reinterpret_cast<uint32_t*>(dk + at) =
          tc::pack_bf16(dk_acc[j][0], dk_acc[j][1]);
      *reinterpret_cast<uint32_t*>(dv + at) =
          tc::pack_bf16(dv_acc[j][0], dv_acc[j][1]);
    }
    if (key_hi < p.S_k) {
      const long long at = (out + key_hi) * D + col;
      *reinterpret_cast<uint32_t*>(dk + at) =
          tc::pack_bf16(dk_acc[j][2], dk_acc[j][3]);
      *reinterpret_cast<uint32_t*>(dv + at) =
          tc::pack_bf16(dv_acc[j][2], dv_acc[j][3]);
    }
  }
}

// ---------------------------------------------------------------------------
// kernels: one template each, the dtype picks the design
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void
__launch_bounds__(Path<T>::kThreads, DqMinBlocks<T, D>::value)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    Strides qs, Strides ks, Strides vs, Strides dos,
                    Problem p) {
  if constexpr (std::is_same<T, bf16>::value) {
    dq_tensor_cores<D>(q, k, v, dout, lse, delta, dq, qs, ks, vs, dos, p);
  } else {
    dq_scalar<D>(q, k, v, dout, lse, delta, dq, qs, ks, vs, dos, p);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(Path<T>::kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, Strides qs, Strides ks, Strides vs,
                     Strides dos, Problem p) {
  if constexpr (std::is_same<T, bf16>::value) {
    dkv_tensor_cores<D>(q, k, v, dout, lse, delta, dk, dv, qs, ks, vs, dos,
                        p);
  } else {
    dkv_scalar<D>(q, k, v, dout, lse, delta, dk, dv, qs, ks, vs, dos, p);
  }
}

// dynamic shared memory of each kernel, in bytes
template <typename T, int D>
constexpr int dq_smem_bytes() {
  if constexpr (std::is_same<T, bf16>::value) {
    return TcLayout<D>::kDqSmem;
  } else {
    return (4 * 64 * (D + 1) + kBlockQ * kPStride) * 4;
  }
}

template <typename T, int D>
constexpr int dkv_smem_bytes() {
  if constexpr (std::is_same<T, bf16>::value) {
    return TcLayout<D>::kDkvSmem;
  } else {
    return (4 * 64 * (D + 1) + 2 * kBlockK * kPStride + 2 * kBlockQ) * 4;
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      void* dq, int B, Strides qs, Strides ks, Strides vs,
                      Strides dos, const Problem& p, cudaStream_t stream) {
  constexpr int smem = dq_smem_bytes<T, D>();
  auto kernel = flash_bwd_dq_kernel<T, D>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.S_q + kBlockQ - 1) / kBlockQ, p.H, B);
  kernel<<<grid, Path<T>::kThreads, smem, stream>>>(
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
  constexpr int smem = dkv_smem_bytes<T, D>();
  auto kernel = flash_bwd_dkv_kernel<T, D>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.S_k + kBlockK - 1) / kBlockK, p.H_kv, B);
  kernel<<<grid, Path<T>::kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), qs, ks, vs, dos, p);
  return cudaGetLastError();
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

// Every instantiation, for flash_bwd_kernel_attributes
template <typename T, int D>
cudaError_t dq_attributes(cudaFuncAttributes* a) {
  return cudaFuncGetAttributes(a, flash_bwd_dq_kernel<T, D>);
}

template <typename T, int D>
cudaError_t dkv_attributes(cudaFuncAttributes* a) {
  return cudaFuncGetAttributes(a, flash_bwd_dkv_kernel<T, D>);
}

const KernelInfo kKernels[] = {
    {"flash_bwd_dq bf16 64", dq_attributes<bf16, 64>,
     dq_smem_bytes<bf16, 64>()},
    {"flash_bwd_dq bf16 128", dq_attributes<bf16, 128>,
     dq_smem_bytes<bf16, 128>()},
    {"flash_bwd_dq f32 64", dq_attributes<float, 64>,
     dq_smem_bytes<float, 64>()},
    {"flash_bwd_dq f32 128", dq_attributes<float, 128>,
     dq_smem_bytes<float, 128>()},
    {"flash_bwd_dkv bf16 64", dkv_attributes<bf16, 64>,
     dkv_smem_bytes<bf16, 64>()},
    {"flash_bwd_dkv bf16 128", dkv_attributes<bf16, 128>,
     dkv_smem_bytes<bf16, 128>()},
    {"flash_bwd_dkv f32 64", dkv_attributes<float, 64>,
     dkv_smem_bytes<float, 64>()},
    {"flash_bwd_dkv f32 128", dkv_attributes<float, 128>,
     dkv_smem_bytes<float, 128>()},
};

}  // namespace

// Plain C entry points for ctypes.  Pointers are device pointers: q, dout
// [B, H, S_q, D] and k, v [B, H_kv, S_k, D] with the given strides (in
// elements, the last dim contiguous; for bf16 every row 16-byte aligned);
// lse and delta contiguous fp32 [B, H, S_q]; dq, dk, dv contiguous outputs
// in the input dtype.  window <= 0 means none.  Each returns
// cudaGetLastError() after the launch (0 = launched).
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

FLASH_KERNEL_ATTRIBUTE_ENTRIES(flash_bwd, kKernels)
