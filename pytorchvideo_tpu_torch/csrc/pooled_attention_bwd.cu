// Backward of pooled multi-head attention, o = softmax(q k^T * scale) v (+ q),
// for sm_90a (H100).
//
// Replaces two TPU kernels of pytorchvideo_tpu/ops/pooled_attention.py:
// `_attention_bwd_kernel_packed` (behind `_packed_pallas_bwd_local`), MViT's
// default head-packed path, and `_attention_bwd_kernel` (behind
// `_pooled_attention_pallas_bwd_local`), the per-head path of `pool_first`.
// As in the forward (csrc/pooled_attention.cu) the layouts differ only in
// strides: a (batch, head, row) triple for the q-shaped tensors (q, o, g,
// dq) and one for the k-shaped ones (k, v, dk, dv); the c axis is contiguous.
//
// Given q, k, v, the forward's output o, its row log-sum-exp lse (natural
// log, (B, H, Lq) float32) and the output's gradient g:
//
//   p  = exp(q k^T * scale - lse)            recomputed per tile, never stored
//   D  = rowsum(g * o_attn), o_attn = o - q with the residual, else o
//   dp = g v^T,  ds = p * (dp - D)
//   dq = ds k * scale (+ g with the residual)
//   dk = ds^T q * scale,  dv = p^T g
//
// The residual's own gradient goes only into dq; D must see o_attn, which is
// why q is subtracted from the saved output (in f32) where the residual is on.
//
// The TPU kernels keep all of K and V in VMEM and accumulate dk and dv across
// a sequential q-tile grid axis. Blocks on the GPU run in no order, so the
// work is split as in FlashAttention-2: dq per block of q rows over every
// key, dk and dv per block of keys over a split of the q rows, the splits'
// f32 partials summed in a fixed order. There are no atomics: every route
// is deterministic. Each result is rounded once to the input type. Keys past
// Lk and q rows past Lq add nothing, so nothing is padded.
//
// What bounds it on this card: operations. The function needs five products
// of the forward's size (q k^T, g v^T, ds k, ds^T q, p^T g); the split into
// a dq and a dk/dv pass recomputes q k^T and g v^T in both. Three routes;
// ops/pooled_attention.py picks one per call (`backward_route`), by the
// forward's rule:
//
// - Tensor cores (`pvt_pooled_attention_bwd_tc`): bf16, c a multiple of 8,
//   more than a few query rows. The forward's tiles (csrc/hopper_tiles.cuh):
//   unswizzled core-matrix tiles filled by cp.async rings, bf16 wgmma with
//   f32 accumulators in registers.
//   1. `attention_bwd_dq_tc_kernel`: a block owns one (batch, head) and 192
//      query rows, three warpgroups of 64; its Q and G tiles are loaded once
//      and K/V tiles of 64 keys stream through a three-stage ring. S = Q K^T
//      and dP = G V^T are shared-memory wgmmas (V read K-major); p and ds
//      are formed on the accumulators in f32; dQ += dS K takes dS from
//      registers and K read MN-major, as the forward's O += P V. Its
//      prologue computes D for its rows from device memory and writes it out.
//   2. `attention_bwd_dkdv_tc_kernel`: a block owns one (batch, head), 128
//      keys (two warpgroups of 64) and one split of the q tiles; K and V are
//      loaded once and Q, G tiles of 64 rows with their lse and D stream
//      through the ring. S^T = K Q^T and dP^T = V G^T (shared memory); P^T
//      and dS^T on the accumulators, lse and D per column; dV += P^T G and
//      dK += dS^T Q from registers, G and Q read MN-major from the tiles the
//      first two products read K-major. One split writes dk and dv directly;
//      several write f32 partials that `attention_bwd_reduce_kernel` sums.
//   Rounding: the inputs are bf16, so S and dP are exact products summed in
//   f32; what the route adds is P and dS as bf16 A operands. bf16(x) alone
//   (2^-9 relative) puts dq, dk and dv each past the bf16 gradient
//   tolerance at few keys, so every A operand goes as a hi + lo pair (2^-16),
//   two wgmmas each: ten products of the forward's size in all (S, dP, 2 dQ;
//   S^T, dP^T, 2 dV, 2 dK).
// - Split keys (`pvt_pooled_attention_bwd_split`): bf16 as above, at most 8
//   query rows (MViT's cls query, Lq = 1). Bound by bytes: K and V read
//   once, dK and dV written once. The key axis is cut into the forward's
//   splits, one per 16-lane group (each lane holds 8 columns); each group
//   computes s, dp, p and ds of its keys for the rows, writes each key's dk
//   and dv (one owner per key, no partials) and an f32 dq partial of its
//   split; a second launch sums the dq partials in split order.
// - CUDA cores (`pvt_pooled_attention_bwd`): float32, and bf16 whose c is
//   not a multiple of 8 or whose data is not 16-byte aligned. Float32 stays
//   here because the tensor cores take bf16 (8 bits of mantissa) or TF32
//   (10), and the f32 path is held to 1e-4, beyond either. The first version
//   of this port; arithmetic f32 throughout (inputs converted on load):
//   1. `attention_bwd_delta_kernel`: D per (b, head, q row), one warp per row.
//   2. `attention_bwd_dkdv_kernel`: one block per (64-key tile, b * head, q
//      split). It holds its K and V tiles in shared memory and walks its share
//      of the q tiles, recomputing p and ds per tile; dk and dv accumulate in
//      registers in f32 and are written once, as f32 partials of its q split.
//   3. `attention_bwd_dq_kernel`: one block per (64-row q tile, b * head); it
//      walks every key tile and accumulates dq in registers in f32.
//   4. `attention_bwd_reduce_kernel`: sums the q splits' partials in a fixed
//      order and writes dk and dv in k's layout and type. Splitting q lets a
//      short key axis (MViT-B block 0: Lk 393, one head) still fill the card's
//      132 SMs.
//   Work split (128 threads, 64 x 64 tiles): thread (ty, tx) = (tid / 16,
//   tid % 16) owns tile rows 8*ty .. 8*ty + 7 (keys in the dk/dv kernel, q
//   rows in the dq kernel), and tile columns tx + 16*j (j < 4) of a 64 x 64
//   score tile, or head-dim columns tx + 16*j (j < DC/16) of an accumulator.
//   Shared-memory rows are padded by one float, as in the forward.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_tiles.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 64;          // q rows and keys per tile
constexpr int kRows = 8;           // tile rows per thread
constexpr int kCols = kTile / 16;  // score-tile columns per thread
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* g;
  const float* lse;  // (B, H, Lq)
  float* delta;      // (B, H, Lq) scratch
  float* dk_part;    // (splits, B, H, Lk, c) scratch
  float* dv_part;
  void* dq;
  void* dk;
  void* dv;
  int64_t B, H, Lq, Lk, c;
  int64_t sq[3], sk[3];  // (batch, head, row) strides: q, o, g, dq; k, v, dk, dv
  float scale;
  int residual;
  int64_t splits, tiles_per_split;
};

// Loads rows [row0, row0 + kTile) of a (rows, c) slice into a (kTile, DC+1)
// f32 tile; rows past `rows` and columns past c are zero.
template <typename T, int DC>
__device__ __forceinline__ void load_tile(float* tile, const T* src, int64_t row_stride,
                                          int64_t row0, int64_t rows, int64_t c) {
  for (int i = threadIdx.x; i < kTile * DC; i += kThreads) {
    const int r = i / DC, d = i % DC;
    float val = 0.0f;
    if (row0 + r < rows && d < c) val = to_f32(src[(row0 + r) * row_stride + d]);
    tile[r * (DC + 1) + d] = val;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) attention_bwd_delta_kernel(BwdArgs a) {
  const int64_t warp = ((int64_t)blockIdx.x * kThreads + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (warp >= a.B * a.H * a.Lq) return;  // whole warps leave together
  const int64_t row = warp % a.Lq, bh = warp / a.Lq;
  const int64_t off = (bh / a.H) * a.sq[0] + (bh % a.H) * a.sq[1] + row * a.sq[2];
  const T* q = static_cast<const T*>(a.q) + off;
  const T* o = static_cast<const T*>(a.o) + off;
  const T* g = static_cast<const T*>(a.g) + off;
  float acc = 0.0f;
  for (int64_t d = lane; d < a.c; d += 32) {
    float od = to_f32(o[d]);
    if (a.residual) od -= to_f32(q[d]);
    acc = fmaf(to_f32(g[d]), od, acc);
  }
#pragma unroll
  for (int off2 = 16; off2 > 0; off2 >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off2);
  if (lane == 0) a.delta[warp] = acc;
}

template <typename T, int DC>
__global__ void __launch_bounds__(kThreads) attention_bwd_dkdv_kernel(BwdArgs a) {
  constexpr int LD = DC + 1, LP = kTile + 1, kOut = DC / 16;
  extern __shared__ float smem[];
  float* sK = smem;               // keys x LD
  float* sV = sK + kTile * LD;
  float* sQ = sV + kTile * LD;    // q rows x LD
  float* sG = sQ + kTile * LD;
  float* sP = sG + kTile * LD;    // keys x LP: p^T of the tile
  float* sDS = sP + kTile * LP;   // keys x LP: ds^T of the tile
  float* sL = sDS + kTile * LP;   // q rows: lse * log2 e
  float* sD = sL + kTile;         // q rows: D

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int64_t k0 = (int64_t)blockIdx.x * kTile;
  const int64_t bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int64_t split = blockIdx.z;
  const int64_t qoff = b * a.sq[0] + h * a.sq[1], koff = b * a.sk[0] + h * a.sk[1];
  const T* qp = static_cast<const T*>(a.q) + qoff;
  const T* gp = static_cast<const T*>(a.g) + qoff;
  const float* lse = a.lse + bh * a.Lq;
  const float* delta = a.delta + bh * a.Lq;

  load_tile<T, DC>(sK, static_cast<const T*>(a.k) + koff, a.sk[2], k0, a.Lk, a.c);
  load_tile<T, DC>(sV, static_cast<const T*>(a.v) + koff, a.sk[2], k0, a.Lk, a.c);
  const float scale_log2 = a.scale * kLog2e;

  float dk[kRows][kOut], dv[kRows][kOut];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
#pragma unroll
    for (int j = 0; j < kOut; ++j) dk[i][j] = dv[i][j] = 0.0f;
  }

  const int64_t q_tiles = (a.Lq + kTile - 1) / kTile;
  const int64_t t_begin = split * a.tiles_per_split;
  const int64_t t_end =
      t_begin + a.tiles_per_split < q_tiles ? t_begin + a.tiles_per_split : q_tiles;
  for (int64_t t = t_begin; t < t_end; ++t) {
    const int64_t q0 = t * kTile;
    __syncthreads();  // the previous tile is done with sQ, sG, sP, sDS
    load_tile<T, DC>(sQ, qp, a.sq[2], q0, a.Lq, a.c);
    load_tile<T, DC>(sG, gp, a.sq[2], q0, a.Lq, a.c);
    for (int i = tid; i < kTile; i += kThreads) {
      const bool ok = q0 + i < a.Lq;
      sL[i] = ok ? lse[q0 + i] * kLog2e : 0.0f;
      sD[i] = ok ? delta[q0 + i] : 0.0f;
    }
    __syncthreads();

    // s^T = k q^T and dp^T = v g^T for keys 8*ty + i, q rows tx + 16*j.
    float s[kRows][kCols], dp[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = dp[i][j] = 0.0f;
    }
#pragma unroll 2
    for (int d = 0; d < DC; ++d) {
      float kv[kRows], vv[kRows], qv[kCols], gv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        kv[i] = sK[(ty * kRows + i) * LD + d];
        vv[i] = sV[(ty * kRows + i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        qv[j] = sQ[(tx + 16 * j) * LD + d];
        gv[j] = sG[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
          dp[i][j] = fmaf(vv[i], gv[j], dp[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int qr = tx + 16 * j;
        const float p = q0 + qr < a.Lq ? exp2f(s[i][j] * scale_log2 - sL[qr]) : 0.0f;
        sP[(ty * kRows + i) * LP + qr] = p;
        sDS[(ty * kRows + i) * LP + qr] = p * (dp[i][j] - sD[qr]);
      }
    }
    __syncthreads();

    // dv += p^T g and dk += ds^T q over the tile's q rows.
#pragma unroll 2
    for (int qr = 0; qr < kTile; ++qr) {
      float pv[kRows], dsv[kRows], gv[kOut], qv[kOut];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        pv[i] = sP[(ty * kRows + i) * LP + qr];
        dsv[i] = sDS[(ty * kRows + i) * LP + qr];
      }
#pragma unroll
      for (int j = 0; j < kOut; ++j) {
        gv[j] = sG[qr * LD + tx + 16 * j];
        qv[j] = sQ[qr * LD + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
#pragma unroll
        for (int j = 0; j < kOut; ++j) {
          dv[i][j] = fmaf(pv[i], gv[j], dv[i][j]);
          dk[i][j] = fmaf(dsv[i], qv[j], dk[i][j]);
        }
      }
    }
  }

  const int64_t part = ((split * a.B * a.H + bh) * a.Lk) * a.c;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int64_t key = k0 + ty * kRows + i;
    if (key >= a.Lk) continue;
#pragma unroll
    for (int j = 0; j < kOut; ++j) {
      const int col = tx + 16 * j;
      if (col >= a.c) continue;
      a.dk_part[part + key * a.c + col] = dk[i][j] * a.scale;
      a.dv_part[part + key * a.c + col] = dv[i][j];
    }
  }
}

template <typename T, int DC>
__global__ void __launch_bounds__(kThreads) attention_bwd_dq_kernel(BwdArgs a) {
  constexpr int LD = DC + 1, LP = kTile + 1, kOut = DC / 16;
  extern __shared__ float smem[];
  float* sQ = smem;               // q rows x LD
  float* sG = sQ + kTile * LD;
  float* sK = sG + kTile * LD;    // keys x LD
  float* sV = sK + kTile * LD;
  float* sDS = sV + kTile * LD;   // q rows x LP: ds of the tile

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int64_t q0 = (int64_t)blockIdx.x * kTile;
  const int64_t bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int64_t qoff = b * a.sq[0] + h * a.sq[1], koff = b * a.sk[0] + h * a.sk[1];
  const T* kp = static_cast<const T*>(a.k) + koff;
  const T* vp = static_cast<const T*>(a.v) + koff;

  load_tile<T, DC>(sQ, static_cast<const T*>(a.q) + qoff, a.sq[2], q0, a.Lq, a.c);
  load_tile<T, DC>(sG, static_cast<const T*>(a.g) + qoff, a.sq[2], q0, a.Lq, a.c);
  const float scale_log2 = a.scale * kLog2e;
  float lse2[kRows], D[kRows], acc[kRows][kOut];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int64_t row = q0 + ty * kRows + i;
    lse2[i] = row < a.Lq ? a.lse[bh * a.Lq + row] * kLog2e : 0.0f;
    D[i] = row < a.Lq ? a.delta[bh * a.Lq + row] : 0.0f;
#pragma unroll
    for (int j = 0; j < kOut; ++j) acc[i][j] = 0.0f;
  }

  for (int64_t k0 = 0; k0 < a.Lk; k0 += kTile) {
    __syncthreads();  // the previous tile is done with sK, sV, sDS
    load_tile<T, DC>(sK, kp, a.sk[2], k0, a.Lk, a.c);
    load_tile<T, DC>(sV, vp, a.sk[2], k0, a.Lk, a.c);
    __syncthreads();

    // s = q k^T and dp = g v^T for q rows 8*ty + i, keys tx + 16*j.
    float s[kRows][kCols], dp[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = dp[i][j] = 0.0f;
    }
#pragma unroll 2
    for (int d = 0; d < DC; ++d) {
      float qv[kRows], gv[kRows], kv[kCols], vv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        qv[i] = sQ[(ty * kRows + i) * LD + d];
        gv[i] = sG[(ty * kRows + i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        kv[j] = sK[(tx + 16 * j) * LD + d];
        vv[j] = sV[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kc = tx + 16 * j;
        const float p = k0 + kc < a.Lk ? exp2f(s[i][j] * scale_log2 - lse2[i]) : 0.0f;
        sDS[(ty * kRows + i) * LP + kc] = p * (dp[i][j] - D[i]);
      }
    }
    __syncthreads();

    // dq += ds k over the tile's keys.
#pragma unroll 2
    for (int kk = 0; kk < kTile; ++kk) {
      float dsv[kRows], kv[kOut];
#pragma unroll
      for (int i = 0; i < kRows; ++i) dsv[i] = sDS[(ty * kRows + i) * LP + kk];
#pragma unroll
      for (int j = 0; j < kOut; ++j) kv[j] = sK[kk * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
#pragma unroll
        for (int j = 0; j < kOut; ++j) acc[i][j] = fmaf(dsv[i], kv[j], acc[i][j]);
      }
    }
  }

  T* dqp = static_cast<T*>(a.dq) + qoff;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = ty * kRows + i;
    if (q0 + r >= a.Lq) continue;
#pragma unroll
    for (int j = 0; j < kOut; ++j) {
      const int col = tx + 16 * j;
      if (col >= a.c) continue;
      float y = acc[i][j] * a.scale;
      if (a.residual) y += sG[r * LD + col];
      dqp[(q0 + r) * a.sq[2] + col] = from_f32<T>(y);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(256) attention_bwd_reduce_kernel(BwdArgs a) {
  const int64_t n = a.B * a.H * a.Lk * a.c;
  const int64_t idx = (int64_t)blockIdx.x * 256 + threadIdx.x;
  if (idx >= n) return;
  const int64_t col = idx % a.c, r = idx / a.c, key = r % a.Lk, bh = r / a.Lk;
  float sk = 0.0f, sv = 0.0f;
  for (int64_t s = 0; s < a.splits; ++s) {
    sk += a.dk_part[s * n + idx];
    sv += a.dv_part[s * n + idx];
  }
  const int64_t off = (bh / a.H) * a.sk[0] + (bh % a.H) * a.sk[1] + key * a.sk[2] + col;
  static_cast<T*>(a.dk)[off] = from_f32<T>(sk);
  static_cast<T*>(a.dv)[off] = from_f32<T>(sv);
}

template <typename T, int DC>
cudaError_t launch(const BwdArgs& a, cudaStream_t stream) {
  const int64_t rows = a.B * a.H * a.Lq;
  attention_bwd_delta_kernel<T>
      <<<(unsigned)((rows * 32 + kThreads - 1) / kThreads), kThreads, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t smem_dkdv =
      sizeof(float) * (4 * kTile * (DC + 1) + 2 * kTile * (kTile + 1) + 2 * kTile);
  err = cudaFuncSetAttribute(attention_bwd_dkdv_kernel<T, DC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_dkdv);
  if (err != cudaSuccess) return err;
  const dim3 grid_kv((unsigned)((a.Lk + kTile - 1) / kTile), (unsigned)(a.B * a.H),
                     (unsigned)a.splits);
  attention_bwd_dkdv_kernel<T, DC><<<grid_kv, kThreads, smem_dkdv, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t smem_dq = sizeof(float) * (4 * kTile * (DC + 1) + kTile * (kTile + 1));
  err = cudaFuncSetAttribute(attention_bwd_dq_kernel<T, DC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_dq);
  if (err != cudaSuccess) return err;
  const dim3 grid_q((unsigned)((a.Lq + kTile - 1) / kTile), (unsigned)(a.B * a.H));
  attention_bwd_dq_kernel<T, DC><<<grid_q, kThreads, smem_dq, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int64_t n = a.B * a.H * a.Lk * a.c;
  attention_bwd_reduce_kernel<T><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dc(const BwdArgs& a, cudaStream_t stream) {
  if (a.c <= 32) return launch<T, 32>(a, stream);
  if (a.c <= 64) return launch<T, 64>(a, stream);
  if (a.c <= 96) return launch<T, 96>(a, stream);
  if (a.c <= 128) return launch<T, 128>(a, stream);
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// Tensor-core route: bf16, c a multiple of 8 (at most 128), 16-byte aligned
// tensors, more than a few query rows.

namespace tc {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int kBN = 64;      // rows of a streamed tile: keys (dQ kernel), q rows (dK/dV kernel)
constexpr int kStages = 3;   // streamed tiles in the ring
// dQ kernel: three warpgroups of 64 query rows share each K/V tile, as in
// the forward. dK/dV kernel: two warpgroups of 64 keys share each Q/G tile;
// each thread holds dK and dV (c floats) beside S^T and dP^T (64 floats),
// which at c = 128 leaves no room for a third warpgroup's registers.
constexpr int kDqWarpgroups = 3;
constexpr int kDqThreads = 128 * kDqWarpgroups;
constexpr int kDqRows = 64 * kDqWarpgroups;  // q rows per dQ block
constexpr int kKvWarpgroups = 2;
constexpr int kKvThreads = 128 * kKvWarpgroups;
constexpr int kKvRows = 64 * kKvWarpgroups;  // keys per dK/dV block

// The register A operands of m64nNk16 from a 64 x 64 f32 accumulator x, as
// in the forward's P: for columns 16kk .. 16kk + 15, {row r0, row r0 + 8} x
// {columns 2 (lane % 4) + (0, 1), + 8}. Each value goes as two bf16 terms,
// hi = x with its low 16 bits cut and lo = bf16(x - hi), each a product of
// its own: bf16(x) alone puts dQ, dK and dV past the bf16 gradient
// tolerance at few keys (tests/test_torch_train_grads.py emulates both).
__device__ __forceinline__ void split_fragments(const float (&x)[32], uint32_t (&hi)[4][4],
                                                uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float e0 = x[4 * n + 2 * i], e1 = x[4 * n + 2 * i + 1];
      const uint32_t b0 = __float_as_uint(e0), b1 = __float_as_uint(e1);
      hi[n / 2][(n % 2) * 2 + i] = __byte_perm(b0, b1, 0x7632);
      lo[n / 2][(n % 2) * 2 + i] = pack_bf16(e0 - __uint_as_float(b0 & 0xffff0000u),
                                             e1 - __uint_as_float(b1 & 0xffff0000u));
    }
  }
}

// Accumulator layout of m64nN (per warpgroup): thread (warp, lane) holds
// rows r0 = 16 * warp + lane / 4 and r0 + 8, columns 8n + 2 (lane % 4) and
// + 1, as d[4n + 2i + j] for row r0 + 8i, column + j.

// One block per (192 query rows, head, batch): dQ, and D for its rows.
template <int DC>
__global__ void __launch_bounds__(kDqThreads, 1) attention_bwd_dq_tc_kernel(BwdArgs a) {
  constexpr int kGroupBytes = DC / 8 * 128;  // one 8-row group of a tile
  constexpr int kQBytes = kDqRows * DC * 2;
  constexpr int kKVBytes = kBN * DC * 2;
  extern __shared__ __align__(128) unsigned char dq_smem[];
  const uint32_t sQ = smem_addr(dq_smem);
  const uint32_t sG = sQ + kQBytes;
  const uint32_t sK = sG + kQBytes;             // kStages K tiles
  const uint32_t sV = sK + kStages * kKVBytes;  // kStages V tiles

  const int wg = threadIdx.x / 128, warp = threadIdx.x % 128 / 32, lane = threadIdx.x % 32;
  const int64_t q0 = (int64_t)blockIdx.x * kDqRows;
  const int64_t h = blockIdx.y, b = blockIdx.z, bh = b * a.H + h;
  const int64_t qoff = b * a.sq[0] + h * a.sq[1], koff = b * a.sk[0] + h * a.sk[1];
  const bf16* qp = static_cast<const bf16*>(a.q) + qoff;
  const bf16* gp = static_cast<const bf16*>(a.g) + qoff;
  const bf16* op = static_cast<const bf16*>(a.o) + qoff;
  const bf16* kp = static_cast<const bf16*>(a.k) + koff;
  const bf16* vp = static_cast<const bf16*>(a.v) + koff;
  const int n_tiles = (int)((a.Lk + kBN - 1) / kBN);

  // Q and G with the first K/V tiles in the first group.
  hopper::load_tile<DC, kDqRows, kDqThreads>(sQ, qp, a.sq[2], q0, a.Lq, a.c);
  hopper::load_tile<DC, kDqRows, kDqThreads>(sG, gp, a.sq[2], q0, a.Lq, a.c);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles) {
      hopper::load_tile<DC, kBN, kDqThreads>(sK + s * kKVBytes, kp, a.sk[2], (int64_t)s * kBN, a.Lk, a.c);
      hopper::load_tile<DC, kBN, kDqThreads>(sV + s * kKVBytes, vp, a.sk[2], (int64_t)s * kBN, a.Lk, a.c);
    }
    cp_async_commit();
  }

  // While the tiles land: each of the thread's two rows' lse (log2 domain;
  // +inf past Lq, so p = 0 there) and D = rowsum(g * o_attn), read from
  // device memory, the quad's four lanes taking alternate 16-byte chunks.
  // D goes out for the dK/dV kernel, which runs next.
  float lse2[2], dlt[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int64_t row = q0 + wg * 64 + 16 * warp + lane / 4 + 8 * i;
    const bool ok = row < a.Lq;
    float acc = 0.0f;
    if (ok) {
      for (int ch = lane % 4; ch * 8 < a.c; ch += 4) {
        float gx[8], ox[8], qx[8];
        load8(gp + row * a.sq[2] + 8 * ch, gx);
        load8(op + row * a.sq[2] + 8 * ch, ox);
        if (a.residual) {
          load8(qp + row * a.sq[2] + 8 * ch, qx);
#pragma unroll
          for (int e = 0; e < 8; ++e) ox[e] -= qx[e];
        }
#pragma unroll
        for (int e = 0; e < 8; ++e) acc = fmaf(gx[e], ox[e], acc);
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    dlt[i] = acc;
    lse2[i] = ok ? a.lse[bh * a.Lq + row] * kLog2e : INFINITY;
    if (ok && lane % 4 == 0) a.delta[bh * a.Lq + row] = acc;
  }

  float dq[DC / 2];
#pragma unroll
  for (int i = 0; i < DC / 2; ++i) dq[i] = 0.0f;
  const float scale_log2 = a.scale * kLog2e;
  const uint32_t sQw = sQ + wg * 64 * DC * 2, sGw = sG + wg * 64 * DC * 2;  // this warpgroup's rows

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<kStages - 2>();  // tile `it` has landed
    fence_async_smem();
    __syncthreads();  // ... for every thread; and every warpgroup is done with tile it - 1
    {
      const int next = it + kStages - 1;  // into the stage tile it - 1 used
      if (next < n_tiles) {
        const int st = next % kStages;
        hopper::load_tile<DC, kBN, kDqThreads>(sK + st * kKVBytes, kp, a.sk[2], (int64_t)next * kBN, a.Lk, a.c);
        hopper::load_tile<DC, kBN, kDqThreads>(sV + st * kKVBytes, vp, a.sk[2], (int64_t)next * kBN, a.Lk, a.c);
      }
      cp_async_commit();
    }
    const uint32_t sKt = sK + (it % kStages) * kKVBytes, sVt = sV + (it % kStages) * kKVBytes;

    // S = Q K^T and dP = G V^T, reduced over c in steps of 16.
    float s[kBN / 2], dp[kBN / 2];
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) s[i] = dp[i] = 0.0f;
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DC / 16; ++kk) {
      wgmma_ss(s, make_desc(sQw + kk * 256, 128, kGroupBytes),
               make_desc(sKt + kk * 256, 128, kGroupBytes), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < DC / 16; ++kk) {
      wgmma_ss(dp, make_desc(sGw + kk * 256, 128, kGroupBytes),
               make_desc(sVt + kk * 256, 128, kGroupBytes), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);

    // p = 2^(s scale log2 e - lse log2 e), ds = p (dp - D), in dp's
    // registers; keys past Lk (in the last tile only) get p = 0.
    if ((int64_t)(it + 1) * kBN > a.Lk) {
      const int valid = (int)(a.Lk - (int64_t)it * kBN) - 2 * (lane % 4);
#pragma unroll
      for (int n = 0; n < kBN / 8; ++n) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (8 * n + j % 2 >= valid) s[4 * n + j] = -INFINITY;
        }
      }
    }
#pragma unroll
    for (int n = 0; n < kBN / 8; ++n) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = fast_exp2(fmaf(s[4 * n + j], scale_log2, -lse2[j / 2]));
        dp[4 * n + j] = p * (dp[4 * n + j] - dlt[j / 2]);
      }
    }
    uint32_t ds_hi[kBN / 16][4], ds_lo[kBN / 16][4];
    split_fragments(dp, ds_hi, ds_lo);

    // dQ += dS K, reduced over the tile's keys in steps of 16; K read
    // MN-major, as the forward reads V.
    fence_regs(dq);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      const uint64_t k_desc = make_desc(sKt + kk * 2 * kGroupBytes, kGroupBytes, 128);
      wgmma_rs(dq, ds_hi[kk], k_desc);
      wgmma_rs(dq, ds_lo[kk], k_desc);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dq);
  }

  // dq * scale (+ g with the residual), rounded once; rows past Lq and
  // columns past c are not stored.
  const unsigned char* g_tile = dq_smem + kQBytes;
  bf16* dqp = static_cast<bf16*>(a.dq) + qoff;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = wg * 64 + 16 * warp + lane / 4 + 8 * i;  // row of the block
    const int64_t row = q0 + r;
    if (row >= a.Lq) continue;
#pragma unroll
    for (int n = 0; n < DC / 8; ++n) {
      const int col = 8 * n + 2 * (lane % 4);
      if (col >= a.c) continue;
      float y0 = dq[4 * n + 2 * i] * a.scale, y1 = dq[4 * n + 2 * i + 1] * a.scale;
      if (a.residual) {
        const __nv_bfloat162 gv =
            *reinterpret_cast<const __nv_bfloat162*>(g_tile + tile_offset<DC>(r, col));
        y0 += __low2float(gv);
        y1 += __high2float(gv);
      }
      *reinterpret_cast<__nv_bfloat162*>(dqp + row * a.sq[2] + col) = __floats2bfloat162_rn(y0, y1);
    }
  }
}

// One block per (128 keys, batch * head, q split): dK and dV of its keys
// over its split's q tiles. A stage of the ring holds a Q tile, a G tile and
// the tile rows' lse and D.
template <int DC>
__global__ void __launch_bounds__(kKvThreads, 1) attention_bwd_dkdv_tc_kernel(BwdArgs a) {
  constexpr int kGroupBytes = DC / 8 * 128;
  constexpr int kKBytes = kKvRows * DC * 2;   // the block's K (or V)
  constexpr int kTileBytes = kBN * DC * 2;    // a Q (or G) tile
  constexpr int kStageBytes = 2 * kTileBytes + 2 * kBN * 4;
  extern __shared__ __align__(128) unsigned char kv_smem[];
  const uint32_t sK = smem_addr(kv_smem);
  const uint32_t sV = sK + kKBytes;
  const uint32_t sRing = sV + kKBytes;

  const int wg = threadIdx.x / 128, warp = threadIdx.x % 128 / 32, lane = threadIdx.x % 32;
  const int64_t k0 = (int64_t)blockIdx.x * kKvRows;
  const int64_t bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int64_t split = blockIdx.z;
  const int64_t qoff = b * a.sq[0] + h * a.sq[1], koff = b * a.sk[0] + h * a.sk[1];
  const bf16* qp = static_cast<const bf16*>(a.q) + qoff;
  const bf16* gp = static_cast<const bf16*>(a.g) + qoff;
  const float* lse = a.lse + bh * a.Lq;
  const float* delta = a.delta + bh * a.Lq;
  const int64_t q_tiles = (a.Lq + kBN - 1) / kBN;
  const int64_t t_begin = split * a.tiles_per_split;
  const int64_t t_end =
      t_begin + a.tiles_per_split < q_tiles ? t_begin + a.tiles_per_split : q_tiles;
  const int n_tiles = (int)(t_end - t_begin);

  // Q rows past Lq are zero, and so are their lse and D: s = 0, p = 1,
  // dp = 0, ds = 0, so they add exactly nothing to dK or dV.
  auto load_stage = [&](int st, int64_t t) {
    const uint32_t base = sRing + st * kStageBytes;
    const int64_t row0 = t * kBN;
    hopper::load_tile<DC, kBN, kKvThreads>(base, qp, a.sq[2], row0, a.Lq, a.c);
    hopper::load_tile<DC, kBN, kKvThreads>(base + kTileBytes, gp, a.sq[2], row0, a.Lq, a.c);
    if (threadIdx.x < 2 * kBN) {
      const int i = threadIdx.x % kBN;
      const bool valid = row0 + i < a.Lq;
      const float* src = threadIdx.x < kBN ? lse : delta;
      cp_async_4(base + 2 * kTileBytes + 4 * threadIdx.x, valid ? src + row0 + i : src, valid);
    }
  };

  // K and V with the first Q/G tiles in the first group.
  hopper::load_tile<DC, kKvRows, kKvThreads>(sK, static_cast<const bf16*>(a.k) + koff, a.sk[2], k0, a.Lk, a.c);
  hopper::load_tile<DC, kKvRows, kKvThreads>(sV, static_cast<const bf16*>(a.v) + koff, a.sk[2], k0, a.Lk, a.c);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles) load_stage(s, t_begin + s);
    cp_async_commit();
  }

  // A warpgroup whose 64 keys all lie past Lk skips the products but keeps
  // the barriers.
  const bool active = k0 + wg * 64 < a.Lk;
  float dk[DC / 2], dv[DC / 2];
#pragma unroll
  for (int i = 0; i < DC / 2; ++i) dk[i] = dv[i] = 0.0f;
  const float scale_log2 = a.scale * kLog2e;
  const uint32_t sKw = sK + wg * 64 * DC * 2, sVw = sV + wg * 64 * DC * 2;

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<kStages - 2>();
    fence_async_smem();
    __syncthreads();
    {
      const int next = it + kStages - 1;
      if (next < n_tiles) load_stage(next % kStages, t_begin + next);
      cp_async_commit();
    }
    if (!active) continue;
    const uint32_t sQt = sRing + (it % kStages) * kStageBytes, sGt = sQt + kTileBytes;
    const float* lse_t =
        reinterpret_cast<const float*>(kv_smem + (sQt - sK) + 2 * kTileBytes);
    const float* dlt_t = lse_t + kBN;

    // S^T = K Q^T and dP^T = V G^T: keys are the rows, the tile's q rows
    // the columns.
    float st[kBN / 2], dpt[kBN / 2];
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) st[i] = dpt[i] = 0.0f;
    fence_regs(st);
    fence_regs(dpt);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DC / 16; ++kk) {
      wgmma_ss(st, make_desc(sKw + kk * 256, 128, kGroupBytes),
               make_desc(sQt + kk * 256, 128, kGroupBytes), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < DC / 16; ++kk) {
      wgmma_ss(dpt, make_desc(sVw + kk * 256, 128, kGroupBytes),
               make_desc(sGt + kk * 256, 128, kGroupBytes), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(st);
    fence_regs(dpt);

    // P^T and dS^T in place; lse and D are per column (q row).
#pragma unroll
    for (int n = 0; n < kBN / 8; ++n) {
      const int col = 8 * n + 2 * (lane % 4);
      const float2 l2 = *reinterpret_cast<const float2*>(lse_t + col);
      const float2 d2 = *reinterpret_cast<const float2*>(dlt_t + col);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = fast_exp2(fmaf(st[4 * n + j], scale_log2, -(j % 2 ? l2.y : l2.x) * kLog2e));
        st[4 * n + j] = p;
        dpt[4 * n + j] = p * (dpt[4 * n + j] - (j % 2 ? d2.y : d2.x));
      }
    }
    uint32_t p_hi[kBN / 16][4], p_lo[kBN / 16][4], ds_hi[kBN / 16][4], ds_lo[kBN / 16][4];
    split_fragments(st, p_hi, p_lo);
    split_fragments(dpt, ds_hi, ds_lo);

    // dV += P^T G and dK += dS^T Q over the tile's q rows in steps of 16;
    // G and Q read MN-major from the tiles the products above read K-major.
    fence_regs(dv);
    fence_regs(dk);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      const uint64_t g_desc = make_desc(sGt + kk * 2 * kGroupBytes, kGroupBytes, 128);
      const uint64_t q_desc = make_desc(sQt + kk * 2 * kGroupBytes, kGroupBytes, 128);
      wgmma_rs(dv, p_hi[kk], g_desc);
      wgmma_rs(dv, p_lo[kk], g_desc);
      wgmma_rs(dk, ds_hi[kk], q_desc);
      wgmma_rs(dk, ds_lo[kk], q_desc);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dv);
    fence_regs(dk);
  }

  // One q split: dK and dV in k's layout and type. Several: f32 partials of
  // this split, summed by attention_bwd_reduce_kernel.
  const int64_t part = (split * a.B * a.H + bh) * a.Lk * a.c;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int64_t key = k0 + wg * 64 + 16 * warp + lane / 4 + 8 * i;
    if (key >= a.Lk) continue;
#pragma unroll
    for (int n = 0; n < DC / 8; ++n) {
      const int col = 8 * n + 2 * (lane % 4);
      if (col >= a.c) continue;
      const float k0v = dk[4 * n + 2 * i] * a.scale, k1v = dk[4 * n + 2 * i + 1] * a.scale;
      const float v0 = dv[4 * n + 2 * i], v1 = dv[4 * n + 2 * i + 1];
      if (a.splits == 1) {
        const int64_t off = koff + key * a.sk[2] + col;
        *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(a.dk) + off) =
            __floats2bfloat162_rn(k0v, k1v);
        *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(a.dv) + off) =
            __floats2bfloat162_rn(v0, v1);
      } else {
        *reinterpret_cast<float2*>(a.dk_part + part + key * a.c + col) = make_float2(k0v, k1v);
        *reinterpret_cast<float2*>(a.dv_part + part + key * a.c + col) = make_float2(v0, v1);
      }
    }
  }
}

template <int DC>
cudaError_t launch(const BwdArgs& a, cudaStream_t stream) {
  constexpr int smem_dq = 2 * kDqRows * DC * 2 + 2 * kStages * kBN * DC * 2;
  cudaError_t err = cudaFuncSetAttribute(attention_bwd_dq_tc_kernel<DC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_dq);
  if (err != cudaSuccess) return err;
  const dim3 grid_q((unsigned)((a.Lq + kDqRows - 1) / kDqRows), (unsigned)a.H, (unsigned)a.B);
  attention_bwd_dq_tc_kernel<DC><<<grid_q, kDqThreads, smem_dq, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  constexpr int smem_kv = 2 * kKvRows * DC * 2 + kStages * (2 * kBN * DC * 2 + 2 * kBN * 4);
  err = cudaFuncSetAttribute(attention_bwd_dkdv_tc_kernel<DC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem_kv);
  if (err != cudaSuccess) return err;
  const dim3 grid_kv((unsigned)((a.Lk + kKvRows - 1) / kKvRows), (unsigned)(a.B * a.H),
                     (unsigned)a.splits);
  attention_bwd_dkdv_tc_kernel<DC><<<grid_kv, kKvThreads, smem_kv, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return err;

  const int64_t n = a.B * a.H * a.Lk * a.c;
  attention_bwd_reduce_kernel<bf16><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t launch_dc(const BwdArgs& a, cudaStream_t stream) {
  if (a.c <= 32) return launch<32>(a, stream);
  if (a.c <= 64) return launch<64>(a, stream);
  if (a.c <= 96) return launch<96>(a, stream);
  return launch<128>(a, stream);
}

}  // namespace tc

// ---------------------------------------------------------------------------
// Split-key route: as the tensor-core route, at most kMaxRows query rows.

namespace split {

using hopper::fast_exp2;
using hopper::load8;
using bf16 = __nv_bfloat16;

constexpr int kMaxRows = 8;    // query rows a call may have
constexpr int kThreads = 128;  // 8 groups of 16 lanes, one split each
constexpr int kGroups = kThreads / 16;
constexpr int kCombineThreads = 256;

struct SplitBwdArgs {
  BwdArgs a;
  float* part_dq;  // (B, H, splits, Lq, c) dq of each split, unscaled
  int64_t splits, per_split;
};

__device__ __forceinline__ void store8(bf16* p, const float (&x)[8], float scale) {
  uint4 u;
  uint32_t* w = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) w[j] = hopper::pack_bf16(x[2 * j] * scale, x[2 * j + 1] * scale);
  *reinterpret_cast<uint4*>(p) = u;
}

// A group of 16 lanes owns split `part % splits` of (batch, head)
// `part / splits`: keys [split * per_split, + per_split) below Lk. Lane i
// holds columns 8i .. 8i + 7 of the R query rows, of their g, and of each
// key; a score is its 8 products summed over the group by 4 shuffles. Each
// key's dk and dv are written by its group alone; dq goes out as the
// split's f32 partial. Rows past Lq are zero rows with p = 0.
template <int R, int kUnroll>
__global__ void __launch_bounds__(kThreads) attention_bwd_split_kernel(SplitBwdArgs sa) {
  const BwdArgs& a = sa.a;
  const int lane = threadIdx.x % 16;
  const unsigned group_mask = (threadIdx.x % 32) < 16 ? 0x0000ffffu : 0xffff0000u;
  const int64_t part = (int64_t)blockIdx.x * kGroups + threadIdx.x / 16;
  const bool active = part < a.B * a.H * sa.splits;
  const int64_t bh = part / sa.splits, b = bh / a.H, h = bh % a.H;
  const int64_t k_begin = part % sa.splits * sa.per_split;
  const int64_t k_end = !active ? k_begin : k_begin + sa.per_split < a.Lk ? k_begin + sa.per_split : a.Lk;
  const bool has_cols = active && 8 * lane < a.c;
  const int64_t qoff = b * a.sq[0] + h * a.sq[1] + 8 * lane;
  const int64_t koff = b * a.sk[0] + h * a.sk[1] + 8 * lane;
  const bf16* kp = static_cast<const bf16*>(a.k) + koff;
  const bf16* vp = static_cast<const bf16*>(a.v) + koff;
  const float scale_log2 = a.scale * kLog2e;

  // The rows' q and g, lse (log2 domain) and D = rowsum(g * o_attn).
  float q[R][8], g[R][8], dq[R][8], lse2[R], dlt[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const bool ok = has_cols && r < a.Lq;
    float acc = 0.0f;
    if (ok) {
      const int64_t off = qoff + r * a.sq[2];
      float o[8];
      load8(static_cast<const bf16*>(a.q) + off, q[r]);
      load8(static_cast<const bf16*>(a.g) + off, g[r]);
      load8(static_cast<const bf16*>(a.o) + off, o);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc = fmaf(g[r][e], a.residual ? o[e] - q[r][e] : o[e], acc);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) q[r][e] = g[r][e] = 0.0f;
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) acc += __shfl_xor_sync(group_mask, acc, off, 16);
    dlt[r] = acc;
    lse2[r] = active && r < a.Lq ? a.lse[bh * a.Lq + r] * kLog2e : INFINITY;
#pragma unroll
    for (int e = 0; e < 8; ++e) dq[r][e] = 0.0f;
  }

  for (int64_t j0 = k_begin; j0 < k_end; j0 += kUnroll) {
    float kx[kUnroll][8], vx[kUnroll][8];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (has_cols && j0 + u < k_end) {
        load8(kp + (j0 + u) * a.sk[2], kx[u]);
        load8(vp + (j0 + u) * a.sk[2], vx[u]);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) kx[u][e] = vx[u][e] = 0.0f;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float dk[8] = {}, dv[8] = {};
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float s = 0.0f, dp = 0.0f;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          s = fmaf(q[r][e], kx[u][e], s);
          dp = fmaf(g[r][e], vx[u][e], dp);
        }
#pragma unroll
        for (int off = 8; off > 0; off >>= 1) {
          s += __shfl_xor_sync(group_mask, s, off, 16);
          dp += __shfl_xor_sync(group_mask, dp, off, 16);
        }
        const float p = fast_exp2(fmaf(s, scale_log2, -lse2[r]));
        const float ds = p * (dp - dlt[r]);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          dk[e] = fmaf(ds, q[r][e], dk[e]);
          dv[e] = fmaf(p, g[r][e], dv[e]);
          dq[r][e] = fmaf(ds, kx[u][e], dq[r][e]);
        }
      }
      if (has_cols && j0 + u < k_end) {
        const int64_t off = (j0 + u) * a.sk[2];
        store8(static_cast<bf16*>(a.dk) + koff + off, dk, a.scale);
        store8(static_cast<bf16*>(a.dv) + koff + off, dv, 1.0f);
      }
    }
  }

  if (!has_cols) return;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (r >= a.Lq) break;
    float4* dst = reinterpret_cast<float4*>(sa.part_dq + (part * a.Lq + r) * a.c + 8 * lane);
    dst[0] = make_float4(dq[r][0], dq[r][1], dq[r][2], dq[r][3]);
    dst[1] = make_float4(dq[r][4], dq[r][5], dq[r][6], dq[r][7]);
  }
}

// One thread per (batch, head, row, column): the splits' dq partials summed
// in split order, times the scale, plus g with the residual.
__global__ void __launch_bounds__(kCombineThreads) attention_bwd_split_combine_kernel(SplitBwdArgs sa) {
  const BwdArgs& a = sa.a;
  const int64_t i = (int64_t)blockIdx.x * kCombineThreads + threadIdx.x;
  if (i >= a.B * a.H * a.Lq * a.c) return;
  const int64_t col = i % a.c, row = i / a.c % a.Lq, bh = i / a.c / a.Lq;
  const int64_t off = (bh / a.H) * a.sq[0] + (bh % a.H) * a.sq[1] + row * a.sq[2] + col;
  float acc = 0.0f;
  for (int64_t s = 0; s < sa.splits; ++s) {
    acc += sa.part_dq[((bh * sa.splits + s) * a.Lq + row) * a.c + col];
  }
  float y = acc * a.scale;
  if (a.residual) y += __bfloat162float(static_cast<const bf16*>(a.g)[off]);
  static_cast<bf16*>(a.dq)[off] = __float2bfloat16(y);
}

cudaError_t launch(const SplitBwdArgs& sa, cudaStream_t stream) {
  const BwdArgs& a = sa.a;
  const int64_t parts = a.B * a.H * sa.splits;
  const unsigned blocks = (unsigned)((parts + kGroups - 1) / kGroups);
  if (a.Lq == 1) {
    attention_bwd_split_kernel<1, 4><<<blocks, kThreads, 0, stream>>>(sa);
  } else {
    attention_bwd_split_kernel<kMaxRows, 1><<<blocks, kThreads, 0, stream>>>(sa);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t outputs = a.B * a.H * a.Lq * a.c;
  attention_bwd_split_combine_kernel<<<(unsigned)((outputs + kCombineThreads - 1) / kCombineThreads),
                                       kCombineThreads, 0, stream>>>(sa);
  return cudaGetLastError();
}

}  // namespace split

// The bf16 routes load and store 16 bytes at a time: 16-byte aligned
// tensors whose strides are multiples of 8 elements, 8 <= c <= 128.
bool vector_ready(const BwdArgs& a) {
  const void* ptrs[8] = {a.q, a.k, a.v, a.o, a.g, a.dq, a.dk, a.dv};
  for (const void* p : ptrs) {
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  }
  for (int i = 0; i < 3; ++i) {
    if (a.sq[i] % 8 || a.sk[i] % 8) return false;
  }
  return a.c % 8 == 0 && a.c >= 8 && a.c <= 128 && a.Lq >= 1 && a.Lk >= 1 && a.H <= 65535 &&
         a.B <= 65535;
}

BwdArgs make_args(const void* q, const void* k, const void* v, const void* o, const void* g,
                  const float* lse, float* delta, float* dk_part, float* dv_part, void* dq,
                  void* dk, void* dv, int64_t B, int64_t H, int64_t Lq, int64_t Lk, int64_t c,
                  const int64_t* strides, float scale, int residual, int64_t splits,
                  int64_t tiles_per_split) {
  BwdArgs a{q, k, v, o, g, lse, delta, dk_part, dv_part, dq, dk, dv, B, H, Lq, Lk, c,
            {}, {}, scale, residual, splits, tiles_per_split};
  for (int i = 0; i < 3; ++i) {
    a.sq[i] = strides[i];
    a.sk[i] = strides[3 + i];
  }
  return a;
}

}  // namespace

// q, o, g, dq: (B, H, Lq, c) and k, v, dk, dv: (B, H, Lk, c) as seen through
// `strides`, 6 int64 (batch, head, row) strides in elements: the q-shaped
// tensors' then the k-shaped ones'; the c axis is contiguous. lse: the
// forward's (B, H, Lq) float32 row log-sum-exp. residual != 0: o = attn + q.
// Each returns the first cudaGetLastError() after a launch (0 on success),
// or cudaErrorInvalidValue for inputs its route does not take.

// The CUDA-core route. Scratch from the caller: delta (B*H*Lq floats) and
// dk_part, dv_part (splits*B*H*Lk*c floats each), with splits *
// tiles_per_split >= ceil(Lq / 64). c <= 128, Lq >= 1, Lk >= 1. dtype: 0 =
// float32, 1 = bfloat16.
extern "C" int pvt_pooled_attention_bwd(const void* q, const void* k, const void* v,
                                        const void* o, const void* g, const float* lse,
                                        float* delta, float* dk_part, float* dv_part, void* dq,
                                        void* dk, void* dv, int64_t B, int64_t H, int64_t Lq,
                                        int64_t Lk, int64_t c, const int64_t* strides,
                                        float scale, int residual, int64_t splits,
                                        int64_t tiles_per_split, int dtype, void* stream) {
  if (B * H == 0) return (int)cudaSuccess;
  const int64_t q_tiles = (Lq + kTile - 1) / kTile;
  if (Lq < 1 || Lk < 1 || c < 1 || B * H > 65535 || splits < 1 || splits > 65535 ||
      splits * tiles_per_split < q_tiles || q_tiles > 0x7fffffff) {
    return (int)cudaErrorInvalidValue;
  }
  const BwdArgs a = make_args(q, k, v, o, g, lse, delta, dk_part, dv_part, dq, dk, dv, B, H, Lq,
                              Lk, c, strides, scale, residual, splits, tiles_per_split);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_dc<float>(a, s);
  if (dtype == 1) return (int)launch_dc<__nv_bfloat16>(a, s);
  return (int)cudaErrorInvalidValue;
}

// The tensor-core route: bfloat16, 16-byte aligned tensors, strides and c
// multiples of 8, c <= 128. Scratch: delta (B*H*Lq floats: the dQ kernel
// writes D there for the dK/dV kernel) and, when splits > 1, dk_part and
// dv_part (splits*B*H*Lk*c floats each, 8-byte aligned). The dK/dV kernel
// cuts the q axis into `splits` runs of `tiles_per_split` 64-row tiles,
// splits * tiles_per_split >= ceil(Lq / 64).
extern "C" int pvt_pooled_attention_bwd_tc(const void* q, const void* k, const void* v,
                                           const void* o, const void* g, const float* lse,
                                           float* delta, float* dk_part, float* dv_part,
                                           void* dq, void* dk, void* dv, int64_t B, int64_t H,
                                           int64_t Lq, int64_t Lk, int64_t c,
                                           const int64_t* strides, float scale, int residual,
                                           int64_t splits, int64_t tiles_per_split,
                                           void* stream) {
  if (B * H == 0) return (int)cudaSuccess;
  const BwdArgs a = make_args(q, k, v, o, g, lse, delta, dk_part, dv_part, dq, dk, dv, B, H, Lq,
                              Lk, c, strides, scale, residual, splits, tiles_per_split);
  const int64_t q_tiles = (Lq + tc::kBN - 1) / tc::kBN;
  const bool parts_ok = splits == 1 || (reinterpret_cast<uintptr_t>(dk_part) % 8 == 0 &&
                                        reinterpret_cast<uintptr_t>(dv_part) % 8 == 0);
  if (!vector_ready(a) || !parts_ok || B * H > 65535 || splits < 1 || splits > 65535 ||
      splits * tiles_per_split < q_tiles || (Lq + tc::kDqRows - 1) / tc::kDqRows > 0x7fffffff) {
    return (int)cudaErrorInvalidValue;
  }
  return (int)tc::launch_dc(a, static_cast<cudaStream_t>(stream));
}

// The split-key route: as the tensor-core route, Lq <= 8; the keys cut into
// `splits` runs of `per_split` (the last may be shorter, none empty).
// dq_part: a 16-byte aligned float32 buffer of B * H * splits * Lq * c.
extern "C" int pvt_pooled_attention_bwd_split(const void* q, const void* k, const void* v,
                                              const void* o, const void* g, const float* lse,
                                              float* dq_part, void* dq, void* dk, void* dv,
                                              int64_t B, int64_t H, int64_t Lq, int64_t Lk,
                                              int64_t c, const int64_t* strides, float scale,
                                              int residual, int64_t splits, int64_t per_split,
                                              void* stream) {
  if (B * H == 0) return (int)cudaSuccess;
  const BwdArgs a = make_args(q, k, v, o, g, lse, nullptr, nullptr, nullptr, dq, dk, dv, B, H, Lq,
                              Lk, c, strides, scale, residual, splits, per_split);
  if (!vector_ready(a) || Lq > split::kMaxRows || splits < 1 || per_split < 1 ||
      splits * per_split < Lk || (splits - 1) * per_split >= Lk ||
      reinterpret_cast<uintptr_t>(dq_part) % 16 != 0 ||
      (B * H * splits + split::kGroups - 1) / split::kGroups > 0x7fffffff) {
    return (int)cudaErrorInvalidValue;
  }
  return (int)split::launch(split::SplitBwdArgs{a, dq_part, splits, per_split},
                            static_cast<cudaStream_t>(stream));
}
