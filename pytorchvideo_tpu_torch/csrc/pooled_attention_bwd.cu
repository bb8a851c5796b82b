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
// work is split as in FlashAttention-2, with no atomics (deterministic):
//
// 1. `attention_bwd_delta_kernel`: D per (b, head, q row), one warp per row.
// 2. `attention_bwd_dkdv_kernel`: one block per (64-key tile, b * head, q
//    split). It holds its K and V tiles in shared memory and walks its share
//    of the q tiles, recomputing p and ds per tile; dk and dv accumulate in
//    registers in f32 and are written once, as f32 partials of its q split.
// 3. `attention_bwd_dq_kernel`: one block per (64-row q tile, b * head); it
//    walks every key tile and accumulates dq in registers in f32.
// 4. `attention_bwd_reduce_kernel`: sums the q splits' partials in a fixed
//    order and writes dk and dv in k's layout and type. Splitting q lets a
//    short key axis (MViT-B block 0: Lk 393, one head) still fill the card's
//    132 SMs.
//
// Arithmetic is float32 throughout (inputs converted on load); dq, dk and dv
// are each rounded once to the input type. Keys past Lk and q rows past Lq
// get p = 0, so nothing is padded.
//
// What bounds it on this card: operations. The function needs five products
// of the forward's size (q k^T, g v^T, ds k, ds^T q, p^T g); this split does
// seven, as both kernels recompute q k^T and g v^T. This first version runs
// on the CUDA cores in f32 (67 TFLOP/s peak), far from the 989 TFLOP/s bf16
// tensor-core bound; mma/wgmma tiles are the next version.
//
// Work split (128 threads, 64 x 64 tiles): thread (ty, tx) = (tid / 16,
// tid % 16) owns tile rows 8*ty .. 8*ty + 7 (keys in the dk/dv kernel, q
// rows in the dq kernel), and tile columns tx + 16*j (j < 4) of a 64 x 64
// score tile, or head-dim columns tx + 16*j (j < DC/16) of an accumulator.
// Shared-memory rows are padded by one float, as in the forward.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

}  // namespace

// q, o, g, dq: (B, H, Lq, c) and k, v, dk, dv: (B, H, Lk, c) as seen through
// `strides`, 6 int64 (batch, head, row) strides in elements: the q-shaped
// tensors' then the k-shaped ones'; the c axis is contiguous. lse: the
// forward's (B, H, Lq) float32 row log-sum-exp. Scratch from the caller:
// delta (B*H*Lq floats) and dk_part, dv_part (splits*B*H*Lk*c floats each),
// with splits * tiles_per_split >= ceil(Lq / 64). c <= 128, Lq >= 1,
// Lk >= 1. dtype: 0 = float32, 1 = bfloat16. residual != 0: o = attn + q.
// Returns the first cudaGetLastError() after a launch (0 on success).
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
  BwdArgs a{q, k, v, o, g, lse, delta, dk_part, dv_part, dq, dk, dv, B, H, Lq, Lk, c,
            {}, {}, scale, residual, splits, tiles_per_split};
  for (int i = 0; i < 3; ++i) {
    a.sq[i] = strides[i];
    a.sk[i] = strides[3 + i];
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_dc<float>(a, s);
  if (dtype == 1) return (int)launch_dc<__nv_bfloat16>(a, s);
  return (int)cudaErrorInvalidValue;
}
