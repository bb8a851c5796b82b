// Fused kv-pool + per-head LayerNorm of MViT's keys and values, for sm_90a (H100).
//
// Replaces the pool phase of the TPU kernel
// pytorchvideo_tpu/ops/fused_kvpool_attention.py `_fused_local` (body
// `_fused_kernel`, pool phase `_pool_ln_plane`). Its attention phase is the
// port's kernel of csrc/pooled_attention.cu, which the wrapper
// (ops/fused_kvpool_attention.py) launches next on the same stream over this
// kernel's output, for the grid queries and for the cls query (Lq = 1).
//
//   pooled[b, r, ch] = sum_taps grid[b, t*st+dt-pt, h*sh+dy-ph, w*sw+dx-pw, ch]
//                                 * taps[tap, ch % Cw]                 (zero padding)
//   out[b, cls + r, head*c + d] = LayerNorm over d of pooled[b, r, head*c + d]
//                                 * ln[0, ch % Cw] + ln[1, ch % Cw]
//   out[b, 0, :] = cls[b, 0, :]   (the already-normed cls row, when given)
//
// k and v go through one launch (blockIdx.z picks the tensor). grid is the
// UNPOOLED (B, T*H*W, HC) output of the k or v projection, read in place as
// its (B, T, H, W, HC) grid; out is a (B, cls + T2*H2*W2, HC) buffer whose
// row 0 holds the cls row, so the attention kernel reads it whole and the
// pooled grid is the view out[:, cls:], with no concatenation. The pooled sum
// and the LayerNorm stay in f32 (as `_pool_ln_plane` does); the output is
// rounded once to the input type. taps (kt*kh*kw, Cw) and ln (2, Cw) serve
// channel ch from column ch % Cw: Cw = HC is the JAX package's head-tiled
// layout, Cw = c the per-head parameters that every head shares.
//
// Why two launches and not one: the TPU kernel's grid runs in order, so its
// pool steps leave the pooled planes in VMEM scratch for its attention
// steps. Blocks on the GPU run in no order; one launch would need a
// grid-wide barrier. The handover goes through memory instead: the pooled k
// and v of one batch row are at most 1569 x 768 x 2 B (2.4 MB) per tensor in
// MViT-B, so at small batch they stay in the 50 MB L2. The TPU kernel's W
// padding to a multiple of 8, its masked key columns and its 0/1 segment
// matmuls for the per-head sums came from Mosaic's layout rules and are not
// carried over: nothing is padded here, and a head's sums are warp shuffles.
//
// What bounds it on this card: memory. Each output reads the taps some
// output needs (at stride (1, 8, 8) 20 of 56 rows and columns) and writes
// itself; per output 2 x 27 FMAs plus the LayerNorm's ~8 operations. MViT-B
// 16x4 block 0 at B32 bf16 reads 20 MB of each of its 154 MB k and v grids.
//
// Design (first version, simple and correct): one warp per (tensor, batch
// row, pooled row, head). Lane l holds channels l, l + 32, ... of the head
// (c <= 128: at most four), so for each tap the warp reads the head's c
// contiguous channels (coalesced), accumulates in registers, and reduces the
// head's mean and variance (two passes, as the JAX kernel) by shuffles.
// Nothing goes through shared memory, so no size of the grid or of the
// pooled grid limits it; re-reads of an input row by neighbouring outputs are
// served by L1/L2. Vector loads, cp.async and a single-launch design are
// left for later versions.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxPerLane = 4;  // head_dim <= 128

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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

struct Operand {        // k or v
  const void* grid;     // (B, T*H*W, HC) unpooled
  const void* taps;     // (kt*kh*kw, Cw)
  const void* ln;       // (2, Cw): LayerNorm scale, then shift
  const void* cls;      // (B, 1, HC) normed cls row, or null
  void* out;            // (B, has_cls + T2*H2*W2, HC)
};

struct Args {
  Operand op[2];
  int64_t T, H, W, HC, T2, H2, W2, Cw;
  int kt, kh, kw, st, sh, sw;
  int heads, c, has_cls;
  float eps;
};

template <typename T>
__global__ void __launch_bounds__(kThreads) kvpool_ln_kernel(Args a) {
  const int lane = threadIdx.x & 31;
  const int64_t rows = a.has_cls + a.T2 * a.H2 * a.W2;
  // One warp per (row, head); the index is the same on every lane, so a warp
  // leaves or stays as a whole and the shuffles below see all 32 lanes.
  const int64_t item = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (item >= rows * a.heads) return;
  const int64_t row = item / a.heads;
  const int head = (int)(item % a.heads);
  const int64_t b = blockIdx.y;
  const Operand o = blockIdx.z == 0 ? a.op[0] : a.op[1];
  T* out = static_cast<T*>(o.out) + (b * rows + row) * a.HC + head * a.c;

  if (row < a.has_cls) {
    const T* cls = static_cast<const T*>(o.cls) + b * a.HC + head * a.c;
    for (int d = lane; d < a.c; d += 32) out[d] = cls[d];
    return;
  }

  const int64_t r = row - a.has_cls;
  const int64_t wo = r % a.W2, ho = (r / a.W2) % a.H2, to = r / (a.W2 * a.H2);
  const T* grid = static_cast<const T*>(o.grid) + b * a.T * a.H * a.W * a.HC + head * a.c;
  const T* taps = static_cast<const T*>(o.taps);
  int64_t col[kMaxPerLane];  // column of taps and ln: channel % Cw
  float acc[kMaxPerLane];
#pragma unroll
  for (int j = 0; j < kMaxPerLane; ++j) {
    col[j] = (head * a.c + lane + 32 * j) % a.Cw;
    acc[j] = 0.0f;
  }
  for (int dt = 0; dt < a.kt; ++dt) {
    const int64_t ti = to * a.st + dt - a.kt / 2;
    if (ti < 0 || ti >= a.T) continue;
    for (int dy = 0; dy < a.kh; ++dy) {
      const int64_t hi = ho * a.sh + dy - a.kh / 2;
      if (hi < 0 || hi >= a.H) continue;
      for (int dx = 0; dx < a.kw; ++dx) {
        const int64_t wi = wo * a.sw + dx - a.kw / 2;
        if (wi < 0 || wi >= a.W) continue;
        const T* src = grid + ((ti * a.H + hi) * a.W + wi) * a.HC;
        const T* w = taps + ((dt * a.kh + dy) * a.kw + dx) * a.Cw;
#pragma unroll
        for (int j = 0; j < kMaxPerLane; ++j) {
          const int d = lane + 32 * j;
          if (d < a.c) acc[j] = fmaf(to_f32(src[d]), to_f32(w[col[j]]), acc[j]);
        }
      }
    }
  }

  // Per-head LayerNorm in f32: mean, then the mean of squared deviations.
  float sum = 0.0f;
#pragma unroll
  for (int j = 0; j < kMaxPerLane; ++j) {
    if (lane + 32 * j < a.c) sum += acc[j];
  }
  const float mean = warp_sum(sum) / (float)a.c;
  float sq = 0.0f;
#pragma unroll
  for (int j = 0; j < kMaxPerLane; ++j) {
    if (lane + 32 * j < a.c) {
      const float x = acc[j] - mean;
      sq += x * x;
    }
  }
  const float rstd = rsqrtf(warp_sum(sq) / (float)a.c + a.eps);
  const T* ln = static_cast<const T*>(o.ln);
#pragma unroll
  for (int j = 0; j < kMaxPerLane; ++j) {
    const int d = lane + 32 * j;
    if (d < a.c) {
      const float y = (acc[j] - mean) * rstd * to_f32(ln[col[j]]) + to_f32(ln[a.Cw + col[j]]);
      out[d] = from_f32<T>(y);
    }
  }
}

template <typename T>
cudaError_t launch(const Args& a, cudaStream_t stream, int64_t B) {
  const int64_t rows = a.has_cls + a.T2 * a.H2 * a.W2;
  const int64_t blocks = (rows * a.heads + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffff || B > 65535) return cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)blocks, (unsigned)B, 2);
  kvpool_ln_kernel<T><<<grid, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// k_grid, v_grid: (B, T*H*W, HC) contiguous; k_taps, v_taps: (kt*kh*kw, Cw);
// k_ln, v_ln: (2, Cw); k_cls, v_cls: (B, 1, HC) normed cls rows, both null or
// both given; k_out, v_out: (B, has_cls + T2*H2*W2, HC). HC % Cw == 0 and
// HC = heads * c with c <= 128; padding k // 2 on each axis; the pooled grid
// (T2, H2, W2) is passed in by the caller. dtype: 0 = float32, 1 = bfloat16,
// for every tensor. Returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int pvt_fused_kvpool_ln(const void* k_grid, const void* v_grid, const void* k_taps,
                                   const void* v_taps, const void* k_ln, const void* v_ln,
                                   const void* k_cls, const void* v_cls, void* k_out, void* v_out,
                                   int64_t B, int64_t T, int64_t H, int64_t W, int64_t HC,
                                   int64_t T2, int64_t H2, int64_t W2, int kt, int kh, int kw,
                                   int st, int sh, int sw, int64_t Cw, int heads, float eps,
                                   int dtype, void* stream) {
  if (B * T2 * H2 * W2 * HC == 0) return (int)cudaSuccess;
  if (heads < 1 || HC % heads != 0 || HC / heads > 32 * kMaxPerLane || Cw < 1 || HC % Cw != 0 ||
      (k_cls == nullptr) != (v_cls == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const int has_cls = k_cls != nullptr ? 1 : 0;
  const Args a{{{k_grid, k_taps, k_ln, k_cls, k_out}, {v_grid, v_taps, v_ln, v_cls, v_out}},
               T, H, W, HC, T2, H2, W2, Cw, kt, kh, kw, st, sh, sw,
               heads, (int)(HC / heads), has_cls, eps};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(a, s, B);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(a, s, B);
  return (int)cudaErrorInvalidValue;
}
