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
// k and v go through one launch (blockIdx.z picks the tensor; blockIdx.y in
// the tiled kernel). grid is the UNPOOLED (B, T*H*W, HC) output of the k or
// v projection, read in place as its (B, T, H, W, HC) grid; out is a
// (B, cls + T2*H2*W2, HC) buffer whose row 0 holds the cls row, so the
// attention kernel reads it whole and the pooled grid is the view
// out[:, cls:], with no concatenation. The pooled sum
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
// 16x4 block 0 at B32 bf16 reads 20 MB of each of its 154 MB k and v grids;
// the 16 pool-LN launches of a B32 forward move 2.2 GB, 0.668 ms at 3.35 TB/s.
//
// Two routes, chosen by the caller before the launch (`pool_ln_route`):
//
// `scalar` (`kvpool_ln_kernel`, the first version, any head width <= 128):
// one warp per (tensor, batch row, pooled row, head). Lane l holds channels
// l, l + 32, ... of the head (at most four), so for each tap the warp reads
// the head's c contiguous channels in 2-byte or 4-byte scalars, accumulates
// in registers, and reduces the head's mean and variance (two passes, as
// the JAX kernel) by shuffles. Each of the 27 taps re-reads its input row
// through L1/L2 and the tap weights from device memory, with 64-bit index
// arithmetic: at stride 1, where 27 outputs read each input, it sits at
// ~30x its byte bound.
//
// `tiled` (`kvpool_ln_tiled`; f32 and bf16, head width c of 32, 64, 96 or
// 128, 16-byte aligned grids, kernel (3, 3, 3) at T stride 1) runs on the
// token pool's tiled machinery (pool_tiles.cuh) with a slice one head wide:
// a block owns (tensor, batch row, tile of H2 x W2 outputs, head) and walks
// T2 with a ring of 3 + depth planes in shared memory, each plane's slots
// (only the rows and columns some tap reads) copied by 16-byte cp.async
// `depth` planes ahead, so each input row comes from device memory about
// once and the 27 taps read shared memory. Lane l holds the channel pairs
// (2l, 2l + 1) and (64 + 2l, 65 + 2l) of the head where they are < c, as a
// bf16x2 or a float2, read from a slot without bank conflicts. The head's
// 27 taps (column ch % Cw) sit behind the ring as f32, filled once a block
// by all its threads; the LayerNorm's scale and shift sit in registers. A
// warp computes two adjacent output positions along W at a time (at W
// stride 1 from the 4 columns they read in each of the 9 (dt, dy) rows),
// sums in f32, and their LayerNorm is the walk's epilogue: means and
// variances by shuffles, then pairs stored to the output rows. Offsets
// inside a plane are 32-bit; the padding is the copies' zero fill, so the
// tap loops have no bounds branch. The blocks of tile 0 copy the cls row of
// their head.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "pool_tiles.cuh"

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

namespace {
namespace pool {

// Bytes of the head's taps behind the ring: (27, c) floats.
constexpr int ln_taps_bytes(int c) { return 27 * c * 4; }

// Three bf16 blocks an SM (80 registers a thread) hide more of each plane's
// copy latency than two; the f32 kernel needs up to 128 registers, so two.
template <typename T, int kWidth, bool kUnitW>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 2 ? 3 : 2)
    kvpool_ln_tiled(Args a, Plan p) {
  constexpr int kHalves = (kWidth / 2 + 31) / 32;  // channel pairs of a lane: 1 or 2
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int ys[kMaxSlots], xs[kMaxSlots];
  const T* smem = reinterpret_cast<const T*>(smem_raw);

  int idx = blockIdx.x;
  const int tw_i = idx % p.tiles_w;
  idx /= p.tiles_w;
  const int th_i = idx % p.tiles_h;
  idx /= p.tiles_h;
  const int b = idx % p.B, head = idx / p.B;
  const Operand o = blockIdx.y == 0 ? a.op[0] : a.op[1];
  const int oh0 = th_i * p.tile_h, ow0 = tw_i * p.tile_w;
  const int nh = min(p.tile_h, p.H2 - oh0), nw = min(p.tile_w, p.W2 - ow0);
  const int ch0 = head * kWidth;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int rows_out = a.has_cls + p.T2 * p.H2 * p.W2;
  T* const out_b = static_cast<T*>(o.out) + (int64_t)b * rows_out * p.C + ch0;

  // Slot j of a tile axis holds coordinate first * s - 1 + (j / step) * s + j % step.
  const Axis ry{oh0 * p.sh - 1, p.row_step, p.sh, (nh - 1) * p.row_step + 3, p.H};
  const Axis rx{ow0 * p.sw - 1, p.col_step, p.sw, (nw - 1) * p.col_step + 3, p.W};
  fill_axis(ys, ry, p.W);
  fill_axis(xs, rx, 1);
  const Slots slots = make_slots<T, 16, kWidth>(ys, ry.n, xs, rx.n);
  const int plane_elems = p.rows * p.cols * kWidth;
  const uint32_t smem_base = hopper::smem_addr(smem_raw);
  const int HWC = p.H * p.W * p.C;
  const T* xb = static_cast<const T*>(o.grid) + (int64_t)b * p.T * HWC;

  // The head's taps (column ch % Cw) as f32 behind the ring, once per block;
  // the lane's LayerNorm scale and shift in registers.
  float* const wsm = reinterpret_cast<float*>(smem_raw + p.ring * plane_elems * (int)sizeof(T));
  const T* taps = static_cast<const T*>(o.taps);
  for (int i = threadIdx.x; i < 27 * kWidth; i += kThreads) {
    const int t = i / kWidth, d = i - t * kWidth;
    wsm[i] = to_f32(taps[t * p.Cw + (ch0 + d) % p.Cw]);
  }
  const T* ln = static_cast<const T*>(o.ln);
  bool has[kHalves];
  float2 gain[kHalves], shift[kHalves];
#pragma unroll
  for (int j = 0; j < kHalves; ++j) {
    const int d = 2 * lane + 64 * j;
    has[j] = d < kWidth;
    const int c0 = has[j] ? (ch0 + d) % p.Cw : 0, c1 = has[j] ? (ch0 + d + 1) % p.Cw : 0;
    gain[j] = make_float2(to_f32(ln[c0]), to_f32(ln[c1]));
    shift[j] = make_float2(to_f32(ln[p.Cw + c0]), to_f32(ln[p.Cw + c1]));
  }

  // The already-normed cls row, by the first warp of tile 0.
  if (a.has_cls && th_i == 0 && tw_i == 0 && warp == 0) {
    const T* cls = static_cast<const T*>(o.cls) + (int64_t)b * p.C + ch0;
    for (int d = lane; d < kWidth; d += 32) out_b[d] = cls[d];
  }

  // Copies the planes output plane t2 reads and the ring does not hold yet:
  // t2 - 1, t2 and t2 + 1 at t2 = 0, then only t2 + 1 (T stride 1).
  auto issue = [&](int t2) {
#pragma unroll
    for (int dt = 0; dt < 3; ++dt) {
      if (t2 > 0 && dt < 2) continue;
      const int ti = t2 + dt - 1;
      if (ti < 0 || ti >= p.T) continue;
      load_plane<T, 16, kWidth>(smem_base + fwd_slot<3>(p, t2, dt) * plane_elems * (int)sizeof(T),
                                xb + (int64_t)ti * HWC, p.C, slots, p.cols, ch0);
    }
    hopper::cp_async_commit();
  };

  const int npairs = (nw + 1) / 2, items = nh * npairs;
  const uint32_t pairs_magic = div_magic(npairs);
  const float inv_c = 1.0f / (float)kWidth;
  __syncthreads();  // the slot tables and the taps
  for (int j = 0; j < p.depth; ++j) {
    if (j < p.T2) {
      issue(j);
    } else {
      hopper::cp_async_commit();
    }
  }
  for (int t2 = 0; t2 < p.T2; ++t2) {
    if (t2 + p.depth < p.T2) {
      issue(t2 + p.depth);
    } else {
      hopper::cp_async_commit();
    }
    wait_pending(p.depth);
    __syncthreads();
    // Two adjacent output positions along W per warp and pass (without a
    // second, its loads repeat the first's columns and its sums are
    // dropped); the loop's bound is the same on every lane, so the
    // shuffles below see all 32.
    for (int it = warp; it < items; it += kWarps) {
      const int oy = fast_div(it, pairs_magic), ox = (it - oy * npairs) * 2;
      const bool two = ox + 1 < nw;
      const int ox1 = two ? ox + 1 : ox;
      float2 a0[kHalves], a1[kHalves];
#pragma unroll
      for (int j = 0; j < kHalves; ++j) a0[j] = a1[j] = make_float2(0.0f, 0.0f);
#pragma unroll
      for (int dt = 0; dt < 3; ++dt) {
        const int ti = t2 + dt - 1;
        if (ti < 0 || ti >= p.T) continue;
        const T* plane = smem + fwd_slot<3>(p, t2, dt) * plane_elems + 2 * lane;
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          const T* row = plane + (oy * p.row_step + dy) * p.cols * kWidth;
          const float* wrow = wsm + (dt * 3 + dy) * 3 * kWidth + 2 * lane;
#pragma unroll
          for (int j = 0; j < kHalves; ++j) {
            if (!has[j]) continue;
            float2 v[2][3];
            if (kUnitW) {
              // Slot step 1: the two outputs read slots ox .. ox + 3.
              float2 u[4];
#pragma unroll
              for (int c = 0; c < 4; ++c) u[c] = load2(row + (c < 3 ? ox + c : ox1 + 2) * kWidth + 64 * j);
#pragma unroll
              for (int dx = 0; dx < 3; ++dx) {
                v[0][dx] = u[dx];
                v[1][dx] = u[dx + 1];
              }
            } else {
#pragma unroll
              for (int dx = 0; dx < 3; ++dx) {
                v[0][dx] = load2(row + (ox * p.col_step + dx) * kWidth + 64 * j);
                v[1][dx] = load2(row + (ox1 * p.col_step + dx) * kWidth + 64 * j);
              }
            }
#pragma unroll
            for (int dx = 0; dx < 3; ++dx) {
              const float2 wv = *reinterpret_cast<const float2*>(wrow + dx * kWidth + 64 * j);
              a0[j].x = fmaf(v[0][dx].x, wv.x, a0[j].x);
              a0[j].y = fmaf(v[0][dx].y, wv.y, a0[j].y);
              a1[j].x = fmaf(v[1][dx].x, wv.x, a1[j].x);
              a1[j].y = fmaf(v[1][dx].y, wv.y, a1[j].y);
            }
          }
        }
      }
      // Each output's LayerNorm over the head in f32: mean, then the mean of
      // squared deviations.
      float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
      for (int j = 0; j < kHalves; ++j) {
        if (has[j]) {
          s0 += a0[j].x + a0[j].y;
          s1 += a1[j].x + a1[j].y;
        }
      }
      const float mean0 = warp_sum(s0) * inv_c, mean1 = warp_sum(s1) * inv_c;
      float q0 = 0.0f, q1 = 0.0f;
#pragma unroll
      for (int j = 0; j < kHalves; ++j) {
        if (has[j]) {
          const float x0 = a0[j].x - mean0, y0 = a0[j].y - mean0;
          const float x1 = a1[j].x - mean1, y1 = a1[j].y - mean1;
          q0 += x0 * x0 + y0 * y0;
          q1 += x1 * x1 + y1 * y1;
        }
      }
      const float rstd0 = rsqrtf(warp_sum(q0) * inv_c + a.eps);
      const float rstd1 = rsqrtf(warp_sum(q1) * inv_c + a.eps);
      T* dst = out_b + ((int64_t)a.has_cls + (t2 * p.H2 + oh0 + oy) * p.W2 + ow0 + ox) * p.C +
               2 * lane;
#pragma unroll
      for (int j = 0; j < kHalves; ++j) {
        if (has[j]) {
          store2(dst + 64 * j,
                 make_float2((a0[j].x - mean0) * rstd0 * gain[j].x + shift[j].x,
                             (a0[j].y - mean0) * rstd0 * gain[j].y + shift[j].y));
          if (two) {
            store2(dst + p.C + 64 * j,
                   make_float2((a1[j].x - mean1) * rstd1 * gain[j].x + shift[j].x,
                               (a1[j].y - mean1) * rstd1 * gain[j].y + shift[j].y));
          }
        }
      }
    }
    __syncthreads();
  }
}

template <typename T, int kWidth, bool kUnitW>
cudaError_t launch_ln_tiled(const Args& a, const Plan& p, cudaStream_t stream) {
  static int limit[64];
  const auto kernel = kvpool_ln_tiled<T, kWidth, kUnitW>;
  const cudaError_t err = allow_smem(kernel, p.smem_bytes, limit);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((unsigned)p.blocks, 2), kThreads, p.smem_bytes, stream>>>(a, p);
  return cudaGetLastError();
}

// At W stride 1 a warp's two outputs share two of their three columns, so
// they take four shared loads a row, not six: MViT-B's stride-1 launches at
// B32 in bf16 ran 9-10% faster so on an H100 (PERF.md section 6).
template <typename T, int kWidth>
cudaError_t launch_ln_step(const Args& a, const Plan& p, cudaStream_t stream) {
  return p.col_step == 1 ? launch_ln_tiled<T, kWidth, true>(a, p, stream)
                         : launch_ln_tiled<T, kWidth, false>(a, p, stream);
}

template <typename T>
cudaError_t launch_ln_width(const Args& a, const Plan& p, int c, cudaStream_t stream) {
  switch (c) {
    case 32: return launch_ln_step<T, 32>(a, p, stream);
    case 64: return launch_ln_step<T, 64>(a, p, stream);
    case 96: return launch_ln_step<T, 96>(a, p, stream);
    case 128: return launch_ln_step<T, 128>(a, p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace pool
}  // namespace

// The `tiled` route: the same function as pvt_fused_kvpool_ln for float32 or
// bfloat16 (dtype 0, 1) at kernel (3, 3, 3), T stride 1 and a head width c
// of 32, 64, 96 or 128, with k_grid and v_grid 16-byte aligned. `args` is
// the token pool's tiled call (pool_tiles.cuh `Call`): the geometry (B, T, H,
// W, HC, T2, H2, W2, kt, kh, kw, st, sh, sw, Cw, mode 0, dtype), then
// pool_ln_tile_plan's 14 ints, whose `slices` are the heads and whose
// shared memory holds the ring and the head's (27, c) f32 taps. Returns
// cudaGetLastError() after the launch (0 on success), cudaErrorInvalidValue
// for a call the route does not take.
extern "C" int pvt_fused_kvpool_ln_tiled(const void* k_grid, const void* v_grid,
                                         const void* k_taps, const void* v_taps, const void* k_ln,
                                         const void* v_ln, const void* k_cls, const void* v_cls,
                                         void* k_out, void* v_out, const int* args, float eps,
                                         void* stream) {
  const pool::Call call = pool::make_call(args);
  const pool::Plan& p = call.p;
  if ((int64_t)p.B * p.T2 * p.H2 * p.W2 * p.C == 0) return (int)cudaSuccess;
  const int heads = p.slices, c = heads > 0 ? p.C / heads : 0;
  const int elem = call.dtype == 0 ? 4 : 2;
  const int row_step = p.sh < 3 ? p.sh : 3, col_step = p.sw < 3 ? p.sw : 3;
  if (!pool::plan_ok(p, c) || call.kt != 3 || call.kh != 3 || call.kw != 3 ||
      call.mode != pool::kConv || (call.dtype != 0 && call.dtype != 1) || p.st != 1 ||
      p.T2 != p.T || p.H2 != (p.H - 1) / p.sh + 1 || p.W2 != (p.W - 1) / p.sw + 1 ||
      heads * c != p.C || (c != 32 && c != 64 && c != 96 && c != 128) || p.Cw < 1 ||
      p.C % p.Cw != 0 || (int64_t)p.H * p.W * p.C > 0x7fffffff ||
      (int64_t)p.T2 * p.H2 * p.W2 > 0x7fffffff / p.C || p.tiles_h * p.tile_h < p.H2 ||
      p.tiles_w * p.tile_w < p.W2 || p.row_step != row_step || p.col_step != col_step ||
      p.rows != (p.tile_h - 1) * row_step + 3 || p.cols != (p.tile_w - 1) * col_step + 3 ||
      p.ring != 3 + p.depth ||
      (int64_t)p.blocks != (int64_t)p.B * heads * p.tiles_h * p.tiles_w ||
      (int64_t)p.ring * p.rows * p.cols * c * elem + pool::ln_taps_bytes(c) > p.smem_bytes ||
      (k_cls == nullptr) != (v_cls == nullptr) || reinterpret_cast<uintptr_t>(k_grid) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(v_grid) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const Args a{{{k_grid, k_taps, k_ln, k_cls, k_out}, {v_grid, v_taps, v_ln, v_cls, v_out}},
               p.T, p.H, p.W, p.C, p.T2, p.H2, p.W2, p.Cw, 3, 3, 3, 1, p.sh, p.sw,
               heads, c, k_cls != nullptr ? 1 : 0, eps};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (call.dtype == 0) return (int)pool::launch_ln_width<float>(a, p, c, s);
  return (int)pool::launch_ln_width<__nv_bfloat16>(a, p, c, s);
}
