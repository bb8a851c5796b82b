// Token pooling of a channels-last (B, T, H, W, C) grid: depthwise conv, max
// or average, any stride, padding k // 2 on each axis, for sm_90a (H100).
//
// Replaces the TPU kernel pytorchvideo_tpu/ops/token_pool.py
// `_pool_pallas_call` (body `_pool_kernel`), behind
// `depthwise_token_pool_pallas`, `max_token_pool_pallas` and `_avg_pool_ad`:
// MViT's q/k/v pools and the residual (skip) max pool.
//
//   conv: out[b,t,h,w,c] = sum_taps x[b, t*st+dt-pt, h*sh+dy-ph, w*sw+dx-pw, c]
//                                  * wt[c % Cw, dt, dy, dx]       (zero padding)
//   max:  max over the taps inside the input (-inf padding, MaxPool3d)
//   avg:  sum over the taps inside the input / (kt*kh*kw)  (count_include_pad)
//
// A tap that falls in the padding contributes nothing, as in the TPU kernel
// (token_pool.py:133-141). x and out are contiguous; x is the (B, L, C) token
// tensor of a model seen as its (B, T, H, W, C) grid, so no copy is made.
// wt is the depthwise conv weight in PyTorch's layout (Cw, 1, kt, kh, kw),
// i.e. (Cw, kt*kh*kw); C is a multiple of Cw and channel c uses row c % Cw,
// which is how MViT's head-packed tokens (C = heads * head_dim) share one
// per-head weight without tiling it. Accumulation is in f32; x, wt and out
// share one type (f32 or bf16).
//
// What bounds it on this card: memory. MViT-B's pools move the unpooled grid
// in and the pooled grid out (block 1's q pool at B32 bf16: 385 MB, 0.115 ms
// at 3.35 TB/s) and do at most 27 FMAs per output.
//
// Two routes, chosen by the caller before the launch (`pool_route`):
//
// `scalar` (`token_pool_kernel`, the first version, any geometry): one
// thread per output element, channel fastest, so a warp reads 32
// neighbouring channels of each tap; each input element is re-read by up to
// 27 outputs through L1/L2, with runtime tap loops and 64-bit offsets.
//
// `tiled` (`token_pool_kernel_tiled`; f32 and bf16 with 16-byte rows and
// pointers, the kernel sizes it instantiates): a block owns one batch
// element, a tile of output rows x columns and a 64-channel slice
// (pool_tiles.cuh), and walks the T2 output planes in order, the loop that
// replaces the TPU's sequential (B, T_out) grid. Its input planes sit in a
// ring of shared memory (kt + depth planes at st = 1, so each plane is
// copied once per tile; two sets of kt otherwise), and the planes of the
// next `depth` output planes are copied by 16-byte cp.async while the
// current one is computed. The slots' offsets in a plane are tabled once
// per tile, so a copy costs no division.
// Only the rows and columns some tap reads are copied: at MViT's kv strides
// (1, 8, 8) and (1, 4, 4) the k rows of each window, compacted. The taps are
// template parameters, so their loops unroll; the weight slice sits in
// registers, read once per block. Each thread owns two channels of two
// adjacent outputs along W, and at unit slot step (W stride 1) reads their
// kw + 1 columns once. Offsets inside a plane are 32-bit, from blockIdx and
// the plan; no division is 64-bit. Max leaves padded taps out by their
// coordinates (a zero-filled slot would win over negative inputs); conv and
// avg read the zero fill, so their tap loops have no branch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "pool_tiles.cuh"

namespace {

constexpr int kThreads = 256;
enum Mode { kConv = 0, kMax = 1, kAvg = 2 };

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

struct Geometry {
  int64_t B, T, H, W, C;     // input grid
  int64_t T2, H2, W2;        // output grid
  int kt, kh, kw;            // kernel
  int st, sh, sw;            // stride
  int pt, ph, pw;            // padding (k // 2)
  int64_t Cw;                // weight rows (conv)
};

template <typename T, int kMode>
__global__ void __launch_bounds__(kThreads)
    token_pool_kernel(const T* __restrict__ x, const T* __restrict__ wt, T* __restrict__ out,
                      Geometry g) {
  const int64_t idx = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= g.B * g.T2 * g.H2 * g.W2 * g.C) return;
  const int64_t c = idx % g.C;
  int64_t r = idx / g.C;
  const int64_t wo = r % g.W2;
  r /= g.W2;
  const int64_t ho = r % g.H2;
  r /= g.H2;
  const int64_t to = r % g.T2;
  const int64_t b = r / g.T2;

  const int taps = g.kt * g.kh * g.kw;
  const T* wrow = kMode == kConv ? wt + (c % g.Cw) * taps : nullptr;
  const T* xb = x + b * g.T * g.H * g.W * g.C + c;
  float acc = kMode == kMax ? -INFINITY : 0.0f;
  for (int dt = 0; dt < g.kt; ++dt) {
    const int64_t ti = to * g.st + dt - g.pt;
    if (ti < 0 || ti >= g.T) continue;
    for (int dy = 0; dy < g.kh; ++dy) {
      const int64_t hi = ho * g.sh + dy - g.ph;
      if (hi < 0 || hi >= g.H) continue;
      const T* row = xb + (ti * g.H + hi) * g.W * g.C;
      for (int dx = 0; dx < g.kw; ++dx) {
        const int64_t wi = wo * g.sw + dx - g.pw;
        if (wi < 0 || wi >= g.W) continue;
        const float v = to_f32(row[wi * g.C]);
        if (kMode == kConv) {
          acc = fmaf(v, to_f32(wrow[(dt * g.kh + dy) * g.kw + dx]), acc);
        } else if (kMode == kMax) {
          acc = fmaxf(acc, v);
        } else {
          acc += v;
        }
      }
    }
  }
  if (kMode == kAvg) acc *= 1.0f / (float)taps;
  out[idx] = from_f32<T>(acc);
}

template <typename T>
cudaError_t launch(const void* x, const void* wt, void* out, const Geometry& g, int mode,
                   cudaStream_t stream) {
  const int64_t blocks = (g.B * g.T2 * g.H2 * g.W2 * g.C + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;  // grid.x limit
  const dim3 grid((unsigned)blocks);
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(wt);
  T* op = static_cast<T*>(out);
  if (mode == kConv) {
    token_pool_kernel<T, kConv><<<grid, kThreads, 0, stream>>>(xp, wp, op, g);
  } else if (mode == kMax) {
    token_pool_kernel<T, kMax><<<grid, kThreads, 0, stream>>>(xp, wp, op, g);
  } else if (mode == kAvg) {
    token_pool_kernel<T, kAvg><<<grid, kThreads, 0, stream>>>(xp, wp, op, g);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// mode: 0 = conv (wt (Cw, kt*kh*kw), C % Cw == 0), 1 = max, 2 = avg (wt
// unused, may be null). dtype: 0 = float32, 1 = bfloat16. Padding is k // 2
// on each axis; the output grid (T2, H2, W2) is passed in by the caller.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int pvt_token_pool(const void* x, const void* wt, void* out, int64_t B, int64_t T,
                              int64_t H, int64_t W, int64_t C, int64_t T2, int64_t H2,
                              int64_t W2, int kt, int kh, int kw, int st, int sh, int sw,
                              int64_t Cw, int mode, int dtype, void* stream) {
  if (B * T2 * H2 * W2 * C == 0) return (int)cudaSuccess;
  if (mode == kConv && (Cw <= 0 || C % Cw != 0)) return (int)cudaErrorInvalidValue;
  const Geometry g{B, T, H, W, C, T2, H2, W2, kt, kh, kw, st, sh, sw, kt / 2, kh / 2, kw / 2,
                   Cw};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(x, wt, out, g, mode, s);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(x, wt, out, g, mode, s);
  return (int)cudaErrorInvalidValue;
}

namespace {
namespace pool {

template <typename T, int KT, int KH, int KW, int kMode, bool kUnitW>
__global__ void __launch_bounds__(kThreads, 2)
    token_pool_kernel_tiled(const T* __restrict__ x, const T* __restrict__ wt,
                            T* __restrict__ out, Plan p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int ys[kMaxSlots], xs[kMaxSlots];
  const T* smem = reinterpret_cast<const T*>(smem_raw);
  constexpr int PT = KT / 2, PH = KH / 2, PW = KW / 2;
  constexpr int kTaps = KT * KH * KW;

  int idx = blockIdx.x;
  const int tw_i = idx % p.tiles_w;
  idx /= p.tiles_w;
  const int th_i = idx % p.tiles_h;
  idx /= p.tiles_h;
  const int b = idx % p.B, slice = idx / p.B;
  const int oh0 = th_i * p.tile_h, ow0 = tw_i * p.tile_w;
  const int nh = min(p.tile_h, p.H2 - oh0), nw = min(p.tile_w, p.W2 - ow0);
  const int ch0 = slice * kSlice;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int c = ch0 + 2 * lane;
  const bool active = c < p.C;

  const Axis ry{oh0 * p.sh - PH, p.row_step, p.sh, (nh - 1) * p.row_step + KH, p.H};
  const Axis rx{ow0 * p.sw - PW, p.col_step, p.sw, (nw - 1) * p.col_step + KW, p.W};
  fill_axis(ys, ry, p.W);
  fill_axis(xs, rx, 1);
  const Slots slots = make_slots<T>(ys, ry.n, xs, rx.n);
  const int plane_elems = p.rows * p.cols * kSlice;
  const uint32_t smem_base = hopper::smem_addr(smem_raw);
  const int HWC = p.H * p.W * p.C;
  const T* xb = x + (int64_t)b * p.T * HWC;

  // The two channels' weight rows, once per block.
  float2 w[kMode == kConv ? kTaps : 1];
  if (kMode == kConv) {
    const int r0 = active ? c % p.Cw : 0, r1 = active ? (c + 1) % p.Cw : 0;
#pragma unroll
    for (int t = 0; t < kTaps; ++t) {
      w[t] = make_float2(to_f32(wt[r0 * kTaps + t]), to_f32(wt[r1 * kTaps + t]));
    }
  }

  // Copies the planes output plane t2 reads and the ring does not hold yet.
  auto issue = [&](int t2) {
#pragma unroll
    for (int dt = 0; dt < KT; ++dt) {
      if (p.st == 1 && t2 > 0 && dt < KT - 1) continue;
      const int ti = t2 * p.st + dt - PT;
      if (ti < 0 || ti >= p.T) continue;
      load_plane(smem_base + fwd_slot<KT>(p, t2, dt) * plane_elems * (int)sizeof(T),
                 xb + (int64_t)ti * HWC, p.C, slots, p.cols, ch0);
    }
    hopper::cp_async_commit();
  };

  const float init = kMode == kMax ? -INFINITY : 0.0f;
  const int npairs = (nw + 1) / 2, items = nh * npairs;
  const uint32_t pairs_magic = div_magic(npairs);
  __syncthreads();  // the slot tables
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
    T* ob = out + (((int64_t)b * p.T2 + t2) * p.H2 + oh0) * p.W2 * p.C + c;
    for (int it = warp; it < items && active; it += kWarps) {
      const int oy = fast_div(it, pairs_magic), ox = (it - oy * npairs) * 2;
      const bool two = ox + 1 < nw;
      // Straight-line taps, so a row's loads issue together: conv and avg
      // read the padding's zero fill; without a second output its loads
      // repeat the first's columns, and its sums are dropped.
      const int ox1 = two ? ox + 1 : ox;
      float2 a0 = make_float2(init, init), a1 = a0;
#pragma unroll
      for (int dt = 0; dt < KT; ++dt) {
        const int ti = t2 * p.st + dt - PT;
        if (ti < 0 || ti >= p.T) continue;
        const T* plane = smem + fwd_slot<KT>(p, t2, dt) * plane_elems + 2 * lane;
#pragma unroll
        for (int dy = 0; dy < KH; ++dy) {
          if (kMode == kMax) {
            const int y = (oh0 + oy) * p.sh - PH + dy;
            if (y < 0 || y >= p.H) continue;
          }
          const T* row = plane + (oy * p.row_step + dy) * p.cols * kSlice;
          if (kUnitW) {
            // Slot step 1: the two outputs read slots ox .. ox + kw.
            float2 v[KW + 1];
#pragma unroll
            for (int j = 0; j <= KW; ++j) {
              v[j] = load2(row + (j < KW ? ox + j : ox1 + KW - 1) * kSlice);
              if (kMode == kMax) {
                const int xx = rx.base + (j < KW ? ox + j : ox1 + KW - 1) * p.sw;
                if (xx < 0 || xx >= p.W) v[j] = make_float2(-INFINITY, -INFINITY);
              }
            }
#pragma unroll
            for (int d = 0; d < KW; ++d) {
              if (kMode == kConv) {
                const float2 wv = w[(dt * KH + dy) * KW + d];
                a0.x = fmaf(v[d].x, wv.x, a0.x);
                a0.y = fmaf(v[d].y, wv.y, a0.y);
                a1.x = fmaf(v[d + 1].x, wv.x, a1.x);
                a1.y = fmaf(v[d + 1].y, wv.y, a1.y);
              } else if (kMode == kMax) {
                a0.x = fmaxf(a0.x, v[d].x);
                a0.y = fmaxf(a0.y, v[d].y);
                a1.x = fmaxf(a1.x, v[d + 1].x);
                a1.y = fmaxf(a1.y, v[d + 1].y);
              } else {
                a0.x += v[d].x;
                a0.y += v[d].y;
                a1.x += v[d + 1].x;
                a1.y += v[d + 1].y;
              }
            }
          } else {
            float2 v[2][KW];
#pragma unroll
            for (int o = 0; o < 2; ++o) {
              const int col = o == 0 ? ox : ox1;
#pragma unroll
              for (int d = 0; d < KW; ++d) {
                v[o][d] = load2(row + (col * p.col_step + d) * kSlice);
                if (kMode == kMax) {
                  const int xx = (ow0 + col) * p.sw - PW + d;
                  if (xx < 0 || xx >= p.W) v[o][d] = make_float2(-INFINITY, -INFINITY);
                }
              }
            }
#pragma unroll
            for (int d = 0; d < KW; ++d) {
              if (kMode == kConv) {
                const float2 wv = w[(dt * KH + dy) * KW + d];
                a0.x = fmaf(v[0][d].x, wv.x, a0.x);
                a0.y = fmaf(v[0][d].y, wv.y, a0.y);
                a1.x = fmaf(v[1][d].x, wv.x, a1.x);
                a1.y = fmaf(v[1][d].y, wv.y, a1.y);
              } else if (kMode == kMax) {
                a0.x = fmaxf(a0.x, v[0][d].x);
                a0.y = fmaxf(a0.y, v[0][d].y);
                a1.x = fmaxf(a1.x, v[1][d].x);
                a1.y = fmaxf(a1.y, v[1][d].y);
              } else {
                a0.x += v[0][d].x;
                a0.y += v[0][d].y;
                a1.x += v[1][d].x;
                a1.y += v[1][d].y;
              }
            }
          }
        }
      }
      if (kMode == kAvg) {
        const float inv = 1.0f / (float)kTaps;
        a0.x *= inv;
        a0.y *= inv;
        a1.x *= inv;
        a1.y *= inv;
      }
      T* o = ob + (oy * p.W2 + ow0 + ox) * p.C;
      store2(o, a0);
      if (two) store2(o + p.C, a1);
    }
    __syncthreads();
  }
}

template <typename T, int KT, int KH, int KW, int kMode>
cudaError_t launch_tiled_mode(const void* x, const void* wt, void* out, const Plan& p,
                              cudaStream_t stream) {
  static int limit[2][64];
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(wt);
  T* op = static_cast<T*>(out);
  const bool unit = p.col_step == 1;
  cudaError_t err =
      unit ? allow_smem(token_pool_kernel_tiled<T, KT, KH, KW, kMode, true>, p.smem_bytes,
                        limit[1])
           : allow_smem(token_pool_kernel_tiled<T, KT, KH, KW, kMode, false>, p.smem_bytes,
                        limit[0]);
  if (err != cudaSuccess) return err;
  if (unit) {
    token_pool_kernel_tiled<T, KT, KH, KW, kMode, true>
        <<<p.blocks, kThreads, p.smem_bytes, stream>>>(xp, wp, op, p);
  } else {
    token_pool_kernel_tiled<T, KT, KH, KW, kMode, false>
        <<<p.blocks, kThreads, p.smem_bytes, stream>>>(xp, wp, op, p);
  }
  return cudaGetLastError();
}

template <typename T, int KT, int KH, int KW>
cudaError_t launch_tiled_kernel(const void* x, const void* wt, void* out, const Plan& p, int mode,
                                cudaStream_t stream) {
  if (mode == kConv) return launch_tiled_mode<T, KT, KH, KW, kConv>(x, wt, out, p, stream);
  if (mode == kMax) return launch_tiled_mode<T, KT, KH, KW, kMax>(x, wt, out, p, stream);
  if (mode == kAvg) return launch_tiled_mode<T, KT, KH, KW, kAvg>(x, wt, out, p, stream);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_tiled(const void* x, const void* wt, void* out, const Plan& p, int kt, int kh,
                         int kw, int mode, cudaStream_t stream) {
  if (kt == 3 && kh == 3 && kw == 3) {
    return launch_tiled_kernel<T, 3, 3, 3>(x, wt, out, p, mode, stream);
  }
  if (kt == 1 && kh == 3 && kw == 3) {
    return launch_tiled_kernel<T, 1, 3, 3>(x, wt, out, p, mode, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace pool
}  // namespace

// The `tiled` route: the same function as pvt_token_pool for kernel sizes
// (3, 3, 3) and (1, 3, 3), float32 or bfloat16 (dtype 0, 1), C *
// sizeof(dtype) a multiple of 16 and x, out 16-byte aligned. `args` holds
// the geometry (B, T, H, W, C, T2, H2, W2, kt, kh, kw, st, sh, sw, Cw, mode,
// dtype) and then pool_tile_plan's 14 ints (tile_h, tile_w, tiles_h,
// tiles_w, slices, rows, cols, row_step, col_step, ring, depth, groups,
// blocks, smem_bytes). Returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int pvt_token_pool_tiled(const void* x, const void* wt, void* out, const int* args,
                                    void* stream) {
  const pool::Call call = pool::make_call(args);
  const pool::Plan& p = call.p;
  const int B = p.B, H = p.H, W = p.W, C = p.C, T2 = p.T2, H2 = p.H2, W2 = p.W2, Cw = p.Cw;
  const int kt = call.kt, kh = call.kh, kw = call.kw, st = p.st, sh = p.sh, sw = p.sw;
  const int mode = call.mode, dtype = call.dtype;
  if ((int64_t)B * T2 * H2 * W2 * C == 0) return (int)cudaSuccess;
  const int row_step = sh < kh ? sh : kh, col_step = sw < kw ? sw : kw;
  if (!pool::plan_ok(p) || (int64_t)H * W * C > 0x7fffffff || p.tiles_h * p.tile_h < H2 ||
      p.tiles_w * p.tile_w < W2 || p.row_step != row_step || p.col_step != col_step ||
      p.rows != (p.tile_h - 1) * row_step + kh || p.cols != (p.tile_w - 1) * col_step + kw ||
      p.ring != (st == 1 ? kt + p.depth : 2 * kt) ||
      (int64_t)p.blocks != (int64_t)B * p.slices * p.tiles_h * p.tiles_w ||
      (mode == pool::kConv && (Cw <= 0 || C % Cw != 0))) {
    return (int)cudaErrorInvalidValue;
  }
  const int elem = dtype == 0 ? 4 : 2;
  if ((int64_t)p.ring * p.rows * p.cols * pool::kSlice * elem > p.smem_bytes) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)pool::launch_tiled<float>(x, wt, out, p, kt, kh, kw, mode, s);
  if (dtype == 1) return (int)pool::launch_tiled<__nv_bfloat16>(x, wt, out, p, kt, kh, kw, mode, s);
  return (int)cudaErrorInvalidValue;
}
