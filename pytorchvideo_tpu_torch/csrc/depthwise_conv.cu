// Fused depthwise 3x3x3 conv + per-channel scale/bias + optional swish, for
// sm_90a (H100).
//
// Replaces the TPU kernel pytorchvideo_tpu/ops/depthwise_conv.py
// `depthwise3x3x3_bn_swish_pallas` (body `_kernel`): X3D's stride-1 conv_b
// with the folded-BN epilogue, computed in one pass over device memory.
//
//   out[b,t,h,w,c] = act(scale[c] * sum_{dt,dy,dx} x[b,t+dt-1,h+dy-1,w+dx-1,c]
//                                           * w[dt,dy,dx,c] + bias[c])
//
// Layout: x and out are contiguous (B, T, H, W, C); w is (3, 3, 3, C); zero
// padding of 1 on T, H and W (bounds-checked, no padded copy). Accumulation
// and the epilogue are in f32; the output has the input's type (f32 or bf16).
//
// What bounds it on this card: memory, with arithmetic close behind. Per
// X3D-S bf16 forward at B128 (22 launches) the op reads its input and writes
// its output once: 1.245 ms at 3.35 TB/s. Its 27 FMAs per output cannot
// reach the tensor cores (each channel has its own taps), and on the CUDA
// cores' ~67 TFLOP/s of f32 they take ~0.84 ms. So each input has to come
// from device memory once, and each output may cost few instructions beyond
// its FMAs.
//
// Two routes, chosen by the caller before the launch (`depthwise_route`):
//
// `scalar` (`depthwise3x3x3_kernel`, the first version, any C): one thread
// per (b, t, h, strip of kStrip outputs along W, c), channel fastest, so
// neighbouring threads read neighbouring channels. The 27 taps sit in
// registers; along W a window of three (dt, dy) columns is kept in
// registers, so each output loads 9 new inputs; reuse across t and h comes
// only from L1/L2, with 2-byte loads and 64-bit index math.
//
// `tiled` (`depthwise3x3x3_tiled`; f32 and bf16, C even, x and out aligned
// to the copy width) runs on the token pool's machinery (pool_tiles.cuh):
// a block owns one batch element, a tile of H x W (pool_tile_plan's, at
// kernel (3, 3, 3) and stride 1) and a 64-channel slice, and walks T with a
// ring of 3 + depth planes in shared memory, so each input plane of the
// tile is copied from device memory once, `depth` planes ahead of the one
// computed, by cp.async. The copy is as wide as a position's row allows:
// the largest of 16, 8 and 4 bytes that divides C * sizeof(T) (bf16: 4 at
// C = 54, 8 at 108, 16 at 216 and 432), a template parameter of the copy and
// the slot map. Lane l holds channels 2l and 2l + 1 with their 27 taps in
// registers; a thread computes two adjacent outputs along W from the 4
// columns they read in each of the 9 (dt, dy) rows (36 shared loads for 108
// FMAs), and the epilogue (scale, bias, swish, in f32) writes a bf16x2 or
// float2. The padding is the copies' zero fill, so the tap loops have no
// branch; offsets inside a plane are 32-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "pool_tiles.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kStrip = 8;

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

// Loads input column ww of the nine (dt, dy) rows; zero outside the input.
template <typename T>
__device__ __forceinline__ void load_column(float (&col)[3][3], const T* (&rows)[3][3],
                                            int64_t ww, int64_t W, int64_t C) {
  const bool inside = ww >= 0 && ww < W;
#pragma unroll
  for (int dt = 0; dt < 3; ++dt) {
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      col[dt][dy] = (inside && rows[dt][dy] != nullptr) ? to_f32(rows[dt][dy][ww * C]) : 0.0f;
    }
  }
}

template <typename T, bool kSwish>
__global__ void __launch_bounds__(kThreads)
    depthwise3x3x3_kernel(const T* __restrict__ x, const T* __restrict__ w,
                          const T* __restrict__ scale, const T* __restrict__ bias,
                          T* __restrict__ out, int64_t B, int64_t Tn, int64_t H,
                          int64_t W, int64_t C, int64_t n_strips) {
  const int64_t idx = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= B * Tn * H * n_strips * C) return;
  const int64_t c = idx % C;
  int64_t r = idx / C;
  const int64_t strip = r % n_strips;
  r /= n_strips;
  const int64_t h = r % H;
  r /= H;
  const int64_t t = r % Tn;
  const int64_t b = r / Tn;

  float taps[3][3][3];  // [dt][dy][dx]
#pragma unroll
  for (int k = 0; k < 27; ++k) taps[k / 9][(k / 3) % 3][k % 3] = to_f32(w[k * C + c]);
  const float s = scale != nullptr ? to_f32(scale[c]) : 1.0f;
  const float o = bias != nullptr ? to_f32(bias[c]) : 0.0f;

  // Start of the (t+dt-1, h+dy-1) input row at channel c; nullptr where the
  // row lies in the zero padding.
  const T* rows[3][3];
#pragma unroll
  for (int dt = 0; dt < 3; ++dt) {
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      const int64_t tt = t + dt - 1, hh = h + dy - 1;
      const bool inside = tt >= 0 && tt < Tn && hh >= 0 && hh < H;
      rows[dt][dy] = inside ? x + ((b * Tn + tt) * H + hh) * W * C + c : nullptr;
    }
  }

  float win[3][3][3];  // [column][dt][dy]: input columns wo - 1, wo, wo + 1
  const int64_t w_begin = strip * kStrip;
  const int64_t w_end = w_begin + kStrip < W ? w_begin + kStrip : W;
  load_column(win[0], rows, w_begin - 1, W, C);
  load_column(win[1], rows, w_begin, W, C);
  T* dst = out + ((b * Tn + t) * H + h) * W * C + c;
  for (int64_t wo = w_begin; wo < w_end; ++wo) {
    load_column(win[2], rows, wo + 1, W, C);
    float acc = 0.0f;
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
#pragma unroll
      for (int dt = 0; dt < 3; ++dt) {
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) acc = fmaf(win[dx][dt][dy], taps[dt][dy][dx], acc);
      }
    }
    float y = fmaf(acc, s, o);
    if (kSwish) y = y / (1.0f + expf(-y));
    dst[wo * C] = from_f32<T>(y);
#pragma unroll
    for (int dt = 0; dt < 3; ++dt) {
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        win[0][dt][dy] = win[1][dt][dy];
        win[1][dt][dy] = win[2][dt][dy];
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const void* scale, const void* bias, void* out,
                   int64_t B, int64_t Tn, int64_t H, int64_t W, int64_t C, int apply_swish,
                   cudaStream_t stream) {
  const int64_t n_strips = (W + kStrip - 1) / kStrip;
  const int64_t blocks = (B * Tn * H * n_strips * C + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;  // grid.x limit
  const dim3 grid((unsigned)blocks);
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  const T* sp = static_cast<const T*>(scale);
  const T* bp = static_cast<const T*>(bias);
  T* op = static_cast<T*>(out);
  if (apply_swish) {
    depthwise3x3x3_kernel<T, true><<<grid, kThreads, 0, stream>>>(xp, wp, sp, bp, op, B, Tn, H,
                                                                   W, C, n_strips);
  } else {
    depthwise3x3x3_kernel<T, false><<<grid, kThreads, 0, stream>>>(xp, wp, sp, bp, op, B, Tn,
                                                                    H, W, C, n_strips);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. scale and bias may be null (1 and 0).
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int pvt_depthwise3x3x3_bn_swish(const void* x, const void* w, const void* scale,
                                           const void* bias, void* out, int64_t B, int64_t T,
                                           int64_t H, int64_t W, int64_t C, int dtype,
                                           int apply_swish, void* stream) {
  if (B * T * H * W * C == 0) return (int)cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(x, w, scale, bias, out, B, T, H, W, C, apply_swish, s);
  if (dtype == 1) {
    return (int)launch<__nv_bfloat16>(x, w, scale, bias, out, B, T, H, W, C, apply_swish, s);
  }
  return (int)cudaErrorInvalidValue;
}

namespace {
namespace pool {

template <typename T, int kBytes, bool kSwish>
__global__ void __launch_bounds__(kThreads, 2)
    depthwise3x3x3_tiled(const T* __restrict__ x, const T* __restrict__ w,
                         const T* __restrict__ scale, const T* __restrict__ bias,
                         T* __restrict__ out, Plan p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int ys[kMaxSlots], xs[kMaxSlots];
  const T* smem = reinterpret_cast<const T*>(smem_raw);

  int idx = blockIdx.x;
  const int tw_i = idx % p.tiles_w;
  idx /= p.tiles_w;
  const int th_i = idx % p.tiles_h;
  idx /= p.tiles_h;
  const int b = idx % p.B, slice = idx / p.B;
  const int oh0 = th_i * p.tile_h, ow0 = tw_i * p.tile_w;
  const int nh = min(p.tile_h, p.H - oh0), nw = min(p.tile_w, p.W - ow0);
  const int ch0 = slice * kSlice;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int c = ch0 + 2 * lane;
  const bool active = c < p.C;

  // Slot j of a tile axis holds coordinate first - 1 + j (stride 1, pad 1).
  const Axis ry{oh0 - 1, 1, 1, nh + 2, p.H};
  const Axis rx{ow0 - 1, 1, 1, nw + 2, p.W};
  fill_axis(ys, ry, p.W);
  fill_axis(xs, rx, 1);
  const Slots slots = make_slots<T, kBytes>(ys, ry.n, xs, rx.n);
  const int plane_elems = p.rows * p.cols * kSlice;
  const uint32_t smem_base = hopper::smem_addr(smem_raw);
  const int HWC = p.H * p.W * p.C;
  const T* xb = x + (int64_t)b * p.T * HWC;

  // The two channels' taps (w is (3, 3, 3, C)) and epilogue, once per block.
  float2 taps[27];
  float2 s = make_float2(1.0f, 1.0f), o = make_float2(0.0f, 0.0f);
  if (active) {
#pragma unroll
    for (int t = 0; t < 27; ++t) {
      taps[t] = make_float2(to_f32(w[t * p.C + c]), to_f32(w[t * p.C + c + 1]));
    }
    if (scale != nullptr) s = make_float2(to_f32(scale[c]), to_f32(scale[c + 1]));
    if (bias != nullptr) o = make_float2(to_f32(bias[c]), to_f32(bias[c + 1]));
  }

  // Copies the planes output plane t reads and the ring does not hold yet:
  // t - 1, t and t + 1 at t = 0, then only t + 1.
  auto issue = [&](int t) {
#pragma unroll
    for (int dt = 0; dt < 3; ++dt) {
      if (t > 0 && dt < 2) continue;
      const int ti = t + dt - 1;
      if (ti < 0 || ti >= p.T) continue;
      load_plane<T, kBytes>(smem_base + fwd_slot<3>(p, t, dt) * plane_elems * (int)sizeof(T),
                            xb + (int64_t)ti * HWC, p.C, slots, p.cols, ch0);
    }
    hopper::cp_async_commit();
  };

  const int npairs = (nw + 1) / 2, items = nh * npairs;
  const uint32_t pairs_magic = div_magic(npairs);
  __syncthreads();  // the slot tables
  for (int j = 0; j < p.depth; ++j) {
    if (j < p.T) {
      issue(j);
    } else {
      hopper::cp_async_commit();
    }
  }
  for (int t = 0; t < p.T; ++t) {
    if (t + p.depth < p.T) {
      issue(t + p.depth);
    } else {
      hopper::cp_async_commit();
    }
    wait_pending(p.depth);
    __syncthreads();
    T* ob = out + (((int64_t)b * p.T + t) * p.H + oh0) * p.W * p.C + c;
    for (int it = warp; it < items && active; it += kWarps) {
      const int oy = fast_div(it, pairs_magic), ox = (it - oy * npairs) * 2;
      const bool two = ox + 1 < nw;
      // Without a second output the fourth column repeats the third, and
      // its sums are dropped.
      const int last = two ? ox + 3 : ox + 2;
      float2 a0 = make_float2(0.0f, 0.0f), a1 = a0;
#pragma unroll
      for (int dt = 0; dt < 3; ++dt) {
        const int ti = t + dt - 1;
        if (ti < 0 || ti >= p.T) continue;
        const T* plane = smem + fwd_slot<3>(p, t, dt) * plane_elems + 2 * lane;
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          const T* row = plane + (oy + dy) * p.cols * kSlice;
          float2 v[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) v[j] = load2(row + (j < 3 ? ox + j : last) * kSlice);
#pragma unroll
          for (int d = 0; d < 3; ++d) {
            const float2 wv = taps[(dt * 3 + dy) * 3 + d];
            a0.x = fmaf(v[d].x, wv.x, a0.x);
            a0.y = fmaf(v[d].y, wv.y, a0.y);
            a1.x = fmaf(v[d + 1].x, wv.x, a1.x);
            a1.y = fmaf(v[d + 1].y, wv.y, a1.y);
          }
        }
      }
      a0 = make_float2(fmaf(a0.x, s.x, o.x), fmaf(a0.y, s.y, o.y));
      a1 = make_float2(fmaf(a1.x, s.x, o.x), fmaf(a1.y, s.y, o.y));
      if (kSwish) {
        a0 = make_float2(a0.x / (1.0f + expf(-a0.x)), a0.y / (1.0f + expf(-a0.y)));
        a1 = make_float2(a1.x / (1.0f + expf(-a1.x)), a1.y / (1.0f + expf(-a1.y)));
      }
      T* dst = ob + (oy * p.W + ow0 + ox) * p.C;
      store2(dst, a0);
      if (two) store2(dst + p.C, a1);
    }
    __syncthreads();
  }
}

template <typename T, int kBytes, bool kSwish>
cudaError_t launch_tiled(const void* x, const void* w, const void* scale, const void* bias,
                         void* out, const Plan& p, cudaStream_t stream) {
  static int limit[64];
  const auto kernel = depthwise3x3x3_tiled<T, kBytes, kSwish>;
  const cudaError_t err = allow_smem(kernel, p.smem_bytes, limit);
  if (err != cudaSuccess) return err;
  kernel<<<p.blocks, kThreads, p.smem_bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(scale),
      static_cast<const T*>(bias), static_cast<T*>(out), p);
  return cudaGetLastError();
}

template <typename T, int kBytes>
cudaError_t launch_tiled_width(const void* x, const void* w, const void* scale, const void* bias,
                               void* out, const Plan& p, int apply_swish, cudaStream_t stream) {
  return apply_swish ? launch_tiled<T, kBytes, true>(x, w, scale, bias, out, p, stream)
                     : launch_tiled<T, kBytes, false>(x, w, scale, bias, out, p, stream);
}

}  // namespace pool
}  // namespace

// The `tiled` route: the same function as pvt_depthwise3x3x3_bn_swish for
// float32 or bfloat16 (dtype 0, 1) with C even. `args` is the token pool's
// tiled call (pool_tiles.cuh `Call`): the geometry (B, T, H, W, C, T2, H2,
// W2, kt, kh, kw, st, sh, sw, Cw, mode, dtype) at kernel (3, 3, 3), stride
// 1 and mode 0, then pool_tile_plan's 14 ints. The copy width is the
// largest of 16, 8 and 4 bytes that divides C * sizeof(dtype); x and out
// must be aligned to it. Returns cudaGetLastError() after the launch (0 on
// success), cudaErrorInvalidValue for a call the route does not take.
extern "C" int pvt_depthwise3x3x3_tiled(const void* x, const void* w, const void* scale,
                                        const void* bias, void* out, const int* args,
                                        int apply_swish, void* stream) {
  const pool::Call call = pool::make_call(args);
  const pool::Plan& p = call.p;
  if ((int64_t)p.B * p.T * p.H * p.W * p.C == 0) return (int)cudaSuccess;
  const int elem = call.dtype == 0 ? 4 : 2;
  const int row = p.C * elem;
  const int width = row % 16 == 0 ? 16 : row % 8 == 0 ? 8 : row % 4 == 0 ? 4 : 0;
  if (!pool::plan_ok(p) || call.kt != 3 || call.kh != 3 || call.kw != 3 ||
      call.mode != pool::kConv || (call.dtype != 0 && call.dtype != 1) || p.st != 1 ||
      p.sh != 1 || p.sw != 1 || p.T2 != p.T || p.H2 != p.H || p.W2 != p.W ||
      (int64_t)p.H * p.W * p.C > 0x7fffffff || p.tiles_h * p.tile_h < p.H ||
      p.tiles_w * p.tile_w < p.W || p.row_step != 1 || p.col_step != 1 ||
      p.rows != p.tile_h + 2 || p.cols != p.tile_w + 2 || p.ring != 3 + p.depth ||
      (int64_t)p.blocks != (int64_t)p.B * p.slices * p.tiles_h * p.tiles_w ||
      (int64_t)p.ring * p.rows * p.cols * pool::kSlice * elem > p.smem_bytes || width == 0 ||
      (width == 4 && elem == 4) || reinterpret_cast<uintptr_t>(x) % width != 0 ||
      reinterpret_cast<uintptr_t>(out) % width != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (call.dtype == 0) {
    return (int)(width == 16
                     ? pool::launch_tiled_width<float, 16>(x, w, scale, bias, out, p, apply_swish, s)
                     : pool::launch_tiled_width<float, 8>(x, w, scale, bias, out, p, apply_swish, s));
  }
  using bf16 = __nv_bfloat16;
  if (width == 16) {
    return (int)pool::launch_tiled_width<bf16, 16>(x, w, scale, bias, out, p, apply_swish, s);
  }
  if (width == 8) {
    return (int)pool::launch_tiled_width<bf16, 8>(x, w, scale, bias, out, p, apply_swish, s);
  }
  return (int)pool::launch_tiled_width<bf16, 4>(x, w, scale, bias, out, p, apply_swish, s);
}
