// Backward of the depthwise conv token pool (csrc/token_pool.cu, conv mode)
// for sm_90a (H100): the input gradient dx and the weight gradient dw.
//
// Replaces the TPU kernel pytorchvideo_tpu/ops/token_pool.py `_dw_kernel`
// (behind `_weight_grad_pallas_local`) and the forward-kernel reuse of
// `_input_grad_pallas`, the two halves of `_token_pool_bwd`.
//
// Forward: out[b,t2,h2,w2,c] = sum_taps x[b, t2*st+dt-pt, h2*sh+dy-ph,
// w2*sw+dx-pw, c] * wt[c % Cw, tap], zero padding (pt, ph, pw) = k // 2.
//
// dx (`token_pool_dx_kernel`): one thread per input element, channel fastest
// (coalesced), in gather form: dx[b,t,h,w,c] = sum over the taps whose output
// position ((t + pt - dt) / st, ...) is whole and inside the output grid of
// g[that position, c] * wt[c % Cw, tap]. The TPU version dilates g by the
// stride and runs the forward kernel with flipped taps; at MViT's kv stride
// (1, 8, 8) that dilated tensor is 64x the size of g, so it is not copied.
//
// dw (`token_pool_dw_partial_kernel` + `token_pool_dw_reduce_kernel`):
// dw[r, tap] = sum over (b, t2, h2, w2) and over the channels c = r (mod Cw)
// of x[tap window] * g. The TPU kernel accumulates one (taps, C) block across
// a sequential (B, T_out) grid. Here the output positions are cut into
// chunks; a block of 32 channels x 8 tap lanes walks one chunk, each thread
// summing up to 10 taps of one channel in registers, and writes f32
// partials (chunks, taps, C). The reduce kernel then sums, in a fixed order
// (deterministic, no atomics), the chunks and the heads that share each
// per-head weight row: the port's weight is (Cw, 1, kt, kh, kw) and every
// head of a head-packed grid (C = heads * Cw) uses it through row c % Cw, so
// the heads are reduced here, where the JAX package tiles a weight copy and
// lets autograd sum it.
//
// Arithmetic is f32; dx and dw are rounded once to the input type.
//
// What bounds it on this card: memory. dx reads g and writes dx once (plus
// the weight); dw reads x's tap windows and g; both do at most 75 FMAs per
// element. Vector loads and shared-memory tiles are left for later versions.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kDwChannels = 32;  // channels per dw block (threadIdx.x % 32)
constexpr int kDwLanes = 8;      // tap lanes per dw block (threadIdx.x / 32)
constexpr int kDwTaps = 10;      // taps per thread: 8 * 10 >= 75 = 3 * 5 * 5

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
  int64_t B, T, H, W, C;  // input grid
  int64_t T2, H2, W2;     // output grid
  int kt, kh, kw;         // kernel
  int st, sh, sw;         // stride
  int pt, ph, pw;         // padding (k // 2)
  int64_t Cw;             // weight rows
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    token_pool_dx_kernel(const T* __restrict__ g, const T* __restrict__ wt, T* __restrict__ dx,
                         Geometry gm) {
  const int64_t idx = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= gm.B * gm.T * gm.H * gm.W * gm.C) return;
  // One 64-bit division; the grid positions fit in 32 bits (checked by the
  // entry point), and so does every division below.
  const int64_t pos = idx / gm.C;
  const int64_t c = idx - pos * gm.C;
  int r = (int)pos;
  const int wi = r % (int)gm.W;
  r /= (int)gm.W;
  const int hi = r % (int)gm.H;
  r /= (int)gm.H;
  const int ti = r % (int)gm.T;
  const int64_t b = r / (int)gm.T;

  // Along each axis, the taps d through which this position reaches a whole
  // output position o = (i + p - d) / s are d = (i + p) % s, then every s-th
  // tap on, while d <= i + p; o must also fall inside the output grid.
  const int ip_t = ti + gm.pt, ip_h = hi + gm.ph, ip_w = wi + gm.pw;
  const int h0 = ip_h % gm.sh, w0 = ip_w % gm.sw;
  const T* wrow = wt + (c % gm.Cw) * (gm.kt * gm.kh * gm.kw);
  const T* gb = g + b * gm.T2 * gm.H2 * gm.W2 * gm.C + c;
  float acc = 0.0f;
  for (int dt = ip_t % gm.st; dt < gm.kt && dt <= ip_t; dt += gm.st) {
    const int to = (ip_t - dt) / gm.st;
    if (to >= gm.T2) continue;
    for (int dy = h0; dy < gm.kh && dy <= ip_h; dy += gm.sh) {
      const int ho = (ip_h - dy) / gm.sh;
      if (ho >= gm.H2) continue;
      const T* grow = gb + ((int64_t)to * gm.H2 + ho) * gm.W2 * gm.C;
      const T* wtap = wrow + (dt * gm.kh + dy) * gm.kw;
      for (int dxx = w0; dxx < gm.kw && dxx <= ip_w; dxx += gm.sw) {
        const int wo = (ip_w - dxx) / gm.sw;
        if (wo >= gm.W2) continue;
        acc = fmaf(to_f32(grow[(int64_t)wo * gm.C]), to_f32(wtap[dxx]), acc);
      }
    }
  }
  dx[idx] = from_f32<T>(acc);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    token_pool_dw_partial_kernel(const T* __restrict__ x, const T* __restrict__ g,
                                 float* __restrict__ part, Geometry gm,
                                 int64_t positions_per_chunk) {
  const int lane_c = threadIdx.x % kDwChannels, lane_t = threadIdx.x / kDwChannels;
  const int64_t c = (int64_t)blockIdx.y * kDwChannels + lane_c;
  const int64_t chunk = blockIdx.x;
  const int taps = gm.kt * gm.kh * gm.kw;
  if (c >= gm.C) return;

  // This thread's taps: lane_t + 8 * j.
  int tdt[kDwTaps], tdy[kDwTaps], tdx[kDwTaps];
  float acc[kDwTaps];
#pragma unroll
  for (int j = 0; j < kDwTaps; ++j) {
    const int tap = lane_t + kDwLanes * j;
    tdt[j] = tap / (gm.kh * gm.kw);
    tdy[j] = (tap / gm.kw) % gm.kh;
    tdx[j] = tap % gm.kw;
    acc[j] = 0.0f;
  }

  const int64_t positions = gm.B * gm.T2 * gm.H2 * gm.W2;
  const int64_t p0 = chunk * positions_per_chunk;
  const int64_t p1 = p0 + positions_per_chunk < positions ? p0 + positions_per_chunk : positions;
  // The chunk's first output position (b, to, ho, wo); the walk then steps
  // it on with carries, not divisions.
  int64_t r = p0;
  int64_t wo = r % gm.W2;
  r /= gm.W2;
  int64_t ho = r % gm.H2;
  r /= gm.H2;
  int64_t to = r % gm.T2;
  int64_t b = r / gm.T2;
  for (int64_t p = p0; p < p1; ++p) {
    const float gv = to_f32(g[p * gm.C + c]);
    const T* xb = x + b * gm.T * gm.H * gm.W * gm.C + c;
#pragma unroll
    for (int j = 0; j < kDwTaps; ++j) {
      if (lane_t + kDwLanes * j >= taps) continue;
      const int64_t ti = to * gm.st + tdt[j] - gm.pt;
      const int64_t hi = ho * gm.sh + tdy[j] - gm.ph;
      const int64_t wi = wo * gm.sw + tdx[j] - gm.pw;
      if (ti < 0 || ti >= gm.T || hi < 0 || hi >= gm.H || wi < 0 || wi >= gm.W) continue;
      acc[j] = fmaf(to_f32(xb[((ti * gm.H + hi) * gm.W + wi) * gm.C]), gv, acc[j]);
    }
    if (++wo == gm.W2) {
      wo = 0;
      if (++ho == gm.H2) {
        ho = 0;
        if (++to == gm.T2) {
          to = 0;
          ++b;
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kDwTaps; ++j) {
    const int tap = lane_t + kDwLanes * j;
    if (tap < taps) part[(chunk * taps + tap) * gm.C + c] = acc[j];
  }
}

// dw[r, tap] = sum over chunks and heads of part[chunk, tap, head * Cw + r];
// consecutive threads take consecutive r, so the reads are coalesced.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    token_pool_dw_reduce_kernel(const float* __restrict__ part, T* __restrict__ dw, int64_t chunks,
                                int taps, int64_t C, int64_t Cw) {
  const int64_t idx = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= Cw * taps) return;
  const int64_t r = idx % Cw, tap = idx / Cw;
  float acc = 0.0f;
  for (int64_t chunk = 0; chunk < chunks; ++chunk) {
    const float* row = part + (chunk * taps + tap) * C;
    for (int64_t c = r; c < C; c += Cw) acc += row[c];
  }
  dw[r * taps + tap] = from_f32<T>(acc);
}

Geometry make_geometry(int64_t B, int64_t T, int64_t H, int64_t W, int64_t C, int64_t T2,
                       int64_t H2, int64_t W2, int kt, int kh, int kw, int st, int sh, int sw,
                       int64_t Cw) {
  return Geometry{B, T, H, W, C, T2, H2, W2, kt, kh, kw, st, sh, sw, kt / 2, kh / 2, kw / 2, Cw};
}

bool valid(const Geometry& g) {
  return g.Cw > 0 && g.C % g.Cw == 0 && g.kt * g.kh * g.kw <= kDwLanes * kDwTaps && g.st > 0 &&
         g.sh > 0 && g.sw > 0;
}

template <typename T>
cudaError_t launch_dx(const void* g, const void* wt, void* dx, const Geometry& gm,
                      cudaStream_t stream) {
  const int64_t blocks = (gm.B * gm.T * gm.H * gm.W * gm.C + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  token_pool_dx_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(g), static_cast<const T*>(wt), static_cast<T*>(dx), gm);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dw(const void* x, const void* g, float* part, void* dw, const Geometry& gm,
                      int64_t chunks, int64_t positions_per_chunk, cudaStream_t stream) {
  const dim3 grid((unsigned)chunks, (unsigned)((gm.C + kDwChannels - 1) / kDwChannels));
  token_pool_dw_partial_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), part, gm, positions_per_chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int taps = gm.kt * gm.kh * gm.kw;
  token_pool_dw_reduce_kernel<T><<<(unsigned)((gm.Cw * taps + kThreads - 1) / kThreads),
                                    kThreads, 0, stream>>>(part, static_cast<T*>(dw), chunks,
                                                           taps, gm.C, gm.Cw);
  return cudaGetLastError();
}

}  // namespace

// dx (B, T, H, W, C) from g (B, T2, H2, W2, C) and wt (Cw, kt*kh*kw), C % Cw
// == 0, padding k // 2, all contiguous and of one type (dtype 0 = float32,
// 1 = bfloat16). Returns cudaGetLastError() after the launch (0 on success).
extern "C" int pvt_token_pool_dx(const void* g, const void* wt, void* dx, int64_t B, int64_t T,
                                 int64_t H, int64_t W, int64_t C, int64_t T2, int64_t H2,
                                 int64_t W2, int kt, int kh, int kw, int st, int sh, int sw,
                                 int64_t Cw, int dtype, void* stream) {
  if (B * T * H * W * C == 0) return (int)cudaSuccess;
  const Geometry gm = make_geometry(B, T, H, W, C, T2, H2, W2, kt, kh, kw, st, sh, sw, Cw);
  if (!valid(gm) || B * T * H * W > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_dx<float>(g, wt, dx, gm, s);
  if (dtype == 1) return (int)launch_dx<__nv_bfloat16>(g, wt, dx, gm, s);
  return (int)cudaErrorInvalidValue;
}

// dw (Cw, kt*kh*kw) from x (B, T, H, W, C) and g (B, T2, H2, W2, C), through
// the caller's f32 scratch `part` of chunks * kt*kh*kw * C floats, with
// chunks * positions_per_chunk >= B*T2*H2*W2. Same types and padding as
// above. Returns the first cudaGetLastError() after a launch (0 on success).
extern "C" int pvt_token_pool_dw(const void* x, const void* g, float* part, void* dw, int64_t B,
                                 int64_t T, int64_t H, int64_t W, int64_t C, int64_t T2,
                                 int64_t H2, int64_t W2, int kt, int kh, int kw, int st, int sh,
                                 int sw, int64_t Cw, int64_t chunks, int64_t positions_per_chunk,
                                 int dtype, void* stream) {
  const Geometry gm = make_geometry(B, T, H, W, C, T2, H2, W2, kt, kh, kw, st, sh, sw, Cw);
  if (!valid(gm) || chunks < 1 || chunks > 0x7fffffff || positions_per_chunk < 1 ||
      chunks * positions_per_chunk < B * T2 * H2 * W2 || (C + kDwChannels - 1) / kDwChannels > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_dw<float>(x, g, part, dw, gm, chunks, positions_per_chunk, s);
  if (dtype == 1) {
    return (int)launch_dw<__nv_bfloat16>(x, g, part, dw, gm, chunks, positions_per_chunk, s);
  }
  return (int)cudaErrorInvalidValue;
}
