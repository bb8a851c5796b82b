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
// element.
//
// Those are the `scalar` route (the first version, any geometry). The
// `tiled` route (f32 and bf16 with 16-byte rows and pointers, kernel sizes
// (3, 3, 3) and (1, 3, 3); `pool_route` chooses before the launch) runs the
// forward's tiles (pool_tiles.cuh):
//
// dx (`token_pool_dx_tiled`), in gather form (the TPU's dilated g would be
// 64x the size of g at the (1, 8, 8) kv stride), cut into super-blocks:
// along an axis of stride s, input i = s * m - p + r (residue r < s) takes
// the taps d = r + s * j < k from g row o = m - j, so each residue r <
// step = min(s, k) has its own taps, fixed at compile time (the kernel is
// instantiated per row and column step), and a super-block m reads g rows
// m - J .. m, J = (k - 1) / step. A block owns one batch element, a tile of
// super-rows x super-columns and a 64-channel slice, and walks T with a ring
// of the g planes that reach it (copied by 16-byte cp.async, `depth` planes
// ahead); a warp takes two neighbouring super-blocks at a time and reads
// their (J + 1) x (J + 2) window of g once for all their residues. Inputs
// whose residue no tap reaches (r >= k: 86% of them at stride (1, 8, 8))
// read no g and are written as zeros with 16-byte stores.
//
// dw (`token_pool_dw_tiled`), one launch: a block owns a channel slice and a
// group of (batch element, output tile) units, and walks each unit's T2
// with the forward's ring of x planes plus a ring of depth + 1 g planes. Each
// thread owns two channels and every tap (54 f32 sums at (3, 3, 3)); the
// warps' sums meet in shared memory in warp order, and the block writes one
// f32 partial (taps x slice). The last block of a slice to finish (it reads
// a per-slice counter, and resets it) sums the slice's partials in group
// order; the last slice to finish sums the heads that share each weight row
// (c % Cw) and writes dw. Sums take no atomics, so dw is the same bits from
// call to call; the counters, allocated once per device by the caller, are
// the only atomics, and replace the scalar route's reduce launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "pool_tiles.cuh"

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

namespace {
namespace pool {

// Ring slot of the g plane of tap dt for input plane ti: at st = 1 the ring
// holds kt + depth consecutive g planes, g plane to in slot
// (to - pt + kt) % ring; otherwise input planes alternate between two sets
// of kt slots.
template <int KT>
__device__ __forceinline__ int dx_slot(const Plan& p, int ti, int dt) {
  return p.st == 1 ? (ti - dt + KT) % p.ring : (ti & 1) * KT + dt;
}

// Whether q = i + p - d is a whole output position q / s of an axis of n.
__device__ __forceinline__ bool hits(int q, int s, int n) {
  return q >= 0 && q % s == 0 && q / s < n;
}

template <typename T, int KT, int KH, int KW, int SH, int SW>
__global__ void __launch_bounds__(kThreads, 2)
    token_pool_dx_tiled(const T* __restrict__ g, const T* __restrict__ wt, T* __restrict__ dx,
                        Plan p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int ys[kMaxSlots], xs[kMaxSlots];
  const T* smem = reinterpret_cast<const T*>(smem_raw);
  constexpr int PT = KT / 2, PH = KH / 2, PW = KW / 2;
  constexpr int kTaps = KT * KH * KW;
  constexpr int JH = (KH - 1) / SH, JW = (KW - 1) / SW;
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = kSlice / kVec;

  int idx = blockIdx.x;
  const int tw_i = idx % p.tiles_w;
  idx /= p.tiles_w;
  const int th_i = idx % p.tiles_h;
  idx /= p.tiles_h;
  const int b = idx % p.B, slice = idx / p.B;
  // The tile's super-blocks: super-row m covers input rows s * m - p ..
  // s * m - p + s - 1, from m = p / s (the first that reaches row 0) on.
  const int m0 = PH / p.sh + th_i * p.tile_h, n0 = PW / p.sw + tw_i * p.tile_w;
  const int nh = min(p.tile_h, (p.H - 1 + PH) / p.sh - m0 + 1);
  const int nw = min(p.tile_w, (p.W - 1 + PW) / p.sw - n0 + 1);
  const int ch0 = slice * kSlice;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int c = ch0 + 2 * lane;
  const bool active = c < p.C;

  // The g rows m0 - JH .. m0 + nh - 1 and columns likewise.
  const Axis ry{m0 - JH, 1, 1, nh + JH, p.H2};
  const Axis rx{n0 - JW, 1, 1, nw + JW, p.W2};
  fill_axis(ys, ry, p.W2);
  fill_axis(xs, rx, 1);
  const Slots slots = make_slots<T>(ys, ry.n, xs, rx.n);
  const int plane_elems = p.rows * p.cols * kSlice;
  const uint32_t smem_base = hopper::smem_addr(smem_raw);

  float2 w[kTaps];
  {
    const int r0 = active ? c % p.Cw : 0, r1 = active ? (c + 1) % p.Cw : 0;
#pragma unroll
    for (int t = 0; t < kTaps; ++t) {
      w[t] = make_float2(to_f32(wt[r0 * kTaps + t]), to_f32(wt[r1 * kTaps + t]));
    }
  }

  const int HWC = p.H * p.W * p.C, gHWC = p.H2 * p.W2 * p.C;
  const T* gb = g + (int64_t)b * p.T2 * gHWC;
  // Copies the g planes input plane ti reads and the ring does not hold yet.
  auto issue = [&](int ti) {
#pragma unroll
    for (int dt = 0; dt < KT; ++dt) {
      if (p.st == 1 && ti > 0 && dt > 0) continue;
      const int q = ti + PT - dt;
      if (!hits(q, p.st, p.T2)) continue;
      load_plane(smem_base + dx_slot<KT>(p, ti, dt) * plane_elems * (int)sizeof(T),
                 gb + (int64_t)(q / p.st) * gHWC, p.C, slots, p.cols, ch0);
    }
    hopper::cp_async_commit();
  };

  // The tile's input rows and columns inside the grid, and whether some
  // residue of the grid has no tap (s > k), which leaves zeros to write.
  const int iy0 = max(0, p.sh * m0 - PH), iy1 = min(p.H, p.sh * (m0 + nh) - PH);
  const int ix0 = max(0, p.sw * n0 - PW), ix1 = min(p.W, p.sw * (n0 + nw) - PW);
  const int zw = ix1 - ix0;
  const bool gaps = p.sh > KH || p.sw > KW;
  const uint32_t zw_magic = div_magic(zw), sh_magic = div_magic(p.sh), sw_magic = div_magic(p.sw);
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
  for (int ti = 0; ti < p.T; ++ti) {
    if (ti + p.depth < p.T) {
      issue(ti + p.depth);
    } else {
      hopper::cp_async_commit();
    }
    wait_pending(p.depth);
    __syncthreads();
    // The ring slot of each T tap's g plane, -1 where it reaches no output plane.
    int tslot[KT];
    bool plane_hit = false;
#pragma unroll
    for (int dt = 0; dt < KT; ++dt) {
      const bool h = hits(ti + PT - dt, p.st, p.T2);
      tslot[dt] = h ? dx_slot<KT>(p, ti, dt) : -1;
      plane_hit |= h;
    }
    T* db = dx + ((int64_t)b * p.T + ti) * HWC + c;
    for (int it = warp; plane_hit && active && it < items; it += kWarps) {
      const int a = fast_div(it, pairs_magic), q0 = (it - a * npairs) * 2;
      const bool two = q0 + 1 < nw;
      float2 acc[2][SH][SW];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
#pragma unroll
        for (int ry = 0; ry < SH; ++ry) {
#pragma unroll
          for (int rx = 0; rx < SW; ++rx) acc[q][ry][rx] = make_float2(0.0f, 0.0f);
        }
      }
#pragma unroll
      for (int dt = 0; dt < KT; ++dt) {
        if (tslot[dt] < 0) continue;
        const T* plane = smem + tslot[dt] * plane_elems + 2 * lane;
#pragma unroll
        for (int jr = 0; jr <= JH; ++jr) {
          // g row m - jr of super-row m = m0 + a; columns n - JW .. n + 1.
          const T* row = plane + ((a + JH - jr) * p.cols + q0) * kSlice;
          float2 gv[JW + 2];
#pragma unroll
          for (int k = 0; k < JW + 2; ++k) {
            gv[k] = k <= JW || two ? load2(row + k * kSlice) : make_float2(0.0f, 0.0f);
          }
#pragma unroll
          for (int ry = 0; ry < SH; ++ry) {
            const int dy = ry + SH * jr;
            if (dy >= KH) continue;
#pragma unroll
            for (int rx = 0; rx < SW; ++rx) {
#pragma unroll
              for (int jc = 0; jc <= JW; ++jc) {
                const int dxx = rx + SW * jc;
                if (dxx >= KW) continue;
                const float2 wv = w[(dt * KH + dy) * KW + dxx];
#pragma unroll
                for (int q = 0; q < 2; ++q) {
                  const float2 v = gv[q + JW - jc];
                  acc[q][ry][rx].x = fmaf(v.x, wv.x, acc[q][ry][rx].x);
                  acc[q][ry][rx].y = fmaf(v.y, wv.y, acc[q][ry][rx].y);
                }
              }
            }
          }
        }
      }
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        if (q == 1 && !two) break;
        const int n = n0 + q0 + q;
#pragma unroll
        for (int ry = 0; ry < SH; ++ry) {
          const int iy = p.sh * (m0 + a) - PH + ry;
          if (iy < 0 || iy >= p.H) continue;
#pragma unroll
          for (int rx = 0; rx < SW; ++rx) {
            const int ix = p.sw * n - PW + rx;
            if (ix < 0 || ix >= p.W) continue;
            store2(db + (iy * p.W + ix) * p.C, acc[q][ry][rx]);
          }
        }
      }
    }
    // The inputs no tap reaches (a residue >= k, or no T tap): zeros, 16
    // bytes a thread.
    if (gaps || !plane_hit) {
      T* zb = dx + ((int64_t)b * p.T + ti) * HWC;
      const int n = (iy1 - iy0) * zw * kChunks;
      for (int i = tid; i < n; i += kThreads) {
        const int pos = i / kChunks, k = i % kChunks;
        const int ly = fast_div(pos, zw_magic);
        const int iy = iy0 + ly, ix = ix0 + pos - ly * zw;
        const int cc = ch0 + k * kVec;
        const int qy = iy + PH, qx = ix + PW;
        const int ry = qy - fast_div(qy, sh_magic) * p.sh, rx = qx - fast_div(qx, sw_magic) * p.sw;
        if ((plane_hit && ry < KH && rx < KW) || cc >= p.C) continue;
        *reinterpret_cast<uint4*>(zb + (iy * p.W + ix) * p.C + cc) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    __syncthreads();
  }
}

// Entries of a (taps x slice) partial each thread of the dw kernel's last
// blocks sums.
template <int kTaps>
constexpr int kPerThread = (kTaps * kSlice + kThreads - 1) / kThreads;

template <typename T, int KT, int KH, int KW>
__global__ void __launch_bounds__(kThreads, 2)
    token_pool_dw_tiled(const T* __restrict__ x, const T* __restrict__ g, float* __restrict__ part,
                        float* __restrict__ slice_sum, int* __restrict__ counters,
                        T* __restrict__ dw, Plan p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int PT = KT / 2, PH = KH / 2, PW = KW / 2;
  constexpr int kTaps = KT * KH * KW;
  constexpr int kPer = kPerThread<kTaps>;
  __shared__ int ys[kMaxSlots], xs[kMaxSlots], gys[kMaxTile], gxs[kMaxTile];
  __shared__ float red[kTaps * kSlice];
  __shared__ int last;
  const T* smem = reinterpret_cast<const T*>(smem_raw);

  const int slice = blockIdx.x / p.groups, grp = blockIdx.x % p.groups;
  const int ch0 = slice * kSlice;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int c = ch0 + 2 * lane;
  const bool active = c < p.C;
  const int units = p.B * p.tiles_h * p.tiles_w;
  const int plane_elems = p.rows * p.cols * kSlice;
  const int g_elems = p.tile_h * p.tile_w * kSlice;
  const uint32_t smem_base = hopper::smem_addr(smem_raw);
  const uint32_t g_base = smem_base + p.ring * plane_elems * (int)sizeof(T);
  const int HWC = p.H * p.W * p.C, gHWC = p.H2 * p.W2 * p.C;

  float2 acc[kTaps];
#pragma unroll
  for (int t = 0; t < kTaps; ++t) acc[t] = make_float2(0.0f, 0.0f);

  for (int u = grp; u < units; u += p.groups) {
    const int tw_i = u % p.tiles_w, r = u / p.tiles_w;
    const int th_i = r % p.tiles_h, b = r / p.tiles_h;
    const int oh0 = th_i * p.tile_h, ow0 = tw_i * p.tile_w;
    const int nh = min(p.tile_h, p.H2 - oh0), nw = min(p.tile_w, p.W2 - ow0);
    const Axis ry{oh0 * p.sh - PH, p.row_step, p.sh, (nh - 1) * p.row_step + KH, p.H};
    const Axis rx{ow0 * p.sw - PW, p.col_step, p.sw, (nw - 1) * p.col_step + KW, p.W};
    fill_axis(ys, ry, p.W);
    fill_axis(xs, rx, 1);
    fill_axis(gys, Axis{oh0, 1, 1, nh, p.H2}, p.W2);
    fill_axis(gxs, Axis{ow0, 1, 1, nw, p.W2}, 1);
    const Slots xslots = make_slots<T>(ys, ry.n, xs, rx.n);
    const Slots gslots = make_slots<T>(gys, nh, gxs, nw);
    const uint32_t nw_magic = div_magic(nw);
    const T* xb = x + (int64_t)b * p.T * HWC;
    const T* gb = g + (int64_t)b * p.T2 * gHWC;
    // The forward's x planes of output plane t2, and g's plane t2.
    auto issue = [&](int t2) {
#pragma unroll
      for (int dt = 0; dt < KT; ++dt) {
        if (p.st == 1 && t2 > 0 && dt < KT - 1) continue;
        const int ti = t2 * p.st + dt - PT;
        if (ti < 0 || ti >= p.T) continue;
        load_plane(smem_base + fwd_slot<KT>(p, t2, dt) * plane_elems * (int)sizeof(T),
                   xb + (int64_t)ti * HWC, p.C, xslots, p.cols, ch0);
      }
      load_plane(g_base + (t2 % (p.depth + 1)) * g_elems * (int)sizeof(T),
                 gb + (int64_t)t2 * gHWC, p.C, gslots, p.tile_w, ch0);
      hopper::cp_async_commit();
    };

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
      const T* gs = smem + p.ring * plane_elems + (t2 % (p.depth + 1)) * g_elems + 2 * lane;
      for (int pi = warp; active && pi < nh * nw; pi += kWarps) {
        const int oy = fast_div(pi, nw_magic), ox = pi - oy * nw;
        const float2 gv = load2(gs + (oy * p.tile_w + ox) * kSlice);
#pragma unroll
        for (int dt = 0; dt < KT; ++dt) {
          const int ti = t2 * p.st + dt - PT;
          if (ti < 0 || ti >= p.T) continue;
          const T* plane = smem + fwd_slot<KT>(p, t2, dt) * plane_elems + 2 * lane;
#pragma unroll
          for (int dy = 0; dy < KH; ++dy) {
            // Rows and columns outside the input are zero-filled slots.
            const T* row = plane + (oy * p.row_step + dy) * p.cols * kSlice;
#pragma unroll
            for (int d = 0; d < KW; ++d) {
              const float2 v = load2(row + (ox * p.col_step + d) * kSlice);
              float2& a = acc[(dt * KH + dy) * KW + d];
              a.x = fmaf(v.x, gv.x, a.x);
              a.y = fmaf(v.y, gv.y, a.y);
            }
          }
        }
      }
      __syncthreads();
    }
  }

  // The warps' sums, in warp order, then the block's partial.
  for (int wi = 0; wi < kWarps; ++wi) {
    if (warp == wi) {
#pragma unroll
      for (int t = 0; t < kTaps; ++t) {
        float* r = red + t * kSlice + 2 * lane;
        r[0] = (wi == 0 ? 0.0f : r[0]) + acc[t].x;
        r[1] = (wi == 0 ? 0.0f : r[1]) + acc[t].y;
      }
    }
    __syncthreads();
  }
  float* mine = part + ((int64_t)slice * p.groups + grp) * (kTaps * kSlice);
  for (int i = tid; i < kTaps * kSlice; i += kThreads) mine[i] = red[i];
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    last = atomicAdd(counters + slice, 1) == p.groups - 1;
    if (last) counters[slice] = 0;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();

  // The slice's last block: its groups' partials, each entry summed in group
  // order. Eight groups' loads are issued before their sums, so the walk
  // over the groups waits on L2 once per eight.
  {
    const float* src = part + (int64_t)slice * p.groups * (kTaps * kSlice);
    float s[kPer];
#pragma unroll
    for (int e = 0; e < kPer; ++e) s[e] = 0.0f;
    for (int k0 = 0; k0 < p.groups; k0 += 8) {
      float v[8][kPer];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
#pragma unroll
        for (int e = 0; e < kPer; ++e) {
          const int i = tid + e * kThreads;
          v[u][e] = k0 + u < p.groups && i < kTaps * kSlice
                        ? __ldcg(src + (k0 + u) * (kTaps * kSlice) + i)
                        : 0.0f;
        }
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
#pragma unroll
        for (int e = 0; e < kPer; ++e) s[e] += v[u][e];
      }
    }
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int i = tid + e * kThreads;
      const int ch = ch0 + i % kSlice;
      if (i < kTaps * kSlice && ch < p.C) slice_sum[(i / kSlice) * p.C + ch] = s[e];
    }
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    last = atomicAdd(counters + p.slices, 1) == p.slices - 1;
    if (last) counters[p.slices] = 0;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();

  // The last slice's last block: the heads that share each weight row, in
  // head order; dw is (Cw, taps).
  const int heads = p.C / p.Cw;
  for (int i0 = 0; i0 < p.Cw * kTaps; i0 += kThreads * kPer) {
    float s[kPer];
#pragma unroll
    for (int e = 0; e < kPer; ++e) s[e] = 0.0f;
    for (int h0 = 0; h0 < heads; h0 += 8) {
      float v[8][kPer];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
#pragma unroll
        for (int e = 0; e < kPer; ++e) {
          const int i = i0 + tid + e * kThreads;
          v[u][e] = h0 + u < heads && i < p.Cw * kTaps
                        ? __ldcg(slice_sum + (i % kTaps) * p.C + (h0 + u) * p.Cw + i / kTaps)
                        : 0.0f;
        }
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
#pragma unroll
        for (int e = 0; e < kPer; ++e) s[e] += v[u][e];
      }
    }
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int i = i0 + tid + e * kThreads;
      if (i < p.Cw * kTaps) dw[i] = from_f32<T>(s[e]);
    }
  }
}

template <typename T, int KT, int KH, int KW, int SH, int SW>
cudaError_t launch_dx_steps(const void* g, const void* wt, void* dx, const Plan& p,
                            cudaStream_t stream) {
  static int limit[64];
  cudaError_t err = allow_smem(token_pool_dx_tiled<T, KT, KH, KW, SH, SW>, p.smem_bytes, limit);
  if (err != cudaSuccess) return err;
  token_pool_dx_tiled<T, KT, KH, KW, SH, SW><<<p.blocks, kThreads, p.smem_bytes, stream>>>(
      static_cast<const T*>(g), static_cast<const T*>(wt), static_cast<T*>(dx), p);
  return cudaGetLastError();
}

// The dx kernel of the plan's row and column steps (min(s, k), 1 to 3).
template <typename T, int KT, int KH, int KW>
cudaError_t launch_dx_tiled(const void* g, const void* wt, void* dx, const Plan& p,
                            cudaStream_t stream) {
  switch (p.row_step * 4 + p.col_step) {
    case 5: return launch_dx_steps<T, KT, KH, KW, 1, 1>(g, wt, dx, p, stream);
    case 6: return launch_dx_steps<T, KT, KH, KW, 1, 2>(g, wt, dx, p, stream);
    case 7: return launch_dx_steps<T, KT, KH, KW, 1, 3>(g, wt, dx, p, stream);
    case 9: return launch_dx_steps<T, KT, KH, KW, 2, 1>(g, wt, dx, p, stream);
    case 10: return launch_dx_steps<T, KT, KH, KW, 2, 2>(g, wt, dx, p, stream);
    case 11: return launch_dx_steps<T, KT, KH, KW, 2, 3>(g, wt, dx, p, stream);
    case 13: return launch_dx_steps<T, KT, KH, KW, 3, 1>(g, wt, dx, p, stream);
    case 14: return launch_dx_steps<T, KT, KH, KW, 3, 2>(g, wt, dx, p, stream);
    case 15: return launch_dx_steps<T, KT, KH, KW, 3, 3>(g, wt, dx, p, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, int KT, int KH, int KW>
cudaError_t launch_dw_tiled(const void* x, const void* g, float* part, float* slice_sum,
                            int* counters, void* dw, const Plan& p, cudaStream_t stream) {
  static int limit[64];
  cudaError_t err = allow_smem(token_pool_dw_tiled<T, KT, KH, KW>, p.smem_bytes, limit);
  if (err != cudaSuccess) return err;
  token_pool_dw_tiled<T, KT, KH, KW><<<p.blocks, kThreads, p.smem_bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), part, slice_sum, counters,
      static_cast<T*>(dw), p);
  return cudaGetLastError();
}

// The checks both tiled entry points share: the plan's slices, ring and
// tiles over the grid `H x W` that the block tiles (dx: the input; dw: the
// output), and a plane offset that fits in 32 bits.
bool tiled_ok(const Plan& p, int kt, int H, int W) {
  return plan_ok(p) && (int64_t)p.H * p.W * p.C <= 0x7fffffff && p.Cw > 0 && p.C % p.Cw == 0 &&
         p.tiles_h * p.tile_h >= H && p.tiles_w * p.tile_w >= W &&
         p.ring == (p.st == 1 ? kt + p.depth : 2 * kt);
}

}  // namespace pool
}  // namespace

// The `tiled` route of pvt_token_pool_dx, for kernel sizes (3, 3, 3) and
// (1, 3, 3), float32 or bfloat16 (dtype 0, 1), C * sizeof(dtype) a multiple
// of 16, g and dx 16-byte aligned. `args` holds the geometry (B, T, H, W, C,
// T2, H2, W2, kt, kh, kw, st, sh, sw, Cw, mode (unused), dtype) and then
// pool_tile_plan's 14 ints for kind "dx" (tiles of input rows x columns).
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int pvt_token_pool_dx_tiled(const void* g, const void* wt, void* dx, const int* args,
                                       void* stream) {
  const pool::Call call = pool::make_call(args);
  const pool::Plan& p = call.p;
  const int kt = call.kt, kh = call.kh, kw = call.kw, dtype = call.dtype;
  if ((int64_t)p.B * p.T * p.H * p.W * p.C == 0) return (int)cudaSuccess;
  const int elem = dtype == 0 ? 4 : 2;
  const int row_step = p.sh < kh ? p.sh : kh, col_step = p.sw < kw ? p.sw : kw;
  // Super-rows from (kh / 2) / sh to (H - 1 + kh / 2) / sh; likewise columns.
  const int super_h = (p.H - 1 + kh / 2) / p.sh - (kh / 2) / p.sh + 1;
  const int super_w = (p.W - 1 + kw / 2) / p.sw - (kw / 2) / p.sw + 1;
  if (!pool::tiled_ok(p, kt, super_h, super_w) || p.row_step != row_step ||
      p.col_step != col_step || p.rows != p.tile_h + (kh - 1) / row_step ||
      p.cols != p.tile_w + (kw - 1) / col_step ||
      (int64_t)p.blocks != (int64_t)p.B * p.slices * p.tiles_h * p.tiles_w ||
      (int64_t)p.ring * p.rows * p.cols * pool::kSlice * elem > p.smem_bytes) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kt == 3 && kh == 3 && kw == 3) {
    if (dtype == 0) return (int)pool::launch_dx_tiled<float, 3, 3, 3>(g, wt, dx, p, s);
    if (dtype == 1) return (int)pool::launch_dx_tiled<__nv_bfloat16, 3, 3, 3>(g, wt, dx, p, s);
  } else if (kt == 1 && kh == 3 && kw == 3) {
    if (dtype == 0) return (int)pool::launch_dx_tiled<float, 1, 3, 3>(g, wt, dx, p, s);
    if (dtype == 1) return (int)pool::launch_dx_tiled<__nv_bfloat16, 1, 3, 3>(g, wt, dx, p, s);
  }
  return (int)cudaErrorInvalidValue;
}

// The `tiled` route of pvt_token_pool_dw, in one launch: dw (Cw, kt*kh*kw)
// from x and g, through the caller's f32 scratch of
// slices * groups * kt*kh*kw * 64 (the blocks' partials) + kt*kh*kw * C
// floats (the slices' sums) and its int counters (at least slices + 1,
// zero before the first call; each call leaves them zero). Calls that share
// counters must not run at once. Same types, alignment, kernel sizes and
// `args` layout as pvt_token_pool_dx_tiled, with pool_tile_plan's plan for
// kind "dw".
extern "C" int pvt_token_pool_dw_tiled(const void* x, const void* g, float* scratch,
                                       int* counters, void* dw, const int* args, void* stream) {
  const pool::Call call = pool::make_call(args);
  const pool::Plan& p = call.p;
  const int kt = call.kt, kh = call.kh, kw = call.kw, dtype = call.dtype;
  const int row_step = p.sh < kh ? p.sh : kh, col_step = p.sw < kw ? p.sw : kw;
  const int elem = dtype == 0 ? 4 : 2;
  if ((int64_t)p.B * p.T2 * p.H2 * p.W2 == 0 || !pool::tiled_ok(p, kt, p.H2, p.W2) ||
      p.groups < 1 || p.row_step != row_step || p.col_step != col_step ||
      p.rows != (p.tile_h - 1) * row_step + kh || p.cols != (p.tile_w - 1) * col_step + kw ||
      (int64_t)p.blocks != (int64_t)p.slices * p.groups ||
      (int64_t)p.groups > (int64_t)p.B * p.tiles_h * p.tiles_w ||
      ((int64_t)p.ring * p.rows * p.cols + (p.depth + 1) * p.tile_h * p.tile_w) * pool::kSlice *
              elem >
          p.smem_bytes) {
    return (int)cudaErrorInvalidValue;
  }
  const int taps = kt * kh * kw;
  float* part = scratch;
  float* slice_sum = scratch + (int64_t)p.slices * p.groups * taps * pool::kSlice;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kt == 3 && kh == 3 && kw == 3) {
    if (dtype == 0) {
      return (int)pool::launch_dw_tiled<float, 3, 3, 3>(x, g, part, slice_sum, counters, dw, p, s);
    }
    if (dtype == 1) {
      return (int)pool::launch_dw_tiled<__nv_bfloat16, 3, 3, 3>(x, g, part, slice_sum, counters,
                                                                 dw, p, s);
    }
  } else if (kt == 1 && kh == 3 && kw == 3) {
    if (dtype == 0) {
      return (int)pool::launch_dw_tiled<float, 1, 3, 3>(x, g, part, slice_sum, counters, dw, p, s);
    }
    if (dtype == 1) {
      return (int)pool::launch_dw_tiled<__nv_bfloat16, 1, 3, 3>(x, g, part, slice_sum, counters,
                                                                 dw, p, s);
    }
  }
  return (int)cudaErrorInvalidValue;
}
