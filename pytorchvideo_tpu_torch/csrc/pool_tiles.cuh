// Shared-memory tiles of a channels-last (B, T, H, W, C) grid for the
// `tiled` kernels of the token pool (token_pool.cu, token_pool_bwd.cu), of
// the depthwise conv (depthwise_conv.cu) and of the fused kv-pool's pool-LN
// (fused_kvpool_attention.cu), sm_90a (H100): the tile plan that
// `pool_tile_plan` (ops/token_pool.py) or `pool_ln_tile_plan`
// (ops/fused_kvpool_attention.py) picks, the slot maps of the rows and
// columns a tile reads, and cp.async copies of one plane's slots, 16 bytes
// wide unless the caller asks for 8 or 4 (rows of C channels that are no
// whole number of 16-byte vectors, as X3D-S's 54 and 108). Each source
// includes it into its own translation unit.
//
// A block owns one channel slice of kSlice channels: lane l holds channels
// 2l and 2l + 1 (a bf16x2 or a float2), so a warp reads one position's slice
// from shared memory without bank conflicts and stores it to device memory
// in one 128-byte (bf16) or 256-byte (f32) run. A plane of the tile is
// `rows x cols` slots of one slice each, slot (j, i) at element
// (j * cols + i) * kSlice. The slot maps and the copy take the slice's
// width as a template parameter, kSlice unless the caller gives another:
// the pool-LN's slice is one head (c channels), so a warp holds a whole
// head for its LayerNorm. Slot j of an axis holds input coordinate
// base + (j / step) * s + j % step: with step = min(s, k), output o and tap
// d read slot o * step + d, which is the contiguous range of the tile's
// windows where they overlap (s < k) and only the k rows of each window,
// compacted, where they do not (s >= k).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_tiles.cuh"

namespace {
namespace pool {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSlice = 64;      // channels of a block: 32 lanes x 2
constexpr int kMaxTile = 64;    // tile rows and columns (pool_tile_plan's POOL_MAX_TILE)
constexpr int kMaxSlots = 192;  // slots of a tile axis: (kMaxTile - 1) * 3 + 3
constexpr int kMaxDepth = 4;    // planes a walk copies ahead, at most
enum Mode { kConv = 0, kMax = 1, kAvg = 2 };

struct Plan {
  int B, T, H, W, C;       // input grid
  int T2, H2, W2;          // output grid
  int st, sh, sw;          // stride
  int Cw;                  // weight rows
  int tile_h, tile_w;      // outputs of a tile (dx: inputs)
  int tiles_h, tiles_w;
  int slices;              // channel slices of kSlice
  int rows, cols;          // slots of a plane
  int row_step, col_step;  // forward and dw: min(s, k); dx: 1
  int ring;                // planes in the ring
  int depth;               // planes the walk copies ahead
  int groups;              // dw: blocks per slice
  int blocks;
  int smem_bytes;          // dynamic shared memory of a block
};

// A tiled call's ints, as the wrapper caches them per call signature: the
// geometry (kGeometryInts: B, T, H, W, C, T2, H2, W2, kt, kh, kw, st, sh, sw,
// Cw, mode, dtype), then pool_tile_plan's 14, in Plan's order from tile_h on.
constexpr int kGeometryInts = 17;
struct Call {
  int kt, kh, kw, mode, dtype;
  Plan p;
};

inline Call make_call(const int* a) {
  const int* v = a + kGeometryInts;
  return Call{a[8], a[9], a[10], a[15], a[16],
              Plan{a[0], a[1], a[2], a[3], a[4], a[5], a[6], a[7], a[11], a[12], a[13], a[14],
                   v[0], v[1], v[2], v[3], v[4], v[5], v[6], v[7], v[8], v[9], v[10], v[11],
                   v[12], v[13]}};
}

// `width`: the channels of a slice (kSlice, or the pool-LN's head width).
inline bool plan_ok(const Plan& p, int width = kSlice) {
  return p.tile_h > 0 && p.tile_w > 0 && p.tile_h <= kMaxTile && p.tile_w <= kMaxTile &&
         p.tiles_h > 0 && p.tiles_w > 0 && p.slices > 0 && p.rows > 0 && p.cols > 0 &&
         p.rows <= kMaxSlots && p.cols <= kMaxSlots && p.depth >= 1 && p.depth <= kMaxDepth &&
         (p.st == 1 || p.depth == 1) && p.row_step > 0 && p.col_step > 0 && p.ring > 0 &&
         p.blocks > 0 && p.smem_bytes > 0 && p.smem_bytes <= 232448 && p.st > 0 &&
         p.sh > 0 && p.sw > 0 && p.C % 2 == 0 && width > 0 && (p.C + width - 1) / width == p.slices;
}

// Raises the kernel's dynamic shared-memory limit to `bytes` where it is
// lower. The attribute is per device. It is set for small launches too:
// without it, static and dynamic shared memory together may not pass 48 KB,
// and the kernels' slot tables are static. The limit is what the launch
// asks, not the card's most, since static shared memory counts against the
// 227 KB as well.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, int bytes, int (&limit)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && limit[dev] >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < 64) limit[dev] = bytes;
  return err;
}

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

// Two adjacent channels as floats, and back (round to nearest once).
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store2(float* p, float2 v) {
  *reinterpret_cast<float2*>(p) = v;
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float2 v) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v.x, v.y);
}

// One axis of a tile's slot map: slot j holds coordinate
// base + (j / step) * s + j % step; coordinates outside [0, bound) are
// zero-filled.
struct Axis {
  int base, step, s, n, bound;
  __device__ __forceinline__ int coord(int j) const { return base + (j / step) * s + j % step; }
};

// floor(a / s) for any sign of a, s > 0.
__device__ __forceinline__ int floor_div(int a, int s) {
  return a >= 0 ? a / s : -((-a + s - 1) / s);
}

// Division by a block-uniform d without a divide: q = i / d is
// __umulhi(i, ceil(2^32 / d)), exact for i, d < 2^16 (every index a tile
// divides here is below 2^13); d = 1 keeps i.
__device__ __forceinline__ uint32_t div_magic(int d) {
  return d > 1 ? 0xFFFFFFFFu / (uint32_t)d + 1u : 0u;
}
__device__ __forceinline__ int fast_div(int i, uint32_t magic) {
  return magic ? (int)__umulhi((uint32_t)i, magic) : i;
}

// Waits until at most n of this thread's cp.async groups are pending: the
// walk's plane i has landed once the `depth` groups issued after it are all
// that is left.
__device__ __forceinline__ void wait_pending(int n) {
  switch (n) {
    case 0: hopper::cp_async_wait<0>(); break;
    case 1: hopper::cp_async_wait<1>(); break;
    case 2: hopper::cp_async_wait<2>(); break;
    case 3: hopper::cp_async_wait<3>(); break;
    default: hopper::cp_async_wait<4>(); break;
  }
}

// Ring slot of the input plane of tap dt for output plane t2: at st = 1 the
// ring holds kt + depth consecutive planes, plane ti in slot (ti + pt) %
// ring, so the copies `depth` output planes ahead land in the slot of a
// plane no pending output plane reads; otherwise output planes alternate
// between two sets of kt slots.
template <int KT>
__device__ __forceinline__ int fwd_slot(const Plan& p, int t2, int dt) {
  return p.st == 1 ? (t2 + dt) % p.ring : (t2 & 1) * KT + dt;
}

// The slots of one tile axis as offsets into a plane: tab[j] =
// coordinate * scale (scale W for rows, 1 for columns), -1 where slot j
// falls outside [0, bound). Filled once per tile, read for every plane.
__device__ __forceinline__ void fill_axis(int* tab, const Axis& a, int scale) {
  for (int j = threadIdx.x; j < a.n; j += kThreads) {
    const int c = a.coord(j);
    tab[j] = c >= 0 && c < a.bound ? c * scale : -1;
  }
}

// A plane's slots: ny rows x nx columns, from the tables of fill_axis.
struct Slots {
  const int* ys;
  const int* xs;
  int ny, nx;
  uint32_t magic;  // div_magic(nx * the chunks of a slot)
};

// kBytes: the width of one copy (load_plane's), 16, 8 or 4; kWidth: the
// channels of a slice (load_plane's).
template <typename T, int kBytes = 16, int kWidth = kSlice>
__device__ __forceinline__ Slots make_slots(const int* ys, int ny, const int* xs, int nx) {
  return Slots{ys, xs, ny, nx, div_magic(nx * (kWidth * (int)sizeof(T) / kBytes))};
}

// kBytes global -> shared, asynchronously; a source size of 0 writes zeros.
// 16 bytes bypass L1 (.cg); 8 and 4 may only go through it (.ca).
template <int kBytes>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src, bool valid) {
  static_assert(kBytes == 16 || kBytes == 8 || kBytes == 4, "cp.async copies 4, 8 or 16 bytes");
  if constexpr (kBytes == 16) {
    hopper::cp_async_16(dst, src, valid);
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst), "l"(src),
                 "n"(kBytes), "r"(valid ? kBytes : 0)
                 : "memory");
  }
}

// Copies one plane's slots (sl.ny x sl.nx; an edge tile reads fewer than
// the plan holds room for) of the kWidth-channel slice at channel ch0 into
// shared memory at dst, `pitch` slots a row, by kBytes-wide cp.async: thread i of the
// block takes the chunks i, i + kThreads, ..., so a warp writes 32 * kBytes
// contiguous bytes of a row. The caller's rows of C channels are whole
// chunks (C * sizeof(T) % kBytes == 0) and its pointers kBytes-aligned.
// Chunks past C are not copied (no lane reads them); slots outside the
// plane are zero-filled.
template <typename T, int kBytes = 16, int kWidth = kSlice>
__device__ __forceinline__ void load_plane(uint32_t dst, const T* plane, int C, const Slots& sl,
                                           int pitch, int ch0) {
  constexpr int kVec = kBytes / sizeof(T);
  constexpr int kChunks = kWidth / kVec;
  const int per_row = sl.nx * kChunks;
  const int n = sl.ny * per_row;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int jy = fast_div(i, sl.magic);
    const int rest = i - jy * per_row;
    const int jx = rest / kChunks, k = rest % kChunks;
    const int c = ch0 + k * kVec;
    if (c >= C) continue;
    const int y = sl.ys[jy], x = sl.xs[jx];
    const bool valid = (y | x) >= 0;
    cp_async<kBytes>(dst + kBytes * ((jy * pitch + jx) * kChunks + k),
                     valid ? plane + (y + x) * C + c : plane, valid);
  }
}

}  // namespace pool
}  // namespace
