// Pooled multi-head attention, softmax(q k^T * scale) v (+ q), for sm_90a (H100).
//
// This source replaces two TPU kernels of pytorchvideo_tpu/ops/pooled_attention.py:
// `_packed_pallas_local` (body `_attention_kernel_packed`), MViT's default
// head-packed path, and `_pooled_attention_pallas_local` (body
// `_attention_kernel`), the per-head path of `pool_first` (and the unpadded
// benchmark variant `_pallas_nopad` of benchmarks/mvit_micro.py). The layouts
// differ only in strides, so the caller passes a (batch, head, row) stride
// triple per tensor: head-packed (B, L, H*c) is (L*H*c, c, H*c), per-head
// (B, H, L, c) is (H*L*c, L*c, c). The last axis (c) is contiguous.
//
// MViT's attention is tall and skinny: Lq up to 50,176 query rows against
// Lk up to 3,137 pooled keys, c = 96. The TPU kernel holds all of K and V in
// VMEM; here they do not fit in shared memory, so K and V stream through it
// in tiles under an online softmax (running row max and sum, rescaled
// output). Nothing of size (Lq, Lk) reaches device memory. In training the
// caller also passes `lse`, (B, H, Lq) float32, and each row's natural-log
// log-sum-exp of its scaled scores lands there for the backward
// (csrc/pooled_attention_bwd.cu); the deploy path passes null. The output is
// rounded once to the input type, after the +q residual in f32.
//
// Three routes; ops/pooled_attention.py picks one per call by dtype and shape:
//
// - Tensor cores (`pvt_pooled_attention_tc`): bf16, c a multiple of 8, more
//   than a few query rows. Bound by operations: MViT-B 16x4's 16 grid
//   attentions do 0.94 ms of bf16 products per B32 forward at 989 TFLOP/s
//   against far fewer bytes. A block owns one (batch, head) and 192 query
//   rows, three warpgroups of 64; its Q tile is loaded once. K and V tiles
//   of 64 keys come by cp.async into a three-stage ring in shared memory,
//   two tiles ahead, so the copies overlap the products; one barrier a tile
//   publishes the landed tile and frees the oldest stage. S = Q K^T is a
//   wgmma (m64n64k16, bf16 in, f32 accumulate) with both operands in shared
//   memory; the online softmax runs on the accumulator in registers, in f32
//   with exp2, row max and sum by quad shuffles; P goes to bf16 in
//   registers as a hi + lo pair (bf16 alone is 2^-9 relative per
//   probability, past the bf16 tolerance at few keys), each the register A
//   operand of O += P V (m64n{c}k16), V read as an MN-major B operand (the
//   transpose bit). The pair makes P V twice the tensor work of S.
//   Tiles are laid out in 8 x 16-byte core matrices (no swizzle), so c = 96
//   (192-byte rows, which no swizzle atom spans) needs no panels, and any
//   c <= 128 is zero-filled up to the instantiated width. Ragged edges: the
//   copies zero-fill rows past L and columns past c (cp.async with a source
//   size of 0), scores of keys past Lk are -inf before the row max, stores
//   past Lq are masked.
// - Split keys (`pvt_pooled_attention_split`): bf16, c a multiple of 8, at
//   most kMaxRows query rows (MViT's cls query, Lq = 1). Bound by bytes: the
//   16 cls queries read K and V once, 0.154 ms per B32 forward at
//   3.35 TB/s. One block per (batch, head) would walk all keys alone with 64
//   blocks on 132 SMs; instead the key axis is cut into splits, one per
//   16-lane group (each lane holds 8 columns; 4 keys' loads in flight), each
//   producing an f32 (row max, row sum, unnormalised output) partial; a
//   second launch combines the partials in split order (no atomics) and
//   adds the residual and the lse.
// - CUDA cores (`pvt_pooled_attention`): float32, and bf16 whose c is not a
//   multiple of 8 or whose data is not 16-byte aligned. Float32 stays here
//   because the tensor cores take bf16 (8 bits of mantissa) or TF32 (10),
//   and the f32 path is held to 1e-4, beyond either. Arithmetic is f32
//   throughout on 64 x 64 tiles (128 threads, each with 8 rows x 4 keys),
//   inputs converted on load.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_tiles.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* lse;  // (B, H, Lq) row log-sum-exp, natural log; null: not written
  int64_t B, H, Lq, Lk, c;
  int64_t sq[3], sk[3], sv[3], so[3];  // (batch, head, row) strides in elements
  float scale;
  int residual;
};

Args make_args(const void* q, const void* k, const void* v, void* out, float* lse, int64_t B,
               int64_t H, int64_t Lq, int64_t Lk, int64_t c, const int64_t* strides, float scale,
               int residual) {
  Args a{q, k, v, out, lse, B, H, Lq, Lk, c, {}, {}, {}, {}, scale, residual};
  for (int i = 0; i < 3; ++i) {
    a.sq[i] = strides[i];
    a.sk[i] = strides[3 + i];
    a.sv[i] = strides[6 + i];
    a.so[i] = strides[9 + i];
  }
  return a;
}

// The bf16 routes load 16 bytes at a time: 16-byte aligned tensors whose
// strides are multiples of 8 elements, c a multiple of 8, at most 128.
bool vector_ready(const Args& a) {
  const void* ptrs[4] = {a.q, a.k, a.v, a.out};
  for (const void* p : ptrs) {
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  }
  for (int i = 0; i < 3; ++i) {
    if (a.sq[i] % 8 || a.sk[i] % 8 || a.sv[i] % 8 || a.so[i] % 8) return false;
  }
  return a.c % 8 == 0 && a.c >= 8 && a.c <= 128 && a.Lk >= 1 && a.H <= 65535 && a.B <= 65535;
}

// ---------------------------------------------------------------------------
// CUDA-core route.

namespace cuda_core {

constexpr int kThreads = 128;
constexpr int kBQ = 64;  // q rows per block
constexpr int kBK = 64;  // keys per streamed tile
constexpr int kRows = 8;  // q rows per thread
constexpr int kCols = kBK / 16;  // score columns per thread

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16(v);
}

// Loads rows [row0, row0 + n_rows) of a (rows, c) slice into a (n_rows, DC+1)
// f32 tile; rows past `rows` and columns past c are zero.
template <typename T, int DC>
__device__ __forceinline__ void load_tile(float* tile, const T* src, int64_t row_stride,
                                          int64_t row0, int64_t rows, int64_t c, int n_rows) {
  for (int i = threadIdx.x; i < n_rows * DC; i += kThreads) {
    const int r = i / DC, d = i % DC;
    float val = 0.0f;
    if (row0 + r < rows && d < c) val = to_f32(src[(row0 + r) * row_stride + d]);
    tile[r * (DC + 1) + d] = val;
  }
}

// Thread (ty, tx) = (tid / 16, tid % 16) owns q rows 8*ty .. 8*ty + 7; for
// the scores it owns keys tx + 16*j (j < 4), for the output head-dim columns
// tx + 16*j (j < DC/16). The 16 threads of a row group are a half-warp, so
// row max and row sum are four shuffles. Shared-memory rows are padded by
// one float so the strided reads of the 16 key rows fall in distinct banks.
template <typename T, int DC>
__global__ void __launch_bounds__(kThreads) pooled_attention_kernel(Args a) {
  extern __shared__ float smem[];
  float* sQ = smem;                   // kBQ x (DC + 1)
  float* sKV = sQ + kBQ * (DC + 1);   // kBK x (DC + 1): K, then V of the tile
  float* sP = sKV + kBK * (DC + 1);   // kBQ x (kBK + 1): probabilities

  constexpr int kOut = DC / 16;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int64_t q0 = (int64_t)blockIdx.x * kBQ;
  const int64_t h = blockIdx.y, b = blockIdx.z;
  const T* qp = static_cast<const T*>(a.q) + b * a.sq[0] + h * a.sq[1];
  const T* kp = static_cast<const T*>(a.k) + b * a.sk[0] + h * a.sk[1];
  const T* vp = static_cast<const T*>(a.v) + b * a.sv[0] + h * a.sv[1];
  T* op = static_cast<T*>(a.out) + b * a.so[0] + h * a.so[1];

  load_tile<T, DC>(sQ, qp, a.sq[2], q0, a.Lq, a.c, kBQ);
  // Threads whose rows all lie past Lq skip the products but keep the
  // shuffles and barriers.
  const bool active = q0 + ty * kRows < a.Lq;
  const float scale_log2 = a.scale * kLog2e;  // exp(x) = exp2(x * log2 e)

  float m[kRows], l[kRows], o[kRows][kOut];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < kOut; ++j) o[i][j] = 0.0f;
  }

  for (int64_t k0 = 0; k0 < a.Lk; k0 += kBK) {
    __syncthreads();  // the previous tile's P @ V is done with sKV and sP
    load_tile<T, DC>(sKV, kp, a.sk[2], k0, a.Lk, a.c, kBK);
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.0f;
    }
    if (active) {
#pragma unroll 4
      for (int d = 0; d < DC; ++d) {
        float qv[kRows], kv[kCols];
#pragma unroll
        for (int i = 0; i < kRows; ++i) qv[i] = sQ[(ty * kRows + i) * (DC + 1) + d];
#pragma unroll
        for (int j = 0; j < kCols; ++j) kv[j] = sKV[(tx + 16 * j) * (DC + 1) + d];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
#pragma unroll
          for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        }
      }
    }

    // Online softmax over this tile (every tile holds at least one key < Lk,
    // so each row's running max is finite after it).
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        s[i][j] = (k0 + tx + 16 * j < a.Lk) ? s[i][j] * scale_log2 : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = exp2f(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        s[i][j] = exp2f(s[i][j] - m_new);
        sum += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kOut; ++j) o[i][j] *= alpha;
#pragma unroll
      for (int j = 0; j < kCols; ++j) sP[(ty * kRows + i) * (kBK + 1) + tx + 16 * j] = s[i][j];
    }
    __syncthreads();  // scores done with K; P complete
    load_tile<T, DC>(sKV, vp, a.sv[2], k0, a.Lk, a.c, kBK);
    __syncthreads();

    if (active) {
#pragma unroll 4
      for (int kk = 0; kk < kBK; ++kk) {
        float pv[kRows], vv[kOut];
#pragma unroll
        for (int i = 0; i < kRows; ++i) pv[i] = sP[(ty * kRows + i) * (kBK + 1) + kk];
#pragma unroll
        for (int j = 0; j < kOut; ++j) vv[j] = sKV[kk * (DC + 1) + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
#pragma unroll
          for (int j = 0; j < kOut; ++j) o[i][j] = fmaf(pv[i], vv[j], o[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = ty * kRows + i;
    if (q0 + r >= a.Lq) continue;
    const float inv = 1.0f / l[i];
#pragma unroll
    for (int j = 0; j < kOut; ++j) {
      const int col = tx + 16 * j;
      if (col >= a.c) continue;
      float y = o[i][j] * inv;
      if (a.residual) y += sQ[r * (DC + 1) + col];
      op[(q0 + r) * a.so[2] + col] = from_f32<T>(y);
    }
    // m is in the log2 domain (scores * scale * log2 e): lse = (m + log2 l) ln 2.
    if (a.lse != nullptr && tx == 0) {
      a.lse[(b * a.H + h) * a.Lq + q0 + r] = (m[i] + log2f(l[i])) * kLn2;
    }
  }
}

template <typename T, int DC>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((kBQ + kBK) * (DC + 1) + kBQ * (kBK + 1));
  cudaError_t err = cudaFuncSetAttribute(pooled_attention_kernel<T, DC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((a.Lq + kBQ - 1) / kBQ), (unsigned)a.H, (unsigned)a.B);
  pooled_attention_kernel<T, DC><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dc(const Args& a, cudaStream_t stream) {
  if (a.c <= 32) return launch<T, 32>(a, stream);
  if (a.c <= 64) return launch<T, 64>(a, stream);
  if (a.c <= 96) return launch<T, 96>(a, stream);
  if (a.c <= 128) return launch<T, 128>(a, stream);
  return cudaErrorInvalidValue;
}

}  // namespace cuda_core

// ---------------------------------------------------------------------------
// Tensor-core route.

namespace tc {

// Three warpgroups give each SM more warps to cover one another's softmax;
// a three-stage ring keeps two tiles in flight; 64-key tiles keep S, O and P
// in registers at one block per SM.
constexpr int kWarpgroups = 3;
constexpr int kThreads = 128 * kWarpgroups;
constexpr int kBM = 64 * kWarpgroups;  // q rows per block
constexpr int kBN = 64;                // keys per K/V tile
constexpr int kStages = 3;             // K/V tiles in the ring

using namespace hopper;

template <int DC>
__global__ void __launch_bounds__(kThreads, 1) pooled_attention_tc_kernel(Args a) {
  constexpr int kGroupBytes = DC / 8 * 128;  // one 8-row group of a tile
  constexpr int kQBytes = kBM * DC * 2;
  constexpr int kKVBytes = kBN * DC * 2;
  extern __shared__ __align__(128) unsigned char tc_smem[];
  const uint32_t sQ = smem_addr(tc_smem);
  const uint32_t sK = sQ + kQBytes;             // kStages K tiles
  const uint32_t sV = sK + kStages * kKVBytes;  // kStages V tiles

  const int wg = threadIdx.x / 128, warp = threadIdx.x % 128 / 32, lane = threadIdx.x % 32;
  const int64_t q0 = (int64_t)blockIdx.x * kBM;
  const int64_t h = blockIdx.y, b = blockIdx.z;
  const bf16* qp = static_cast<const bf16*>(a.q) + b * a.sq[0] + h * a.sq[1];
  const bf16* kp = static_cast<const bf16*>(a.k) + b * a.sk[0] + h * a.sk[1];
  const bf16* vp = static_cast<const bf16*>(a.v) + b * a.sv[0] + h * a.sv[1];
  bf16* op = static_cast<bf16*>(a.out) + b * a.so[0] + h * a.so[1];
  const int n_tiles = (int)((a.Lk + kBN - 1) / kBN);

  // Q with the first K/V tiles in the first group.
  load_tile<DC, kBM, kThreads>(sQ, qp, a.sq[2], q0, a.Lq, a.c);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles) {
      load_tile<DC, kBN, kThreads>(sK + s * kKVBytes, kp, a.sk[2], (int64_t)s * kBN, a.Lk, a.c);
      load_tile<DC, kBN, kThreads>(sV + s * kKVBytes, vp, a.sv[2], (int64_t)s * kBN, a.Lk, a.c);
    }
    cp_async_commit();
  }

  // Accumulator layout of m64nN (per warpgroup): thread (warp, lane) holds
  // rows r0 = 16 * warp + lane / 4 and r0 + 8, columns 8n + 2 (lane % 4)
  // and + 1, as d[4n + 2i + j] for row r0 + 8i, column + j.
  float o[DC / 2];
#pragma unroll
  for (int i = 0; i < DC / 2; ++i) o[i] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  const float scale_log2 = a.scale * kLog2e;
  const uint32_t sQw = sQ + wg * 64 * DC * 2;  // this warpgroup's 64 rows

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<kStages - 2>();  // tile `it` has landed
    fence_async_smem();
    __syncthreads();  // ... for every thread; and every warpgroup is done with tile it - 1
    {
      const int next = it + kStages - 1;  // into the stage tile it - 1 used
      if (next < n_tiles) {
        const int st = next % kStages;
        load_tile<DC, kBN, kThreads>(sK + st * kKVBytes, kp, a.sk[2], (int64_t)next * kBN, a.Lk, a.c);
        load_tile<DC, kBN, kThreads>(sV + st * kKVBytes, vp, a.sv[2], (int64_t)next * kBN, a.Lk, a.c);
      }
      cp_async_commit();
    }
    const uint32_t sKt = sK + (it % kStages) * kKVBytes, sVt = sV + (it % kStages) * kKVBytes;

    // S = Q K^T, reduced over c in steps of 16 (two chunks, 256 bytes).
    float s[kBN / 2];
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) s[i] = 0.0f;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DC / 16; ++kk) {
      wgmma_ss(s, make_desc(sQw + kk * 256, 128, kGroupBytes),
               make_desc(sKt + kk * 256, 128, kGroupBytes), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // Online softmax in the log2 domain; a row's 64 scores lie in one quad.
    // Keys past Lk (in the last tile only) score -inf. Max and sum keep four
    // partials a row, so their dependent chains are 8 long, not 32.
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
    float mx[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int q = 0; q < 4; ++q) mx[i][q] = -INFINITY;
    }
#pragma unroll
    for (int n = 0; n < kBN / 8; ++n) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[4 * n + j] *= scale_log2;
        mx[j / 2][n % 4] = fmaxf(mx[j / 2][n % 4], s[4 * n + j]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float r = fmaxf(fmaxf(mx[i][0], mx[i][1]), fmaxf(mx[i][2], mx[i][3]));
      r = fmaxf(r, __shfl_xor_sync(0xffffffffu, r, 1));
      r = fmaxf(r, __shfl_xor_sync(0xffffffffu, r, 2));
      const float m_new = fmaxf(m[i], r);  // finite: key `it * kBN` is < Lk
      alpha[i] = fast_exp2(m[i] - m_new);
      m[i] = m_new;
    }
    // P as the A fragments of m64n{DC}k16: for keys 16kk .. 16kk + 15,
    // {row r0, row r0 + 8} x {columns 2 (lane % 4) + (0, 1), + 8}. P is
    // carried as two bf16 terms, hi = p with its low 16 bits cut and lo =
    // bf16(p - hi), each a product with V: bf16(p) alone is 2^-9 relative
    // per probability, which at few keys puts the output past the bf16
    // tolerance (the f32 reference's 1e-3 + 2^-7 relative); hi + lo is 2^-16.
    uint32_t p_hi[kBN / 16][4], p_lo[kBN / 16][4];
    float sum[2][4] = {};
#pragma unroll
    for (int n = 0; n < kBN / 8; ++n) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float e0 = fast_exp2(s[4 * n + 2 * i] - m[i]);
        const float e1 = fast_exp2(s[4 * n + 2 * i + 1] - m[i]);
        sum[i][n % 4] += e0 + e1;
        const uint32_t b0 = __float_as_uint(e0), b1 = __float_as_uint(e1);
        p_hi[n / 2][(n % 2) * 2 + i] = __byte_perm(b0, b1, 0x7632);
        p_lo[n / 2][(n % 2) * 2 + i] = pack_bf16(e0 - __uint_as_float(b0 & 0xffff0000u),
                                                 e1 - __uint_as_float(b1 & 0xffff0000u));
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      // a lane's share of the row sum; the quad's are added at the end
      l[i] = l[i] * alpha[i] + ((sum[i][0] + sum[i][1]) + (sum[i][2] + sum[i][3]));
    }
#pragma unroll
    for (int n = 0; n < DC / 8; ++n) {
#pragma unroll
      for (int j = 0; j < 4; ++j) o[4 * n + j] *= alpha[j / 2];
    }

    // O += P V, reduced over the tile's keys in steps of 16 (two 8-key groups).
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      const uint64_t v_desc = make_desc(sVt + kk * 2 * kGroupBytes, kGroupBytes, 128);
      wgmma_rs(o, p_hi[kk], v_desc);
      wgmma_rs(o, p_lo[kk], v_desc);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
  }

  const unsigned char* q_tile = tc_smem;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int r = wg * 64 + 16 * warp + lane / 4 + 8 * i;  // row of the block
    const int64_t row = q0 + r;
    if (row >= a.Lq) continue;
    const float inv = 1.0f / l[i];
#pragma unroll
    for (int n = 0; n < DC / 8; ++n) {
      const int col = 8 * n + 2 * (lane % 4);
      if (col >= a.c) continue;
      float y0 = o[4 * n + 2 * i] * inv, y1 = o[4 * n + 2 * i + 1] * inv;
      if (a.residual) {
        const __nv_bfloat162 qv =
            *reinterpret_cast<const __nv_bfloat162*>(q_tile + tile_offset<DC>(r, col));
        y0 += __low2float(qv);
        y1 += __high2float(qv);
      }
      *reinterpret_cast<__nv_bfloat162*>(op + row * a.so[2] + col) = __floats2bfloat162_rn(y0, y1);
    }
    if (a.lse != nullptr && lane % 4 == 0) {
      a.lse[(b * a.H + h) * a.Lq + row] = (m[i] + log2f(l[i])) * kLn2;
    }
  }
}

// One block per (batch, head, 192 query rows). A small grid (MViT-B's last
// block at B1: 3 x 8 = 24 blocks) leaves most of the 132 SMs idle; that is
// not tuned here.
template <int DC>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr int smem = kBM * DC * 2 + 2 * kStages * kBN * DC * 2;
  cudaError_t err = cudaFuncSetAttribute(pooled_attention_tc_kernel<DC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((a.Lq + kBM - 1) / kBM), (unsigned)a.H, (unsigned)a.B);
  pooled_attention_tc_kernel<DC><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t launch_dc(const Args& a, cudaStream_t stream) {
  if (a.c <= 32) return launch<32>(a, stream);
  if (a.c <= 64) return launch<64>(a, stream);
  if (a.c <= 96) return launch<96>(a, stream);
  return launch<128>(a, stream);
}

}  // namespace tc

// ---------------------------------------------------------------------------
// Split-key route.

namespace split {

constexpr int kMaxRows = 8;      // query rows a call may have
constexpr int kThreads = 128;    // 8 groups of 16 lanes, one split each
constexpr int kGroups = kThreads / 16;
constexpr int kUnroll = 4;       // keys whose loads are in flight together
constexpr int kCombineThreads = 256;

using hopper::load8;

struct SplitArgs {
  Args a;
  float* part_o;  // (B, H, splits, Lq, c) unnormalised output
  float* part_m;  // (B, H, splits, Lq) row max of the split, log2 domain
  float* part_l;  // (B, H, splits, Lq) row sum of exp2(score - max)
  int64_t splits, per_split;
};

// A group of 16 lanes owns split `part % splits` of (batch, head)
// `part / splits`: keys [split * per_split, + per_split) below Lk. Lane i
// holds columns 8i .. 8i + 7 of the R query rows and of each key; a score is
// its 8 products summed over the group by 4 shuffles. Rows past Lq are zero
// queries whose results are not written.
template <int R>
__global__ void __launch_bounds__(kThreads) pooled_attention_split_kernel(SplitArgs sa) {
  const Args& a = sa.a;
  const int lane = threadIdx.x % 16;
  const unsigned group_mask = (threadIdx.x % 32) < 16 ? 0x0000ffffu : 0xffff0000u;
  const int64_t part = (int64_t)blockIdx.x * kGroups + threadIdx.x / 16;
  const bool active = part < a.B * a.H * sa.splits;
  const int64_t bh = part / sa.splits, b = bh / a.H, h = bh % a.H;
  const int64_t k_begin = part % sa.splits * sa.per_split;
  const int64_t k_end = !active ? k_begin : k_begin + sa.per_split < a.Lk ? k_begin + sa.per_split : a.Lk;
  const bool has_cols = active && 8 * lane < a.c;
  const bf16* qp = static_cast<const bf16*>(a.q) + b * a.sq[0] + h * a.sq[1] + 8 * lane;
  const bf16* kp = static_cast<const bf16*>(a.k) + b * a.sk[0] + h * a.sk[1] + 8 * lane;
  const bf16* vp = static_cast<const bf16*>(a.v) + b * a.sv[0] + h * a.sv[1] + 8 * lane;
  const float scale_log2 = a.scale * kLog2e;

  float q[R][8], m[R], l[R], o[R][8];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (has_cols && r < a.Lq) {
      load8(qp + r * a.sq[2], q[r]);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) q[r][e] = 0.0f;
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      q[r][e] *= scale_log2;
      o[r][e] = 0.0f;
    }
    m[r] = -INFINITY;
    l[r] = 0.0f;
  }

  for (int64_t j0 = k_begin; j0 < k_end; j0 += kUnroll) {
    float kx[kUnroll][8], vx[kUnroll][8];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (has_cols && j0 + u < k_end) {
        load8(kp + (j0 + u) * a.sk[2], kx[u]);
        load8(vp + (j0 + u) * a.sv[2], vx[u]);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) kx[u][e] = vx[u][e] = 0.0f;
      }
    }
    float s[R][kUnroll];
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float dot = 0.0f;
#pragma unroll
        for (int e = 0; e < 8; ++e) dot = fmaf(q[r][e], kx[u][e], dot);
#pragma unroll
        for (int off = 8; off > 0; off >>= 1) dot += __shfl_xor_sync(group_mask, dot, off, 16);
        s[r][u] = j0 + u < k_end ? dot : -INFINITY;
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float m_new = m[r];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) m_new = fmaxf(m_new, s[r][u]);  // finite: key j0 < k_end
      const float alpha = exp2f(m[r] - m_new);
      l[r] *= alpha;
#pragma unroll
      for (int e = 0; e < 8; ++e) o[r][e] *= alpha;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const float p = exp2f(s[r][u] - m_new);
        l[r] += p;
#pragma unroll
        for (int e = 0; e < 8; ++e) o[r][e] = fmaf(p, vx[u][e], o[r][e]);
      }
      m[r] = m_new;
    }
  }

  if (!active) return;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (r >= a.Lq) break;
    const int64_t idx = part * a.Lq + r;
    if (lane == 0) {
      sa.part_m[idx] = m[r];
      sa.part_l[idx] = l[r];
    }
    if (has_cols) {
      float4* dst = reinterpret_cast<float4*>(sa.part_o + idx * a.c + 8 * lane);
      dst[0] = make_float4(o[r][0], o[r][1], o[r][2], o[r][3]);
      dst[1] = make_float4(o[r][4], o[r][5], o[r][6], o[r][7]);
    }
  }
}

// One thread per (batch, head, row, column): the splits' partials combined
// in split order, normalised, plus the residual; column 0 writes the lse.
__global__ void __launch_bounds__(kCombineThreads) pooled_attention_combine_kernel(SplitArgs sa) {
  const Args& a = sa.a;
  const int64_t i = (int64_t)blockIdx.x * kCombineThreads + threadIdx.x;
  if (i >= a.B * a.H * a.Lq * a.c) return;
  const int64_t col = i % a.c, row = i / a.c % a.Lq, bh = i / a.c / a.Lq;
  const int64_t b = bh / a.H, h = bh % a.H;
  const int64_t first = bh * sa.splits * a.Lq + row;  // partial of split s: first + s * Lq
  float mx = -INFINITY;
  for (int64_t s = 0; s < sa.splits; ++s) mx = fmaxf(mx, sa.part_m[first + s * a.Lq]);
  float sum = 0.0f, acc = 0.0f;
  for (int64_t s = 0; s < sa.splits; ++s) {
    const int64_t idx = first + s * a.Lq;
    const float w = exp2f(sa.part_m[idx] - mx);
    sum = fmaf(sa.part_l[idx], w, sum);
    acc = fmaf(sa.part_o[idx * a.c + col], w, acc);
  }
  float y = acc / sum;
  if (a.residual) {
    y += __bfloat162float(
        static_cast<const bf16*>(a.q)[b * a.sq[0] + h * a.sq[1] + row * a.sq[2] + col]);
  }
  static_cast<bf16*>(a.out)[b * a.so[0] + h * a.so[1] + row * a.so[2] + col] = __float2bfloat16(y);
  if (a.lse != nullptr && col == 0) a.lse[bh * a.Lq + row] = (mx + log2f(sum)) * kLn2;
}

cudaError_t launch(const SplitArgs& sa, cudaStream_t stream) {
  const Args& a = sa.a;
  const int64_t parts = a.B * a.H * sa.splits;
  const unsigned blocks = (unsigned)((parts + kGroups - 1) / kGroups);
  if (a.Lq == 1) {
    pooled_attention_split_kernel<1><<<blocks, kThreads, 0, stream>>>(sa);
  } else {
    pooled_attention_split_kernel<kMaxRows><<<blocks, kThreads, 0, stream>>>(sa);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t outputs = a.B * a.H * a.Lq * a.c;
  pooled_attention_combine_kernel<<<(unsigned)((outputs + kCombineThreads - 1) / kCombineThreads),
                                    kCombineThreads, 0, stream>>>(sa);
  return cudaGetLastError();
}

}  // namespace split

}  // namespace

// Common arguments: q (B, H, Lq, c) and k, v (B, H, Lk, c) as seen through
// `strides`, 12 int64 (batch, head, row) strides in elements for q, k, v and
// out in that order; the c axis is contiguous. residual != 0 adds q to the
// output. lse: null, or a contiguous (B, H, Lq) float32 buffer for each
// row's log-sum-exp. Each returns cudaGetLastError() after its launches (0
// on success), or cudaErrorInvalidValue for inputs its route does not take.

// The CUDA-core route: c <= 128, Lk >= 1; dtype 0 = float32, 1 = bfloat16.
extern "C" int pvt_pooled_attention(const void* q, const void* k, const void* v, void* out,
                                    float* lse, int64_t B, int64_t H, int64_t Lq, int64_t Lk, int64_t c,
                                    const int64_t* strides, float scale, int residual, int dtype,
                                    void* stream) {
  if (B * H * Lq == 0) return (int)cudaSuccess;
  if (Lk < 1 || c < 1 || H > 65535 || B > 65535 ||
      (Lq + cuda_core::kBQ - 1) / cuda_core::kBQ > 0x7fffffff) {
    return (int)cudaErrorInvalidValue;
  }
  const Args a = make_args(q, k, v, out, lse, B, H, Lq, Lk, c, strides, scale, residual);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)cuda_core::launch_dc<float>(a, s);
  if (dtype == 1) return (int)cuda_core::launch_dc<bf16>(a, s);
  return (int)cudaErrorInvalidValue;
}

// The tensor-core route: bfloat16, 16-byte aligned tensors, strides and c
// multiples of 8, c <= 128, Lk >= 1.
extern "C" int pvt_pooled_attention_tc(const void* q, const void* k, const void* v, void* out,
                                       float* lse, int64_t B, int64_t H, int64_t Lq, int64_t Lk,
                                       int64_t c, const int64_t* strides, float scale, int residual,
                                       void* stream) {
  if (B * H * Lq == 0) return (int)cudaSuccess;
  const Args a = make_args(q, k, v, out, lse, B, H, Lq, Lk, c, strides, scale, residual);
  if (!vector_ready(a) || (Lq + tc::kBM - 1) / tc::kBM > 0x7fffffff) {
    return (int)cudaErrorInvalidValue;
  }
  return (int)tc::launch_dc(a, static_cast<cudaStream_t>(stream));
}

// The split-key route: as the tensor-core route, Lq <= 8; the keys cut into
// `splits` runs of `per_split` (the last may be shorter, none empty).
// `parts`: a 16-byte aligned float32 buffer of B * H * splits * Lq * (c + 2)
// for the partials, the outputs (B, H, splits, Lq, c) first, then the row
// maxima and row sums (B, H, splits, Lq) each.
extern "C" int pvt_pooled_attention_split(const void* q, const void* k, const void* v, void* out,
                                          float* lse, float* parts,
                                          int64_t B, int64_t H, int64_t Lq, int64_t Lk, int64_t c,
                                          const int64_t* strides, float scale, int residual,
                                          int64_t splits, int64_t per_split, void* stream) {
  if (B * H * Lq == 0) return (int)cudaSuccess;
  const Args a = make_args(q, k, v, out, lse, B, H, Lq, Lk, c, strides, scale, residual);
  if (!vector_ready(a) || Lq > split::kMaxRows || splits < 1 || per_split < 1 ||
      splits * per_split < Lk || (splits - 1) * per_split >= Lk ||
      reinterpret_cast<uintptr_t>(parts) % 16 != 0 ||
      (B * H * splits + split::kGroups - 1) / split::kGroups > 0x7fffffff) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t rows = B * H * splits * Lq;
  const split::SplitArgs sa{a, parts, parts + rows * c, parts + rows * (c + 1), splits, per_split};
  return (int)split::launch(sa, static_cast<cudaStream_t>(stream));
}
