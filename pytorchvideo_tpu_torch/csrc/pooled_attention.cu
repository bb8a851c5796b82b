// Pooled multi-head attention, softmax(q k^T * scale) v (+ q), for sm_90a (H100).
//
// One kernel replaces two TPU kernels of pytorchvideo_tpu/ops/pooled_attention.py:
// `_packed_pallas_local` (body `_attention_kernel_packed`), MViT's default
// head-packed path, and `_pooled_attention_pallas_local` (body
// `_attention_kernel`), the per-head path of `pool_first`. The layouts differ
// only in strides, so the caller passes a (batch, head, row) stride triple per
// tensor: head-packed (B, L, H*c) is (L*H*c, c, H*c), per-head (B, H, L, c) is
// (H*L*c, L*c, c). The last axis (c) is contiguous.
//
// MViT's attention is tall and skinny: Lq up to 50,176 query rows against
// Lk up to 3,137 pooled keys, c = 96. The TPU kernel holds all of K and V in
// VMEM; here they do not fit in shared memory (k + v of MViT-B 16x4 block 14
// at H*c 768 are 4.8 MB in bf16), so each block owns one (b, head, 64-row
// q tile) and streams K and V through shared memory in 64-row tiles with an
// online softmax (running row max and sum, rescaled output). Nothing of size
// (Lq, Lk) reaches device memory.
//
// Arithmetic is float32 throughout (inputs f32 or bf16, converted on load;
// scores, probabilities, sums and the output accumulator in f32; the +q
// residual in f32); the output is rounded once to the input type. In
// training the caller also passes `lse`, (B, H, Lq) float32, and each row's
// log-sum-exp of its scaled scores lands there for the backward
// (csrc/pooled_attention_bwd.cu); the deploy path passes null. Keys past
// Lk score -inf; head-dim columns past c are zero in shared memory, so any
// c <= 128 (96 included) needs no padded copy of the tensors.
//
// What bounds it on this card: operations. MViT-B 16x4 block 0 at B32 does
// 121 GFLOP against 0.42 GB of q, k, v and out (0.12 ms at 989 TFLOP/s bf16).
// This first version runs on the CUDA cores in f32 (67 TFLOP/s peak), not on
// the tensor cores, so it cannot come near that bound; wgmma tiles with TMA
// loads are the next version.
//
// Work split (128 threads, 64 q rows x 64 keys a tile): thread (ty, tx) =
// (tid / 16, tid % 16) owns q rows 8*ty .. 8*ty + 7; for the scores it owns
// keys tx + 16*j (j < 4), for the output head-dim columns tx + 16*j
// (j < DC/16). The 16 threads of a row group are a half-warp, so row max and
// row sum are four shuffles. Shared-memory rows are padded by one float so
// the strided reads of the 16 key rows fall in distinct banks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kBQ = 64;  // q rows per block
constexpr int kBK = 64;  // keys per streamed tile
constexpr int kRows = 8;  // q rows per thread
constexpr int kCols = kBK / 16;  // score columns per thread

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
  // Threads whose rows all lie past Lq (an Lq = 1 cls query uses one row
  // group) skip the products but keep the shuffles and barriers.
  const bool active = q0 + ty * kRows < a.Lq;
  const float scale_log2 = a.scale * 1.4426950408889634f;  // exp(x) = exp2(x * log2 e)

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
      a.lse[(b * a.H + h) * a.Lq + q0 + r] = (m[i] + log2f(l[i])) * 0.6931471805599453f;
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

}  // namespace

// q: (B, H, Lq, c) and k, v: (B, H, Lk, c) as seen through `strides`, 12
// int64 (batch, head, row) strides in elements for q, k, v and out in that
// order; the c axis is contiguous. c <= 128, Lk >= 1. dtype: 0 = float32,
// 1 = bfloat16. residual != 0 adds q to the output. lse: null, or a
// contiguous (B, H, Lq) float32 buffer for each row's log-sum-exp.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int pvt_pooled_attention(const void* q, const void* k, const void* v, void* out,
                                    float* lse, int64_t B, int64_t H, int64_t Lq, int64_t Lk, int64_t c,
                                    const int64_t* strides, float scale, int residual, int dtype,
                                    void* stream) {
  if (B * H * Lq == 0) return (int)cudaSuccess;
  if (Lk < 1 || c < 1 || H > 65535 || B > 65535 || (Lq + kBQ - 1) / kBQ > 0x7fffffff) {
    return (int)cudaErrorInvalidValue;
  }
  Args a{q, k, v, out, lse, B, H, Lq, Lk, c, {}, {}, {}, {}, scale, residual};
  for (int i = 0; i < 3; ++i) {
    a.sq[i] = strides[i];
    a.sk[i] = strides[3 + i];
    a.sv[i] = strides[6 + i];
    a.so[i] = strides[9 + i];
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_dc<float>(a, s);
  if (dtype == 1) return (int)launch_dc<__nv_bfloat16>(a, s);
  return (int)cudaErrorInvalidValue;
}
