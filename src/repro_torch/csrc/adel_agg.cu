// ADEL-FL's Eq. 5 layer-wise fold on Hopper (sm_90a), plain C interface
// for ctypes (see repro_torch/kernels/build.py and kernels/adel_agg.py).
//
//   adel_agg:    out[l, f] = sum_u coeff[u, l] * grads[u, l, f]
//                grads (U, L, F) f32 or bf16, coeff (U, L) f32,
//                out (L, F) in the grads dtype, f32 accumulation.
//                Replaces repro/kernels/adel_agg.py:adel_agg.
//   adel_agg_q8: out[l, f] = sum_u coeff[u, l] * scales[u, l] * q[u, l, f]
//                q (U, L, F) int8, scales and coeff (U, L) f32,
//                out (L, F) f32. Replaces repro/kernels/adel_agg.py:adel_agg_q8.
//
// Bound: both are memory-bound reductions (2 flops per element read). On an
// H100 SXM (3.35 TB/s) adel_agg moves U*L*F*sizeof(T) + L*F*sizeof(T) bytes
// and adel_agg_q8 moves U*L*F + 4*L*F bytes; the arithmetic is ~1/4 flop
// per byte, far below the card's ridge point. The design therefore only has
// to stream every input byte once, coalesced:
//   * grid (ceil(F / (threads * VEC)), L): each thread owns VEC adjacent
//     features of one layer and walks u = 0..U-1 with 16-byte loads
//     (4 f32, 8 bf16 or 16 int8), neighbouring threads on neighbouring
//     addresses, accumulating in f32 registers; the output is written once;
//   * the block's (U,) weight column (coeff, or coeff * scale for int8) is
//     staged in shared memory once, so the inner loop reads no (U, L) table
//     from device memory;
//   * the ragged edge of F is masked in the kernel (no padding copy); rows
//     whose byte length is not a multiple of 16 take the scalar path.
// The TPU kernel's (U, block_f) MXU matvec is not carried over: a
// contraction over U <= a few dozen is bandwidth, not matrix-unit, work.

#include <cstdint>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);   // round to nearest even, as torch's .to(bfloat16)
}

// One 16-byte vector of T.
template <typename T>
struct alignas(16) Vec {
  static constexpr int N = 16 / sizeof(T);
  T v[N];
};

// Stage the block's weight column w[u] = coeff[u, l] (* scales[u, l]).
__device__ __forceinline__ void load_weights(float* w, const float* coeff,
                                             const float* scales, int U, int L,
                                             int l) {
  for (int u = threadIdx.x; u < U; u += blockDim.x) {
    float c = coeff[(int64_t)u * L + l];
    w[u] = scales ? c * scales[(int64_t)u * L + l] : c;
  }
  __syncthreads();
}

// TIn: input element type, TOut: output type. VECTOR: 16-byte path (every
// row start is 16-byte aligned); otherwise one element per thread.
template <typename TIn, typename TOut, bool VECTOR>
__global__ void __launch_bounds__(kThreads)
fold_kernel(const TIn* __restrict__ x, const float* __restrict__ coeff,
            const float* __restrict__ scales, TOut* __restrict__ out,
            int U, int L, int64_t F) {
  extern __shared__ float w[];
  const int l = blockIdx.y;
  load_weights(w, coeff, scales, U, L, l);
  constexpr int V = VECTOR ? Vec<TIn>::N : 1;
  const int64_t f0 = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) * V;
  if (f0 >= F) return;
  const int64_t row = (int64_t)L * F;            // stride between clients
  const TIn* src = x + (int64_t)l * F + f0;
  TOut* dst = out + (int64_t)l * F + f0;

  if (VECTOR && f0 + V <= F) {
    float acc[V];
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = 0.f;
    for (int u = 0; u < U; ++u) {
      const Vec<TIn> v = *reinterpret_cast<const Vec<TIn>*>(src + u * row);
      const float wu = w[u];
#pragma unroll
      for (int i = 0; i < V; ++i) acc[i] = fmaf(wu, to_f32(v.v[i]), acc[i]);
    }
    // V outputs = V * sizeof(TOut) bytes, stored as 16-byte vectors
    struct alignas(16) { TOut v[V]; } res;
#pragma unroll
    for (int i = 0; i < V; ++i) res.v[i] = from_f32<TOut>(acc[i]);
    constexpr int NV = V * (int)sizeof(TOut) / 16;
    const uint4* rs = reinterpret_cast<const uint4*>(res.v);
    uint4* d = reinterpret_cast<uint4*>(dst);
#pragma unroll
    for (int k = 0; k < NV; ++k) d[k] = rs[k];
    return;
  }
  // scalar path: unaligned rows, or the ragged tail of a vector row
  const int n = (int)((F - f0) < V ? (F - f0) : V);
  for (int i = 0; i < n; ++i) {
    float acc = 0.f;
    for (int u = 0; u < U; ++u) acc = fmaf(w[u], to_f32(src[u * row + i]), acc);
    dst[i] = from_f32<TOut>(acc);
  }
}

template <typename TIn, typename TOut>
int launch(const void* x, const void* coeff, const void* scales, void* out,
           int U, int L, int64_t F, void* stream) {
  constexpr int VN = 16 / sizeof(TIn);
  const bool vector = (F % VN == 0) &&
                      (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                      (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  const int per_block = kThreads * (vector ? VN : 1);
  dim3 grid((unsigned)((F + per_block - 1) / per_block), (unsigned)L);
  const size_t smem = sizeof(float) * (size_t)U;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const TIn* xi = static_cast<const TIn*>(x);
  const float* c = static_cast<const float*>(coeff);
  const float* sc = static_cast<const float*>(scales);
  TOut* o = static_cast<TOut*>(out);
  if (vector)
    fold_kernel<TIn, TOut, true><<<grid, kThreads, smem, s>>>(xi, c, sc, o, U, L, F);
  else
    fold_kernel<TIn, TOut, false><<<grid, kThreads, smem, s>>>(xi, c, sc, o, U, L, F);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int adel_agg_f32(const void* grads, const void* coeff, void* out, int U, int L,
                 long long F, void* stream) {
  return launch<float, float>(grads, coeff, nullptr, out, U, L, F, stream);
}

int adel_agg_bf16(const void* grads, const void* coeff, void* out, int U, int L,
                  long long F, void* stream) {
  return launch<__nv_bfloat16, __nv_bfloat16>(grads, coeff, nullptr, out, U, L,
                                              F, stream);
}

int adel_agg_q8(const void* q, const void* scales, const void* coeff, void* out,
                int U, int L, long long F, void* stream) {
  return launch<int8_t, float>(q, coeff, scales, out, U, L, F, stream);
}

}  // extern "C"
