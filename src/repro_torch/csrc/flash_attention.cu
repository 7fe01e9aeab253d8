// GQA flash attention (forward) on Hopper (sm_90a), plain C interface for
// ctypes (see repro_torch/kernels/build.py and kernels/flash_attention.py).
//
//   out[b, h, i, :] = sum_j softmax_j(scale * q[b, h, i] . k[b, h / G, j])
//                     * v[b, h / G, j, :]
//   q (B, H, Sq, hd), k and v (B, KV, Sk, hd), H = KV * G, f32 or bf16,
//   hd 64 or 128; out (B, H, Sq, hd) in q's dtype; scale = hd^-0.5.
//   Causal (key j <= query i) and/or a sliding window (j > i - window),
//   positions counted from 0 in both sequences; a masked score is excluded
//   exactly, and a row with no visible key gives 0 (the Pallas kernel's
//   acc / max(l, 1e-30)).
//   Replaces repro/kernels/flash_attention.py:flash_attention.
//
// Bound: at hymba-1.5b's prefill (S 4096, window 1024, hd 64) the work is
// 4 * hd flops per visible (query, key) pair against 2 * hd elements of q
// and out per row, so it is bound by operations, not bytes. This first
// kernel does its arithmetic in f32 on the CUDA cores (67 TFLOP/s peak),
// not on the tensor cores (989 TFLOP/s bf16), so it stays far from the
// bound; wgmma with TMA-fed tiles is the later step.
//
// Design, one block of 256 threads per (64-row q tile, head, batch):
//   * the q tile sits in shared memory as f32; the KV head is h / G,
//     indexed in place, never copied out per head;
//   * the loop over 64-key tiles starts at the window's first tile and
//     stops at the causal frontier, so tiles with no visible key are never
//     read (the Pallas grid visits and masks them);
//   * scores: each thread owns a 4 x 4 register tile (4 query rows, 4 keys
//     strided by 16), two loads per four FMAs; K rows are padded to hd + 1
//     floats so the 16 keys a warp reads sit in 16 banks;
//   * online softmax in f32 per row (m, l in shared memory, four threads a
//     row with warp shuffles), then O += P V with each thread owning 4 rows
//     x hd / 16 columns of the f32 accumulator in registers;
//   * any Sq and Sk: rows and keys past the end of the tile are zero-filled
//     on load, masked in the scores, and not stored.

#include <cstdint>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 256;
constexpr int BQ = 64;              // query rows per block
constexpr int BK = 64;              // keys per tile
constexpr int PS = BK + 1;          // padded row stride of the P tile

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);       // round to nearest even, as torch's .to()
}

template <int HD>
constexpr int smem_floats() {
  // Q (BQ x HD), K (BK x HD+1), V (BK x HD), P (BQ x PS), m, l, alpha (BQ)
  return BQ * HD + BK * (HD + 1) + BK * HD + BQ * PS + 3 * BQ;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int H, int KV,
                 int Sq, int Sk, int causal, int window, float scale) {
  extern __shared__ float sm[];
  float* sQ = sm;
  float* sK = sQ + BQ * HD;
  float* sV = sK + BK * (HD + 1);
  float* sP = sV + BK * HD;
  float* sM = sP + BQ * PS;
  float* sL = sM + BQ;
  float* sA = sL + BQ;

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const T* qb = q + (int64_t)(b * H + h) * Sq * HD;
  const T* kb = k + (int64_t)(b * KV + kvh) * Sk * HD;
  const T* vb = v + (int64_t)(b * KV + kvh) * Sk * HD;
  T* ob = o + (int64_t)(b * H + h) * Sq * HD;

  for (int idx = tid; idx < BQ * HD; idx += kThreads) {
    const int r = idx / HD;
    sQ[idx] = (q0 + r < Sq) ? to_f32(qb[(int64_t)q0 * HD + idx]) : 0.f;
  }
  if (tid < BQ) {
    sM[tid] = -1e30f;
    sL[tid] = 0.f;
  }

  // keys any row of this tile can see: [k_lo, k_hi)
  const int q_last = min(q0 + BQ, Sq) - 1;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_hi = causal ? min(Sk, q_last + 1) : Sk;

  const int ty = tid / 16;          // rows ty*4 .. ty*4+3 (scores, P V)
  const int tx = tid % 16;          // keys / columns tx + 16 c
  constexpr int NC = HD / 16;
  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;

  for (int kt = (k_lo / BK) * BK; kt < k_hi; kt += BK) {
    __syncthreads();                // the previous tile's readers are done
    for (int idx = tid; idx < BK * HD; idx += kThreads) {
      const int r = idx / HD, d = idx % HD;
      const bool in = kt + r < Sk;
      const int64_t g = (int64_t)kt * HD + idx;
      sK[r * (HD + 1) + d] = in ? to_f32(kb[g]) : 0.f;
      sV[idx] = in ? to_f32(vb[g]) : 0.f;
    }
    __syncthreads();

    // scores S = scale * Q K^T for this thread's 4 x 4 tile, masked
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = 0.f;
#pragma unroll 16
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(ty * 4 + i) * HD + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) kv[c] = sK[(tx + 16 * c) * (HD + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[i][c] = fmaf(qv[i], kv[c], s[i][c]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty * 4 + i;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kp = kt + tx + 16 * c;
        bool vis = kp < Sk;
        if (causal) vis = vis && kp <= qp;
        if (window > 0) vis = vis && kp > qp - window;
        // -inf drops the entry from the row max and gives exp() = 0
        sP[(ty * 4 + i) * PS + tx + 16 * c] = vis ? s[i][c] * scale : -INFINITY;
      }
    }
    __syncthreads();

    // online softmax: four threads per row, 16 entries each
    {
      const int r = tid >> 2, t = tid & 3;
      float* row = sP + r * PS + t * 16;
      float mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < 16; ++i) mx = fmaxf(mx, row[i]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = sM[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const float p = expf(row[i] - m_new);
        row[i] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      __syncwarp();
      if (t == 0) {
        const float alpha = expf(m_prev - m_new);
        sA[r] = alpha;
        sL[r] = alpha * sL[r] + sum;
        sM[r] = m_new;
      }
    }
    __syncthreads();

    // O = alpha * O + P V
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = sA[ty * 4 + i];
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= a;
    }
#pragma unroll 8
    for (int j = 0; j < BK; ++j) {
      float pv[4], vv[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sP[(ty * 4 + i) * PS + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) vv[c] = sV[j * HD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }
  __syncthreads();                  // l is final (or still 0: no tile ran)

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (q0 + r >= Sq) continue;
    const float l = fmaxf(sL[r], 1e-30f);
    T* dst = ob + (int64_t)(q0 + r) * HD;
#pragma unroll
    for (int c = 0; c < NC; ++c) dst[tx + 16 * c] = from_f32<T>(acc[i][c] / l);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H,
           int KV, int Sq, int Sk, int causal, int window, float scale,
           cudaStream_t stream) {
  constexpr int bytes = smem_floats<HD>() * (int)sizeof(float);
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T, HD><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, KV, Sq, Sk, causal,
      window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = launched).
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int dtype, int B, int H, int KV, int Sq, int Sk,
                        int hd, int causal, int window, float scale,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || KV < 1 || H % KV != 0 || Sq < 1 || Sk < 1 || window < 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0 && hd == 64)
    return launch<float, 64>(q, k, v, o, B, H, KV, Sq, Sk, causal, window, scale, s);
  if (dtype == 0 && hd == 128)
    return launch<float, 128>(q, k, v, o, B, H, KV, Sq, Sk, causal, window, scale, s);
  if (dtype == 1 && hd == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, o, B, H, KV, Sq, Sk, causal, window, scale, s);
  if (dtype == 1 && hd == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, o, B, H, KV, Sq, Sk, causal, window, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
