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
//
// adel_agg_grouped folds every leaf of one dtype of a round in one launch
// (fold_grouped_kernel; the per-leaf fold_kernel above stays the entry of
// adel_agg and adel_agg_q8):
//   * the leaf table (pointers, sizes, layer ids, each leaf's first block)
//     is a __grid_constant__ kernel parameter, filled on the host and
//     copied with the launch: no host-to-device copy a round. A table holds
//     kMaxLeaves leaves (3,608 bytes of the 4 KB of parameters); a pytree
//     with more leaves takes one launch per kMaxLeaves;
//   * block b finds its leaf by a binary search of the leaves' first blocks
//     (a prefix sum of L_leaf x feature tiles, computed on the host), then
//     its (row, feature tile); a tile is kThreads x kVecs 16-byte vectors;
//   * each leaf's weights are read straight from the (U, L) coefficient
//     matrix through its layer ids (a scalar id0 + row, or an (L_leaf,)
//     int32 vector on the device): no per-leaf gather of coefficient rows;
//   * a thread owns kVecs vectors of a row and walks the clients kUnroll at
//     a time, so kVecs * kUnroll 16-byte loads are in flight before its
//     first FMA; f32 sums stay in registers; rows that are not 16-byte
//     aligned, or whose length is not a multiple of the vector, take the
//     scalar path (kVecs * VN elements a thread, neighbouring threads on
//     neighbouring elements).
//
// adel_agg_q8_grouped folds every int8 leaf of a compressed round in one
// launch (fold_grouped_q8_kernel; adel_agg_q8's per-leaf fold_kernel stays
// the single-tensor entry). It is the grouped fold above with the int8
// wire format:
//   * a table entry is a FoldLeaf plus the leaf's (U, rows) f32 scales;
//     at 64 bytes an entry, kMaxLeavesQ8 = 63 leaves fill the 4 KB of
//     kernel parameters (checked at build time);
//   * the weight of client u for row r is coeff[u, id(r)] * scales[u, r],
//     formed in f32 as the TPU kernel's _kernel_q8 forms c * s;
//   * a 16-byte load brings 16 int8 codes; each becomes f32 exactly by a
//     byte permute into the mantissa of 2^23 and one subtraction
//     (unpack_q8), not by the quarter-rate I2F conversion; a thread owns
//     kVecsQ8 = 1 such vector (a 4,096-code tile a block; on an H100 two
//     vectors took 114-122 registers and a VGG-11 round 36-39% longer)
//     and loads kUnroll clients ahead; its f32 sums stay in registers;
//   * each vector writes 64 bytes of f32; a warp stages its 2 KB through
//     shared memory and stores it coalesced (on an H100 a VGG-11 round
//     takes 14-16% less time than with four 16-byte stores a lane, 64 bytes
//     apart; scripts/probe_fold_q8.py times both);
//   * the bytes are small (a VGG-11 round: 97.6 MB of codes, 39.0 MB of
//     f32 out), so what one launch a round saves is the 38 launches' gaps
//     and partly idle blocks of the small leaves.

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

// ---------------------------------------------------------------------------
// the grouped fold
// ---------------------------------------------------------------------------

constexpr int kMaxLeaves = 64;   // leaves one launch's table holds
constexpr int kVecs = 2;         // 16-byte vectors a thread owns in a row
constexpr int kUnroll = 4;       // clients a thread loads ahead

// One leaf of the table; the layout is mirrored by _FoldLeaf in
// kernels/adel_agg.py (adel_agg_grouped_table_bytes checks the size).
struct FoldLeaf {
  const void* x;       // (U, rows, F), contiguous
  void* out;           // (rows, F)
  const int* ids;      // (rows,) layer ids on the device, or null: id0 + row
  long long F;
  long long tile0;     // the leaf's first block
  int tiles;           // feature tiles a row
  int id0;
  int rows;
  int vec;             // 1: x and out 16-byte aligned and F % VN == 0
};

// One int8 leaf: x is (U, rows, F) int8, out (rows, F) f32. Mirrored by
// _FoldQ8Leaf in kernels/adel_agg.py.
struct FoldQ8Leaf {
  FoldLeaf leaf;
  const float* scales; // (U, rows) f32, contiguous
};

__device__ __forceinline__ const FoldLeaf& base(const FoldLeaf& l) { return l; }
__device__ __forceinline__ const FoldLeaf& base(const FoldQ8Leaf& l) { return l.leaf; }

template <typename Leaf, int N>
struct Table {
  static constexpr int kLeaves = N;
  const float* coeff;  // (U, L) f32, contiguous
  int U, L, n, pad;
  Leaf leaf[N];
};

constexpr int kMaxLeavesQ8 = 63;  // int8 leaves one launch's table holds
using FoldTable = Table<FoldLeaf, kMaxLeaves>;
using FoldQ8Table = Table<FoldQ8Leaf, kMaxLeavesQ8>;
static_assert(sizeof(FoldTable) <= 4096 && sizeof(FoldQ8Table) <= 4096,
              "a leaf table must fit in the 4 KB of kernel parameters");

// The leaf of block b: the last whose first block is <= b.
template <typename Tab>
__device__ __forceinline__ int find_leaf(const Tab& t, long long b) {
  int lo = 0, hi = t.n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (base(t.leaf[mid]).tile0 <= b) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

__device__ __forceinline__ void unpack16(const uint4 r, float* f, float) {
  f[0] = __uint_as_float(r.x);
  f[1] = __uint_as_float(r.y);
  f[2] = __uint_as_float(r.z);
  f[3] = __uint_as_float(r.w);
}

__device__ __forceinline__ void unpack16(const uint4 r, float* f, __nv_bfloat16) {
  const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    f[2 * k] = __uint_as_float(w[k] << 16);          // the lower half is first
    f[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint4 pack16(const float* f, float) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                    __float_as_uint(f[2]), __float_as_uint(f[3]));
}

__device__ __forceinline__ unsigned bf16_bits(float x) {
  return (unsigned)__bfloat16_as_ushort(__float2bfloat16(x));
}

__device__ __forceinline__ uint4 pack16(const float* f, __nv_bfloat16) {
  unsigned w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    w[k] = bf16_bits(f[2 * k]) | (bf16_bits(f[2 * k + 1]) << 16);
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fold_grouped_kernel(const __grid_constant__ FoldTable t) {
  const long long b = blockIdx.x;
  const FoldLeaf& lf = t.leaf[find_leaf(t, b)];
  const long long local = b - lf.tile0;
  const int row = (int)(local / lf.tiles);
  constexpr int VN = 16 / (int)sizeof(T);
  constexpr int E = kVecs * VN;                 // elements a thread owns
  const long long F = lf.F;
  const long long f0 = (local - (long long)row * lf.tiles) * (kThreads * E);
  const long long cstride = (long long)lf.rows * F;   // between clients
  const T* src = static_cast<const T*>(lf.x) + (long long)row * F;
  T* dst = static_cast<T*>(lf.out) + (long long)row * F;
  const float* w = t.coeff + (lf.ids ? lf.ids[row] : lf.id0 + row);
  const int U = t.U;
  const long long L = t.L;

  if (lf.vec) {
    // vector k of this thread starts at feature f0 + (k * kThreads + tid) * VN;
    // F % VN == 0, so a vector lies wholly inside or wholly past the row
    long long f[kVecs];
    bool in[kVecs];
#pragma unroll
    for (int k = 0; k < kVecs; ++k) {
      f[k] = f0 + ((long long)k * kThreads + threadIdx.x) * VN;
      in[k] = f[k] < F;
    }
    if (!in[0]) return;
    float acc[kVecs][VN];
#pragma unroll
    for (int k = 0; k < kVecs; ++k)
#pragma unroll
      for (int i = 0; i < VN; ++i) acc[k][i] = 0.f;
    int u = 0;
    for (; u + kUnroll <= U; u += kUnroll) {
      uint4 v[kUnroll][kVecs];
      float wu[kUnroll];
#pragma unroll
      for (int a = 0; a < kUnroll; ++a) {
        wu[a] = __ldg(w + (u + a) * L);
#pragma unroll
        for (int k = 0; k < kVecs; ++k)
          v[a][k] = in[k] ? __ldg(reinterpret_cast<const uint4*>(
                                src + (u + a) * cstride + f[k]))
                          : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int a = 0; a < kUnroll; ++a)
#pragma unroll
        for (int k = 0; k < kVecs; ++k) {
          float x[VN];
          unpack16(v[a][k], x, T());
#pragma unroll
          for (int i = 0; i < VN; ++i) acc[k][i] = fmaf(wu[a], x[i], acc[k][i]);
        }
    }
    for (; u < U; ++u) {
      const float wu = __ldg(w + u * L);
#pragma unroll
      for (int k = 0; k < kVecs; ++k) {
        if (!in[k]) continue;
        float x[VN];
        unpack16(__ldg(reinterpret_cast<const uint4*>(src + u * cstride + f[k])),
                 x, T());
#pragma unroll
        for (int i = 0; i < VN; ++i) acc[k][i] = fmaf(wu, x[i], acc[k][i]);
      }
    }
#pragma unroll
    for (int k = 0; k < kVecs; ++k)
      if (in[k]) *reinterpret_cast<uint4*>(dst + f[k]) = pack16(acc[k], T());
    return;
  }
  // scalar path: element k of this thread is f0 + k * kThreads + tid
  float acc[E];
#pragma unroll
  for (int k = 0; k < E; ++k) acc[k] = 0.f;
  for (int u = 0; u < U; ++u) {
    const float wu = __ldg(w + u * L);
    const T* s = src + u * cstride;
#pragma unroll
    for (int k = 0; k < E; ++k) {
      const long long f = f0 + (long long)k * kThreads + threadIdx.x;
      if (f < F) acc[k] = fmaf(wu, to_f32(s[f]), acc[k]);
    }
  }
#pragma unroll
  for (int k = 0; k < E; ++k) {
    const long long f = f0 + (long long)k * kThreads + threadIdx.x;
    if (f < F) dst[f] = from_f32<T>(acc[k]);
  }
}

// ---------------------------------------------------------------------------
// the grouped int8 fold
// ---------------------------------------------------------------------------

constexpr int kVecsQ8 = 1;       // 16-int8 vectors a thread owns in a row

// 16 int8 codes -> f32, exactly: code c, biased to c + 128 (the sign bit
// flipped), is permuted into the low byte of 0x4B000000 = 2^23, whose
// mantissa then holds it, and 2^23 + 128 is subtracted.
__device__ __forceinline__ void unpack_q8(const uint4 r, float* f) {
  const unsigned w[4] = {r.x ^ 0x80808080u, r.y ^ 0x80808080u,
                         r.z ^ 0x80808080u, r.w ^ 0x80808080u};
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      f[4 * k + j] = __uint_as_float(__byte_perm(w[k], 0x4B000000u,
                                                 0x7440u + j)) - 8388736.f;
}

__global__ void __launch_bounds__(kThreads)
fold_grouped_q8_kernel(const __grid_constant__ FoldQ8Table t) {
  const long long b = blockIdx.x;
  const FoldQ8Leaf& lq = t.leaf[find_leaf(t, b)];
  const FoldLeaf& lf = lq.leaf;
  const long long local = b - lf.tile0;
  const int row = (int)(local / lf.tiles);
  constexpr int VN = 16;
  constexpr int E = kVecsQ8 * VN;              // codes a thread owns
  const long long F = lf.F;
  const long long f0 = (local - (long long)row * lf.tiles) * (kThreads * E);
  const long long cstride = (long long)lf.rows * F;   // between clients
  const int8_t* src = static_cast<const int8_t*>(lf.x) + (long long)row * F;
  float* dst = static_cast<float*>(lf.out) + (long long)row * F;
  // weight of client u: coeff[u, id] * scales[u, row]
  const float* cw = t.coeff + (lf.ids ? lf.ids[row] : lf.id0 + row);
  const float* sw = lq.scales + row;
  const int U = t.U;
  const long long L = t.L, rows = lf.rows;

  if (lf.vec) {
    // vector k of this thread starts at code f0 + (k * kThreads + tid) * 16;
    // F % 16 == 0, so a vector lies wholly inside or wholly past the row
    long long f[kVecsQ8];
    bool in[kVecsQ8];
#pragma unroll
    for (int k = 0; k < kVecsQ8; ++k) {
      f[k] = f0 + ((long long)k * kThreads + threadIdx.x) * VN;
      in[k] = f[k] < F;
    }
    if (!in[0]) return;
    float acc[kVecsQ8][VN];
#pragma unroll
    for (int k = 0; k < kVecsQ8; ++k)
#pragma unroll
      for (int i = 0; i < VN; ++i) acc[k][i] = 0.f;
    int u = 0;
    for (; u + kUnroll <= U; u += kUnroll) {
      uint4 v[kUnroll][kVecsQ8];
      float wu[kUnroll];
#pragma unroll
      for (int a = 0; a < kUnroll; ++a) {
        wu[a] = __ldg(cw + (u + a) * L) * __ldg(sw + (u + a) * rows);
#pragma unroll
        for (int k = 0; k < kVecsQ8; ++k)
          v[a][k] = in[k] ? __ldg(reinterpret_cast<const uint4*>(
                                src + (u + a) * cstride + f[k]))
                          : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int a = 0; a < kUnroll; ++a)
#pragma unroll
        for (int k = 0; k < kVecsQ8; ++k) {
          float x[VN];
          unpack_q8(v[a][k], x);
#pragma unroll
          for (int i = 0; i < VN; ++i) acc[k][i] = fmaf(wu[a], x[i], acc[k][i]);
        }
    }
    for (; u < U; ++u) {
      const float wu = __ldg(cw + u * L) * __ldg(sw + u * rows);
#pragma unroll
      for (int k = 0; k < kVecsQ8; ++k) {
        if (!in[k]) continue;
        float x[VN];
        unpack_q8(__ldg(reinterpret_cast<const uint4*>(src + u * cstride + f[k])),
                  x);
#pragma unroll
        for (int i = 0; i < VN; ++i) acc[k][i] = fmaf(wu, x[i], acc[k][i]);
      }
    }
    // a vector's 16 sums are 64 bytes of f32; stored from registers, lanes
    // 64 bytes apart would each write a quarter of a warp's 2 KB span per
    // 16-byte store. A warp whose 32 vectors lie wholly inside the row
    // stages them through shared memory (swizzled: no bank conflicts on
    // either side) and stores the 2 KB as four coalesced 512-byte rows.
    __shared__ uint4 stage[kThreads / 32][32 * VN / 4];
    uint4* st = stage[threadIdx.x >> 5];
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int k = 0; k < kVecsQ8; ++k) {
      if (!in[k]) continue;
      uint4* d = reinterpret_cast<uint4*>(dst + f[k]);
      if (f0 + ((long long)k * kThreads + (threadIdx.x | 31) + 1) * VN <= F) {
#pragma unroll
        for (int j = 0; j < VN / 4; ++j)
          st[lane * 4 + ((j + (lane >> 1)) & 3)] = pack16(acc[k] + 4 * j, float());
        __syncwarp();
        uint4* dw = d - lane * (VN / 4);            // the warp's first vector
#pragma unroll
        for (int i = 0; i < VN / 4; ++i) {
          const int m = i * 32 + lane;              // from lane m / 4
          dw[m] = st[(m & ~3) + (((m & 3) + (m >> 3)) & 3)];
        }
        __syncwarp();
        continue;
      }
#pragma unroll
      for (int j = 0; j < VN / 4; ++j) d[j] = pack16(acc[k] + 4 * j, float());
    }
    return;
  }
  // scalar path: code k of this thread is f0 + k * kThreads + tid
  float acc[E];
#pragma unroll
  for (int k = 0; k < E; ++k) acc[k] = 0.f;
  for (int u = 0; u < U; ++u) {
    const float wu = __ldg(cw + u * L) * __ldg(sw + u * rows);
    const int8_t* s = src + u * cstride;
#pragma unroll
    for (int k = 0; k < E; ++k) {
      const long long f = f0 + (long long)k * kThreads + threadIdx.x;
      if (f < F) acc[k] = fmaf(wu, to_f32(s[f]), acc[k]);
    }
  }
#pragma unroll
  for (int k = 0; k < E; ++k) {
    const long long f = f0 + (long long)k * kThreads + threadIdx.x;
    if (f < F) dst[f] = acc[k];
  }
}

// One launch over a table, or cudaErrorInvalidValue for a table the kernel
// does not take.
template <typename Tab>
int launch_table(void (*kernel)(const Tab), const Tab* table,
                 long long blocks, void* stream) {
  if (table->n < 1 || table->n > Tab::kLeaves || blocks < 1 ||
      blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(*table);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The grouped fold of kernels/adel_agg.py:adel_agg_grouped: one launch over
// a table of leaves of one dtype; returns a cudaError_t (0 = launched).
int adel_agg_grouped_f32(const void* table, long long blocks, void* stream) {
  return launch_table(fold_grouped_kernel<float>,
                      static_cast<const FoldTable*>(table), blocks, stream);
}

int adel_agg_grouped_bf16(const void* table, long long blocks, void* stream) {
  return launch_table(fold_grouped_kernel<__nv_bfloat16>,
                      static_cast<const FoldTable*>(table), blocks, stream);
}

// sizeof(FoldTable), kMaxLeaves and the elements of a feature tile (f32,
// bf16), for the wrapper to check its mirror of the table against.
long long adel_agg_grouped_table_bytes() { return (long long)sizeof(FoldTable); }
int adel_agg_grouped_max_leaves() { return kMaxLeaves; }
int adel_agg_grouped_tile(int itemsize) { return kThreads * kVecs * (16 / itemsize); }

// The grouped int8 fold of kernels/adel_agg.py:adel_agg_q8_grouped, and
// its table's size, leaves and feature tile (int8 codes a block folds).
int adel_agg_q8_grouped(const void* table, long long blocks, void* stream) {
  return launch_table(fold_grouped_q8_kernel,
                      static_cast<const FoldQ8Table*>(table), blocks, stream);
}

long long adel_agg_q8_grouped_table_bytes() { return (long long)sizeof(FoldQ8Table); }
int adel_agg_q8_grouped_max_leaves() { return kMaxLeavesQ8; }
int adel_agg_q8_grouped_tile() { return kThreads * kVecsQ8 * 16; }


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
