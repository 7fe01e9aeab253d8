// Mamba2 SSD chunk scan (forward) on Hopper (sm_90a), plain C interface for
// ctypes (see repro_torch/kernels/build.py and kernels/ssd_scan.py).
//
//   xdt (BH, S, P) = x * dt, la (BH, S) = -A * dt, b and c (G, S, N), all
//   f32, with BH = G * r: head bh reads b[bh / r] and c[bh / r], so the
//   per-batch projections shared by every head of a Mamba2 block are read
//   where they lie, never copied out per head. y (BH, S, P) f32. Per chunk
//   of Q tokens, with cum = cumsum(la) inside the chunk and tot = cum[Q-1]:
//     y     = ((C B^T) o tril(exp(cum_i - cum_j))) X + exp(cum) o (C state)
//     state = exp(tot) * state + (B o exp(tot - cum))^T X
//   with an f32 (N, P) state carried across the chunks, starting at 0.
//   Replaces repro/kernels/ssd_scan.py:ssd_scan.
//
// Bound: per chunk the function needs C B^T once per group (Q^2 N / 2
// FMAs) and, per head, the intra term, the inter term and the state update
// (Q^2 P / 2 + 2 Q N P FMAs), for Q (2P + 1) floats a head and 2 Q N a group
// moved: at hymba-1.5b's shapes (Q 64, N 16, P 50, 64 heads a group) about
// 16 flops a byte, at mamba2-370m's (N 128, P 64, 32 heads) about 68, so it
// sits near the f32 ridge of the card (67 TFLOP/s over 3.35 TB/s = 20).
// This kernel forms C B^T once per head and P slice, which at mamba2's
// shapes is more work than all of the above. What bounds it in practice
// is its sequential chunk loop:
// the TPU's sequential ("arbitrary") chunk grid axis becomes a loop inside
// a block, and each chunk pays its load latency, five block barriers and
// the shared-memory loads and index arithmetic around its FMAs.
//
// Design, one block of 256 threads per (head bh, slice of <= 16 of the P
// columns):
//   * the columns of X, y and the state are independent given the masked
//     decay matrix, so P is split across blocks (4 slices at P 50 or 64):
//     4x the blocks of one block per head (512 at hymba's prefill), at the
//     cost of forming the Q x Q decay matrix once per slice;
//   * the slice's f32 (N, P) state lives in shared memory for the whole
//     sequence;
//   * per chunk, X, B, C and la are staged in shared memory (B and C rows
//     padded to N + 1 floats so a warp reading 32 rows hits 32 banks), and
//     the cumulative log-decay is a warp scan;
//   * each chunk's products are short, so the shared-memory loads and
//     index arithmetic around the FMAs cost as much as the FMAs. Each
//     product works on register tiles: the lower triangle of the masked
//     decay matrix (C B^T) o L in 4 x 4 tiles (8 loads per 16 FMAs), y in
//     4 rows x 1 column (5 loads per 4 FMAs, four independent sums), the
//     state update with B pre-scaled by exp(tot - cum) (2 loads per FMA,
//     four independent sums); the staging loads and the y tiles walk their
//     index ranges with no division inside the chunk loop;
//   * P and N are runtime values (hymba: P 50, N 16; mamba2-370m: P 64,
//     N 128): the tiles cover the actual sizes with bounds checks, so no
//     width is assumed to be a power of two or a multiple of 16;
//   * S % Q == 0 is the caller's job, as in the reference (the model pads).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSlice = 16;          // at most this many P columns a block
constexpr int kMaxSmem = 232448;    // 227 KB a block may opt into on sm_90

__host__ __device__ inline int n_slices(int P) { return (P + kSlice - 1) / kSlice; }
__host__ __device__ inline int slice_width(int P) {
  return (P + n_slices(P) - 1) / n_slices(P);
}

__host__ __device__ inline int smem_floats(int Q, int P, int N) {
  // X (Q x pw), B and C (Q x N+1), the decay-masked scores (Q x Q+1),
  // state (N x pw), cum, exp(cum), exp(tot - cum) (Q each)
  const int pw = slice_width(P);
  return Q * pw + 2 * Q * (N + 1) + Q * (Q + 1) + N * pw + 3 * Q;
}

// A thread's walk over a flat range [0, total) of a (rows x width) array in
// steps of kThreads, as (row, col) pairs, without division in the loop.
struct Walk {
  int width, row0, col0, drow, dcol;
  __device__ explicit Walk(int w)
      : width(w), row0(threadIdx.x / w), col0(threadIdx.x % w),
        drow(kThreads / w), dcol(kThreads % w) {}
  __device__ __forceinline__ void step(int& row, int& col) const {
    row += drow;
    col += dcol;
    if (col >= width) {
      col -= width;
      ++row;
    }
  }
};

__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const float* __restrict__ xdt, const float* __restrict__ la,
                const float* __restrict__ bg, const float* __restrict__ cg,
                float* __restrict__ y, int r, int S, int P, int N, int Q) {
  extern __shared__ float sm[];
  const int pw = slice_width(P);
  const int p0 = blockIdx.y * pw;
  const int W = min(pw, P - p0);    // this block's columns [p0, p0 + W)
  const int NS = N + 1, QS = Q + 1;
  float* sX = sm;                   // Q x W
  float* sB = sX + Q * pw;          // Q x NS; scaled by exp(tot - cum) late
  float* sC = sB + Q * NS;
  float* sLm = sC + Q * NS;         // Q x QS, lower triangle (+ 4x4 diagonal tiles)
  float* sSt = sLm + Q * QS;        // N x W
  float* sCum = sSt + N * pw;
  float* sE = sCum + Q;             // exp(cum_i)
  float* sW = sE + Q;               // exp(tot - cum_j)

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const float* xb = xdt + (int64_t)bh * S * P + p0;
  const float* lb = la + (int64_t)bh * S;
  const float* bb = bg + (int64_t)(bh / r) * S * N;
  const float* cb = cg + (int64_t)(bh / r) * S * N;
  float* yb = y + (int64_t)bh * S * P + p0;

  const int nG = (Q + 3) / 4;        // 4-row groups
  const int nT = nG * (nG + 1) / 2;   // 4 x 4 tiles on or below the diagonal
  const Walk wx(W), wbc(N), wst(W), wy(W);

  for (int idx = tid; idx < N * W; idx += kThreads) sSt[idx] = 0.f;

  for (int s0 = 0; s0 < S; s0 += Q) {
    // stage the chunk
    {
      int i = wx.row0, p = wx.col0;
      for (int idx = tid; idx < Q * W; idx += kThreads, wx.step(i, p))
        sX[idx] = xb[(int64_t)(s0 + i) * P + p];
    }
    {
      int i = wbc.row0, n = wbc.col0;
      for (int idx = tid; idx < Q * N; idx += kThreads, wbc.step(i, n)) {
        sB[i * NS + n] = bb[(int64_t)s0 * N + idx];
        sC[i * NS + n] = cb[(int64_t)s0 * N + idx];
      }
    }
    for (int i = tid; i < Q; i += kThreads) sCum[i] = lb[s0 + i];
    __syncthreads();

    // cum = cumsum(la): warp 0, a contiguous segment per lane, then a
    // shuffle scan of the segment totals
    if (tid < 32) {
      const int seg = (Q + 31) / 32;
      const int lo = tid * seg, hi = min(lo + seg, Q);
      float run = 0.f;
      for (int i = lo; i < hi; ++i) {
        run += sCum[i];
        sCum[i] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float t = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += t;
      }
      const float excl = incl - run;
      for (int i = lo; i < hi; ++i) sCum[i] += excl;
    }
    __syncthreads();

    const float tot = sCum[Q - 1];
    for (int i = tid; i < Q; i += kThreads) {
      sE[i] = expf(sCum[i]);
      sW[i] = expf(tot - sCum[i]);
    }
    // (C B^T) o exp(cum_i - cum_j) on 4 x 4 tiles (gi, gj), gj <= gi;
    // entries above the diagonal (j > i) are 0
    for (int t = tid; t < nT; t += kThreads) {
      int gi = (int)((sqrtf(8.f * t + 1.f) - 1.f) * 0.5f);
      while ((gi + 1) * (gi + 2) / 2 <= t) ++gi;
      while (gi * (gi + 1) / 2 > t) --gi;
      const int gj = t - gi * (gi + 1) / 2;
      float acc[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
      int ci[4], bj[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        ci[a] = min(gi * 4 + a, Q - 1) * NS;
        bj[a] = min(gj * 4 + a, Q - 1) * NS;
      }
      for (int n = 0; n < N; ++n) {
        float cv[4], bv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          cv[a] = sC[ci[a] + n];
          bv[a] = sB[bj[a] + n];
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(cv[a], bv[b], acc[a][b]);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = gi * 4 + a;
        if (i >= Q) continue;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int j = gj * 4 + b;
          if (j >= Q) continue;
          sLm[i * QS + j] =
              j <= i ? acc[a][b] * expf(sCum[i] - sCum[j]) : 0.f;
        }
      }
    }
    __syncthreads();

    // y = Lm X + exp(cum) o (C state), 4 rows x 1 column a thread; B is
    // scaled by exp(tot - cum) for the state update meanwhile
    {
      int g = wy.row0, p = wy.col0;
      for (int t = tid; t < nG * W; t += kThreads, wy.step(g, p)) {
        const int i0 = g * 4;
        const int jn = min(i0 + 4, Q);
        float in[4] = {0.f, 0.f, 0.f, 0.f}, ex[4] = {0.f, 0.f, 0.f, 0.f};
        int li[4], ci[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          li[a] = min(i0 + a, Q - 1) * QS;
          ci[a] = min(i0 + a, Q - 1) * NS;
        }
        for (int j = 0; j < jn; ++j) {
          const float xv = sX[j * W + p];
#pragma unroll
          for (int a = 0; a < 4; ++a) in[a] = fmaf(sLm[li[a] + j], xv, in[a]);
        }
        for (int n = 0; n < N; ++n) {
          const float sv = sSt[n * W + p];
#pragma unroll
          for (int a = 0; a < 4; ++a) ex[a] = fmaf(sC[ci[a] + n], sv, ex[a]);
        }
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int i = i0 + a;
          if (i < Q) yb[(int64_t)(s0 + i) * P + p] = in[a] + sE[i] * ex[a];
        }
      }
    }
    {
      int i = wbc.row0, n = wbc.col0;
      for (int idx = tid; idx < Q * N; idx += kThreads, wbc.step(i, n))
        sB[i * NS + n] *= sW[i];
    }
    __syncthreads();

    // state = exp(tot) state + (B o exp(tot - cum))^T X
    const float decay = expf(tot);
    {
      int n = wst.row0, p = wst.col0;
      for (int idx = tid; idx < N * W; idx += kThreads, wst.step(n, p)) {
        float s0v = 0.f, s1v = 0.f, s2v = 0.f, s3v = 0.f;
        int j = 0;
        for (; j + 4 <= Q; j += 4) {
          s0v = fmaf(sB[j * NS + n], sX[j * W + p], s0v);
          s1v = fmaf(sB[(j + 1) * NS + n], sX[(j + 1) * W + p], s1v);
          s2v = fmaf(sB[(j + 2) * NS + n], sX[(j + 2) * W + p], s2v);
          s3v = fmaf(sB[(j + 3) * NS + n], sX[(j + 3) * W + p], s3v);
        }
        for (; j < Q; ++j) s0v = fmaf(sB[j * NS + n], sX[j * W + p], s0v);
        sSt[idx] = decay * sSt[idx] + ((s0v + s1v) + (s2v + s3v));
      }
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 = launched); cudaErrorInvalidValue for sizes it
// cannot run, among them tiles over the shared memory a block may have.
int ssd_scan_f32(const float* xdt, const float* la, const float* b,
                 const float* c, float* y, int BH, int G, int S, int P, int N,
                 int Q, void* stream) {
  if (BH < 1 || G < 1 || BH % G != 0 || Q < 1 || S < Q || S % Q != 0 ||
      P < 1 || N < 1)
    return (int)cudaErrorInvalidValue;
  const int bytes = smem_floats(Q, P, N) * (int)sizeof(float);
  if (bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        ssd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  dim3 grid(BH, n_slices(P));
  ssd_scan_kernel<<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      xdt, la, b, c, y, BH / G, S, P, N, Q);
  return (int)cudaGetLastError();
}

}  // extern "C"
