// Mamba2 SSD chunk scan (forward) on Hopper (sm_90a), plain C interface for
// ctypes (see repro_torch/kernels/build.py and kernels/ssd_scan.py).
//
//   xdt (G, r, S, P) = x * dt and la (G, r, S) = -A * dt, read through
//   element strides of (group, head, token) with P unit-stride, so the
//   model's (B, S, H, P) and (B, S, H) tensors are read where they lie;
//   b and c (G, S, N) contiguous, shared by the r heads of a group (the
//   model's per-batch projections, G = B; G = BH is the reference's per-head
//   layout); all f32. y (G, r, S, P) f32, written through strides of its
//   own. Per chunk of Q tokens, with cum = cumsum(la) inside the chunk and
//   tot = cum[Q-1]:
//     y     = ((C B^T) o tril(exp(cum_i - cum_j))) X + exp(cum) o (C h_in)
//     h_out = exp(tot) h_in + (B o exp(tot - cum))^T X,  h_in = 0 at chunk 0
//   with an f32 (N, P) state. Replaces repro/kernels/ssd_scan.py:ssd_scan.
//
// Bound: the function reads xdt, la, b and c once and writes y once; per
// chunk it needs C B^T once per group (Q^2 N / 2 FMAs over the causal
// pairs) and, per head, the decay mask, the intra term (Q^2 P / 2 FMAs),
// the inter term and the state update (Q N P FMAs each). At hymba-1.5b's
// shapes (Q 64, N 16, P 50, 64 heads a group) that is ~16 flops a byte, at
// mamba2-370m's (N 128, P 64, 32 heads) ~68: both near the f32 ridge of the
// card (67 TFLOP/s over 3.35 TB/s = 20), so bytes and f32 FMAs both count.
//
// Design: the three-phase form of the SSD algorithm (arXiv:2405.21060 §6,
// the decomposition models/ssm.py:chunk_scan computes), in four launches on
// the caller's stream. The TPU kernel's sequential chunk grid axis becomes
// a short recurrence over chunk states (phase 3); everything else is
// parallel over chunks:
//   1. ssd_scan_cb       grid (nC, G): C B^T of a chunk, once per (group,
//      chunk), shared by every head of the group; stored transposed
//      (B C^T, rows of QP = Q rounded up to 4 floats) in a scratch;
//   2. ssd_scan_states   grid (nC, G, head tiles): per head cum (kept,
//      times log2(e), in a (BH, S) scratch for phase 4), exp(tot) (to a
//      (BH, nC) scratch) and the chunk's state contribution
//      (B o exp(tot - cum))^T X, an (N, P) tile, to a (BH, nC, N, P)
//      scratch; the B chunk is staged once for the block's heads;
//   3. ssd_scan_pass     grid (N*P / 1024, BH): h_in[c] = h, h = exp(tot_c) h
//      + s_c over the nC chunks, in place (chunk c's slot gets h_in[c]); a
//      thread carries 4 adjacent elements and issues the 16-byte loads of
//      kPass contributions before the FMAs that need them, since they do
//      not depend on h;
//   4. ssd_scan_outputs  grid (nC, G, head tiles): the chunk's C B^T and C
//      staged once for the block's kOutHeads heads; per head the inter term
//      C h_in and the intra term with the decay applied in its loop, y
//      written once, as whole rows.
// Phases 2 and 4 both read X: phase 4 needs h_in, which needs every earlier
// chunk's phase 2, so without a wait across blocks the two passes cannot
// share one read. Moving the intra term into phase 2 would write y there
// and read it back in phase 4: the same bytes. Extra traffic over the
// function's own: X once more, the states four times (write, read and
// write in place, read; 26 MB at hymba's prefill, within the 50 MB L2),
// cum twice and C B^T twice (2 MB each).
//
// Arithmetic: f32 on the CUDA cores (fmaf), in 4 x 4 register tiles fed by
// 16-byte shared-memory loads (rows padded to a multiple of 4 floats, the
// pads zeroed); tiles are staged with cp.async, 16, 8 or 4 bytes a copy as
// the rows' alignment allows. P, N and Q are runtime values (hymba: P 50,
// N 16; mamba2-370m: P 64, N 128): the tiles cover the actual sizes with
// bounds checks, so no width is assumed to be a power of two or a multiple
// of 16. S % Q == 0 is the caller's job, as in the reference (the model
// pads); la <= 0, as -A dt is, keeps every decay factor finite.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSmem = 232448;    // 227 KB a block may opt into on sm_90
constexpr int kSmemPerSM = 233472;  // 228 KB an SM has
constexpr int kPass = 8;            // chunk states a pass thread loads ahead
constexpr int kOutHeads = 4;        // heads a block of phase 4 walks
// at most this many heads a block of phase 2: at hymba's sizes 3 heads
// (156 of 256 threads busy, 44 KB) leave room for four blocks on an SM,
// where 4 heads (208 threads, 58 KB) leave room for three, and more
// resident blocks hide more of the copies' latency
constexpr int kStateHeads = 3;
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {                    // element strides of (group, head, token)
  long long g, h, s;
};

__host__ __device__ inline int pad4(int n) { return (n + 3) & ~3; }

// shared memory of each phase, in floats
__host__ inline int cb_smem(int Q, int N) { return 2 * N * pad4(Q); }
__host__ inline int states_smem(int Q, int P, int N, int R) {
  return Q * pad4(N) + R * Q + R * Q * pad4(P);
}
__host__ inline int outputs_smem(int Q, int P, int N) {
  const int QP = pad4(Q), PP = pad4(P);
  return Q * QP + N * QP + 2 * Q * PP + N * PP + QP;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

template <int V> __device__ __forceinline__ void load_v(float* dst, const float* src);
template <> __device__ __forceinline__ void load_v<1>(float* dst, const float* src) {
  dst[0] = *src;
}
template <> __device__ __forceinline__ void load_v<4>(float* dst, const float* src) {
  const float4 v = ld4(src);
  dst[0] = v.x;
  dst[1] = v.y;
  dst[2] = v.z;
  dst[3] = v.w;
}
template <int V> __device__ __forceinline__ void store_v(float* dst, const float* src);
template <> __device__ __forceinline__ void store_v<1>(float* dst, const float* src) {
  *dst = src[0];
}
template <> __device__ __forceinline__ void store_v<4>(float* dst, const float* src) {
  *reinterpret_cast<float4*>(dst) = make_float4(src[0], src[1], src[2], src[3]);
}

// out[0, n) = v[0, n) for n <= 4 (n = 4 but at a row's ragged end), as
// V-float stores: out is V-float aligned and n is a multiple of V.
__device__ __forceinline__ void store_row(float* out, const float (&v)[4],
                                          int n, int V) {
  if (V == 4 && n == 4) {
    *reinterpret_cast<float4*>(out) = make_float4(v[0], v[1], v[2], v[3]);
  } else if (V == 2) {
    *reinterpret_cast<float2*>(out) = make_float2(v[0], v[1]);
    if (n == 4) *reinterpret_cast<float2*>(out + 2) = make_float2(v[2], v[3]);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (k < n) out[k] = v[k];
  }
}

// acc[a][b] += u[a] * v[b]
__device__ __forceinline__ void outer4(float (&acc)[4][4], const float4 u,
                                       const float4 v) {
  const float uu[4] = {u.x, u.y, u.z, u.w}, vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(uu[a], vv[b], acc[a][b]);
}

__device__ __forceinline__ void zero4(float (&acc)[4][4]) {
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
}

// Asynchronous 4-, 8- and 16-byte copies from device memory to shared memory
// (cp.async): the copies of a whole tile are in flight at once, and no
// register holds them on the way.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"((unsigned)__cvta_generic_to_shared(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async8(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
               :: "r"((unsigned)__cvta_generic_to_shared(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"((unsigned)__cvta_generic_to_shared(dst)), "l"(src)
               : "memory");
}
// Wait for this thread's copies; a __syncthreads() must follow before other
// threads read them.
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// cum[i] = cum[0] + ... + cum[i] in place over one chunk in shared memory,
// by one warp: each lane sums a contiguous segment, then a shuffle scan of
// the segment totals.
__device__ void warp_cumsum(float* cum, int Q, int lane) {
  const int seg = (Q + 31) / 32;
  const int lo = min(lane * seg, Q), hi = min(lo + seg, Q);
  float run = 0.f;
  for (int i = lo; i < hi; ++i) {
    run += cum[i];
    cum[i] = run;
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float t = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += t;
  }
  const float excl = incl - run;
  for (int i = lo; i < hi; ++i) cum[i] += excl;
}

// Start copying rows [0, n) of P floats at src + i * stride into dst rows
// of PP floats (the pad columns zeroed), V floats a copy (src, the stride
// and P keep V-float alignment): a warp a row, a lane a copy.
__device__ void stage_rows(float* dst, const float* src, long long stride,
                           int n, int P, int PP, int V) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = warp; i < n; i += kWarps) {
    const float* s = src + (long long)i * stride;
    float* d = dst + i * PP;
    if (V == 4)
      for (int p = 4 * lane; p < P; p += 128) cp_async16(d + p, s + p);
    else if (V == 2)
      for (int p = 2 * lane; p < P; p += 64) cp_async8(d + p, s + p);
    else
      for (int p = lane; p < P; p += 32) cp_async4(d + p, s + p);
    for (int p = P + lane; p < PP; p += 32) d[p] = 0.f;
  }
}

// Start copying Q values at src + i * stride into dst.
__device__ void stage_vec(float* dst, const float* src, long long stride,
                          int Q) {
  for (int i = threadIdx.x; i < Q; i += kThreads)
    cp_async4(dst + i, src + (long long)i * stride);
}

// Start copying a (Q, N) row-major chunk into dst as (N, QP): dst[n][i]
// (the pad columns zeroed).
__device__ void stage_transposed(float* dst, const float* src, int Q, int N,
                                 int QP) {
  for (int idx = threadIdx.x; idx < Q * N; idx += kThreads) {
    const int i = idx / N, n = idx - i * N;
    cp_async4(dst + n * QP + i, src + idx);
  }
  for (int idx = threadIdx.x; idx < N * (QP - Q); idx += kThreads) {
    const int n = idx / (QP - Q);
    dst[n * QP + Q + idx - n * (QP - Q)] = 0.f;
  }
}

// Phase 1: cb[g, c][j][i] = sum_n B[j][n] C[i][n] (= (C B^T)[i][j]).
__global__ void __launch_bounds__(kThreads)
ssd_scan_cb(const float* __restrict__ bg, const float* __restrict__ cg,
            float* __restrict__ cb, int S, int N, int Q) {
  extern __shared__ __align__(16) float sm[];
  const int QP = pad4(Q);
  float* sB = sm;               // N x QP: sB[n][j] = B[j][n]
  float* sC = sB + N * QP;      // N x QP: sC[n][i] = C[i][n]
  const int c = blockIdx.x, g = blockIdx.y, nC = gridDim.x;
  const long long base = ((long long)g * S + (long long)c * Q) * N;
  stage_transposed(sB, bg + base, Q, N, QP);
  stage_transposed(sC, cg + base, Q, N, QP);
  cp_async_wait();
  __syncthreads();
  const int T4 = QP / 4;
  float* out = cb + ((long long)g * nC + c) * Q * QP;
  for (int t = threadIdx.x; t < T4 * T4; t += kThreads) {
    const int j0 = (t / T4) * 4, i0 = (t % T4) * 4;
    float acc[4][4];
    zero4(acc);
    for (int n = 0; n < N; ++n)
      outer4(acc, ld4(sB + n * QP + j0), ld4(sC + n * QP + i0));
#pragma unroll
    for (int a = 0; a < 4; ++a)
      if (j0 + a < Q)
        *reinterpret_cast<float4*>(out + (j0 + a) * QP + i0) =
            make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
  }
}

// Phase 2: per head of the block's R: log2(e) cum to cs (for phase 4),
// exp(tot) to dec, and the chunk's state contribution
// (B o exp(tot - cum))^T X to st, stored V floats at a time.
__global__ void __launch_bounds__(kThreads)
ssd_scan_states(const float* __restrict__ xdt, Strides xs,
                const float* __restrict__ la, Strides ls,
                const float* __restrict__ bg, float* __restrict__ st,
                float* __restrict__ dec, float* __restrict__ cs, int r, int R,
                int S, int P, int N, int Q, int V, int vx, int vb) {
  extern __shared__ __align__(16) float sm[];
  const int PP = pad4(P), NP = pad4(N);
  const int c = blockIdx.x, g = blockIdx.y, h0 = blockIdx.z * R;
  const int nC = gridDim.x;
  const int nh = min(R, r - h0);
  float* sB = sm;               // Q x NP
  float* sW = sB + Q * NP;      // R x Q: la, then cum, then exp(tot - cum)
  float* sX = sW + R * Q;       // R x Q x PP
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long s0 = (long long)c * Q;

  stage_rows(sB, bg + ((long long)g * S + s0) * N, N, Q, N, NP, vb);
  for (int hh = 0; hh < nh; ++hh) {
    const long long h = h0 + hh;
    stage_vec(sW + hh * Q, la + g * ls.g + h * ls.h + s0 * ls.s, ls.s, Q);
    stage_rows(sX + hh * Q * PP, xdt + g * xs.g + h * xs.h + s0 * xs.s, xs.s,
               Q, P, PP, vx);
  }
  cp_async_wait();
  __syncthreads();
  for (int hh = warp; hh < nh; hh += kWarps) {
    const long long bh = (long long)g * r + h0 + hh;
    float* w = sW + hh * Q;
    warp_cumsum(w, Q, lane);
    __syncwarp();
    const float tot = w[Q - 1];
    __syncwarp();
    for (int j = lane; j < Q; j += 32) {
      cs[bh * S + s0 + j] = w[j] * kLog2e;
      w[j] = expf(tot - w[j]);
    }
    if (lane == 0) dec[bh * nC + c] = expf(tot);
  }
  __syncthreads();
  // X o exp(tot - cum), a warp a row
  for (int row = warp; row < nh * Q; row += kWarps) {
    const float wj = sW[row];
    for (int p = lane; p < P; p += 32) sX[row * PP + p] *= wj;
  }
  __syncthreads();

  const int NT = NP / 4, PT = PP / 4;
  for (int t = threadIdx.x; t < nh * NT * PT; t += kThreads) {
    const int hh = t / (NT * PT), rem = t - hh * NT * PT;
    const int n0 = (rem / PT) * 4, p0 = (rem % PT) * 4;
    const float* x = sX + hh * Q * PP + p0;
    float acc[4][4];
    zero4(acc);
#pragma unroll 4
    for (int j = 0; j < Q; ++j) outer4(acc, ld4(sB + j * NP + n0), ld4(x + j * PP));
    float* out = st + (((long long)g * r + h0 + hh) * nC + c) * N * P + p0;
    const int n = min(4, P - p0);
#pragma unroll
    for (int a = 0; a < 4; ++a)
      if (n0 + a < N) store_row(out + (n0 + a) * P, acc[a], n, V);
  }
}

// Phase 3: the recurrence over the chunks, in place: chunk c's slot of st
// gets the state entering chunk c. V: adjacent elements a thread carries
// (4, as one 16-byte load, when N * P % 4 == 0).
template <int V>
__global__ void __launch_bounds__(kThreads)
ssd_scan_pass(float* __restrict__ st, const float* __restrict__ dec, int nC,
              int NPn) {
  const int e = (blockIdx.x * kThreads + threadIdx.x) * V;
  if (e >= NPn) return;
  const long long bh = blockIdx.y;
  float* p = st + bh * nC * (long long)NPn + e;
  const float* d = dec + bh * nC;
  float h[V];
#pragma unroll
  for (int v = 0; v < V; ++v) h[v] = 0.f;
  int c = 0;
  for (; c + kPass <= nC; c += kPass) {
    float s[kPass][V], a[kPass];
#pragma unroll
    for (int k = 0; k < kPass; ++k) {
      load_v<V>(s[k], p + (long long)(c + k) * NPn);
      a[k] = __ldg(d + c + k);
    }
#pragma unroll
    for (int k = 0; k < kPass; ++k) {
      store_v<V>(p + (long long)(c + k) * NPn, h);
#pragma unroll
      for (int v = 0; v < V; ++v) h[v] = fmaf(a[k], h[v], s[k][v]);
    }
  }
  for (; c < nC; ++c) {
    float s[V];
    load_v<V>(s, p + (long long)c * NPn);
    store_v<V>(p + (long long)c * NPn, h);
    const float a = __ldg(d + c);
#pragma unroll
    for (int v = 0; v < V; ++v) h[v] = fmaf(a, h[v], s[v]);
  }
}

// Phase 4: y of the block's heads, one 4 x 4 output tile a thread (the
// caller keeps ceil(Q/4) * ceil(P/4) <= kThreads). The decay
// exp(cum_i - cum_j) is applied inside the intra term's loop, factored
// around the tile's first row i0 as exp(cum_i - cum_i0) exp(cum_i0 - cum_j),
// so both factors stay <= 1 off the diagonal tile and no masked Q x Q matrix
// is built per head. The y tile goes through shared memory and out as whole
// rows, V floats a store. MIN_BLOCKS: the blocks an SM should hold, which
// caps the registers a thread: 4 where shared memory lets 4 blocks share an
// SM (hymba's sizes), else 2 (left to itself ptxas takes 125-160 registers,
// one block an SM).
template <int MIN_BLOCKS>
__global__ void __launch_bounds__(kThreads, MIN_BLOCKS)
ssd_scan_outputs(const float* __restrict__ xdt, Strides xs,
                 const float* __restrict__ cs, const float* __restrict__ cg,
                 const float* __restrict__ cb, const float* __restrict__ st,
                 float* __restrict__ y, Strides ys, int r, int R, int S, int P,
                 int N, int Q, int V, int vx, int vh) {
  extern __shared__ __align__(16) float sm[];
  const int PP = pad4(P), QP = pad4(Q);
  const int c = blockIdx.x, g = blockIdx.y, h0 = blockIdx.z * R;
  const int nC = gridDim.x;
  const int nh = min(R, r - h0);
  float* sG = sm;               // Q x QP: sG[j][i] = (C B^T)[i][j]
  float* sCT = sG + Q * QP;     // N x QP: sCT[n][i] = C[i][n]
  float* sX = sCT + N * QP;     // Q x PP
  float* sH = sX + Q * PP;      // N x PP: h_in
  float* sY = sH + N * PP;      // Q x PP
  float* sCum = sY + Q * PP;    // QP: log2(e) cum, for exp2f
  const long long s0 = (long long)c * Q;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  {
    const float* src = cb + ((long long)g * nC + c) * Q * QP;
    for (int idx = threadIdx.x * 4; idx < Q * QP; idx += kThreads * 4)
      cp_async16(sG + idx, src + idx);
    stage_transposed(sCT, cg + ((long long)g * S + s0) * N, Q, N, QP);
  }

  const int PT = PP / 4, tiles = (QP / 4) * PT;
  const int i0 = (threadIdx.x / PT) * 4, p0 = (threadIdx.x % PT) * 4;
  for (int hh = 0; hh < nh; ++hh) {
    const int h = h0 + hh;
    const long long bh = (long long)g * r + h;
    stage_vec(sCum, cs + bh * S + s0, 1, Q);
    stage_rows(sX, xdt + g * xs.g + h * xs.h + s0 * xs.s, xs.s, Q, P, PP, vx);
    stage_rows(sH, st + (bh * nC + c) * N * P, P, N, P, PP, vh);
    cp_async_wait();
    __syncthreads();

    if (threadIdx.x < tiles) {
      // the inter term C h_in
      float inter[4][4];
      zero4(inter);
#pragma unroll 4
      for (int n = 0; n < N; ++n)
        outer4(inter, ld4(sCT + n * QP + i0), ld4(sH + n * PP + p0));
      // the intra term: rows before the diagonal tile, then the diagonal
      // tile, where row i0 + a sees j <= i0 + a
      const float c0 = sCum[i0];
      float acc[4][4];
      zero4(acc);
#pragma unroll 4
      for (int j = 0; j < i0; ++j) {
        const float bj = exp2f(c0 - sCum[j]);
        float4 gv = ld4(sG + j * QP + i0);
        gv.x *= bj;
        gv.y *= bj;
        gv.z *= bj;
        gv.w *= bj;
        outer4(acc, gv, ld4(sX + j * PP + p0));
      }
      for (int j = i0; j < min(i0 + 4, Q); ++j) {
        const float bj = exp2f(c0 - sCum[j]);
        float4 gv = ld4(sG + j * QP + i0);
        gv.x = j <= i0 ? gv.x * bj : 0.f;
        gv.y = j <= i0 + 1 ? gv.y * bj : 0.f;
        gv.z = j <= i0 + 2 ? gv.z * bj : 0.f;
        gv.w *= bj;
        outer4(acc, gv, ld4(sX + j * PP + p0));
      }
      // y = exp(cum_i - cum_i0) intra + exp(cum_i) inter, into sY (the
      // previous head's rows left it before this head's barrier)
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        if (i0 + a >= Q) continue;
        const float ci = sCum[i0 + a];
        const float ai = exp2f(ci - c0), ei = exp2f(ci);
        float v[4];
#pragma unroll
        for (int b = 0; b < 4; ++b) v[b] = fmaf(ei, inter[a][b], ai * acc[a][b]);
        *reinterpret_cast<float4*>(sY + (i0 + a) * PP + p0) =
            make_float4(v[0], v[1], v[2], v[3]);
      }
    }
    __syncthreads();
    // y out as whole rows: a warp a row, V floats a lane; the next head's
    // copies may start meanwhile, since X, h_in and cum are read
    float* out = y + g * ys.g + h * ys.h + s0 * ys.s;
    for (int i = warp; i < Q; i += kWarps) {
      float* o = out + (long long)i * ys.s;
      const float* v = sY + i * PP;
      if (V == 4)
        for (int p = 4 * lane; p < P; p += 128)
          *reinterpret_cast<float4*>(o + p) = ld4(v + p);
      else if (V == 2)
        for (int p = 2 * lane; p < P; p += 64)
          *reinterpret_cast<float2*>(o + p) = *reinterpret_cast<const float2*>(v + p);
      else
        for (int p = lane; p < P; p += 32) o[p] = v[p];
    }
  }
}

// scratch layout, in floats: C B^T (G, nC, Q, QP) first (16-byte rows),
// then the chunk states (BH, nC, N, P), exp(tot) (BH, nC) and log2(e) cum
// (BH, S)
long long cb_floats(int G, int S, int Q) {
  return (long long)G * (S / Q) * Q * pad4(Q);
}
long long st_floats(int G, int r, int S, int P, int N, int Q) {
  return (long long)G * r * (S / Q) * N * P;
}

// The widest access (4, 2 or 1 floats) that rows of P floats at ptr + the
// given strides keep aligned.
int store_width(const void* ptr, int P, long long s1, long long s2,
                long long s3) {
  for (int V = 4; V > 1; V /= 2)
    if (P % V == 0 && s1 % V == 0 && s2 % V == 0 && s3 % V == 0 &&
        reinterpret_cast<uintptr_t>(ptr) % (4 * V) == 0)
      return V;
  return 1;
}

int states_heads(int r, int P, int N, int Q) {
  const int per_head = (pad4(N) / 4) * (pad4(P) / 4);
  int R = kThreads / per_head;
  R = R < 1 ? 1 : (R > kStateHeads ? kStateHeads : R);
  R = R > r ? r : R;
  while (R > 1 && states_smem(Q, P, N, R) * (int)sizeof(float) > kMaxSmem) --R;
  return R;
}

}  // namespace

extern "C" {

// Floats of scratch ssd_scan_f32 needs (the wrapper allocates it).
long long ssd_scan_scratch_floats(int G, int r, int S, int P, int N, int Q) {
  if (G < 1 || r < 1 || Q < 1 || S < Q) return 0;
  return cb_floats(G, S, Q) + st_floats(G, r, S, P, N, Q) +
         (long long)G * r * (S / Q) + (long long)G * r * S;
}

// Returns a cudaError_t (0 = launched); cudaErrorInvalidValue for sizes it
// cannot run, among them tiles over the shared memory a block may have.
int ssd_scan_f32(const float* xdt, long long xg, long long xh, long long xs,
                 const float* la, long long lg, long long lh, long long ls,
                 const float* b, const float* c, float* y, long long yg,
                 long long yh, long long ys, float* scratch, int G, int r,
                 int S, int P, int N, int Q, void* stream) {
  if (G < 1 || r < 1 || Q < 1 || S < Q || S % Q != 0 || P < 1 || N < 1 ||
      (long long)G * r > 65535 || G > 65535)
    return (int)cudaErrorInvalidValue;
  const int nC = S / Q;
  const int R = states_heads(r, P, N, Q);
  const int R4 = r < kOutHeads ? r : kOutHeads;
  const int tiles = (pad4(Q) / 4) * (pad4(P) / 4);
  const int bytes_cb = cb_smem(Q, N) * (int)sizeof(float);
  const int bytes_st = states_smem(Q, P, N, R) * (int)sizeof(float);
  const int bytes_out = outputs_smem(Q, P, N) * (int)sizeof(float);
  if (bytes_cb > kMaxSmem || bytes_st > kMaxSmem || bytes_out > kMaxSmem ||
      tiles > kThreads)
    return (int)cudaErrorInvalidValue;
  // four blocks an SM where their shared memory fits (1 KB each reserved)
  const bool four = bytes_out <= (kSmemPerSM - 4 * 1024) / 4;
  static bool configured = false;
  if (!configured) {
    const void* kernels[] = {(const void*)ssd_scan_cb,
                             (const void*)ssd_scan_states,
                             (const void*)ssd_scan_outputs<2>,
                             (const void*)ssd_scan_outputs<4>};
    for (const void* k : kernels) {
      cudaError_t err = cudaFuncSetAttribute(
          k, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
      if (err != cudaSuccess) return (int)err;
    }
    configured = true;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* cbs = scratch;
  float* st = cbs + cb_floats(G, S, Q);
  float* dec = st + st_floats(G, r, S, P, N, Q);
  float* cs = dec + (long long)G * r * nC;
  const Strides xst{xg, xh, xs}, lst{lg, lh, ls}, yst{yg, yh, ys};
  const int vst = store_width(st, P, P, N * P, N * P);
  const int vy = store_width(y, P, yg, yh, ys);
  const int vx = store_width(xdt, P, xg, xh, xs);
  const int vb = store_width(b, N, N, N, (long long)S * N);
  cudaError_t err;

  ssd_scan_cb<<<dim3(nC, G), kThreads, bytes_cb, s>>>(b, c, cbs, S, N, Q);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ssd_scan_states<<<dim3(nC, G, (r + R - 1) / R), kThreads, bytes_st, s>>>(
      xdt, xst, la, lst, b, st, dec, cs, r, R, S, P, N, Q, vst, vx, vb);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if ((N * P) % 4 == 0)
    ssd_scan_pass<4><<<dim3((N * P / 4 + kThreads - 1) / kThreads, G * r),
                       kThreads, 0, s>>>(st, dec, nC, N * P);
  else
    ssd_scan_pass<1><<<dim3((N * P + kThreads - 1) / kThreads, G * r),
                       kThreads, 0, s>>>(st, dec, nC, N * P);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const dim3 grid4(nC, G, (r + R4 - 1) / R4);
  auto outputs = four ? ssd_scan_outputs<4> : ssd_scan_outputs<2>;
  outputs<<<grid4, kThreads, bytes_out, s>>>(xdt, xst, cs, c, cbs, st, y, yst,
                                            r, R4, S, P, N, Q, vy, vx, vst);
  return (int)cudaGetLastError();
}

}  // extern "C"
