// Mamba2 SSD chunk scan (forward) on Hopper (sm_90a), plain C interface for
// ctypes (see repro_torch/kernels/build.py and kernels/ssd_scan.py).
//
//   xdt (G, r, S, P) = x * dt and la (G, r, S) = -A * dt, read through
//   element strides of (group, head, token) with P unit-stride, so the
//   model's (B, S, H, P) and (B, S, H) tensors are read where they lie;
//   b and c (G, S, N) contiguous, shared by the r heads of a group (the
//   model's per-batch projections, G = B; G = BH is the reference's per-head
//   layout); all f32. y (G, r, S, P) f32, written through strides of its
//   own. Per tile of T tokens, with cum = cumsum(la) inside the tile and
//   tot = cum[T-1]:
//     y     = ((C B^T) o tril(exp(cum_i - cum_j))) X + exp(cum) o (C h_in)
//     h_out = exp(tot) h_in + (B o exp(tot - cum))^T X,  h_in = 0 at tile 0
//   with an f32 (N, P) state. Replaces repro/kernels/ssd_scan.py:ssd_scan.
//   The tile is T = 64 tokens whatever the caller's chunk Q: the chunked
//   form is exact for any chunk length, so Q only sets the refusal of an S
//   that is not a multiple of it (the reference's contract); a last tile
//   past S (Q 16 or 32) is zero-filled.
//
// Bound: the function reads xdt, la, b and c once and writes y once; per
// tile it needs C B^T once per group (T^2 N / 2 FMAs over the causal
// pairs) and, per head, the decay mask, the intra term (T^2 P / 2 FMAs),
// the inter term and the state update (T N P FMAs each). In f32-accurate
// tensor-core work (3xTF32: 495 / 3 TFLOP/s) hymba-1.5b's shapes (N 16,
// P 50) are bound by bytes, mamba2-370m's (N 128, P 64) by operations.
//
// Design: one pass. The TPU kernel's sequential chunk axis is a loop inside
// the block, and the state is a wgmma accumulator in f32 registers:
//   * a block owns one head and a slice of PW of its P columns (columns of
//     X, y and h are independent): grid (r * slices, G). PW is one of 16,
//     32, 56, 64 and NS, the state width, one of 16, 32, 64, 128 (template
//     arguments, the wgmma N); P over 64, or a large state's grid short of
//     the SMs (mamba2's 64 heads), takes more, narrower slices;
//   * loads run ahead: a ring of `stages` (<= 3) tile slots (X, la, b, c),
//     filled by cp.async, 16, 8 or 4 bytes a copy as the strides allow
//     (hymba's 200-byte rows rule out TMA), one commit group a tile, started
//     stages - 1 tiles ahead; b and c land in wgmma's K-major layout (rows
//     of 32-float boxes, 128-byte swizzle);
//   * a split pass turns the arrived tile into what the wgmmas read:
//     hi = tf32(x) by cvt.rna and lo = tf32(x - hi), B's hi in place and its
//     lo beside it; X^T hi and lo (tf32 wgmma reads both operands K-major,
//     and X is token-major), tokens permuted within each group of 8 so that
//     the accumulator fragment of C B^T is the A fragment of the intra
//     product as it stands (position t holds token 2t, t + 4 token 2t + 1);
//     for a small state (N <= 32) also (B o w)^T hi and lo, w = exp2(tot -
//     cum), in the same token order;
//   * every product is three TF32 products (lo hi + hi lo + hi hi, f32
//     sums), on wgmma m64nNk8:
//       G = C B^T           A = C from registers (split there), B = B hi/lo;
//       y = C h_in          the same A fragments, B = h^T hi/lo (K = N);
//       y = e^cum y + M X   M = G o exp2(cum2_i - cum2_j), the exponent -inf
//                           above the diagonal before the exp (every factor
//                           <= 1, as la <= 0), split in registers;
//       state, small:  h^T = e^tot h^T + X^T (B o w)   (rows p; both
//                           operands from shared memory, N = NS);
//       state, large:  h = e^tot h + (B o w)^T X   (rows n, one or two
//                           64-row tiles; A = (B hi + lo) w from registers);
//     then h^T hi/lo to shared memory for the next tile's inter term;
//   * y is stored from the accumulator fragment, 8-byte pairs where the
//     strides allow, as streaming (evict-first) stores;
//   * ssd_scan_tc: one warpgroup does every part of a tile in turn (any
//     state; the only kernel for a large state or a grid over the SMs);
//   * ssd_scan_ws: for a small state whose grid fits one block an SM
//     (hymba's prefill: 128 heads), two warpgroups: a producer starts the
//     loads and does the split pass and the state update one tile ahead of
//     a consumer doing G, the inter and intra terms and y. The split pass's
//     tiles, cum and h^T come in two sets by tile parity, passed by
//     mbarriers (full, ready, done);
//   * no atomics and a fixed order of sums: two calls give the same bits,
//     and the load width never changes the arithmetic.
// Shared memory (floats; NB = boxes of 32 state columns, 1 at N <= 32, 4
// at N 128; a box tile is 64 x 32), sets: 1, or 2 with a producer:
//   ring: stages x (B 64 x 32 NB, C 64 x 32 NB, X 64 x PW, la 64);
//   a set: B lo 64 x 32 NB; X^T hi, lo PW x 64 each; h^T hi, lo PW x 32 NB
//   each; small: (B o w)^T hi, lo NS x 64 each; cum 64.
//   hymba's prefill (PW 64, NS 16, a producer): 3 stages, 226 KB; its
//   training block (PW 56, one warpgroup): 1 stage, 89 KB (two blocks an
//   SM); mamba2-370m (PW 32, NS 128): 2 stages, 225 KB. N over 128, or
//   tiles over the 227 KB a block may have, are refused.
// Registers a thread: G 32, y PW / 2, the state NS / 2 (small) or NT x PW
// / 2 (large), A fragments of M 64 (hi and lo), of C 32 (four k-steps at a
// time), of a large state's (B o w)^T 64 (a row tile at a time): up to 255
// in the one-warpgroup kernels, no spill on the main path's (ptxas -v).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kT = 64;              // tokens a tile: wgmma's M
constexpr int kThreads = 128;       // one warpgroup
constexpr int kMaxStages = 3;       // tile slots of the load ring
constexpr int kMaxSmem = 232448;    // 227 KB a block may opt into on sm_90
constexpr int kSmemPerSM = 233472;  // 228 KB an SM has
constexpr int kWidths[] = {16, 32, 56, 64};  // P columns a block (PW)
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {                    // element strides of (group, head, token)
  long long g, h, s;
};

struct Args {
  const float* xdt;
  Strides xs;
  const float* la;
  Strides ls;
  const float* b;
  const float* c;
  float* y;
  Strides ys;
  int r, S, P, N, slices, stages;
  int vx, vb, vy;                   // floats a copy of X, of b and c; a y store
};

// NS, the state width a kernel is built for: 16 or 32 keep h^T (PW x NS,
// rows p) as the accumulator, 64 or 128 keep h (NS x PW, rows n) in NS / 64
// accumulator tiles
__host__ __device__ constexpr bool small_state(int NS) { return NS <= 32; }

__host__ __device__ inline int state_width(int N) {
  return N <= 16 ? 16 : N <= 32 ? 32 : N <= 64 ? 64 : 128;
}

// offsets (floats) of the shared tiles; the swizzled ones first, each a
// multiple of 1024 bytes from the 1024-aligned base. `pars` sets of the
// split pass's tiles (and of h^T): two when a producer warpgroup fills one
// while the consumer reads the other (by tile parity), else one
struct Layout {
  int br, cr, blo, xth, xtl, hth, htl, bwh, bwl, xr, la, cum, wts, bar, total;
  int nblo, nxt, nht, nbw;          // floats of one set's B lo, X^T, h^T, (B o w)^T
};

__host__ __device__ inline Layout layout(int PW, int NB, int stages, int NS, int pars) {
  const int box = kT * 32 * NB;     // a 64-row tile of NB boxes
  Layout L;
  L.nblo = box;
  L.nxt = PW * kT;
  L.nht = PW * 32 * NB;
  L.nbw = small_state(NS) ? NS * kT : 0;
  int o = 0;
  L.br = o;  o += stages * box;
  L.cr = o;  o += stages * box;
  L.blo = o; o += pars * L.nblo;
  L.xth = o; o += pars * L.nxt;
  L.xtl = o; o += pars * L.nxt;
  L.hth = o; o += pars * L.nht;
  L.htl = o; o += pars * L.nht;
  L.bwh = o; o += pars * L.nbw;
  L.bwl = o; o += pars * L.nbw;
  L.xr = o;  o += stages * kT * PW;
  L.la = o;  o += stages * kT;
  L.cum = o; o += pars * kT;
  L.wts = o; o += kT;
  L.bar = o; o += 12;               // six mbarriers (8 bytes each)
  L.total = o;
  return L;
}

__host__ __device__ inline int state_boxes(int N) { return (((N + 7) & ~7) + 31) / 32; }

__host__ inline int smem_bytes(int PW, int N, int stages, int pars) {
  return layout(PW, state_boxes(N), stages, state_width(N), pars).total *
             (int)sizeof(float) + 1024;
}

// float offset of (row, col) in a K-major tile of R rows: boxes of 32
// columns, rows of 128 bytes, 16-byte chunks under the 128-byte swizzle
__device__ __forceinline__ int sw(int R, int row, int col) {
  return (col >> 5) * R * 32 + row * 32 + ((((col & 31) >> 2) ^ (row & 7)) << 2) +
         (col & 3);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma shared-memory descriptor, 128-byte swizzle; offsets in bytes
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  const uint32_t lbo = 16, sbo = 1024;
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// keep the compiler from moving accumulator registers across a wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// generic-proxy writes to shared memory made visible to wgmma's reads
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// D (64 x 16, f32) += A (64 x 8, registers) B (16 x 8, shared, K-major), tf32
__device__ __forceinline__ void wgmma_rs(float (&d)[8], const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D (64 x 32, f32) += A (64 x 8, registers) B (32 x 8, shared, K-major), tf32
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D (64 x 56, f32) += A (64 x 8, registers) B (56 x 8, shared, K-major), tf32
__device__ __forceinline__ void wgmma_rs(float (&d)[28], const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %33, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n56k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27"
      "}, {%28, %29, %30, %31}, %32, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D (64 x 64, f32) += A (64 x 8, registers) B (64 x 8, shared, K-major), tf32
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D (64 x 16, f32) += A (64 x 8, shared) B (16 x 8, shared), tf32, both K-major
__device__ __forceinline__ void wgmma_ss(float (&d)[8], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(1));
}

// D (64 x 32, f32) += A (64 x 8, shared) B (32 x 8, shared), tf32, both K-major
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(1));
}

// round to tf32 (nearest, ties away from zero): the low 13 bits cleared
__device__ __forceinline__ float to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

__device__ __forceinline__ void split(float x, float& hi, float& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - hi);                     // x - hi is exact in f32
}

__device__ __forceinline__ void split_u(float x, uint32_t& hi, uint32_t& lo) {
  float h, l;
  split(x, h, l);
  hi = __float_as_uint(h);
  lo = __float_as_uint(l);
}

__device__ __forceinline__ float4 split4(float4 x, float4& lo) {
  float4 hi;
  split(x.x, hi.x, lo.x);
  split(x.y, hi.y, lo.y);
  split(x.z, hi.z, lo.z);
  split(x.w, hi.w, lo.w);
  return hi;
}

__device__ __forceinline__ float lane_of(const float4& x, int j) {
  return j == 0 ? x.x : j == 1 ? x.y : j == 2 ? x.z : x.w;
}

// 2^x on the SFU (ex2.approx: about 2 ulp; 2^-inf = 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Asynchronous 4-, 8- and 16-byte copies from device memory to shared memory
__device__ __forceinline__ void cp_async(int V, float* dst, const float* src) {
  const uint32_t d = smem_u32(dst);
  if (V == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src)
                 : "memory");
  else if (V == 2)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(d), "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// wait until at most `pending` (0..2) of this thread's commit groups are
// in flight; a __syncthreads() must follow before other threads read them
__device__ __forceinline__ void cp_async_wait(int pending) {
  if (pending >= 2)
    asm volatile("cp.async.wait_group 2;" ::: "memory");
  else if (pending == 1)
    asm volatile("cp.async.wait_group 1;" ::: "memory");
  else
    asm volatile("cp.async.wait_group 0;" ::: "memory");
}

__device__ __forceinline__ void bar_group(int id) {   // one warpgroup's barrier
  asm volatile("bar.sync %0, %1;" ::"r"(id), "n"(kThreads) : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  }
}

// where this block reads and writes: its (group, head) and P slice
struct Span {
  const float *x, *la, *b, *c;
  float* y;
  int pc;                           // columns of the slice inside P
};

__device__ __forceinline__ Span span(const Args& a, int PW) {
  const int ps = blockIdx.x % a.slices;
  const long long h = blockIdx.x / a.slices, g = blockIdx.y;
  const int p0 = ps * PW;
  Span sp;
  sp.x = a.xdt + g * a.xs.g + h * a.xs.h + p0;
  sp.la = a.la + g * a.ls.g + h * a.ls.h;
  sp.b = a.b + g * a.S * (long long)a.N;
  sp.c = a.c + g * a.S * (long long)a.N;
  sp.y = a.y + g * a.ys.g + h * a.ys.h + p0;
  sp.pc = min(PW, a.P - p0);
  return sp;
}

// A thread's walk over the copies of a tile's rows, `per` copies a row, a
// warpgroup's threads one copy each a step: no division in the tile loop.
struct Walk {
  int i0, c0, di, dc, per;
};

__device__ __forceinline__ Walk walk(int per, int wt) {
  return Walk{wt / per, wt % per, kThreads / per, kThreads % per, per};
}

// Start the copies of tile t into ring slot s (no commit), by the 128
// threads of one warpgroup (wt its thread): X rows into X (64 x PW,
// row-major), b and c into their K-major swizzled slots, la. Rows past S
// are zeroed here; columns past P or N stay as the block's first pass
// zeroed them, since no copy writes them.
template <int PW>
__device__ void load_tile(float* sm, const Layout& L, const Args& a,
                           const Span& sp, int t, int s, int NB, const Walk& wx,
                           const Walk& wb, int wt) {
  const int t0 = t * kT, valid = min(kT, a.S - t0);
  float* xr = sm + L.xr + s * kT * PW;
  float* br = sm + L.br + s * kT * 32 * NB;
  float* cr = sm + L.cr + s * kT * 32 * NB;
  float* lr = sm + L.la + s * kT;
  const float* xs = sp.x + (long long)t0 * a.xs.s;
  for (int i = wx.i0, c = wx.c0; i < valid;) {
    const int p = c * a.vx;
    cp_async(a.vx, xr + i * PW + p, xs + (long long)i * a.xs.s + p);
    i += wx.di;
    c += wx.dc;
    if (c >= wx.per) {
      c -= wx.per;
      ++i;
    }
  }
  const long long b0 = (long long)t0 * a.N;
  for (int i = wb.i0, c = wb.c0; i < valid;) {
    const int n = c * a.vb;
    cp_async(a.vb, br + sw(kT, i, n), sp.b + b0 + i * a.N + n);
    cp_async(a.vb, cr + sw(kT, i, n), sp.c + b0 + i * a.N + n);
    i += wb.di;
    c += wb.dc;
    if (c >= wb.per) {
      c -= wb.per;
      ++i;
    }
  }
  for (int i = wt; i < valid; i += kThreads)
    cp_async(1, lr + i, sp.la + (long long)(t0 + i) * a.ls.s);
  if (valid < kT) {
    for (int u = wt; u < (kT - valid) * PW; u += kThreads) xr[valid * PW + u] = 0.f;
    for (int u = wt; u < (kT - valid) * 32 * NB; u += kThreads) {
      const int box = u / ((kT - valid) * 32), rest = u - box * (kT - valid) * 32;
      const int off = box * kT * 32 + valid * 32 + rest;
      br[off] = 0.f;
      cr[off] = 0.f;
    }
    for (int i = valid + wt; i < kT; i += kThreads) lr[i] = 0.f;
  }
}

// The tile's log2(e) cumsum(la) in every warp's registers (a lane: tokens
// 2 lane and 2 lane + 1), and tot, its last; `cum` (and `wts`, exp2(tot -
// cum), when given) written by the warp that `writes`.
struct Cum {
  float c0, c1, tot;
};

__device__ __forceinline__ Cum tile_cumsum(const float* lr, float* cum, float* wts,
                                           int lane, bool writes) {
  const float2 lv = *reinterpret_cast<const float2*>(lr + 2 * lane);
  float incl = lv.x + lv.y;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += u;
  }
  Cum cm;
  cm.c0 = (incl - lv.y) * kLog2e;
  cm.c1 = incl * kLog2e;
  cm.tot = __shfl_sync(0xffffffffu, cm.c1, 31);
  if (writes) {
    *reinterpret_cast<float2*>(cum + 2 * lane) = make_float2(cm.c0, cm.c1);
    if (wts != nullptr)
      *reinterpret_cast<float2*>(wts + 2 * lane) =
          make_float2(ex2(cm.tot - cm.c0), ex2(cm.tot - cm.c1));
  }
  return cm;
}

// The split pass of one tile by one warpgroup (wt its thread): X^T hi/lo
// from the X slot; B hi in place in its slot, B lo; a small state's (B o
// w)^T hi/lo (w = exp2(tot - cum)).
template <int PW, int NS>
__device__ __forceinline__ void split_pass(const float* xr, float* br, float* blo,
                                           float* xth, float* xtl, float* bwh,
                                           float* bwl, int N8, const Cum& cm, int wt) {
  // unit u: column p of X, tokens 8 q + 2 i + half (i = 0..3), written
  // to positions 8 q + 4 half + i of X^T's row p
  for (int u = wt; u < PW * 16; u += kThreads) {
    const int p = u % PW, qh = u / PW, q = qh >> 1, half = qh & 1;
    const float* col = xr + (8 * q + half) * PW + p;
    const float4 v = make_float4(col[0], col[2 * PW], col[4 * PW], col[6 * PW]);
    float4 lo;
    const float4 hi = split4(v, lo);
    const int chunk = 2 * q + half;         // 16-byte chunk of the 64-token row
    const int off = (chunk >> 3) * PW * 32 + p * 32 + (((chunk & 7) ^ (p & 7)) << 2);
    *reinterpret_cast<float4*>(xth + off) = hi;
    *reinterpret_cast<float4*>(xtl + off) = lo;
  }
  // unit u: token tok, state columns 4 c .. 4 c + 3 (a trip count of
  // 16 N8 / 128 for every thread, so the warp's shuffles line up)
  for (int u = wt; u < kT * (N8 / 4); u += kThreads) {
    const int tok = u / (N8 / 4), c = u - tok * (N8 / 4);
    const int off = sw(kT, tok, 4 * c);
    const float4 v = *reinterpret_cast<const float4*>(br + off);
    float4 lo;
    *reinterpret_cast<float4*>(br + off) = split4(v, lo);
    *reinterpret_cast<float4*>(blo + off) = lo;
    if constexpr (small_state(NS)) {
      const float c0 = __shfl_sync(0xffffffffu, cm.c0, tok >> 1);
      const float c1 = __shfl_sync(0xffffffffu, cm.c1, tok >> 1);
      const float w = ex2(cm.tot - ((tok & 1) ? c1 : c0));
      const int pos = 8 * (tok >> 3) + ((tok & 1) << 2) + ((tok & 7) >> 1);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float bh, bl;
        split(lane_of(v, e) * w, bh, bl);
        const int o = sw(NS, 4 * c + e, pos);
        bwh[o] = bh;
        bwl[o] = bl;
      }
    }
  }
}

// G = C B^T into gacc and, when `inter`, the inter term C h_in into yacc
// (else yacc = 0). A = C from registers (split there), four k-steps (a box
// of 32 state columns) at a time.
template <int PW>
__device__ __forceinline__ void g_and_inter(float (&gacc)[32], float (&yacc)[PW / 2],
                                            const float* cr, uint32_t bh_u,
                                            uint32_t blo_u, uint32_t hth, uint32_t htl,
                                            bool inter, int nk, int row0, int t4) {
#pragma unroll
  for (int e = 0; e < 32; ++e) gacc[e] = 0.f;
#pragma unroll
  for (int e = 0; e < PW / 2; ++e) yacc[e] = 0.f;
  for (int k0 = 0; k0 < nk; k0 += 4) {
    uint32_t ah[4][4], al[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (k0 + kk >= nk) break;
      const int col = 8 * (k0 + kk) + t4;
      split_u(cr[sw(kT, row0, col)], ah[kk][0], al[kk][0]);
      split_u(cr[sw(kT, row0 + 8, col)], ah[kk][1], al[kk][1]);
      split_u(cr[sw(kT, row0, col + 4)], ah[kk][2], al[kk][2]);
      split_u(cr[sw(kT, row0 + 8, col + 4)], ah[kk][3], al[kk][3]);
    }
    fence_regs(gacc);
    fence_regs(yacc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int k = k0 + kk;
      if (k >= nk) break;
      const uint32_t bo = (k >> 2) * kT * 128 + (k & 3) * 32;
      wgmma_rs(gacc, al[kk], desc(bh_u + bo));
      wgmma_rs(gacc, ah[kk], desc(blo_u + bo));
      wgmma_rs(gacc, ah[kk], desc(bh_u + bo));
      if (inter) {
        const uint32_t ho = (k >> 2) * PW * 128 + (k & 3) * 32;
        wgmma_rs(yacc, al[kk], desc(hth + ho));
        wgmma_rs(yacc, ah[kk], desc(htl + ho));
        wgmma_rs(yacc, ah[kk], desc(hth + ho));
      }
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(gacc);
    fence_regs(yacc);
  }
}

// M = G o exp2(cum2_i - cum2_j), the exponent -inf above the diagonal
// before the exp; y rows times e^cum_i when `scale` (the inter term is in
// y); then the intra term, y += M X, A = M from registers, B = X^T.
template <int PW>
__device__ __forceinline__ void decay_and_intra(const float (&gacc)[32],
                                                float (&yacc)[PW / 2], const float* cum,
                                                bool scale, uint32_t xth, uint32_t xtl,
                                                int row0, int t4) {
  // element e of G's fragment, (row0 + 8 r8, token 8 (e / 4) + 2 t4 +
  // (e & 1)), goes to the A fragment of k-step e / 4 as it stands: its
  // quad holds (row0, 2 t4), (row0 + 8, 2 t4), (row0, 2 t4 + 1),
  // (row0 + 8, 2 t4 + 1), X^T's token order
  const float ci[2] = {cum[row0], cum[row0 + 8]};
  uint32_t mh[kT / 8][4], ml[kT / 8][4];
#pragma unroll
  for (int jb = 0; jb < kT / 8; ++jb) {
    const float2 cj = *reinterpret_cast<const float2*>(cum + 8 * jb + 2 * t4);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int r8 = q & 1, c1 = q >> 1;    // (row0 + 8 r8, token 8 jb + 2 t4 + c1)
      const int i = row0 + 8 * r8, j = 8 * jb + 2 * t4 + c1;
      const float arg = j <= i ? ci[r8] - (c1 ? cj.y : cj.x) : -INFINITY;
      split_u(gacc[4 * jb + 2 * r8 + c1] * ex2(arg), mh[jb][q], ml[jb][q]);
    }
  }
  if (scale) {
    const float ei[2] = {ex2(ci[0]), ex2(ci[1])};
#pragma unroll
    for (int e = 0; e < PW / 2; ++e) yacc[e] *= ei[(e >> 1) & 1];
  }
  fence_regs(yacc);
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < kT / 8; ++j) {
    const uint32_t xo = (j >> 2) * PW * 128 + (j & 3) * 32;
    wgmma_rs(yacc, ml[j], desc(xth + xo));
    wgmma_rs(yacc, mh[j], desc(xtl + xo));
    wgmma_rs(yacc, mh[j], desc(xth + xo));
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(yacc);
}

// y of tile t out from the fragment, (row, 2 adjacent columns) a pair;
// streaming (evict-first) stores: the model layout's strided rows 0.307
// against 0.322 ms at hymba's prefill block (H100 80GB HBM3, 700 W)
template <int PW>
__device__ __forceinline__ void store_y(const float (&yacc)[PW / 2], const Args& a,
                                        const Span& sp, int t, int row0, int t4) {
  const int valid = min(kT, a.S - t * kT);
#pragma unroll
  for (int e = 0; e < PW / 2; e += 2) {
    const int i = row0 + 8 * ((e >> 1) & 1), p = 8 * (e >> 2) + 2 * t4;
    if (i >= valid || p >= sp.pc) continue;
    float* o = sp.y + (long long)(t * kT + i) * a.ys.s + p;
    if (a.vy == 2 && p + 1 < sp.pc) {
      __stcs(reinterpret_cast<float2*>(o), make_float2(yacc[e], yacc[e + 1]));
    } else {
      __stcs(o, yacc[e]);
      if (p + 1 < sp.pc) __stcs(o + 1, yacc[e + 1]);
    }
  }
}

// A small state: h^T (rows p) = dk h^T + X^T (B o w), both operands from
// shared memory
template <int PW, int NS>
__device__ __forceinline__ void small_state_update(float (&hacc)[NS / 2], float dk,
                                                   uint32_t xth, uint32_t xtl,
                                                   uint32_t bwh, uint32_t bwl) {
#pragma unroll
  for (int e = 0; e < NS / 2; ++e) hacc[e] *= dk;
  fence_regs(hacc);
  wgmma_fence();
#pragma unroll
  for (int k = 0; k < kT / 8; ++k) {
    const uint32_t xo = (k >> 2) * PW * 128 + (k & 3) * 32;
    const uint32_t bo = (k >> 2) * NS * 128 + (k & 3) * 32;
    wgmma_ss(hacc, desc(xtl + xo), desc(bwh + bo));
    wgmma_ss(hacc, desc(xth + xo), desc(bwl + bo));
    wgmma_ss(hacc, desc(xth + xo), desc(bwh + bo));
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(hacc);
}

// h^T hi/lo for the next tile's inter term (rows p, K = n), from a state
// accumulator tile m: h^T's fragment (rows p) when small, h's (rows n)
template <int PW, int NS, int HN>
__device__ __forceinline__ void store_ht(const float (&hacc)[HN], int m, float* hth,
                                         float* htl, int N8, int row0, int t4) {
#pragma unroll
  for (int e = 0; e < HN; ++e) {
    const int r = row0 + 8 * ((e >> 1) & 1), c = 8 * (e >> 2) + 2 * t4 + (e & 1);
    const int p = small_state(NS) ? r : c, n = small_state(NS) ? c : 64 * m + r;
    if (p >= PW || n >= N8) continue;
    float hi, lo;
    split(hacc[e], hi, lo);
    const int off = sw(PW, p, n);
    hth[off] = hi;
    htl[off] = lo;
  }
}

// One warpgroup walks the chunks and does every part of a tile in turn
// (any state width; the large state's update lives here).
template <int PW, int NS>
__global__ void __launch_bounds__(kThreads, 1) ssd_scan_tc(const Args a) {
  constexpr bool kSmall = small_state(NS);
  constexpr int NT = kSmall ? 1 : NS / 64;  // accumulator tiles of the state
  constexpr int HN = kSmall ? NS / 2 : PW / 2;  // floats of one
  extern __shared__ unsigned char smem_raw[];
  float* sm = reinterpret_cast<float*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int N = a.N, N8 = (N + 7) & ~7, nk = N8 / 8, NB = state_boxes(N);
  const Layout L = layout(PW, NB, a.stages, NS, 1);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row0 = 16 * warp + (lane >> 2), t4 = lane & 3;
  const Span sp = span(a, PW);
  const int nT = (a.S + kT - 1) / kT;
  const Walk wx = walk(sp.pc / a.vx, tid), wb = walk(N / a.vb, tid);

  {
    float4* v = reinterpret_cast<float4*>(sm);
    for (int i = tid; i < L.total / 4; i += kThreads)
      v[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncthreads();
  for (int t = 0; t < a.stages - 1; ++t) {
    if (t < nT) load_tile<PW>(sm, L, a, sp, t, t, NB, wx, wb, tid);
    cp_async_commit();
  }

  float* cum = sm + L.cum;
  float* wts = sm + L.wts;
  float* blo = sm + L.blo;
  const uint32_t xth = smem_u32(sm + L.xth), xtl = smem_u32(sm + L.xtl);
  const uint32_t hth = smem_u32(sm + L.hth), htl = smem_u32(sm + L.htl);
  const uint32_t bwh = smem_u32(sm + L.bwh), bwl = smem_u32(sm + L.bwl);
  const uint32_t blo_u = smem_u32(blo);
  // large state: where this thread's (B o w)^T fragment values lie in the
  // B tile, (token 2 t4 (+1), row n0 (+8)); + 256 a k-step of 8 tokens,
  // + 4096 a 64-row tile of the state
  const int boff[4] = {sw(kT, 2 * t4, row0), sw(kT, 2 * t4, row0 + 8),
                       sw(kT, 2 * t4 + 1, row0), sw(kT, 2 * t4 + 1, row0 + 8)};
  float hacc[NT][HN];
#pragma unroll
  for (int m = 0; m < NT; ++m)
#pragma unroll
    for (int e = 0; e < HN; ++e) hacc[m][e] = 0.f;

  for (int t = 0; t < nT; ++t) {
    const int s = t % a.stages;
    {
      const int tn = t + a.stages - 1;      // its slot was tile t - 1's
      if (tn < nT) load_tile<PW>(sm, L, a, sp, tn, tn % a.stages, NB, wx, wb, tid);
      cp_async_commit();
      cp_async_wait(a.stages - 1);
      __syncthreads();
    }
    float* br = sm + L.br + s * kT * 32 * NB;
    const float* cr = sm + L.cr + s * kT * 32 * NB;
    const float* xr = sm + L.xr + s * kT * PW;

    const Cum cm = tile_cumsum(sm + L.la + s * kT, cum, kSmall ? nullptr : wts, lane,
                               warp == 0);
    split_pass<PW, NS>(xr, br, blo, sm + L.xth, sm + L.xtl, sm + L.bwh, sm + L.bwl, N8,
                       cm, tid);
    fence_async_smem();
    __syncthreads();

    float gacc[32], yacc[PW / 2];
    g_and_inter<PW>(gacc, yacc, cr, smem_u32(br), blo_u, hth, htl, t > 0, nk, row0, t4);
    decay_and_intra<PW>(gacc, yacc, cum, t > 0, xth, xtl, row0, t4);
    store_y<PW>(yacc, a, sp, t, row0, t4);

    if (t + 1 < nT) {                        // no state after the last tile
      // ---- the state: h = e^tot h + (B o w)^T X, w = exp2(tot - cum) ----
      const float dk = ex2(cm.tot);
      if constexpr (kSmall) {
        small_state_update<PW, NS>(hacc[0], dk, xth, xtl, bwh, bwl);
      } else {
        // h (rows n) += (B o w)^T X, A from registers (B as hi + lo)
#pragma unroll
        for (int m = 0; m < NT; ++m) {
#pragma unroll
          for (int e = 0; e < HN; ++e) hacc[m][e] *= dk;
          uint32_t bh[kT / 8][4], bl[kT / 8][4];
          const int n0 = 64 * m + row0;
#pragma unroll
          for (int k = 0; k < kT / 8; ++k) {
            const float2 w = *reinterpret_cast<const float2*>(wts + 8 * k + 2 * t4);
            const int o = 256 * k + 4096 * m;
            const float v[4] = {
                n0 < N ? (br[boff[0] + o] + blo[boff[0] + o]) * w.x : 0.f,
                n0 + 8 < N ? (br[boff[1] + o] + blo[boff[1] + o]) * w.x : 0.f,
                n0 < N ? (br[boff[2] + o] + blo[boff[2] + o]) * w.y : 0.f,
                n0 + 8 < N ? (br[boff[3] + o] + blo[boff[3] + o]) * w.y : 0.f};
#pragma unroll
            for (int q = 0; q < 4; ++q) split_u(v[q], bh[k][q], bl[k][q]);
          }
          fence_regs(hacc[m]);
          wgmma_fence();
#pragma unroll
          for (int k = 0; k < kT / 8; ++k) {
            const uint32_t xo = (k >> 2) * PW * 128 + (k & 3) * 32;
            wgmma_rs(hacc[m], bl[k], desc(xth + xo));
            wgmma_rs(hacc[m], bh[k], desc(xtl + xo));
            wgmma_rs(hacc[m], bh[k], desc(xth + xo));
          }
          wgmma_commit();
          wgmma_wait_all();
          fence_regs(hacc[m]);
        }
      }
      // every warp is past its wgmmas that read h^T, X^T and B lo
      __syncthreads();
#pragma unroll
      for (int m = 0; m < NT; ++m)
        store_ht<PW, NS>(hacc[m], m, sm + L.hth, sm + L.htl, N8, row0, t4);
      fence_async_smem();
    }
  }
  cp_async_wait(0);
}

// Two warpgroups, for a small state: a producer (threads 128-255) starts
// the loads and does each tile's split pass and state update, one tile
// ahead of a consumer (threads 0-127) that does G, the inter and intra
// terms and y. The split pass's tiles, cum and h^T come in two sets by
// tile parity; six mbarriers (count 128) pass them: full[p] (tile t's
// split pass done), ready[p] (h after tile t in h^T[p]), done[p] (the
// consumer is through tile t), p = t & 1, phase t / 2.
template <int PW, int NS>
__global__ void __launch_bounds__(2 * kThreads, 1) ssd_scan_ws(const Args a) {
  static_assert(small_state(NS), "a producer warpgroup takes a small state");
  extern __shared__ unsigned char smem_raw[];
  float* sm = reinterpret_cast<float*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int N = a.N, N8 = (N + 7) & ~7, nk = N8 / 8, NB = state_boxes(N);
  const Layout L = layout(PW, NB, a.stages, NS, 2);
  const int tid = threadIdx.x, wt = tid & (kThreads - 1);
  const int warp = wt >> 5, lane = tid & 31;
  const int row0 = 16 * warp + (lane >> 2), t4 = lane & 3;
  const Span sp = span(a, PW);
  const int nT = (a.S + kT - 1) / kT;
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L.bar);
  uint64_t* ready = full + 2;
  uint64_t* done = full + 4;

  {
    float4* v = reinterpret_cast<float4*>(sm);
    for (int i = tid; i < L.total / 4; i += 2 * kThreads)
      v[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncthreads();
  if (tid == 0) {
    for (int i = 0; i < 6; ++i) mbar_init(full + i, kThreads);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= kThreads) {
    // ---- producer ----
    const Walk wx = walk(sp.pc / a.vx, wt), wb = walk(N / a.vb, wt);
    for (int t = 0; t < a.stages - 1; ++t) {
      if (t < nT) load_tile<PW>(sm, L, a, sp, t, t, NB, wx, wb, wt);
      cp_async_commit();
    }
    float hacc[NS / 2];
#pragma unroll
    for (int e = 0; e < NS / 2; ++e) hacc[e] = 0.f;
    for (int t = 0; t < nT; ++t) {
      const int s = t % a.stages, p = t & 1;
      cp_async_wait(a.stages - 2);          // tile t's copies (stages >= 2)
      bar_group(1);
      if (t >= 2) mbar_wait(done + p, ((t - 2) >> 1) & 1);   // set p is free
      float* xth = sm + L.xth + p * L.nxt;
      float* xtl = sm + L.xtl + p * L.nxt;
      float* bwh = sm + L.bwh + p * L.nbw;
      float* bwl = sm + L.bwl + p * L.nbw;
      const Cum cm = tile_cumsum(sm + L.la + s * kT, sm + L.cum + p * kT, nullptr, lane,
                                 warp == 0);
      split_pass<PW, NS>(sm + L.xr + s * kT * PW, sm + L.br + s * kT * 32 * NB,
                         sm + L.blo + p * L.nblo, xth, xtl, bwh, bwl, N8, cm, wt);
      fence_async_smem();
      bar_group(1);
      mbar_arrive(full + p);
      if (t + 1 < nT)
        small_state_update<PW, NS>(hacc, ex2(cm.tot), smem_u32(xth), smem_u32(xtl),
                                   smem_u32(bwh), smem_u32(bwl));
      // the consumer is through tile t - 1: h^T[p] (read by its inter
      // term) and tile t - 1's ring slot are free
      if (t >= 1) mbar_wait(done + (p ^ 1), ((t - 1) >> 1) & 1);
      if (t + 1 < nT) {
        store_ht<PW, NS>(hacc, 0, sm + L.hth + p * L.nht, sm + L.htl + p * L.nht, N8,
                         row0, t4);
        fence_async_smem();
        mbar_arrive(ready + p);
      }
      const int tn = t + a.stages - 1;
      if (tn < nT) load_tile<PW>(sm, L, a, sp, tn, tn % a.stages, NB, wx, wb, wt);
      cp_async_commit();
    }
    cp_async_wait(0);
  } else {
    // ---- consumer ----
    for (int t = 0; t < nT; ++t) {
      const int s = t % a.stages, p = t & 1;
      mbar_wait(full + p, (t >> 1) & 1);
      if (t > 0) mbar_wait(ready + (p ^ 1), ((t - 1) >> 1) & 1);
      float gacc[32], yacc[PW / 2];
      g_and_inter<PW>(gacc, yacc, sm + L.cr + s * kT * 32 * NB,
                      smem_u32(sm + L.br + s * kT * 32 * NB),
                      smem_u32(sm + L.blo + p * L.nblo),
                      smem_u32(sm + L.hth + (p ^ 1) * L.nht),
                      smem_u32(sm + L.htl + (p ^ 1) * L.nht), t > 0, nk, row0, t4);
      decay_and_intra<PW>(gacc, yacc, sm + L.cum + p * kT, t > 0,
                          smem_u32(sm + L.xth + p * L.nxt),
                          smem_u32(sm + L.xtl + p * L.nxt), row0, t4);
      store_y<PW>(yacc, a, sp, t, row0, t4);
      mbar_arrive(done + p);
    }
  }
}

struct Plan {
  int pw, slices, stages, groups, bytes;    // groups: warpgroups a block
};

int width_for(int p) {
  for (int w : kWidths)
    if (p <= w) return w;
  return 0;
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      n = 132;
  }
  return n;
}

// The block's P slice, warpgroups and ring depth. The fewest slices of
// at most 64 columns, doubled once for a large state when the grid leaves
// SMs idle and the narrower width saves something (mamba2-370m's 64
// heads: 0.78 ms against 1.0 at one slice; a small state's block is short,
// and hymba's 128 heads at one slice of 56 beat two of 32, 0.364 ms
// against 0.381, H100 80GB HBM3, 700 W); a producer warpgroup for a small
// state whose grid fits one block an SM, its slice widened to 64 columns
// past 32 (hymba's prefill: 0.290 ms against 0.346 at 56); the most
// stages (<= 3, <= the tiles, >= 2 with a producer) that let the blocks
// an SM must take (<= 2) share its shared memory, else that one block's.
// false: no plan fits.
bool make_plan(int G, int r, int S, int P, int N, Plan* out) {
  if (N < 1 || N > 128 || P < 1 || S < 1) return false;
  const int nT = (S + kT - 1) / kT;
  const bool small = small_state(state_width(N));
  int slices = (P + 63) / 64;
  const int cur = width_for((P + slices - 1) / slices);
  const int half = width_for((P + 2 * slices - 1) / (2 * slices));
  if (!small && (long long)G * r * slices < sm_count() && half < cur) slices *= 2;
  int pw = width_for((P + slices - 1) / slices);
  const long long blocks = (long long)G * r * slices;
  const int groups = small && blocks <= sm_count() ? 2 : 1;
  if (groups == 2 && pw > 32) pw = 64;
  const int share = groups == 1 && blocks > sm_count() ? 2 : 1;
  const int budget = kSmemPerSM / share - 1024;
  int stages = nT < kMaxStages ? nT : kMaxStages;
  if (stages < groups) stages = groups;
  while (stages > groups &&
         smem_bytes(pw, N, stages, groups) > (budget < kMaxSmem ? budget : kMaxSmem))
    --stages;
  const int bytes = smem_bytes(pw, N, stages, groups);
  if (bytes > kMaxSmem) return false;
  *out = Plan{pw, slices, stages, groups, bytes};
  return true;
}

// The widest access (4, 2 or 1 floats) that rows of n floats at ptr + the
// given strides keep aligned.
int access_width(const void* ptr, int n, long long s1, long long s2, long long s3) {
  for (int V = 4; V > 1; V /= 2)
    if (n % V == 0 && s1 % V == 0 && s2 % V == 0 && s3 % V == 0 &&
        reinterpret_cast<uintptr_t>(ptr) % (4 * V) == 0)
      return V;
  return 1;
}

template <typename K>
int launch(K kernel, int threads, const Args& a, int G, int bytes, cudaStream_t s,
           bool& configured) {
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  kernel<<<dim3(a.r * a.slices, G), threads, bytes, s>>>(a);
  return (int)cudaGetLastError();
}

template <int PW, int NS>
int launch_tiles(const Args& a, int G, const Plan& pl, cudaStream_t s) {
  if constexpr (small_state(NS)) {
    if (pl.groups == 2) {
      static bool configured = false;
      return launch(ssd_scan_ws<PW, NS>, 2 * kThreads, a, G, pl.bytes, s, configured);
    }
  }
  static bool configured = false;
  return launch(ssd_scan_tc<PW, NS>, kThreads, a, G, pl.bytes, s, configured);
}

template <int PW>
int launch_ns(const Args& a, int G, const Plan& pl, cudaStream_t s) {
  switch (state_width(a.N)) {
    case 16: return launch_tiles<PW, 16>(a, G, pl, s);
    case 32: return launch_tiles<PW, 32>(a, G, pl, s);
    case 64: return launch_tiles<PW, 64>(a, G, pl, s);
    default: return launch_tiles<PW, 128>(a, G, pl, s);
  }
}

}  // namespace

extern "C" {

// Tokens a tile (the chunk the kernel walks, whatever the caller's Q).
int ssd_scan_tile() { return kT; }

// The plan a call takes: out = {PW, slices, stages, warpgroups a block,
// shared bytes}. Returns 0, or cudaErrorInvalidValue when no block fits.
int ssd_scan_plan(int G, int r, int S, int P, int N, int* out) {
  Plan pl;
  if (G < 1 || r < 1 || !make_plan(G, r, S, P, N, &pl))
    return (int)cudaErrorInvalidValue;
  out[0] = pl.pw;
  out[1] = pl.slices;
  out[2] = pl.stages;
  out[3] = pl.groups;
  out[4] = pl.bytes;
  return 0;
}

// Returns a cudaError_t (0 = launched); cudaErrorInvalidValue for sizes it
// cannot run, among them tiles over the shared memory a block may have.
int ssd_scan_f32(const float* xdt, long long xg, long long xh, long long xs,
                 const float* la, long long lg, long long lh, long long ls,
                 const float* b, const float* c, float* y, long long yg,
                 long long yh, long long ys, int G, int r, int S, int P, int N,
                 int Q, void* stream) {
  Plan pl;
  if (G < 1 || r < 1 || Q < 1 || S < Q || S % Q != 0 || G > 65535 ||
      !make_plan(G, r, S, P, N, &pl) ||
      (long long)r * pl.slices > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.xdt = xdt;
  a.xs = Strides{xg, xh, xs};
  a.la = la;
  a.ls = Strides{lg, lh, ls};
  a.b = b;
  a.c = c;
  a.y = y;
  a.ys = Strides{yg, yh, ys};
  a.r = r;
  a.S = S;
  a.P = P;
  a.N = N;
  a.slices = pl.slices;
  a.stages = pl.stages;
  a.vx = access_width(xdt, P, xg, xh, xs);
  const int vb = access_width(b, N, N, N, N), vc = access_width(c, N, N, N, N);
  a.vb = vb < vc ? vb : vc;
  a.vy = access_width(y, P, yg, yh, ys) >= 2 ? 2 : 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (pl.pw) {
    case 16: return launch_ns<16>(a, G, pl, s);
    case 32: return launch_ns<32>(a, G, pl, s);
    case 56: return launch_ns<56>(a, G, pl, s);
    default: return launch_ns<64>(a, G, pl, s);
  }
}

}  // extern "C"
