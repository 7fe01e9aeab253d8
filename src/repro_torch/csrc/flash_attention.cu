// GQA flash attention (forward) on Hopper (sm_90a), plain C interface for
// ctypes (see repro_torch/kernels/build.py and kernels/flash_attention.py).
//
//   out[b, h, i, :] = sum_j softmax_j(scale * q[b, h, i] . k[b, h / G, j])
//                     * v[b, h / G, j, :]
//   q (B, H, Sq, hd), k and v (B, KV, Sk, hd), H = KV * G, f32 or bf16,
//   hd 64 or 128; out (B, H, Sq, hd) in q's dtype; scale = hd^-0.5.
//   Each tensor is read (out written) through its strides: unit stride on
//   hd, the other strides and the base 16-byte aligned, so the model's
//   (B, S, H, hd) layout is taken as it is, with no copy.
//   Causal (key j <= query i) and/or a sliding window (j > i - window),
//   positions counted from 0 in both sequences; a masked score is excluded
//   exactly, and a row with no visible key gives 0 (the Pallas kernel's
//   acc / max(l, 1e-30)).
//   Replaces repro/kernels/flash_attention.py:flash_attention.
//
// Bound: 4 * hd flops per visible (query, key) pair against 2 * hd
// elements of q and out per row, so on an H100 the work is bound by
// operations, on the tensor cores in both dtypes: bf16 at 989 TFLOP/s;
// f32 as three TF32 products per product at 495 TFLOP/s, ~165 TFLOP/s of
// f32-accurate work. The dtype picks the kernel; neither stands in for the
// other.
//
// bf16: flash_fwd_kernel_tc, tensor cores fed by TMA.
//   * one block per (128-row q tile, head, batch) of 3 warpgroups: warp 0
//     of warpgroup 0 issues the TMA loads (cp.async.bulk.tensor, 128-byte
//     swizzle; the Q tile once, K and V tiles into a ring of kStages
//     stages with full/empty mbarriers), warpgroups 1 and 2 each own 64 q
//     rows; setmaxnreg moves registers from the producer to them;
//   * the tensor maps are 4-D (hd, S, heads, B) over the caller's strides,
//     built on the host by cuTensorMapEncodeTiled, reached through the
//     runtime's driver entry point (no -lcuda), passed as
//     __grid_constant__ parameters; TMA zero-fills rows and keys past Sq
//     and Sk, and hd 128 loads as two 64-column boxes;
//   * S = Q K^T on wgmma (bf16 in, f32 accumulate, both operands K-major
//     in shared memory); the online softmax runs on the accumulator
//     fragment in registers (row max and sum over the 4 threads of a row
//     by shuffles, exp2f with scale * log2(e) folded in, m and l per row
//     in registers) and masks only the tiles that need it (the window's
//     first tile, the causal diagonal, the ragged end of Sk);
//   * O += P V on wgmma with P from registers and V MN-major in shared
//     memory (the transpose-B flag). P is split into P_hi = bf16(P) and
//     P_lo = bf16(P - P_hi), two wgmmas: one bf16 P puts a few outputs
//     per million past the check of one bf16 ulp against the f32 plain
//     version (rtol 1e-2, atol 1e-3), hi + lo none;
//   * the KV loop runs from the window's first tile to the causal
//     frontier; with a causal mask and no window the q tiles with the most
//     KV tiles are launched first;
//   * the epilogue divides by max(l, 1e-30) and stores bf16 pairs, rows
//     past Sq skipped.
//
// f32: flash_fwd_kernel_tf32, the same shape of kernel in 3xTF32.
//   * the block, producer, ring and barriers are the bf16 kernel's; the f32
//     tensor maps have boxes of 32 columns (128 bytes, 128-byte swizzle:
//     hd 64 is 2 boxes, hd 128 is 4), and K/V tiles hold BKT keys;
//   * a split pass by the 256 consumer threads turns each arrived tile into
//     what the wgmmas read: hi = tf32(x) (cvt.rna, stored rounded, so
//     wgmma's dropping of the low 13 bits changes nothing) and lo =
//     tf32(x - hi) (x - hi is exact in f32). Q (each warpgroup its 64 rows,
//     once) and K keep hi in place and lo in a buffer of their own. tf32
//     wgmma reads B only K-major and V is MN-major as stored, so V is
//     transposed on the way: V_hi^T over the arrived V, V_lo^T in its own
//     buffer, keys permuted within each group of 8 so that P's accumulator
//     fragment is already wgmma's A fragment (column t of a k-step is key
//     2t, column t + 4 key 2t + 1): no shuffles;
//   * S = Q_lo K_hi + Q_hi K_lo + Q_hi K_hi, m64nBKTk8 wgmmas from shared
//     memory, and O += P_lo V_hi + P_hi V_lo + P_hi V_hi with P hi and lo
//     from registers, f32 accumulation. One TF32 product per product
//     misses the f32 check (rtol = atol = 2e-5) ~9-fold; the three pass it
//     ~100-fold (tests/test_torch_flash_f32_tc.py emulates the schedule);
//   * the softmax, masks, KV tile range and epilogue are the bf16
//     kernel's (O stored as f32 pairs); every causal problem runs its
//     q tiles in reverse (the most KV tiles first), with or without a
//     window;
//   * the lo buffers are shared by the stages and the two warpgroups, so a
//     tile takes two named barriers of the 256 consumer threads: one before
//     the split (both are past the previous tile's wgmmas; the raw V is in
//     registers) and one after it. No atomics, sums in a fixed order: two
//     calls on the same inputs give the same bits.
//   Shared memory, the binding limit (f32 tiles and their lo parts):
//     hd 64,  BKT 64, 2 stages: Q 32 KB + Q_lo 32 + 2 x (K 16 + V 16)
//             + K_lo 16 + V_lo^T 16 = 160 KB;
//     hd 128, BKT 32, 2 stages: 64 + 64 + 2 x (16 + 16) + 16 + 16 = 224 KB
//             of the 227 KB a block may have (+ 1 KB to align).
//   Registers a consumer thread: S BKT / 2, P_hi and P_lo BKT / 2 each,
//   O hd / 2 (hd 64: 32 + 64 + 32; hd 128: 16 + 32 + 64).

#include <cstdint>
#include <cuda.h>           // CUtensorMap and its enums (types only)
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

// element strides of a (B, heads, S, hd) tensor; hd has unit stride
struct Strides {
  int64_t b, h, s;
};

// ---------------------------------------------------------------------------
// both kernels: mbarriers, TMA, wgmma descriptors and fences, tensor maps
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)), "r"(bytes) : "memory");
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

// TMA: box of the 4-D map at (c0 = hd column, c1 = row, c2 = head, c3 = batch)
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle; offsets in bytes
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
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

// keep the compiler from moving accumulator registers across wgmma issue
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// cuTensorMapEncodeTiled, reached through the runtime (no -lcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a 4-D map (hd, S, heads, B) of elem-byte values (bf16 or f32) over the
// tensor's strides; box (128 / elem, rows, 1, 1), i.e. 128-byte rows, with
// the 128-byte swizzle, zero fill out of bounds
int make_map(CUtensorMap* map, const void* base, const Strides& st, int elem,
             int HD, int S, int heads, int B, int rows) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)HD, (cuuint64_t)S, (cuuint64_t)heads,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st.s * elem, (cuuint64_t)st.h * elem,
                                 (cuuint64_t)st.b * elem};
  const cuuint32_t box[4] = {(cuuint32_t)(128 / elem), (cuuint32_t)rows, 1, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  CUresult res = fn(map, elem == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                   : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                    4, const_cast<void*>(base), dims, strides, box, estr,
                    CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                    CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                    CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : 10000 + (int)res;
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (wgmma) fed by TMA
// ---------------------------------------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kConsumers = 2;               // warpgroups of 64 q rows each
constexpr int BQ = 64 * kConsumers;         // q rows per block
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int BKT = 128;                    // keys per K/V tile (hd 64 and 128)
constexpr int kStages = 2;                  // K/V ring depth
constexpr int kBox = 64;                    // hd columns per TMA box (128 B)

// One tile is HD / 64 boxes of [rows][64] bf16, each row 128 bytes, laid
// out by TMA with the 128-byte swizzle (1024-byte atoms of 8 rows).
template <int HD>
struct Smem {
  bf16 q[BQ * HD];
  bf16 k[kStages][BKT * HD];
  bf16 v[kStages][BKT * HD];
  uint64_t q_full;
  uint64_t full[kStages];
  uint64_t empty[kStages];
};

// S (64 x 128, f32) += A (64 x 16, shared) B (128 x 16, shared), both
// K-major; scale_d 0 overwrites S
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a, uint64_t b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// O (64 x N, f32) += A (64 x 16, registers) B (16 x N, shared, MN-major:
// the transpose-B flag), N = 64 or 128
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
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

__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}


__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&t);
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel_tc(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    bf16* __restrict__ o, Strides so, int H, int KV, int Sq,
                    int Sk, int causal, int window, float scale_log2) {
  constexpr int NB = HD / kBox;             // boxes per row of a tile
  extern __shared__ unsigned char smem_raw[];
  // TMA's 128-byte swizzle wants 1024-byte aligned tiles
  Smem<HD>& sm = *reinterpret_cast<Smem<HD>*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int nq = gridDim.z;
  // causal, no window: the q tiles with the most KV tiles go first
  const int qt = (causal && window == 0) ? nq - 1 - (int)blockIdx.z
                                         : (int)blockIdx.z;
  const int q0 = qt * BQ;
  const int kvh = h / (H / KV);

  // KV tiles any row of this block can see: [t_lo, t_hi)
  const int q_last = min(q0 + BQ, Sq) - 1;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_hi = causal ? min(Sk, q_last + 1) : Sk;
  const int t_lo = k_lo / BKT;
  const int n_tiles = max(0, (k_hi + BKT - 1) / BKT - t_lo);

  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], 128 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread issues every TMA load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(&sm.q_full, BQ * HD * sizeof(bf16));
#pragma unroll
      for (int bx = 0; bx < NB; ++bx)
        tma_load(sm.q + bx * BQ * kBox, &tq, &sm.q_full, bx * kBox, q0, h, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        mbar_wait(&sm.empty[s], ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(&sm.full[s], 2 * BKT * HD * sizeof(bf16));
        const int kt = (t_lo + it) * BKT;
#pragma unroll
        for (int bx = 0; bx < NB; ++bx) {
          tma_load(sm.k[s] + bx * BKT * kBox, &tk, &sm.full[s], bx * kBox, kt,
                   kvh, b);
          tma_load(sm.v[s] + bx * BKT * kBox, &tv, &sm.full[s], bx * kBox, kt,
                   kvh, b);
        }
      }
    }
  } else {
    // ---- consumers: 64 q rows per warpgroup ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int c = wg - 1;
    const int t = threadIdx.x % 128;
    const int warp = t / 32, lane = t % 32;
    const int r_lo = q0 + 64 * c;             // this warpgroup's rows
    const int r_hi = r_lo + 63;
    const int row0 = r_lo + 16 * warp + lane / 4;  // and row0 + 8
    const int col0 = 2 * (lane % 4);

    float acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.f, 0.f};                   // this thread's share of the row sums

    const uint32_t q_base = smem_u32(sm.q) + 64 * c * 128;
    mbar_wait(&sm.q_full, 0);

    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % kStages;
      const int kt = (t_lo + it) * BKT;
      mbar_wait(&sm.full[s], (it / kStages) & 1);
      // a tile none of this warpgroup's rows can see: release it unread
      if ((causal && kt > r_hi) || (window > 0 && kt + BKT - 1 <= r_lo - window)) {
        mbar_arrive(&sm.empty[s]);
        continue;
      }

      // S = Q K^T: 64 x BKT in f32, HD / 16 wgmmas
      float sc[BKT / 2];
      const uint32_t k_base = smem_u32(sm.k[s]);
      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;  // bytes along a 128-byte row
        wgmma_ss(sc, desc(q_base + (kk / 4) * BQ * 128 + off, 16, 1024),
                 desc(k_base + (kk / 4) * BKT * 128 + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);

      // mask only where some (row, key) of this warpgroup is not visible
      const bool need_mask = (kt + BKT > Sk) || (causal && kt + BKT - 1 > r_lo) ||
                             (window > 0 && kt <= r_hi - window);
      if (need_mask) {
#pragma unroll
        for (int i = 0; i < BKT / 2; ++i) {
          const int row = row0 + 8 * ((i / 2) % 2);
          const int key = kt + 8 * (i / 4) + col0 + (i % 2);
          bool vis = key < Sk;
          if (causal) vis = vis && key <= row;
          if (window > 0) vis = vis && key > row - window;
          if (!vis) sc[i] = -INFINITY;
        }
      }

      // online softmax on the fragment: element i is row row0 + 8 * ((i/2)%2)
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < BKT / 2; ++i)
        mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], sc[i]);
      float m_use[2], alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r] * scale_log2);
        // a row with nothing visible yet keeps m = -inf: exp2 against 0
        m_use[r] = m_new == -INFINITY ? 0.f : m_new;
        alpha[r] = exp2f(m[r] - m_use[r]);
        m[r] = m_new;
      }
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < BKT / 2; ++i) {
        const int r = (i / 2) % 2;
        sc[i] = exp2f(fmaf(sc[i], scale_log2, -m_use[r]));
        rs[r] += sc[i];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) acc[i] *= alpha[(i / 2) % 2];

      // P as bf16 hi + lo A fragments: k-step j takes elements 8j .. 8j+7
      uint32_t ph[BKT / 4], pl[BKT / 4];
#pragma unroll
      for (int j = 0; j < BKT / 4; ++j) {
        const float x = sc[2 * j], y = sc[2 * j + 1];
        const __nv_bfloat162 hi = __floats2bfloat162_rn(x, y);
        const float2 hf = __bfloat1622float2(hi);
        ph[j] = *reinterpret_cast<const uint32_t*>(&hi);
        pl[j] = pack_bf16(x - hf.x, y - hf.y);
      }

      // O += P_hi V + P_lo V: V is [BKT keys][HD] (MN-major), 16 keys a step
      const uint32_t v_base = smem_u32(sm.v[s]);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < BKT / 16; ++j) {
        const uint32_t a[4] = {ph[4 * j], ph[4 * j + 1], ph[4 * j + 2], ph[4 * j + 3]};
        wgmma_rs(acc, a, desc(v_base + j * 16 * 128, BKT * 128, 1024));
      }
#pragma unroll
      for (int j = 0; j < BKT / 16; ++j) {
        const uint32_t a[4] = {pl[4 * j], pl[4 * j + 1], pl[4 * j + 2], pl[4 * j + 3]};
        wgmma_rs(acc, a, desc(v_base + j * 16 * 128, BKT * 128, 1024));
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      mbar_arrive(&sm.empty[s]);
    }

    // epilogue: the row sums over the 4 threads of a row, then O / l
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      inv[r] = 1.f / fmaxf(l[r], 1e-30f);
    }
    bf16* ob = o + b * so.b + h * so.h;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= Sq) continue;
      bf16* dst = ob + row * so.s + col0;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        *reinterpret_cast<uint32_t*>(dst + 8 * j) =
            pack_bf16(acc[4 * j + 2 * r] * inv[r], acc[4 * j + 2 * r + 1] * inv[r]);
    }
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o,
           const Strides* st, int B, int H, int KV, int Sq, int Sk, int causal,
           int window, float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  int err = make_map(&tq, q, st[0], sizeof(bf16), HD, Sq, H, B, BQ);
  if (!err) err = make_map(&tk, k, st[1], sizeof(bf16), HD, Sk, KV, B, BKT);
  if (!err) err = make_map(&tv, v, st[2], sizeof(bf16), HD, Sk, KV, B, BKT);
  if (err) return err;
  constexpr int bytes = (int)sizeof(Smem<HD>) + 1024;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel_tc<HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const float log2e = 1.4426950408889634f;
  dim3 grid(H, B, (Sq + BQ - 1) / BQ);
  flash_fwd_kernel_tc<HD><<<grid, kThreads, bytes, stream>>>(
      tq, tk, tv, static_cast<bf16*>(o), st[3], H, KV, Sq, Sk, causal, window,
      scale * log2e);
  return (int)cudaGetLastError();
}

}  // namespace tc

// ---------------------------------------------------------------------------
// f32: tensor cores in 3xTF32 (wgmma) fed by TMA
// ---------------------------------------------------------------------------

namespace tf32 {

constexpr int kConsumers = 2;               // warpgroups of 64 q rows each
constexpr int BQ = 64 * kConsumers;         // q rows per block
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kStages = 2;                  // K/V ring depth
constexpr int kBox = 32;                    // hd columns per TMA box (128 B)

// keys per K/V tile: what shared memory leaves room for (the header's budget)
template <int HD>
__host__ __device__ constexpr int key_tile() { return HD == 64 ? 64 : 32; }

// Every tile is [rows][32] f32 boxes, each row 128 bytes, 128-byte swizzle
// (1024-byte atoms of 8 rows); V^T is BKT / 32 boxes of [HD][32 keys].
template <int HD>
struct Smem {
  static constexpr int BKT = key_tile<HD>();
  float q[BQ * HD];                         // Q, then Q_hi in place
  float q_lo[BQ * HD];
  float k[kStages][BKT * HD];               // K, then K_hi in place
  float v[kStages][BKT * HD];               // V, then V_hi^T in place
  float k_lo[BKT * HD];                     // shared by the stages
  float vt_lo[BKT * HD];
  uint64_t q_full;
  uint64_t full[kStages];
  uint64_t empty[kStages];
};

// S (64 x 32, f32) (+)= A (64 x 8, shared) B (32 x 8, shared), tf32, both
// K-major; scale_d 0 overwrites S
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t a, uint64_t b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d));
}

// S (64 x 64, f32) (+)= A (64 x 8, shared) B (64 x 8, shared), tf32, both
// K-major; scale_d 0 overwrites S
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// O (64 x 64, f32) += A (64 x 8, registers) B (64 x 8, shared, K-major), tf32
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
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

// O (64 x 128, f32) += A (64 x 8, registers) B (128 x 8, shared, K-major), tf32
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
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

__device__ __forceinline__ float4 split4(float4 x, float4& lo) {
  float4 hi;
  split(x.x, hi.x, lo.x);
  split(x.y, hi.y, lo.y);
  split(x.z, hi.z, lo.z);
  split(x.w, hi.w, lo.w);
  return hi;
}

// n floats of x: hi in place, lo to the same offsets of lo (the swizzle
// permutes 16-byte chunks, so an elementwise pass keeps the layout)
__device__ __forceinline__ void split_tile(float* x, float* lo, int n, int t,
                                           int nt) {
  float4* xv = reinterpret_cast<float4*>(x);
  float4* lv = reinterpret_cast<float4*>(lo);
  for (int i = t; i < n / 4; i += nt) xv[i] = split4(xv[i], lv[i]);
}

__device__ __forceinline__ float lane_of(const float4& x, int j) {
  return j == 0 ? x.x : j == 1 ? x.y : j == 2 ? x.z : x.w;
}

// byte offset of the 16-byte chunk `chunk` (0..7) of row `row` of a box
// whose rows are 128 bytes, under the 128-byte swizzle
__device__ __forceinline__ int swz(int row, int chunk) {
  return row * 128 + ((chunk ^ (row % 8)) << 4);
}

__device__ __forceinline__ void bar_consumers() {
  asm volatile("bar.sync 1, %0;" ::"n"(128 * kConsumers) : "memory");
}

// generic-proxy writes to shared memory made visible to wgmma's reads
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel_tf32(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      float* __restrict__ o, Strides so, int H, int KV, int Sq,
                      int Sk, int causal, int window, float scale_log2) {
  constexpr int BKT = key_tile<HD>();
  constexpr int NB = HD / kBox;             // boxes per row of a Q or K tile
  static_assert(BKT * HD == 16 * 128 * kConsumers,
                "one 4 x 4 block of V a consumer thread");
  extern __shared__ unsigned char smem_raw[];
  Smem<HD>& sm = *reinterpret_cast<Smem<HD>*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int nq = gridDim.z;
  // causal: the q tiles with the most KV tiles go first
  const int qt = causal ? nq - 1 - (int)blockIdx.z : (int)blockIdx.z;
  const int q0 = qt * BQ;
  const int kvh = h / (H / KV);

  // KV tiles any row of this block can see: [t_lo, t_lo + n_tiles)
  const int q_last = min(q0 + BQ, Sq) - 1;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_hi = causal ? min(Sk, q_last + 1) : Sk;
  const int t_lo = k_lo / BKT;
  const int n_tiles = max(0, (k_hi + BKT - 1) / BKT - t_lo);

  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], 128 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread issues every TMA load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(&sm.q_full, BQ * HD * sizeof(float));
#pragma unroll
      for (int bx = 0; bx < NB; ++bx)
        tma_load(sm.q + bx * BQ * kBox, &tq, &sm.q_full, bx * kBox, q0, h, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        mbar_wait(&sm.empty[s], ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(&sm.full[s], 2 * BKT * HD * sizeof(float));
        const int kt = (t_lo + it) * BKT;
#pragma unroll
        for (int bx = 0; bx < NB; ++bx) {
          tma_load(sm.k[s] + bx * BKT * kBox, &tk, &sm.full[s], bx * kBox, kt,
                   kvh, b);
          tma_load(sm.v[s] + bx * BKT * kBox, &tv, &sm.full[s], bx * kBox, kt,
                   kvh, b);
        }
      }
    }
  } else {
    // ---- consumers: 64 q rows per warpgroup ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int c = wg - 1;
    const int ct = threadIdx.x - 128;         // 0 .. 255 over both warpgroups
    const int t = threadIdx.x % 128;
    const int warp = t / 32, lane = t % 32;
    const int r_lo = q0 + 64 * c;             // this warpgroup's rows
    const int r_hi = r_lo + 63;
    const int row0 = r_lo + 16 * warp + lane / 4;  // and row0 + 8
    const int col0 = 2 * (lane % 4);

    // this thread's block of V in the transposing split: keys key0 + 2i
    // (i = 0..3) at hd columns 4 dq .. 4 dq + 3, written to V^T chunk kq
    // of rows 4 dq .. 4 dq + 3. A V^T row's positions 8g .. 8g + 7 hold
    // keys 8g, 8g+2, 8g+4, 8g+6, 8g+1, 8g+3, 8g+5, 8g+7. The eight threads
    // of a quarter warp take eight kq and dq of one parity, so each 16-byte
    // read and write of theirs falls on eight distinct bank groups.
    const int kx = ct % 8, rest = ct / 8;
    const int kq = 8 * (rest % (BKT / 32)) + kx;
    const int r2 = rest / (BKT / 32);
    const int dq = 8 * (r2 / 8) + (((kx & 6) + 2 * (r2 % 4)) & 7) + ((r2 / 4) & 1);
    const int key0 = 8 * (kq / 2) + kq % 2;

    float acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.f, 0.f};                   // this thread's share of the row sums

    // split this warpgroup's Q rows (64 rows of each box, 8 KB apart)
    mbar_wait(&sm.q_full, 0);
#pragma unroll
    for (int bx = 0; bx < NB; ++bx) {
      const int off = bx * BQ * kBox + 64 * c * kBox;
      split_tile(sm.q + off, sm.q_lo + off, 64 * kBox, t, 128);
    }
    fence_async_smem();
    const uint32_t qh_base = smem_u32(sm.q) + 64 * c * 128;
    const uint32_t ql_base = smem_u32(sm.q_lo) + 64 * c * 128;
    const uint32_t kl_base = smem_u32(sm.k_lo);
    const uint32_t vl_base = smem_u32(sm.vt_lo);

    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % kStages;
      const int kt = (t_lo + it) * BKT;
      mbar_wait(&sm.full[s], (it / kStages) & 1);

      // ---- split pass: raw V to registers, then (once both warpgroups are
      // past the previous tile's wgmmas) K hi/lo and V^T hi/lo ----
      unsigned char* vbytes = reinterpret_cast<unsigned char*>(sm.v[s]);
      float4 vx[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = key0 + 2 * i;
        vx[i] = *reinterpret_cast<const float4*>(
            vbytes + (dq / 8) * BKT * 128 + swz(key, dq % 8));
      }
      bar_consumers();
      split_tile(sm.k[s], sm.k_lo, BKT * HD, ct, 128 * kConsumers);
      unsigned char* vlo = reinterpret_cast<unsigned char*>(sm.vt_lo);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 col = make_float4(lane_of(vx[0], j), lane_of(vx[1], j),
                                       lane_of(vx[2], j), lane_of(vx[3], j));
        const int off = (kq / 8) * HD * 128 + swz(4 * dq + j, kq % 8);
        float4 lo;
        *reinterpret_cast<float4*>(vbytes + off) = split4(col, lo);
        *reinterpret_cast<float4*>(vlo + off) = lo;
      }
      fence_async_smem();
      bar_consumers();

      // a tile none of this warpgroup's rows can see: release it unread
      if ((causal && kt > r_hi) || (window > 0 && kt + BKT - 1 <= r_lo - window)) {
        mbar_arrive(&sm.empty[s]);
        continue;
      }

      // S = Q K^T: 64 x BKT in f32, three wgmmas a k-step of 8
      float sc[BKT / 2];
      const uint32_t kh_base = smem_u32(sm.k[s]);
      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 8; ++kk) {
        const uint32_t qo = (kk / 4) * BQ * 128 + (kk % 4) * 32;
        const uint32_t ko = (kk / 4) * BKT * 128 + (kk % 4) * 32;
        wgmma_ss(sc, desc(ql_base + qo, 16, 1024), desc(kh_base + ko, 16, 1024),
                 kk > 0);
        wgmma_ss(sc, desc(qh_base + qo, 16, 1024), desc(kl_base + ko, 16, 1024), 1);
        wgmma_ss(sc, desc(qh_base + qo, 16, 1024), desc(kh_base + ko, 16, 1024), 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);

      // mask only where some (row, key) of this warpgroup is not visible
      const bool need_mask = (kt + BKT > Sk) || (causal && kt + BKT - 1 > r_lo) ||
                             (window > 0 && kt <= r_hi - window);
      if (need_mask) {
#pragma unroll
        for (int i = 0; i < BKT / 2; ++i) {
          const int row = row0 + 8 * ((i / 2) % 2);
          const int key = kt + 8 * (i / 4) + col0 + (i % 2);
          bool vis = key < Sk;
          if (causal) vis = vis && key <= row;
          if (window > 0) vis = vis && key > row - window;
          if (!vis) sc[i] = -INFINITY;
        }
      }

      // online softmax on the fragment: element i is row row0 + 8 * ((i/2)%2)
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < BKT / 2; ++i)
        mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], sc[i]);
      float m_use[2], alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r] * scale_log2);
        // a row with nothing visible yet keeps m = -inf: exp2 against 0
        m_use[r] = m_new == -INFINITY ? 0.f : m_new;
        alpha[r] = exp2f(m[r] - m_use[r]);
        m[r] = m_new;
      }
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < BKT / 2; ++i) {
        const int r = (i / 2) % 2;
        sc[i] = exp2f(fmaf(sc[i], scale_log2, -m_use[r]));
        rs[r] += sc[i];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) acc[i] *= alpha[(i / 2) % 2];

      // P as tf32 hi + lo A fragments. k-step j holds elements 4j .. 4j+3:
      // (row0, key 2t), (row0, 2t+1), (row0+8, 2t), (row0+8, 2t+1) with
      // t = lane % 4; the A fragment wants (row0, col t), (row0+8, col t),
      // (row0, col t+4), (row0+8, col t+4): V^T's key order makes column t
      // key 2t and column t+4 key 2t+1
      uint32_t ph[BKT / 2], pl[BKT / 2];
#pragma unroll
      for (int i = 0; i < BKT / 2; ++i) {
        float hi, lo;
        split(sc[i], hi, lo);
        ph[i] = __float_as_uint(hi);
        pl[i] = __float_as_uint(lo);
      }

      // O += P_lo V_hi + P_hi V_lo + P_hi V_hi: V^T is [HD][BKT] K-major
      const uint32_t vh_base = smem_u32(sm.v[s]);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < BKT / 8; ++j) {
        const uint32_t vo = (j / 4) * HD * 128 + (j % 4) * 32;
        const uint32_t ah[4] = {ph[4 * j], ph[4 * j + 2], ph[4 * j + 1], ph[4 * j + 3]};
        const uint32_t al[4] = {pl[4 * j], pl[4 * j + 2], pl[4 * j + 1], pl[4 * j + 3]};
        wgmma_rs(acc, al, desc(vh_base + vo, 16, 1024));
        wgmma_rs(acc, ah, desc(vl_base + vo, 16, 1024));
        wgmma_rs(acc, ah, desc(vh_base + vo, 16, 1024));
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      mbar_arrive(&sm.empty[s]);
    }

    // epilogue: the row sums over the 4 threads of a row, then O / l
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      inv[r] = 1.f / fmaxf(l[r], 1e-30f);
    }
    float* ob = o + b * so.b + h * so.h;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= Sq) continue;
      float* dst = ob + row * so.s + col0;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        *reinterpret_cast<float2*>(dst + 8 * j) =
            make_float2(acc[4 * j + 2 * r] * inv[r], acc[4 * j + 2 * r + 1] * inv[r]);
    }
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o,
           const Strides* st, int B, int H, int KV, int Sq, int Sk, int causal,
           int window, float scale, cudaStream_t stream) {
  constexpr int BKT = key_tile<HD>();
  CUtensorMap tq, tk, tv;
  int err = make_map(&tq, q, st[0], sizeof(float), HD, Sq, H, B, BQ);
  if (!err) err = make_map(&tk, k, st[1], sizeof(float), HD, Sk, KV, B, BKT);
  if (!err) err = make_map(&tv, v, st[2], sizeof(float), HD, Sk, KV, B, BKT);
  if (err) return err;
  constexpr int bytes = (int)sizeof(Smem<HD>) + 1024;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel_tf32<HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const float log2e = 1.4426950408889634f;
  dim3 grid(H, B, (Sq + BQ - 1) / BQ);
  flash_fwd_kernel_tf32<HD><<<grid, kThreads, bytes, stream>>>(
      tq, tk, tv, static_cast<float*>(o), st[3], H, KV, Sq, Sk, causal, window,
      scale * log2e);
  return (int)cudaGetLastError();
}

}  // namespace tf32

}  // namespace

extern "C" {

// dtype: 0 = float32 (3xTF32), 1 = bfloat16; both on the tensor cores.
// strides: 12 element strides, (b, head, s) of q, k, v and out in that
// order. Returns 0 when launched, else a cudaError_t (10000 + a CUresult
// when a tensor map is refused).
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int dtype, int B, int H, int KV, int Sq, int Sk,
                        int hd, int causal, int window, float scale,
                        const int64_t* strides, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || KV < 1 || H % KV != 0 || Sq < 1 || Sk < 1 || window < 0)
    return (int)cudaErrorInvalidValue;
  Strides st[4];
  for (int i = 0; i < 4; ++i)
    st[i] = {strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  if (dtype == 0 && hd == 64)
    return tf32::launch<64>(q, k, v, o, st, B, H, KV, Sq, Sk, causal, window, scale, s);
  if (dtype == 0 && hd == 128)
    return tf32::launch<128>(q, k, v, o, st, B, H, KV, Sq, Sk, causal, window, scale, s);
  if (dtype == 1 && hd == 64)
    return tc::launch<64>(q, k, v, o, st, B, H, KV, Sq, Sk, causal, window, scale, s);
  if (dtype == 1 && hd == 128)
    return tc::launch<128>(q, k, v, o, st, B, H, KV, Sq, Sk, causal, window, scale, s);
  return (int)cudaErrorInvalidValue;
}

// the q rows a block of each dtype's kernel takes (the grid's z extent is
// Sq over it), and the keys of its K/V tiles at head dim hd; 0 for a dtype
// or hd the kernels do not take
int flash_attention_q_tile(int dtype) {
  return dtype == 0 ? tf32::BQ : dtype == 1 ? tc::BQ : 0;
}

int flash_attention_key_tile(int dtype, int hd) {
  if (hd != 64 && hd != 128) return 0;
  if (dtype == 0) return hd == 64 ? tf32::key_tile<64>() : tf32::key_tile<128>();
  return dtype == 1 ? tc::BKT : 0;
}

}  // extern "C"
