// Hand-written Hopper (sm_90a) tensor-core kernels of the flagship
// transformer's attention and its backward, in bf16 with the probabilities
// rounded to bf16 before P·V: the path that the forward and the train step
// take.
//
// Built by ray_tpu_torch/models/kernels.py (through util/cuda_build.py) with
// one nvcc call and cuda_build.BASE_FLAGS (no fast math) into a shared
// library with a plain C interface, loaded with ctypes; the wrappers, the
// route between this file and the CUDA-core kernels of model_kernels.cu
// (`_attention_route`) and the plain PyTorch versions live in kernels.py.
// Every entry point launches on the stream it is given, allocates nothing,
// does not synchronise, and returns cudaGetLastError() after its launches
// (or a code of its own when a TMA descriptor cannot be made; see
// attention_sm90_error_string). Tensors are contiguous, 16-byte aligned
// bf16 [B, S, H, Dh] (q, k, v, out, dout, dq, dk, dv) and float32 [B, H,
// Sq] (m, l, dsum). Deterministic: no atomics, every sum in a fixed order,
// so two launches on the same inputs give the same bits.
//
// Kernels:
//   K8  attention_sm90_forward   replaces ray_tpu/models/transformer.py
//       _attention (:113-124) in bf16: logits = einsum(q, k) summed in f32,
//       times the scale, -1e30 where masked; m the row max, l = sum(exp(s -
//       m)); p = exp(s - m) / l (IEEE division) rounded to bf16; out = P·V
//       summed in f32 and rounded once. Writes m and l ([B, H, Sq] f32) for
//       the backward when given buffers.
//   K8  attention_sm90_block_update  K8's block form in bf16: replaces
//       ray_tpu/parallel/ring_attention.py _block_update (:41-69), one
//       online-softmax step of the float32 state (o, m, l) against one KV
//       block whose first key sits at k_off (the first query at q_off):
//       logits = einsum(q, k) summed in f32, times the scale, -1e30 where
//       q_off + i < k_off + j (causal); m_new = max(m, row max); p = exp(s -
//       m_new), 0 where masked (the reference's pmask), never rounded;
//       corr = exp(m - m_new); l = l corr + sum(p); o = o corr + P·V, the
//       float32 P·V summed apart and added last. State in: o [B, Sq, H, Dh],
//       m and l [B, H, Sq] (f32, m >= -1e30); state out: new buffers.
//       Float32 blocks stay on model_kernels.cu's CUDA cores.
//   K8' attention_sm90_backward  replaces the gradient of _attention that
//       jax.value_and_grad(loss_fn) forms (ray_tpu/parallel/tpu_train.py:78),
//       with the roundings of its jaxpr: dP = dO·V^T rounded to bf16; Dt =
//       sum_j (dP * (1 / (l * l))) * e; dS = ((dP / l) - Dt) * e, zero where
//       masked, times the scale; dV = round(P)^T·dO; dQ = dS·K and dK =
//       dS^T·Q from the float32 dS, each summed in f32 and rounded once.
//
// Bound: at the flagship's shapes (B 8, S 2 048, H 8, Dh 64, causal) K8's
// three products (QK^T twice, PV) are 51.6 GFLOP, K8''s about eleven
// product-equivalents; both are bound by operations, and beside the
// tensor-core products each (query, key) pair costs two (K8) or three (K8')
// IEEE expf and as many IEEE divisions on the CUDA cores, which the
// reference's numerics need and which no tensor core does. That elementwise
// work, not the products, is most of each kernel's time
// (ray_tpu_torch/scripts/profile_model.py --attention), so the design keeps
// it lean: a division is two residual steps from a·(1/b) with the row's
// reciprocal (div_rn: the IEEE quotient's bits by Markstein's theorem,
// without __fdiv_rn's per-element check and branch); each exp is taken
// unconditionally and a masked key selected away; and a tile that no mask
// or ragged edge touches runs a body compiled without masks (the kEdge
// templates).
//
// Design. Every product is a wgmma.mma_async, bf16 operands and a float32
// accumulator; one warpgroup (128 threads) a block owns 64 rows (queries in
// K8 and K8' launch 1, keys in launch 2). Tiles of 64 rows reach shared
// memory by TMA (cuTensorMapEncodeTiled, fetched with
// cudaGetDriverEntryPoint so the build needs no -lcuda) with mbarriers, in
// a ring of two stages: thread 0 issues tile t + 1 before the warpgroup
// multiplies tile t, and a block barrier at the end of a tile frees its
// stage. This is the two-stage pipeline without warp specialisation; the
// latency it leaves is covered by several blocks an SM (up to Dh 64, the
// register caps of __launch_bounds__ keep 4 blocks of K8 and 3 of each K8'
// launch on an SM). A tile is stored as Dh / W panels of [64 rows][W
// columns], W = the largest of 64, 32, 16 that divides Dh, swizzled 2W
// bytes (128, 64 or 32 B), the mode the wgmma descriptors name: K-major
// operands (Q, K, V, dO along Dh) advance 32 bytes a 16-column slice,
// MN-major ones (V, K, dO, Q as the B of a product along the rows) take
// the transpose bit, 8-row groups SBO apart and W-column panels LBO apart,
// so no tile is ever transposed by a copy. S = Q·K^T takes both operands
// from shared memory; the accumulator of S, packed to bf16 pairs, is the A
// fragment of m64nNk16, so P (and in the backward P^T and dS^T, from S^T =
// K·Q^T and dP^T = V·dO^T computed directly) go to the tensor cores from
// registers. dQ and dK need the float32 dS: it is split into hi = bf16(dS)
// and lo = bf16(dS - hi), and hi·K + lo·K is summed in the f32 accumulator
// (hi + lo is dS within 2^-16), not FlashAttention's one rounding of dS.
// The block form's P·V takes the float32 P the same way: hi·V + lo·V in
// one f32 accumulator (V is bf16, so exact as an operand), kept apart from
// o·corr until the end, as the reference adds pv last. Its bound at the ring
// step's [8, 512, 8, 64] is bytes (the f32 state read and written once);
// a float32 P·V at the CUDA cores' 67 TFLOP/s alone would take 0.032 ms,
// 3.6x the bytes' 0.0089 ms, so the split is what lets the step reach it.
// Causal key tiles above the diagonal are never loaded; the heaviest query
// tiles go first. K8 makes two passes over its key tiles (the first finds m
// and l online, the second forms P and P·V); K8' launch 1 (query-major)
// sweeps its key tiles twice (Dt, then dS and dQ) and writes Dt; launch 2
// (key-major) keeps K and V and streams Q, dO and the rows' m, l, Dt past
// them, with dK and dV in registers. The block form is K8's design with
// its state carried: pass 0 over the visible key tiles (K only) takes each
// row's max from m_in on, so pass 1 (K and V) forms every p against the
// final m_new as the reference does, one exp a pair and no division; m_in,
// l_in and o_in are read with plain loads (a TMA box of [B, H, Sq] floats
// at bh Sq + q0 faults at odd Sq), o_in at the end beside the accumulator.
// A query tile that sees no key of the block copies its state through.

#include <cstdint>
#include <cstdio>
#include <cuda.h>  // CUtensorMap and its enums only: the driver entry is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // one warpgroup
constexpr int kRows = 64;      // rows of a tile: queries or keys
constexpr float kNegInf = -1e30f;  // _NEG_INF of ring_attention.py
constexpr unsigned kFull = 0xffffffffu;
constexpr int kVecBytes = kRows * 4;  // one tile's m, l, 1 / l or Dt (float32)

// Built with -DATTN_SM90_PROFILE (ray_tpu_torch/scripts/profile_model.py
// --attention), each kernel sums the clock64() cycles that thread 0 spends
// in each phase of a tile, over all blocks: waiting for the tile's TMA
// loads, the first products (S, dP; issued and waited for), the elementwise
// softmax or dS work on the CUDA cores, the second products (P·V, dQ, dK and
// dV), the block barrier; and the whole kernel. The default build has none
// of it.
enum Phase { kWaitTiles, kProducts1, kElementwise, kProducts2, kBarrier, kWhole, kPhases };
#ifdef ATTN_SM90_PROFILE
__device__ unsigned long long g_profile[3][kPhases];
#define PROFILE_MARK(t) long long t = clock64()
#define PROFILE_ADD(kernel, phase, t)                                                    \
  do {                                                                                   \
    if (threadIdx.x == 0)                                                                \
      atomicAdd(&g_profile[kernel][phase], (unsigned long long)(clock64() - (t)));       \
  } while (0)
#else
#define PROFILE_MARK(t)
#define PROFILE_ADD(kernel, phase, t)
#endif

// ------------------------------------------------------------------ PTX

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait for the phase of parity `parity` to complete. A wait that never
// completes (a fault in the expected byte counts) traps after ~2^28 polls,
// seconds at least, so the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 28)) __trap();
  }
}

// One box of a [B, S, H, Dh] tensor map: coordinates (column, head, row, batch).
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// After wgmma_wait_all: the accumulator's registers are read no earlier.
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// A wgmma shared-memory matrix descriptor: start address, leading and
// stride byte offsets (16-byte units), swizzle mode (1: 128 B, 2: 64 B,
// 3: 32 B). Every tile starts 1 024-byte aligned, so the base offset is 0.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint32_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)layout << 62);
}


// ------------------------------------------------------------------ tiles

// A [64, kDh] bf16 tile in shared memory: kDh / kW panels of [64][kW],
// each row of a panel one swizzle span (2 kW bytes).
template <int kDh>
struct Tile {
  static constexpr int kLow = kDh & -kDh;
  static constexpr int kW = kLow < 64 ? kLow : 64;
  static constexpr int kRowBytes = 2 * kW;
  static constexpr int kPanelBytes = kRows * kRowBytes;
  static constexpr int kBytes = kRows * kDh * 2;
  static constexpr uint32_t kLayout = kW == 64 ? 1 : kW == 32 ? 2 : 3;
  static_assert(kDh % 16 == 0 && kDh >= 16 && kDh <= 128, "head width");
};

// K-major operand (rows x Dh, Dh the reduction): the 16 columns of slice kk.
template <int kDh>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
  using T = Tile<kDh>;
  const int col = 16 * kk;
  return make_desc(tile + (col / T::kW) * T::kPanelBytes + (col % T::kW) * 2, 16,
                   8 * T::kRowBytes, T::kLayout);
}

// MN-major operand (rows the reduction, Dh the output columns): rows
// 16 kk .. 16 kk + 15, columns from n0 (a multiple of kW).
template <int kDh>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk, int n0) {
  using T = Tile<kDh>;
  return make_desc(tile + (n0 / T::kW) * T::kPanelBytes + 16 * kk * T::kRowBytes,
                   T::kPanelBytes, 8 * T::kRowBytes, T::kLayout);
}

// The rows [row0, row0 + 64) of head h, batch b, of a [B, S, H, Dh] map into
// a tile, one box a panel; rows past S arrive as zeros.
template <int kDh>
__device__ __forceinline__ void load_tile(uint8_t* dst, const CUtensorMap* map, uint64_t* bar,
                                          int h, int row0, int b) {
  using T = Tile<kDh>;
#pragma unroll
  for (int p = 0; p < kDh / T::kW; ++p) {
    tma_load_4d(dst + p * T::kPanelBytes, map, bar, p * T::kW, h, row0, b);
  }
}

// ------------------------------------------------------------------ wgmma

// D[64 x 64] (+)= A[64 x 16] . B[16 x 64], A and B from shared memory (K-major).
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D[64 x 16] += A[64 x 16] . B[16 x 16], A from registers (four bf16x2 a
// thread), B from shared memory, MN-major (the transpose bit set).
__device__ __forceinline__ void wgmma_rs_n16(float* d, const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D[64 x 32] += A[64 x 16] . B[16 x 32], A from registers (four bf16x2 a
// thread), B from shared memory, MN-major (the transpose bit set).
__device__ __forceinline__ void wgmma_rs_n32(float* d, const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D[64 x 64] += A[64 x 16] . B[16 x 64], A from registers (four bf16x2 a
// thread), B from shared memory, MN-major (the transpose bit set).
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// s[64 x 64] = A[64 x Dh] . B[64 x Dh]^T, both tiles K-major, issued but
// not waited for.
template <int kDh>
__device__ __forceinline__ void issue_qk(float (&s)[32], uint32_t a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < kDh / 16; ++kk) wgmma_ss_n64(s, desc_k<kDh>(a, kk), desc_k<kDh>(b, kk), kk);
}

// acc[64 x Dh] += A (registers: the 16 reduction columns of slice kk) . rows
// 16 kk .. 16 kk + 15 of the MN-major tile b: the output columns in chunks
// of 64, then 32, then 16, each starting on a panel.
template <int kDh>
__device__ __forceinline__ void issue_rs(float* acc, const uint32_t (&a)[4], uint32_t b, int kk) {
  constexpr int n64 = kDh / 64;
  constexpr int rest = kDh % 64;
#pragma unroll
  for (int c = 0; c < n64; ++c) wgmma_rs_n64(acc + 32 * c, a, desc_mn<kDh>(b, kk, 64 * c));
  if constexpr (rest >= 32) wgmma_rs_n32(acc + 32 * n64, a, desc_mn<kDh>(b, kk, 64 * n64));
  if constexpr (rest % 32 == 16) {
    constexpr int n0 = 64 * n64 + (rest >= 32 ? 32 : 0);
    wgmma_rs_n16(acc + n0 / 2, a, desc_mn<kDh>(b, kk, n0));
  }
}

// ------------------------------------------------------------------ numerics
//
// A thread's share of a [64 x N] accumulator: element 4 cg + 2 i + e is row
// 16 warp + lane / 4 + 8 i, column 8 cg + 2 (lane % 4) + e. Rows are spread
// over the four lanes of a quad, so a row's max and sums close with two
// xor-shuffles, which give all four lanes the same bits.

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// a / b as the IEEE division rounds it, from rb = __frcp_rn(b), with no
// branch (__fdiv_rn checks each quotient for its slow path). q0 = a * rb
// may be more than one ulp from a / b; one residual step, q1 = q0 + rb (a -
// q0 b), brings it within one ulp; Markstein's theorem (rb correctly
// rounded, q1 within one ulp) makes the second step's q1 + rb (a - q1 b)
// the correctly rounded quotient. Four FMAs: the same bits as __fdiv_rn for
// every normal quotient; below 2^-126 it may differ by one subnormal ulp.
__device__ __forceinline__ float div_rn(float a, float b, float rb) {
  const float q0 = __fmul_rn(a, rb);
  const float q1 = __fmaf_rn(__fmaf_rn(-q0, b, a), rb, q0);
  return __fmaf_rn(__fmaf_rn(-q1, b, a), rb, q1);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kFull, x, 1));
  return fmaxf(x, __shfl_xor_sync(kFull, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(kFull, x, 1);
  return x + __shfl_xor_sync(kFull, x, 2);
}

// The softmax weight of one logit as _attention's softmax computes it:
// exp(s * scale - m), each step rounded on its own; 0 for a masked key.
// exp is taken for every key and a masked one selected away (a select, not
// a branch around each exp; an overflow there is discarded too).
__device__ __forceinline__ float softmax_num(float s, float scale, float m, bool live) {
  const float e = expf(__fsub_rn(__fmul_rn(s, scale), m));
  return live ? e : 0.f;
}

// Whether key `col` is visible to query `row`: in range and, causal, not
// above the diagonal. Interior tiles (kEdge false) have no masked key.
template <bool kEdge>
__device__ __forceinline__ bool visible(int row, int col, int Sk, int causal) {
  return !kEdge || (col < Sk && !(causal && row < col));
}

// K8's pass 0 over one key tile: each row's running max m and this
// thread's share of l at it (online; exp(m_old - m_new) rescales).
template <bool kEdge>
__device__ __forceinline__ void tile_stats(const float (&s)[32], float scale, int row0, int k0,
                                           int c0, int Sk, int causal, float (&m_run)[2],
                                           float (&l_part)[2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    float x[16];
    float rmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = k0 + 8 * (j >> 1) + c0 + (j & 1);
      x[j] = __fmul_rn(s[4 * (j >> 1) + 2 * i + (j & 1)], scale);
      // a masked key counts as -1e30; one past the ragged edge is no key
      const float xm = visible<kEdge>(row, col, Sk, causal) ? x[j] : kNegInf;
      rmax = fmaxf(rmax, kEdge && col >= Sk ? -INFINITY : xm);
    }
    rmax = quad_max(rmax);
    const float m_new = fmaxf(m_run[i], rmax);
    const float corr = expf(m_run[i] - m_new);
    float rsum = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      // masked keys weigh 0, even when the whole row is masked
      const int col = k0 + 8 * (j >> 1) + c0 + (j & 1);
      const float e = expf(__fsub_rn(x[j], m_new));
      rsum += visible<kEdge>(row, col, Sk, causal) ? e : 0.f;
    }
    l_part[i] = l_part[i] * corr + rsum;
    m_run[i] = m_new;
  }
}

// K8's pass 1 over one key tile: s becomes p = exp(s - m) / l with the
// final m and l (r = 1 / l), to be rounded to bf16 by pack_fragments.
template <bool kEdge>
__device__ __forceinline__ void tile_probs(float (&s)[32], float scale, int row0, int k0, int c0,
                                           int Sk, int causal, const float (&m_row)[2],
                                           const float (&l_row)[2], const float (&r_row)[2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int idx = 4 * (j >> 1) + 2 * i + (j & 1);
      const int col = k0 + 8 * (j >> 1) + c0 + (j & 1);
      const float e = softmax_num(s[idx], scale, m_row[i], visible<kEdge>(row0 + 8 * i, col, Sk,
                                                                          causal));
      s[idx] = div_rn(e, l_row[i], r_row[i]);
    }
}

// K8' launch 1 over one key tile, rows row0 and row0 + 8 against columns
// from k0. Sweep 0 adds each row's Dt terms (dP * (1 / (l * l))) * e into
// dt_part; sweep 1 turns s into dS = ((dP / l) - Dt) * e * scale, 0 where
// masked.
template <bool kEdge, bool kSweep1>
__device__ __forceinline__ void dq_tile(float (&s)[32], const float (&dp)[32], float scale,
                                        int row0, int k0, int c0, int Sq, int Sk, int causal,
                                        const float (&m_row)[2], const float (&l_row)[2],
                                        const float (&r_row)[2], const float (&rinv2)[2],
                                        const float (&dt_row)[2], float (&dt_part)[2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int idx = 4 * (j >> 1) + 2 * i + (j & 1);
      const int col = k0 + 8 * (j >> 1) + c0 + (j & 1);
      const bool live = !kEdge || (row < Sq && col < Sk && !(causal && row < col));
      const float e = softmax_num(s[idx], scale, m_row[i], live);
      const float dpr = round_bf16(dp[idx]);
      if constexpr (!kSweep1) {
        dt_part[i] += __fmul_rn(__fmul_rn(dpr, rinv2[i]), e);
      } else {
        const float ds = __fmul_rn(
            __fmul_rn(__fsub_rn(div_rn(dpr, l_row[i], r_row[i]), dt_row[i]), e), scale);
        s[idx] = live ? ds : 0.f;
      }
    }
  }
}

// K8' launch 2 over one query tile, keys key0 and key0 + 8 (rows of S^T)
// against queries from q0 (columns), with the queries' m, l, 1 / l and Dt
// from shared memory: st becomes round(P)^T, dpt becomes dS^T.
template <bool kEdge>
__device__ __forceinline__ void dkv_tile(float (&st)[32], float (&dpt)[32], const float* ms,
                                         float scale, int key0, int q0, int c0, int Sq, int Sk,
                                         int causal) {
  const float* const ls = ms + kRows;
  const float* const rs = ms + 2 * kRows;
  const float* const dts = ms + 3 * kRows;
#pragma unroll
  for (int cg = 0; cg < 8; ++cg) {
    const int qc = 8 * cg + c0;
    const float2 mq = *reinterpret_cast<const float2*>(ms + qc);
    const float2 lq = *reinterpret_cast<const float2*>(ls + qc);
    const float2 rq = *reinterpret_cast<const float2*>(rs + qc);
    const float2 dq = *reinterpret_cast<const float2*>(dts + qc);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int query = q0 + qc + e;
      const float mv = e ? mq.y : mq.x;
      const float lv = e ? lq.y : lq.x;
      const float rv = e ? rq.y : rq.x;
      const float dtv = e ? dq.y : dq.x;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int idx = 4 * cg + 2 * i + e;
        const int key = key0 + 8 * i;
        const bool live = !kEdge || (query < Sq && key < Sk && !(causal && query < key));
        const float ev = softmax_num(st[idx], scale, mv, live);
        const float dpr = round_bf16(dpt[idx]);
        st[idx] = round_bf16(div_rn(ev, lv, rv));
        const float ds = __fmul_rn(__fmul_rn(__fsub_rn(div_rn(dpr, lv, rv), dtv), ev), scale);
        dpt[idx] = live ? ds : 0.f;
      }
    }
  }
}

// The A fragments of the four 16-column slices of a [64 x 64] accumulator
// x, each element rounded to bf16: the accumulator's layout is the A
// operand's.
__device__ __forceinline__ void pack_fragments(const float (&x)[32], uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int idx = 4 * (2 * kk + half) + 2 * i;
        a[kk][2 * half + i] = pack_bf16(x[idx], x[idx + 1]);
      }
}

// dS split into two bf16 fragments: hi = bf16(dS), lo = bf16(dS - hi).
__device__ __forceinline__ void split_fragments(const float (&x)[32], uint32_t (&hi)[4][4],
                                                uint32_t (&lo)[4][4]) {
  float r[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) r[j] = __fsub_rn(x[j], round_bf16(x[j]));
  pack_fragments(x, hi);
  pack_fragments(r, lo);
}

// Store a thread's rows of a [64 x Dh] accumulator as bf16 into rows
// [row0, row0 + 64) of head h, batch b, of a [B, S, H, Dh] tensor; rows past
// S are not written.
template <int kDh>
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, const float* acc, int b, int S,
                                           int H, int h, int row0, int warp, int lane) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 16 * warp + (lane >> 2) + 8 * i;
    if (row >= S) continue;
    __nv_bfloat16* out = dst + ((long long)(b * S + row) * H + h) * kDh + 2 * (lane & 3);
#pragma unroll
    for (int cg = 0; cg < kDh / 8; ++cg) {
      *reinterpret_cast<uint32_t*>(out + 8 * cg) =
          pack_bf16(acc[4 * cg + 2 * i], acc[4 * cg + 2 * i + 1]);
    }
  }
}

// The dynamic shared memory from its first 1 024-byte boundary (the
// 128-byte swizzle repeats every 1 024 bytes; each launch asks 1 024 more).
__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

// ------------------------------------------------------------------ K8

// Shared memory: Q, then stage s's K and V; barriers [0] Q, [1 + s] stage s.
template <int kDh>
constexpr int fwd_smem_bytes() {
  return 5 * Tile<kDh>::kBytes + 3 * 8 + 1024;
}

template <int kDh>
__global__ void __launch_bounds__(kThreads, kDh <= 64 ? 4 : 1) attention_sm90_fwd_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ out,
    float* __restrict__ m_out, float* __restrict__ l_out, int Sq, int Sk, int H, int causal,
    float scale) {
  PROFILE_MARK(t_start);
  using T = Tile<kDh>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const smem = align_1024(smem_raw);
  uint8_t* const sQ = smem;
  uint64_t* const bar = reinterpret_cast<uint64_t*>(smem + 5 * T::kBytes);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int n_qt = (Sq + kRows - 1) / kRows;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * kRows;  // heaviest tiles first
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int n_kt = (Sk + kRows - 1) / kRows;
  const int q_last = min(q0 + kRows - 1, Sq - 1);
  // key tiles with a key some row of this tile may see
  const int kt_end = causal ? min(n_kt, q_last / kRows + 1) : n_kt;
  const int total = 2 * kt_end;  // pass 0: K only (m, l); pass 1: K and V (P·V)

  // tile g of the sequence into stage g % 2
  auto issue = [&](int g) {
    const int stage = g & 1;
    const bool with_v = g >= kt_end;
    const int k0 = (with_v ? g - kt_end : g) * kRows;
    uint64_t* const full = bar + 1 + stage;
    mbar_expect_tx(full, (with_v ? 2 : 1) * T::kBytes);
    load_tile<kDh>(smem + (1 + 2 * stage) * T::kBytes, &tm_k, full, h, k0, b);
    if (with_v) load_tile<kDh>(smem + (2 + 2 * stage) * T::kBytes, &tm_v, full, h, k0, b);
  };

  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(bar + i, 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar, T::kBytes);
    load_tile<kDh>(sQ, &tm_q, bar, h, q0, b);
    issue(0);
  }
  __syncwarp();

  const int r0 = 16 * warp + (lane >> 2);  // this thread's rows: r0, r0 + 8
  const int c0 = 2 * (lane & 3);           // and columns c0, c0 + 1 of each 8
  float m_run[2] = {kNegInf, kNegInf};
  float l_part[2] = {0.f, 0.f};  // this thread's share of l, at m_run
  float l_row[2] = {1.f, 1.f};   // the row's l, once pass 0 is done
  float r_row[2] = {1.f, 1.f};   // and its reciprocal, correctly rounded
  float o[kDh / 2];
#pragma unroll
  for (int j = 0; j < kDh / 2; ++j) o[j] = 0.f;

  mbar_wait(bar, 0);
  for (int g = 0; g < total; ++g) {
    PROFILE_MARK(t0);
    if (tid == 0 && g + 1 < total) issue(g + 1);
    __syncwarp();
    const int stage = g & 1;
    mbar_wait(bar + 1 + stage, (g >> 1) & 1);
    const bool pv_pass = g >= kt_end;
    const int k0 = (pv_pass ? g - kt_end : g) * kRows;
    PROFILE_ADD(0, kWaitTiles, t0);

    PROFILE_MARK(t1);
    float s[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) s[j] = 0.f;
    wgmma_fence();
    issue_qk<kDh>(s, smem_u32(sQ), smem_u32(smem + (1 + 2 * stage) * T::kBytes));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<32>(s);
    PROFILE_ADD(0, kProducts1, t1);
    PROFILE_MARK(t2);

    // a tile with a key past Sk or above the diagonal checks each logit
    const bool edge = k0 + kRows > Sk || (causal && k0 + kRows - 1 > q0);
    if (!pv_pass) {
      if (edge) {
        tile_stats<true>(s, scale, q0 + r0, k0, c0, Sk, causal, m_run, l_part);
      } else {
        tile_stats<false>(s, scale, q0 + r0, k0, c0, Sk, causal, m_run, l_part);
      }
      if (g == kt_end - 1) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          l_row[i] = quad_sum(l_part[i]);
          r_row[i] = __frcp_rn(l_row[i]);
        }
      }
      PROFILE_ADD(0, kElementwise, t2);
    } else {
      if (edge) {
        tile_probs<true>(s, scale, q0 + r0, k0, c0, Sk, causal, m_run, l_row, r_row);
      } else {
        tile_probs<false>(s, scale, q0 + r0, k0, c0, Sk, causal, m_run, l_row, r_row);
      }
      uint32_t pa[4][4];
      pack_fragments(s, pa);
      PROFILE_ADD(0, kElementwise, t2);
      PROFILE_MARK(t3);
      const uint32_t sv = smem_u32(smem + (2 + 2 * stage) * T::kBytes);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) issue_rs<kDh>(o, pa[kk], sv, kk);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<kDh / 2>(o);
      PROFILE_ADD(0, kProducts2, t3);
    }
    PROFILE_MARK(t4);
    __syncthreads();  // every read of this stage is done: it may be refilled
    PROFILE_ADD(0, kBarrier, t4);
  }

  store_rows<kDh>(out, o, b, Sq, H, h, q0, warp, lane);
  if (m_out != nullptr && (lane & 3) == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = q0 + r0 + 8 * i;
      if (row < Sq) {
        m_out[(long long)bh * Sq + row] = m_run[i];
        l_out[(long long)bh * Sq + row] = l_row[i];
      }
    }
  }
  PROFILE_ADD(0, kWhole, t_start);
}

// ------------------------------------------------------------------ K8, block form

// Whether key col may be seen by query row (indices into this call's
// blocks): in range and col - row <= diag, diag being q_off - k_off clamped
// to [-Sq, Sk] (Sk when not causal: every key). Interior tiles (kEdge
// false) have no masked key.
template <bool kEdge>
__device__ __forceinline__ bool block_visible(int row, int col, int Sk, int diag) {
  return !kEdge || (col < Sk && col - row <= diag);
}

// Pass 0 over one key tile: each row's running max, from m_in on. A masked
// key counts as -1e30 (the reference's where); one past the ragged edge is
// no key.
template <bool kEdge>
__device__ __forceinline__ void block_tile_max(const float (&s)[32], float scale, int row0,
                                               int k0, int c0, int Sk, int diag,
                                               float (&m_run)[2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    float rmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = k0 + 8 * (j >> 1) + c0 + (j & 1);
      const float x = __fmul_rn(s[4 * (j >> 1) + 2 * i + (j & 1)], scale);
      const float xm = block_visible<kEdge>(row, col, Sk, diag) ? x : kNegInf;
      rmax = fmaxf(rmax, kEdge && col >= Sk ? -INFINITY : xm);
    }
    m_run[i] = fmaxf(m_run[i], quad_max(rmax));
  }
}

// Pass 1 over one key tile: s becomes p = exp(s scale - m_new), 0 where
// masked, and this thread's share of each row's sum of p grows.
template <bool kEdge>
__device__ __forceinline__ void block_tile_probs(float (&s)[32], float scale, int row0, int k0,
                                                 int c0, int Sk, int diag,
                                                 const float (&m_new)[2], float (&l_part)[2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    float rsum = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int idx = 4 * (j >> 1) + 2 * i + (j & 1);
      const int col = k0 + 8 * (j >> 1) + c0 + (j & 1);
      const float p =
          softmax_num(s[idx], scale, m_new[i], block_visible<kEdge>(row, col, Sk, diag));
      s[idx] = p;
      rsum = __fadd_rn(rsum, p);
    }
    l_part[i] = __fadd_rn(l_part[i], rsum);
  }
}

// One block step of (o, m, l): a block a 64-query tile of one (b, h), the
// heaviest tiles first. Shared memory and barriers as K8's forward.
template <int kDh>
__global__ void __launch_bounds__(kThreads, kDh <= 64 ? 4 : 1) attention_sm90_block_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, const float* __restrict__ o_in,
    const float* __restrict__ m_in, const float* __restrict__ l_in, float* __restrict__ o_out,
    float* __restrict__ m_out, float* __restrict__ l_out, int Sq, int Sk, int H, int diag,
    float scale) {
  using T = Tile<kDh>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const smem = align_1024(smem_raw);
  uint8_t* const sQ = smem;
  uint64_t* const bar = reinterpret_cast<uint64_t*>(smem + 5 * T::kBytes);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int n_qt = (Sq + kRows - 1) / kRows;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * kRows;  // heaviest tiles first
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int n_kt = (Sk + kRows - 1) / kRows;
  const int q_last = min(q0 + kRows - 1, Sq - 1);
  // key tiles with a key some row of this tile may see: a tile wholly above
  // the diagonal leaves the state as it is (m >= -1e30), so it is skipped
  const long long lim = (long long)q_last + diag;  // the last key the last row sees
  const int kt_end = lim < 0 ? 0 : (int)min((long long)n_kt, lim / kRows + 1);
  const int total = 2 * kt_end;  // pass 0: K only (the max); pass 1: K and V

  const int r0 = 16 * warp + (lane >> 2);  // this thread's rows: r0, r0 + 8
  const int c0 = 2 * (lane & 3);           // and columns c0, c0 + 1 of each 8
  // the state's element of accumulator entry 4 cg + 2 i + e of this thread
  auto o_at = [&](int i) { return ((long long)(b * Sq + q0 + r0 + 8 * i) * H + h) * kDh + c0; };
  float m_row[2], l_row[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + r0 + 8 * i;
    m_row[i] = row < Sq ? m_in[(long long)bh * Sq + row] : 0.f;
    l_row[i] = row < Sq ? l_in[(long long)bh * Sq + row] : 0.f;
  }

  if (kt_end == 0) {  // no key for any row of the tile: the state, bit for bit
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = q0 + r0 + 8 * i;
      if (row >= Sq) continue;
      const long long at = o_at(i);
#pragma unroll
      for (int cg = 0; cg < kDh / 8; ++cg) {
        *reinterpret_cast<float2*>(o_out + at + 8 * cg) =
            *reinterpret_cast<const float2*>(o_in + at + 8 * cg);
      }
      if ((lane & 3) == 0) {
        m_out[(long long)bh * Sq + row] = m_row[i];
        l_out[(long long)bh * Sq + row] = l_row[i];
      }
    }
    return;
  }

  // tile g of the sequence into stage g % 2
  auto issue = [&](int g) {
    const int stage = g & 1;
    const bool with_v = g >= kt_end;
    const int k0 = (with_v ? g - kt_end : g) * kRows;
    uint64_t* const full = bar + 1 + stage;
    mbar_expect_tx(full, (with_v ? 2 : 1) * T::kBytes);
    load_tile<kDh>(smem + (1 + 2 * stage) * T::kBytes, &tm_k, full, h, k0, b);
    if (with_v) load_tile<kDh>(smem + (2 + 2 * stage) * T::kBytes, &tm_v, full, h, k0, b);
  };

  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(bar + i, 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar, T::kBytes);
    load_tile<kDh>(sQ, &tm_q, bar, h, q0, b);
    issue(0);
  }
  __syncwarp();

  float m_new[2] = {m_row[0], m_row[1]};
  float l_part[2] = {0.f, 0.f};  // this thread's share of sum(p)
  float pv[kDh / 2];             // P·V, apart from o·corr until the end
#pragma unroll
  for (int j = 0; j < kDh / 2; ++j) pv[j] = 0.f;

  mbar_wait(bar, 0);
  for (int g = 0; g < total; ++g) {
    if (tid == 0 && g + 1 < total) issue(g + 1);
    __syncwarp();
    const int stage = g & 1;
    mbar_wait(bar + 1 + stage, (g >> 1) & 1);
    const bool pv_pass = g >= kt_end;
    const int k0 = (pv_pass ? g - kt_end : g) * kRows;

    float s[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) s[j] = 0.f;
    wgmma_fence();
    issue_qk<kDh>(s, smem_u32(sQ), smem_u32(smem + (1 + 2 * stage) * T::kBytes));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<32>(s);

    // a tile with a key past Sk or one hidden from its first row checks each logit
    const bool edge = k0 + kRows > Sk || k0 + kRows - 1 - q0 > diag;
    if (!pv_pass) {
      if (edge) {
        block_tile_max<true>(s, scale, q0 + r0, k0, c0, Sk, diag, m_new);
      } else {
        block_tile_max<false>(s, scale, q0 + r0, k0, c0, Sk, diag, m_new);
      }
    } else {
      if (edge) {
        block_tile_probs<true>(s, scale, q0 + r0, k0, c0, Sk, diag, m_new, l_part);
      } else {
        block_tile_probs<false>(s, scale, q0 + r0, k0, c0, Sk, diag, m_new, l_part);
      }
      uint32_t hi[4][4], lo[4][4];
      split_fragments(s, hi, lo);
      const uint32_t sv = smem_u32(smem + (2 + 2 * stage) * T::kBytes);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) issue_rs<kDh>(pv, hi[kk], sv, kk);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) issue_rs<kDh>(pv, lo[kk], sv, kk);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<kDh / 2>(pv);
    }
    __syncthreads();  // every read of this stage is done: it may be refilled
  }

  // corr = exp(m - m_new); l = l corr + sum(p); o = o corr + pv
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float l_sum = quad_sum(l_part[i]);  // every lane: the shuffles
    const int row = q0 + r0 + 8 * i;
    if (row >= Sq) continue;
    const float corr = expf(__fsub_rn(m_row[i], m_new[i]));
    const long long at = o_at(i);
#pragma unroll
    for (int cg = 0; cg < kDh / 8; ++cg) {
      float2 o = *reinterpret_cast<const float2*>(o_in + at + 8 * cg);
      o.x = __fadd_rn(__fmul_rn(o.x, corr), pv[4 * cg + 2 * i]);
      o.y = __fadd_rn(__fmul_rn(o.y, corr), pv[4 * cg + 2 * i + 1]);
      *reinterpret_cast<float2*>(o_out + at + 8 * cg) = o;
    }
    if ((lane & 3) == 0) {
      m_out[(long long)bh * Sq + row] = m_new[i];
      l_out[(long long)bh * Sq + row] = __fadd_rn(__fmul_rn(l_row[i], corr), l_sum);
    }
  }
}

// ------------------------------------------------------------------ K8' launch 1

// Shared memory: Q, dO, then stage s's K and V; barriers [0] Q and dO,
// [1 + s] stage s.
template <int kDh>
constexpr int bwd_dq_smem_bytes() {
  return 6 * Tile<kDh>::kBytes + 3 * 8 + 1024;
}

// Query-major: sweep 0 over the visible key tiles sums Dt (written to dsum),
// sweep 1 recomputes S and dP and accumulates dQ = hi(dS)·K + lo(dS)·K.
template <int kDh>
__global__ void __launch_bounds__(kThreads, kDh <= 64 ? 3 : 1) attention_sm90_bwd_dq_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
    const float* __restrict__ m, const float* __restrict__ l, float* __restrict__ dsum,
    __nv_bfloat16* __restrict__ dq, int Sq, int Sk, int H, int causal, float scale) {
  PROFILE_MARK(t_start);
  using T = Tile<kDh>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const smem = align_1024(smem_raw);
  uint8_t* const sQ = smem;
  uint8_t* const sdO = smem + T::kBytes;
  uint64_t* const bar = reinterpret_cast<uint64_t*>(smem + 6 * T::kBytes);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int n_qt = (Sq + kRows - 1) / kRows;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * kRows;  // heaviest tiles first
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int n_kt = (Sk + kRows - 1) / kRows;
  const int q_last = min(q0 + kRows - 1, Sq - 1);
  const int kt_end = causal ? min(n_kt, q_last / kRows + 1) : n_kt;
  const int total = 2 * kt_end;

  auto issue = [&](int g) {
    const int stage = g & 1;
    const int k0 = (g < kt_end ? g : g - kt_end) * kRows;
    uint64_t* const full = bar + 1 + stage;
    mbar_expect_tx(full, 2 * T::kBytes);
    load_tile<kDh>(smem + (2 + 2 * stage) * T::kBytes, &tm_k, full, h, k0, b);
    load_tile<kDh>(smem + (3 + 2 * stage) * T::kBytes, &tm_v, full, h, k0, b);
  };

  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(bar + i, 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar, 2 * T::kBytes);
    load_tile<kDh>(sQ, &tm_q, bar, h, q0, b);
    load_tile<kDh>(sdO, &tm_do, bar, h, q0, b);
    issue(0);
  }
  __syncwarp();

  const int r0 = 16 * warp + (lane >> 2);
  const int c0 = 2 * (lane & 3);
  float m_row[2], l_row[2], r_row[2], rinv2[2], dt_part[2] = {0.f, 0.f};
  float dt_row[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + r0 + 8 * i;
    const bool in = row < Sq;
    m_row[i] = in ? m[(long long)bh * Sq + row] : 0.f;
    l_row[i] = in ? l[(long long)bh * Sq + row] : 1.f;
    r_row[i] = __frcp_rn(l_row[i]);
    rinv2[i] = __fdiv_rn(1.f, __fmul_rn(l_row[i], l_row[i]));  // integer_pow(l, -2)
  }
  float acc[kDh / 2];
#pragma unroll
  for (int j = 0; j < kDh / 2; ++j) acc[j] = 0.f;

  mbar_wait(bar, 0);
  for (int g = 0; g < total; ++g) {
    PROFILE_MARK(t0);
    if (tid == 0 && g + 1 < total) issue(g + 1);
    __syncwarp();
    const int stage = g & 1;
    mbar_wait(bar + 1 + stage, (g >> 1) & 1);
    PROFILE_ADD(1, kWaitTiles, t0);
    PROFILE_MARK(t1);
    const bool sweep1 = g >= kt_end;
    const int k0 = (sweep1 ? g - kt_end : g) * kRows;
    const uint32_t sk = smem_u32(smem + (2 + 2 * stage) * T::kBytes);
    const uint32_t sv = smem_u32(smem + (3 + 2 * stage) * T::kBytes);

    float s[32], dp[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) s[j] = dp[j] = 0.f;
    wgmma_fence();
    issue_qk<kDh>(s, smem_u32(sQ), sk);
    issue_qk<kDh>(dp, smem_u32(sdO), sv);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<32>(s);
    fence_regs<32>(dp);
    PROFILE_ADD(1, kProducts1, t1);
    PROFILE_MARK(t2);

    const bool edge = k0 + kRows > Sk || q0 + kRows > Sq || (causal && k0 + kRows - 1 > q0);
    const int row0 = q0 + r0;
    if (!sweep1) {
      if (edge) {
        dq_tile<true, false>(s, dp, scale, row0, k0, c0, Sq, Sk, causal, m_row, l_row, r_row,
                             rinv2, dt_row, dt_part);
      } else {
        dq_tile<false, false>(s, dp, scale, row0, k0, c0, Sq, Sk, causal, m_row, l_row, r_row,
                              rinv2, dt_row, dt_part);
      }
    } else if (edge) {
      dq_tile<true, true>(s, dp, scale, row0, k0, c0, Sq, Sk, causal, m_row, l_row, r_row,
                          rinv2, dt_row, dt_part);
    } else {
      dq_tile<false, true>(s, dp, scale, row0, k0, c0, Sq, Sk, causal, m_row, l_row, r_row,
                           rinv2, dt_row, dt_part);
    }
    if (!sweep1) {
      if (g == kt_end - 1) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          dt_row[i] = quad_sum(dt_part[i]);
          const int row = q0 + r0 + 8 * i;
          if ((lane & 3) == 0 && row < Sq) dsum[(long long)bh * Sq + row] = dt_row[i];
        }
      }
      PROFILE_ADD(1, kElementwise, t2);
    } else {
      uint32_t hi[4][4], lo[4][4];
      split_fragments(s, hi, lo);
      PROFILE_ADD(1, kElementwise, t2);
      PROFILE_MARK(t3);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) issue_rs<kDh>(acc, hi[kk], sk, kk);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) issue_rs<kDh>(acc, lo[kk], sk, kk);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<kDh / 2>(acc);
      PROFILE_ADD(1, kProducts2, t3);
    }
    PROFILE_MARK(t4);
    __syncthreads();
    PROFILE_ADD(1, kBarrier, t4);
  }
  store_rows<kDh>(dq, acc, b, Sq, H, h, q0, warp, lane);
  PROFILE_ADD(1, kWhole, t_start);
}

// ------------------------------------------------------------------ K8' launch 2

// Shared memory: K, V, then stage s's Q and dO, then stage s's m, l, 1 / l,
// Dt (64 floats each); barriers [0] K and V, [1 + s] stage s. m, l and Dt are
// not TMA boxes: a row of [B, H, Sq] floats starts 16-byte aligned only
// when Sq is a multiple of 4.
template <int kDh>
constexpr int bwd_dkv_smem_bytes() {
  return 6 * Tile<kDh>::kBytes + 8 * kVecBytes + 3 * 8 + 1024;
}

// Key-major: K and V stay; the query tiles on and below the diagonal stream
// past with their rows' m, l, Dt (loaded by the first 64 threads a tile
// ahead, stored into the next stage before the tile's closing barrier).
// S^T = K·Q^T and dP^T = V·dO^T give P^T and dS^T in the A operand's
// layout; dV += round(P)^T·dO, dK += hi(dS)^T·Q + lo(dS)^T·Q.
template <int kDh>
__global__ void __launch_bounds__(kThreads, kDh <= 64 ? 3 : 1) attention_sm90_bwd_dkv_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
    const float* __restrict__ m, const float* __restrict__ l, const float* __restrict__ dsum,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int Sq, int Sk, int H,
    int causal, float scale) {
  PROFILE_MARK(t_start);
  using T = Tile<kDh>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const smem = align_1024(smem_raw);
  uint8_t* const sK = smem;
  uint8_t* const sV = smem + T::kBytes;
  float* const vec = reinterpret_cast<float*>(smem + 6 * T::kBytes);  // [stage][m, l, 1/l, Dt][64]
  uint64_t* const bar = reinterpret_cast<uint64_t*>(smem + 6 * T::kBytes + 8 * kVecBytes);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int k0 = (int)blockIdx.x * kRows;  // heaviest (most query tiles) first
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int n_qt = (Sq + kRows - 1) / kRows;
  const int qt_begin = causal ? min(n_qt, k0 / kRows) : 0;
  const int total = n_qt - qt_begin;

  auto issue = [&](int g) {
    const int stage = g & 1;
    const int q0 = (qt_begin + g) * kRows;
    uint64_t* const full = bar + 1 + stage;
    mbar_expect_tx(full, 2 * T::kBytes);
    load_tile<kDh>(smem + (2 + 2 * stage) * T::kBytes, &tm_q, full, h, q0, b);
    load_tile<kDh>(smem + (3 + 2 * stage) * T::kBytes, &tm_do, full, h, q0, b);
  };
  // query tile g's row tid of m, l, Dt (0, 1, 0 past Sq), for tid < 64
  float row_m = 0.f, row_l = 1.f, row_dt = 0.f;
  auto fetch = [&](int g) {
    const int query = (qt_begin + g) * kRows + tid;
    const bool in = tid < kRows && query < Sq;
    row_m = in ? m[(long long)bh * Sq + query] : 0.f;
    row_l = in ? l[(long long)bh * Sq + query] : 1.f;
    row_dt = in ? dsum[(long long)bh * Sq + query] : 0.f;
  };
  auto stash = [&](int g) {
    if (tid < kRows) {
      float* const v = vec + (g & 1) * 4 * kRows;
      v[tid] = row_m;
      v[kRows + tid] = row_l;
      v[2 * kRows + tid] = __frcp_rn(row_l);
      v[3 * kRows + tid] = row_dt;
    }
  };

  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(bar + i, 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar, 2 * T::kBytes);
    load_tile<kDh>(sK, &tm_k, bar, h, k0, b);
    load_tile<kDh>(sV, &tm_v, bar, h, k0, b);
    if (total > 0) issue(0);
  }
  if (total > 0) {
    fetch(0);
    stash(0);
  }
  __syncthreads();

  const int r0 = 16 * warp + (lane >> 2);  // this thread's keys: k0 + r0, k0 + r0 + 8
  const int c0 = 2 * (lane & 3);           // and queries c0, c0 + 1 of each 8
  float dk_acc[kDh / 2], dv_acc[kDh / 2];
#pragma unroll
  for (int j = 0; j < kDh / 2; ++j) dk_acc[j] = dv_acc[j] = 0.f;

  mbar_wait(bar, 0);
  for (int g = 0; g < total; ++g) {
    PROFILE_MARK(t0);
    if (tid == 0 && g + 1 < total) issue(g + 1);
    __syncwarp();
    if (g + 1 < total) fetch(g + 1);  // used only by stash(g + 1) below
    const int stage = g & 1;
    mbar_wait(bar + 1 + stage, (g >> 1) & 1);
    PROFILE_ADD(2, kWaitTiles, t0);
    PROFILE_MARK(t1);
    const int q0 = (qt_begin + g) * kRows;
    const uint32_t sq = smem_u32(smem + (2 + 2 * stage) * T::kBytes);
    const uint32_t sdo = smem_u32(smem + (3 + 2 * stage) * T::kBytes);
    const float* const ms = vec + stage * 4 * kRows;  // then l, 1 / l, Dt

    // the same products as launch 1 and the forward, transposed
    float st[32], dpt[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) st[j] = dpt[j] = 0.f;
    wgmma_fence();
    issue_qk<kDh>(st, smem_u32(sK), sq);
    issue_qk<kDh>(dpt, smem_u32(sV), sdo);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<32>(st);
    fence_regs<32>(dpt);
    PROFILE_ADD(2, kProducts1, t1);
    PROFILE_MARK(t2);

    const bool edge = k0 + kRows > Sk || q0 + kRows > Sq || (causal && q0 < k0 + kRows - 1);
    if (edge) {
      dkv_tile<true>(st, dpt, ms, scale, k0 + r0, q0, c0, Sq, Sk, causal);
    } else {
      dkv_tile<false>(st, dpt, ms, scale, k0 + r0, q0, c0, Sq, Sk, causal);
    }
    uint32_t pa[4][4], hi[4][4], lo[4][4];
    pack_fragments(st, pa);
    split_fragments(dpt, hi, lo);
    PROFILE_ADD(2, kElementwise, t2);
    PROFILE_MARK(t3);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) issue_rs<kDh>(dv_acc, pa[kk], sdo, kk);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) issue_rs<kDh>(dk_acc, hi[kk], sq, kk);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) issue_rs<kDh>(dk_acc, lo[kk], sq, kk);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<kDh / 2>(dk_acc);
    fence_regs<kDh / 2>(dv_acc);
    PROFILE_ADD(2, kProducts2, t3);
    PROFILE_MARK(t4);
    if (g + 1 < total) stash(g + 1);  // stage (g + 1) % 2 was last read in tile g - 1
    __syncthreads();
    PROFILE_ADD(2, kBarrier, t4);
  }
  store_rows<kDh>(dk, dk_acc, b, Sk, H, h, k0, warp, lane);
  store_rows<kDh>(dv, dv_acc, b, Sk, H, h, k0, warp, lane);
  PROFILE_ADD(2, kWhole, t_start);
}

// ------------------------------------------------------------------ host

// Codes of this file beside cudaError_t's: the driver's tensor-map encoder
// was not found, or refused a descriptor (its CUresult added to the base).
constexpr int kErrNoEncoder = 10000;
constexpr int kErrEncode = 20000;

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess || p == nullptr) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A [B, S, H, Dh] bf16 tensor, boxes of [64 rows][w columns] of one head,
// swizzled 2w bytes.
int encode_rows(CUtensorMap* map, const void* base, int B, int S, int H, int Dh, int w) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return kErrNoEncoder;
  const cuuint64_t dims[4] = {(cuuint64_t)Dh, (cuuint64_t)H, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)Dh * 2, (cuuint64_t)H * Dh * 2,
                                 (cuuint64_t)S * H * Dh * 2};
  const cuuint32_t box[4] = {(cuuint32_t)w, 1, (cuuint32_t)kRows, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle = w == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : w == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                               : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                         strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncode + (int)r;
}

struct Shape {
  int B, Sq, Sk, H, Dh, causal;
  float scale;
};

int check_shape(const Shape& p) {
  if (p.B <= 0 || p.Sq <= 0 || p.Sk <= 0 || p.H <= 0 || (long long)p.B * p.H > 65535 ||
      (long long)p.B * p.H * p.Sq >= (1ll << 31) || (long long)p.B * p.H * p.Sk >= (1ll << 31) ||
      p.Dh % 16 != 0 || p.Dh < 16 || p.Dh > 128) {
    return (int)cudaErrorInvalidValue;
  }
  return 0;
}

template <int kDh>
int launch_forward(const void* q, const void* k, const void* v, void* out, float* m, float* l,
                   const Shape& p, cudaStream_t stream) {
  constexpr int w = Tile<kDh>::kW;
  CUtensorMap tq, tk, tv;
  int rc = encode_rows(&tq, q, p.B, p.Sq, p.H, kDh, w);
  if (rc == 0) rc = encode_rows(&tk, k, p.B, p.Sk, p.H, kDh, w);
  if (rc == 0) rc = encode_rows(&tv, v, p.B, p.Sk, p.H, kDh, w);
  if (rc != 0) return rc;
  constexpr int smem = fwd_smem_bytes<kDh>();
  cudaError_t err = cudaFuncSetAttribute(attention_sm90_fwd_kernel<kDh>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.Sq + kRows - 1) / kRows, p.B * p.H);
  attention_sm90_fwd_kernel<kDh><<<grid, kThreads, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), m, l, p.Sq, p.Sk, p.H, p.causal, p.scale);
  return (int)cudaGetLastError();
}

struct BlockState {
  const float* o_in;
  const float* m_in;
  const float* l_in;
  float* o_out;
  float* m_out;
  float* l_out;
};

template <int kDh>
int launch_block(const void* q, const void* k, const void* v, const BlockState& st,
                 const Shape& p, int diag, cudaStream_t stream) {
  constexpr int w = Tile<kDh>::kW;
  CUtensorMap tq, tk, tv;
  int rc = encode_rows(&tq, q, p.B, p.Sq, p.H, kDh, w);
  if (rc == 0) rc = encode_rows(&tk, k, p.B, p.Sk, p.H, kDh, w);
  if (rc == 0) rc = encode_rows(&tv, v, p.B, p.Sk, p.H, kDh, w);
  if (rc != 0) return rc;
  constexpr int smem = fwd_smem_bytes<kDh>();
  cudaError_t err = cudaFuncSetAttribute(attention_sm90_block_kernel<kDh>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.Sq + kRows - 1) / kRows, p.B * p.H);
  attention_sm90_block_kernel<kDh><<<grid, kThreads, smem, stream>>>(
      tq, tk, tv, st.o_in, st.m_in, st.l_in, st.o_out, st.m_out, st.l_out, p.Sq, p.Sk, p.H,
      diag, p.scale);
  return (int)cudaGetLastError();
}

template <int kDh>
int launch_backward(const void* q, const void* k, const void* v, const void* dout,
                    const float* m, const float* l, float* dsum, void* dq, void* dk, void* dv,
                    const Shape& p, cudaStream_t stream) {
  constexpr int w = Tile<kDh>::kW;
  CUtensorMap tq, tk, tv, tdo;
  int rc = encode_rows(&tq, q, p.B, p.Sq, p.H, kDh, w);
  if (rc == 0) rc = encode_rows(&tk, k, p.B, p.Sk, p.H, kDh, w);
  if (rc == 0) rc = encode_rows(&tv, v, p.B, p.Sk, p.H, kDh, w);
  if (rc == 0) rc = encode_rows(&tdo, dout, p.B, p.Sq, p.H, kDh, w);
  if (rc != 0) return rc;
  constexpr int smem1 = bwd_dq_smem_bytes<kDh>();
  constexpr int smem2 = bwd_dkv_smem_bytes<kDh>();
  cudaError_t err = cudaFuncSetAttribute(attention_sm90_bwd_dq_kernel<kDh>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem1);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(attention_sm90_bwd_dkv_kernel<kDh>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem2);
  if (err != cudaSuccess) return (int)err;
  attention_sm90_bwd_dq_kernel<kDh><<<dim3((p.Sq + kRows - 1) / kRows, p.B * p.H), kThreads,
                                      smem1, stream>>>(
      tq, tk, tv, tdo, m, l, dsum, static_cast<__nv_bfloat16*>(dq), p.Sq, p.Sk, p.H, p.causal,
      p.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  attention_sm90_bwd_dkv_kernel<kDh><<<dim3((p.Sk + kRows - 1) / kRows, p.B * p.H), kThreads,
                                       smem2, stream>>>(
      tq, tk, tv, tdo, m, l, dsum, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), p.Sq, p.Sk, p.H, p.causal, p.scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* attention_sm90_error_string(int code) {
  static thread_local char buf[96];
  if (code == kErrNoEncoder) return "cuTensorMapEncodeTiled not found by cudaGetDriverEntryPoint";
  if (code >= kErrEncode) {
    snprintf(buf, sizeof(buf), "cuTensorMapEncodeTiled refused a descriptor (CUresult %d)",
             code - kErrEncode);
    return buf;
  }
  return cudaGetErrorString((cudaError_t)code);
}

// K8 in bf16 with rounded probabilities: q [B, Sq, H, Dh], k and v [B, Sk, H,
// Dh] -> out (q's shape), and the rows' m and l ([B, H, Sq] f32) unless
// null. Dh: a multiple of 16 up to 128.
int attention_sm90_forward(const void* q, const void* k, const void* v, void* out, float* m_out,
                           float* l_out, int B, int Sq, int Sk, int H, int Dh, int causal,
                           float scale, void* stream) {
  const Shape p{B, Sq, Sk, H, Dh, causal, scale};
  if (int rc = check_shape(p)) return rc;
  if ((m_out == nullptr) != (l_out == nullptr)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (Dh / 16) {
    case 1: return launch_forward<16>(q, k, v, out, m_out, l_out, p, s);
    case 2: return launch_forward<32>(q, k, v, out, m_out, l_out, p, s);
    case 3: return launch_forward<48>(q, k, v, out, m_out, l_out, p, s);
    case 4: return launch_forward<64>(q, k, v, out, m_out, l_out, p, s);
    case 5: return launch_forward<80>(q, k, v, out, m_out, l_out, p, s);
    case 6: return launch_forward<96>(q, k, v, out, m_out, l_out, p, s);
    case 7: return launch_forward<112>(q, k, v, out, m_out, l_out, p, s);
    default: return launch_forward<128>(q, k, v, out, m_out, l_out, p, s);
  }
}

// K8's block form in bf16: q [B, Sq, H, Dh], k and v [B, Sk, H, Dh], the
// float32 state o_in (q's shape), m_in and l_in ([B, H, Sq], m_in >= -1e30)
// -> o_out, m_out, l_out (buffers of their own; the state in is only read).
// The first query sits at position q_off, the first key at k_off. Dh: a
// multiple of 16 up to 128.
int attention_sm90_block_update(const void* q, const void* k, const void* v, const float* o_in,
                                const float* m_in, const float* l_in, float* o_out,
                                float* m_out, float* l_out, int B, int Sq, int Sk, int H, int Dh,
                                long long q_off, long long k_off, int causal, float scale,
                                void* stream) {
  const Shape p{B, Sq, Sk, H, Dh, causal, scale};
  if (int rc = check_shape(p)) return rc;
  // key j is visible to query i where j - i <= q_off - k_off; past [-Sq, Sk]
  // the answer no longer changes, so the difference fits an int
  const long long d = causal ? q_off - k_off : (long long)Sk;
  const int diag = (int)(d < -(long long)Sq ? -(long long)Sq : d > Sk ? (long long)Sk : d);
  const BlockState st{o_in, m_in, l_in, o_out, m_out, l_out};
  cudaStream_t s = (cudaStream_t)stream;
  switch (Dh / 16) {
    case 1: return launch_block<16>(q, k, v, st, p, diag, s);
    case 2: return launch_block<32>(q, k, v, st, p, diag, s);
    case 3: return launch_block<48>(q, k, v, st, p, diag, s);
    case 4: return launch_block<64>(q, k, v, st, p, diag, s);
    case 5: return launch_block<80>(q, k, v, st, p, diag, s);
    case 6: return launch_block<96>(q, k, v, st, p, diag, s);
    case 7: return launch_block<112>(q, k, v, st, p, diag, s);
    default: return launch_block<128>(q, k, v, st, p, diag, s);
  }
}

// K8' in bf16: the gradient of attention_sm90_forward for dout (q's shape),
// from its m and l; dsum ([B, H, Sq] f32) is launch 1's Dt for launch 2.
// Dh: 16, 32, 64 or 128.
int attention_sm90_backward(const void* q, const void* k, const void* v, const void* dout,
                            const float* m, const float* l, float* dsum, void* dq, void* dk,
                            void* dv, int B, int Sq, int Sk, int H, int Dh, int causal,
                            float scale, void* stream) {
  const Shape p{B, Sq, Sk, H, Dh, causal, scale};
  if (int rc = check_shape(p)) return rc;
  cudaStream_t s = (cudaStream_t)stream;
  switch (Dh) {
    case 16: return launch_backward<16>(q, k, v, dout, m, l, dsum, dq, dk, dv, p, s);
    case 32: return launch_backward<32>(q, k, v, dout, m, l, dsum, dq, dk, dv, p, s);
    case 64: return launch_backward<64>(q, k, v, dout, m, l, dsum, dq, dk, dv, p, s);
    case 128: return launch_backward<128>(q, k, v, dout, m, l, dsum, dq, dk, dv, p, s);
    default: return (int)cudaErrorInvalidValue;  // Dh 48, 80, 96, 112: not built
  }
}

#ifdef ATTN_SM90_PROFILE
// The profile build's cycle sums [kernel: forward, launch 1, launch 2][phase]
// into out (3 x kPhases), then zeroed when reset is set.
int attention_sm90_profile(unsigned long long* out, int reset) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_profile, sizeof(g_profile));
  if (err == cudaSuccess && reset) {
    static const unsigned long long zeros[3][kPhases] = {};
    err = cudaMemcpyToSymbol(g_profile, zeros, sizeof(g_profile));
  }
  return (int)err;
}
#endif

}  // extern "C"
