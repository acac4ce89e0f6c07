// Hand-written Hopper (sm_90a) kernels of the batched scheduling round.
//
// Built by ray_tpu_torch/sched/_build.py with one nvcc call into a shared
// library with a plain C interface (loaded through ctypes); the Python
// wrappers and their plain PyTorch versions live in kernel_torch.py.
//
// Numerics: every decision must be bit-identical to kernel_np (the NumPy
// reference). So: IEEE float32 division (nvcc's default -prec-div=true), no
// fast math, and no FMA contraction. The build passes --fmad=false, and the
// three sites where numpy rounds a product before a sum
// (avail - take*d, thr*total - used, over*(B-2)) also spell the rounding out
// with __fmul_rn / __fadd_rn / __fsub_rn so the source states the intent.
//
// Kernels:
//   K1 sched_schedule_classes  replaces ray_tpu/sched/kernel_jax.py
//                              schedule_classes (+ _one_class, _class_fit,
//                              critical_util, _threshold_cap, _score_bucket,
//                              _fill_by_bucket, _sat_cumsum); one
//                              thread-block cluster of 16 (or 8) blocks
//   K2, K3                     replace kernel_jax.py _scatter_rows (rows
//                              mode, K2) and JaxScheduler.apply_delta (delta
//                              mode, K3): applied by K1 itself, in the launch
//                              of the scan round that follows the refresh
//                              (schedule_classes_kernel<ROWS, THREADS, REF>,
//                              as it stages the view), or alone by
//                              refresh_view_kernel<MODE> (sched_refresh_view)
//                              where no K1 follows
//   K4 sched_compact_nonzero   replaces the sparse download of
//                              kernel_jax.py JaxScheduler.schedule_async
//                              (jnp.nonzero(size=cap, fill_value=0) + gather
//                              + narrowing); one cooperative launch
//   K5 sched_schedule_rounds_phases
//                              replaces kernel_jax.py schedule_classes_rounds
//                              (+ _rounds_core, _sat_cumsum); three kernels
//                              a phase (caps, prefix, trim), 24 a call at 4
//                              rounds
//   K6 sched_schedule_rounds   replaces kernel_jax.py schedule_classes_chunked
//                              (the rounds core chunk by chunk); one
//                              thread-block cluster of 16 (or 8) blocks
//   K7 sched_schedule_classes_sharded
//                              replaces ray_tpu/sched/kernel_shard.py:54-196
//                              (the round with the node axis split over p
//                              shards): K1's kernel on a cluster of p blocks,
//                              block r owning shard r
//   K7r sched_k7r_pass         replaces kernel_shard.py:54-131 across
//                              ranks: one step of a pass (terms, caps, fill)
//                              on one rank's block of nodes, the collectives
//                              between the launches the host's
// Every entry point launches on the stream it is given, allocates nothing,
// does not synchronise, and returns cudaGetLastError() after its launches.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

// Built with -DSCHED_K1_PROFILE (ray_tpu_torch/scripts/profile_sched.py
// only), thread 0 of every block of K1 (and of K7, which runs K1's kernel)
// sums the cycles of each phase of a pass into g_k1_profile[rank]:
// [exchange 1 (barrier, feasible counts), sweep (caps, bucket totals),
// exchange 2 (barrier, offsets, take modes), fill and the next pass's phase
// 1, tail, passes]; and thread 0 of every block of K6 into
// g_rounds_profile[rank]: [caps, count exchange (phase B), totals (phase
// B's share caps, the segments' and the block's totals), totals exchange,
// want and the trim, debit, placed exchange, tiles run, tiles skipped].
// The production build compiles the stamps away.
#ifdef SCHED_K1_PROFILE
constexpr int kK1Phases = 5;
__device__ unsigned long long g_k1_profile[16][kK1Phases + 1];
constexpr int kRPhases = 7;
__device__ unsigned long long g_rounds_profile[16][kRPhases + 2];
#define K1_PROFILE_DECL long long k1_prof[kK1Phases + 1] = {}, k1_last = 0
#define K1_PROFILE_START() k1_last = clock64()
#define K1_MARK(phase)                                               \
  if (threadIdx.x == 0) {                                           \
    const long long now = clock64();                                \
    k1_prof[phase] += now - k1_last;                                \
    k1_last = now;                                                  \
  }
#define K1_PROFILE_PASS() \
  if (threadIdx.x == 0) ++k1_prof[kK1Phases];
#define K1_PROFILE_FLUSH(rank)                                       \
  if (threadIdx.x == 0) {                                           \
    for (int i = 0; i <= kK1Phases; ++i) g_k1_profile[rank][i] += k1_prof[i]; \
  }
#define R_PROFILE_DECL long long r_prof[kRPhases + 2] = {}, r_last = 0
#define R_PROFILE_START() r_last = clock64()
#define R_MARK(phase)                                                \
  if (threadIdx.x == 0) {                                           \
    const long long now = clock64();                                \
    r_prof[phase] += now - r_last;                                  \
    r_last = now;                                                   \
  }
#define R_COUNT(i) \
  if (threadIdx.x == 0) ++r_prof[kRPhases + (i)];
#define R_PROFILE_FLUSH(rank)                                        \
  if (threadIdx.x == 0) {                                           \
    for (int i = 0; i < kRPhases + 2; ++i) g_rounds_profile[rank][i] += r_prof[i]; \
  }
#else
#define K1_PROFILE_DECL
#define K1_PROFILE_START()
#define K1_MARK(phase)
#define K1_PROFILE_PASS()
#define K1_PROFILE_FLUSH(rank)
#define R_PROFILE_DECL
#define R_PROFILE_START()
#define R_MARK(phase)
#define R_COUNT(i)
#define R_PROFILE_FLUSH(rank)
#endif

namespace {

constexpr int kBuckets = 64;          // SCORE_BUCKETS
constexpr float kEps = 1e-4f;         // EPS
constexpr float kInfFit = 1073741824.0f;  // INF_FIT = 2**30
constexpr int kMaxR = 64;             // resource columns a class row may have
constexpr unsigned kFull = 0xffffffffu;

// Block-wide exclusive prefix sum of one int64 per thread. Every thread of
// the block must call it (it synchronises). `warp_sums` is 32 shared slots.
__device__ long long block_exclusive_scan(long long v, long long* warp_sums) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = (blockDim.x + 31) >> 5;
  long long x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    long long y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    long long s = lane < n_warps ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      long long y = __shfl_up_sync(kFull, s, o);
      if (lane >= o) s += y;
    }
    warp_sums[lane] = s;  // inclusive over warps
  }
  __syncthreads();
  long long base = warp > 0 ? warp_sums[warp - 1] : 0;
  long long out = base + x - v;
  __syncthreads();  // warp_sums may be reused right after
  return out;
}

__device__ __forceinline__ long long warp_sum(long long v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
  return v;  // lane 0's is the warp's sum
}

// ---------------------------------------------------------------------------
// The per-node arithmetic of one pass, op for op as kernel_np (K1, and so
// K7).
// ---------------------------------------------------------------------------

// critical_util's term of one column: used / max(total, eps), 0 where total
// is 0
__device__ __forceinline__ float used_frac(float av, float tt) {
  return tt > 0.f ? __fdiv_rn(__fsub_rn(tt, av), fmaxf(tt, kEps)) : 0.f;
}

// _class_fit's term of one demanded column
__device__ __forceinline__ float fit_ratio(float av, float d) {
  return floorf(__fdiv_rn(__fadd_rn(av, kEps), d));
}

// _threshold_cap's term of one demanded column
__device__ __forceinline__ float cap_ratio(float av, float tt, float thr, float d) {
  const float head = __fsub_rn(__fmul_rn(thr, tt), __fsub_rn(tt, av));
  return floorf(__fdiv_rn(__fadd_rn(head, kEps), d));
}

__device__ __forceinline__ int clip_fit(float fit) {
  return (int)fminf(fmaxf(fit, 0.f), kInfFit);
}

// clip(k, 0, float32(INF_FIT - 1)) + 1; float32(2**30 - 1) == 2**30
__device__ __forceinline__ int clip_cap(float k) {
  return (int)__fadd_rn(fminf(fmaxf(k, 0.f), kInfFit), 1.0f);
}

// _score_bucket: 0 under the threshold, 1 + floor(over * 62) at or above it
__device__ __forceinline__ uint8_t score_bucket(float util, float thr, float over_denom) {
  float over = __fdiv_rn(__fsub_rn(util, thr), over_denom);
  over = fminf(fmaxf(over, 0.f), 1.f);
  float b = util >= thr ? __fadd_rn(1.0f, floorf(__fmul_rn(over, (float)(kBuckets - 2)))) : 0.f;
  b = fminf(fmaxf(b, 0.f), (float)(kBuckets - 1));
  return (uint8_t)b;
}

// The fill's debit of one column: max(avail - take*d, 0)
__device__ __forceinline__ float debit(float a, float take, float d) {
  const float v = __fsub_rn(a, __fmul_rn(take, d));
  return v < 0.f ? 0.f : v;
}

// A refresh of the view (K2, K3), applied by K1 (REF) or by
// refresh_view_kernel<MODE>: none, rows (view[idx[i]] = rows[i], indices
// outside the view dropped) or delta (clip(view + delta, 0, total))
enum RefreshMode : int { kRefreshNone = 0, kRefreshRows = 1, kRefreshDelta = 2 };

// K3's entry: avail + delta rounded once, then compared with 0 and with
// total, in that order (jnp.clip)
__device__ __forceinline__ float refresh_delta(float a, float delta, float t) {
  float v = __fadd_rn(a, delta);
  v = v < 0.f ? 0.f : v;
  return v > t ? t : v;
}

// ---------------------------------------------------------------------------
// K1's exchanges are pushed: a block writes what its peers need into their
// shared memory with st.async, which adds the bytes it wrote to the
// receiver's mbarrier (complete_tx); the receiver arms the mbarrier for the
// bytes it expects from every block (expect_tx) and waits on it, then reads
// its own shared memory only. One one-way trip a peer, no read after the
// barrier: on the card, K1's two exchanges done by pulling (a cluster
// barrier, then reads of the peers, as K7's first kernel did) took ~73 % of
// a pass (profile_sched.py k1, PERF.md). With one block (K7 at p = 1) every
// st.async goes to the block itself and completes its own mbarrier.
// A wait that never completes (a block that skipped an exchange, or a wrong
// byte count) traps after ~2^28 polls instead of hanging the card.
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the address of `p`'s counterpart in the shared memory of block `rank`
__device__ __forceinline__ uint32_t peer_u32(const void* p, int rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(a) : "r"(smem_u32(p)),
               "r"((unsigned)rank));
  return a;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)) : "memory");
}

// the mbarrier's one arrival, expecting `bytes` from st.async
__device__ __forceinline__ void mbar_arm(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 28)) __trap();
  }
}

__device__ __forceinline__ void st_async(uint32_t dst, unsigned v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n" ::"r"(dst),
      "r"(v), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void st_async(uint32_t dst, uint4 v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, "
      "[%5];\n" ::"r"(dst),
      "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(bar)
      : "memory");
}

// ---------------------------------------------------------------------------
// K1: one scheduling round, classes in order, <= max_passes passes each, on
// one thread-block cluster of P = 16 blocks (8 where the card has no room
// for 16). The kernel reads P from the cluster: K7 runs it on p blocks.
//
// Bound on this card: the round is a chain of dependent passes (class c
// sees the availability class c-1 left; pass p sees pass p-1's): 257 at the
// stream's first round (10k nodes x 256 classes), each needing two
// cluster-wide reductions (the feasible count, then the bucket totals and
// their offsets), so it is bound by the latency of a pass, not by bytes:
// the round must move only ~2*N*R*4 bytes plus the [C, N] result. A pass on
// one SM (the first form of this kernel, 1024 threads) cost ~38 us, most of
// it phase 1 re-reading every node's row from L2 and recomputing its
// utilization over all 16 columns with IEEE divisions. Here a pass costs
// ~5 us (PERF.md): the sweeps of the block the fill reaches, and the waits of
// the two exchanges.
//
// Design:
//  - Block r owns nodes [r*Nb, (r+1)*Nb), Nb = ceil(N / P): N is padded up
//    to a multiple of P with dead, empty nodes, which hold no state and are
//    never feasible. A block's rows of avail and total (by column, so that
//    neighbouring lanes read neighbouring words) and its per-node state live
//    in shared memory for the whole round (~89 KB at 10k nodes and R = 16);
//    avail is written back once, at the end. Where they do not fit
//    (k1_plan: above ~23k nodes at R = 16) the rows stay in global memory and
//    the per-node state in global scratch (ROWS = false).
//  - Each node's utilization and score bucket are cached. They depend on
//    its row alone, so they are recomputed only where the fill debited the
//    row, and over every row once, after the round's one clamp at zero. A
//    debit only lowers the demanded columns (all entries >= 0 after the
//    clamp), and IEEE division is monotone, so the new utilization is
//    max(old, the demanded columns' new terms): equal bit for bit to a
//    recomputation over every column. A class with a negative demand
//    recomputes over every column.
//  - Phase 1's fit and threshold cap take only the class's demanded columns
//    (a bit mask from one ballot a warp), and the threshold cap only on a
//    node under the threshold (over it, the cap is the equal share).
//  - One ownership of nodes for every phase: warp w owns a contiguous chunk
//    of 32-node segments, lane l node l of each. The fill of pass p and phase
//    1 of pass p + 1 run in one sweep, since the next pass's demand is known
//    when the fill starts (the same class while remaining > 0, else the next
//    class with a positive count, whose demand row is loaded a pass ahead).
//  - The fill needs no scan over buckets: in (bucket, node) order the
//    block's nodes of bucket b take places [off[b], off[b] + its total), so
//    every bucket takes all of its caps or none, except at most one bucket
//    whose range holds `remaining`, and only in one block. That block alone
//    scans that bucket's caps: the warps before it from their bucket totals
//    (kept from phase 2), then the lanes.
//  - The two exchanges of a pass are pushed (st.async, above): warp q sends
//    the block's feasible count and then its 64 bucket totals to block q
//    (exact int64, each warp's sums kept in a row of its own, so no
//    atomics); each block then forms n_feasible, and 64 threads the offsets
//    and the placed total as JAX's sharded round does (global prefix over
//    buckets + the totals of the ranks before it), from its own shared
//    memory.
//  - A refresh of the view that a scan round follows (K2's dirty rows, or
//    K3's delta: REF) is applied in the round's own launch, by each block
//    to its own nodes, before the first cluster barrier: with the rows in
//    shared memory, while staging them (K3's delta added to each entry as
//    it is read; K2's rows, those of idx in the block's range, written
//    over the staged copy), so that the refreshed view reaches global
//    memory with the round's own write-back; with the rows in global
//    memory, in place, first thing (k1_refresh_block). The round then runs
//    as without one. A standalone refresh costs about an empty launch
//    (~5 us; it moves 64 KB-2.5 MB), which no change inside it could
//    remove; fused, it is a few loads and stores a thread. REF =
//    kRefreshNone compiles to the kernel without a refresh.
// A pass is then one sweep over ~40 nodes a warp, one sweep over the caps
// and two exchanges. Every block takes the same branches: the class order,
// n_feasible and the placed total are the same in every block.
// Exact int64 prefixes equal the reference's saturating float32 ones
// wherever the result depends on them, because counts stay below 2**23
// (pad_problem asserts it).
// ---------------------------------------------------------------------------
constexpr int kK1Threads = 512;
constexpr int kK1MaxCluster = 16;
constexpr int kK1CountWindow = 1024;          // class counts held in shared memory at a time
constexpr size_t kK1SmemBudget = 200 * 1024;  // dynamic shared memory of one block
constexpr uint8_t kTakeNone = 0, kTakeAll = 1, kTakePart = 2;

// The stride of one column of a block's rows in shared memory: odd, so that
// the column-major copy of the rows is free of bank conflicts.
__host__ __device__ inline int k1_col_stride(int Nb) { return Nb | 1; }

// Bytes of one block's share of the round (Nb nodes): with the rows, avail
// and total by column, then the per-node state: utilization (float32), fit,
// cap (int32), bucket, alive (uint8); 16-aligned.
__host__ __device__ inline size_t k1_block_bytes(int Nb, int R, bool rows) {
  const size_t b = (rows ? (size_t)8 * R * k1_col_stride(Nb) : 0) + (size_t)14 * Nb;
  return (b + 15) & ~(size_t)15;
}

struct K1Plan {
  int Nb;                     // nodes a block
  bool rows;                  // rows and state in shared memory
  size_t smem;                // dynamic shared memory a block
  long long scratch_words;    // int32 words of global scratch (rows == false)
};

K1Plan k1_plan(int N, int R, int P) {
  K1Plan pl;
  pl.Nb = (N + P - 1) / P;
  const size_t rows = k1_block_bytes(pl.Nb, R, true);
  pl.rows = rows <= kK1SmemBudget;
  pl.smem = pl.rows ? rows : 0;
  pl.scratch_words = pl.rows ? 0 : (long long)P * (long long)(k1_block_bytes(pl.Nb, R, false) / 4);
  return pl;
}

// One block's nodes: the rows (ROWS: column-major [R][S] in shared memory;
// else the block's rows of the global [N, R]) and the per-node state.
template <bool ROWS>
struct K1Nodes {
  float* av;
  const float* tt;
  int S, R;
  float* util;
  int* fit;
  int* cap;
  uint8_t* bkt;
  uint8_t* alive;
  __device__ __forceinline__ float& a(int j, int r) const {
    return av[ROWS ? (size_t)r * S + j : (size_t)j * R + r];
  }
  __device__ __forceinline__ float t(int j, int r) const {
    return tt[ROWS ? (size_t)r * S + j : (size_t)j * R + r];
  }
  __device__ __forceinline__ float util_of_row(int j) const {
    float u = __int_as_float(0xff800000);  // -inf
    for (int r = 0; r < R; ++r) u = fmaxf(u, used_frac(a(j, r), t(j, r)));
    return u;
  }
};

// One class as a sweep reads it: its demand row (shared memory), the bit
// mask of its demanded columns (d > 0) and whether any column is negative.
struct K1Class {
  const float* d;
  unsigned long long pos;
  bool neg;
};

__device__ __forceinline__ K1Class k1_class(const float* d, int R) {
  const int lane = threadIdx.x & 31;
  const float d0 = lane < R ? d[lane] : 0.f;
  const float d1 = lane + 32 < R ? d[lane + 32] : 0.f;
  K1Class k;
  k.d = d;
  k.pos = (unsigned long long)__ballot_sync(kFull, d0 > 0.f) |
          ((unsigned long long)__ballot_sync(kFull, d1 > 0.f) << 32);
  k.neg = __any_sync(kFull, d0 < 0.f || d1 < 0.f);
  return k;
}

// The first class after c with a positive count, and that count ({C, 0}:
// none), searched 32 at a time in the window of counts in shared memory,
// which moves forward as needed. Every thread of the block calls it.
__device__ int2 k1_next_class(int c, const int* __restrict__ counts, int C, int* s_cnt,
                              int& w0) {
  const int lane = threadIdx.x & 31;
  for (int i = c + 1; i < C;) {
    if (i >= w0 + kK1CountWindow) {
      __syncthreads();
      w0 = i;
      for (int k = threadIdx.x; k < kK1CountWindow && w0 + k < C; k += blockDim.x)
        s_cnt[k] = counts[w0 + k];
      __syncthreads();
    }
    const int end = min(C, w0 + kK1CountWindow);
    const int v = i + lane < end ? s_cnt[i + lane - w0] : 0;
    const unsigned m = __ballot_sync(kFull, v > 0);
    if (m) {
      const int l = __ffs(m) - 1;
      return make_int2(i + l, __shfl_sync(kFull, v, l));
    }
    i = min(i + 32, end);
  }
  return make_int2(C, 0);
}

// What one sweep does, besides the next pass's phase 1 (when `next`).
struct K1Fill {
  bool on;                  // this pass's fill
  bool clamp;               // the round's first placing pass: clamp every row
  K1Class cls;              // the filled class
  int remaining;
  const uint8_t* mode;      // per bucket: kTakeNone, kTakeAll or kTakePart
  int partial;              // the bucket partly taken in this block, or -1
  long long base;           // places before the warp's first node of it
  int* assigned;            // assigned + c*N + first
};

// One sweep over the warp's nodes [j0, j1): the fill (take, debit, the
// cached utilization and bucket), or with `refresh` every node's
// utilization and bucket; then phase 1 of the next pass's class. Two
// 32-node segments a step: their fills in node order, then the next pass's
// phase 1 of a lane's two nodes interleaved, so that their divisions are
// independent (on the card 2-8 % faster than a segment a step, K1 and K7
// alike; PERF.md). Returns this lane's count of feasible nodes.
template <bool ROWS>
__device__ int k1_sweep(const K1Nodes<ROWS>& v, int j0, int j1, const K1Fill& f, bool refresh,
                        bool next, const K1Class& nc, float thr, float over_denom) {
  const int lane = threadIdx.x & 31;
  int feas = 0;
  long long carry = f.base;
  // the fill of node j (take, debit, the cached utilization and bucket), or
  // with `refresh` its utilization and bucket; returns its utilization
  auto fill_node = [&](int j, bool in) -> float {
    float util = in ? v.util[j] : 0.f;
    const float util0 = util;
    if (f.on) {
      int cp = 0, b = 0;
      if (in) {
        cp = v.cap[j];
        b = v.bkt[j];
      }
      int take = cp > 0 && f.mode[b] == kTakeAll ? cp : 0;
      if (f.partial >= 0) {  // the same in every lane: one bucket straddles `remaining`
        const int x = cp > 0 && b == f.partial ? cp : 0;
        int incl = x;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int y = __shfl_up_sync(kFull, incl, o);
          if (lane >= o) incl += y;
        }
        if (x > 0) {
          const long long t = (long long)f.remaining - (carry + incl - x);
          take = (int)(t < 0 ? 0 : (t > x ? x : t));
        }
        carry += __shfl_sync(kFull, incl, 31);
      }
      if (take > 0) atomicAdd(f.assigned + j, take);
      const float tf = (float)take;
      if (f.clamp) {
        if (in) {
          util = __int_as_float(0xff800000);
          for (int r = 0; r < v.R; ++r) {
            float x = v.a(j, r);
            if (take > 0) x = debit(x, tf, f.cls.d[r]);
            x = x < 0.f ? 0.f : x;
            v.a(j, r) = x;
            util = fmaxf(util, used_frac(x, v.t(j, r)));
          }
        }
      } else if (take > 0) {
        if (f.cls.neg) {
          for (int r = 0; r < v.R; ++r) v.a(j, r) = debit(v.a(j, r), tf, f.cls.d[r]);
          util = v.util_of_row(j);
        } else {
          for (unsigned long long m = f.cls.pos; m; m &= m - 1) {
            const int r = __ffsll((long long)m) - 1;
            const float x = debit(v.a(j, r), tf, f.cls.d[r]);
            v.a(j, r) = x;
            util = fmaxf(util, used_frac(x, v.t(j, r)));
          }
        }
      }
    }
    if (refresh && in) util = v.util_of_row(j);
    if (in && (refresh || (f.on && f.clamp) || util != util0)) {
      v.util[j] = util;
      v.bkt[j] = score_bucket(util, thr, over_denom);
    }
    return util;
  };
  // two segments a step: the fills in node order, then the next pass's
  // phase 1 of both nodes of a lane interleaved, their divisions independent
  for (int s = j0; s < j1; s += 64) {
    const int ja = s + lane, jb = s + 32 + lane;
    const bool ina = ja < j1, inb = jb < j1;
    const float ua = fill_node(ja, ina);
    const bool second = s + 32 < j1;  // the same in every lane
    const float ub = second ? fill_node(jb, inb) : 0.f;
    if (next) {
      const bool la = ina && v.alive[ja], lb = inb && v.alive[jb];
      const bool unda = ua < thr, undb = ub < thr;
      float fa = kInfFit, ka = kInfFit, fb = kInfFit, kb = kInfFit;
      for (unsigned long long m = nc.pos; m; m &= m - 1) {
        const int r = __ffsll((long long)m) - 1;
        const float d = nc.d[r];
        if (la) {
          const float x = v.a(ja, r);
          fa = fminf(fa, fit_ratio(x, d));
          if (unda) ka = fminf(ka, cap_ratio(x, v.t(ja, r), thr, d));
        }
        if (lb) {
          const float x = v.a(jb, r);
          fb = fminf(fb, fit_ratio(x, d));
          if (undb) kb = fminf(kb, cap_ratio(x, v.t(jb, r), thr, d));
        }
      }
      if (ina) {
        const int fit_i = la ? clip_fit(fa) : 0;
        v.fit[ja] = fit_i;
        v.cap[ja] = la && unda ? clip_cap(ka) : -1;
        feas += fit_i > 0;
      }
      if (inb) {
        const int fit_i = lb ? clip_fit(fb) : 0;
        v.fit[jb] = fit_i;
        v.cap[jb] = lb && undb ? clip_cap(kb) : -1;
        feas += fit_i > 0;
      }
    }
  }
  return feas;
}

// Phase 2 over the warp's nodes: the final caps, min(threshold cap or equal
// share, fit, remaining), and their sums by bucket into the warp's own row
// (lane l holds buckets 2l and 2l + 1 in registers; one 16-byte store each).
template <bool ROWS>
__device__ void k1_caps(const K1Nodes<ROWS>& v, int j0, int j1, long long share, int remaining,
                        unsigned long long* row) {
  const int lane = threadIdx.x & 31;
  unsigned long long t0 = 0, t1 = 0;
#pragma unroll 2
  for (int s = j0; s < j1; s += 32) {
    const int j = s + lane;
    int cp = 0, b = 0;
    if (j < j1) {
      const int ct = v.cap[j];
      long long x = ct >= 0 ? (long long)ct : share;
      x = min(x, (long long)v.fit[j]);
      x = min(x, (long long)remaining);
      cp = (int)x;
      v.cap[j] = cp;
      b = v.bkt[j];
    }
    for (unsigned todo = __ballot_sync(kFull, cp > 0); todo;) {
      const int lb = __shfl_sync(kFull, b, __ffs(todo) - 1);
      const bool mine = cp > 0 && b == lb;
      // < 32 caps below 2**23 each: exact in 32 bits
      const unsigned sum = __reduce_add_sync(kFull, mine ? (unsigned)cp : 0u);
      if (lane == lb >> 1) (lb & 1 ? t1 : t0) += sum;
      todo &= ~__ballot_sync(kFull, mine);
    }
  }
  row[2 * lane] = t0;
  row[2 * lane + 1] = t1;
}

// K2 or K3 (REF) in the launch of K1 with its rows in global memory, first
// thing: each block refreshes its own nodes [first, first + nl) of the view
// in place, before K1 reads them (a block barrier at the end), so that K1
// then runs as without a refresh. K3: clip(avail + delta, 0, total) on
// every entry of the block's rows; K2: the entries of idx in the block's
// range (the padding value N, and any index outside the view, is in no
// block's range), a thread an entry.
template <int THREADS, int REF>
__device__ void k1_refresh_block(float* __restrict__ avail, const float* __restrict__ total,
                                 const int* __restrict__ ref_idx,
                                 const float* __restrict__ ref_src, int ref_pad, int N, int R,
                                 int Nb) {
  const int tid = threadIdx.x;
  const int first = (int)cg::this_cluster().block_rank() * Nb;
  const int nl = max(0, min(Nb, N - first));
  if constexpr (REF == kRefreshDelta) {
    const size_t e0 = (size_t)first * R;
    for (int e = tid; e < nl * R; e += THREADS)
      avail[e0 + e] = refresh_delta(avail[e0 + e], ref_src[e0 + e], total[e0 + e]);
  } else {
    for (int i = tid; i < ref_pad; i += THREADS) {
      const int n = ref_idx[i];
      if (n < first || n >= first + nl) continue;
      for (int r = 0; r < R; ++r) avail[(size_t)n * R + r] = ref_src[(size_t)i * R + r];
    }
  }
  __syncthreads();  // the block's refreshed rows, read by other threads of it next
}

// ref_idx, ref_src, ref_pad: the refresh of REF (kRefreshRows: idx [pad]
// and rows [pad, R]; kRefreshDelta: the delta [N, R] in ref_src), last, so
// that the other parameters keep the offsets (and the kernel without a
// refresh the code) they had before: inserted before N, they moved every
// branch of that kernel by one instruction, and K7 at p = 8 took 0.33 %
// longer on the card
template <bool ROWS, int THREADS, int REF>
__global__ void __launch_bounds__(THREADS, 1)
schedule_classes_kernel(float* __restrict__ avail, const float* __restrict__ total,
                        const uint8_t* __restrict__ alive, const float* __restrict__ demands,
                        const int* __restrict__ counts, int* __restrict__ assigned,
                        int* __restrict__ scratch, int N, int R, int C, int Nb, float thr,
                        float over_denom, int max_passes, const int* __restrict__ ref_idx,
                        const float* __restrict__ ref_src, int ref_pad) {
  constexpr int kWarps = THREADS / 32;
  static_assert(kWarps >= kK1MaxCluster, "warp q sends the bucket totals to block q");
  if constexpr (REF != kRefreshNone && !ROWS)  // in place, before K1 reads the view
    k1_refresh_block<THREADS, REF>(avail, total, ref_idx, ref_src, ref_pad, N, R, Nb);
  cg::cluster_group cluster = cg::this_cluster();
  const int P = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int first = rank * Nb;
  const int nl = max(0, min(Nb, N - first));
  __shared__ float s_d[2][kMaxR];                  // two classes' demand rows
  __shared__ int s_wfeas[kWarps];                // each warp's feasible count
  __shared__ __align__(16) unsigned long long s_wtot[kWarps][kBuckets];  // each warp's totals
  __shared__ __align__(16) unsigned long long s_btot[kBuckets];            // the block's
  __shared__ int s_nfeas;                                                  // the cluster's
  __shared__ int s_feas_in[2][kK1MaxCluster];      // every block's count, by pass parity
  __shared__ __align__(16) unsigned long long s_tot_in[kK1MaxCluster][kBuckets];  // its totals
  __shared__ __align__(8) uint64_t s_bar_feas[2];  // their mbarriers
  __shared__ __align__(8) uint64_t s_bar_tot;
  __shared__ long long s_off[kBuckets];
  __shared__ long long s_total;
  __shared__ long long s_scan;
  __shared__ uint8_t s_take[kBuckets];
  __shared__ int s_partial;
  __shared__ int s_cnt[kK1CountWindow];
  extern __shared__ __align__(16) unsigned char s_dyn[];
  K1_PROFILE_DECL;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  K1Nodes<ROWS> v;
  v.R = R;
  v.S = k1_col_stride(Nb);
  unsigned char* sc;
  if (ROWS) {
    v.av = reinterpret_cast<float*>(s_dyn);
    v.tt = v.av + (size_t)R * v.S;
    sc = s_dyn + (size_t)8 * R * v.S;
  } else {
    v.av = avail + (size_t)first * R;
    v.tt = total + (size_t)first * R;
    sc = reinterpret_cast<unsigned char*>(scratch) + (size_t)rank * k1_block_bytes(Nb, R, false);
  }
  v.util = reinterpret_cast<float*>(sc);
  v.fit = reinterpret_cast<int*>(sc + (size_t)4 * Nb);
  v.cap = reinterpret_cast<int*>(sc + (size_t)8 * Nb);
  v.bkt = sc + (size_t)12 * Nb;
  v.alive = sc + (size_t)13 * Nb;

  // bytes each exchange brings from the P blocks
  const uint32_t feas_bytes = 4u * P, tot_bytes = 8u * kBuckets * P;
  if (tid == 0) {
    mbar_init(&s_bar_feas[0]);
    mbar_init(&s_bar_feas[1]);
    mbar_init(&s_bar_tot);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_arm(&s_bar_feas[0], feas_bytes);
    mbar_arm(&s_bar_feas[1], feas_bytes);
    mbar_arm(&s_bar_tot, tot_bytes);
  }
  for (int k = tid; k < kK1CountWindow && k < C; k += THREADS) s_cnt[k] = counts[k];
  if constexpr (ROWS && REF == kRefreshNone) {
    float* tt = v.av + (size_t)R * v.S;
    for (int e = tid; e < nl * R; e += THREADS) {
      const int j = e / R, r = e - j * R;
      v.av[(size_t)r * v.S + j] = avail[(size_t)first * R + e];
      tt[(size_t)r * v.S + j] = total[(size_t)first * R + e];
    }
  } else if constexpr (ROWS) {  // the refresh applied to the staged rows
    float* tt = v.av + (size_t)R * v.S;
    for (int e = tid; e < nl * R; e += THREADS) {
      const int j = e / R, r = e - j * R;
      const float t = total[(size_t)first * R + e];
      float a = avail[(size_t)first * R + e];
      if constexpr (REF == kRefreshDelta) a = refresh_delta(a, ref_src[(size_t)first * R + e], t);
      v.av[(size_t)r * v.S + j] = a;
      tt[(size_t)r * v.S + j] = t;
    }
    if constexpr (REF == kRefreshRows) {
      __syncthreads();  // the staged rows, written over next by other threads
      for (int i = tid; i < ref_pad; i += THREADS) {  // idx's entries in the block's range
        const int j = ref_idx[i] - first;
        if (j < 0 || j >= nl) continue;
        const float* row = ref_src + (size_t)i * R;
        for (int r = 0; r < R; ++r) v.av[(size_t)r * v.S + j] = row[r];
      }
    }
  }
  for (int j = tid; j < nl; j += THREADS) v.alive[j] = alive[first + j];
  int w0 = 0;
  cluster.sync();  // every block resident, its mbarriers initialised and armed

  // warp w's nodes: [j0, j1), a whole number of 32-node segments
  const int cw = 32 * ((Nb + 32 * kWarps - 1) / (32 * kWarps));
  const int j0 = min(warp * cw, nl), j1 = min(j0 + cw, nl);
  const int2 c0 = k1_next_class(-1, counts, C, s_cnt, w0);
  if (c0.x < C && max_passes > 0) {
    int c = c0.x, remaining = c0.y, p = 0, slot = 0;
    int2 nxt = k1_next_class(c, counts, C, s_cnt, w0);
    if (tid < R) {
      s_d[0][tid] = demands[(size_t)c * R + tid];
      if (nxt.x < C) s_d[1][tid] = demands[(size_t)nxt.x * R + tid];
    }
    bool nxt_ready = true;  // s_d[slot ^ 1] holds the demand of class nxt.x
    float pf = 0.f;         // that demand, loaded a pass ahead (threads < R)
    __syncthreads();
    K1Class cur = k1_class(s_d[0], R);
    K1Fill f = {};
    f.on = false;
    f.partial = -1;
    // the round's first phase 1, and every node's utilization and bucket
    int feas = k1_sweep(v, j0, j1, f, true, true, cur, thr, over_denom);
    feas = (int)__reduce_add_sync(kFull, (unsigned)feas);
    if (lane == 0) s_wfeas[warp] = feas;
    unsigned pass = 0, tot_uses = 0;
    bool clamped = false;
    K1_PROFILE_START();
    for (;;) {
      const int buf = pass & 1;
      __syncthreads();  // every warp's feasible count is in place
      if (warp < P && lane == 0) {  // warp q sends the block's count to block q
        int n = 0;
        for (int w = 0; w < kWarps; ++w) n += s_wfeas[w];
        st_async(peer_u32(&s_feas_in[buf][rank], warp), (unsigned)n,
                 peer_u32(&s_bar_feas[buf], warp));
      }
      if (warp == 0) {  // one warp waits (an acquire at cluster scope is not free)
        mbar_wait(&s_bar_feas[buf], (pass >> 1) & 1u);
        const int n = (int)__reduce_add_sync(kFull, lane < P ? s_feas_in[buf][lane] : 0);
        if (lane == 0) {
          s_nfeas = n;
          // for pass + 2: every block sends that pass's count only after
          // this block's count of pass + 1, which follows a block barrier
          mbar_arm(&s_bar_feas[buf], feas_bytes);
        }
      }
      if (!nxt_ready && tid < R) pf = demands[(size_t)nxt.x * R + tid];
      __syncthreads();
      const int n_feasible = s_nfeas;
      K1_MARK(0);
      int got = 0;
      if (n_feasible > 0) {
        const long long share = ((long long)remaining + n_feasible - 1) / n_feasible;
        k1_caps(v, j0, j1, share, remaining, s_wtot[warp]);
        K1_MARK(1);
        __syncthreads();  // every warp's bucket totals are in place
        if (tid < kBuckets) {
          unsigned long long t = 0;
#pragma unroll
          for (int w = 0; w < kWarps; ++w) t += s_wtot[w][tid];
          s_btot[tid] = t;
        }
        __syncthreads();
        if (warp < P) {  // warp q sends the block's totals to block q, two buckets a lane
          st_async(peer_u32(&s_tot_in[rank][2 * lane], warp),
                   *reinterpret_cast<const uint4*>(&s_btot[2 * lane]),
                   peer_u32(&s_bar_tot, warp));
        }
        if (tid < kBuckets) {  // thread b: bucket b, over every block and the blocks before this one
          mbar_wait(&s_bar_tot, tot_uses & 1u);
          long long all = 0, before = 0;
#pragma unroll 4
          for (int q = 0; q < P; ++q) {
            const long long x = (long long)s_tot_in[q][tid];
            all += x;
            before += q < rank ? x : 0;
          }
          // the exclusive scan over the buckets gives the offsets of this
          // block's first node in each
          long long incl = all;
#pragma unroll
          for (int o = 1; o < 32; o <<= 1) {
            const long long y = __shfl_up_sync(kFull, incl, o);
            if (lane >= o) incl += y;
          }
          if (tid == 31) s_scan = incl;
          if (tid == 0) s_partial = -1;
          asm volatile("bar.sync 1, %0;\n" ::"n"(kBuckets) : "memory");  // the two warps
          if (warp == 1) incl += s_scan;
          const long long o = incl - all + before;
          const long long bt = (long long)s_tot_in[rank][tid];
          s_off[tid] = o;
          uint8_t mode = kTakeNone;
          if (bt > 0 && o < remaining) mode = o + bt <= remaining ? kTakeAll : kTakePart;
          s_take[tid] = mode;
          if (mode == kTakePart) s_partial = tid;  // one bucket at most
          if (tid == kBuckets - 1) s_total = incl;
          // for the next totals, which every block sends only after this
          // block's next count, which follows a block barrier
          if (tid == 0) mbar_arm(&s_bar_tot, tot_bytes);
        }
        ++tot_uses;
      }
      if (!nxt_ready && tid < R) s_d[slot ^ 1][tid] = pf;
      nxt_ready = true;
      __syncthreads();
      if (n_feasible > 0) got = (int)min((long long)remaining, s_total);
      K1_MARK(2);
      // the next pass: the same class while it has tasks and passes left,
      // else the next class with tasks (a stalled class ends)
      const bool fill = got > 0;
      const int rem_after = remaining - got;
      const bool same = fill && rem_after > 0 && p + 1 < max_passes;
      const bool next = same || nxt.x < C;
      const K1Class nc = same ? cur : k1_class(s_d[slot ^ 1], R);
      f.on = fill;
      if (fill) {
        f.clamp = !clamped;
        f.cls = cur;
        f.remaining = remaining;
        f.mode = s_take;
        f.partial = s_partial;
        f.assigned = assigned + (size_t)c * N + first;
        f.base = 0;
        if (f.partial >= 0) {  // places before the warp's first node of that bucket
          const long long x = lane < warp ? (long long)s_wtot[lane][f.partial] : 0;
          f.base = s_off[f.partial] + __shfl_sync(kFull, warp_sum(x), 0);
        }
      }
      if (fill || next) {
        feas = k1_sweep(v, j0, j1, f, false, next, nc, thr, over_denom);
        feas = (int)__reduce_add_sync(kFull, (unsigned)feas);
        if (lane == 0) s_wfeas[warp] = feas;
      }
      clamped = clamped || fill;
      K1_MARK(3);
      K1_PROFILE_PASS();
      if (!next) break;
      if (same) {
        remaining = rem_after;
        ++p;
      } else {
        c = nxt.x;
        remaining = nxt.y;
        p = 0;
        slot ^= 1;
        cur = nc;
        nxt = k1_next_class(c, counts, C, s_cnt, w0);
        nxt_ready = nxt.x >= C;
      }
      ++pass;
      K1_MARK(4);
    }
  }
  __syncthreads();
  if constexpr (ROWS) {
    for (int e = tid; e < nl * R; e += THREADS) {
      const int j = e / R, r = e - j * R;
      avail[(size_t)first * R + e] = v.av[(size_t)r * v.S + j];
    }
  }
  K1_PROFILE_FLUSH(rank);
  cluster.sync();  // no block exits while a peer's st.async to it may be in flight
}

template <bool ROWS, int THREADS, int REF>
cudaError_t k1_config(int P, size_t smem, cudaStream_t st, cudaLaunchConfig_t& cfg,
                      cudaLaunchAttribute& attr) {
  auto kernel = schedule_classes_kernel<ROWS, THREADS, REF>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = (unsigned)P;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg = {};
  cfg.gridDim = dim3((unsigned)P, 1, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

// Whether one cluster of P blocks of K1 with this plan fits on the card
// (asked of the kernel without a refresh: a refresh adds no shared memory,
// and every form holds one block of THREADS an SM)
template <bool ROWS, int THREADS>
cudaError_t k1_fits(int P, const K1Plan& pl, bool& fits) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = k1_config<ROWS, THREADS, kRefreshNone>(P, pl.smem, nullptr, cfg, attr);
  if (err != cudaSuccess) return err;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(
      &clusters, (const void*)schedule_classes_kernel<ROWS, THREADS, kRefreshNone>, &cfg);
  if (err != cudaSuccess) {  // this size is refused: the caller tries the next
    (void)cudaGetLastError();
    clusters = 0;
  }
  fits = clusters >= 1;
  return cudaSuccess;
}

template <bool ROWS, int THREADS, int REF = kRefreshNone>
cudaError_t launch_k1(cudaStream_t st, int P, const K1Plan& pl, float* avail,
                      const float* total, const uint8_t* alive, const float* demands,
                      const int* counts, int* assigned, int* scratch, int N, int R, int C,
                      float thr, float over_denom, int max_passes, const int* ref_idx = nullptr,
                      const float* ref_src = nullptr, int ref_pad = 0) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = k1_config<ROWS, THREADS, REF>(P, pl.smem, st, cfg, attr);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&cfg, schedule_classes_kernel<ROWS, THREADS, REF>, avail, total,
                           alive, demands, counts, assigned, scratch, N, R, C, pl.Nb, thr,
                           over_denom, max_passes, ref_idx, ref_src, ref_pad);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// K1 in form ROWS with the refresh `ref_mode` (RefreshMode) applied in its
// launch
template <bool ROWS>
cudaError_t launch_k1_refresh(cudaStream_t st, int P, const K1Plan& pl, float* avail,
                              const float* total, const uint8_t* alive, const float* demands,
                              const int* counts, int* assigned, int* scratch, int N, int R,
                              int C, float thr, float over_denom, int max_passes, int ref_mode,
                              const int* ref_idx, const float* ref_src, int ref_pad) {
  if (ref_mode == kRefreshRows)
    return launch_k1<ROWS, kK1Threads, kRefreshRows>(st, P, pl, avail, total, alive, demands,
                                                     counts, assigned, scratch, N, R, C, thr,
                                                     over_denom, max_passes, ref_idx, ref_src,
                                                     ref_pad);
  if (ref_mode == kRefreshDelta)
    return launch_k1<ROWS, kK1Threads, kRefreshDelta>(st, P, pl, avail, total, alive, demands,
                                                      counts, assigned, scratch, N, R, C, thr,
                                                      over_denom, max_passes, ref_idx, ref_src,
                                                      ref_pad);
  return launch_k1<ROWS, kK1Threads>(st, P, pl, avail, total, alive, demands, counts, assigned,
                                     scratch, N, R, C, thr, over_denom, max_passes);
}

// ---------------------------------------------------------------------------
// K7: the round with the node axis split over p shards (p in 1, 2, 4, 8),
// replacing ray_tpu/sched/kernel_shard.py:54-196 (_fill_by_bucket_sharded,
// _one_class_sharded, _sharded_body under shard_map). It is K1's kernel on
// one cluster of p blocks: with N divisible by p, K1's layout (block r owns
// nodes [r*N/p, (r+1)*N/p)) is the shard layout, and K1's two pushed
// exchanges carry the JAX program's collectives: the feasible count (psum,
// :105), every shard's 64 bucket totals (all_gather, :75), which each block
// recomposes into its shard's global prefix (:75-91), and the placed total
// (psum, :117). Decisions and availability equal K1's and kernel_np's
// exactly.
//
// Bound on this card: K1's chain of passes. A block of p < 16 sweeps
// 16 / p times K1's nodes a pass, so the sweeps, not the exchanges, grow
// with fewer blocks. The rows stay in shared memory while a block's share
// fits (k1_plan: p = 8 at 10k nodes and R = 16, 177.6 KB a block), else in
// global memory (p <= 4 at 10k nodes). A block has K1's 512 threads with
// the rows in shared memory and 1 024 with them in global memory, where
// twice the warps hide twice the latency of the rows' loads: on an NVIDIA
// H100 80GB HBM3 at 700 W, at the stream's first round, 1 024 threads took
// p = 1, 2, 4 from 12.26, 6.51, 3.55 to 8.08, 4.78, 3.20 ms, and 512 kept
// p = 8 at 1.61 where 1 024 took 1.91 (PERF.md).
//
// No fallback: where the card has no room for one cluster of p blocks the
// entry point returns cudaErrorLaunchOutOfResources and launches nothing.
// ---------------------------------------------------------------------------
constexpr int kK7ThreadsRows = 512;     // the rows in shared memory
constexpr int kK7ThreadsGlobal = 1024;  // the rows in global memory

// ---------------------------------------------------------------------------
// K7r: K7 across ranks. The node axis is split over the ranks of a process
// group (ray_tpu/sched/kernel_shard.py:54-131 under shard_map over devices);
// each rank runs this kernel on its own block of Nl = N / p nodes, and the
// collectives between the launches are the host's (torch.distributed: gloo
// on CUDA tensors, or NCCL). One launch runs one step of a pass, by MODE:
//   kK7rTerms  fit, threshold cap and bucket of the class's pass, and the
//              block's feasible count (then the host's psum, :105);
//   kK7rCaps   the final caps from the global feasible count, and the
//              block's 64 bucket totals (then the all_gather, :75);
//   kK7rFill   from every rank's totals, the global bucket offsets plus the
//              earlier ranks' totals (exact int64, where the reference
//              saturates float32: :75-91), the take, the debit of avail and
//              the block's placed count (then the psum, :117); in the same
//              sweep, as K1's sweep does, the terms of the next pass (the
//              same class, or the next one with tasks), whose feasible count
//              rides in the same psum.
// The arithmetic is K1's own: k1_sweep, k1_caps, k1_class, debit and
// score_bucket over K1's global-memory form of a block's nodes
// (K1Nodes<false>: the rows in global memory, the per-node state in
// scratch, kept from launch to launch), and block_exclusive_scan for the
// offsets; a pass takes the branches K1's does, so decisions and
// availability equal K1's and kernel_np's exactly.
//
// Bound: the latency of a pass, as K1's, and here also the host's two
// collectives and one read of two scalars a pass; the kernels move
// ~2 * Nl * R * 4 bytes a pass at most. One block of 1 024 threads a rank
// (K7's global-memory form at p = 1) keeps every step one launch without a
// grid barrier.
// ---------------------------------------------------------------------------
constexpr int kK7rThreads = 1024;
constexpr int kK7rWarps = kK7rThreads / 32;
constexpr int kK7rTerms = 0, kK7rCaps = 1, kK7rFill = 2;

// int32 words of K7r's scratch for a block of Nl nodes: each warp's bucket
// totals of the pass (int64, read again by the fill), then the per-node
// state in K1's global-memory layout
__host__ __device__ inline long long k7r_scratch_words(int Nl, int R) {
  return 2LL * kK7rWarps * kBuckets + (long long)(k1_block_bytes(Nl, R, false) / 4);
}

// the block's sum of one value a thread, written by thread 0
__device__ __forceinline__ long long k7r_block_sum(long long v, long long* s_w) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) s_w[warp] = v;
  __syncthreads();
  long long s = 0;
  if (threadIdx.x == 0)
    for (int w = 0; w < kK7rWarps; ++w) s += s_w[w];
  __syncthreads();
  return s;
}

// avail, total [Nl, R] and alive [Nl]: this rank's block (avail written by
// the fills); d_cur the class's demand row, d_next the next class's with
// tasks (Fill; nullptr: none); assigned the class's row of this rank's
// [C, Nl]; out: Terms and Fill [placed, feasible], Caps the 64 totals;
// all_tot [P, 64] every rank's totals (Fill). flag: Terms 1 refreshes every
// node's utilization and bucket (the round's first launch); Fill bit 0
// clamps every row (the round's first placing pass), bit 1 lets the class
// take another pass.
template <int MODE>
__global__ void __launch_bounds__(kK7rThreads, 1)
k7r_kernel(float* __restrict__ avail, const float* __restrict__ total,
           const uint8_t* __restrict__ alive, const float* __restrict__ d_cur,
           const float* __restrict__ d_next, int* __restrict__ assigned,
           int* __restrict__ scratch, long long* __restrict__ out,
           const long long* __restrict__ all_tot, int Nl, int R, int P, int rank, int remaining,
           int n_feasible, int flag, float thr, float over_denom) {
  __shared__ float s_d[2][kMaxR];
  __shared__ long long s_w[32];
  __shared__ long long s_off[kBuckets];
  __shared__ long long s_total;
  __shared__ uint8_t s_take[kBuckets];
  __shared__ int s_partial;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  unsigned long long* wtot = reinterpret_cast<unsigned long long*>(scratch);
  unsigned char* sc = reinterpret_cast<unsigned char*>(scratch + 2 * kK7rWarps * kBuckets);
  K1Nodes<false> v;
  v.av = avail;
  v.tt = total;
  v.R = R;
  v.S = k1_col_stride(Nl);
  v.util = reinterpret_cast<float*>(sc);
  v.fit = reinterpret_cast<int*>(sc + (size_t)4 * Nl);
  v.cap = reinterpret_cast<int*>(sc + (size_t)8 * Nl);
  v.bkt = sc + (size_t)12 * Nl;
  v.alive = sc + (size_t)13 * Nl;
  // warp w's nodes: [j0, j1), a whole number of 32-node segments
  const int cw = 32 * ((Nl + 32 * kK7rWarps - 1) / (32 * kK7rWarps));
  const int j0 = min(warp * cw, Nl), j1 = min(j0 + cw, Nl);

  if (MODE == kK7rCaps) {
    const long long share = ((long long)remaining + n_feasible - 1) / n_feasible;
    k1_caps(v, j0, j1, share, remaining, wtot + (size_t)warp * kBuckets);
    __syncthreads();  // every warp's totals are in place
    if (tid < kBuckets) {
      unsigned long long t = 0;
      for (int w = 0; w < kK7rWarps; ++w) t += wtot[(size_t)w * kBuckets + tid];
      out[tid] = (long long)t;
    }
    return;
  }
  if (tid < R) {
    s_d[0][tid] = d_cur[tid];
    if (MODE == kK7rFill && d_next != nullptr) s_d[1][tid] = d_next[tid];
  }
  if (MODE == kK7rTerms && flag)
    for (int j = tid; j < Nl; j += kK7rThreads) v.alive[j] = alive[j];
  __syncthreads();
  K1Fill f = {};
  f.on = false;
  f.partial = -1;
  bool next = true;
  K1Class nc = k1_class(s_d[0], R);
  long long placed = 0;
  if (MODE == kK7rFill) {
    // thread b < 64: bucket b over every rank, and over the ranks before this one
    long long all = 0, before = 0, bt = 0;
    if (tid < kBuckets) {
      for (int q = 0; q < P; ++q) {
        const long long x = all_tot[(size_t)q * kBuckets + tid];
        all += x;
        before += q < rank ? x : 0;
      }
      bt = all_tot[(size_t)rank * kBuckets + tid];
    }
    if (tid == 0) s_partial = -1;
    const long long excl = block_exclusive_scan(tid < kBuckets ? all : 0, s_w);
    if (tid < kBuckets) {
      const long long o = excl + before;  // this block's first place in bucket b
      s_off[tid] = o;
      uint8_t mode = kTakeNone;
      if (bt > 0 && o < remaining) mode = o + bt <= remaining ? kTakeAll : kTakePart;
      s_take[tid] = mode;
      if (mode == kTakePart) s_partial = tid;  // one bucket at most
      if (tid == kBuckets - 1) s_total = excl + all;
      const long long t = (long long)remaining - o;  // places of bucket b this block takes
      placed = t < 0 ? 0 : (t > bt ? bt : t);
    }
    __syncthreads();
    const long long got = min((long long)remaining, s_total);
    const bool fill = got > 0;
    const bool same = fill && remaining - got > 0 && (flag & 2);
    next = same || d_next != nullptr;
    const K1Class cur = nc;
    if (!same && d_next != nullptr) nc = k1_class(s_d[1], R);
    f.on = fill;
    if (fill) {
      f.clamp = (flag & 1) != 0;
      f.cls = cur;
      f.remaining = remaining;
      f.mode = s_take;
      f.partial = s_partial;
      f.assigned = assigned;
      f.base = 0;
      if (f.partial >= 0) {  // places before the warp's first node of that bucket
        const long long x = lane < warp ? (long long)wtot[(size_t)lane * kBuckets + f.partial] : 0;
        f.base = s_off[f.partial] + __shfl_sync(kFull, warp_sum(x), 0);
      }
    }
  }
  int feas = 0;
  if (f.on || next)
    feas = k1_sweep(v, j0, j1, f, MODE == kK7rTerms && flag, next, nc, thr, over_denom);
  const long long n_feas = k7r_block_sum(feas, s_w);
  const long long n_placed = k7r_block_sum(placed, s_w);
  if (tid == 0) {
    out[0] = n_placed;
    out[1] = n_feas;
  }
}

// ---------------------------------------------------------------------------
// K6: the two-phase [C, N] rounds core (kernel_np.schedule_classes_rounds,
// op for op), replacing ray_tpu/sched/kernel_jax.py:226 _rounds_core and
// :370 schedule_classes_chunked (chunks of 16 classes, the availability
// carried from chunk to chunk); K5 runs the same core as three kernels a
// phase (below), which measured faster for every class at once. Each global
// round is phase A (fill the nodes under the spread threshold up to it),
// then phase B (an equal share of the rest over the feasible nodes). In a
// phase every class claims a prefix of the nodes, in node order, up to its
// remaining count (want); then each node trims the claims, classes in index
// order, against what the earlier classes' claims use (take).
//
// Bound on this card: the latency of a chain of dependent steps, not bytes
// or operations. The work is a few IEEE divisions per (class, node,
// demanded column) and phase (~0.01-0.02 ms of issue at the stream's first
// round), but each phase is a chain: the prefix along N needs every node's
// cap, the trim needs the prefix, the next phase needs the debit; and a
// launch a step costs ~10 us of launch and drain (profile_sched.py k5, k6;
// PERF.md), 192 of them a call for K6 as three kernels a phase.
//
// Design: one launch a call, of one thread-block cluster of P = 16 blocks
// (8 where the card has no room for 16) of 768 threads, which runs the
// call's whole loop: chunks, rounds, phases and tiles of 16 classes.
//  - Block r owns nodes [r*Nb, (r+1)*Nb), Nb = ceil(N / P): N is padded up
//    to a multiple of P with dead nodes that hold no state. A block keeps its
//    nodes' state for the whole call (rounds_plan): the active columns'
//    avail and total, the trim's usage prefixes and debits (double), flags,
//    and each node's largest utilization term over the inactive columns.
//    Those columns change only by the clamp at zero, which is idempotent
//    after the call's first phase, so the term is taken once from the view
//    as given (for the first phase A) and once after the first phase's clamp
//    (for every later one). The rows are written back once, at the end.
//    Above the shared-memory budget the same arrays live in global scratch
//    (SMEM = false).
//  - A tile's caps (then wants, then takes) and its per-segment totals and
//    bases live beside them and never reach device memory. The steps of a
//    tile in a phase, all but the trim over (class, 32-node segment) units,
//    a warp a unit, so that every warp has work:
//      1. caps: phase A min(fit, threshold cap) on a node under the
//         threshold, else 0; phase B fit, and the block's count of feasible
//         nodes of each class;
//      2. phase B: one exchange of the counts, with the tile's placed counts
//         of phase A in the same message; then remaining, share = ceil(rem /
//         max(n_feas, 1)) and capc = min(fit, share, min(rem, SAT));
//      3. each segment's total of capc (one warp reduction), the block's
//         totals, saturating at SAT (exact: a saturating sum of nonnegative
//         terms is associative);
//      4. one exchange of the 16 block totals; each segment's base is the
//         saturating sum of the lower blocks' and segments' totals;
//      5. want = clip(rem - ((float)incl - capc), 0, capc), incl = min(base +
//         the warp's inclusive prefix, SAT), literally as kernel_np writes
//         it, skipped for a segment that can want nothing of a class (no cap
//         there, or a base in [rem, SAT - rem]); then the trim, a thread a
//         node, over the classes its segment wants, the usage prefixes
//         carried from tile to tile of the phase; assigned += take by the
//         cell's owner thread (a reduction, so that no thread waits for the
//         old value; no two threads share a cell); the tile's placed counts.
//    At a phase's end every node's active columns are debited and clamped,
//    max(avail - usage, 0), and the phase B placed counts are exchanged (up
//    to 256 classes a message) so that `remaining` is settled before the
//    next round's phase A; the last phase of a chunk needs none.
//  - The exchanges push (K1's form): st.async into the peers' shared memory,
//    completing on their mbarriers, a double-buffered pair of buffers and
//    mbarriers for each kind of message, each mbarrier armed a use ahead;
//    bounded waits that trap.
//  - An exact skip: a class whose remaining is 0 has capc = 0, so want =
//    take = usage = 0, and in phase B its share is 0: it changes nothing. A
//    tile whose classes all have remaining 0 is skipped, and so is the
//    placed exchange of a phase that ran no tile. Every block holds the same
//    remaining after the exchanges, so every block takes the same branches
//    and meets every exchange. Padded classes (count 0) are such classes.
//    The first phase's clamp runs all the same.
//  - `assigned` is written whole in each chunk's first phase (take, or 0 in
//    a skipped tile), so a call enqueues this one kernel and no fill.
//  - Up to 4 active columns (the main path has 3), the caps and the trim
//    hold a node's columns in registers, the caps' numerators taken once a
//    tile; the trim's columns then bound take independently and the least
//    bound wins (min is exact in any order). More columns take rolled
//    loops. Both divide by __fdiv_rn.
//
// Numerics (decisions bit-identical to kernel_np on integer-granular
// problems, counts < 2**23): IEEE division, no contraction (--fmad=false
// plus explicit __fmul_rn / __fadd_rn where numpy rounds a product before a
// sum), float -> int conversions truncate. The saturating prefixes mirror
// the reference literally: along N the prefix clipped at SAT, cast to
// float32, minus the element (when saturated that is NOT the exclusive
// prefix); along C each column's usage want*d is rounded to float32 and
// accumulated in double (kernel_np._sat_cumsum_f), clipped at SAT, cast to
// float32, minus the element. The debit sums take*d in double and rounds
// once (exact for integer-granular demands, like the reference's float32
// product).
// ---------------------------------------------------------------------------
constexpr int kRThreads = 768;
constexpr int kRTile = 16;                     // classes a tile
constexpr int kRMaxCluster = 16;
constexpr int kRMaxGroup = 256;                // classes a placed exchange carries
constexpr int kRCntWords = 2 * kRTile;         // feasible counts, then phase A's placed
constexpr int kRTotWords = kRTile;             // block totals
constexpr size_t kRSmemBudget = 216 * 1024;    // dynamic shared memory of one block
constexpr float kSat = 8388608.0f;             // SAT = 2**23
constexpr int kSatI = 1 << 23;
constexpr float kMinDemand = 1e-9f;            // np.float32(1e-9)
constexpr int kRRegCols = 4;                   // active columns the register form holds

// The stride of a block's per-node arrays: its node count rounded up to
// whole 32-node segments (a warp's nodes in every node-local step).
__host__ __device__ inline int rounds_stride(int Nb) { return (Nb + 31) & ~31; }

// Classes a placed exchange carries: the chunk's, rounded up to 16, at most
// kRMaxGroup.
__host__ __device__ inline int rounds_group(int C, int chunk) {
  const int cc = chunk < C ? chunk : C;
  const int g = (cc + 15) & ~15;
  return g < kRMaxGroup ? g : kRMaxGroup;
}

// Bytes of one block's node state at stride S over A active columns: the
// usage prefix and debit (f64), avail and total (f32) by column, the
// inactive columns' term (f32), the tile's caps (f32), the per-segment
// totals and offsets of each class of the tile (i32, 16 x S / 32 each),
// flags and under (u8), the segments' masks of wanted classes (u32 a
// segment, S bytes held); 16-aligned.
__host__ __device__ inline size_t rounds_node_bytes(int S, int A) {
  return ((size_t)(24 * A + 4 + 4 * kRTile + 4 + 3) * S + 15) & ~(size_t)15;
}

// Bytes of the exchange buffers: [2][P][words] for each kind of message.
__host__ __device__ inline size_t rounds_exchange_bytes(int P, int G) {
  return (size_t)2 * P * (kRCntWords + kRTotWords + G) * 4;
}

struct RoundsPlan {
  int Nb;                     // nodes a block
  int S;                      // stride of the per-node arrays
  int G;                      // classes a placed exchange
  bool rows;                  // node state in shared memory
  size_t smem;                // dynamic shared memory a block
  long long scratch_words;    // int32 words of global scratch
};

// The global scratch: every block's copy of remaining [P][C] (f32) and its
// placed partials [P][C] (i32); then, without `rows`, every block's node
// state.
RoundsPlan rounds_plan(int N, int A, int C, int chunk, int P) {
  RoundsPlan pl;
  pl.Nb = (N + P - 1) / P;
  pl.S = rounds_stride(pl.Nb);
  pl.G = rounds_group(C, chunk);
  const size_t ex = rounds_exchange_bytes(P, pl.G), nb = rounds_node_bytes(pl.S, A);
  pl.rows = ex + nb <= kRSmemBudget;
  pl.smem = ex + (pl.rows ? nb : 0);
  pl.scratch_words = 2LL * P * C + (pl.rows ? 0 : (long long)P * (long long)(nb / 4));
  return pl;
}

// One block's node state (rounds_node_bytes), by column at stride S, from
// one base (shared memory, or the block's global scratch).
struct RNodes {
  unsigned char* base;
  int S, A;
  // the trim's usage prefix over the phase's classes, [A][S]
  __device__ __forceinline__ double& acc(int a, int j) const {
    return reinterpret_cast<double*>(base)[(size_t)a * S + j];
  }
  // the phase's debit, [A][S]
  __device__ __forceinline__ double& use(int a, int j) const {
    return reinterpret_cast<double*>(base)[(size_t)(A + a) * S + j];
  }
  __device__ __forceinline__ float* f32(int row) const {
    return reinterpret_cast<float*>(base + (size_t)16 * A * S) + (size_t)row * S;
  }
  // avail and total of the active columns, [A][S] each
  __device__ __forceinline__ float& av(int a, int j) const { return f32(a)[j]; }
  __device__ __forceinline__ float& tt(int a, int j) const { return f32(A + a)[j]; }
  // the largest utilization term over the inactive columns, [S]
  __device__ __forceinline__ float& uin(int j) const { return f32(2 * A)[j]; }
  // the tile's caps, [16][S]
  __device__ __forceinline__ float& cw(int c, int j) const { return f32(2 * A + 1 + c)[j]; }
  // each 32-node segment's total of class c's caps, and the places before
  // the segment (the lower blocks' and segments'), [16][S / 32] each
  __device__ __forceinline__ int& seg_total(int c, int s) const {
    return reinterpret_cast<int*>(f32(2 * A + 1 + kRTile))[c * (S >> 5) + s];
  }
  __device__ __forceinline__ int& seg_base(int c, int s) const {
    return reinterpret_cast<int*>(f32(2 * A + 1 + kRTile))[(kRTile + c) * (S >> 5) + s];
  }
  // alive; alive and under the threshold (phase A); [S]
  __device__ __forceinline__ uint8_t& flags(int j) const {
    return reinterpret_cast<uint8_t*>(f32(2 * A + 2 + kRTile))[j];
  }
  __device__ __forceinline__ uint8_t& under(int j) const {
    return reinterpret_cast<uint8_t*>(f32(2 * A + 2 + kRTile))[S + j];
  }
  // the classes of the tile a segment wants any of, [S / 32] (u32), and
  // whether a segment has a node on this phase, [S / 32] (u8): S bytes held
  __device__ __forceinline__ unsigned& seg_want(int s) const {
    return reinterpret_cast<unsigned*>(
        reinterpret_cast<uint8_t*>(f32(2 * A + 2 + kRTile)) + 2 * S)[s];
  }
  __device__ __forceinline__ uint8_t& seg_on(int s) const {
    return reinterpret_cast<uint8_t*>(f32(2 * A + 2 + kRTile))[2 * S + S / 2 + s];
  }
};

// critical_util's terms over the columns no class demands (slot < 0) of
// node n, after the clamp at zero when `clamped`
__device__ __forceinline__ float inactive_util(const float* __restrict__ avail,
                                               const float* __restrict__ total, size_t n, int R,
                                               const int* slot, bool clamped) {
  float u = __int_as_float(0xff800000);  // -inf
  for (int r = 0; r < R; ++r) {
    if (slot[r] >= 0) continue;
    float x = avail[n * R + r];
    if (clamped) x = fmaxf(x, 0.f);
    u = fmaxf(u, used_frac(x, total[n * R + r]));
  }
  return u;
}

// Push `words` (a multiple of 4) words of `msg` (shared, 16-aligned) into
// slot `rank` of buffer `buf` ([P][words]) of every block of the cluster,
// completing on that block's `bar`, one 16-byte piece a thread.
__device__ __forceinline__ void rounds_push(const unsigned* msg, unsigned* buf, uint64_t* bar,
                                            int words, int P, int rank) {
  const int per = words >> 2;
  for (int i = threadIdx.x; i < P * per; i += kRThreads) {
    const int q = i / per, k = i - q * per;
    st_async(peer_u32(buf + (size_t)rank * words + 4 * k, q),
             *reinterpret_cast<const uint4*>(msg + 4 * k), peer_u32(bar, q));
  }
}

// Wait for use `u` of a double-buffered exchange (buffer u & 1), then (one
// thread) arm its mbarrier for use u + 2: every block sends that use only
// after this block's use u + 1, which follows a block barrier.
__device__ __forceinline__ const unsigned* rounds_receive(uint64_t (&bar)[2], const unsigned* buf,
                                                          int slot_words, int P, unsigned u,
                                                          uint32_t bytes, bool arm) {
  const int b = u & 1;
  mbar_wait(&bar[b], (u >> 1) & 1u);
  if (arm) mbar_arm(&bar[b], bytes);
  return buf + (size_t)b * P * slot_words;
}

// A class's caps over the warp's 32-node segment into the segment's total
// (exact: 32 caps below 2**23 each), saturated at SAT.
__device__ __forceinline__ void rounds_seg_total(const RNodes& v, int c, int seg, float capc) {
  const unsigned s = __reduce_add_sync(kFull, (unsigned)capc);
  if ((threadIdx.x & 31) == 0) v.seg_total(c, seg) = (int)min(s, (unsigned)kSatI);
}

// One cap for node j, class c: phase A min(clip(fit), clip(threshold cap)
// + 1), phase B clip(fit); 0 where the node is off (dead, or over the
// threshold in phase A). AMAX > 0: the columns unrolled to AMAX, the
// node's numerators (avail + eps, headroom + eps) in xe, he; else rolled.
template <int AMAX>
__device__ __forceinline__ float rounds_cap(const RNodes& v, int j, bool on, int c, bool phase_b,
                                            int A, float thr, const float (*td)[kMaxR],
                                            const float* xe, const float* he) {
  float fit = kInfFit, k = kInfFit;
  if (AMAX > 0 && on) {
#pragma unroll
    for (int a = 0; a < AMAX; ++a) {
      const float d = td[c][a];
      if (a < A && d > 0.f) {
        const float dm = fmaxf(d, kMinDemand);
        fit = fminf(fit, floorf(__fdiv_rn(xe[a], dm)));
        if (!phase_b) k = fminf(k, floorf(__fdiv_rn(he[a], dm)));
      }
    }
  } else if (on) {
    for (int a = 0; a < A; ++a) {
      const float d = td[c][a];
      if (d <= 0.f) continue;
      const float dm = fmaxf(d, kMinDemand), x = v.av(a, j);
      fit = fminf(fit, floorf(__fdiv_rn(__fadd_rn(x, kEps), dm)));
      if (!phase_b) {
        const float t = v.tt(a, j);
        const float head = __fsub_rn(__fmul_rn(thr, t), __fsub_rn(t, x));
        k = fminf(k, floorf(__fdiv_rn(__fadd_rn(head, kEps), dm)));
      }
    }
  }
  fit = on ? fminf(fmaxf(fit, 0.f), kInfFit) : 0.f;
  // clip(k, 0, float32(INF_FIT) - 1) + 1; float32(2**30 - 1) == 2**30
  return phase_b ? fit : fminf(fit, __fadd_rn(fminf(fmaxf(k, 0.f), kInfFit), 1.f));
}

// Step 1 of a tile, caps, a warp a 32-node segment, the tile's classes with
// tasks left (`live`) in turn: phase A capc = min(cap, min(rem, SAT)) and
// the segment's total; phase B fit, and the block's count of feasible
// nodes of each class (s_cnt). A segment with no node on (alive, and under
// the threshold in phase A) has every cap 0: it is marked off (seg_on) and
// its caps are not written.
template <int AMAX>
__device__ __forceinline__ void rounds_caps(const RNodes& v, int nl, unsigned live, bool phase_b,
                                            int A, float thr, const float (*td)[kMaxR],
                                            const float* s_rem, int* s_cnt) {
  const int lane = threadIdx.x & 31;
  const int nseg = (nl + 31) >> 5;
  for (int seg = threadIdx.x >> 5; seg < nseg; seg += kRThreads / 32) {
    const int j = seg * 32 + lane;
    const bool in = j < nl;
    const bool on = in && (phase_b ? (v.flags(j) & 1) : v.under(j));
    const bool any = __any_sync(kFull, on);
    if (lane == 0) v.seg_on(seg) = any;
    if (!any) {
      if (!phase_b && ((live >> lane) & 1u)) v.seg_total(lane, seg) = 0;
      continue;
    }
    constexpr int AR = AMAX > 0 ? AMAX : 1;
    float xe[AR], he[AR];  // the node's numerators, taken once for every class
#pragma unroll
    for (int a = 0; a < AR; ++a) {
      const float x = AMAX > 0 && on && a < A ? v.av(a, j) : 0.f;
      const float t = AMAX > 0 && on && a < A ? v.tt(a, j) : 0.f;
      xe[a] = __fadd_rn(x, kEps);
      he[a] = __fadd_rn(__fsub_rn(__fmul_rn(thr, t), __fsub_rn(t, x)), kEps);
    }
    for (unsigned m = live; m; m &= m - 1) {
      const int c = __ffs(m) - 1;
      const float fit = rounds_cap<AMAX>(v, j, on, c, phase_b, A, thr, td, xe, he);
      if (!phase_b) {
        const float capc = fminf(fit, fminf(s_rem[c], kSat));
        if (in) v.cw(c, j) = capc;
        rounds_seg_total(v, c, seg, capc);
      } else {
        if (in) v.cw(c, j) = fit;
        const unsigned feas = __ballot_sync(kFull, fit > 0.f);
        if (lane == 0 && feas) atomicAdd(&s_cnt[c], __popc(feas));
      }
    }
  }
}

// Phase B, after the count exchange: capc = min(fit, share, min(rem, SAT))
// and each segment's total (0 in a segment marked off), a warp a segment.
__device__ __forceinline__ void rounds_share_caps(const RNodes& v, int nl, unsigned live,
                                                  const float* s_rem, const float* s_share) {
  const int lane = threadIdx.x & 31;
  const int nseg = (nl + 31) >> 5;
  for (int seg = threadIdx.x >> 5; seg < nseg; seg += kRThreads / 32) {
    if (!v.seg_on(seg)) {
      if ((live >> lane) & 1u) v.seg_total(lane, seg) = 0;
      continue;
    }
    const int j = seg * 32 + lane;
    for (unsigned m = live; m; m &= m - 1) {
      const int c = __ffs(m) - 1;
      float capc = 0.f;
      if (j < nl) {
        capc = fminf(fminf(v.cw(c, j), s_share[c]), fminf(s_rem[c], kSat));
        v.cw(c, j) = capc;
      }
      rounds_seg_total(v, c, seg, capc);
    }
  }
}

// Step 5a, want, a warp a segment: incl = min(the segment's base + the
// warp's inclusive prefix of capc, SAT) and want = clip(rem - ((float)incl
// - capc), 0, capc), written over capc, for the classes the segment can
// want anything of: a cap there (the segment's total) and a base outside
// [rem, SAT - rem] (inside it every node's (float)incl - capc is at least
// rem). The segment's mask of the classes it wants (seg_want).
__device__ __forceinline__ void rounds_want(const RNodes& v, int nl, unsigned live,
                                            const float* s_rem) {
  const int lane = threadIdx.x & 31;
  const int nseg = (nl + 31) >> 5;
  for (int seg = threadIdx.x >> 5; seg < nseg; seg += kRThreads / 32) {
    bool need = false;
    if ((live >> lane) & 1u) {  // lane c judges class c
      const int base = v.seg_base(lane, seg), rem = (int)s_rem[lane];
      need = v.seg_total(lane, seg) > 0 && !(base >= rem && base <= kSatI - rem);
    }
    unsigned wanted = 0;
    const int j = seg * 32 + lane;
    for (unsigned m = __ballot_sync(kFull, need); m; m &= m - 1) {
      const int c = __ffs(m) - 1;
      const float capc = j < nl ? v.cw(c, j) : 0.f;
      int incl = (int)capc;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += y;
      }
      incl = min(v.seg_base(c, seg) + incl, kSatI);
      const float w =
          fminf(fmaxf(__fsub_rn(s_rem[c], __fsub_rn((float)incl, capc)), 0.f), capc);
      if (j < nl) v.cw(c, j) = w;
      if (__any_sync(kFull, w > 0.f)) wanted |= 1u << c;
    }
    if (lane == 0) v.seg_want(seg) = wanted;
  }
}

// One class's column of the trim: the usage prefix acc (double) takes u =
// want * d, and where d > 0 the column's headroom for the class is
// clip(floor((avail - prev + eps) / d), 0, SAT), prev = (float)min(acc,
// SAT) - u; take is want trimmed to the least of them. The register form:
// every column's headroom on its own (the columns' chains independent),
// then their minimum: `use` false leaves acc as it is and gives SAT. The
// rolled form: the running t; a column is skipped where t*d <= the
// numerator exactly (its quotient is then at least t, an integer below
// 2**24).
__device__ __forceinline__ float trim_headroom(bool use, float w, float d, float av,
                                               double& acc) {
  const float u = __fmul_rn(w, d);
  const double a2 = acc + (double)u;
  acc = use ? a2 : acc;
  const float pr = __fsub_rn((float)fmin(a2, (double)kSat), u);
  const float hp = __fadd_rn(__fsub_rn(av, pr), kEps);
  const float q = fminf(fmaxf(floorf(__fdiv_rn(hp, fmaxf(d, kMinDemand))), 0.f), kSat);
  return use && d > 0.f ? q : kSat;
}

__device__ __forceinline__ void trim_column(float w, float d, float av, double& acc, float& t) {
  const float u = __fmul_rn(w, d);
  acc += (double)u;
  if (d > 0.f && t > 0.f) {
    const float pr = __fsub_rn((float)fmin(acc, (double)kSat), u);
    const float hp = __fadd_rn(__fsub_rn(av, pr), kEps);
    const float dm = fmaxf(d, kMinDemand);
    if (!(__fmaf_rn(t, dm, -hp) <= 0.f))
      t = fminf(t, fminf(fmaxf(floorf(__fdiv_rn(hp, dm)), 0.f), kSat));
  }
}

// Step 5b, the trim, a thread a node, the classes its segment wants in
// index order: take = want trimmed to every demanded column's headroom
// (trim_column), the usage prefixes carried from tile to tile of the phase
// (in registers up to 4 columns); take written over want, for the
// placed pass; assigned += take (`fresh`: every cell written; else a
// reduction where take > 0, so that no thread waits for a cell's old
// value).
template <int AMAX>
__device__ __forceinline__ void rounds_trim_warp(const RNodes& v, int j, bool in, unsigned want,
                                                 int ct, int A, bool fresh,
                                                 const float (*td)[kMaxR],
                                                 int* __restrict__ cells, int N) {
  constexpr bool REG = AMAX > 0;
  constexpr int AR = REG ? AMAX : 1;
  float avr[AR];
  double accr[AR], user[AR];
  if (REG) {
#pragma unroll
    for (int a = 0; a < AR; ++a) {
      const bool ok = a < A && in;
      avr[a] = ok ? v.av(a, j) : 0.f;
      accr[a] = ok ? v.acc(a, j) : 0.0;
      user[a] = ok ? v.use(a, j) : 0.0;
    }
  }
  for (int c = 0; c < ct; ++c) {
    int* cell = cells + (size_t)c * N + j;
    if (!((want >> c) & 1u)) {
      if (fresh && in) *cell = 0;
      continue;
    }
    const float w = in ? v.cw(c, j) : 0.f;
    float t = w;
    if (REG) {
      float room[AR];
#pragma unroll
      for (int a = 0; a < AR; ++a) {
        const float d = td[c][a];
        room[a] = kSat;
        if (a < A && d != 0.f)  // the same in the warp: one class
          room[a] = trim_headroom(w > 0.f, w, d, avr[a], accr[a]);
      }
#pragma unroll
      for (int a = 0; a < AR; ++a) t = fminf(t, room[a]);
    } else if (w > 0.f) {
      for (int a = 0; a < A; ++a) {
        const float d = td[c][a];
        if (d == 0.f) continue;  // adds nothing to the usage prefix
        double acc = v.acc(a, j);
        trim_column(w, d, v.av(a, j), acc, t);
        v.acc(a, j) = acc;
      }
    }
    t = fminf(fmaxf(t, 0.f), w);
    const int take = (int)t;
    if (REG) {
#pragma unroll
      for (int a = 0; a < AR; ++a)
        user[a] += take > 0 && a < A ? (double)t * (double)td[c][a] : 0.0;
    } else if (take > 0) {
      for (int a = 0; a < A; ++a) v.use(a, j) += (double)t * (double)td[c][a];
    }
    if (in) {
      v.cw(c, j) = t;
      if (fresh)
        *cell = take;
      else if (take > 0)
        atomicAdd(cell, take);
    }
  }
  if (REG) {
#pragma unroll
    for (int a = 0; a < AR; ++a) {
      if (a < A && in) {
        v.acc(a, j) = accr[a];
        v.use(a, j) = user[a];
      }
    }
  }
}

// Step 5c: each class's places in this block (s_placed), a warp a segment,
// from the takes the trim left in the caps' place.
__device__ __forceinline__ void rounds_placed(const RNodes& v, int nl, int* s_placed) {
  const int lane = threadIdx.x & 31;
  const int nseg = (nl + 31) >> 5;
  for (int seg = threadIdx.x >> 5; seg < nseg; seg += kRThreads / 32) {
    const int j = seg * 32 + lane;
    for (unsigned m = v.seg_want(seg); m; m &= m - 1) {
      const int c = __ffs(m) - 1;
      const unsigned got = __reduce_add_sync(kFull, j < nl ? (unsigned)v.cw(c, j) : 0u);
      if (lane == 0 && got) atomicAdd(&s_placed[c], (int)got);
    }
  }
}


template <int AMAX, bool SMEM>
__global__ void __launch_bounds__(kRThreads, 1)
schedule_rounds_kernel(float* __restrict__ avail, const float* __restrict__ total,
                       const uint8_t* __restrict__ alive, const float* __restrict__ demands,
                       const int* __restrict__ counts, unsigned long long mask, int A,
                       int* __restrict__ assigned, int* __restrict__ scratch, int N, int R, int C,
                       int chunk, int Nb, int G, float thr, int rounds) {
  cg::cluster_group cluster = cg::this_cluster();
  const int P = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int first = rank * Nb;
  const int nl = max(0, min(Nb, N - first));
  const int nseg = (nl + 31) >> 5;
  const int tid = threadIdx.x;
  __shared__ int s_col[kMaxR];                 // the active columns, lowest first
  __shared__ int s_slot[kMaxR];                // column r's place among them, or -1
  __shared__ float s_td[kRTile][kMaxR];        // the tile's demands on the active columns
  __shared__ float s_rem[kRTile];              // the tile's remaining
  __shared__ float s_share[kRTile];            // phase B's equal shares
  __shared__ int s_cnt[kRTile];                // this block's feasible nodes (phase B)
  __shared__ int s_placed[kRTile];             // this block's placed, this tile and phase
  __shared__ int s_sum[kRCntWords];            // the cluster's sums of a count message
  __shared__ __align__(16) unsigned s_msg[kRCntWords];  // what this block sends
  __shared__ __align__(16) unsigned s_stage[kRMaxGroup];  // its placed partials, a group
  __shared__ __align__(8) uint64_t s_bar_cnt[2], s_bar_tot[2], s_bar_plc[2];
  extern __shared__ __align__(16) unsigned char s_dyn[];
  R_PROFILE_DECL;

  // the exchange buffers, [2][P][words] each
  unsigned* cnt_in = reinterpret_cast<unsigned*>(s_dyn);
  unsigned* tot_in = cnt_in + 2 * P * kRCntWords;
  unsigned* plc_in = tot_in + 2 * P * kRTotWords;
  float* rem_g = reinterpret_cast<float*>(scratch) + (size_t)rank * C;
  int* placed_g = scratch + (size_t)P * C + (size_t)rank * C;
  RNodes v;
  v.S = rounds_stride(Nb);
  v.A = A;
  v.base = SMEM ? s_dyn + rounds_exchange_bytes(P, G)
                : reinterpret_cast<unsigned char*>(scratch + 2 * (size_t)P * C) +
                      (size_t)rank * rounds_node_bytes(v.S, A);
  const uint32_t cnt_bytes = 4u * kRCntWords * P, tot_bytes = 4u * kRTotWords * P,
                 plc_bytes = 4u * G * P;

  if (tid == 0) {
    for (int b = 0; b < 2; ++b) {
      mbar_init(&s_bar_cnt[b]);
      mbar_init(&s_bar_tot[b]);
      mbar_init(&s_bar_plc[b]);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int b = 0; b < 2; ++b) {
      mbar_arm(&s_bar_cnt[b], cnt_bytes);
      mbar_arm(&s_bar_tot[b], tot_bytes);
      mbar_arm(&s_bar_plc[b], plc_bytes);
    }
  }
  if (tid < kMaxR) {
    const bool on = tid < R && ((mask >> tid) & 1ull);
    const int a = __popcll(mask & ((1ull << tid) - 1ull));
    s_slot[tid] = on ? a : -1;
    if (on) s_col[a] = tid;
  }
  for (int c = tid; c < C; c += kRThreads) rem_g[c] = (float)counts[c];
  __syncthreads();
  for (int e = tid; e < nl * R; e += kRThreads) {
    const int j = e / R, r = e - j * R, a = s_slot[r];
    if (a >= 0) {
      v.av(a, j) = avail[(size_t)first * R + e];
      v.tt(a, j) = total[(size_t)first * R + e];
    }
  }
  for (int j = tid; j < nl; j += kRThreads) {
    v.flags(j) = alive[first + j] ? 1 : 0;
    v.uin(j) = inactive_util(avail, total, (size_t)first + j, R, s_slot, false);
    for (int a = 0; a < A; ++a) {
      v.acc(a, j) = 0.0;
      v.use(a, j) = 0.0;
    }
  }
  cluster.sync();  // every block resident, its mbarriers initialised and armed

  unsigned use_cnt = 0, use_tot = 0, use_plc = 0;  // uses of each exchange
  bool first_phase = true;
  R_PROFILE_START();
  for (int cs = 0; cs < C; cs += chunk) {
    const int Cc = min(chunk, C - cs);
    for (int rd = 0; rd < rounds; ++rd) {
      for (int ph = 0; ph < 2; ++ph) {
        const bool phase_b = ph == 1;
        const bool fresh = rd == 0 && !phase_b;  // the chunk's first phase writes `assigned`
        if (!phase_b) {
          // critical_util < thr on a live node: the fill of phase A
          for (int j = tid; j < nl; j += kRThreads) {
            float u = v.uin(j);
            for (int a = 0; a < A; ++a) u = fmaxf(u, used_frac(v.av(a, j), v.tt(a, j)));
            v.under(j) = (v.flags(j) & 1) && u < thr;
          }
        }
        bool ran = false;
        for (int t0 = 0; t0 < Cc; t0 += kRTile) {
          const int ct = min(kRTile, Cc - t0);
          const int c0 = cs + t0;  // the tile's first class
          __syncthreads();         // the previous tile is done with s_*
          if (tid < kRTile) {
            s_rem[tid] = tid < ct ? rem_g[c0 + tid] : 0.f;
            s_cnt[tid] = 0;
            s_placed[tid] = 0;
          } else if (tid >= 32) {  // other warps than the one loading s_rem
            for (int i = tid - 32; i < ct * A; i += kRThreads - 32) {
              const int c = i / A, a = i - c * A;
              s_td[c][a] = demands[(size_t)(c0 + c) * R + s_col[a]];
            }
          }
          __syncthreads();  // s_* are read from here on
          unsigned live = 0;  // the tile's classes with tasks left
          for (int c = 0; c < ct; ++c) live |= (s_rem[c] > 0.f ? 1u : 0u) << c;
          if (live) {
            // 1. caps
            rounds_caps<AMAX>(v, nl, live, phase_b, A, thr, s_td, s_rem, s_cnt);
            __syncthreads();
            R_MARK(0);
            if (phase_b) {
              // 2. the feasible counts, with phase A's placed partials
              if (tid < kRCntWords) {
                const int c = tid - kRTile;
                s_msg[tid] = tid < kRTile ? (unsigned)s_cnt[tid]
                                          : (c < ct ? (unsigned)placed_g[c0 + c] : 0u);
              }
              __syncthreads();
              rounds_push(s_msg, cnt_in + (size_t)(use_cnt & 1) * P * kRCntWords,
                          &s_bar_cnt[use_cnt & 1], kRCntWords, P, rank);
              if (tid < kRCntWords) {
                const unsigned* in =
                    rounds_receive(s_bar_cnt, cnt_in, kRCntWords, P, use_cnt, cnt_bytes, tid == 0);
                int sum = 0;
                for (int q = 0; q < P; ++q) sum += (int)in[q * kRCntWords + tid];
                s_sum[tid] = sum;
              }
              ++use_cnt;
              __syncthreads();
              if (tid < ct) {
                const float rem = __fsub_rn(s_rem[tid], (float)s_sum[kRTile + tid]);
                s_rem[tid] = rem;
                rem_g[c0 + tid] = rem;
                s_share[tid] = ceilf(__fdiv_rn(rem, fmaxf((float)s_sum[tid], 1.f)));
              }
              __syncthreads();
              live = 0;
              for (int c = 0; c < ct; ++c) live |= (s_rem[c] > 0.f ? 1u : 0u) << c;
              R_MARK(1);
              if (live) {
                rounds_share_caps(v, nl, live, s_rem, s_share);
                __syncthreads();
              }
            }
          }
          if (!live) {  // the same in every block: nothing to place in this tile
            if (fresh) {
              for (int i = tid; i < ct * nl; i += kRThreads) {
                const int c = i / nl;
                assigned[(size_t)(c0 + c) * N + first + (i - c * nl)] = 0;
              }
            }
            if (tid < ct) placed_g[c0 + tid] = 0;
            R_COUNT(1);
            continue;
          }
          // 3. the block's totals (saturating: exact, the terms are nonnegative)
          if (tid < kRTile) {
            int tot = 0;
            if ((live >> tid) & 1u)
              for (int s = 0; s < nseg; ++s) tot = min(tot + v.seg_total(tid, s), kSatI);
            s_msg[tid] = (unsigned)tot;
          }
          __syncthreads();
          R_MARK(2);
          // 4. the totals exchange; each segment's base
          rounds_push(s_msg, tot_in + (size_t)(use_tot & 1) * P * kRTotWords,
                      &s_bar_tot[use_tot & 1], kRTotWords, P, rank);
          if (tid < kRTile) {
            const unsigned* in =
                rounds_receive(s_bar_tot, tot_in, kRTotWords, P, use_tot, tot_bytes, tid == 0);
            if ((live >> tid) & 1u) {
              int base = 0;
              for (int q = 0; q < rank; ++q) base = min(base + (int)in[q * kRTotWords + tid], kSatI);
              for (int s = 0; s < nseg; ++s) {
                v.seg_base(tid, s) = base;
                base = min(base + v.seg_total(tid, s), kSatI);
              }
            }
          }
          ++use_tot;
          __syncthreads();
          R_MARK(3);
          // 5. want; the trim; the placed partials
          rounds_want(v, nl, live, s_rem);
          __syncthreads();
          for (int b0 = tid & ~31; b0 < nl; b0 += kRThreads) {
            const int j = b0 + (tid & 31);
            const unsigned want = v.seg_want(b0 >> 5);
            if (!want && !fresh) continue;
            int* cells = assigned + (size_t)c0 * N + first;
            rounds_trim_warp<AMAX>(v, j, j < nl, want, ct, A, fresh, s_td, cells, N);
          }
          __syncthreads();
          rounds_placed(v, nl, s_placed);
          __syncthreads();
          if (tid < ct) placed_g[c0 + tid] = s_placed[tid];
          ran = true;
          R_MARK(4);
          R_COUNT(0);
        }
        // the phase's debit and clamp: max(avail - usage, 0); after the
        // call's first phase no entry is negative, so a phase that placed
        // nothing changes nothing
        if (ran || first_phase) {
          for (int j = tid; j < nl; j += kRThreads) {
            for (int a = 0; a < A; ++a) {
              v.av(a, j) = fmaxf(__fsub_rn(v.av(a, j), (float)v.use(a, j)), 0.f);
              v.use(a, j) = 0.0;
              v.acc(a, j) = 0.0;
            }
            if (first_phase) v.uin(j) = inactive_util(avail, total, (size_t)first + j, R, s_slot, true);
          }
        }
        first_phase = false;
        R_MARK(5);
        // the placed partials of phase B settle `remaining` for the next round
        if (phase_b && ran && rd + 1 < rounds) {
          for (int g0 = 0; g0 < Cc; g0 += G) {
            __syncthreads();
            if (tid < G) s_stage[tid] = g0 + tid < Cc ? (unsigned)placed_g[cs + g0 + tid] : 0u;
            __syncthreads();
            rounds_push(s_stage, plc_in + (size_t)(use_plc & 1) * P * G, &s_bar_plc[use_plc & 1],
                        G, P, rank);
            if (tid < G) {
              const unsigned* in =
                  rounds_receive(s_bar_plc, plc_in, G, P, use_plc, plc_bytes, tid == 0);
              int sum = 0;
              for (int q = 0; q < P; ++q) sum += (int)in[q * G + tid];
              if (g0 + tid < Cc) {
                float* rem = rem_g + cs + g0 + tid;
                *rem = __fsub_rn(*rem, (float)sum);
              }
            }
            ++use_plc;
          }
          R_MARK(6);
        }
        __syncthreads();
      }
    }
  }
  // the rows, written back once: the active columns from the block's state,
  // the others clamped at zero as every phase's debit does
  for (int e = tid; e < nl * R; e += kRThreads) {
    const int j = e / R, r = e - j * R, a = s_slot[r];
    float* x = avail + (size_t)first * R + e;
    *x = a >= 0 ? v.av(a, j) : fmaxf(*x, 0.f);
  }
  R_PROFILE_FLUSH(rank);
  cluster.sync();  // no block exits while a peer's st.async to it may be in flight
}

template <int AMAX, bool SMEM>
cudaError_t rounds_config(int P, size_t smem, cudaStream_t st, cudaLaunchConfig_t& cfg,
                          cudaLaunchAttribute& attr) {
  auto kernel = schedule_rounds_kernel<AMAX, SMEM>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = (unsigned)P;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg = {};
  cfg.gridDim = dim3((unsigned)P, 1, 1);
  cfg.blockDim = dim3(kRThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

// Whether one cluster of P blocks of K6 with this plan fits on the card.
template <int AMAX, bool SMEM>
cudaError_t rounds_fits(int P, const RoundsPlan& pl, bool& fits) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = rounds_config<AMAX, SMEM>(P, pl.smem, nullptr, cfg, attr);
  if (err != cudaSuccess) return err;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters,
                                       (const void*)schedule_rounds_kernel<AMAX, SMEM>, &cfg);
  if (err != cudaSuccess) {  // this size is refused: the caller tries the next
    (void)cudaGetLastError();
    clusters = 0;
  }
  fits = clusters >= 1;
  return cudaSuccess;
}

template <int AMAX, bool SMEM>
cudaError_t launch_rounds(cudaStream_t st, int P, const RoundsPlan& pl, float* avail,
                          const float* total, const uint8_t* alive, const float* demands,
                          const int* counts, unsigned long long mask, int A, int* assigned,
                          int* scratch, int N, int R, int C, int chunk, float thr, int rounds) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = rounds_config<AMAX, SMEM>(P, pl.smem, st, cfg, attr);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&cfg, schedule_rounds_kernel<AMAX, SMEM>, avail, total, alive, demands,
                           counts, mask, A, assigned, scratch, N, R, C, chunk, pl.Nb, pl.G, thr,
                           rounds);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}



// ---------------------------------------------------------------------------
// K5: the two-phase [C, N] rounds core for every class at once
// (kernel_np.schedule_classes_rounds semantics, op for op), replacing
// ray_tpu/sched/kernel_jax.py:318 schedule_classes_rounds (+ :226
// _rounds_core, _sat_cumsum). Per global round, phase A (fill nodes under
// the spread threshold up to it) then phase B (equal-share the rest over the
// feasible nodes); each phase is three launches on one stream, no host sync:
//   1. rounds_caps_kernel   one thread per node, a tile of classes per block:
//                           the [C, N] cap matrix (A: min(fit, threshold
//                           cap) x under-threshold mask; B: fit, and the
//                           per-class count of feasible nodes);
//   2. rounds_prefix_kernel one block per class: the saturating prefix fill
//                           along N in node order -> want [C, N] (in place);
//   3. rounds_trim_kernel   one thread per node, classes in index order: the
//                           class-priority trim against the usage of earlier
//                           classes -> take; assigned += take; the debit of
//                           the node's row; per-class placed counts.
// The prefix kernel of the next phase settles `remaining -= placed` first.
//
// Bound on this card: bytes. Every phase writes and reads the [C, N] f32
// cap/want matrix twice (10 MB at 256 x 10k) and the trim reads it once
// more, against a few hundred operations per cell; the round itself must
// move only the [N, R] views and the [C, N] int32 result once. Design: the
// per-node kernels keep the node's active columns in registers and read
// the [C, N] scratch coalesced across a warp (row-major, one node per
// lane); the per-class prefix is an exact int64 block scan, tile by tile.
// With every class at once, 132 SMs share each launch's work; on one cluster
// (the kernel above) the same call measured 1.6x slower (PERF.md), so K5
// keeps these 24 launches a call at 4 rounds.
//
// Numerics (decisions bit-identical to kernel_np on integer-granular
// problems): IEEE division, no contraction (--fmad=false plus explicit
// __fmul_rn / __fadd_rn where numpy rounds a product before a sum), float
// -> int conversions truncate. The saturating prefixes mirror the
// reference literally: along N an exact int64 inclusive prefix clipped at
// SAT, cast to float32, minus the element (when saturated that is NOT the
// exclusive prefix); along C each column's usage want*d is rounded to
// float32 and accumulated in double (kernel_np._sat_cumsum_f), clipped at
// SAT, cast to float32, minus the element. The debit sums take*d in double
// and rounds once (exact for integer-granular demands, like the
// reference's float32 product).
// ---------------------------------------------------------------------------
constexpr int kNodeThreads = 128;     // per-node kernels of K5
constexpr int kCapClassTile = 16;     // classes per block of the cap kernel
constexpr int kPrefixThreads = 1024;

// The active columns (bits of `mask`, lowest first) as AMAX register slots.
template <int AMAX>
__device__ __forceinline__ void active_columns(unsigned long long mask, int (&col)[AMAX]) {
#pragma unroll
  for (int j = 0; j < AMAX; ++j) {
    col[j] = mask ? __ffsll((long long)mask) - 1 : 0;
    mask &= mask - 1;
  }
}

template <int AMAX, bool PHASE_A>
__global__ void __launch_bounds__(kNodeThreads)
rounds_caps_kernel(const float* __restrict__ avail, const float* __restrict__ total,
                   const uint8_t* __restrict__ alive, const float* __restrict__ demands,
                   unsigned long long mask, int A, int N, int R, int C, float thr,
                   float* __restrict__ cap, int* __restrict__ n_feas) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  const bool in = n < N;
  int col[AMAX];
  active_columns<AMAX>(mask, col);
  float av[AMAX] = {}, head[AMAX] = {};
  float alive_f = 0.f, under_f = 0.f;
  if (in) {
    const float* a = avail + (size_t)n * R;
    const float* t = total + (size_t)n * R;
    alive_f = alive[n] ? 1.f : 0.f;
#pragma unroll
    for (int j = 0; j < AMAX; ++j) {
      if (j < A) {
        av[j] = a[col[j]];
        if (PHASE_A) {
          const float tj = t[col[j]];
          head[j] = __fsub_rn(__fmul_rn(thr, tj), __fsub_rn(tj, av[j]));
        }
      }
    }
    if (PHASE_A) {
      // critical_util over every column, as kernel_np.critical_util
      float util = __int_as_float(0xff800000);  // -inf
      for (int r = 0; r < R; ++r) {
        const float tt = t[r];
        const float frac = tt > 0.f ? __fdiv_rn(__fsub_rn(tt, a[r]), fmaxf(tt, kEps)) : 0.f;
        util = fmaxf(util, frac);
      }
      under_f = (util < thr ? 1.f : 0.f) * alive_f;
    }
  }
  const int c1 = min((int)(blockIdx.y + 1) * kCapClassTile, C);
  for (int c = blockIdx.y * kCapClassTile; c < c1; ++c) {
    const float* d = demands + (size_t)c * R;
    float fit = kInfFit, k = kInfFit;
#pragma unroll
    for (int j = 0; j < AMAX; ++j) {
      if (j < A) {
        const float dj = __ldg(d + col[j]);
        if (dj > 0.f) {
          const float dm = fmaxf(dj, kMinDemand);
          fit = fminf(fit, floorf(__fdiv_rn(__fadd_rn(av[j], kEps), dm)));
          if (PHASE_A) k = fminf(k, floorf(__fdiv_rn(__fadd_rn(head[j], kEps), dm)));
        }
      }
    }
    fit = __fmul_rn(fminf(fmaxf(fit, 0.f), kInfFit), alive_f);
    float out = fit;
    if (PHASE_A) {
      // clip(k, 0, float32(INF_FIT) - 1) + 1; float32(2**30 - 1) == 2**30
      k = __fadd_rn(fminf(fmaxf(k, 0.f), kInfFit), 1.f);
      out = __fmul_rn(fminf(fit, k), under_f);
    }
    if (in) cap[(size_t)c * N + n] = out;
    if (!PHASE_A) {
      const unsigned feas = __ballot_sync(kFull, in && out > 0.f);
      if ((threadIdx.x & 31) == 0 && feas) atomicAdd(&n_feas[c], __popc(feas));
    }
  }
}

// One block per class. Settles the previous phase's placements into
// `remaining` (or loads the counts on the first phase), then turns the cap
// row into the want row in place.
template <bool PHASE_B>
__global__ void __launch_bounds__(kPrefixThreads)
rounds_prefix_kernel(float* __restrict__ cap, const int* __restrict__ counts,
                     float* __restrict__ remaining, int* __restrict__ placed,
                     int* __restrict__ n_feas, int N, int first) {
  __shared__ long long s_warp[32];
  __shared__ long long s_tile;
  __shared__ float s_rem, s_share;
  const int c = blockIdx.x;
  if (threadIdx.x == 0) {
    const float rem = first ? (float)counts[c] : __fsub_rn(remaining[c], (float)placed[c]);
    remaining[c] = rem;
    placed[c] = 0;
    s_rem = rem;
    if (PHASE_B) {
      s_share = ceilf(__fdiv_rn(rem, fmaxf((float)n_feas[c], 1.f)));
    } else {
      n_feas[c] = 0;  // phase B's cap kernel counts into it
    }
  }
  __syncthreads();
  const float rem = s_rem;
  const float satcap = fminf(rem, kSat);
  float* row = cap + (size_t)c * N;
  long long carry = 0;
  for (int start = 0; start < N; start += blockDim.x) {
    const int n = start + threadIdx.x;
    float capc = 0.f;
    if (n < N) {
      float cp = row[n];
      if (PHASE_B) cp = fminf(cp, s_share);
      capc = fminf(cp, satcap);
    }
    const long long v = (long long)capc;
    const long long ex = block_exclusive_scan(v, s_warp);
    if (n < N) {
      const long long incl = min(carry + ex + v, (long long)kSat);
      const float prev = __fsub_rn((float)incl, capc);
      row[n] = fminf(fmaxf(__fsub_rn(rem, prev), 0.f), capc);
    }
    if (threadIdx.x == blockDim.x - 1) s_tile = ex + v;
    __syncthreads();
    carry += s_tile;
    __syncthreads();
  }
}

template <int AMAX>
__global__ void __launch_bounds__(kNodeThreads)
rounds_trim_kernel(float* __restrict__ avail, const float* __restrict__ want,
                   const float* __restrict__ demands, unsigned long long mask, int A, int N,
                   int R, int C, int* __restrict__ assigned, int* __restrict__ placed) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  const bool in = n < N;
  int col[AMAX];
  active_columns<AMAX>(mask, col);
  float av[AMAX];
  double acc[AMAX], use[AMAX];
#pragma unroll
  for (int j = 0; j < AMAX; ++j) {
    av[j] = (in && j < A) ? avail[(size_t)n * R + col[j]] : 0.f;
    acc[j] = 0.0;
    use[j] = 0.0;
  }
  for (int c = 0; c < C; ++c) {
    const float w = in ? want[(size_t)c * N + n] : 0.f;
    int take_i = 0;
    // want == 0 adds nothing to the usage prefixes and takes nothing
    if (w > 0.f) {
      const float* d = demands + (size_t)c * R;
      float t = w;
#pragma unroll
      for (int j = 0; j < AMAX; ++j) {
        if (j < A) {
          const float dj = __ldg(d + col[j]);
          if (dj > 0.f) {
            const float u = __fmul_rn(w, dj);
            acc[j] += (double)u;
            const float prev = __fsub_rn((float)fmin(acc[j], (double)kSat), u);
            const float head = __fsub_rn(av[j], prev);
            const float fr =
                floorf(__fdiv_rn(__fadd_rn(head, kEps), fmaxf(dj, kMinDemand)));
            t = fminf(t, fminf(fmaxf(fr, 0.f), kSat));
          }
        }
      }
      t = fminf(fmaxf(t, 0.f), w);
      take_i = (int)t;
      if (take_i > 0) {
        assigned[(size_t)c * N + n] += take_i;
#pragma unroll
        for (int j = 0; j < AMAX; ++j)
          if (j < A) use[j] += (double)t * (double)__ldg(d + col[j]);
      }
    }
    const int got = __reduce_add_sync(kFull, take_i);
    if ((threadIdx.x & 31) == 0 && got) atomicAdd(&placed[c], got);
  }
  if (in) {
    // avail = max(avail - usage, 0) over every column (inactive ones have
    // zero usage but are clamped all the same, as the reference does)
    float* a = avail + (size_t)n * R;
#pragma unroll
    for (int j = 0; j < AMAX; ++j)
      if (j < A) a[col[j]] = __fsub_rn(av[j], (float)use[j]);
    for (int r = 0; r < R; ++r) a[r] = fmaxf(a[r], 0.f);
  }
}

template <int AMAX>
cudaError_t launch_rounds_phases(cudaStream_t st, float* avail, const float* total,
                                 const uint8_t* alive, const float* demands, const int* counts,
                                 unsigned long long mask, int A, int* assigned, float* cap,
                                 float* remaining, int* placed, int* n_feas, int N, int R,
                                 int C, float thr, int rounds) {
  const unsigned node_blocks = (unsigned)((N + kNodeThreads - 1) / kNodeThreads);
  const dim3 cap_grid(node_blocks, (unsigned)((C + kCapClassTile - 1) / kCapClassTile));
  for (int r = 0; r < rounds; ++r) {
    rounds_caps_kernel<AMAX, true><<<cap_grid, kNodeThreads, 0, st>>>(
        avail, total, alive, demands, mask, A, N, R, C, thr, cap, n_feas);
    rounds_prefix_kernel<false><<<C, kPrefixThreads, 0, st>>>(cap, counts, remaining, placed,
                                                              n_feas, N, r == 0);
    rounds_trim_kernel<AMAX><<<node_blocks, kNodeThreads, 0, st>>>(
        avail, cap, demands, mask, A, N, R, C, assigned, placed);
    rounds_caps_kernel<AMAX, false><<<cap_grid, kNodeThreads, 0, st>>>(
        avail, total, alive, demands, mask, A, N, R, C, thr, cap, n_feas);
    rounds_prefix_kernel<true><<<C, kPrefixThreads, 0, st>>>(cap, counts, remaining, placed,
                                                             n_feas, N, 0);
    rounds_trim_kernel<AMAX><<<node_blocks, kNodeThreads, 0, st>>>(
        avail, cap, demands, mask, A, N, R, C, assigned, placed);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K2 and K3 alone: refresh_view_kernel<MODE> refreshes the scheduler's view
// of the cluster, [N, R] float32, where no scan round follows the refresh
// (a scan round applies it in K1's launch):
//   kRefreshRows   K2, in place: out[idx[i], :] = rows[i, :] for every
//                  idx[i] in [0, N); other indices (the padding value N) are
//                  dropped, as mode="drop" does; in-range indices are
//                  distinct. One thread per element of rows, neighbouring
//                  threads on neighbouring columns of one row. Bound: bytes
//                  (idx, and each live row read and written).
//   kRefreshDelta  K3: out = clip(avail + delta, 0, total) on every entry
//                  (refresh_delta); a grid-stride elementwise pass. out may
//                  be avail itself (each element read, then written, by one
//                  thread). Bound: bytes (16 per element).
// ---------------------------------------------------------------------------
template <int MODE>
__global__ void refresh_view_kernel(float* out, const float* avail,
                                    const float* __restrict__ src,
                                    const float* __restrict__ total,
                                    const int* __restrict__ idx, int pad, int N, int R) {
  if (MODE == kRefreshRows) {
    const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
    if (i >= (long long)pad * R) return;
    const int row = (int)(i / R), col = (int)(i % R);
    const int n = idx[row];
    if (n < 0 || n >= N) return;
    out[(size_t)n * R + col] = src[i];
    return;
  }
  const long long n = (long long)N * R;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    out[i] = refresh_delta(avail[i], src[i], total[i]);
  }
}

// ---------------------------------------------------------------------------
// K4: COO compaction of the [C, N] assignment in row-major order, equal slot
// for slot to jnp.nonzero(out, size=cap, fill_value=0) plus the value gather:
// slots past the last nonzero hold cell (0, 0) and the value out[0, 0];
// past cap the list is cut. Bound: bytes (read C*N*4, write cap * (index +
// value widths)).
//
// One cooperative launch (cudaLaunchCooperativeKernel: every block resident
// at once) of at most as many blocks as the card holds. The matrix is read
// as int4 vectors in chunks of kK4Chunk vectors: warp w of a block owns the
// chunk's vectors [w*32*kK4Vecs, (w+1)*32*kK4Vecs), lane l of it vectors
// w*32*kK4Vecs + k*32 + l (k < kK4Vecs), so every load of a warp reads 512
// contiguous bytes. Element order within a chunk is warp-major, then k, then
// lane; a chunk's nonzeros are numbered by a shuffle scan a k and a scan of
// the warps' counts in shared memory.
//   - register form (a block a chunk, where the chunks fit the resident
//     blocks; the stream's [256, 10 000] takes 625): the chunk is read once
//     into registers and numbered, the block's count stored; after one grid
//     barrier each block adds the counts before it and writes its slots
//     from registers;
//   - looped form (more chunks than resident blocks, e.g. [256, 40 000]):
//     each block counts its run of chunks before the barrier, then reads the
//     run again (from L2) chunk by chunk, numbering and writing.
// Before the barrier the grid also fills every slot with the padding, cell
// (0, 0) and out[0, 0], while the loads are in flight; the nonzeros
// overwrite slots [0, min(nnz, cap)) after it, so the barrier orders the two
// writes of a slot. The block counts go to a scratch array of the caller's
// stream (one int a block, written before the barrier, read after it). No
// atomics, so the output is deterministic and fetch's assign-not-add
// reconstruction stays exact.
// ---------------------------------------------------------------------------
constexpr int kK4Threads = 256;
constexpr int kK4Warps = kK4Threads / 32;
constexpr int kK4Vecs = 4;                       // int4 a lane a chunk
constexpr int kK4Chunk = kK4Threads * kK4Vecs;   // vectors a chunk (4 096 ints)
constexpr int kK4MinBlocksPerSM = 5;             // registers <= 51: 660 blocks on 132 SMs
constexpr int kK4MaxDevices = 64;

struct K4Plan {
  int blocks;            // the grid
  int chunks_per_block;  // 1 in the register form
  int looped;
};

// The launch for M elements, given the blocks each form can hold resident.
K4Plan k4_plan(long long M, int resident_reg, int resident_loop) {
  const long long vecs = (M + 3) / 4;
  const long long chunks = (vecs + kK4Chunk - 1) / kK4Chunk;
  if (chunks <= resident_reg) return {(int)chunks, 1, 0};
  const long long per = (chunks + resident_loop - 1) / resident_loop;
  return {(int)((chunks + per - 1) / per), (int)per, 1};
}

__device__ __forceinline__ int nonzeros(const int4& v) {
  return (v.x != 0) + (v.y != 0) + (v.z != 0) + (v.w != 0);
}

// The lane's vectors of the chunk starting at vector c0; zeros past M.
__device__ __forceinline__ void k4_load(int4 (&v)[kK4Vecs], const int* __restrict__ x,
                                        long long M, long long c0) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < kK4Vecs; ++k) {
    const long long i = c0 + (warp * kK4Vecs + k) * 32 + lane;
    if (4 * i + 3 < M) {
      v[k] = reinterpret_cast<const int4*>(x)[i];
    } else {
      const long long e = 4 * i;
      v[k] = make_int4(e < M ? x[e] : 0, e + 1 < M ? x[e + 1] : 0, e + 2 < M ? x[e + 2] : 0,
                       e + 3 < M ? x[e + 3] : 0);
    }
  }
}

// The chunk's nonzeros before each of the lane's vectors, in element order
// (off), and the chunk's count (returned). Every thread calls it.
__device__ __forceinline__ int k4_number(const int4 (&v)[kK4Vecs], int (&off)[kK4Vecs],
                                         int* s_warp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int run = 0;
#pragma unroll
  for (int k = 0; k < kK4Vecs; ++k) {
    const int c = nonzeros(v[k]);
    int s = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, s, o);
      if (lane >= o) s += y;
    }
    off[k] = run + s - c;
    run += __shfl_sync(kFull, s, 31);
  }
  if (lane == 0) s_warp[warp] = run;
  __syncthreads();
  int before = 0, total = 0;
#pragma unroll
  for (int w = 0; w < kK4Warps; ++w) {
    const int t = s_warp[w];
    before += w < warp ? t : 0;
    total += t;
  }
  __syncthreads();  // s_warp is reused by the next call
#pragma unroll
  for (int k = 0; k < kK4Vecs; ++k) off[k] += before;
  return total;
}

// Slot p of the output: cell (c, n), value val, each in its width.
__device__ __forceinline__ void k4_store(void* ci, int ci_bytes, void* ni, int ni_bytes,
                                         void* vals, int val_bytes, long long p, long long c,
                                         long long n, int val) {
  if (ci_bytes == 2) static_cast<int16_t*>(ci)[p] = (int16_t)c;
  else static_cast<int32_t*>(ci)[p] = (int32_t)c;
  if (ni_bytes == 2) static_cast<int16_t*>(ni)[p] = (int16_t)n;
  else static_cast<int32_t*>(ni)[p] = (int32_t)n;
  if (val_bytes == 1) static_cast<uint8_t*>(vals)[p] = (uint8_t)val;
  else static_cast<int32_t*>(vals)[p] = val;
}

// Writes the lane's nonzeros of the chunk at vector c0 from slot base + off.
__device__ __forceinline__ void k4_write(const int4 (&v)[kK4Vecs], const int (&off)[kK4Vecs],
                                         long long base, long long c0, int N, long long cap,
                                         void* ci, int ci_bytes, void* ni, int ni_bytes,
                                         void* vals, int val_bytes) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < kK4Vecs; ++k) {
    long long pos = base + off[k];
    const long long e = 4 * (c0 + (warp * kK4Vecs + k) * 32 + lane);
    const int a[4] = {v[k].x, v[k].y, v[k].z, v[k].w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (a[j] == 0) continue;
      if (pos < cap)
        k4_store(ci, ci_bytes, ni, ni_bytes, vals, val_bytes, pos, (e + j) / N, (e + j) % N,
                 a[j]);
      ++pos;
    }
  }
}

// The block's sum of one int64 a thread. Every thread calls it.
__device__ __forceinline__ long long k4_block_sum(long long v, long long* s_sum) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) s_sum[threadIdx.x >> 5] = v;
  __syncthreads();
  long long t = 0;
#pragma unroll
  for (int w = 0; w < kK4Warps; ++w) t += s_sum[w];
  __syncthreads();
  return t;
}

template <bool LOOP>
__global__ void __launch_bounds__(kK4Threads, kK4MinBlocksPerSM)
compact_nonzero_kernel(const int* __restrict__ x, long long M, int N, long long cap,
                       int chunks_per_block, void* ci, int ci_bytes, void* ni, int ni_bytes,
                       void* vals, int val_bytes, int* __restrict__ counts) {
  __shared__ int s_warp[kK4Warps];
  __shared__ long long s_sum[kK4Warps];
  const long long first = (long long)blockIdx.x * chunks_per_block * kK4Chunk;
  int4 v[kK4Vecs];
  int off[kK4Vecs];
  long long count;
  if (!LOOP) {
    k4_load(v, x, M, first);
    count = k4_number(v, off, s_warp);
  } else {
    long long mine = 0;
    for (int c = 0; c < chunks_per_block; ++c) {
      k4_load(v, x, M, first + (long long)c * kK4Chunk);
#pragma unroll
      for (int k = 0; k < kK4Vecs; ++k) mine += nonzeros(v[k]);
    }
    count = k4_block_sum(mine, s_sum);
  }
  if (threadIdx.x == 0) counts[blockIdx.x] = (int)count;
  // every slot padded: cell (0, 0) and its value
  const int v00 = x[0];
  for (long long p = blockIdx.x * (long long)kK4Threads + threadIdx.x; p < cap;
       p += (long long)gridDim.x * kK4Threads)
    k4_store(ci, ci_bytes, ni, ni_bytes, vals, val_bytes, p, 0, 0, v00);
  cg::this_grid().sync();

  long long before = 0;  // the slots of the blocks before this one
  for (int b = threadIdx.x; b < (int)blockIdx.x; b += kK4Threads) before += __ldcg(counts + b);
  before = k4_block_sum(before, s_sum);
  if (!LOOP) {
    k4_write(v, off, before, first, N, cap, ci, ci_bytes, ni, ni_bytes, vals, val_bytes);
  } else {
    for (int c = 0; c < chunks_per_block && before < cap; ++c) {
      const long long c0 = first + (long long)c * kK4Chunk;
      k4_load(v, x, M, c0);
      const int n = k4_number(v, off, s_warp);
      k4_write(v, off, before, c0, N, cap, ci, ci_bytes, ni, ni_bytes, vals, val_bytes);
      before += n;
    }
  }
}

// Blocks of K4's `looped` form the current device holds at once (cached a
// device).
cudaError_t k4_resident(int looped, int* blocks) {
  static int cache[2][kK4MaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kK4MaxDevices && cache[looped][dev] > 0) {
    *blocks = cache[looped][dev];
    return cudaSuccess;
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, looped ? compact_nonzero_kernel<true> : compact_nonzero_kernel<false>,
        kK4Threads, 0);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorLaunchOutOfResources;
  *blocks = per_sm * sms;
  if (dev < kK4MaxDevices) cache[looped][dev] = *blocks;
  return cudaSuccess;
}

cudaError_t k4_launch_plan(long long M, K4Plan* plan) {
  int reg = 0, loop = 0;
  cudaError_t err = k4_resident(0, &reg);
  if (err == cudaSuccess) err = k4_resident(1, &loop);
  if (err != cudaSuccess) return err;
  *plan = k4_plan(M, reg, loop);
  return cudaSuccess;
}

}  // namespace

extern "C" {

#ifdef SCHED_K1_PROFILE
// [16][6] cycle sums by block of K1 (and K7), as g_k1_profile holds them
int sched_k1_profile(unsigned long long* out, int reset) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_k1_profile, sizeof(g_k1_profile));
  if (err == cudaSuccess && reset) {
    static const unsigned long long zero[sizeof(g_k1_profile) / 8] = {};
    err = cudaMemcpyToSymbol(g_k1_profile, zero, sizeof(zero));
  }
  return (int)err;
}

// [16][9] K6 cycle sums by block, as g_rounds_profile holds them
int sched_rounds_profile(unsigned long long* out, int reset) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_rounds_profile, sizeof(g_rounds_profile));
  if (err == cudaSuccess && reset) {
    static const unsigned long long zero[sizeof(g_rounds_profile) / 8] = {};
    err = cudaMemcpyToSymbol(g_rounds_profile, zero, sizeof(zero));
  }
  return (int)err;
}

#endif

const char* sched_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// K1's cluster size for N nodes of R columns: 16 where one cluster of 16
// blocks fits on the card, else 8 (written to *cluster).
int sched_k1_cluster_size(int N, int R, int* cluster) {
  if (N < 1 || R < 1 || R > kMaxR) return (int)cudaErrorInvalidValue;
  const int sizes[2] = {kK1MaxCluster, kK1MaxCluster / 2};
  for (const int P : sizes) {
    const K1Plan pl = k1_plan(N, R, P);
    bool fits = false;
    const cudaError_t err = pl.rows ? k1_fits<true, kK1Threads>(P, pl, fits)
                                    : k1_fits<false, kK1Threads>(P, pl, fits);
    if (err != cudaSuccess) return (int)err;
    if (fits) {
      *cluster = P;
      return 0;
    }
  }
  return (int)cudaErrorLaunchOutOfResources;
}

// int32 words of global scratch K1 needs over a cluster of P blocks (0 when
// the rows and the per-node state fit in shared memory)
long long sched_k1_scratch_words(int N, int R, int P) { return k1_plan(N, R, P).scratch_words; }

// K1 over one cluster of P blocks (16 or 8, sched_k1_cluster_size);
// `scratch` holds scratch_words int32 words. ref_mode (RefreshMode) is the
// refresh K1 applies to avail before its first sweep: kRefreshRows, idx
// `ref_idx` [ref_pad] and rows `ref_src` [ref_pad, R]; kRefreshDelta, the
// delta `ref_src` [N, R]. A refresh needs a launch: with C or N 0 it is
// refused (the caller applies it with sched_refresh_view).
int sched_schedule_classes(float* avail, const float* total, const uint8_t* alive,
                           const float* demands, const int* counts, int* assigned,
                           int* scratch, long long scratch_words, int N, int R, int C, int P,
                           float thr, float over_denom, int max_passes, int ref_mode,
                           const int* ref_idx, const float* ref_src, int ref_pad,
                           void* stream) {
  if (R > kMaxR || R < 1 || (P != kK1MaxCluster && P != kK1MaxCluster / 2))
    return (int)cudaErrorInvalidValue;
  if (ref_mode != kRefreshNone && ref_mode != kRefreshRows && ref_mode != kRefreshDelta)
    return (int)cudaErrorInvalidValue;
  if (ref_mode != kRefreshNone && (ref_src == nullptr || C == 0 || N == 0))
    return (int)cudaErrorInvalidValue;
  if (ref_mode == kRefreshRows && (ref_idx == nullptr || ref_pad < 0))
    return (int)cudaErrorInvalidValue;
  if (C == 0 || N == 0) return (int)cudaGetLastError();
  const K1Plan pl = k1_plan(N, R, P);
  if (scratch_words < pl.scratch_words) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (pl.rows)
    return (int)launch_k1_refresh<true>(st, P, pl, avail, total, alive, demands, counts,
                                        assigned, scratch, N, R, C, thr, over_denom, max_passes,
                                        ref_mode, ref_idx, ref_src, ref_pad);
  return (int)launch_k1_refresh<false>(st, P, pl, avail, total, alive, demands, counts,
                                       assigned, scratch, N, R, C, thr, over_denom, max_passes,
                                       ref_mode, ref_idx, ref_src, ref_pad);
}

// K7: K1's kernel over one cluster of P blocks (P in 1, 2, 4, 8, 16; N
// divisible by P) of kK7ThreadsRows or kK7ThreadsGlobal threads, by the row
// form; `scratch` holds sched_k1_scratch_words(N, R, P) int32 words.
// cudaErrorLaunchOutOfResources where one cluster of P blocks does not fit
// on the card.
int sched_schedule_classes_sharded(float* avail, const float* total, const uint8_t* alive,
                                   const float* demands, const int* counts, int* assigned,
                                   int* scratch, long long scratch_words, int N, int R, int C,
                                   int P, float thr, float over_denom, int max_passes,
                                   void* stream) {
  if (R > kMaxR || R < 1) return (int)cudaErrorInvalidValue;
  if (P < 1 || P > kK1MaxCluster || (P & (P - 1)) != 0 || N % P != 0)
    return (int)cudaErrorInvalidValue;
  if (C == 0 || N == 0) return (int)cudaGetLastError();
  const K1Plan pl = k1_plan(N, R, P);
  if (scratch_words < pl.scratch_words) return (int)cudaErrorInvalidValue;
  bool fits = false;
  const cudaError_t err = pl.rows ? k1_fits<true, kK7ThreadsRows>(P, pl, fits)
                                  : k1_fits<false, kK7ThreadsGlobal>(P, pl, fits);
  if (err != cudaSuccess) return (int)err;
  if (!fits) return (int)cudaErrorLaunchOutOfResources;
  cudaStream_t st = (cudaStream_t)stream;
  if (pl.rows)
    return (int)launch_k1<true, kK7ThreadsRows>(st, P, pl, avail, total, alive, demands,
                                                counts, assigned, scratch, N, R, C, thr,
                                                over_denom, max_passes);
  return (int)launch_k1<false, kK7ThreadsGlobal>(st, P, pl, avail, total, alive, demands,
                                                 counts, assigned, scratch, N, R, C, thr,
                                                 over_denom, max_passes);
}

// int32 words of K7r's scratch for a rank's block of Nl nodes of R columns
long long sched_k7r_scratch_words(int Nl, int R) { return k7r_scratch_words(Nl, R); }

// K7r: one step of a pass (mode kK7rTerms, kK7rCaps or kK7rFill) on this
// rank's block of Nl nodes, one block of kK7rThreads threads; the arguments
// as k7r_kernel's. `scratch` holds sched_k7r_scratch_words(Nl, R) int32
// words and keeps the block's per-node state from launch to launch of a
// round.
int sched_k7r_pass(int mode, float* avail, const float* total, const uint8_t* alive,
                   const float* d_cur, const float* d_next, int* assigned, int* scratch,
                   long long scratch_words, long long* out, const long long* all_tot, int Nl,
                   int R, int P, int rank, int remaining, int n_feasible, int flag, float thr,
                   float over_denom, void* stream) {
  if (R > kMaxR || R < 1 || Nl < 1 || P < 1 || rank < 0 || rank >= P || remaining < 0)
    return (int)cudaErrorInvalidValue;
  if (scratch_words < k7r_scratch_words(Nl, R)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (mode == kK7rTerms) {
    k7r_kernel<kK7rTerms><<<1, kK7rThreads, 0, st>>>(avail, total, alive, d_cur, d_next,
                                                      assigned, scratch, out, all_tot, Nl, R,
                                                      P, rank, remaining, n_feasible, flag, thr,
                                                      over_denom);
  } else if (mode == kK7rCaps) {
    if (n_feasible < 1) return (int)cudaErrorInvalidValue;
    k7r_kernel<kK7rCaps><<<1, kK7rThreads, 0, st>>>(avail, total, alive, d_cur, d_next,
                                                     assigned, scratch, out, all_tot, Nl, R, P,
                                                     rank, remaining, n_feasible, flag, thr,
                                                     over_denom);
  } else if (mode == kK7rFill) {
    if (all_tot == nullptr) return (int)cudaErrorInvalidValue;
    k7r_kernel<kK7rFill><<<1, kK7rThreads, 0, st>>>(avail, total, alive, d_cur, d_next,
                                                     assigned, scratch, out, all_tot, Nl, R, P,
                                                     rank, remaining, n_feasible, flag, thr,
                                                     over_denom);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// K2 and K3 alone: rows mode (kRefreshRows) writes rows `src` [pad, R] into
// `out` [N, R] in place at idx [pad] (avail unused); delta mode
// (kRefreshDelta) writes clip(avail + delta, 0, total) into out (a tensor
// of its own, or avail itself) from avail, delta `src` and total, each
// [N, R].
int sched_refresh_view(float* out, const float* avail, const float* src, const float* total,
                       const int* idx, int pad, int N, int R, int mode, void* stream) {
  if (N < 0 || R < 1 || pad < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int threads = 256;
  if (mode == kRefreshRows) {
    const long long n = (long long)pad * R;
    if (n == 0 || N == 0) return (int)cudaGetLastError();
    const unsigned blocks = (unsigned)((n + threads - 1) / threads);
    refresh_view_kernel<kRefreshRows><<<blocks, threads, 0, st>>>(out, avail, src, total, idx,
                                                                  pad, N, R);
  } else if (mode == kRefreshDelta) {
    const long long n = (long long)N * R;
    if (n == 0) return (int)cudaGetLastError();
    long long blocks = (n + threads - 1) / threads;
    if (blocks > 132 * 16) blocks = 132 * 16;
    refresh_view_kernel<kRefreshDelta><<<(unsigned)blocks, threads, 0, st>>>(
        out, avail, src, total, idx, pad, N, R);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// K6's cluster size for N nodes of R columns, A of them active, C classes
// in chunks of `chunk`: 16 where one cluster of 16 blocks fits on
// the card, else 8 (written to *cluster).
int sched_rounds_cluster_size(int N, int R, int A, int C, int chunk, int* cluster) {
  if (N < 1 || R < 1 || R > kMaxR || A < 0 || A > R || C < 1 || chunk < 1)
    return (int)cudaErrorInvalidValue;
  const int sizes[2] = {kRMaxCluster, kRMaxCluster / 2};
  for (const int P : sizes) {
    const RoundsPlan pl = rounds_plan(N, A, C, chunk, P);
    bool fits = false;
    const cudaError_t err = A <= kRRegCols
                                ? (pl.rows ? rounds_fits<kRRegCols, true>(P, pl, fits)
                                           : rounds_fits<kRRegCols, false>(P, pl, fits))
                                : (pl.rows ? rounds_fits<0, true>(P, pl, fits)
                                           : rounds_fits<0, false>(P, pl, fits));
    if (err != cudaSuccess) return (int)err;
    if (fits) {
      *cluster = P;
      return 0;
    }
  }
  return (int)cudaErrorLaunchOutOfResources;
}

// int32 words of global scratch K6 needs over a cluster of P blocks
long long sched_rounds_scratch_words(int N, int A, int C, int chunk, int P) {
  return rounds_plan(N, A, C, chunk, P).scratch_words;
}

// K6 (chunk = 16; any chunk >= 1) over one cluster of P blocks (16 or 8,
// sched_rounds_cluster_size); `scratch` holds scratch_words int32 words.
// `mask` has bit r set for each active resource column r (the columns any
// class demands). Every cell of `assigned` [C, N] is written.
int sched_schedule_rounds(float* avail, const float* total, const uint8_t* alive,
                          const float* demands, const int* counts, unsigned long long mask,
                          int* assigned, int* scratch, long long scratch_words, int N, int R,
                          int C, int chunk, int P, float thr, int rounds, void* stream) {
  if (R > kMaxR || R < 1 || chunk < 1 || rounds < 0 || (P != kRMaxCluster && P != kRMaxCluster / 2))
    return (int)cudaErrorInvalidValue;
  if (R < 64 && (mask >> R) != 0ull) return (int)cudaErrorInvalidValue;
  if (C == 0 || N == 0 || rounds == 0) return (int)cudaGetLastError();
  const int A = __builtin_popcountll(mask);
  const RoundsPlan pl = rounds_plan(N, A, C, chunk, P);
  if (scratch_words < pl.scratch_words) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  auto launch = A <= kRRegCols ? (pl.rows ? launch_rounds<kRRegCols, true>
                                           : launch_rounds<kRRegCols, false>)
                                : (pl.rows ? launch_rounds<0, true> : launch_rounds<0, false>);
  return (int)launch(st, P, pl, avail, total, alive, demands, counts, mask, A, assigned, scratch,
                     N, R, C, chunk, thr, rounds);
}

// K5: three kernels a phase (launch_rounds_phases), every class at once.
// Scratch, allocated by the caller: cap [C, N] float32; remaining [C]
// float32, placed and n_feas [C] int32. `mask` has bit r set for each
// active resource column r (the columns any class demands); `assigned`
// must be zeroed.
int sched_schedule_rounds_phases(float* avail, const float* total, const uint8_t* alive,
                                 const float* demands, const int* counts,
                                 unsigned long long mask, int* assigned, float* cap,
                                 float* remaining, int* placed, int* n_feas, int N, int R,
                                 int C, float thr, int rounds, void* stream) {
  if (R > kMaxR || R < 1 || rounds < 0) return (int)cudaErrorInvalidValue;
  if (R < 64 && (mask >> R) != 0ull) return (int)cudaErrorInvalidValue;
  if (C == 0 || N == 0 || rounds == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  const int A = __builtin_popcountll(mask);
  auto launch = A <= 4 ? launch_rounds_phases<4>
                       : (A <= 16 ? launch_rounds_phases<16> : launch_rounds_phases<kMaxR>);
  return (int)launch(st, avail, total, alive, demands, counts, mask, A, assigned, cap,
                     remaining, placed, n_feas, N, R, C, thr, rounds);
}

// K4's launch for M elements on the current device: [blocks, chunks a
// block, looped form] written to plan[0..2].
int sched_k4_plan(long long M, int* plan) {
  if (M <= 0) return (int)cudaErrorInvalidValue;
  K4Plan pl;
  const cudaError_t err = k4_launch_plan(M, &pl);
  if (err != cudaSuccess) return (int)err;
  plan[0] = pl.blocks;
  plan[1] = pl.chunks_per_block;
  plan[2] = pl.looped;
  return 0;
}

// K4 in one cooperative launch (k4_plan); x must be 16-byte aligned.
// counts: n_counts ints (at least the plan's blocks) that no other launch
// uses meanwhile.
int sched_compact_nonzero(const int* x, long long M, int N, long long cap, void* ci,
                          int ci_bytes, void* ni, int ni_bytes, void* vals, int val_bytes,
                          int* counts, int n_counts, void* stream) {
  if (M <= 0 || cap <= 0 || N <= 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if ((ci_bytes != 2 && ci_bytes != 4) || (ni_bytes != 2 && ni_bytes != 4) ||
      (val_bytes != 1 && val_bytes != 4))
    return (int)cudaErrorInvalidValue;
  K4Plan pl;
  cudaError_t err = k4_launch_plan(M, &pl);
  if (err != cudaSuccess) return (int)err;
  if (pl.blocks > n_counts) return (int)cudaErrorInvalidValue;
  void* args[] = {(void*)&x,  (void*)&M,        (void*)&N,    (void*)&cap,
                  (void*)&pl.chunks_per_block,  (void*)&ci,   (void*)&ci_bytes,
                  (void*)&ni, (void*)&ni_bytes, (void*)&vals, (void*)&val_bytes,
                  (void*)&counts};
  const void* kernel = pl.looped ? (const void*)compact_nonzero_kernel<true>
                                 : (const void*)compact_nonzero_kernel<false>;
  err = cudaLaunchCooperativeKernel(kernel, dim3(pl.blocks), dim3(kK4Threads), args, 0,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
