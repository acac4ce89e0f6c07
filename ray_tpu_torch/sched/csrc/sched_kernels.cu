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
//                              _fill_by_bucket, _sat_cumsum)
//   K2 sched_scatter_rows      replaces kernel_jax.py _scatter_rows
//   K3 sched_delta_clip        replaces kernel_jax.py JaxScheduler.apply_delta
//   K4 sched_compact_nonzero   replaces the sparse download of
//                              kernel_jax.py JaxScheduler.schedule_async
//                              (jnp.nonzero(size=cap, fill_value=0) + gather
//                              + narrowing)
//   K5 sched_schedule_rounds   replaces kernel_jax.py schedule_classes_rounds
//      (chunk = C)             (+ _rounds_core, _sat_cumsum)
//   K6 sched_schedule_rounds   replaces kernel_jax.py schedule_classes_chunked
//      (chunk = 16)
//   K7 sched_schedule_classes_sharded
//                              replaces ray_tpu/sched/kernel_shard.py:54-196
//                              (K1 with the node axis split over the blocks
//                              of one thread-block cluster)
// Every entry point launches on the stream it is given, allocates nothing,
// does not synchronise, and returns cudaGetLastError() after its launches.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

// Built with -DSCHED_K1_PROFILE (ray_tpu_torch/scripts/profile_sched.py
// only), K1's thread 0 sums the cycles of each pass phase into
// g_k1_profile: [phase 1, phase 2, phase 3, tail, passes], and thread 0 of
// K7's block 0 into g_k7_profile: [phase 1, exchange 1 (barrier, feasible
// counts), phase 2, exchange 2 (barrier, bucket totals, offsets), phase 3,
// tail, passes]. The production build compiles the stamps away.
#ifdef SCHED_K1_PROFILE
__device__ unsigned long long g_k1_profile[5];
__device__ unsigned long long g_k7_profile[7];
#define K1_STAMP(t) const long long t = clock64()
#define K1_PROFILE_PASS(t0, t1, t2, t3)                              \
  if (threadIdx.x == 0) {                                           \
    g_k1_profile[0] += t1 - t0;                                     \
    g_k1_profile[1] += t2 - t1;                                     \
    g_k1_profile[2] += t3 - t2;                                     \
    g_k1_profile[3] += clock64() - t3;                              \
    g_k1_profile[4] += 1;                                           \
  }
#define K7_PROFILE_PASS(rank, t0, t1, t2, t3, t4, t5)                \
  if (threadIdx.x == 0 && rank == 0) {                              \
    g_k7_profile[0] += t1 - t0;                                     \
    g_k7_profile[1] += t2 - t1;                                     \
    g_k7_profile[2] += t3 - t2;                                     \
    g_k7_profile[3] += t4 - t3;                                     \
    g_k7_profile[4] += t5 - t4;                                     \
    g_k7_profile[5] += clock64() - t5;                              \
    g_k7_profile[6] += 1;                                           \
  }
#else
#define K1_STAMP(t)
#define K1_PROFILE_PASS(t0, t1, t2, t3)
#define K7_PROFILE_PASS(rank, t0, t1, t2, t3, t4, t5)
#endif

namespace {

constexpr int kBuckets = 64;          // SCORE_BUCKETS
constexpr float kEps = 1e-4f;         // EPS
constexpr float kInfFit = 1073741824.0f;  // INF_FIT = 2**30
constexpr int kMaxR = 64;             // resource columns a class row may have
constexpr int kK1Threads = 1024;
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

// Exact 64-bit sum kept as two 32-bit words in shared memory, added with
// native 32-bit atomics and an explicit carry: a 64-bit shared atomicAdd is a
// compare-and-swap loop on this card, and under contention it costs
// quadratically in the number of warps (measured: PERF.md).
__device__ __forceinline__ void shared_add_u64(unsigned* lo, unsigned* hi,
                                               unsigned long long v) {
  const unsigned vlo = (unsigned)v;
  const unsigned old = atomicAdd(lo, vlo);
  const unsigned up = (unsigned)(v >> 32) + (old + vlo < old ? 1u : 0u);
  if (up) atomicAdd(hi, up);
}

__device__ __forceinline__ unsigned long long shared_u64(const unsigned* lo,
                                                         const unsigned* hi) {
  return ((unsigned long long)*hi << 32) | *lo;
}

__device__ __forceinline__ int block_sum_int(int v, int* slot) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
  if ((threadIdx.x & 31) == 0 && v) atomicAdd(slot, v);
  __syncthreads();
  return *slot;
}

// ---------------------------------------------------------------------------
// The per-node steps of one pass, shared by K1 and K7 (each block runs them
// over its own view: the whole [N, R] for K1, one shard's rows for K7).
// ---------------------------------------------------------------------------

// Phase 1 for node n: fit (0 on a dead node), the threshold cap (-1 when the
// node is at or above the threshold: its cap is the equal share) and the
// score bucket.
template <int RU>
__device__ __forceinline__ void node_terms(const float* __restrict__ avail,
                                           const float* __restrict__ total,
                                           const uint8_t* __restrict__ alive,
                                           const float* s_d, int n, int R, float thr,
                                           float over_denom, int& fit_out, int& cap_out,
                                           uint8_t& bkt_out) {
  float fit = kInfFit, kcap = kInfFit, util = __int_as_float(0xff800000);  // -inf
  auto column = [&](int r, float av, float tt) {
    const float d = s_d[r];
    const float used = __fsub_rn(tt, av);
    const float frac = tt > 0.f ? __fdiv_rn(used, fmaxf(tt, kEps)) : 0.f;
    util = fmaxf(util, frac);
    if (d > 0.f) {
      fit = fminf(fit, floorf(__fdiv_rn(__fadd_rn(av, kEps), d)));
      const float head = __fsub_rn(__fmul_rn(thr, tt), used);
      kcap = fminf(kcap, floorf(__fdiv_rn(__fadd_rn(head, kEps), d)));
    }
  };
  if constexpr (RU == 16) {
    const float4* a4 = reinterpret_cast<const float4*>(avail + (size_t)n * 16);
    const float4* t4 = reinterpret_cast<const float4*>(total + (size_t)n * 16);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 av = a4[q], tv = t4[q];
      column(4 * q + 0, av.x, tv.x);
      column(4 * q + 1, av.y, tv.y);
      column(4 * q + 2, av.z, tv.z);
      column(4 * q + 3, av.w, tv.w);
    }
  } else {
    const float* a = avail + (size_t)n * R;
    const float* t = total + (size_t)n * R;
    for (int r = 0; r < R; ++r) column(r, a[r], t[r]);
  }
  fit = fminf(fmaxf(fit, 0.f), kInfFit);
  fit_out = alive[n] ? (int)fit : 0;
  // clip(k, 0, float32(INF_FIT - 1)) + 1; float32(2**30 - 1) == 2**30
  kcap = __fadd_rn(fminf(fmaxf(kcap, 0.f), kInfFit), 1.0f);
  float over = __fdiv_rn(__fsub_rn(util, thr), over_denom);
  over = fminf(fmaxf(over, 0.f), 1.f);
  float b = util >= thr ? __fadd_rn(1.0f, floorf(__fmul_rn(over, (float)(kBuckets - 2)))) : 0.f;
  b = fminf(fmaxf(b, 0.f), (float)(kBuckets - 1));
  cap_out = util < thr ? (int)kcap : -1;
  bkt_out = (uint8_t)b;
}

// Phase 2: the final per-node cap, min(threshold cap or equal share, fit,
// remaining), and the per-bucket totals of the caps. Each thread sums runs
// of one bucket and flushes on a change; the last run is summed over the
// warp when every lane with something to add agrees on it.
__device__ __forceinline__ void bucket_totals(int* __restrict__ cap_s,
                                              const int* __restrict__ fit_s,
                                              const uint8_t* __restrict__ bkt_s, int N,
                                              long long share, int remaining,
                                              unsigned* tot_lo, unsigned* tot_hi) {
  const int tid = threadIdx.x;
  int run_b = -1;
  long long run = 0;
  for (int n = tid; n < N; n += blockDim.x) {
    const int ct = cap_s[n];
    long long cap = ct >= 0 ? (long long)ct : share;
    cap = min(cap, (long long)fit_s[n]);
    cap = min(cap, (long long)remaining);
    cap_s[n] = (int)cap;
    if (cap > 0) {
      const int b = bkt_s[n];
      if (b != run_b) {
        if (run > 0) shared_add_u64(&tot_lo[run_b], &tot_hi[run_b], run);
        run_b = b;
        run = 0;
      }
      run += cap;
    }
  }
  const int lane = tid & 31;
  const unsigned busy = __ballot_sync(kFull, run > 0);
  const int b0 = busy ? __shfl_sync(kFull, run_b, __ffs(busy) - 1) : -1;
  if (__all_sync(kFull, run == 0 || run_b == b0)) {
    long long w = run;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) w += __shfl_down_sync(kFull, w, o);
    if (lane == 0 && w > 0) shared_add_u64(&tot_lo[b0], &tot_hi[b0], w);
  } else if (run > 0) {
    shared_add_u64(&tot_lo[run_b], &tot_hi[run_b], run);
  }
}

// Phase 3: the prefix fill in (bucket, node index) order over this block's
// nodes, each thread owning the contiguous range [lo, hi) so that a block
// scan gives node order. off[b] is the count placed before this block's
// first node of bucket b; only buckets with local caps (tot) and an offset
// below `remaining` can take anything, and off[] never decreases. Adds take
// to assigned_row and debits the node's row: max(avail - take*d, 0).
template <int RU>
__device__ __forceinline__ void fill_by_bucket(float* __restrict__ avail,
                                               int* __restrict__ assigned_row,
                                               const int* __restrict__ cap_s,
                                               const uint8_t* __restrict__ bkt_s, int lo,
                                               int hi, const unsigned* tot_lo,
                                               const unsigned* tot_hi, const long long* off,
                                               int remaining, long long* s_warp,
                                               const float* s_d, int R) {
  for (int b = 0; b < kBuckets; ++b) {
    if (shared_u64(&tot_lo[b], &tot_hi[b]) == 0ull) continue;
    const long long ob = off[b];
    if (ob >= remaining) break;
    long long local = 0;
    for (int n = lo; n < hi; ++n)
      if (bkt_s[n] == b) local += cap_s[n];
    long long prev = ob + block_exclusive_scan(local, s_warp);
    for (int n = lo; n < hi; ++n) {
      if (bkt_s[n] != b) continue;
      const long long cap = cap_s[n];
      long long take = (long long)remaining - prev;
      take = take < 0 ? 0 : (take > cap ? cap : take);
      prev += cap;
      if (take > 0) {
        assigned_row[n] += (int)take;
        const float tf = (float)take;
        auto debit = [&](float a, int r) {
          const float v = __fsub_rn(a, __fmul_rn(tf, s_d[r]));
          return v < 0.f ? 0.f : v;
        };
        if constexpr (RU == 16) {
          float4* a4 = reinterpret_cast<float4*>(avail + (size_t)n * 16);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            float4 v = a4[q];
            v.x = debit(v.x, 4 * q + 0);
            v.y = debit(v.y, 4 * q + 1);
            v.z = debit(v.z, 4 * q + 2);
            v.w = debit(v.w, 4 * q + 3);
            a4[q] = v;
          }
        } else {
          float* a = avail + (size_t)n * R;
          for (int r = 0; r < R; ++r) a[r] = debit(a[r], r);
        }
      }
    }
  }
}

// numpy clamps every node's availability at 0 on the first pass that places
// anything (avail = max(avail - take*d, 0) over all nodes); after that no
// entry can go negative again, so each kernel runs this sweep once
__device__ __forceinline__ void clamp_at_zero(float* __restrict__ a, size_t n) {
  for (size_t i = threadIdx.x; i < n; i += blockDim.x)
    if (a[i] < 0.f) a[i] = 0.f;
}

// bytes of per-node scratch (fit, cap: int32; bucket: uint8), 16-aligned
__host__ __device__ size_t k1_scratch_bytes(int N) { return ((size_t)N * 9 + 15) & ~(size_t)15; }
constexpr size_t kK1MaxDynSmem = 200 * 1024;

// The per-node scratch of one block: in shared memory (SMEM) or at `words`
// in global memory.
template <bool SMEM>
__device__ __forceinline__ void node_scratch(unsigned char* s_dyn, int* words, int N,
                                             int*& fit_s, int*& cap_s, uint8_t*& bkt_s) {
  int* base = SMEM ? reinterpret_cast<int*>(s_dyn) : words;
  fit_s = base;
  cap_s = base + N;
  bkt_s = reinterpret_cast<uint8_t*>(base + 2 * (size_t)N);
}

// ---------------------------------------------------------------------------
// K1: one scheduling round, classes in order, <= max_passes passes each.
//
// Bound on this card: the work is a chain of dependent steps (class c sees
// the availability class c-1 left; pass p sees pass p-1's), so it is bound by
// latency, not by bytes: the whole round must move only ~2*N*R*4 bytes plus
// the [C, N] result. Design: one persistent block of 1024 threads keeps the
// whole round on one SM, so the chain never leaves the chip and never
// returns to the host; the [N, R] view (640 KB at 10k x 16) stays in L2.
// The TPU program's score-ordered fill (one-hot [B, N] saturating scans) is
// a stable counting sort here: per-bucket totals in shared memory, an
// exclusive scan over the 64 buckets, then an exact int64 block scan in node
// order, only over buckets whose offset is below `remaining` (no other
// bucket can take anything). Exact int64 prefixes equal the reference's
// saturating float32 ones wherever the result depends on them, because
// counts stay below 2**23 (pad_problem asserts it).
//
// Per-node scratch (9 bytes: fit int32, cap int32, bucket uint8) lives in
// shared memory when it fits (SMEM, N up to ~24k), else in global memory.
// Costs the design avoids, each measured on an earlier version (PERF.md):
//  - 64-bit shared atomics on one bucket total from every node: totals are
//    summed per thread, flushed once per warp where the warp agrees, and
//    added as two native 32-bit words (shared_add_u64);
//  - one 32-byte L2 request per column of a node row (lanes read rows 64 B
//    apart): with R == 16 (RU = 16) a row is four float4 loads;
//  - reading back from global memory the scratch the pass just wrote.
// ---------------------------------------------------------------------------
template <int RU, bool SMEM>
__global__ void __launch_bounds__(kK1Threads)
schedule_classes_kernel(float* __restrict__ avail, const float* __restrict__ total,
                        const uint8_t* __restrict__ alive,
                        const float* __restrict__ demands,
                        const int* __restrict__ counts, int* __restrict__ assigned,
                        int* __restrict__ scratch, int N, int R, int C, float thr,
                        float over_denom, int max_passes) {
  __shared__ float s_d[kMaxR];
  __shared__ unsigned s_tot_lo[kBuckets], s_tot_hi[kBuckets];
  __shared__ long long s_off[kBuckets];
  __shared__ long long s_warp[32];
  __shared__ long long s_total;
  __shared__ int s_nfeas;
  extern __shared__ __align__(16) unsigned char s_dyn[];

  int *fit_s, *cap_s;
  uint8_t* bkt_s;
  node_scratch<SMEM>(s_dyn, scratch, N, fit_s, cap_s, bkt_s);
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int per = (N + nt - 1) / nt;
  const int lo = min(tid * per, N);
  const int hi = min(lo + per, N);
  bool clamped = false;

  for (int c = 0; c < C; ++c) {
    __syncthreads();
    if (tid < R) s_d[tid] = demands[(size_t)c * R + tid];
    __syncthreads();
    int remaining = counts[c];
    for (int p = 0; p < max_passes && remaining > 0; ++p) {
      if (tid == 0) s_nfeas = 0;
      if (tid < kBuckets) s_tot_lo[tid] = s_tot_hi[tid] = 0u;
      __syncthreads();
      K1_STAMP(t0);
      // phase 1: per-node fit, score bucket, threshold cap
      int my_feas = 0;
      for (int n = tid; n < N; n += nt) {
        int fit_i, cap_t;
        uint8_t b;
        node_terms<RU>(avail, total, alive, s_d, n, R, thr, over_denom, fit_i, cap_t, b);
        fit_s[n] = fit_i;
        cap_s[n] = cap_t;
        bkt_s[n] = b;
        my_feas += fit_i > 0;
      }
      const int n_feasible = block_sum_int(my_feas, &s_nfeas);
      K1_STAMP(t1);
      if (n_feasible == 0) break;  // uniform: stalled
      const long long share = ((long long)remaining + n_feasible - 1) / n_feasible;
      // phase 2: final per-node cap and per-bucket totals
      bucket_totals(cap_s, fit_s, bkt_s, N, share, remaining, s_tot_lo, s_tot_hi);
      __syncthreads();
      if (tid == 0) {
        long long acc = 0;
        for (int b = 0; b < kBuckets; ++b) {
          s_off[b] = acc;
          acc += (long long)shared_u64(&s_tot_lo[b], &s_tot_hi[b]);
        }
        s_total = acc;
      }
      __syncthreads();
      const int got = (int)min((long long)remaining, s_total);
      K1_STAMP(t2);
      if (got == 0) break;  // uniform: stalled
      // phase 3: prefix fill in (bucket, node index) order
      fill_by_bucket<RU>(avail, assigned + (size_t)c * N, cap_s, bkt_s, lo, hi, s_tot_lo,
                         s_tot_hi, s_off, remaining, s_warp, s_d, R);
      K1_STAMP(t3);
      remaining -= got;
      if (!clamped) {
        __syncthreads();
        clamp_at_zero(avail, (size_t)N * R);
        clamped = true;
      }
      __syncthreads();
      K1_PROFILE_PASS(t0, t1, t2, t3)
    }
  }
}

template <int RU>
cudaError_t launch_k1(cudaStream_t st, float* avail, const float* total, const uint8_t* alive,
                      const float* demands, const int* counts, int* assigned, int* scratch,
                      int N, int R, int C, float thr, float over_denom, int max_passes) {
  const size_t smem = k1_scratch_bytes(N);
  if (smem <= kK1MaxDynSmem) {
    cudaError_t err = cudaFuncSetAttribute(schedule_classes_kernel<RU, true>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
    schedule_classes_kernel<RU, true><<<1, kK1Threads, smem, st>>>(
        avail, total, alive, demands, counts, assigned, scratch, N, R, C, thr, over_denom,
        max_passes);
  } else {
    schedule_classes_kernel<RU, false><<<1, kK1Threads, 0, st>>>(
        avail, total, alive, demands, counts, assigned, scratch, N, R, C, thr, over_denom,
        max_passes);
  }
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K7: K1 with the node axis split over P shards (P in 1, 2, 4, 8), replacing
// ray_tpu/sched/kernel_shard.py:54-196 (_fill_by_bucket_sharded,
// _one_class_sharded, _sharded_body under shard_map). One launch of one
// thread-block cluster of P blocks runs the whole round: block r plays
// device r of the JAX mesh and owns nodes [r*N/P, (r+1)*N/P), on which it
// runs K1's per-node steps. The values that cross shards go through
// distributed shared memory (DSMEM) under cluster barriers:
//  - the feasible count (JAX's psum, :105): lane q of each block's first
//    warp reads block q's count, and the warp sums them;
//  - the per-bucket totals (JAX's all_gather, :75, and the recomposition,
//    :76-91): the first warp reads the peers' 64 totals (exact int64, as
//    two 32-bit words), two buckets a lane, and forms the shard prefix
//    (the totals of the ranks before this one) and the global bucket
//    totals, whose exclusive scan over the lanes gives the bucket
//    offsets; the offset for bucket b is global offset + shard prefix,
//    and the within-shard prefix is K1's block scan;
//  - the placed total (JAX's psum, :117) is min(remaining, sum of the
//    global totals), which every block forms from the same exchanged
//    totals: no third exchange.
// Every block reaches the same n_feasible, got and remaining, so all take
// the same branches and arrive at every cluster barrier. The exchanged
// count and totals are double-buffered by the parity of the pass (counted
// over every class): a block zeroes pass k+2's buffer only after the next
// pass's first barrier, which every peer reaches after reading pass k's. A
// last barrier keeps every block resident until its peers are done.
// Decisions and availability equal K1's and kernel_np's exactly (exact
// int64 prefixes, counts < 2**23).
//
// Bound on this card: the same latency-bound chain as K1; the bytes bound is
// ~2*N*R*4 plus the [C, N] result, and each pass adds two cluster barriers.
// Design: a simple, correct kernel first; each block keeps its per-node
// scratch in shared memory and reads its rows of the view from L2 every
// pass. Keeping each block's rows of avail and total resident in shared
// memory (1 250 rows at P = 8 and 10k nodes, ~160 KB) is later work.
// ---------------------------------------------------------------------------
constexpr int kMaxShards = 8;

template <int RU, bool SMEM>
__global__ void __launch_bounds__(kK1Threads)
schedule_classes_sharded_kernel(float* __restrict__ avail, const float* __restrict__ total,
                                const uint8_t* __restrict__ alive,
                                const float* __restrict__ demands,
                                const int* __restrict__ counts, int* __restrict__ assigned,
                                int* __restrict__ scratch, int N, int R, int C, float thr,
                                float over_denom, int max_passes) {
  cg::cluster_group cluster = cg::this_cluster();
  const int P = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int Nl = N / P;
  const size_t first = (size_t)rank * Nl;
  __shared__ float s_d[kMaxR];
  __shared__ unsigned s_tot_lo[2][kBuckets], s_tot_hi[2][kBuckets];
  __shared__ int s_nfeas[2];
  __shared__ int s_nfeas_all;
  __shared__ long long s_off[kBuckets];
  __shared__ long long s_warp[32];
  __shared__ long long s_total;
  extern __shared__ __align__(16) unsigned char s_dyn[];

  int *fit_s, *cap_s;
  uint8_t* bkt_s;
  node_scratch<SMEM>(s_dyn, scratch + rank * (k1_scratch_bytes(Nl) / 4), Nl, fit_s, cap_s,
                     bkt_s);
  float* av = avail + first * R;
  const float* tt = total + first * R;
  const uint8_t* al = alive + first;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int per = (Nl + nt - 1) / nt;
  const int lo = min(tid * per, Nl);
  const int hi = min(lo + per, Nl);
  bool clamped = false;
  unsigned pass = 0;  // passes begun over every class: the exchange buffer's parity

  for (int c = 0; c < C; ++c) {
    __syncthreads();
    if (tid < R) s_d[tid] = demands[(size_t)c * R + tid];
    __syncthreads();
    int remaining = counts[c];
    for (int p = 0; p < max_passes && remaining > 0; ++p) {
      const int buf = pass++ & 1;
      if (tid == 0) s_nfeas[buf] = 0;
      if (tid < kBuckets) s_tot_lo[buf][tid] = s_tot_hi[buf][tid] = 0u;
      __syncthreads();
      K1_STAMP(t0);
      int my_feas = 0;
      for (int n = tid; n < Nl; n += nt) {
        int fit_i, cap_t;
        uint8_t b;
        node_terms<RU>(av, tt, al, s_d, n, R, thr, over_denom, fit_i, cap_t, b);
        fit_s[n] = fit_i;
        cap_s[n] = cap_t;
        bkt_s[n] = b;
        my_feas += fit_i > 0;
      }
      block_sum_int(my_feas, &s_nfeas[buf]);
      K1_STAMP(t1);
      cluster.sync();  // every shard's feasible count is in place
      if (tid < 32) {  // lane q reads block q's count
        const int v = tid < P ? *cluster.map_shared_rank(&s_nfeas[buf], tid) : 0;
        const int sum = __reduce_add_sync(kFull, v);
        if (tid == 0) s_nfeas_all = sum;
      }
      __syncthreads();
      const int n_feasible = s_nfeas_all;
      K1_STAMP(t2);
      if (n_feasible == 0) break;  // uniform over the cluster: stalled
      const long long share = ((long long)remaining + n_feasible - 1) / n_feasible;
      bucket_totals(cap_s, fit_s, bkt_s, Nl, share, remaining, s_tot_lo[buf], s_tot_hi[buf]);
      K1_STAMP(t3);
      cluster.sync();  // every shard's bucket totals are in place
      if (tid < 32) {
        // lane l owns buckets 2l and 2l + 1: their totals over every block
        // and over the blocks before this one, read from the peers' shared
        // memory; then an exclusive scan over the lanes gives the offsets
        long long all0 = 0, all1 = 0, before0 = 0, before1 = 0;
#pragma unroll
        for (int q = 0; q < kMaxShards; ++q) {
          if (q < P) {
            const unsigned* lo = cluster.map_shared_rank(&s_tot_lo[buf][2 * tid], q);
            const unsigned* hi = cluster.map_shared_rank(&s_tot_hi[buf][2 * tid], q);
            const long long v0 = (long long)shared_u64(lo, hi);
            const long long v1 = (long long)shared_u64(lo + 1, hi + 1);
            all0 += v0;
            all1 += v1;
            before0 += q < rank ? v0 : 0;
            before1 += q < rank ? v1 : 0;
          }
        }
        const long long pair = all0 + all1;
        long long incl = pair;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const long long y = __shfl_up_sync(kFull, incl, o);
          if (tid >= o) incl += y;
        }
        s_off[2 * tid] = incl - pair + before0;
        s_off[2 * tid + 1] = incl - pair + all0 + before1;
        if (tid == 31) s_total = incl;
      }
      __syncthreads();
      const int got = (int)min((long long)remaining, s_total);
      K1_STAMP(t4);
      if (got == 0) break;  // uniform over the cluster: stalled
      fill_by_bucket<RU>(av, assigned + (size_t)c * N + first, cap_s, bkt_s, lo, hi,
                         s_tot_lo[buf], s_tot_hi[buf], s_off, remaining, s_warp, s_d, R);
      K1_STAMP(t5);
      remaining -= got;
      if (!clamped) {
        __syncthreads();
        clamp_at_zero(av, (size_t)Nl * R);
        clamped = true;
      }
      __syncthreads();
      K7_PROFILE_PASS(rank, t0, t1, t2, t3, t4, t5)
    }
  }
  cluster.sync();  // no block exits while a peer may still read its shared memory
}

template <int RU, bool SMEM>
cudaError_t launch_k7(cudaStream_t st, int P, float* avail, const float* total,
                      const uint8_t* alive, const float* demands, const int* counts,
                      int* assigned, int* scratch, int N, int R, int C, float thr,
                      float over_denom, int max_passes) {
  void (*kernel)(float*, const float*, const uint8_t*, const float*, const int*, int*, int*,
                 int, int, int, float, float, int) =
      schedule_classes_sharded_kernel<RU, SMEM>;
  const size_t smem = SMEM ? k1_scratch_bytes(N / P) : 0;
  cudaError_t err;
  if (SMEM) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = (unsigned)P;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)P, 1, 1);
  cfg.blockDim = dim3(kK1Threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, (const void*)kernel, &cfg);
  if (err != cudaSuccess) return err;
  if (clusters < 1) return cudaErrorLaunchOutOfResources;
  err = cudaLaunchKernelEx(&cfg, kernel, avail, total, alive, demands, counts, assigned,
                           scratch, N, R, C, thr, over_denom, max_passes);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K5/K6: the two-phase [C, N] rounds core (kernel_np.schedule_classes_rounds
// semantics, op for op). Per global round, phase A (fill nodes under the
// spread threshold up to it) then phase B (equal-share the rest over the
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
// K6 runs the same launches chunk after chunk on [16, N] slices, the
// availability carried from one chunk to the next on the device.
//
// Bound on this card: bytes. Every phase writes and reads the [C, N] f32
// cap/want matrix twice (10 MB at 256 x 10k) and the trim reads it once
// more, against a few hundred operations per cell; the round itself must
// move only the [N, R] views and the [C, N] int32 result once. Design: the
// per-node kernels keep the node's active columns in registers and read
// the [C, N] scratch coalesced across a warp (row-major, one node per
// lane); the per-class prefix is an exact int64 block scan, tile by tile.
// Fusing the three launches (and the phases) is the next step (PERF.md).
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
constexpr int kNodeThreads = 128;     // per-node kernels of K5/K6
constexpr int kCapClassTile = 16;     // classes per block of the cap kernel
constexpr int kPrefixThreads = 1024;
constexpr float kSat = 8388608.0f;    // SAT = 2**23
constexpr float kMinDemand = 1e-9f;   // np.float32(1e-9)

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
cudaError_t launch_rounds(cudaStream_t st, float* avail, const float* total,
                          const uint8_t* alive, const float* demands, const int* counts,
                          unsigned long long mask, int A, int* assigned, float* cap,
                          float* remaining, int* placed, int* n_feas, int N, int R, int C,
                          int chunk, float thr, int rounds) {
  const unsigned node_blocks = (unsigned)((N + kNodeThreads - 1) / kNodeThreads);
  for (int s = 0; s < C; s += chunk) {
    const int Cc = min(chunk, C - s);
    const float* d = demands + (size_t)s * R;
    int* asg = assigned + (size_t)s * N;
    float* rem = remaining + s;
    int* plc = placed + s;
    int* nf = n_feas + s;
    const dim3 cap_grid(node_blocks, (unsigned)((Cc + kCapClassTile - 1) / kCapClassTile));
    for (int r = 0; r < rounds; ++r) {
      rounds_caps_kernel<AMAX, true><<<cap_grid, kNodeThreads, 0, st>>>(
          avail, total, alive, d, mask, A, N, R, Cc, thr, cap, nf);
      rounds_prefix_kernel<false><<<Cc, kPrefixThreads, 0, st>>>(cap, counts + s, rem, plc, nf,
                                                                 N, r == 0);
      rounds_trim_kernel<AMAX><<<node_blocks, kNodeThreads, 0, st>>>(avail, cap, d, mask, A, N,
                                                                     R, Cc, asg, plc);
      rounds_caps_kernel<AMAX, false><<<cap_grid, kNodeThreads, 0, st>>>(
          avail, total, alive, d, mask, A, N, R, Cc, thr, cap, nf);
      rounds_prefix_kernel<true><<<Cc, kPrefixThreads, 0, st>>>(cap, counts + s, rem, plc, nf,
                                                                N, 0);
      rounds_trim_kernel<AMAX><<<node_blocks, kNodeThreads, 0, st>>>(avail, cap, d, mask, A, N,
                                                                     R, Cc, asg, plc);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return err;
    }
  }
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K2: avail[idx[i], :] = rows[i, :]; indices outside [0, N) (the padding
// value N) are dropped. Bound: bytes (pad*(4 + 8R)); one thread per element,
// neighbouring threads on neighbouring columns of one row.
// ---------------------------------------------------------------------------
__global__ void scatter_rows_kernel(float* __restrict__ avail, const int* __restrict__ idx,
                                    const float* __restrict__ rows, int pad, int N, int R) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= (long long)pad * R) return;
  const int row = (int)(i / R), col = (int)(i % R);
  const int n = idx[row];
  if (n < 0 || n >= N) return;
  avail[(size_t)n * R + col] = rows[i];
}

// ---------------------------------------------------------------------------
// K3: out = clip(avail + delta, 0, total). Bound: bytes (16 per element);
// a grid-stride elementwise pass.
// ---------------------------------------------------------------------------
__global__ void delta_clip_kernel(float* __restrict__ out, const float* __restrict__ avail,
                                  const float* __restrict__ delta,
                                  const float* __restrict__ total, long long n) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float v = __fadd_rn(avail[i], delta[i]);
    v = v < 0.f ? 0.f : v;
    const float t = total[i];
    out[i] = v > t ? t : v;
  }
}

// ---------------------------------------------------------------------------
// K4: COO compaction of the [C, N] assignment in row-major order, equal slot
// for slot to jnp.nonzero(out, size=cap, fill_value=0) plus the value gather:
// slots past the last nonzero hold cell (0, 0) and the value out[0, 0].
// Bound: bytes (read C*N*4, write cap * (index + value widths)). Three
// launches: per-tile nonzero counts, one-block scan of the tile counts, then
// an ordered write (block scan inside each tile). No atomics, so the order
// is deterministic and fetch's assign-not-add reconstruction stays exact.
// ---------------------------------------------------------------------------
constexpr int kK4Threads = 1024;
constexpr int kK4PerThread = 4;
constexpr int kK4Tile = kK4Threads * kK4PerThread;

__global__ void __launch_bounds__(kK4Threads)
nonzero_count_kernel(const int* __restrict__ x, long long M, int* __restrict__ tile_counts) {
  __shared__ int s_cnt;
  if (threadIdx.x == 0) s_cnt = 0;
  __syncthreads();
  const long long base = (long long)blockIdx.x * kK4Tile + (long long)threadIdx.x * kK4PerThread;
  int cnt = 0;
#pragma unroll
  for (int k = 0; k < kK4PerThread; ++k)
    if (base + k < M && x[base + k] != 0) ++cnt;
  const int tot = block_sum_int(cnt, &s_cnt);
  if (threadIdx.x == 0) tile_counts[blockIdx.x] = tot;
}

// tile_offsets[i] = exclusive prefix of tile_counts; tile_offsets[n] = total
__global__ void __launch_bounds__(kK4Threads)
tile_scan_kernel(const int* __restrict__ tile_counts, long long* __restrict__ tile_offsets,
                 int n_tiles) {
  __shared__ long long s_warp[32];
  __shared__ long long s_chunk;
  long long carry = 0;
  for (int start = 0; start < n_tiles; start += blockDim.x) {
    const int i = start + threadIdx.x;
    const long long v = i < n_tiles ? tile_counts[i] : 0;
    const long long ex = block_exclusive_scan(v, s_warp);
    if (i < n_tiles) tile_offsets[i] = carry + ex;
    // last thread's inclusive value is the chunk total
    if (threadIdx.x == blockDim.x - 1) s_chunk = ex + v;
    __syncthreads();
    carry += s_chunk;
    __syncthreads();
  }
  if (threadIdx.x == 0) tile_offsets[n_tiles] = carry;
}

template <typename IC, typename IN, typename V>
__global__ void __launch_bounds__(kK4Threads)
nonzero_write_kernel(const int* __restrict__ x, long long M, int N, long long cap,
                     const long long* __restrict__ tile_offsets, int n_tiles,
                     IC* __restrict__ ci, IN* __restrict__ ni, V* __restrict__ vals) {
  __shared__ long long s_warp[32];
  const long long base = (long long)blockIdx.x * kK4Tile + (long long)threadIdx.x * kK4PerThread;
  int v[kK4PerThread];
  int cnt = 0;
#pragma unroll
  for (int k = 0; k < kK4PerThread; ++k) {
    v[k] = base + k < M ? x[base + k] : 0;
    cnt += v[k] != 0;
  }
  long long pos = tile_offsets[blockIdx.x] + block_exclusive_scan(cnt, s_warp);
#pragma unroll
  for (int k = 0; k < kK4PerThread; ++k) {
    if (v[k] == 0) continue;
    if (pos < cap) {
      const long long e = base + k;
      ci[pos] = (IC)(e / N);
      ni[pos] = (IN)(e % N);
      vals[pos] = (V)v[k];
    }
    ++pos;
  }
  // padding slots: cell (0, 0) and its value
  const long long nnz = tile_offsets[n_tiles];
  const V v00 = (V)x[0];
  for (long long p = nnz + blockIdx.x * (long long)blockDim.x + threadIdx.x; p < cap;
       p += (long long)gridDim.x * blockDim.x) {
    ci[p] = (IC)0;
    ni[p] = (IN)0;
    vals[p] = v00;
  }
}

template <typename IC, typename IN>
void launch_write(int val_bytes, dim3 grid, cudaStream_t st, const int* x, long long M, int N,
                  long long cap, const long long* offs, int n_tiles, void* ci, void* ni,
                  void* vals) {
  if (val_bytes == 1)
    nonzero_write_kernel<IC, IN, uint8_t><<<grid, kK4Threads, 0, st>>>(
        x, M, N, cap, offs, n_tiles, (IC*)ci, (IN*)ni, (uint8_t*)vals);
  else
    nonzero_write_kernel<IC, IN, int32_t><<<grid, kK4Threads, 0, st>>>(
        x, M, N, cap, offs, n_tiles, (IC*)ci, (IN*)ni, (int32_t*)vals);
}

}  // namespace

extern "C" {

#ifdef SCHED_K1_PROFILE
int sched_k1_profile(unsigned long long* out, int reset) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_k1_profile, sizeof(g_k1_profile));
  if (err == cudaSuccess && reset) {
    const unsigned long long zero[5] = {0, 0, 0, 0, 0};
    err = cudaMemcpyToSymbol(g_k1_profile, zero, sizeof(zero));
  }
  return (int)err;
}

int sched_k7_profile(unsigned long long* out, int reset) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_k7_profile, sizeof(g_k7_profile));
  if (err == cudaSuccess && reset) {
    const unsigned long long zero[7] = {0, 0, 0, 0, 0, 0, 0};
    err = cudaMemcpyToSymbol(g_k7_profile, zero, sizeof(zero));
  }
  return (int)err;
}
#endif

const char* sched_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

int sched_schedule_classes(float* avail, const float* total, const uint8_t* alive,
                           const float* demands, const int* counts, int* assigned,
                           int* scratch, int N, int R, int C, float thr, float over_denom,
                           int max_passes, void* stream) {
  if (R > kMaxR || R < 1) return (int)cudaErrorInvalidValue;
  if (C == 0 || N == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  const bool rows16 = R == 16 && (((uintptr_t)avail | (uintptr_t)total) & 15) == 0;
  if (rows16)
    return (int)launch_k1<16>(st, avail, total, alive, demands, counts, assigned, scratch, N,
                              R, C, thr, over_denom, max_passes);
  return (int)launch_k1<0>(st, avail, total, alive, demands, counts, assigned, scratch, N, R,
                           C, thr, over_denom, max_passes);
}

// int32 words of global scratch the K1 wrapper allocates (used only when the
// per-node scratch does not fit in shared memory)
long long sched_k1_scratch_words(int N) { return (long long)(k1_scratch_bytes(N) / 4); }

// K7 over a cluster of P blocks (P in 1, 2, 4, 8; N divisible by P).
int sched_schedule_classes_sharded(float* avail, const float* total, const uint8_t* alive,
                                   const float* demands, const int* counts, int* assigned,
                                   int* scratch, int N, int R, int C, int P, float thr,
                                   float over_denom, int max_passes, void* stream) {
  if (R > kMaxR || R < 1) return (int)cudaErrorInvalidValue;
  if (P < 1 || P > kMaxShards || (P & (P - 1)) != 0 || N % P != 0)
    return (int)cudaErrorInvalidValue;
  if (C == 0 || N == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  const bool rows16 = R == 16 && (((uintptr_t)avail | (uintptr_t)total) & 15) == 0;
  const bool smem = k1_scratch_bytes(N / P) <= kK1MaxDynSmem;
  if (rows16 && smem)
    return (int)launch_k7<16, true>(st, P, avail, total, alive, demands, counts, assigned,
                                    scratch, N, R, C, thr, over_denom, max_passes);
  if (rows16)
    return (int)launch_k7<16, false>(st, P, avail, total, alive, demands, counts, assigned,
                                     scratch, N, R, C, thr, over_denom, max_passes);
  if (smem)
    return (int)launch_k7<0, true>(st, P, avail, total, alive, demands, counts, assigned,
                                   scratch, N, R, C, thr, over_denom, max_passes);
  return (int)launch_k7<0, false>(st, P, avail, total, alive, demands, counts, assigned,
                                  scratch, N, R, C, thr, over_denom, max_passes);
}

// int32 words of global scratch the K7 wrapper allocates: K1's per shard
long long sched_k7_scratch_words(int N, int P) {
  return (long long)P * (long long)(k1_scratch_bytes(N / P) / 4);
}

int sched_scatter_rows(float* avail, const int* idx, const float* rows, int pad, int N, int R,
                       void* stream) {
  const long long n = (long long)pad * R;
  if (n == 0) return (int)cudaGetLastError();
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  scatter_rows_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(avail, idx, rows, pad, N, R);
  return (int)cudaGetLastError();
}

int sched_delta_clip(float* out, const float* avail, const float* delta, const float* total,
                     long long n, void* stream) {
  if (n == 0) return (int)cudaGetLastError();
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  delta_clip_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(out, avail, delta,
                                                                            total, n);
  return (int)cudaGetLastError();
}

// K5 (chunk >= C) and K6 (chunk = 16). Scratch, allocated by the caller:
// cap [min(chunk, C), N] float32; remaining [C] float32, placed and n_feas
// [C] int32. `mask` has bit r set for each active resource column r (the
// columns any class demands); `assigned` must be zeroed.
int sched_schedule_rounds(float* avail, const float* total, const uint8_t* alive,
                          const float* demands, const int* counts, unsigned long long mask,
                          int* assigned, float* cap, float* remaining, int* placed,
                          int* n_feas, int N, int R, int C, int chunk, float thr, int rounds,
                          void* stream) {
  if (R > kMaxR || R < 1 || chunk < 1 || rounds < 0) return (int)cudaErrorInvalidValue;
  if (R < 64 && (mask >> R) != 0ull) return (int)cudaErrorInvalidValue;
  if (C == 0 || N == 0 || rounds == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  const int A = __builtin_popcountll(mask);
  if (A <= 4)
    return (int)launch_rounds<4>(st, avail, total, alive, demands, counts, mask, A, assigned,
                                 cap, remaining, placed, n_feas, N, R, C, chunk, thr, rounds);
  if (A <= 16)
    return (int)launch_rounds<16>(st, avail, total, alive, demands, counts, mask, A, assigned,
                                  cap, remaining, placed, n_feas, N, R, C, chunk, thr, rounds);
  return (int)launch_rounds<kMaxR>(st, avail, total, alive, demands, counts, mask, A, assigned,
                                   cap, remaining, placed, n_feas, N, R, C, chunk, thr, rounds);
}

// tile_counts: n_tiles int32, tile_offsets: n_tiles + 1 int64, where
// n_tiles = sched_nonzero_tiles(M).
int sched_nonzero_tiles(long long M) { return (int)((M + kK4Tile - 1) / kK4Tile); }

int sched_compact_nonzero(const int* x, long long M, int N, long long cap, void* ci,
                          int ci_bytes, void* ni, int ni_bytes, void* vals, int val_bytes,
                          int* tile_counts, long long* tile_offsets, void* stream) {
  if (M <= 0 || cap <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  if ((ci_bytes != 2 && ci_bytes != 4) || (ni_bytes != 2 && ni_bytes != 4) ||
      (val_bytes != 1 && val_bytes != 4))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int n_tiles = sched_nonzero_tiles(M);
  nonzero_count_kernel<<<n_tiles, kK4Threads, 0, st>>>(x, M, tile_counts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  tile_scan_kernel<<<1, kK4Threads, 0, st>>>(tile_counts, tile_offsets, n_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 grid(n_tiles);
  if (ci_bytes == 2 && ni_bytes == 2)
    launch_write<int16_t, int16_t>(val_bytes, grid, st, x, M, N, cap, tile_offsets, n_tiles,
                                   ci, ni, vals);
  else if (ci_bytes == 2)
    launch_write<int16_t, int32_t>(val_bytes, grid, st, x, M, N, cap, tile_offsets, n_tiles,
                                   ci, ni, vals);
  else if (ni_bytes == 2)
    launch_write<int32_t, int16_t>(val_bytes, grid, st, x, M, N, cap, tile_offsets, n_tiles,
                                   ci, ni, vals);
  else
    launch_write<int32_t, int32_t>(val_bytes, grid, st, x, M, N, cap, tile_offsets, n_tiles,
                                   ci, ni, vals);
  return (int)cudaGetLastError();
}

}  // extern "C"
