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
// Every entry point launches on the stream it is given, allocates nothing,
// does not synchronise, and returns cudaGetLastError() after its launches.

#include <cstdint>
#include <cuda_runtime.h>

// Built with -DSCHED_K1_PROFILE (ray_tpu_torch/scripts/k1_phase_profile.py
// only), K1's thread 0 sums the cycles of each pass phase into
// g_k1_profile: [phase 1, phase 2, phase 3, tail, passes]. The production
// build compiles the stamps away.
#ifdef SCHED_K1_PROFILE
__device__ unsigned long long g_k1_profile[5];
#define K1_STAMP(t) const long long t = clock64()
#define K1_PROFILE_PASS(t0, t1, t2, t3)                              \
  if (threadIdx.x == 0) {                                           \
    g_k1_profile[0] += t1 - t0;                                     \
    g_k1_profile[1] += t2 - t1;                                     \
    g_k1_profile[2] += t3 - t2;                                     \
    g_k1_profile[3] += clock64() - t3;                              \
    g_k1_profile[4] += 1;                                           \
  }
#else
#define K1_STAMP(t)
#define K1_PROFILE_PASS(t0, t1, t2, t3)
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

  int* fit_s;
  int* cap_s;
  uint8_t* bkt_s;
  if constexpr (SMEM) {
    fit_s = reinterpret_cast<int*>(s_dyn);
    cap_s = fit_s + N;
    bkt_s = reinterpret_cast<uint8_t*>(cap_s + N);
  } else {
    fit_s = scratch;
    cap_s = scratch + N;
    bkt_s = reinterpret_cast<uint8_t*>(scratch + 2 * (size_t)N);
  }
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int per = (N + nt - 1) / nt;
  const int lo = min(tid * per, N);
  const int hi = min(lo + per, N);
  // numpy clamps every node's availability at 0 on the first pass that
  // places anything (avail = max(avail - take*d, 0) over all nodes); after
  // that no entry can go negative again, so the full sweep runs once
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
        const int fit_i = alive[n] ? (int)fit : 0;
        // clip(k, 0, float32(INF_FIT - 1)) + 1; float32(2**30 - 1) == 2**30
        kcap = __fadd_rn(fminf(fmaxf(kcap, 0.f), kInfFit), 1.0f);
        float over = __fdiv_rn(__fsub_rn(util, thr), over_denom);
        over = fminf(fmaxf(over, 0.f), 1.f);
        float b = util >= thr
                      ? __fadd_rn(1.0f, floorf(__fmul_rn(over, (float)(kBuckets - 2))))
                      : 0.f;
        b = fminf(fmaxf(b, 0.f), (float)(kBuckets - 1));
        fit_s[n] = fit_i;
        cap_s[n] = util < thr ? (int)kcap : -1;
        bkt_s[n] = (uint8_t)b;
        my_feas += fit_i > 0;
      }
      const int n_feasible = block_sum_int(my_feas, &s_nfeas);
      K1_STAMP(t1);
      if (n_feasible == 0) break;  // uniform: stalled
      const long long share = ((long long)remaining + n_feasible - 1) / n_feasible;
      // phase 2: final per-node cap and per-bucket totals. Each thread sums
      // runs of one bucket and flushes on a change; the last run is summed
      // over the warp when every lane with something to add agrees on it.
      int run_b = -1;
      long long run = 0;
      for (int n = tid; n < N; n += nt) {
        const int ct = cap_s[n];
        long long cap = ct >= 0 ? (long long)ct : share;
        cap = min(cap, (long long)fit_s[n]);
        cap = min(cap, (long long)remaining);
        cap_s[n] = (int)cap;
        if (cap > 0) {
          const int b = bkt_s[n];
          if (b != run_b) {
            if (run > 0) shared_add_u64(&s_tot_lo[run_b], &s_tot_hi[run_b], run);
            run_b = b;
            run = 0;
          }
          run += cap;
        }
      }
      {
        const int lane = tid & 31;
        const unsigned busy = __ballot_sync(kFull, run > 0);
        const int b0 = busy ? __shfl_sync(kFull, run_b, __ffs(busy) - 1) : -1;
        if (__all_sync(kFull, run == 0 || run_b == b0)) {
          long long w = run;
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) w += __shfl_down_sync(kFull, w, o);
          if (lane == 0 && w > 0) shared_add_u64(&s_tot_lo[b0], &s_tot_hi[b0], w);
        } else if (run > 0) {
          shared_add_u64(&s_tot_lo[run_b], &s_tot_hi[run_b], run);
        }
      }
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
      // phase 3: prefix fill in (bucket, node index) order; contiguous node
      // ranges per thread so a block scan gives node order
      for (int b = 0; b < kBuckets; ++b) {
        if (shared_u64(&s_tot_lo[b], &s_tot_hi[b]) == 0ull) continue;
        const long long off = s_off[b];
        if (off >= remaining) break;
        long long local = 0;
        for (int n = lo; n < hi; ++n)
          if (bkt_s[n] == b) local += cap_s[n];
        long long prev = off + block_exclusive_scan(local, s_warp);
        for (int n = lo; n < hi; ++n) {
          if (bkt_s[n] != b) continue;
          const long long cap = cap_s[n];
          long long take = (long long)remaining - prev;
          take = take < 0 ? 0 : (take > cap ? cap : take);
          prev += cap;
          if (take > 0) {
            assigned[(size_t)c * N + n] += (int)take;
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
      K1_STAMP(t3);
      remaining -= got;
      if (!clamped) {
        __syncthreads();
        for (size_t i = tid; i < (size_t)N * R; i += nt)
          if (avail[i] < 0.f) avail[i] = 0.f;
        clamped = true;
      }
      __syncthreads();
      K1_PROFILE_PASS(t0, t1, t2, t3)
    }
  }
}

// bytes of per-node scratch (fit, cap: int32; bucket: uint8), 16-aligned
size_t k1_scratch_bytes(int N) { return ((size_t)N * 9 + 15) & ~(size_t)15; }
constexpr size_t kK1MaxDynSmem = 200 * 1024;

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
