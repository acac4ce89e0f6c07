// Hand-written Hopper (sm_90a) kernels of the expert layer's forward
// (ray_tpu/models/moe.py moe_ffn: top-1 Switch routing with a capacity
// drop, GShard-style dispatch to the experts and combine back) and of its
// backward (the gradient of moe_ffn as jax.grad forms it).
//
// Built by ray_tpu_torch/models/moe_kernels.py (through util/cuda_build.py)
// with one nvcc call into a shared library with a plain C interface, loaded
// with ctypes; the Python wrappers and their plain PyTorch versions live in
// moe_kernels.py. Every entry point launches on the stream it is given,
// allocates nothing, does not synchronise, and returns cudaGetLastError()
// after its launch. Tensors are contiguous; activations are of the dtype
// named by a code: 0 float32, 1 bfloat16. Arithmetic is float32 (the
// probability sums float64).
//
// Numerics: built with --fmad=false, as the scheduler's source is. No kernel
// here needs a contraction, and the routing must equal its plain version
// bit for bit: the softmax is spelled out as the reference computes it
// (row max, expf of the difference, a sum in expert order, IEEE division),
// never with the __expf intrinsic or fast math. No value is ever summed or
// stored through an atomic: K9a's ticket and its count of finished blocks
// are the only atomics, and they order blocks, never a sum. Every sum is
// taken in a fixed order, so two launches give the same bits.
//
// Layouts are the JAX package's: logits [G, S, E] (G token groups, S tokens
// a group, E experts), x and y [G, S, D], the experts' rows [E, G, C, D]
// with C the capacity a (group, expert).
//
// Kernels:
//   K9a moe_route     replaces moe.py :70-82 (softmax, argmax, gate,
//                     one-hot, the associative_scan position in expert,
//                     keep) and the sums behind the aux loss (:112-114).
//                     Per token: softmax over E, the top-1 expert (first
//                     index on equal probabilities, as jnp.argmax), gate =
//                     that probability. Per (group, expert): the inclusive
//                     running count of tokens over s = 0..S-1, so pos =
//                     count - 1 and a token is kept while pos < C. Writes
//                     expert [G,S], gate [G,S], slot [G,S] (e*C + pos, or -1
//                     if dropped), token_of_slot [E,G,C] (the token s held
//                     in a slot, or -1 if it is empty) and stats [G,2,E]
//                     (tokens and summed probability per expert).
//                     Bound: it reads G*S*E*4 bytes and writes ~G*S*12 +
//                     E*G*C*4 (0.8 MB, 0.24 us at 3.35 TB/s at the main
//                     path's shapes); the count over S is a scan, so it is
//                     latency-bound. Design: one launch of G * ceil(S / T)
//                     blocks, T = 256 tokens a block (a chunk), one token a
//                     thread: 64 blocks at the main path's [8, 2048, 8],
//                     where a block a group would be 8 blocks walking 8
//                     chunks in turn. Inside a chunk a token's
//                     rank among the earlier tokens of its expert comes
//                     from __match_any_sync over its warp plus the counts
//                     of the earlier warps (shared memory). Across chunks,
//                     a decoupled look-back on the integer counts: each
//                     block publishes its chunk's E counts (the count and
//                     a ready bit in one 32-bit word, so no fence is
//                     needed between them), then adds up the published
//                     counts of every earlier chunk of its group, read in
//                     parallel, one word a thread. Chosen over recomputing
//                     the earlier chunks' argmax (which waits on nothing)
//                     because the last chunk would redo 7 of 8 chunks'
//                     softmax at the main path's shape, a serial chain of
//                     ~60 expf and divisions a thread, while every block
//                     publishes after its own softmax alone, so a wait is
//                     about one L2 round trip. A block takes its chunk
//                     from an atomic ticket, not from blockIdx: it then
//                     waits only on blocks that have started, and every
//                     started block publishes without waiting, so the
//                     look-back makes progress at any G * S, grids larger
//                     than the card holds included. Every wait traps after
//                     2^26 polls. Counts are exact int32. The probability
//                     sums are taken per warp in float64 (a fixed
//                     butterfly), added in warp order into the chunk's
//                     sum in scratch; the group's last block to finish (a
//                     count of finished blocks, after __threadfence) adds
//                     the chunks' sums in chunk order, rounds once to
//                     float32, writes the token counts, fills the empty
//                     slots [count, C) of every expert with -1 and leaves
//                     the scratch as zeros. The scratch (moe_route_plan's
//                     words) is kept a stream by the wrapper, so no call
//                     allocates.
//   K9b moe_dispatch  replaces moe.py :83-89 and :99 (the dispatch one-hot,
//                     einsum("gsec,gsd->egcd") and .astype(cfg.dtype)): a
//                     gather, expert_in[e,g,c,:] = x[g, token_of_slot[e,g,c],
//                     :] rounded to the output dtype (round to nearest even),
//                     zeros in an empty slot. Each output row is written
//                     once. Bound by bytes (the kept rows of x read once, the
//                     E*G*C*D output written once). Design: a grid-stride
//                     loop over 8-element pieces of the output rows, 16-byte
//                     loads and stores where D is a multiple of 8 and every
//                     pointer 16-byte aligned (one element a thread
//                     otherwise), 64-bit offsets.
//   K9c moe_combine   replaces moe.py :86 and :110 (the combine weights and
//                     einsum("gsec,egcd->gsd"), .astype(x.dtype)): y[g,s,:] =
//                     gate[g,s] * out[e,g,pos,:] as one float32 product,
//                     rounded to y's dtype; exact zeros for a dropped token.
//                     Each sum of the einsum has one non-zero term, so this
//                     equals it. Bound by bytes (the kept rows of out read
//                     once, y written once). Design: as K9b, over y's rows.
//
// The backward, the transposes of the jaxpr of jax.vjp(moe_ffn) (each
// cotangent's one non-zero term taken directly, so no sum is needed where
// the einsum has one term):
//   K9c' moe_combine_bwd  the transpose of :110 (combine weights and
//                     einsum("gsec,egcd->gsd")): d_out[e,g,c,:] = gate[g,t] *
//                     dy[g,t,:] as one float32 product, t = token_of_slot[e,g,
//                     c], zeros in an empty slot (K9b's gather with a gate);
//                     d_gate[g,s] = sum_d dy[g,s,d] * out[slot[g,s], d] for a
//                     kept token, 0 for a dropped one (the combine weights'
//                     cotangent summed over (e, c)). Bound by bytes: the kept
//                     rows of dy and of out read once, d_out written once.
//                     Design: one launch, one warp a slot of [E, G, C]. Each
//                     kept token holds exactly one slot, so the slot's warp
//                     reads the token's dy row once (16-byte loads), writes
//                     gate * dy, reads the slot's row of out and writes
//                     d_gate of the token once, with no atomics: lane l
//                     sums the 8-element pieces l, l + 32, ... in order, then
//                     a butterfly over the warp (a fixed order; every lane
//                     ends with the same sum). The same launch writes 0 to
//                     a dropped token's d_gate. Where D is not a multiple of
//                     8 or a row is not 16-byte aligned, two launches: the
//                     rows (as K9b) and the dot products, one warp a token,
//                     each lane summing its strided elements in order.
//   K9b' moe_dispatch_bwd  the transpose of :89 and :99 (the dispatch
//                     einsum, the casts): each kept token holds one slot, so
//                     dx[g,s,:] = d_expert_in[slot[g,s],:] in x's dtype, zeros
//                     for a dropped token: K9c's gather without the gate.
//                     Bound by bytes (the kept rows read, dx written once).
//   K9a' moe_route_bwd  the gradient through :70-72 and :112-114: the
//                     softmax recomputed as K9a computes it (so e = exp(l -
//                     max), u and the probabilities equal the forward's bit
//                     for bit); the gate's cotangent split over the experts
//                     tied at the max, d_gate / count (jnp.max's rule;
//                     argmax takes the first, the gradient does not); the
//                     aux loss's term (frac_tokens[e] * (E * d_aux)) /
//                     (G*S), a true division, added to it; then the
//                     softmax's backward in the jaxpr's form, d_logits =
//                     (dp / u + -(sum_e dp * (1 / (u*u)) * e)) * e, the sum
//                     in expert order. It moves ~1 MB at the main path's
//                     shapes (under a microsecond at 3.35 TB/s): latency-
//                     bound, a chain of an expf and ~3 divisions an expert
//                     when one thread takes a token. Design: one lane a
//                     (token, expert), a group of the next power of two >=
//                     E lanes a token (4 tokens a warp at E = 8; one warp a
//                     token, two experts a lane, past 32 experts), so each
//                     lane takes one expf and one p = e / u, and a warp's
//                     loads and stores are consecutive floats: 512 blocks
//                     of 256 at the main path's [8, 2048, 8]. The row max
//                     and the gate are butterflies of fmaxf (exact in any
//                     order); u and sum_e (dp (1 / u^2)) e are added in
//                     expert order from the lanes' values by shuffles, as
//                     the jaxpr adds them, never by a tree; the tie count
//                     is a ballot's popcount.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kF32 = 0;
constexpr int kBF16 = 1;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxExperts = 64;

// ------------------------------------------------------------------ K9a

constexpr int kRouteThreads = 256;  // T: tokens a chunk (a block), one a thread
constexpr int kRouteWarps = kRouteThreads / 32;
constexpr unsigned kCountReady = 0x80000000u;  // set in a published count word
constexpr unsigned kRoutePolls = 1u << 26;     // a wait traps after this many polls

// K9a's scratch, int32 words kept a stream by the caller (zeros when it is
// made; every launch leaves it zeros again): [0] the ticket, [done, +G) the
// blocks of each group that have finished, [agg, +n) each chunk's token
// count per expert, published with kCountReady, and [part, +2n) each
// chunk's probability sum per expert as a double; n = G * chunks * E.
struct RouteLayout {
  long long done, agg, part, words;
};

__host__ __device__ inline int route_chunks(int S) {
  return (S + kRouteThreads - 1) / kRouteThreads;
}

__host__ __device__ inline RouteLayout route_layout(int G, int S, int E) {
  const long long n = (long long)G * route_chunks(S) * E;
  RouteLayout L;
  L.done = 2;
  L.agg = L.done + G + (G & 1);
  L.part = L.agg + n + (n & 1);  // 8-byte aligned
  L.words = L.part + 2 * n;
  return L;
}

// A count word of an earlier chunk, once its block has published it. A
// wait that never ends (a fault) traps after kRoutePolls polls, seconds at
// least, so the launch fails instead of hanging the card.
__device__ __forceinline__ int wait_count(const int* word) {
  for (unsigned polls = 0;; ++polls) {
    const unsigned w = *reinterpret_cast<const volatile unsigned*>(word);
    if (w & kCountReady) return (int)(w & ~kCountReady);
    if (polls == kRoutePolls) __trap();
  }
}

template <int kMaxE>
__global__ void __launch_bounds__(kRouteThreads) route_kernel(
    const float* __restrict__ logits, int G, int S, int E, int C,
    int* __restrict__ expert_out, float* __restrict__ gate_out, int* __restrict__ slot_out,
    int* __restrict__ token_of_slot, float* __restrict__ stats, int* __restrict__ scratch) {
  __shared__ int wcount[kRouteWarps][kMaxE];    // tokens of warp w routed to e
  __shared__ double wprob[kRouteWarps][kMaxE];  // warp w's sum of probs[e]
  __shared__ int lookback[kRouteThreads];       // earlier chunks' counts, in part
  __shared__ int base[kMaxE];                   // tokens of earlier chunks routed to e
  __shared__ unsigned ticket_of_block;
  __shared__ int last_of_group;
  const RouteLayout L = route_layout(G, S, E);
  const int chunks = route_chunks(S);
  unsigned* ticket = reinterpret_cast<unsigned*>(scratch);
  int* done = scratch + L.done;
  int* agg = scratch + L.agg;
  double* part = reinterpret_cast<double*>(scratch + L.part);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const unsigned lanes_before = (1u << lane) - 1u;

  // the chunk comes from the ticket, so every block this one waits for
  // (an earlier chunk of its group) has started
  if (tid == 0) {
    const unsigned t = atomicAdd(ticket, 1u);
    if (t == gridDim.x - 1) atomicExch(ticket, 0u);  // every ticket taken
    ticket_of_block = t;
  }
  for (int i = tid; i < kRouteWarps * kMaxE; i += kRouteThreads) wcount[i / kMaxE][i % kMaxE] = 0;
  __syncthreads();
  const int g = (int)(ticket_of_block / (unsigned)chunks);
  const int j = (int)(ticket_of_block - (unsigned)g * (unsigned)chunks);
  const int s = j * kRouteThreads + tid;
  const bool live = s < S;
  const long long gs = (long long)g * S + s;
  float p[kMaxE];
  int best = -1;  // -1: no token (past the ragged end)
  float gate = 0.f;
#pragma unroll
  for (int e = 0; e < kMaxE; ++e) p[e] = 0.f;
  if (live) {
    const float* row = logits + gs * E;
    float m = -INFINITY;
#pragma unroll
    for (int e = 0; e < kMaxE; ++e) {
      if (e < E) {
        p[e] = row[e];
        m = fmaxf(m, p[e]);
      }
    }
    // softmax as the reference: exp(l - max), summed in e order, divided
    float sum = 0.f;
#pragma unroll
    for (int e = 0; e < kMaxE; ++e) {
      if (e < E) {
        p[e] = expf(__fsub_rn(p[e], m));
        sum = __fadd_rn(sum, p[e]);
      }
    }
    // argmax over the probabilities, the first index on equal values
#pragma unroll
    for (int e = 0; e < kMaxE; ++e) {
      if (e < E) {
        p[e] = __fdiv_rn(p[e], sum);
        if (e == 0 || p[e] > gate) {
          gate = p[e];
          best = e;
        }
      }
    }
  }

  // rank among the earlier tokens of this warp routed to the same expert;
  // the warp's first such token records the warp's count
  const unsigned peers = __match_any_sync(kFull, best);
  const int rank = __popc(peers & lanes_before);
  if (live && rank == 0) wcount[warp][best] = __popc(peers);
#pragma unroll
  for (int e = 0; e < kMaxE; ++e) {
    if (e < E) {
      double v = (double)p[e];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
      if (lane == 0) wprob[warp][e] = v;
    }
  }
  __syncthreads();

  // publish this chunk's counts (the count and its flag in one word) and
  // its probability sums, the warps in order
  const long long group0 = (long long)g * chunks * E;
  if (tid < E) {
    int count = 0;
    double sum = 0.0;
    for (int w = 0; w < kRouteWarps; ++w) {
      count += wcount[w][tid];
      sum += wprob[w][tid];
    }
    part[group0 + (long long)j * E + tid] = sum;
    *reinterpret_cast<volatile unsigned*>(agg + group0 + (long long)j * E + tid) =
        (unsigned)count | kCountReady;
  }
  // the tokens of the earlier chunks routed to each expert: thread k0 * E + e
  // adds the counts of chunks k0, k0 + per_e, ... below j, then thread e
  // adds those partial counts (exact integers)
  const int per_e = kRouteThreads / E;
  if (tid < per_e * E) {
    const int e = tid % E;
    int sum = 0;
    for (int k = tid / E; k < j; k += per_e) sum += wait_count(agg + group0 + (long long)k * E + e);
    lookback[tid] = sum;
  }
  __syncthreads();
  if (tid < E) {
    int b = 0;
    for (int k0 = 0; k0 < per_e; ++k0) b += lookback[k0 * E + tid];
    base[tid] = b;
  }
  __syncthreads();

  if (live) {
    int pos = base[best] + rank;
    for (int w = 0; w < warp; ++w) pos += wcount[w][best];
    const bool keep = pos < C;
    expert_out[gs] = best;
    gate_out[gs] = gate;
    slot_out[gs] = keep ? best * C + pos : -1;
    if (keep) token_of_slot[((long long)best * G + g) * C + pos] = s;
  }

  // the group's last block to finish writes its stats, fills its empty
  // slots and leaves the group's scratch as zeros
  __threadfence();  // this chunk's sums before its done ticket
  __syncthreads();
  if (tid == 0) last_of_group = atomicAdd(done + g, 1) == chunks - 1;
  __syncthreads();
  if (!last_of_group) return;
  __threadfence();
  if (tid < E) {
    int count = 0;
    double total = 0.0;  // in chunk order
    for (int k = 0; k < chunks; ++k) {
      const long long at = group0 + (long long)k * E + tid;
      count += __ldcg(agg + at) & (int)~kCountReady;
      total += __ldcg(part + at);
      agg[at] = 0;  // a later call may lay its counts over these sums:
      part[at] = 0.0;  // zeros, so no word reads as published
    }
    stats[((long long)g * 2 + 0) * E + tid] = (float)count;
    stats[((long long)g * 2 + 1) * E + tid] = __double2float_rn(total);
    base[tid] = count;
  }
  if (tid == 0) done[g] = 0;
  __syncthreads();
  // the slots past each expert's count stay empty
  for (int e = 0; e < E; ++e) {
    int* dst = token_of_slot + ((long long)e * G + g) * C;
    for (int c = min(base[e], C) + tid; c < C; c += kRouteThreads) dst[c] = -1;
  }
}

template <int kMaxE>
int launch_route(const float* logits, int* expert, float* gate, int* slot, int* tos,
                 float* stats, int* scratch, int G, int S, int E, int C, cudaStream_t stream) {
  const long long blocks = (long long)G * route_chunks(S);
  route_kernel<kMaxE><<<(unsigned)blocks, kRouteThreads, 0, stream>>>(
      logits, G, S, E, C, expert, gate, slot, tos, stats, scratch);
  return (int)cudaGetLastError();
}

// ------------------------------------------------- K9b and K9c: row copies

constexpr int kCopyThreads = 256;

// n consecutive elements from index i as float32; n = 8 reads 16-byte units.
template <int kVec>
__device__ __forceinline__ void load_vec(const void* p, long long i, int dt, float* v) {
  if constexpr (kVec == 8) {
    if (dt == kBF16) {
      const uint4 u = *reinterpret_cast<const uint4*>(
          reinterpret_cast<const __nv_bfloat16*>(p) + i);
      const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[k]));
        v[2 * k] = f.x;
        v[2 * k + 1] = f.y;
      }
    } else {
      const float4* q = reinterpret_cast<const float4*>(reinterpret_cast<const float*>(p) + i);
      const float4 a = q[0];
      const float4 b = q[1];
      v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
      v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      v[k] = dt == kBF16 ? __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(p)[i + k])
                         : reinterpret_cast<const float*>(p)[i + k];
    }
  }
}

// n consecutive elements to index i, rounded to the dtype (nearest even).
template <int kVec>
__device__ __forceinline__ void store_vec(void* p, long long i, int dt, const float* v) {
  if constexpr (kVec == 8) {
    if (dt == kBF16) {
      unsigned w[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
        w[k] = *reinterpret_cast<const unsigned*>(&h);
      }
      *reinterpret_cast<uint4*>(reinterpret_cast<__nv_bfloat16*>(p) + i) =
          make_uint4(w[0], w[1], w[2], w[3]);
    } else {
      float4* q = reinterpret_cast<float4*>(reinterpret_cast<float*>(p) + i);
      q[0] = make_float4(v[0], v[1], v[2], v[3]);
      q[1] = make_float4(v[4], v[5], v[6], v[7]);
    }
  } else {
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      if (dt == kBF16) {
        reinterpret_cast<__nv_bfloat16*>(p)[i + k] = __float2bfloat16_rn(v[k]);
      } else {
        reinterpret_cast<float*>(p)[i + k] = v[k];
      }
    }
  }
}

// dst[e,g,c,:] = src[g, token_of_slot[e,g,c], :], times gate[g, that token]
// when a gate is given (one float32 product), rounded to dst's dtype; zeros
// in an empty slot (a token outside [0, S), never read).
template <int kVec>
__device__ __forceinline__ void rows_by_slot(const void* __restrict__ src, int src_dt,
                                             const int* __restrict__ token_of_slot,
                                             const float* __restrict__ gate,
                                             void* __restrict__ dst, int dst_dt, int G, int S,
                                             int C, int D, long long n_pieces) {
  const int per_row = D / kVec;
  for (long long i = (long long)blockIdx.x * kCopyThreads + threadIdx.x; i < n_pieces;
       i += (long long)gridDim.x * kCopyThreads) {
    const long long row = i / per_row;  // (e, g, c)
    const int col = (int)(i - row * per_row) * kVec;
    const int g = (int)((row / C) % G);
    const int tok = token_of_slot[row];
    float v[kVec];
    if (tok >= 0 && tok < S) {
      const long long gs = (long long)g * S + tok;
      load_vec<kVec>(src, gs * D + col, src_dt, v);
      if (gate != nullptr) {
        const float gt = gate[gs];
#pragma unroll
        for (int k = 0; k < kVec; ++k) v[k] = __fmul_rn(gt, v[k]);
      }
    } else {
#pragma unroll
      for (int k = 0; k < kVec; ++k) v[k] = 0.f;
    }
    store_vec<kVec>(dst, row * D + col, dst_dt, v);
  }
}

// dst[g,s,:] = src[e, g, pos, :] with slot[g,s] = e*C + pos, times gate[g,s]
// when a gate is given (one float32 product), rounded to dst's dtype; zeros
// for a dropped token (a slot outside [0, E*C), never read).
template <int kVec>
__device__ __forceinline__ void rows_by_token(const void* __restrict__ src, int src_dt,
                                              const int* __restrict__ slot,
                                              const float* __restrict__ gate,
                                              void* __restrict__ dst, int dst_dt, int E, int G,
                                              int S, int C, int D, long long n_pieces) {
  const int per_row = D / kVec;
  for (long long i = (long long)blockIdx.x * kCopyThreads + threadIdx.x; i < n_pieces;
       i += (long long)gridDim.x * kCopyThreads) {
    const long long row = i / per_row;  // (g, s)
    const int col = (int)(i - row * per_row) * kVec;
    const int sl = slot[row];
    float v[kVec];
    if (sl >= 0 && sl < E * C) {
      const int g = (int)(row / S);
      const long long src_row = ((long long)(sl / C) * G + g) * C + sl % C;
      load_vec<kVec>(src, src_row * D + col, src_dt, v);
      if (gate != nullptr) {
        const float gt = gate[row];
#pragma unroll
        for (int k = 0; k < kVec; ++k) v[k] = __fmul_rn(gt, v[k]);
      }
    } else {
#pragma unroll
      for (int k = 0; k < kVec; ++k) v[k] = 0.f;
    }
    store_vec<kVec>(dst, row * D + col, dst_dt, v);
  }
}

// K9b: the kept tokens' rows of x into the experts' slots
template <int kVec>
__global__ void __launch_bounds__(kCopyThreads) dispatch_kernel(
    const void* __restrict__ x, const int* __restrict__ token_of_slot, void* __restrict__ out,
    int G, int S, int C, int D, int x_dt, int out_dt, long long n_pieces) {
  rows_by_slot<kVec>(x, x_dt, token_of_slot, nullptr, out, out_dt, G, S, C, D, n_pieces);
}

// K9c: each token's expert row times its gate
template <int kVec>
__global__ void __launch_bounds__(kCopyThreads) combine_kernel(
    const float* __restrict__ out, const int* __restrict__ slot, const float* __restrict__ gate,
    void* __restrict__ y, int E, int G, int S, int C, int D, int y_dt, long long n_pieces) {
  rows_by_token<kVec>(out, kF32, slot, gate, y, y_dt, E, G, S, C, D, n_pieces);
}

// ------------------------------------------------------------- backward

// K9b': the slots' cotangents back to their tokens, in x's dtype
template <int kVec>
__global__ void __launch_bounds__(kCopyThreads) dispatch_bwd_kernel(
    const void* __restrict__ d_in, const int* __restrict__ slot, void* __restrict__ dx, int E,
    int G, int S, int C, int D, int in_dt, int dx_dt, long long n_pieces) {
  rows_by_token<kVec>(d_in, in_dt, slot, nullptr, dx, dx_dt, E, G, S, C, D, n_pieces);
}

// K9c', launch 1: d_out[e,g,c,:] = gate * dy of the slot's token, float32
template <int kVec>
__global__ void __launch_bounds__(kCopyThreads) combine_bwd_rows_kernel(
    const void* __restrict__ dy, const int* __restrict__ token_of_slot,
    const float* __restrict__ gate, float* __restrict__ d_out, int G, int S, int C, int D,
    int dy_dt, long long n_pieces) {
  rows_by_slot<kVec>(dy, dy_dt, token_of_slot, gate, d_out, kF32, G, S, C, D, n_pieces);
}

constexpr int kGateThreads = 256;  // one warp a token (a slot in the fused form)
constexpr int kGateWarps = kGateThreads / 32;

// K9c' in one launch (D a multiple of 8, every row 16-byte aligned): one
// warp a slot of [E, G, C], then one thread a token for the dropped ones.
__global__ void __launch_bounds__(kGateThreads) combine_bwd_fused_kernel(
    const void* __restrict__ dy, const float* __restrict__ out, const int* __restrict__ slot,
    const float* __restrict__ gate, const int* __restrict__ token_of_slot,
    float* __restrict__ d_out, float* __restrict__ d_gate, int E, int G, int S, int C, int D,
    int dy_dt, long long n_slots, long long n_tokens) {
  const int lane = threadIdx.x & 31;
  const int pieces = D / 8;
  const long long warps = (long long)gridDim.x * kGateWarps;
  for (long long row = (long long)blockIdx.x * kGateWarps + (threadIdx.x >> 5); row < n_slots;
       row += warps) {  // row = (e, g, c)
    const int tok = token_of_slot[row];
    if (tok >= 0 && tok < S) {  // the same branch for the whole warp
      const long long gs = (long long)((row / C) % G) * S + tok;
      const float gt = gate[gs];
      float acc = 0.f;
      for (int k = lane; k < pieces; k += 32) {
        float v[8], o[8];
        load_vec<8>(dy, gs * D + 8 * k, dy_dt, v);
        load_vec<8>(out, row * D + 8 * k, kF32, o);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          acc = __fadd_rn(acc, __fmul_rn(v[i], o[i]));
          v[i] = __fmul_rn(gt, v[i]);
        }
        store_vec<8>(d_out, row * D + 8 * k, kF32, v);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) acc = __fadd_rn(acc, __shfl_xor_sync(kFull, acc, off));
      if (lane == 0) d_gate[gs] = acc;
    } else {
      const float zero[8] = {};
      for (int k = lane; k < pieces; k += 32) store_vec<8>(d_out, row * D + 8 * k, kF32, zero);
    }
  }
  for (long long t = (long long)blockIdx.x * kGateThreads + threadIdx.x; t < n_tokens;
       t += (long long)gridDim.x * kGateThreads) {
    const int sl = slot[t];
    if (sl < 0 || sl >= E * C) d_gate[t] = 0.f;
  }
}

// K9c', launch 2: d_gate[g,s] = sum_d dy[g,s,d] * out[slot[g,s], d], 0 for a
// dropped token. Lane l sums d = l, l + 32, ... in order; then a butterfly.
__global__ void __launch_bounds__(kGateThreads) combine_bwd_gate_kernel(
    const void* __restrict__ dy, const float* __restrict__ out, const int* __restrict__ slot,
    float* __restrict__ d_gate, int E, int G, int S, int C, int D, int dy_dt,
    long long n_tokens) {
  const int lane = threadIdx.x & 31;
  for (long long t = (long long)blockIdx.x * kGateWarps + (threadIdx.x >> 5); t < n_tokens;
       t += (long long)gridDim.x * kGateWarps) {
    const int sl = slot[t];
    float acc = 0.f;
    if (sl >= 0 && sl < E * C) {  // the same branch for the whole warp
      const int g = (int)(t / S);
      const float* row = out + (((long long)(sl / C) * G + g) * C + sl % C) * D;
      for (int d = lane; d < D; d += 32) {
        float v;
        load_vec<1>(dy, t * D + d, dy_dt, &v);
        acc = __fadd_rn(acc, __fmul_rn(v, row[d]));
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) acc = __fadd_rn(acc, __shfl_xor_sync(kFull, acc, off));
    }
    if (lane == 0) d_gate[t] = acc;
  }
}

constexpr int kRouteBwdThreads = 256;
constexpr int kRouteBwdWarps = kRouteBwdThreads / 32;

// K9a''s layout for E experts: lanes a token, the next power of two >= E
// up to 32 (lanes E and past idle), and experts a lane, 1 or, past 32
// experts, 2 (experts l and l + 32 on lane l).
__host__ __device__ constexpr int route_bwd_lanes(int E) {
  int lanes = 1;
  while (lanes < E && lanes < 32) lanes <<= 1;
  return lanes;
}

__host__ __device__ constexpr int route_bwd_per_lane(int E) { return E > 32 ? 2 : 1; }

// Expert e's value among a token's lanes (its group, kLanes wide), every
// lane of the warp taking part; for kPer 2, v[1] holds experts 32 and up.
template <int kLanes, int kPer>
__device__ __forceinline__ float expert_value(const float (&v)[kPer], int e) {
  if constexpr (kPer == 2) {
    if (e >= 32) return __shfl_sync(kFull, v[1], e - 32);
  }
  return __shfl_sync(kFull, v[0], e, kLanes);
}

// A sum over experts 0..E-1 in expert order, as the jaxpr adds them (every
// lane of the group gets the same bits; never a tree, which rounds apart).
// E is the same for every lane, so every lane takes part in each shuffle.
template <int kLanes, int kPer>
__device__ __forceinline__ float expert_order_sum(const float (&v)[kPer], int E) {
  float sum = expert_value<kLanes, kPer>(v, 0);
#pragma unroll
  for (int e = 1; e < kLanes * kPer; ++e) {
    if (e < E) sum = __fadd_rn(sum, expert_value<kLanes, kPer>(v, e));
  }
  return sum;
}

// K9a': d_logits with one lane a (token, expert) (kPer 2: two experts a
// lane), kLanes lanes a token, 32 / kLanes tokens a warp, in the jaxpr's
// order of operations. A warp's loads and stores of logits and d_logits
// are one stretch of consecutive floats.
template <int kLanes, int kPer>
__global__ void __launch_bounds__(kRouteBwdThreads) route_bwd_kernel(
    const float* __restrict__ logits, const float* __restrict__ d_gate,
    const float* __restrict__ frac_tokens, const float* __restrict__ d_aux, float n_tokens_f,
    float* __restrict__ d_logits, int E, long long n_tokens) {
  constexpr int kTokensWarp = 32 / kLanes;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int j = lane % kLanes;  // this lane's expert (and j + 32 for kPer 2)
  const unsigned group = kLanes == 32 ? kFull : ((1u << kLanes) - 1u) << (lane - j);
  const float z = __fmul_rn((float)E, *d_aux);
  bool has[kPer];
  float frac[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    has[k] = j + 32 * k < E;
    frac[k] = has[k] ? frac_tokens[j + 32 * k] : 0.f;
  }
  const long long stride = (long long)gridDim.x * kRouteBwdWarps * kTokensWarp;
  for (long long t0 = ((long long)blockIdx.x * kRouteBwdWarps + warp) * kTokensWarp;
       t0 < n_tokens; t0 += stride) {  // uniform over the warp: every lane shuffles
    const long long t = t0 + lane / kLanes;
    const bool live = t < n_tokens;
    // every load first, so that all are in flight before the first division
    float x[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) x[k] = live && has[k] ? logits[t * E + j + 32 * k] : -INFINITY;
    const float d_gate_t = live ? d_gate[t] : 0.f;
    // the aux loss's term of this lane's experts: (frac_tokens[e] * (E * d_aux)) / (G*S)
    float aux[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) aux[k] = __fdiv_rn(__fmul_rn(frac[k], z), n_tokens_f);
    // the softmax as K9a computes it: the row max (exact in any order),
    // e = exp(l - max), u their sum in expert order, p = e / u (IEEE)
    float m = x[0];
#pragma unroll
    for (int k = 1; k < kPer; ++k) m = fmaxf(m, x[k]);
#pragma unroll
    for (int off = kLanes / 2; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
    float ex[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) ex[k] = has[k] ? expf(__fsub_rn(x[k], m)) : 0.f;
    const float u = expert_order_sum<kLanes, kPer>(ex, E);
    float p[kPer];
    float gate = -INFINITY;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      p[k] = __fdiv_rn(ex[k], u);
      if (has[k]) gate = fmaxf(gate, p[k]);
    }
#pragma unroll
    for (int off = kLanes / 2; off > 0; off >>= 1) {
      gate = fmaxf(gate, __shfl_xor_sync(kFull, gate, off));
    }
    // the experts tied at the max share the gate's cotangent (jnp.max's rule)
    bool tie[kPer];
    int count = 0;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      tie[k] = has[k] && p[k] == gate;
      count += __popc(__ballot_sync(kFull, tie[k]) & group);
    }
    const float dg = __fdiv_rn(d_gate_t, (float)count);
    const float s = __fdiv_rn(1.f, __fmul_rn(u, u));
    float dp[kPer], w[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      dp[k] = __fadd_rn(aux[k], __fmul_rn(dg, tie[k] ? 1.f : 0.f));
      w[k] = __fmul_rn(__fmul_rn(dp[k], s), ex[k]);
    }
    const float sum = expert_order_sum<kLanes, kPer>(w, E);
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      if (live && has[k]) {
        d_logits[t * E + j + 32 * k] = __fmul_rn(__fadd_rn(__fdiv_rn(dp[k], u), -sum), ex[k]);
      }
    }
  }
}

// K9a''s blocks: 8 warps of 32 / lanes-a-token tokens a block, at most 2^30
// (a grid-stride loop past them).
long long route_bwd_blocks(long long n_tokens, int E) {
  const long long tokens = (long long)kRouteBwdWarps * (32 / route_bwd_lanes(E));
  const long long blocks = (n_tokens + tokens - 1) / tokens;
  return blocks < (1LL << 30) ? blocks : (1LL << 30);
}

template <int kLanes, int kPer>
int launch_route_bwd(const float* logits, const float* d_gate, const float* frac,
                     const float* d_aux, float n_tokens_f, float* d_logits, int E,
                     long long n_tokens, cudaStream_t stream) {
  route_bwd_kernel<kLanes, kPer><<<(int)route_bwd_blocks(n_tokens, E), kRouteBwdThreads, 0,
                                   stream>>>(logits, d_gate, frac, d_aux, n_tokens_f, d_logits, E,
                                             n_tokens);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

int copy_blocks(long long n_pieces) {
  const long long blocks = (n_pieces + kCopyThreads - 1) / kCopyThreads;
  return (int)(blocks < (1LL << 30) ? blocks : (1LL << 30));
}

bool bad_dtype(int dt) { return dt != kF32 && dt != kBF16; }

}  // namespace

extern "C" {

const char* moe_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// K9a's launch for logits [G, S, E]: plan = {tokens a chunk, chunks a
// group, blocks, int32 words of scratch}.
int moe_route_plan(int G, int S, int E, long long* plan) {
  if (G <= 0 || S <= 0 || E <= 0) return (int)cudaErrorInvalidValue;
  plan[0] = kRouteThreads;
  plan[1] = route_chunks(S);
  plan[2] = (long long)G * route_chunks(S);
  plan[3] = route_layout(G, S, E).words;
  return 0;
}

// scratch: scratch_words int32 words, zeros, kept for this stream (moe_route_plan).
int moe_route(const float* logits, int* expert, float* gate, int* slot, int* token_of_slot,
              float* stats, int* scratch, long long scratch_words, int G, int S, int E, int C,
              void* stream) {
  if (G <= 0 || G > 65535 || S <= 0 || E <= 0 || E > kMaxExperts || C <= 0 ||
      (long long)G * route_chunks(S) > 0x7fffffffLL ||
      scratch_words < route_layout(G, S, E).words) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  if (E <= 8) return launch_route<8>(logits, expert, gate, slot, token_of_slot, stats, scratch, G, S, E, C, st);
  if (E <= 16) return launch_route<16>(logits, expert, gate, slot, token_of_slot, stats, scratch, G, S, E, C, st);
  if (E <= 32) return launch_route<32>(logits, expert, gate, slot, token_of_slot, stats, scratch, G, S, E, C, st);
  return launch_route<64>(logits, expert, gate, slot, token_of_slot, stats, scratch, G, S, E, C, st);
}

int moe_dispatch(const void* x, const int* token_of_slot, void* out, int E, int G, int S, int C,
                 int D, int x_dtype, int out_dtype, void* stream) {
  if (E <= 0 || G <= 0 || S <= 0 || C <= 0 || D <= 0 || bad_dtype(x_dtype) ||
      bad_dtype(out_dtype)) {
    return (int)cudaErrorInvalidValue;
  }
  const long long elems = (long long)E * G * C * D;
  cudaStream_t st = (cudaStream_t)stream;
  if (D % 8 == 0 && aligned16(x) && aligned16(out)) {
    dispatch_kernel<8><<<copy_blocks(elems / 8), kCopyThreads, 0, st>>>(
        x, token_of_slot, out, G, S, C, D, x_dtype, out_dtype, elems / 8);
  } else {
    dispatch_kernel<1><<<copy_blocks(elems), kCopyThreads, 0, st>>>(
        x, token_of_slot, out, G, S, C, D, x_dtype, out_dtype, elems);
  }
  return (int)cudaGetLastError();
}

int moe_combine(const float* out, const int* slot, const float* gate, void* y, int E, int G,
                int S, int C, int D, int y_dtype, void* stream) {
  if (E <= 0 || G <= 0 || S <= 0 || C <= 0 || D <= 0 || bad_dtype(y_dtype)) {
    return (int)cudaErrorInvalidValue;
  }
  const long long elems = (long long)G * S * D;
  cudaStream_t st = (cudaStream_t)stream;
  if (D % 8 == 0 && aligned16(out) && aligned16(y)) {
    combine_kernel<8><<<copy_blocks(elems / 8), kCopyThreads, 0, st>>>(
        out, slot, gate, y, E, G, S, C, D, y_dtype, elems / 8);
  } else {
    combine_kernel<1><<<copy_blocks(elems), kCopyThreads, 0, st>>>(
        out, slot, gate, y, E, G, S, C, D, y_dtype, elems);
  }
  return (int)cudaGetLastError();
}

int moe_combine_bwd(const void* dy, const float* out, const int* slot, const float* gate,
                    const int* token_of_slot, float* d_out, float* d_gate, int E, int G, int S,
                    int C, int D, int dy_dtype, void* stream) {
  if (E <= 0 || G <= 0 || S <= 0 || C <= 0 || D <= 0 || bad_dtype(dy_dtype)) {
    return (int)cudaErrorInvalidValue;
  }
  const long long elems = (long long)E * G * C * D;
  const long long n_tokens = (long long)G * S;
  cudaStream_t st = (cudaStream_t)stream;
  if (D % 8 == 0 && aligned16(dy) && aligned16(out) && aligned16(d_out)) {
    const long long n_slots = (long long)E * G * C;
    const long long slot_blocks = (n_slots + kGateWarps - 1) / kGateWarps;
    combine_bwd_fused_kernel<<<(int)(slot_blocks < (1LL << 30) ? slot_blocks : (1LL << 30)),
                               kGateThreads, 0, st>>>(dy, out, slot, gate, token_of_slot, d_out,
                                                      d_gate, E, G, S, C, D, dy_dtype, n_slots,
                                                      n_tokens);
    return (int)cudaGetLastError();
  }
  combine_bwd_rows_kernel<1><<<copy_blocks(elems), kCopyThreads, 0, st>>>(
      dy, token_of_slot, gate, d_out, G, S, C, D, dy_dtype, elems);
  const int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  const long long blocks = (n_tokens + kGateWarps - 1) / kGateWarps;
  combine_bwd_gate_kernel<<<(int)(blocks < (1LL << 30) ? blocks : (1LL << 30)), kGateThreads, 0,
                            st>>>(dy, out, slot, d_gate, E, G, S, C, D, dy_dtype, n_tokens);
  return (int)cudaGetLastError();
}

int moe_dispatch_bwd(const void* d_in, const int* slot, void* dx, int E, int G, int S, int C,
                     int D, int in_dtype, int dx_dtype, void* stream) {
  if (E <= 0 || G <= 0 || S <= 0 || C <= 0 || D <= 0 || bad_dtype(in_dtype) ||
      bad_dtype(dx_dtype)) {
    return (int)cudaErrorInvalidValue;
  }
  const long long elems = (long long)G * S * D;
  cudaStream_t st = (cudaStream_t)stream;
  if (D % 8 == 0 && aligned16(d_in) && aligned16(dx)) {
    dispatch_bwd_kernel<8><<<copy_blocks(elems / 8), kCopyThreads, 0, st>>>(
        d_in, slot, dx, E, G, S, C, D, in_dtype, dx_dtype, elems / 8);
  } else {
    dispatch_bwd_kernel<1><<<copy_blocks(elems), kCopyThreads, 0, st>>>(
        d_in, slot, dx, E, G, S, C, D, in_dtype, dx_dtype, elems);
  }
  return (int)cudaGetLastError();
}

int moe_route_bwd(const float* logits, const float* d_gate, const float* frac_tokens,
                  const float* d_aux, float* d_logits, int G, int S, int E, float n_tokens_f,
                  void* stream) {
  if (G <= 0 || S <= 0 || E <= 0 || E > kMaxExperts) return (int)cudaErrorInvalidValue;
  const long long n = (long long)G * S;
  cudaStream_t st = (cudaStream_t)stream;
  switch (route_bwd_lanes(E) * route_bwd_per_lane(E)) {
    case 1: return launch_route_bwd<1, 1>(logits, d_gate, frac_tokens, d_aux, n_tokens_f, d_logits, E, n, st);
    case 2: return launch_route_bwd<2, 1>(logits, d_gate, frac_tokens, d_aux, n_tokens_f, d_logits, E, n, st);
    case 4: return launch_route_bwd<4, 1>(logits, d_gate, frac_tokens, d_aux, n_tokens_f, d_logits, E, n, st);
    case 8: return launch_route_bwd<8, 1>(logits, d_gate, frac_tokens, d_aux, n_tokens_f, d_logits, E, n, st);
    case 16: return launch_route_bwd<16, 1>(logits, d_gate, frac_tokens, d_aux, n_tokens_f, d_logits, E, n, st);
    case 32: return launch_route_bwd<32, 1>(logits, d_gate, frac_tokens, d_aux, n_tokens_f, d_logits, E, n, st);
    default: return launch_route_bwd<32, 2>(logits, d_gate, frac_tokens, d_aux, n_tokens_f, d_logits, E, n, st);
  }
}

}  // extern "C"
