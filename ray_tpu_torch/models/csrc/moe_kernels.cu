// Hand-written Hopper (sm_90a) kernels of the expert layer's forward
// (ray_tpu/models/moe.py moe_ffn: top-1 Switch routing with a capacity
// drop, GShard-style dispatch to the experts and combine back).
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
// never with the __expf intrinsic or fast math.
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
//                     E*G*C*4 (microseconds at 3.35 TB/s); the count over S
//                     is sequential, so it is latency-bound: one block per
//                     group, G = 8 blocks on 132 SMs at the main path's
//                     shapes. Design: the order of the count is the
//                     semantics, and blocks run in no order, so one block
//                     owns a group and walks it in chunks of 256 tokens, one
//                     token a thread. Inside a chunk a token's rank among
//                     the earlier tokens of its expert comes from
//                     __match_any_sync over its warp plus the counts of the
//                     earlier warps (shared memory); a running count per
//                     expert carries from chunk to chunk. Counts are exact
//                     int32. The probability sums are taken per warp in
//                     float64 and added in warp order, so they are
//                     deterministic and round once to float32. A later
//                     kernel can spread a group over several blocks with a
//                     decoupled look-back.
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

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kF32 = 0;
constexpr int kBF16 = 1;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxExperts = 64;

// ------------------------------------------------------------------ K9a

constexpr int kRouteThreads = 256;  // tokens a chunk, one a thread
constexpr int kRouteWarps = kRouteThreads / 32;

template <int kMaxE>
__global__ void __launch_bounds__(kRouteThreads) route_kernel(
    const float* __restrict__ logits, int G, int S, int E, int C,
    int* __restrict__ expert_out, float* __restrict__ gate_out, int* __restrict__ slot_out,
    int* __restrict__ token_of_slot, float* __restrict__ stats) {
  __shared__ int base[kMaxE];                   // tokens of the group routed to e so far
  __shared__ int wcount[kRouteWarps][kMaxE];    // this chunk: tokens of warp w routed to e
  __shared__ double wprob[kRouteWarps][kMaxE];  // warp w's sum of probs[e] over all chunks
  const int g = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const unsigned lanes_before = (1u << lane) - 1u;

  for (int i = tid; i < kMaxE; i += kRouteThreads) base[i] = 0;
  for (int i = tid; i < kRouteWarps * kMaxE; i += kRouteThreads) {
    wcount[i / kMaxE][i % kMaxE] = 0;
    wprob[i / kMaxE][i % kMaxE] = 0.0;
  }
  __syncthreads();

  for (int s0 = 0; s0 < S; s0 += kRouteThreads) {
    const int s = s0 + tid;
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
        if (lane == 0) wprob[warp][e] += v;
      }
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
    __syncthreads();
    if (tid < E) {
      int total = 0;
      for (int w = 0; w < kRouteWarps; ++w) {
        total += wcount[w][tid];
        wcount[w][tid] = 0;
      }
      base[tid] += total;
    }
    __syncthreads();
  }

  if (tid < E) {
    double total = 0.0;
    for (int w = 0; w < kRouteWarps; ++w) total += wprob[w][tid];
    stats[((long long)g * 2 + 0) * E + tid] = (float)base[tid];
    stats[((long long)g * 2 + 1) * E + tid] = __double2float_rn(total);
  }
  // the slots past each expert's count stay empty
  for (int e = 0; e < E; ++e) {
    int* dst = token_of_slot + ((long long)e * G + g) * C;
    for (int c = min(base[e], C) + tid; c < C; c += kRouteThreads) dst[c] = -1;
  }
}

template <int kMaxE>
int launch_route(const float* logits, int* expert, float* gate, int* slot, int* tos,
                 float* stats, int G, int S, int E, int C, cudaStream_t stream) {
  route_kernel<kMaxE><<<G, kRouteThreads, 0, stream>>>(logits, G, S, E, C, expert, gate, slot,
                                                       tos, stats);
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

template <int kVec>
__global__ void __launch_bounds__(kCopyThreads) dispatch_kernel(
    const void* __restrict__ x, const int* __restrict__ token_of_slot, void* __restrict__ out,
    int G, int S, int C, int D, int x_dt, int out_dt, long long n_pieces) {
  const int per_row = D / kVec;
  for (long long i = (long long)blockIdx.x * kCopyThreads + threadIdx.x; i < n_pieces;
       i += (long long)gridDim.x * kCopyThreads) {
    const long long row = i / per_row;  // (e, g, c)
    const int col = (int)(i - row * per_row) * kVec;
    const int g = (int)((row / C) % G);
    const int tok = token_of_slot[row];
    float v[kVec];
    if (tok >= 0 && tok < S) {  // anything else is an empty slot, never read
      load_vec<kVec>(x, ((long long)g * S + tok) * D + col, x_dt, v);
    } else {
#pragma unroll
      for (int k = 0; k < kVec; ++k) v[k] = 0.f;
    }
    store_vec<kVec>(out, row * D + col, out_dt, v);
  }
}

template <int kVec>
__global__ void __launch_bounds__(kCopyThreads) combine_kernel(
    const float* __restrict__ out, const int* __restrict__ slot, const float* __restrict__ gate,
    void* __restrict__ y, int E, int G, int S, int C, int D, int y_dt, long long n_pieces) {
  const int per_row = D / kVec;
  for (long long i = (long long)blockIdx.x * kCopyThreads + threadIdx.x; i < n_pieces;
       i += (long long)gridDim.x * kCopyThreads) {
    const long long row = i / per_row;  // (g, s)
    const int col = (int)(i - row * per_row) * kVec;
    const int sl = slot[row];
    float v[kVec];
    if (sl >= 0 && sl < E * C) {  // anything else is a dropped token, never read
      const int g = (int)(row / S);
      const long long src = ((long long)(sl / C) * G + g) * C + sl % C;
      load_vec<kVec>(out, src * D + col, kF32, v);
      const float gt = gate[row];
#pragma unroll
      for (int k = 0; k < kVec; ++k) v[k] = __fmul_rn(gt, v[k]);
    } else {
#pragma unroll
      for (int k = 0; k < kVec; ++k) v[k] = 0.f;
    }
    store_vec<kVec>(y, row * D + col, y_dt, v);
  }
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

int moe_route(const float* logits, int* expert, float* gate, int* slot, int* token_of_slot,
              float* stats, int G, int S, int E, int C, void* stream) {
  if (G <= 0 || G > 65535 || S <= 0 || E <= 0 || E > kMaxExperts || C <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  if (E <= 8) return launch_route<8>(logits, expert, gate, slot, token_of_slot, stats, G, S, E, C, st);
  if (E <= 16) return launch_route<16>(logits, expert, gate, slot, token_of_slot, stats, G, S, E, C, st);
  if (E <= 32) return launch_route<32>(logits, expert, gate, slot, token_of_slot, stats, G, S, E, C, st);
  return launch_route<64>(logits, expert, gate, slot, token_of_slot, stats, G, S, E, C, st);
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

}  // extern "C"
