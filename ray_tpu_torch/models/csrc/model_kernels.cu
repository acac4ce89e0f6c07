// Hand-written Hopper (sm_90a) kernels of the flagship transformer: its
// forward and the backward of its own ops.
//
// Built by ray_tpu_torch/models/kernels.py (through util/cuda_build.py) with
// one nvcc call into a shared library with a plain C interface, loaded with
// ctypes; the Python wrappers, their autograd Functions and the plain PyTorch
// versions live in kernels.py. Every entry point launches on the stream it is
// given, allocates nothing, does not synchronise, and returns
// cudaGetLastError() after its launches. Tensors are contiguous, 16-byte
// aligned, and of the dtype named by the code `dtype`: 0 float32, 1 bfloat16.
// Arithmetic is float32 throughout. Every kernel is deterministic: no
// atomics, and every sum is taken in a fixed order, so two launches on the
// same inputs give the same bits.
//
// Numerics: the kernels are held to a stated tolerance against their plain
// versions, not to bit identity, so this source is built without
// --fmad=false (the scheduler's source keeps it): nvcc may contract a
// product into a sum, which the dot products need for the FMA rate. Where
// the reference rounds each step on its own (the logits' scale, exp's
// argument, the softmax and its gradient, RoPE's rotation, the norm's
// gradient) the source spells it out with __fmul_rn / __fadd_rn / __fsub_rn
// / __fdiv_rn, which are never contracted, so a forward and the backward
// that recomputes it get the same bits. Never fast math: expf, cosf, sinf
// and IEEE division, not the __expf / __cosf / __sinf intrinsics (RoPE's
// angles reach 2 047 rad at the flagship's sequence length, where the
// intrinsics are wrong).
//
// Kernels:
//   K8  model_attention     replaces ray_tpu/models/transformer.py
//                           _attention (:113-124) in float32, and
//                           reference_attention in both dtypes: as
//                           ring_attention.py _ring_attention_local on one
//                           device computes it, online softmax from o = 0,
//                           m = -1e30, l = 0 over every KV tile, then o /
//                           max(l, 1e-30) cast to q's dtype; one pass over
//                           the key tiles. In float32 rounding the
//                           probabilities is the identity, so this is also
//                           _attention there. bf16 with the probabilities
//                           rounded before P·V (the forward's and the train
//                           step's path) is the tensor-core kernel of
//                           attention_sm90.cu, which kernels.py routes to.
//                           The whole form writes each row's m and l ([B, H,
//                           Sq] f32) when given buffers: the backward
//                           recomputes p from them.
//       model_block_update  replaces ray_tpu/parallel/ring_attention.py
//                           _block_update (:41-69): (o, m, l) updated by one
//                           KV block at offsets q_off, k_off, f32 state.
//       Bound: at the flagship's shapes (B 8, S 2 048, H 8, Dh 64) causal
//       QK^T and PV are 34.4 GFLOP against 33.6 MB of q, k, v, o in bf16,
//       ~1 000 operations a byte: bound by operations (989 TFLOP/s bf16 on
//       the tensor cores, 67 TFLOP/s f32 on the CUDA cores). Design: one
//       256-thread block per (b, h, 64-query tile); the Q tile and each
//       64-key K/V tile are staged in shared memory as f32 (rows padded to
//       an odd number of 16-byte units, so the float4 reads of the two
//       products are free of bank conflicts); each thread holds a 4 x 4
//       block of the logits and 4 rows x Dh/16 columns of o, and its rows'
//       m and l, in registers; row max and sum go through warp shuffles
//       over the 16 threads of a row; P goes through shared memory to the
//       PV product. Causal tiles above the diagonal are never loaded, and
//       the heaviest query tiles are scheduled first. This is the CUDA-core
//       form, for float32 (whose products the reference takes in full
//       float32: TF32 would lose the float32 golden's 1e-3) and the
//       unrounded bf16 form; the rounded bf16 form is attention_sm90.cu's.
//   K8' model_attention_bwd replaces, in float32 (bf16: attention_sm90.cu),
//                           the gradient of _attention that
//                           jax.value_and_grad(loss_fn) forms
//                           (ray_tpu/parallel/tpu_train.py:78), with the
//                           roundings of its jaxpr: e = exp(s - m), p = e / l,
//                           dP = dO·V^T rounded to the dtype, Dt = sum_j
//                           (dP * (1 / (l * l))) * e, dS = ((dP / l) - Dt) *
//                           e, zero where masked, times the scale; dV =
//                           round(P)^T·dO, dQ = dS·K and dK = dS^T·Q, each
//                           summed in f32 and rounded once. Bound: 5 causal
//                           products, 86 GFLOP at the flagship's shapes,
//                           against 67 MB of q, k, v, dO, dq, dk, dv:
//                           operations. Design: K8's tiles and threads, two
//                           launches. Launch 1, query-tile-major: two sweeps
//                           over the visible key tiles of a query tile, the
//                           first for Dt (written to a [B, H, Sq] buffer),
//                           the second for dS through shared memory into dQ
//                           held in registers. Launch 2, key-tile-major: the
//                           K/V tile stays in shared memory while the query
//                           tiles on and below the diagonal stream past; p
//                           and dS are recomputed transposed ([key, query])
//                           from m, l and Dt, and dK and dV are held in
//                           registers. No atomics: each output row is
//                           written by one block.
//   K10a model_rmsnorm      replaces transformer.py _rmsnorm (:93-95):
//                           (x * rsqrt(mean(x_f32^2) + 1e-6)).astype(x.dtype)
//                           * scale.astype(x.dtype). Bound by bytes (each
//                           row read and written once). Design: one warp
//                           per row, float4 / 4 x bf16 loads, f32 sum of
//                           squares by shuffles; the second read of the row
//                           hits L1.
//   K10a' model_rmsnorm_bwd replaces the gradient of _rmsnorm, with its
//                           jaxpr's roundings: dn = round(dy * round(scale)),
//                           dx = round(round(dn * r) + round(((sum(x * dn) *
//                           (-0.5 * r / j)) / D) * (2 x))) with j = mean(x^2)
//                           + 1e-6 and r = rsqrt(j); dscale = the column sum
//                           of round(round(x * r) * dy), taken in f32 and
//                           rounded once to the dtype. Bound by bytes (x and
//                           dy read, dx written). Design: one cooperative
//                           launch of as many blocks as the card holds; a
//                           warp a row at a time, the row held in registers
//                           (D <= 1024) across its sums and dx, the lane's
//                           dscale sums in registers over its warp's rows;
//                           each block's partial row, a grid-wide barrier,
//                           then the partial rows summed column by column
//                           in a fixed order (rmsnorm_bwd_kernel below).
//   K10b model_rope_split   replaces transformer.py _rope (:98-110) on q
//                           and k with the qkv split of _layer (:132-138):
//                           qkv [B, S, 3D] -> q, k (rotated), v as
//                           [B, S, H, Dh]. Bound by bytes (qkv read once,
//                           q, k, v written once). Two forms, picked by
//                           model_rope_split from the shape and pointers.
//                           Rows form (a half-head of whole 16-byte vectors,
//                           pointers 16-byte aligned: the forward's shapes):
//                           a block takes 8 (b, s) rows, computes each row's
//                           cos and sin once into shared memory (frequency
//                           and angle in f32 as the reference does, rounded
//                           to x's dtype), then rotates 16-byte vectors of
//                           x1 with their x2 partners for q and k and copies
//                           v in 16-byte vectors. Scalar form (any other
//                           even Dh, or a misaligned view): one block per
//                           (b, s) row, one thread per (head, i < Dh/2)
//                           pair computing its own cos and sin. The same
//                           roundings in both, so the same bits.
//   K10b' model_rope_split_bwd replaces the gradient of _rope and the split:
//                           dq, dk, dv [B, S, H, Dh] -> dqkv [B, S, 3D] with
//                           dx1 = round(round(dy2 sin) + round(dy1 cos)),
//                           dx2 = round(round(dy2 cos) - round(dy1 sin)), as
//                           the jaxpr rounds them; dv passes through. Bound
//                           by bytes (dq, dk, dv read once, dqkv written
//                           once). K10b's two forms with the roles swapped,
//                           picked by model_rope_split_bwd by K10b's rule
//                           over dq, dk, dv and dqkv. Rows form
//                           (rope_split_bwd_rows_kernel<DT>; the train
//                           step's shapes): 8 (b, s) rows a block, each
//                           row's cos and sin once in shared memory, then
//                           16-byte vectors of dy1 with their dy2 partners
//                           from dq and dk rotated into dqkv's q and k
//                           thirds, dv copied into the v third in 16-byte
//                           words. Scalar form (other head widths, a
//                           misaligned view): one block per (b, s) row, one
//                           thread per pair computing its own cos and sin.
//                           The same roundings in both, so the same bits.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kF32 = 0;
constexpr int kBF16 = 1;
constexpr float kNegInf = -1e30f;  // _NEG_INF of ring_attention.py
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float load1(const void* p, long long i, int dt) {
  return dt == kBF16 ? __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(p)[i])
                     : reinterpret_cast<const float*>(p)[i];
}

// Four consecutive elements from index i (a multiple of 4) as float32.
__device__ __forceinline__ float4 load4(const void* p, long long i, int dt) {
  if (dt == kBF16) {
    const uint2 u = *reinterpret_cast<const uint2*>(
        reinterpret_cast<const __nv_bfloat16*>(p) + i);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    return make_float4(a.x, a.y, b.x, b.y);
  }
  return *reinterpret_cast<const float4*>(reinterpret_cast<const float*>(p) + i);
}

__device__ __forceinline__ void store1(void* p, long long i, float v, int dt) {
  if (dt == kBF16) {
    reinterpret_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
  } else {
    reinterpret_cast<float*>(p)[i] = v;
  }
}

// v rounded to the dtype (round to nearest even), as a cast there and back.
__device__ __forceinline__ float round_to(float v, int dt) {
  return dt == kBF16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

// ------------------------------------------------------------------ K8

constexpr int kBQ = 64;           // query rows a block
constexpr int kBK = 64;           // keys a tile
constexpr int kAttnThreads = 256; // 16 x 16: ty picks rows, tx columns
constexpr int kMaxDh = 128;
constexpr int kMaxNj = kMaxDh / 16;  // o columns a thread at most
constexpr int kLdp = kBK + 4;        // P row stride (floats)

struct AttnArgs {
  const void* q;
  const void* k;
  const void* v;
  const float* o_in;  // block form: state in; whole form: unused
  const float* m_in;
  const float* l_in;
  float* o_out;       // block form: state out (may alias the state in)
  float* m_out;       // block form: state out; whole form: row stats, or null
  float* l_out;
  void* out;          // whole form: the attention in q's dtype
  int B, Sq, Sk, H, Dh;
  long long q_off, k_off;
  int causal;
  float scale;
  int dtype;
};

__host__ __device__ constexpr int attn_smem_floats(int dh) {
  return 2 * kBQ * (dh + 4) + kBK * dh + kBQ * kLdp;
}

// s[i][j] += A[ra + 16 i] . Bt[rb + 16 j] over Dh, rows of stride ld in
// shared memory: the logits (and, in the backward, dO·V^T) of a thread's
// 4 x 4 block. One summation order for every kernel of this file, so the
// backward recomputes the forward's logits bit for bit.
__device__ __forceinline__ void dot_tile(float (&s)[4][4], const float* A, const float* Bt,
                                         int ra, int rb, int ld, int Dh) {
  for (int d = 0; d < Dh; d += 4) {
    float4 qa[4];
    float4 kb[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) qa[i] = *reinterpret_cast<const float4*>(A + (ra + 16 * i) * ld + d);
#pragma unroll
    for (int j = 0; j < 4; ++j) kb[j] = *reinterpret_cast<const float4*>(Bt + (rb + 16 * j) * ld + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        s[i][j] += qa[i].x * kb[j].x + qa[i].y * kb[j].y + qa[i].z * kb[j].z + qa[i].w * kb[j].w;
  }
}

// The softmax weight of one logit as _attention's softmax computes it:
// exp(s * scale - m), each step rounded on its own; 0 for a masked key.
__device__ __forceinline__ float softmax_num(float s, float scale, float m, bool live) {
  return live ? expf(__fsub_rn(__fmul_rn(s, scale), m)) : 0.f;
}

// Rows [r0, r0 + 64) of x [*, H, Dh] at head h, as f32, into shared memory
// with row stride ld; rows at or past n are zeros.
__device__ __forceinline__ void stage_rows(float* dst, const void* x, int b, int r0, int n,
                                           int H, int h, int Dh, int ld, int dt, int tid) {
  const int nd4 = Dh / 4;
  for (int idx = tid; idx < 64 * nd4; idx += kAttnThreads) {
    const int r = idx / nd4;
    const int d = (idx % nd4) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < n) val = load4(x, ((long long)(b * n + r0 + r) * H + h) * Dh + d, dt);
    *reinterpret_cast<float4*>(dst + r * ld + d) = val;
  }
}

// Thread (ty, tx) owns query rows ty + 16 i (i < 4) of the tile: logits
// columns tx + 16 j (j < 4) of each key tile, and o columns tx + 16 jj
// (jj < Dh / 16).
template <bool kWhole>
__global__ void __launch_bounds__(kAttnThreads, 2) attention_kernel(const AttnArgs a) {
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  const int Dh = a.Dh;
  const int ldq = Dh + 4;  // Dh / 4 + 1 16-byte units: odd, conflict-free
  float* const Qs = smem;
  float* const Ks = Qs + kBQ * ldq;
  float* const Vs = Ks + kBK * ldq;
  float* const Ps = Vs + kBK * Dh;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int n_qt = (a.Sq + kBQ - 1) / kBQ;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * kBQ;  // heaviest tiles first
  const int bh = blockIdx.y;
  const int b = bh / a.H;
  const int h = bh % a.H;
  const int nd4 = Dh / 4;
  const int nj = Dh / 16;

  stage_rows(Qs, a.q, b, q0, a.Sq, a.H, h, Dh, ldq, a.dtype, tid);

  float o[4][kMaxNj];
  float m[4];
  float l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < kMaxNj; ++jj) o[i][jj] = 0.f;
    if (!kWhole && row < a.Sq) {
      m[i] = a.m_in[(long long)bh * a.Sq + row];
      l[i] = a.l_in[(long long)bh * a.Sq + row];
      const long long ob = ((long long)(b * a.Sq + row) * a.H + h) * Dh;
#pragma unroll
      for (int jj = 0; jj < kMaxNj; ++jj) {
        if (jj < nj) o[i][jj] = a.o_in[ob + tx + 16 * jj];
      }
    }
  }

  // Key tiles with at least one key some row of this tile may see. A tile
  // wholly above the diagonal leaves (o, m, l) as they are (m >= -1e30).
  const int q_last = min(q0 + kBQ - 1, a.Sq - 1);
  const int n_kt = (a.Sk + kBK - 1) / kBK;
  int kt_end = n_kt;
  if (a.causal) {
    const long long lim = a.q_off + q_last - a.k_off;  // last visible key
    kt_end = lim < 0 ? 0 : (int)min((long long)n_kt, lim / kBK + 1);
  }

  for (int kt = 0; kt < kt_end; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the last tile's readers are done; Q is stored
    for (int idx = tid; idx < kBK * nd4; idx += kAttnThreads) {
      const int r = idx / nd4;
      const int d = (idx % nd4) * 4;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 vv = kv;
      if (k0 + r < a.Sk) {
        const long long off = ((long long)(b * a.Sk + k0 + r) * a.H + h) * Dh + d;
        kv = load4(a.k, off, a.dtype);
        vv = load4(a.v, off, a.dtype);
      }
      *reinterpret_cast<float4*>(Ks + r * ldq + d) = kv;
      *reinterpret_cast<float4*>(Vs + r * Dh + d) = vv;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    dot_tile(s, Qs, Ks, ty, tx, ldq, Dh);

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long q_pos = a.q_off + q0 + ty + 16 * i;
      unsigned live = 0;  // bit j: key in range and not masked
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        if (col < a.Sk && !(a.causal && q_pos < a.k_off + col)) live |= 1u << j;
      }
      float rmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        if (col >= a.Sk) continue;  // past the ragged edge: not a key
        const float x = (live >> j) & 1u ? __fmul_rn(s[i][j], a.scale) : kNegInf;
        rmax = fmaxf(rmax, x);
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1) rmax = fmaxf(rmax, __shfl_xor_sync(kFull, rmax, off));
      const float m_new = fmaxf(m[i], rmax);
      const float corr = expf(m[i] - m_new);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // masked keys weigh 0 (the reference's pmask), even when the whole
        // row is masked and exp(-1e30 - (-1e30)) would be 1
        const float p = softmax_num(s[i][j], a.scale, m_new, (live >> j) & 1u);
        s[i][j] = p;
        rsum += p;
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1) rsum += __shfl_xor_sync(kFull, rsum, off);
      l[i] = l[i] * corr + rsum;
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < kMaxNj; ++jj) o[i][jj] *= corr;
#pragma unroll
      for (int j = 0; j < 4; ++j) Ps[(ty + 16 * i) * kLdp + tx + 16 * j] = s[i][j];
    }
    __syncthreads();

    const int k_len = min(kBK, a.Sk - k0);
    for (int kk = 0; kk < k_len; kk += 4) {
      float4 p4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p4[i] = *reinterpret_cast<const float4*>(Ps + (ty + 16 * i) * kLdp + kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* vrow = Vs + (kk + u) * Dh + tx;
        float vv[kMaxNj];
#pragma unroll
        for (int jj = 0; jj < kMaxNj; ++jj) vv[jj] = jj < nj ? vrow[16 * jj] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = u == 0 ? p4[i].x : u == 1 ? p4[i].y : u == 2 ? p4[i].z : p4[i].w;
#pragma unroll
          for (int jj = 0; jj < kMaxNj; ++jj) o[i][jj] += p * vv[jj];
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= a.Sq) continue;
    const long long ob = ((long long)(b * a.Sq + row) * a.H + h) * Dh;
    if (kWhole) {
      const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int jj = 0; jj < kMaxNj; ++jj) {
        if (jj < nj) store1(a.out, ob + tx + 16 * jj, o[i][jj] / den, a.dtype);
      }
      if (a.m_out != nullptr && tx == 0) {
        a.m_out[(long long)bh * a.Sq + row] = m[i];
        a.l_out[(long long)bh * a.Sq + row] = l[i];
      }
    } else {
#pragma unroll
      for (int jj = 0; jj < kMaxNj; ++jj) {
        if (jj < nj) a.o_out[ob + tx + 16 * jj] = o[i][jj];
      }
      if (tx == 0) {
        a.m_out[(long long)bh * a.Sq + row] = m[i];
        a.l_out[(long long)bh * a.Sq + row] = l[i];
      }
    }
  }
}

int check_attention_shape(int B, int Sq, int Sk, int H, int Dh) {
  if (Dh % 16 != 0 || Dh <= 0 || Dh > kMaxDh || Sq <= 0 || Sk <= 0 || B <= 0 || H <= 0 ||
      (long long)B * H > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  return 0;
}

template <bool kWhole>
int launch_attention(const AttnArgs& a, cudaStream_t stream) {
  if (int rc = check_attention_shape(a.B, a.Sq, a.Sk, a.H, a.Dh)) return rc;
  const int smem = attn_smem_floats(a.Dh) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(attention_kernel<kWhole>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         attn_smem_floats(kMaxDh) * (int)sizeof(float));
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.Sq + kBQ - 1) / kBQ, a.B * a.H);
  attention_kernel<kWhole><<<grid, kAttnThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------------ K8'

struct AttnBwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* m;  // [B, H, Sq]: the forward's row max and sum
  const float* l;
  float* dsum;     // [B, H, Sq]: Dt of each row, launch 1 -> launch 2
  void* dq;
  void* dk;
  void* dv;
  int B, Sq, Sk, H, Dh;
  int causal;
  float scale;
  int dtype;
};

// Launch 1: four f32 tiles of 64 rows (Q, dO, K, V) and one of dS.
__host__ __device__ constexpr int bwd_dq_smem_floats(int dh) {
  return 4 * 64 * (dh + 4) + kBQ * kLdp;
}

// Launch 2: four f32 tiles (K, V, Q, dO), two [key, query] tiles (round(P),
// dS) and the query rows' m, l, Dt.
__host__ __device__ constexpr int bwd_dkv_smem_floats(int dh) {
  return 4 * 64 * (dh + 4) + 2 * kBK * kLdp + 3 * kBQ;
}

// Thread (ty, tx): query rows ty + 16 i, key columns tx + 16 j, and dQ
// columns tx + 16 jj (jj < kNj = Dh / 16).
template <int kNj>
__global__ void __launch_bounds__(kAttnThreads, 2) attention_bwd_dq_kernel(const AttnBwdArgs a) {
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  constexpr int Dh = 16 * kNj;
  constexpr int ldq = Dh + 4;
  float* const Qs = smem;
  float* const dOs = Qs + 64 * ldq;
  float* const Ks = dOs + 64 * ldq;
  float* const Vs = Ks + 64 * ldq;
  float* const Ps = Vs + 64 * ldq;  // dS [query, key]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int n_qt = (a.Sq + kBQ - 1) / kBQ;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * kBQ;  // heaviest tiles first
  const int bh = blockIdx.y;
  const int b = bh / a.H;
  const int h = bh % a.H;

  stage_rows(Qs, a.q, b, q0, a.Sq, a.H, h, Dh, ldq, a.dtype, tid);
  stage_rows(dOs, a.dout, b, q0, a.Sq, a.H, h, Dh, ldq, a.dtype, tid);

  float mrow[4], lrow[4], rinv2[4], dt[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    const bool in = row < a.Sq;
    mrow[i] = in ? a.m[(long long)bh * a.Sq + row] : 0.f;
    lrow[i] = in ? a.l[(long long)bh * a.Sq + row] : 1.f;
    rinv2[i] = __fdiv_rn(1.f, __fmul_rn(lrow[i], lrow[i]));  // integer_pow(l, -2)
    dt[i] = 0.f;
  }
  const int q_last = min(q0 + kBQ - 1, a.Sq - 1);
  const int n_kt = (a.Sk + kBK - 1) / kBK;
  const int kt_end = a.causal ? min(n_kt, q_last / kBK + 1) : n_kt;

  float acc[4][kNj];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < kNj; ++jj) acc[i][jj] = 0.f;

  // sweep 0: Dt; sweep 1: dS and dQ
  for (int sweep = 0; sweep < 2; ++sweep) {
    for (int kt = 0; kt < kt_end; ++kt) {
      const int k0 = kt * kBK;
      __syncthreads();
      stage_rows(Ks, a.k, b, k0, a.Sk, a.H, h, Dh, ldq, a.dtype, tid);
      stage_rows(Vs, a.v, b, k0, a.Sk, a.H, h, Dh, ldq, a.dtype, tid);
      __syncthreads();
      float s[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
      dot_tile(s, Qs, Ks, ty, tx, ldq, Dh);
      dot_tile(dp, dOs, Vs, ty, tx, ldq, Dh);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = q0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = k0 + tx + 16 * j;
          const bool live = row < a.Sq && col < a.Sk && !(a.causal && row < col);
          const float e = softmax_num(s[i][j], a.scale, mrow[i], live);
          const float dpr = round_to(dp[i][j], a.dtype);
          if (sweep == 0) {
            dt[i] += __fmul_rn(__fmul_rn(dpr, rinv2[i]), e);
          } else {
            const float ds = live ? __fmul_rn(__fmul_rn(__fsub_rn(__fdiv_rn(dpr, lrow[i]), dt[i]), e),
                                              a.scale)
                                  : 0.f;
            Ps[(ty + 16 * i) * kLdp + tx + 16 * j] = ds;
          }
        }
      }
      if (sweep == 0) continue;
      __syncthreads();
      const int k_len = min(kBK, a.Sk - k0);
      for (int kk = 0; kk < k_len; kk += 4) {
        float4 p4[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) p4[i] = *reinterpret_cast<const float4*>(Ps + (ty + 16 * i) * kLdp + kk);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float* krow = Ks + (kk + u) * ldq + tx;
          float kv[kNj];
#pragma unroll
          for (int jj = 0; jj < kNj; ++jj) kv[jj] = krow[16 * jj];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = u == 0 ? p4[i].x : u == 1 ? p4[i].y : u == 2 ? p4[i].z : p4[i].w;
#pragma unroll
            for (int jj = 0; jj < kNj; ++jj) acc[i][jj] += p * kv[jj];
          }
        }
      }
    }
    if (sweep == 0) {
      // Dt over the 16 threads of a row: a butterfly, so every thread of
      // the row holds the same bits
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int off = 1; off < 16; off <<= 1) dt[i] += __shfl_xor_sync(kFull, dt[i], off);
        const int row = q0 + ty + 16 * i;
        if (tx == 0 && row < a.Sq) a.dsum[(long long)bh * a.Sq + row] = dt[i];
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= a.Sq) continue;
    const long long ob = ((long long)(b * a.Sq + row) * a.H + h) * Dh;
#pragma unroll
    for (int jj = 0; jj < kNj; ++jj) store1(a.dq, ob + tx + 16 * jj, acc[i][jj], a.dtype);
  }
}

// Thread (ty, tx): key rows ty + 16 i, query columns tx + 16 j, and dK / dV
// columns tx + 16 jj.
template <int kNj>
__global__ void __launch_bounds__(kAttnThreads, 1) attention_bwd_dkv_kernel(const AttnBwdArgs a) {
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  constexpr int Dh = 16 * kNj;
  constexpr int ldq = Dh + 4;
  float* const Ks = smem;
  float* const Vs = Ks + 64 * ldq;
  float* const Qs = Vs + 64 * ldq;
  float* const dOs = Qs + 64 * ldq;
  float* const P1 = dOs + 64 * ldq;  // round(P) [key, query]
  float* const P2 = P1 + kBK * kLdp; // dS [key, query]
  float* const ms = P2 + kBK * kLdp;
  float* const ls = ms + kBQ;
  float* const ds_row = ls + kBQ;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int k0 = blockIdx.x * kBK;  // heaviest (most query tiles) first
  const int bh = blockIdx.y;
  const int b = bh / a.H;
  const int h = bh % a.H;
  const int n_qt = (a.Sq + kBQ - 1) / kBQ;
  const int qt_begin = a.causal ? min(n_qt, k0 / kBQ) : 0;

  stage_rows(Ks, a.k, b, k0, a.Sk, a.H, h, Dh, ldq, a.dtype, tid);
  stage_rows(Vs, a.v, b, k0, a.Sk, a.H, h, Dh, ldq, a.dtype, tid);

  float dk[4][kNj], dv[4][kNj];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < kNj; ++jj) dk[i][jj] = dv[i][jj] = 0.f;

  for (int qt = qt_begin; qt < n_qt; ++qt) {
    const int q0 = qt * kBQ;
    __syncthreads();
    stage_rows(Qs, a.q, b, q0, a.Sq, a.H, h, Dh, ldq, a.dtype, tid);
    stage_rows(dOs, a.dout, b, q0, a.Sq, a.H, h, Dh, ldq, a.dtype, tid);
    if (tid < kBQ) {
      const int row = q0 + tid;
      const bool in = row < a.Sq;
      ms[tid] = in ? a.m[(long long)bh * a.Sq + row] : 0.f;
      ls[tid] = in ? a.l[(long long)bh * a.Sq + row] : 1.f;
      ds_row[tid] = in ? a.dsum[(long long)bh * a.Sq + row] : 0.f;
    }
    __syncthreads();
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    // the same products as launch 1 and the forward, transposed: K·Q^T and
    // V·dO^T (each term q_d k_d, summed in the same order)
    dot_tile(s, Ks, Qs, ty, tx, ldq, Dh);
    dot_tile(dp, Vs, dOs, ty, tx, ldq, Dh);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = k0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qc = tx + 16 * j;
        const int query = q0 + qc;
        const bool live = query < a.Sq && key < a.Sk && !(a.causal && query < key);
        const float e = softmax_num(s[i][j], a.scale, ms[qc], live);
        const float pb = round_to(__fdiv_rn(e, ls[qc]), a.dtype);
        const float dpr = round_to(dp[i][j], a.dtype);
        const float ds = live ? __fmul_rn(__fmul_rn(__fsub_rn(__fdiv_rn(dpr, ls[qc]), ds_row[qc]), e),
                                          a.scale)
                              : 0.f;
        P1[(ty + 16 * i) * kLdp + qc] = pb;
        P2[(ty + 16 * i) * kLdp + qc] = ds;
      }
    }
    __syncthreads();
    const int q_len = min(kBQ, a.Sq - q0);
    for (int qq = 0; qq < q_len; qq += 4) {
      float4 p4[4], d4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        p4[i] = *reinterpret_cast<const float4*>(P1 + (ty + 16 * i) * kLdp + qq);
        d4[i] = *reinterpret_cast<const float4*>(P2 + (ty + 16 * i) * kLdp + qq);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* orow = dOs + (qq + u) * ldq + tx;
        const float* qrow = Qs + (qq + u) * ldq + tx;
        float ov[kNj], qv[kNj];
#pragma unroll
        for (int jj = 0; jj < kNj; ++jj) {
          ov[jj] = orow[16 * jj];
          qv[jj] = qrow[16 * jj];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = u == 0 ? p4[i].x : u == 1 ? p4[i].y : u == 2 ? p4[i].z : p4[i].w;
          const float d = u == 0 ? d4[i].x : u == 1 ? d4[i].y : u == 2 ? d4[i].z : d4[i].w;
#pragma unroll
          for (int jj = 0; jj < kNj; ++jj) {
            dv[i][jj] += p * ov[jj];
            dk[i][jj] += d * qv[jj];
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= a.Sk) continue;
    const long long ob = ((long long)(b * a.Sk + key) * a.H + h) * Dh;
#pragma unroll
    for (int jj = 0; jj < kNj; ++jj) {
      store1(a.dk, ob + tx + 16 * jj, dk[i][jj], a.dtype);
      store1(a.dv, ob + tx + 16 * jj, dv[i][jj], a.dtype);
    }
  }
}

template <int kNj>
int launch_attention_bwd(const AttnBwdArgs& a, cudaStream_t stream) {
  constexpr int Dh = 16 * kNj;
  const int smem1 = bwd_dq_smem_floats(Dh) * (int)sizeof(float);
  const int smem2 = bwd_dkv_smem_floats(Dh) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(attention_bwd_dq_kernel<kNj>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem1);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(attention_bwd_dkv_kernel<kNj>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem2);
  if (err != cudaSuccess) return (int)err;
  attention_bwd_dq_kernel<kNj><<<dim3((a.Sq + kBQ - 1) / kBQ, a.B * a.H), kAttnThreads, smem1,
                                 stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  attention_bwd_dkv_kernel<kNj><<<dim3((a.Sk + kBK - 1) / kBK, a.B * a.H), kAttnThreads, smem2,
                                  stream>>>(a);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------------ K10a

constexpr int kNormThreads = 256;  // 8 rows at a time a block, one warp each

// sum of x_f32^2 over a row, by one warp (every lane gets the same bits)
__device__ __forceinline__ float row_sumsq(const void* x, long long base, int D, int lane, int dt) {
  float ss = 0.f;
  for (int c = lane * 4; c < D; c += 128) {
    const float4 v = load4(x, base + c, dt);
    ss += v.x * v.x + v.y * v.y + v.z * v.z + v.w * v.w;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(kFull, ss, off);
  return ss;
}

__global__ void __launch_bounds__(kNormThreads) rmsnorm_kernel(
    const void* x, const float* scale, void* out, int rows, int D, int dt) {
  const int row = (blockIdx.x * kNormThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const long long base = (long long)row * D;
  const float r = rsqrtf(row_sumsq(x, base, D, lane, dt) / (float)D + 1e-6f);
  for (int c = lane * 4; c < D; c += 128) {
    const float4 v = load4(x, base + c, dt);
    const float4 g = *reinterpret_cast<const float4*>(scale + c);
    // (x * r).astype(x.dtype) * scale.astype(x.dtype), each rounded
    store1(out, base + c + 0, round_to(v.x * r, dt) * round_to(g.x, dt), dt);
    store1(out, base + c + 1, round_to(v.y * r, dt) * round_to(g.y, dt), dt);
    store1(out, base + c + 2, round_to(v.z * r, dt) * round_to(g.z, dt), dt);
    store1(out, base + c + 3, round_to(v.w * r, dt) * round_to(g.w, dt), dt);
  }
}

// ------------------------------------------------------------------ K10a'

constexpr int kNormBwdWarps = 8;  // a block; a warp takes one row at a time
constexpr int kNormBwdThreads = 32 * kNormBwdWarps;
constexpr int kNormBwdRegD = 1024;  // widest row held in registers

// K10a' holds four consecutive elements of a row as they are stored: two
// words of bf16 pairs (bf16) or four float32 words; element u as float32.
template <int DT>
constexpr int kQuadWords = DT == kBF16 ? 2 : 4;

template <int DT>
__device__ __forceinline__ float quad_elem(const uint32_t (&w)[kQuadWords<DT>], int u) {
  if constexpr (DT == kBF16)
    return __uint_as_float(u & 1 ? (w[u >> 1] & 0xffff0000u) : (w[u >> 1] << 16));
  else
    return __uint_as_float(w[u]);
}

// Elements [i, i + 4) of p (i a multiple of 4), or zeros where !in.
template <int DT>
__device__ __forceinline__ void quad_load(const void* p, long long i, bool in,
                                          uint32_t (&w)[kQuadWords<DT>]) {
  if constexpr (DT == kBF16) {
    const uint2 v = in ? *reinterpret_cast<const uint2*>(
                             reinterpret_cast<const __nv_bfloat16*>(p) + i)
                       : make_uint2(0u, 0u);
    w[0] = v.x;
    w[1] = v.y;
  } else {
    const uint4 v = in ? *reinterpret_cast<const uint4*>(reinterpret_cast<const float*>(p) + i)
                       : make_uint4(0u, 0u, 0u, 0u);
    w[0] = v.x;
    w[1] = v.y;
    w[2] = v.z;
    w[3] = v.w;
  }
}

// a and b rounded to the dtype (to nearest even), as a cast there and back;
// in bf16 one conversion of the pair, returned packed in *packed
template <int DT>
__device__ __forceinline__ void round_pair(float& a, float& b, uint32_t* packed = nullptr) {
  if constexpr (DT == kBF16) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    const uint32_t u = *reinterpret_cast<const uint32_t*>(&h);
    a = __uint_as_float(u << 16);
    b = __uint_as_float(u & 0xffff0000u);
    if (packed) *packed = u;
  }
}

// round(scale) of four columns, held as the row's elements are
template <int DT>
__device__ __forceinline__ void norm_bwd_scale(const float* scale, int c, bool in,
                                               uint32_t (&w)[kQuadWords<DT>]) {
  const float4 v =
      in ? *reinterpret_cast<const float4*>(scale + c) : make_float4(0.f, 0.f, 0.f, 0.f);
  float s[4] = {v.x, v.y, v.z, v.w};
  if constexpr (DT == kBF16) {
    round_pair<DT>(s[0], s[1], &w[0]);
    round_pair<DT>(s[2], s[3], &w[1]);
  } else {
#pragma unroll
    for (int u = 0; u < 4; ++u) w[u] = __float_as_uint(s[u]);
  }
}

// One row's sums over four columns, the lane's share in column order:
// x_f32^2 (K10a's) and x * dn with dn = round(dy * round(scale)) (sr),
// which is returned as it is held (dnw).
template <int DT>
__device__ __forceinline__ void norm_bwd_sums(const uint32_t (&xw)[kQuadWords<DT>],
                                              const uint32_t (&gw)[kQuadWords<DT>],
                                              const uint32_t (&sr)[kQuadWords<DT>],
                                              uint32_t (&dnw)[kQuadWords<DT>], float& ss,
                                              float& ba) {
  float x[4], dn[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    x[u] = quad_elem<DT>(xw, u);
    dn[u] = __fmul_rn(quad_elem<DT>(gw, u), quad_elem<DT>(sr, u));
  }
  ss += x[0] * x[0] + x[1] * x[1] + x[2] * x[2] + x[3] * x[3];
  if constexpr (DT == kBF16) {
    round_pair<DT>(dn[0], dn[1], &dnw[0]);
    round_pair<DT>(dn[2], dn[3], &dnw[1]);
  } else {
#pragma unroll
    for (int u = 0; u < 4; ++u) dnw[u] = __float_as_uint(dn[u]);
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) ba += x[u] * dn[u];
}

// Four columns of dx, round(round(dn * r) + round(coef * (2 x))), stored to
// dx at i, and their dscale terms round(round(x * r) * dy) added to acc.
template <int DT>
__device__ __forceinline__ void norm_bwd_cols(const uint32_t (&xw)[kQuadWords<DT>],
                                              const uint32_t (&gw)[kQuadWords<DT>],
                                              const uint32_t (&dnw)[kQuadWords<DT>], float r,
                                              float coef, float (&acc)[4], void* dx,
                                              long long i, bool in) {
  float t1[4], t2[4], n[4], x[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    x[u] = quad_elem<DT>(xw, u);
    t1[u] = __fmul_rn(quad_elem<DT>(dnw, u), r);
    t2[u] = __fmul_rn(coef, __fmul_rn(2.f, x[u]));
    n[u] = x[u] * r;
  }
#pragma unroll
  for (int u = 0; u < 4; u += 2) {
    round_pair<DT>(t1[u], t1[u + 1]);
    round_pair<DT>(t2[u], t2[u + 1]);
    round_pair<DT>(n[u], n[u + 1]);
  }
  float o[4], term[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    o[u] = __fadd_rn(t1[u], t2[u]);
    term[u] = __fmul_rn(n[u], quad_elem<DT>(gw, u));
  }
#pragma unroll
  for (int u = 0; u < 4; u += 2) round_pair<DT>(term[u], term[u + 1]);
#pragma unroll
  for (int u = 0; u < 4; ++u) acc[u] += term[u];
  if (in) {
    if constexpr (DT == kBF16) {
      const __nv_bfloat162 a = __floats2bfloat162_rn(o[0], o[1]);
      const __nv_bfloat162 b = __floats2bfloat162_rn(o[2], o[3]);
      uint2 u;
      u.x = *reinterpret_cast<const uint32_t*>(&a);
      u.y = *reinterpret_cast<const uint32_t*>(&b);
      *reinterpret_cast<uint2*>(reinterpret_cast<__nv_bfloat16*>(dx) + i) = u;
    } else {
      *reinterpret_cast<float4*>(reinterpret_cast<float*>(dx) + i) =
          make_float4(o[0], o[1], o[2], o[3]);
    }
  }
}

// The row's r = rsqrt(mean(x^2) + 1e-6) (K10a's) and dx's coefficient
// (sum(x * dn) * (-0.5 * r / j)) / D, from the lane's shares of the sums.
__device__ __forceinline__ void norm_bwd_row_terms(float ss, float ba, int D, float& r,
                                                   float& coef) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    ss += __shfl_xor_sync(kFull, ss, off);
    ba += __shfl_xor_sync(kFull, ba, off);
  }
  const float j = ss / (float)D + 1e-6f;
  r = rsqrtf(j);
  coef = __fdiv_rn(__fmul_rn(ba, __fmul_rn(-0.5f, __fdiv_rn(r, j))), (float)D);
}

// One launch: dx row by row, dscale's partial row of each block, a grid-wide
// barrier (cooperative launch: every block is resident), then dscale
// column by column over the blocks' partial rows. DT is the dtype, known at
// compile time, so that a bf16 row is held as it is stored (bf16 pairs) and
// every rounding is one conversion of a pair.
//  - Rows are dealt to the grid's warps in a fixed order (warp w of the grid
//    takes rows w, w + W, w + 2W, ...); lane l owns columns 4l + 128k.
//  - NK > 0 (D <= 128 NK <= 1024): the lane holds its columns of x and dy in
//    registers across the row's three steps (the sums, the row's r and
//    coefficient, dx), so x and dy are read once, and loads the next row's
//    while it works on this one; round(scale) of its columns and its dscale
//    sums stay in registers too, the sums over the warp's rows in row order,
//    since a lane's columns are the same on every row.
//  - NK == 0 (1024 < D <= 4096), a form chosen by the row's width: too wide
//    for registers, the lane reads its columns twice (the sums, then dx) and
//    adds its dscale terms into its warp's row of shared memory, which no
//    other warp touches.
//  - The block sums its warps' rows in warp order into its partial row.
//    After the barrier block q takes columns [32q, 32q + 32) (and q + the
//    grid, ...): warp w sums the partial rows w, w + 8, ... of the lane's
//    column in order, the block adds its warps' sums in warp order, and the
//    column is rounded once to the dtype. No atomics: two launches give the
//    same bits.
template <int NK, int DT>
__global__ void __launch_bounds__(kNormBwdThreads) rmsnorm_bwd_kernel(
    const void* x, const float* scale, const void* dy, void* dx, float* partial,
    float* dscale, int rows, int D) {
  constexpr int QW = kQuadWords<DT>;
  extern __shared__ float4 smem4[];
  float* const wrows = reinterpret_cast<float*>(smem4);  // [warps][D]
  __shared__ float s_col[kNormBwdWarps][32];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int W = gridDim.x * kNormBwdWarps;
  const int gw = blockIdx.x * kNormBwdWarps + warp;
  float* const mine = wrows + (size_t)warp * D;
  if constexpr (NK > 0) {
    uint32_t sr[NK][QW], xs[NK][QW], gs[NK][QW];
    float acc[NK][4] = {};
    const long long b0 = (long long)gw * D;
#pragma unroll
    for (int k = 0; k < NK; ++k) {
      const int c = lane * 4 + 128 * k;
      norm_bwd_scale<DT>(scale, c, c < D, sr[k]);
      quad_load<DT>(x, b0 + c, gw < rows && c < D, xs[k]);
      quad_load<DT>(dy, b0 + c, gw < rows && c < D, gs[k]);
    }
    for (int row = gw; row < rows; row += W) {
      uint32_t xn[NK][QW], gn[NK][QW], dn[NK][QW];
      const long long base = (long long)row * D, nbase = base + (long long)W * D;
      const bool more = row + W < rows;
#pragma unroll
      for (int k = 0; k < NK; ++k) {  // the next row's, in flight during this one
        const int c = lane * 4 + 128 * k;
        quad_load<DT>(x, nbase + c, more && c < D, xn[k]);
        quad_load<DT>(dy, nbase + c, more && c < D, gn[k]);
      }
      float ss = 0.f, ba = 0.f, r, coef;
#pragma unroll
      for (int k = 0; k < NK; ++k) norm_bwd_sums<DT>(xs[k], gs[k], sr[k], dn[k], ss, ba);
      norm_bwd_row_terms(ss, ba, D, r, coef);
#pragma unroll
      for (int k = 0; k < NK; ++k) {
        const int c = lane * 4 + 128 * k;
        norm_bwd_cols<DT>(xs[k], gs[k], dn[k], r, coef, acc[k], dx, base + c, c < D);
      }
#pragma unroll
      for (int k = 0; k < NK; ++k) {
#pragma unroll
        for (int q = 0; q < QW; ++q) {
          xs[k][q] = xn[k][q];
          gs[k][q] = gn[k][q];
        }
      }
    }
#pragma unroll
    for (int k = 0; k < NK; ++k) {
      const int c = lane * 4 + 128 * k;
      if (c < D)
        *reinterpret_cast<float4*>(mine + c) =
            make_float4(acc[k][0], acc[k][1], acc[k][2], acc[k][3]);
    }
  } else {
    for (int c = lane * 4; c < D; c += 128)
      *reinterpret_cast<float4*>(mine + c) = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int row = gw; row < rows; row += W) {
      const long long base = (long long)row * D;
      float ss = 0.f, ba = 0.f, r, coef;
      for (int c = lane * 4; c < D; c += 128) {
        uint32_t xs[QW], gs[QW], sr[QW], dn[QW];
        quad_load<DT>(x, base + c, true, xs);
        quad_load<DT>(dy, base + c, true, gs);
        norm_bwd_scale<DT>(scale, c, true, sr);
        norm_bwd_sums<DT>(xs, gs, sr, dn, ss, ba);
      }
      norm_bwd_row_terms(ss, ba, D, r, coef);
      for (int c = lane * 4; c < D; c += 128) {
        uint32_t xs[QW], gs[QW], sr[QW], dn[QW];
        float ss2 = 0.f, ba2 = 0.f;  // dn again, the sums unused
        quad_load<DT>(x, base + c, true, xs);
        quad_load<DT>(dy, base + c, true, gs);
        norm_bwd_scale<DT>(scale, c, true, sr);
        norm_bwd_sums<DT>(xs, gs, sr, dn, ss2, ba2);
        const float4 t = *reinterpret_cast<const float4*>(mine + c);
        float a4[4] = {t.x, t.y, t.z, t.w};
        norm_bwd_cols<DT>(xs, gs, dn, r, coef, a4, dx, base + c, true);
        *reinterpret_cast<float4*>(mine + c) = make_float4(a4[0], a4[1], a4[2], a4[3]);
      }
    }
  }
  __syncthreads();
  // the block's partial row: its warps' rows summed in warp order
  for (int c = threadIdx.x; c < D; c += kNormBwdThreads) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kNormBwdWarps; ++w) s += wrows[(size_t)w * D + c];
    partial[(long long)blockIdx.x * D + c] = s;
  }
  cooperative_groups::this_grid().sync();
  for (int q = blockIdx.x; q * 32 < D; q += gridDim.x) {
    const int c = q * 32 + lane;
    float s = 0.f;
    if (c < D) {
#pragma unroll 8
      for (int b = warp; b < (int)gridDim.x; b += kNormBwdWarps)
        s += partial[(long long)b * D + c];
    }
    s_col[warp][lane] = s;
    __syncthreads();
    if (warp == 0 && c < D) {
      float t = 0.f;
#pragma unroll
      for (int w = 0; w < kNormBwdWarps; ++w) t += s_col[w][lane];
      dscale[c] = round_to(t, DT);
    }
    __syncthreads();
  }
}

using NormBwdKernel = void (*)(const void*, const float*, const void*, void*, float*, float*,
                               int, int);

template <int DT>
NormBwdKernel norm_bwd_kernel_of(int D) {
  if (D <= 128) return rmsnorm_bwd_kernel<1, DT>;
  if (D <= 256) return rmsnorm_bwd_kernel<2, DT>;
  if (D <= 512) return rmsnorm_bwd_kernel<4, DT>;
  if (D <= kNormBwdRegD) return rmsnorm_bwd_kernel<8, DT>;
  return rmsnorm_bwd_kernel<0, DT>;
}

// The form of K10a' for rows of D columns in the dtype: the narrowest
// register form that holds the row, else the looped one
NormBwdKernel norm_bwd_kernel_for(int D, int dt) {
  return dt == kBF16 ? norm_bwd_kernel_of<kBF16>(D) : norm_bwd_kernel_of<kF32>(D);
}

// ------------------------------------------------------------------ K10b

constexpr int kRopeThreads = 256;

// cos and sin of pair i at position pos, rounded to the dtype: freqs =
// exp(-ln(theta) * i / half), angle = pos * freq, all f32, as _rope
__device__ __forceinline__ void rope_cs_sn(float pos, int i, int half, float neg_log_theta,
                                           int dt, float& cs, float& sn) {
  const float freq = expf(__fdiv_rn(__fmul_rn(neg_log_theta, (float)i), (float)half));
  const float ang = __fmul_rn(pos, freq);
  cs = round_to(cosf(ang), dt);
  sn = round_to(sinf(ang), dt);
}

__global__ void __launch_bounds__(kRopeThreads) rope_split_kernel(
    const void* qkv, void* q, void* k, void* v, int S, int H, int Dh,
    float neg_log_theta, int dt) {
  const int row = blockIdx.x;  // (b, s)
  const int D = H * Dh;
  const int half = Dh / 2;
  const float pos = (float)(row % S);
  const long long in_base = (long long)row * 3 * D;
  const long long out_base = (long long)row * D;
  for (int p = threadIdx.x; p < H * half; p += kRopeThreads) {
    const int i = p % half;
    const int c1 = (p / half) * Dh + i;
    const int c2 = c1 + half;
    float cs, sn;
    rope_cs_sn(pos, i, half, neg_log_theta, dt, cs, sn);
#pragma unroll
    for (int sec = 0; sec < 2; ++sec) {
      void* dst = sec == 0 ? q : k;
      const float x1 = load1(qkv, in_base + sec * D + c1, dt);
      const float x2 = load1(qkv, in_base + sec * D + c2, dt);
      // x1 * cos - x2 * sin, x1 * sin + x2 * cos: every product and sum
      // rounded to the dtype, as the reference's elementwise ops round
      const float y1 = __fsub_rn(round_to(__fmul_rn(x1, cs), dt), round_to(__fmul_rn(x2, sn), dt));
      const float y2 = __fadd_rn(round_to(__fmul_rn(x1, sn), dt), round_to(__fmul_rn(x2, cs), dt));
      store1(dst, out_base + c1, y1, dt);
      store1(dst, out_base + c2, y2, dt);
    }
    store1(v, out_base + c1, load1(qkv, in_base + 2 * D + c1, dt), dt);
    store1(v, out_base + c2, load1(qkv, in_base + 2 * D + c2, dt), dt);
  }
}

// K10b's rows form, where a half-head is a whole number of 16-byte vectors
// and every pointer is 16-byte aligned (model_rope_split picks it): a block
// takes kRopeRows (b, s) rows. The rows' cos and sin, one per (row, i <
// half), are computed once into shared memory with rope_cs_sn's f32
// operations (8 times fewer than the scalar form, which computes them a
// head), then each thread rotates a 16-byte vector of x1 with its partner
// of x2 (8 bf16 or 4 f32 a load and a store) for q and k, and v is a
// straight 16-byte copy. The same roundings as the scalar form, so the
// same bits.
constexpr int kRopeRows = 8;
constexpr int kRopeMaxHalf = 256;  // the tables: 2 * 8 * 256 floats, 16 KB

template <int DT>
struct RopeVec {
  static constexpr int n = DT == kBF16 ? 8 : 4;  // elements a 16-byte vector
};

template <int DT>
__device__ __forceinline__ void load16(const void* p, long long i, float (&f)[RopeVec<DT>::n]) {
  if constexpr (DT == kBF16) {
    const uint4 u = *reinterpret_cast<const uint4*>(reinterpret_cast<const __nv_bfloat16*>(p) + i);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 t = __bfloat1622float2(h[j]);
      f[2 * j] = t.x;
      f[2 * j + 1] = t.y;
    }
  } else {
    const float4 u = *reinterpret_cast<const float4*>(reinterpret_cast<const float*>(p) + i);
    f[0] = u.x;
    f[1] = u.y;
    f[2] = u.z;
    f[3] = u.w;
  }
}

template <int DT>
__device__ __forceinline__ void store16(void* p, long long i, const float (&f)[RopeVec<DT>::n]) {
  if constexpr (DT == kBF16) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int j = 0; j < 4; ++j) h[j] = __floats2bfloat162_rn(f[2 * j], f[2 * j + 1]);
    *reinterpret_cast<uint4*>(reinterpret_cast<__nv_bfloat16*>(p) + i) = u;
  } else {
    *reinterpret_cast<float4*>(reinterpret_cast<float*>(p) + i) =
        make_float4(f[0], f[1], f[2], f[3]);
  }
}

// The rows forms' table: cos and sin of each of the block's n_rows rows
// (positions (row0 + r) % S) and pairs i < half, with rope_cs_sn's f32
// operations, into s_cs and s_sn [kRopeRows][half]; ends with a barrier.
__device__ __forceinline__ void rope_rows_table(float* s_cs, float* s_sn, int row0, int n_rows,
                                                int S, int half, float neg_log_theta, int dt) {
  for (int t = threadIdx.x; t < n_rows * half; t += kRopeThreads) {
    const int r = t / half;
    rope_cs_sn((float)((row0 + r) % S), t - r * half, half, neg_log_theta, dt, s_cs[t],
               s_sn[t]);
  }
  __syncthreads();
}

template <int DT>
__global__ void __launch_bounds__(kRopeThreads) rope_split_rows_kernel(
    const void* qkv, void* q, void* k, void* v, int rows, int S, int H, int Dh,
    float neg_log_theta) {
  constexpr int VE = RopeVec<DT>::n;
  extern __shared__ float s_rope[];  // cos [kRopeRows][half], then sin
  const int half = Dh / 2;
  const int D = H * Dh;
  const int row0 = blockIdx.x * kRopeRows;
  const int n_rows = min(kRopeRows, rows - row0);
  float* s_cs = s_rope;
  float* s_sn = s_rope + kRopeRows * half;
  rope_rows_table(s_cs, s_sn, row0, n_rows, S, half, neg_log_theta, DT);
  const int hv = half / VE;     // vectors a half-head
  const int per_sec = H * hv;   // rotation items of q (or k) a row
  for (int t = threadIdx.x; t < n_rows * 2 * per_sec; t += kRopeThreads) {
    const int r = t / (2 * per_sec);
    int u = t - r * 2 * per_sec;
    const int sec = u >= per_sec;  // 0: q, 1: k
    u -= sec * per_sec;
    const int h = u / hv;
    const int i0 = (u - h * hv) * VE;  // the vector's first pair
    const long long row = row0 + r;
    const int c1 = h * Dh + i0;
    const long long in = row * 3 * D + sec * D + c1;
    float x1[VE], x2[VE], y1[VE], y2[VE];
    load16<DT>(qkv, in, x1);
    load16<DT>(qkv, in + half, x2);
    const float* cs = s_cs + r * half + i0;
    const float* sn = s_sn + r * half + i0;
#pragma unroll
    for (int e = 0; e < VE; ++e) {
      // x1 * cos - x2 * sin, x1 * sin + x2 * cos, as the scalar form
      y1[e] = __fsub_rn(round_to(__fmul_rn(x1[e], cs[e]), DT),
                        round_to(__fmul_rn(x2[e], sn[e]), DT));
      y2[e] = __fadd_rn(round_to(__fmul_rn(x1[e], sn[e]), DT),
                        round_to(__fmul_rn(x2[e], cs[e]), DT));
    }
    void* dst = sec ? k : q;
    store16<DT>(dst, row * D + c1, y1);
    store16<DT>(dst, row * D + c1 + half, y2);
  }
  const int vrow = D / VE;  // v's vectors a row
  for (int t = threadIdx.x; t < n_rows * vrow; t += kRopeThreads) {
    const int r = t / vrow;
    const long long row = row0 + r;
    const long long c = (long long)(t - r * vrow) * VE;
    const uint4* src = reinterpret_cast<const uint4*>(
        static_cast<const char*>(qkv) + (row * 3 * D + 2 * D + c) * (DT == kBF16 ? 2 : 4));
    uint4* dst = reinterpret_cast<uint4*>(static_cast<char*>(v) +
                                          (row * D + c) * (DT == kBF16 ? 2 : 4));
    *dst = *src;
  }
}

// 1 where K10b takes its rows form: a half-head of whole 16-byte vectors, no
// wider than kRopeMaxHalf, and every pointer 16-byte aligned; else 0 (the
// scalar form).
int rope_rows_form(const void* qkv, const void* q, const void* k, const void* v, int Dh,
                   int dtype) {
  const int half = Dh / 2;
  const int esize = dtype == kBF16 ? 2 : 4;
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  return (half * esize) % 16 == 0 && half <= kRopeMaxHalf && aligned(qkv) && aligned(q) &&
         aligned(k) && aligned(v);
}

// ------------------------------------------------------------------ K10b'

__global__ void __launch_bounds__(kRopeThreads) rope_split_bwd_kernel(
    const void* dq, const void* dk, const void* dv, void* dqkv, int S, int H, int Dh,
    float neg_log_theta, int dt) {
  const int row = blockIdx.x;  // (b, s)
  const int D = H * Dh;
  const int half = Dh / 2;
  const float pos = (float)(row % S);
  const long long out_base = (long long)row * 3 * D;
  const long long in_base = (long long)row * D;
  for (int p = threadIdx.x; p < H * half; p += kRopeThreads) {
    const int i = p % half;
    const int c1 = (p / half) * Dh + i;
    const int c2 = c1 + half;
    float cs, sn;
    rope_cs_sn(pos, i, half, neg_log_theta, dt, cs, sn);
#pragma unroll
    for (int sec = 0; sec < 2; ++sec) {
      const void* src = sec == 0 ? dq : dk;
      const float g1 = load1(src, in_base + c1, dt);
      const float g2 = load1(src, in_base + c2, dt);
      // dx1 = dy2 sin + dy1 cos, dx2 = dy2 cos - dy1 sin, rounded as the
      // transposed elementwise ops round
      const float x1 = __fadd_rn(round_to(__fmul_rn(g2, sn), dt), round_to(__fmul_rn(g1, cs), dt));
      const float x2 = __fsub_rn(round_to(__fmul_rn(g2, cs), dt), round_to(__fmul_rn(g1, sn), dt));
      store1(dqkv, out_base + sec * D + c1, x1, dt);
      store1(dqkv, out_base + sec * D + c2, x2, dt);
    }
    store1(dqkv, out_base + 2 * D + c1, load1(dv, in_base + c1, dt), dt);
    store1(dqkv, out_base + 2 * D + c2, load1(dv, in_base + c2, dt), dt);
  }
}

// K10b''s rows form, picked where K10b's is (rope_rows_form over dq, dk, dv
// and dqkv): rope_split_rows_kernel with the roles swapped. A block takes
// kRopeRows (b, s) rows, computes each row's cos and sin once into shared
// memory, then each thread loads a 16-byte vector of dy1 and its dy2
// partner from dq or dk and stores dx1 and dx2 to dqkv's q or k third as
// 16-byte vectors; dv is copied into the v third as 16-byte words. The
// scalar form's roundings, so the same bits.
template <int DT>
__global__ void __launch_bounds__(kRopeThreads) rope_split_bwd_rows_kernel(
    const void* dq, const void* dk, const void* dv, void* dqkv, int rows, int S, int H, int Dh,
    float neg_log_theta) {
  constexpr int VE = RopeVec<DT>::n;
  constexpr int ESIZE = DT == kBF16 ? 2 : 4;
  extern __shared__ float s_rope[];  // cos [kRopeRows][half], then sin
  const int half = Dh / 2;
  const int D = H * Dh;
  const int row0 = blockIdx.x * kRopeRows;
  const int n_rows = min(kRopeRows, rows - row0);
  float* s_cs = s_rope;
  float* s_sn = s_rope + kRopeRows * half;
  rope_rows_table(s_cs, s_sn, row0, n_rows, S, half, neg_log_theta, DT);
  const int hv = half / VE;     // vectors a half-head
  const int per_sec = H * hv;   // rotation items of dq (or dk) a row
  for (int t = threadIdx.x; t < n_rows * 2 * per_sec; t += kRopeThreads) {
    const int r = t / (2 * per_sec);
    int u = t - r * 2 * per_sec;
    const int sec = u >= per_sec;  // 0: dq, 1: dk
    u -= sec * per_sec;
    const int h = u / hv;
    const int i0 = (u - h * hv) * VE;  // the vector's first pair
    const long long row = row0 + r;
    const int c1 = h * Dh + i0;
    const long long in = row * D + c1;
    float g1[VE], g2[VE], x1[VE], x2[VE];
    load16<DT>(sec ? dk : dq, in, g1);
    load16<DT>(sec ? dk : dq, in + half, g2);
    const float* cs = s_cs + r * half + i0;
    const float* sn = s_sn + r * half + i0;
#pragma unroll
    for (int e = 0; e < VE; ++e) {
      // dy2 sin + dy1 cos, dy2 cos - dy1 sin, as the scalar form
      x1[e] = __fadd_rn(round_to(__fmul_rn(g2[e], sn[e]), DT),
                        round_to(__fmul_rn(g1[e], cs[e]), DT));
      x2[e] = __fsub_rn(round_to(__fmul_rn(g2[e], cs[e]), DT),
                        round_to(__fmul_rn(g1[e], sn[e]), DT));
    }
    const long long out = row * 3 * D + sec * D + c1;
    store16<DT>(dqkv, out, x1);
    store16<DT>(dqkv, out + half, x2);
  }
  const int vrow = D / VE;  // dv's vectors a row
  for (int t = threadIdx.x; t < n_rows * vrow; t += kRopeThreads) {
    const int r = t / vrow;
    const long long row = row0 + r;
    const long long c = (long long)(t - r * vrow) * VE;
    const uint4* src =
        reinterpret_cast<const uint4*>(static_cast<const char*>(dv) + (row * D + c) * ESIZE);
    uint4* dst = reinterpret_cast<uint4*>(static_cast<char*>(dqkv) +
                                          (row * 3 * D + 2 * D + c) * ESIZE);
    *dst = *src;
  }
}

}  // namespace

extern "C" {

const char* model_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

int model_attention(const void* q, const void* k, const void* v, void* out, float* m_out,
                    float* l_out, int B, int Sq, int Sk, int H, int Dh, int causal,
                    float scale, int dtype, void* stream) {
  AttnArgs a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.out = out;
  a.m_out = m_out;
  a.l_out = l_out;
  a.B = B;
  a.Sq = Sq;
  a.Sk = Sk;
  a.H = H;
  a.Dh = Dh;
  a.q_off = 0;
  a.k_off = 0;
  a.causal = causal;
  a.scale = scale;
  a.dtype = dtype;
  return launch_attention<true>(a, (cudaStream_t)stream);
}

int model_block_update(const void* q, const void* k, const void* v, const float* o_in,
                       const float* m_in, const float* l_in, float* o_out, float* m_out,
                       float* l_out, int B, int Sq, int Sk, int H, int Dh, long long q_off,
                       long long k_off, int causal, float scale, int dtype, void* stream) {
  AttnArgs a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.o_in = o_in;
  a.m_in = m_in;
  a.l_in = l_in;
  a.o_out = o_out;
  a.m_out = m_out;
  a.l_out = l_out;
  a.B = B;
  a.Sq = Sq;
  a.Sk = Sk;
  a.H = H;
  a.Dh = Dh;
  a.q_off = q_off;
  a.k_off = k_off;
  a.causal = causal;
  a.scale = scale;
  a.dtype = dtype;
  return launch_attention<false>(a, (cudaStream_t)stream);
}

int model_attention_bwd(const void* q, const void* k, const void* v, const void* dout,
                        const float* m, const float* l, float* dsum, void* dq, void* dk,
                        void* dv, int B, int Sq, int Sk, int H, int Dh, int causal, float scale,
                        int dtype, void* stream) {
  if (int rc = check_attention_shape(B, Sq, Sk, H, Dh)) return rc;
  AttnBwdArgs a{q, k, v, dout, m, l, dsum, dq, dk, dv, B, Sq, Sk, H, Dh, causal, scale, dtype};
  cudaStream_t s = (cudaStream_t)stream;
  switch (Dh / 16) {
    case 1: return launch_attention_bwd<1>(a, s);
    case 2: return launch_attention_bwd<2>(a, s);
    case 4: return launch_attention_bwd<4>(a, s);
    case 8: return launch_attention_bwd<8>(a, s);
    default: return (int)cudaErrorInvalidValue;  // Dh 48, 80, 96, 112: not built
  }
}

int model_rmsnorm(const void* x, const float* scale, void* out, int rows, int D, int dtype,
                  void* stream) {
  if (rows <= 0 || D <= 0 || D % 4 != 0) return (int)cudaErrorInvalidValue;
  const int rows_per_block = kNormThreads / 32;
  const int blocks = (rows + rows_per_block - 1) / rows_per_block;
  rmsnorm_kernel<<<blocks, kNormThreads, 0, (cudaStream_t)stream>>>(x, scale, out, rows, D,
                                                                     dtype);
  return (int)cudaGetLastError();
}

// The grid of K10a' for rows x D in the dtype: as many blocks as the card
// holds at once (a cooperative launch), and no more than the rows need (8 a
// block); written to *blocks.
int model_rmsnorm_bwd_blocks(int rows, int D, int dtype, int* blocks) {
  if (rows <= 0 || D <= 0 || D % 4 != 0 || D > 4096 || (dtype != kF32 && dtype != kBF16))
    return (int)cudaErrorInvalidValue;
  const NormBwdKernel kernel = norm_bwd_kernel_for(D, dtype);
  const int smem = kNormBwdWarps * D * (int)sizeof(float);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kNormBwdThreads,
                                                        smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorLaunchOutOfResources;
  const long long need = ((long long)rows + kNormBwdWarps - 1) / kNormBwdWarps;
  *blocks = (int)(need < (long long)per_sm * sms ? need : (long long)per_sm * sms);
  return 0;
}

// K10a' in one cooperative launch of `blocks` blocks (model_rmsnorm_bwd_blocks);
// partial: [blocks, D] f32 scratch.
int model_rmsnorm_bwd(const void* x, const float* scale, const void* dy, void* dx,
                      float* partial, float* dscale, int rows, int D, int blocks, int dtype,
                      void* stream) {
  if (rows <= 0 || D <= 0 || D % 4 != 0 || D > 4096 || blocks < 1 ||
      (dtype != kF32 && dtype != kBF16))
    return (int)cudaErrorInvalidValue;
  const NormBwdKernel kernel = norm_bwd_kernel_for(D, dtype);
  const int smem = kNormBwdWarps * D * (int)sizeof(float);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {(void*)&x,       (void*)&scale,  (void*)&dy, (void*)&dx,
                  (void*)&partial, (void*)&dscale, (void*)&rows, (void*)&D};
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(blocks), dim3(kNormBwdThreads),
                                    args, (size_t)smem, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Which form of K10b model_rope_split launches for these pointers and head
// width: 1 the rows form, 0 the scalar form.
int model_rope_split_form(const void* qkv, const void* q, const void* k, const void* v,
                          int Dh, int dtype) {
  return rope_rows_form(qkv, q, k, v, Dh, dtype);
}

int model_rope_split(const void* qkv, void* q, void* k, void* v, int B, int S, int H, int Dh,
                     float neg_log_theta, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || Dh <= 0 || Dh % 2 != 0 || (dtype != kF32 && dtype != kBF16))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (!rope_rows_form(qkv, q, k, v, Dh, dtype)) {
    rope_split_kernel<<<B * S, kRopeThreads, 0, st>>>(qkv, q, k, v, S, H, Dh, neg_log_theta,
                                                      dtype);
    return (int)cudaGetLastError();
  }
  const int rows = B * S;
  const int blocks = (rows + kRopeRows - 1) / kRopeRows;
  const size_t smem = 2 * kRopeRows * (Dh / 2) * sizeof(float);
  if (dtype == kBF16)
    rope_split_rows_kernel<kBF16><<<blocks, kRopeThreads, smem, st>>>(qkv, q, k, v, rows, S, H,
                                                                     Dh, neg_log_theta);
  else
    rope_split_rows_kernel<kF32><<<blocks, kRopeThreads, smem, st>>>(qkv, q, k, v, rows, S, H,
                                                                    Dh, neg_log_theta);
  return (int)cudaGetLastError();
}

// Which form of K10b' model_rope_split_bwd launches for these pointers and
// head width: 1 the rows form, 0 the scalar form (K10b's rule).
int model_rope_split_bwd_form(const void* dq, const void* dk, const void* dv, const void* dqkv,
                              int Dh, int dtype) {
  return rope_rows_form(dqkv, dq, dk, dv, Dh, dtype);
}

int model_rope_split_bwd(const void* dq, const void* dk, const void* dv, void* dqkv, int B,
                         int S, int H, int Dh, float neg_log_theta, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || Dh <= 0 || Dh % 2 != 0 || (dtype != kF32 && dtype != kBF16))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (!rope_rows_form(dqkv, dq, dk, dv, Dh, dtype)) {
    rope_split_bwd_kernel<<<B * S, kRopeThreads, 0, st>>>(dq, dk, dv, dqkv, S, H, Dh,
                                                          neg_log_theta, dtype);
    return (int)cudaGetLastError();
  }
  const int rows = B * S;
  const int blocks = (rows + kRopeRows - 1) / kRopeRows;
  const size_t smem = 2 * kRopeRows * (Dh / 2) * sizeof(float);
  if (dtype == kBF16)
    rope_split_bwd_rows_kernel<kBF16><<<blocks, kRopeThreads, smem, st>>>(
        dq, dk, dv, dqkv, rows, S, H, Dh, neg_log_theta);
  else
    rope_split_bwd_rows_kernel<kF32><<<blocks, kRopeThreads, smem, st>>>(
        dq, dk, dv, dqkv, rows, S, H, Dh, neg_log_theta);
  return (int)cudaGetLastError();
}

}  // extern "C"
