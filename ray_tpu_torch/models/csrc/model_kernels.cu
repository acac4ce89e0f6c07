// Hand-written Hopper (sm_90a) kernels of the flagship transformer's forward.
//
// Built by ray_tpu_torch/models/kernels.py (through util/cuda_build.py) with
// one nvcc call into a shared library with a plain C interface, loaded with
// ctypes; the Python wrappers and their plain PyTorch versions live in
// kernels.py. Every entry point launches on the stream it is given,
// allocates nothing, does not synchronise, and returns cudaGetLastError()
// after its launch. Tensors are contiguous, 16-byte aligned, and of the
// dtype named by the code `dtype`: 0 float32, 1 bfloat16. Arithmetic is
// float32 throughout.
//
// Numerics: the kernels are held to a stated tolerance against their plain
// versions, not to bit identity, so this source is built without
// --fmad=false (the scheduler's source keeps it): nvcc may contract a
// product into a sum, which the attention's dot products need for the FMA
// rate. Where the reference rounds each product before a sum (RoPE's
// rotation) the source spells it out with __fmul_rn / __fsub_rn / __fadd_rn.
// Never fast math: expf, cosf, sinf and IEEE division, not the __expf /
// __cosf / __sinf intrinsics (RoPE's angles reach 2 047 rad at the
// flagship's sequence length, where the intrinsics are wrong).
//
// Kernels:
//   K8  model_attention     replaces ray_tpu/models/transformer.py
//                           _attention (:113-124), as ring_attention.py
//                           _ring_attention_local on one device computes
//                           it: online softmax from o = 0, m = -1e30, l = 0
//                           over every KV tile, then o / max(l, 1e-30)
//                           cast to q's dtype (= reference_attention).
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
//       running m and l, in registers; row max and sum go through warp
//       shuffles over the 16 threads of a row; P goes through shared
//       memory to the PV product. Causal tiles above the diagonal are
//       never loaded, and the heaviest query tiles are scheduled first.
//       This is the CUDA-core form; wgmma, TMA and warp specialisation are
//       the later step to the tensor-core bound.
//   K10a model_rmsnorm      replaces transformer.py _rmsnorm (:93-95):
//                           (x * rsqrt(mean(x_f32^2) + 1e-6)).astype(x.dtype)
//                           * scale.astype(x.dtype). Bound by bytes (each
//                           row read and written once). Design: one warp
//                           per row, float4 / 4 x bf16 loads, f32 sum of
//                           squares by shuffles; the second read of the row
//                           hits L1.
//   K10b model_rope_split   replaces transformer.py _rope (:98-110) on q
//                           and k with the qkv split of _layer (:132-138):
//                           qkv [B, S, 3D] -> q, k (rotated), v as
//                           [B, S, H, Dh]. Bound by bytes (qkv read once,
//                           q, k, v written once). Design: one block per
//                           (b, s) row, one thread per (head, i < Dh/2)
//                           pair, which computes its frequency and angle in
//                           f32 as the reference does, rounds cos and sin to
//                           x's dtype, and rotates the pair of q and of k.

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
  float* m_out;
  float* l_out;
  void* out;          // whole form: o / max(l, 1e-30) in q's dtype
  int B, Sq, Sk, H, Dh;
  long long q_off, k_off;
  int causal;
  float scale;
  int dtype;
};

__host__ __device__ constexpr int attn_smem_floats(int dh) {
  return 2 * kBQ * (dh + 4) + kBK * dh + kBQ * kLdp;
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

  for (int idx = tid; idx < kBQ * nd4; idx += kAttnThreads) {
    const int r = idx / nd4;
    const int d = (idx % nd4) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < a.Sq) {
      val = load4(a.q, ((long long)(b * a.Sq + q0 + r) * a.H + h) * Dh + d, a.dtype);
    }
    *reinterpret_cast<float4*>(Qs + r * ldq + d) = val;
  }

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
    for (int d = 0; d < Dh; d += 4) {
      float4 qa[4];
      float4 kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * i) * ldq + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) kb[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * ldq + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          s[i][j] += qa[i].x * kb[j].x + qa[i].y * kb[j].y + qa[i].z * kb[j].z + qa[i].w * kb[j].w;
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long q_pos = a.q_off + q0 + ty + 16 * i;
      float rmax = -INFINITY;
      unsigned live = 0;  // bit j: key in range and not masked
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        if (col >= a.Sk) continue;  // past the ragged edge: not a key
        float x = s[i][j] * a.scale;
        if (a.causal && q_pos < a.k_off + col) {
          x = kNegInf;
        } else {
          live |= 1u << j;
        }
        s[i][j] = x;
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
        const float p = (live >> j) & 1u ? expf(s[i][j] - m_new) : 0.f;
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

template <bool kWhole>
int launch_attention(const AttnArgs& a, cudaStream_t stream) {
  if (a.Dh % 16 != 0 || a.Dh <= 0 || a.Dh > kMaxDh || a.Sq <= 0 || a.Sk <= 0 ||
      a.B <= 0 || a.H <= 0 || (long long)a.B * a.H > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const int smem = attn_smem_floats(a.Dh) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(attention_kernel<kWhole>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         attn_smem_floats(kMaxDh) * (int)sizeof(float));
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.Sq + kBQ - 1) / kBQ, a.B * a.H);
  attention_kernel<kWhole><<<grid, kAttnThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------------ K10a

constexpr int kNormThreads = 256;  // 8 rows a block, one warp each

__global__ void __launch_bounds__(kNormThreads) rmsnorm_kernel(
    const void* x, const float* scale, void* out, int rows, int D, int dt) {
  const int row = (blockIdx.x * kNormThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const long long base = (long long)row * D;
  float ss = 0.f;
  for (int c = lane * 4; c < D; c += 128) {
    const float4 v = load4(x, base + c, dt);
    ss += v.x * v.x + v.y * v.y + v.z * v.z + v.w * v.w;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(kFull, ss, off);
  const float r = rsqrtf(ss / (float)D + 1e-6f);
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

// ------------------------------------------------------------------ K10b

constexpr int kRopeThreads = 256;

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
    // freqs = exp(-ln(theta) * i / half); angle = pos * freq, all f32
    const float freq = expf(__fdiv_rn(__fmul_rn(neg_log_theta, (float)i), (float)half));
    const float ang = __fmul_rn(pos, freq);
    const float cs = round_to(cosf(ang), dt);
    const float sn = round_to(sinf(ang), dt);
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

}  // namespace

extern "C" {

const char* model_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

int model_attention(const void* q, const void* k, const void* v, void* out, int B, int Sq,
                    int Sk, int H, int Dh, int causal, float scale, int dtype, void* stream) {
  AttnArgs a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.out = out;
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

int model_rmsnorm(const void* x, const float* scale, void* out, int rows, int D, int dtype,
                  void* stream) {
  if (rows <= 0 || D <= 0 || D % 4 != 0) return (int)cudaErrorInvalidValue;
  const int rows_per_block = kNormThreads / 32;
  const int blocks = (rows + rows_per_block - 1) / rows_per_block;
  rmsnorm_kernel<<<blocks, kNormThreads, 0, (cudaStream_t)stream>>>(x, scale, out, rows, D,
                                                                     dtype);
  return (int)cudaGetLastError();
}

int model_rope_split(const void* qkv, void* q, void* k, void* v, int B, int S, int H, int Dh,
                     float neg_log_theta, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || Dh <= 0 || Dh % 2 != 0) return (int)cudaErrorInvalidValue;
  rope_split_kernel<<<B * S, kRopeThreads, 0, (cudaStream_t)stream>>>(
      qkv, q, k, v, S, H, Dh, neg_log_theta, dtype);
  return (int)cudaGetLastError();
}

}  // extern "C"
