// Hand-written Hopper (sm_90a) kernels of RLlib's own device algorithms
// (ray_tpu/rllib/policy.py and env_runner.py): the env runner's categorical
// draw with its key split, the PG/PPO loss head and the DQN TD head, each
// with its gradient.
//
// Built by ray_tpu_torch/rllib/rllib_kernels.py (through util/cuda_build.py)
// with one nvcc call into a shared library with a plain C interface, loaded
// with ctypes; the Python wrappers and their plain PyTorch versions live in
// rllib_kernels.py and prng.py. Every entry point launches on the stream it
// is given, allocates nothing, does not synchronise, and returns
// cudaGetLastError() after its launch. Tensors are contiguous float32,
// actions int32, a key two int64 words holding the uint32 words of a JAX
// threefry key.
//
// Numerics: built with --fmad=false, never with fast math: expf, logf,
// sqrtf and every division are the IEEE-rounded library forms, and no
// product is contracted into an FMA, so each step rounds as the plain
// version's torch op does. No value is summed through an atomic: K12's and
// K13's batch-wide sums are one block's, each thread adding its rows in
// order and the block a fixed tree in shared memory, so two launches give
// the same bits.
//
// Kernels:
//   K11 rl_sample_actions  replaces policy.py :49-57 (sample_actions:
//                     jax.random.categorical and log_softmax at the draw)
//                     with env_runner.py :51 (jax.random.split of the
//                     runner's key). Per launch: key, sub = split(key) (the
//                     threefry2x32 hash of the counter pairs (0, 0) and (0,
//                     1)); for each row b and action a, the hash under sub
//                     of the flat index b*A + a, its two words xor-ed; the
//                     top 23 bits as a float in [1, 2), less 1, scaled and
//                     kept at or above float32's tiny (jax.random._uniform
//                     with minval tiny); the Gumbel noise -logf(-logf(u))
//                     (_gumbel, mode "low"); the argmax of logits + noise,
//                     the first index at ties (jnp.argmax); then
//                     log_softmax's value at the drawn action as
//                     jax.nn.log_softmax forms it, (x - max) - logf(sum of
//                     expf(x - max)), the sum in action order. Writes the
//                     actions, their log-probabilities and the next key
//                     (the first half of the split), so the runner's key
//                     chain stays on the device. Design: one thread a row,
//                     blocks of 128; every thread hashes sub itself (one
//                     hash), thread 0 of block 0 writes the next key into
//                     a buffer apart from the input's. Bound: B*A*4 bytes
//                     read, B*8 written; at the runner's B = 1 a launch is
//                     all latency.
//   K12 rl_pg_loss     replaces policy.py :71-88 (pg_update's loss_fn)
//                     and :105-127 (ppo_update's, clip given): the masked
//                     mean and variance of the advantage returns - v, its
//                     normalisation by sqrt(var) + 1e-6, log_softmax and
//                     the action's log-probability, the policy term (PG:
//                     logp * adv; PPO: min(ratio * adv, clip(ratio) * adv)
//                     with ratio = expf(logp - logp_old)), the value loss
//                     mean (returns - v)^2, the entropy bonus, total = pg +
//                     0.5 vf - 0.01 entropy; and in the same launch the
//                     gradient of total with respect to the logits and v,
//                     in the order of the reference's jax.value_and_grad:
//                     jnp.minimum / jnp.clip's ties give each side half
//                     (lax.min and lax.max are balanced), so a ratio inside
//                     the clip range sends half its cotangent through each
//                     product, and a ratio at a clip end a quarter through
//                     the clipped one. Every "/ n" is a true division.
//                     Design: one block of 1 024 threads, rows strided over
//                     the threads: the sums of the mask and of adv * mask,
//                     then of (adv - mean)^2 * mask, then of the three loss
//                     terms, each a fixed tree; the gradient rows are
//                     written in the third pass. Bound: ~(A + 5) * B * 4
//                     bytes read, (A + 1) * B * 4 written.
//   K13 rl_dqn_loss    replaces policy.py :160-179 (dqn_update's loss_fn
//                     past the three trunks): the online argmax of the next
//                     Q (first index at ties), the target network's value
//                     there, target = r + (gamma * (1 - done)) * q_next,
//                     td = q[a] - target, optax.huber_loss (delta 1):
//                     0.5 * min(|td|, 1)^2 + (|td| - min(|td|, 1)), its
//                     mean, mean |td|, mean q; and dq, nonzero only at the
//                     taken action: the huber gradient over B, with
//                     jnp.minimum's tie at |td| = 1 split in half (the
//                     gradient there is 1) and 0 at td = 0. Design: as K12,
//                     one block, one pass. Bound: 3 * B * A * 4 + 3 * B * 4
//                     bytes read, B * A * 4 written.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxActions = 64;
constexpr int kSampleThreads = 128;
constexpr int kLossThreads = 1024;
constexpr uint32_t kParity = 0x1BD11BDAu;
constexpr float kTiny = 1.17549435e-38f;  // FLT_MIN, float32's tiny

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// jax/_src/prng.py _threefry2x32_lowering: 20 rounds in five groups of four.
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1, uint32_t c0,
                                             uint32_t c1, uint32_t* y0, uint32_t* y1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ kParity};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  uint32_t x0 = c0 + ks[0];
  uint32_t x1 = c1 + ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl32(x1, rot[i & 1][j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
  *y0 = x0;
  *y1 = x1;
}

__device__ __forceinline__ float gumbel_of_bits(uint32_t bits) {
  const float unit = __int_as_float((int)((bits >> 9) | 0x3F800000u)) - 1.0f;
  const float scale = 1.0f - kTiny;  // maxval - minval in float32: 1.0f
  const float u = fmaxf(kTiny, unit * scale + kTiny);
  return -logf(-logf(u));
}

__global__ void __launch_bounds__(kSampleThreads) sample_actions_kernel(
    const float* __restrict__ logits, const long long* __restrict__ key_in,
    int* __restrict__ actions, float* __restrict__ logp, long long* __restrict__ key_out,
    int B, int A) {
  const uint32_t k0 = (uint32_t)key_in[0];
  const uint32_t k1 = (uint32_t)key_in[1];
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b == 0) {
    uint32_t n0, n1;
    threefry2x32(k0, k1, 0u, 0u, &n0, &n1);
    key_out[0] = (long long)n0;
    key_out[1] = (long long)n1;
  }
  if (b >= B) return;
  uint32_t s0, s1;
  threefry2x32(k0, k1, 0u, 1u, &s0, &s1);
  const float* x = logits + (long long)b * A;
  int best = 0;
  float best_score = 0.0f;
  float mx = x[0];
  for (int a = 0; a < A; ++a) {
    const unsigned long long i = (unsigned long long)b * A + a;
    uint32_t y0, y1;
    threefry2x32(s0, s1, (uint32_t)(i >> 32), (uint32_t)(i & 0xFFFFFFFFull), &y0, &y1);
    const float score = gumbel_of_bits(y0 ^ y1) + x[a];
    if (a == 0 || score > best_score) {
      best = a;
      best_score = score;
    }
    mx = fmaxf(mx, x[a]);
  }
  float s = 0.0f;
  for (int a = 0; a < A; ++a) s = s + expf(x[a] - mx);
  actions[b] = best;
  logp[b] = (x[best] - mx) - logf(s);
}

// The sum of v over the block: each thread's value into shared memory, then
// a fixed tree (the block is a power of two), so the order never varies.
__device__ float block_sum(float v, float* sh) {
  const int t = threadIdx.x;
  sh[t] = v;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (t < s) sh[t] = sh[t] + sh[t + s];
    __syncthreads();
  }
  const float r = sh[0];
  __syncthreads();
  return r;
}

// lax.min's and lax.max's gradient weight for the operand x of op(x, y) = z:
// 1 where x alone gives z, 1/2 where both do, 0 where y does.
__device__ __forceinline__ float balanced(float x, float z, float y) {
  return (x == z ? 1.0f : 0.0f) / (y == z ? 2.0f : 1.0f);
}

// log_softmax of one row as jax.nn.log_softmax forms it: shifted = x - max,
// e = expf(shifted), s their sum in action order, logp = shifted - logf(s).
__device__ __forceinline__ void log_softmax_row(const float* x, int A, float* e, float* lp,
                                                float* s_out) {
  float mx = x[0];
  for (int a = 1; a < A; ++a) mx = fmaxf(mx, x[a]);
  float s = 0.0f;
  for (int a = 0; a < A; ++a) {
    e[a] = expf(x[a] - mx);
    s = s + e[a];
  }
  const float lse = logf(s);
  for (int a = 0; a < A; ++a) lp[a] = (x[a] - mx) - lse;
  *s_out = s;
}

// mode 0: PG (logp_old unused), 1: PPO with ratio clipped to [lo, hi].
__global__ void __launch_bounds__(kLossThreads) pg_loss_kernel(
    const float* __restrict__ logits, const float* __restrict__ v,
    const int* __restrict__ actions, const float* __restrict__ returns,
    const float* __restrict__ mask, const float* __restrict__ logp_old,
    float* __restrict__ losses, float* __restrict__ dlogits, float* __restrict__ dv, int B,
    int A, int mode, float lo, float hi) {
  __shared__ float sh[kLossThreads];
  const int t = threadIdx.x;
  const int T = blockDim.x;
  // pass 1: n = max(sum m, 1), the masked mean of adv = returns - v
  float sm = 0.0f, sam = 0.0f;
  for (int b = t; b < B; b += T) {
    const float m = mask[b];
    sm = sm + m;
    sam = sam + (returns[b] - v[b]) * m;
  }
  const float n = fmaxf(block_sum(sm, sh), 1.0f);
  const float mean = block_sum(sam, sh) / n;
  // pass 2: the masked variance
  float sv = 0.0f;
  for (int b = t; b < B; b += T) {
    const float c = (returns[b] - v[b]) - mean;
    sv = sv + (c * c) * mask[b];
  }
  const float denom = sqrtf(block_sum(sv, sh) / n) + 1e-6f;
  // the cotangents of total's three terms: 1 for pg, 0.5 for vf, -0.01
  // for the entropy bonus, each through its "/ n"
  const float ct_sum_pg = -(1.0f / n);
  const float ct_sum_vf = 0.5f / n;
  const float ct_sum_ent = -0.01f / n;
  // pass 3: the terms and the gradient rows
  float spg = 0.0f, svf = 0.0f, sent = 0.0f;
  float e[kMaxActions], lp[kMaxActions];
  for (int b = t; b < B; b += T) {
    const float* x = logits + (long long)b * A;
    const float m = mask[b];
    const int act = actions[b];
    float s;
    log_softmax_row(x, A, e, lp, &s);
    const float adv = (returns[b] - v[b] - mean) / denom;
    float ct_act;  // the cotangent of logp[act]
    if (mode == 0) {
      spg = spg + (lp[act] * adv) * m;
      ct_act = (ct_sum_pg * m) * adv;
    } else {
      const float ratio = expf(lp[act] - logp_old[b]);
      const float r_lo = fmaxf(lo, ratio);
      const float r_clip = fminf(hi, r_lo);
      const float pa = ratio * adv;
      const float pb = r_clip * adv;
      const float surr = fminf(pa, pb);
      spg = spg + surr * m;
      const float ct_surr = ct_sum_pg * m;
      const float ct_pa = ct_surr * balanced(pa, surr, pb);
      const float ct_pb = ct_surr * balanced(pb, surr, pa);
      const float w_clip = balanced(r_lo, r_clip, hi) * balanced(ratio, r_lo, lo);
      const float ct_ratio = ct_pa * adv + (ct_pb * adv) * w_clip;
      ct_act = ct_ratio * ratio;
    }
    const float d = returns[b] - v[b];
    svf = svf + (d * d) * m;
    float ent = 0.0f;
    for (int a = 0; a < A; ++a) ent = ent + expf(lp[a]) * lp[a];
    ent = -ent;
    sent = sent + ent * m;
    // the entropy's cotangent c on each p * logp; then log_softmax's backward
    const float c = -(ct_sum_ent * m);
    float g[kMaxActions];
    float gsum = 0.0f;
    for (int a = 0; a < A; ++a) {
      const float p = expf(lp[a]);
      float ga = c * p + (c * lp[a]) * p;
      if (a == act) ga = ga + ct_act;
      g[a] = ga;
      gsum = gsum + ga;
    }
    const float ct_s = -gsum / s;
    float* dx = dlogits + (long long)b * A;
    for (int a = 0; a < A; ++a) dx[a] = g[a] + ct_s * e[a];
    dv[b] = -((ct_sum_vf * m) * (2.0f * d));
  }
  const float pg = -block_sum(spg, sh) / n;
  const float vf = block_sum(svf, sh) / n;
  const float entb = block_sum(sent, sh) / n;
  if (t == 0) {
    losses[0] = (pg + 0.5f * vf) - 0.01f * entb;
    losses[1] = pg;
    losses[2] = vf;
  }
}

__global__ void __launch_bounds__(kLossThreads) dqn_loss_kernel(
    const float* __restrict__ q, const float* __restrict__ qn_online,
    const float* __restrict__ qn_target, const int* __restrict__ actions,
    const float* __restrict__ rewards, const float* __restrict__ dones,
    float* __restrict__ losses, float* __restrict__ dq, int B, int A, float gamma) {
  __shared__ float sh[kLossThreads];
  const int t = threadIdx.x;
  const int T = blockDim.x;
  const float nb = (float)B;
  float sh_loss = 0.0f, sabs = 0.0f, sq = 0.0f;
  for (int b = t; b < B; b += T) {
    const float* qo = qn_online + (long long)b * A;
    int an = 0;
    for (int a = 1; a < A; ++a)
      if (qo[a] > qo[an]) an = a;
    const float q_next = qn_target[(long long)b * A + an];
    const float target = rewards[b] + (gamma * (1.0f - dones[b])) * q_next;
    const float* qr = q + (long long)b * A;
    const int act = actions[b];
    const float td = qr[act] - target;
    const float ab = fabsf(td);
    const float quad = fminf(ab, 1.0f);
    const float lin = ab - quad;
    sh_loss = sh_loss + (0.5f * (quad * quad) + 1.0f * lin);
    sabs = sabs + ab;
    float* dr = dq + (long long)b * A;
    for (int a = 0; a < A; ++a) {
      sq = sq + qr[a];
      dr[a] = 0.0f;
    }
    // huber's backward: ct 1/B on the row's loss
    const float ct = 1.0f / nb;
    const float ct_lin = 1.0f * ct;
    const float ct_quad = (0.5f * ct) * (2.0f * quad) - ct_lin;
    const float ct_abs = ct_lin + ct_quad * balanced(ab, quad, 1.0f);
    dr[act] = td > 0.0f ? ct_abs : (td < 0.0f ? -ct_abs : 0.0f);
  }
  const float loss = block_sum(sh_loss, sh) / nb;
  const float td_abs = block_sum(sabs, sh) / nb;
  const float q_mean = block_sum(sq, sh) / (nb * (float)A);
  if (t == 0) {
    losses[0] = loss;
    losses[1] = td_abs;
    losses[2] = q_mean;
  }
}

}  // namespace

extern "C" {

const char* rl_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// K11: logits [B, A] -> actions [B], logp [B], key_out [2] (key_in [2] apart).
int rl_sample_actions(const float* logits, const long long* key_in, int* actions, float* logp,
                      long long* key_out, int B, int A, void* stream) {
  if (B <= 0 || A <= 0 || A > kMaxActions || key_in == key_out) {
    return (int)cudaErrorInvalidValue;
  }
  const int blocks = (B + kSampleThreads - 1) / kSampleThreads;
  sample_actions_kernel<<<blocks, kSampleThreads, 0, (cudaStream_t)stream>>>(
      logits, key_in, actions, logp, key_out, B, A);
  return (int)cudaGetLastError();
}

// K12: losses [3] = total, pg, vf; dlogits [B, A]; dv [B]. mode 0 PG, 1 PPO.
int rl_pg_loss(const float* logits, const float* v, const int* actions, const float* returns,
               const float* mask, const float* logp_old, float* losses, float* dlogits,
               float* dv, int B, int A, int mode, float lo, float hi, void* stream) {
  if (B <= 0 || A <= 0 || A > kMaxActions || mode < 0 || mode > 1 ||
      (mode == 1 && logp_old == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  pg_loss_kernel<<<1, kLossThreads, 0, (cudaStream_t)stream>>>(
      logits, v, actions, returns, mask, logp_old, losses, dlogits, dv, B, A, mode, lo, hi);
  return (int)cudaGetLastError();
}

// K13: losses [3] = loss, mean |td|, mean q; dq [B, A].
int rl_dqn_loss(const float* q, const float* qn_online, const float* qn_target,
                const int* actions, const float* rewards, const float* dones, float* losses,
                float* dq, int B, int A, float gamma, void* stream) {
  if (B <= 0 || A <= 0) return (int)cudaErrorInvalidValue;
  dqn_loss_kernel<<<1, kLossThreads, 0, (cudaStream_t)stream>>>(
      q, qn_online, qn_target, actions, rewards, dones, losses, dq, B, A, gamma);
  return (int)cudaGetLastError();
}

}  // extern "C"
