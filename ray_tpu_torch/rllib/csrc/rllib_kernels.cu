// Hand-written Hopper (sm_90a) kernels of RLlib's own device programs
// (ray_tpu/rllib/policy.py and env_runner.py): the env runner's whole step
// (trunk, logits, key split, categorical draw), the whole PG/PPO update
// (trunk, loss head, backward, Adam) and the whole DQN update (three trunks,
// TD head, backward, Adam).
//
// Built by ray_tpu_torch/rllib/rllib_kernels.py (through util/cuda_build.py)
// with one nvcc call into a shared library with a plain C interface, loaded
// with ctypes; the Python wrappers and their plain PyTorch versions live in
// rllib_kernels.py and prng.py. Every entry point launches on the stream it
// is given, allocates nothing, does not synchronise (rl_stream_sync is the
// wrappers' one wait), and returns cudaGetLastError() after its launch.
// Tensors are contiguous float32, actions int32, a key two int64 words
// holding the uint32 words of a JAX threefry key.
//
// Numerics: built with --fmad=false, never with fast math: tanhf, expf,
// logf, sqrtf and every division are the IEEE-rounded library forms (the
// ones PyTorch's own CUDA ops call), and no product is contracted into an
// FMA, so each step rounds as the plain version's torch op does. No value
// is summed through an atomic: every sum is one thread's, in a fixed order,
// or one block's fixed tree, or K12's cluster's partials in rank order, so
// two launches give the same bits. The products are summed in another order
// than cuBLAS's, so K11's logits and K12's and K13's trunks differ from the
// plain versions' by ulps.
//
// Kernels:
//   K11 rl_policy_sample  replaces policy.py :49-57 (sample_actions: the
//                     trunk :34-37 inside action_logits, then
//                     jax.random.categorical and log_softmax at the draw)
//                     with env_runner.py :51 (jax.random.split of the
//                     runner's key): the whole runner step in one launch.
//                     Per row: h1 = tanh(obs @ w1 + b1), h2 = tanh(h1 @ w2
//                     + b2), logits = h2 @ wp + bp, each product summed in
//                     the order of its inner index. Then key, sub =
//                     split(key) (the threefry2x32 hash of the counter pairs
//                     (0, 0) and (0, 1)); for each row b and action a the
//                     hash under sub of the flat index b*A + a, its two
//                     words xor-ed; the top 23 bits as a float in [1, 2),
//                     less 1, scaled and kept at or above float32's tiny
//                     (jax.random._uniform with minval tiny); the Gumbel
//                     noise -logf(-logf(u)) (_gumbel, mode "low"); the
//                     argmax of logits + noise, the first index at ties
//                     (jnp.argmax); log_softmax's value at the draw as
//                     jax.nn.log_softmax forms it, (x - max) - logf(sum of
//                     expf(x - max)), the sum in action order. Writes the
//                     next key (the first half of the split) on the device,
//                     so the key chain stays there, and the actions and
//                     log-probabilities into pinned host memory (mapped
//                     through unified addressing), readable after the one
//                     stream synchronisation a step. Design: a block of
//                     256 threads for each 4 rows, one hidden unit to each
//                     thread: each thread reads its column of w1 and w2 once
//                     (L2-resident between steps) and applies each weight to
//                     the block's rows; one thread a (row, action) sums its
//                     logit over the hidden units in order (at A = 2 a tree
//                     buys nothing: 64 dependent adds are ~0.1 us); one
//                     thread a row draws. The observation rides in the
//                     kernel's arguments (B*O <= 256 floats: no copy) or is
//                     read from memory the card can reach (pinned staging or
//                     device). Bound: the weights, obs and key read, B*8
//                     bytes written; at the runner's B = 1 a launch is all
//                     latency.
//   K12 rl_pg_update  replaces policy.py :64-97 (pg_update) and :100-136
//                     (ppo_update, clip given): the whole jitted step in one
//                     launch. Per row the trunk h1 = tanh(obs @ w1 + b1), h2 =
//                     tanh(h1 @ w2 + b2), the logits h2 @ wp + bp and v = h2 @
//                     wv + bv; the masked mean and variance of the advantage
//                     returns - v over the batch, its normalisation by
//                     sqrt(var) + 1e-6, log_softmax and the action's
//                     log-probability, the policy term (PG: logp * adv; PPO:
//                     min(ratio * adv, clip(ratio) * adv) with ratio =
//                     expf(logp - logp_old)), the value loss mean (returns -
//                     v)^2, the entropy bonus, total = pg + 0.5 vf - 0.01
//                     entropy; the gradient of total as the reference's
//                     jax.value_and_grad forms it (jnp.minimum / jnp.clip's
//                     ties give each side half: lax.min and lax.max are
//                     balanced, so a ratio inside the clip range sends half
//                     its cotangent through each product, a ratio at a clip
//                     end a quarter through the clipped one; every "/ n" a
//                     true division), back through both heads and the shared
//                     trunk (tanh's backward as dh * (1 - y*y)); and each
//                     entry's Adam step as K13's. Writes the params and
//                     moments in place and total, pg, vf into pinned host
//                     memory. Design: ONE cluster of P blocks of 1 024
//                     threads (P up to 16, about 64 rows a block: 16 at the
//                     default batch of 2 048), block r taking rows [r*B/P,
//                     (r+1)*B/P) and holding the whole network (the value
//                     head as column A of a [H, A + 1] head), its own partial
//                     gradient and its rows' logits and v (A + 1 floats a
//                     row) in its shared memory (106 KB at hidden 64, batch
//                     2 048: 128 rows a block, one tile). Pass 1 runs each
//                     tile of R rows through the trunk and heads; the
//                     cluster then sums n, sum adv * m, and
//                     after the mean sum c^2 * m: each block its partial
//                     (every thread's rows in row order, then a fixed warp
//                     tree), every block reading all P partials through
//                     DSMEM in rank order, so each holds the same bits. Pass
//                     2 runs the loss head and its gradient a row a thread,
//                     then the backward into the block's gradient (each entry
//                     one thread's sum over the block's rows in row order,
//                     whatever R is; a tile's trunk is recomputed where the
//                     block's rows took more than one). Then block r sums
//                     its slice of the ~4 700 gradient entries over the P
//                     blocks in rank order and applies Adam to it. No atomic
//                     anywhere: two launches give the same bits. Limits: the
//                     network, the gradient, the rows' logits and one row in
//                     one block (hidden up to 164 at obs 4, 2 actions; at
//                     hidden 128 and batch 2 048, two tiles a block).
//                     Bound: ~55 MFLOP at the default width and batch (the
//                     forward and the backward's products) against ~0.18 MB
//                     moved: the operations, spread over P SMs' float32
//                     lanes.
//   K13 rl_dqn_update  replaces policy.py :150-185 (dqn_update): the whole
//                     jitted step in one launch. The online trunk and head
//                     on next_obs, the target network's on next_obs, the
//                     online one on obs (its activations kept); the online
//                     argmax of the next Q (first index at ties), the target
//                     network's value there, target = r + (gamma * (1 -
//                     done)) * q_next, td = q[a] - target, optax.huber_loss
//                     (delta 1): 0.5 * min(|td|, 1)^2 + (|td| - min(|td|,
//                     1)), its mean, mean |td|, mean q; dq, nonzero only at
//                     the taken action: the huber gradient over B, with
//                     jnp.minimum's tie at |td| = 1 split in half and 0 at
//                     td = 0. Then the backward through the online trunk as
//                     autograd forms it (tanh's as dh * (1 - y*y)), every
//                     weight-gradient and bias-gradient entry one thread's
//                     sum over the batch in row order, a zero gradient for
//                     the value head wv/bv that the loss does not read (as
//                     jax.grad gives it); and each entry's Adam step as
//                     AdamW.update (ray_tpu_torch/parallel/tpu_train.py)
//                     orders it: mu = mu*b1 + g*(1-b1); nu = nu*b2 +
//                     (g*g)*(1-b2); u = (mu/bc1) / (sqrtf(nu/bc2) + eps);
//                     u = u + p*wd; p = p + u*(-lr), the bias corrections
//                     float32 from the host. Writes the params and moments
//                     in place and the three stats. Design: ONE block of
//                     1 024 threads, both networks and the online one's
//                     gradient in its shared memory (~56 KB at hidden 64),
//                     the batch passed through in tiles of R rows (obs,
//                     next_obs, the online trunk's activations on obs: 576
//                     bytes a row at hidden 64, so R = B up to 299 rows,
//                     DQN's batch of 128 in one tile; the default 2 048 in
//                     7). Each tile runs the three trunks, the TD head and
//                     the backward, adding its rows to the gradient; Adam
//                     runs once after the last tile. An entry's thread is
//                     the same in every tile, so each gradient entry sums
//                     the rows in batch order whatever R is. A cluster of
//                     blocks would split five dependent products of ~0.5 M
//                     multiply-adds each (at B 128) by DSMEM exchanges that
//                     cost more than they save at this size, and one block
//                     keeps every sum in one fixed order. Rows of width
//                     hidden are padded to hidden + 1 floats so that the
//                     transposed products read distinct banks. The
//                     backward overwrites h2 by dz2 and h1 by dz1 in place.
//                     Limits: one row beside the two networks and the
//                     gradient (hidden up to 135 at obs 4, 2 actions).
//                     Bound: params, target, moments and batch read, params
//                     and moments written; ~5.7 MFLOP at the default width,
//                     one SM's float32 lanes the real limit.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxActions = 64;
constexpr int kLossThreads = 1024;
constexpr int kPolicyThreads = 256;  // K11: one thread a hidden unit
constexpr int kMaxHidden = kPolicyThreads;
constexpr int kMaxObs = 64;          // K11's observation width
constexpr int kPolicyRows = 4;       // K11: rows a block
constexpr int kArgObs = 256;         // K11: obs floats carried in the arguments
constexpr int kMaxSmem = 232448;     // a block's shared memory on sm_90
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

struct ObsArg {
  float v[kArgObs];
};

struct PolicyPtrs {
  const float* w[6];  // w1 b1 w2 b2 wp bp
};

__global__ void __launch_bounds__(kPolicyThreads) policy_sample_kernel(
    PolicyPtrs net, ObsArg obs_arg, const float* __restrict__ obs_ptr,
    const long long* __restrict__ key_in, int* __restrict__ actions,
    float* __restrict__ logp, long long* __restrict__ key_out, int B, int O, int H, int A) {
  __shared__ float x[kPolicyRows][kMaxObs];
  __shared__ float h1[kPolicyRows][kMaxHidden];
  __shared__ float h2[kPolicyRows][kMaxHidden];
  __shared__ float logits[kPolicyRows][kMaxActions];
  const float* __restrict__ w1 = net.w[0];
  const float* __restrict__ b1 = net.w[1];
  const float* __restrict__ w2 = net.w[2];
  const float* __restrict__ b2 = net.w[3];
  const float* __restrict__ wp = net.w[4];
  const float* __restrict__ bp = net.w[5];
  const int t = threadIdx.x;
  const int row0 = blockIdx.x * kPolicyRows;
  const int rows = min(kPolicyRows, B - row0);
  const uint32_t k0 = (uint32_t)key_in[0];
  const uint32_t k1 = (uint32_t)key_in[1];
  if (blockIdx.x == 0 && t == 0) {
    uint32_t n0, n1;
    threefry2x32(k0, k1, 0u, 0u, &n0, &n1);
    key_out[0] = (long long)n0;
    key_out[1] = (long long)n1;
  }
  for (int e = t; e < rows * O; e += kPolicyThreads) {
    const long long i = (long long)row0 * O + e;
    x[e / O][e % O] = obs_ptr != nullptr ? obs_ptr[i] : obs_arg.v[i];
  }
  __syncthreads();
  if (t < H) {
    float acc[kPolicyRows];
#pragma unroll
    for (int r = 0; r < kPolicyRows; ++r) acc[r] = 0.0f;
    for (int k = 0; k < O; ++k) {
      const float w = w1[k * H + t];
#pragma unroll
      for (int r = 0; r < kPolicyRows; ++r)
        if (r < rows) acc[r] = acc[r] + x[r][k] * w;
    }
    const float b = b1[t];
#pragma unroll
    for (int r = 0; r < kPolicyRows; ++r)
      if (r < rows) h1[r][t] = tanhf(acc[r] + b);
  }
  __syncthreads();
  if (t < H) {
    float acc[kPolicyRows];
#pragma unroll
    for (int r = 0; r < kPolicyRows; ++r) acc[r] = 0.0f;
#pragma unroll 8
    for (int i = 0; i < H; ++i) {
      const float w = w2[i * H + t];
#pragma unroll
      for (int r = 0; r < kPolicyRows; ++r)
        if (r < rows) acc[r] = acc[r] + h1[r][i] * w;
    }
    const float b = b2[t];
#pragma unroll
    for (int r = 0; r < kPolicyRows; ++r)
      if (r < rows) h2[r][t] = tanhf(acc[r] + b);
  }
  __syncthreads();
  if (t < rows * A) {
    const int r = t / A, a = t % A;
    float s = 0.0f;
#pragma unroll 8
    for (int j = 0; j < H; ++j) s = s + h2[r][j] * wp[j * A + a];
    logits[r][a] = s + bp[a];
  }
  __syncthreads();
  if (t >= rows) return;
  const int b = row0 + t;
  uint32_t s0, s1;
  threefry2x32(k0, k1, 0u, 1u, &s0, &s1);
  const float* xr = logits[t];
  int best = 0;
  float best_score = 0.0f;
  float mx = xr[0];
  for (int a = 0; a < A; ++a) {
    const unsigned long long i = (unsigned long long)b * A + a;
    uint32_t y0, y1;
    threefry2x32(s0, s1, (uint32_t)(i >> 32), (uint32_t)(i & 0xFFFFFFFFull), &y0, &y1);
    const float score = gumbel_of_bits(y0 ^ y1) + xr[a];
    if (a == 0 || score > best_score) {
      best = a;
      best_score = score;
    }
    mx = fmaxf(mx, xr[a]);
  }
  float s = 0.0f;
  for (int a = 0; a < A; ++a) s = s + expf(xr[a] - mx);
  actions[b] = best;
  logp[b] = (xr[best] - mx) - logf(s);
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

// ------------------------------------------------------------------ K13

// K13's arguments, mirrored field for field by rllib_kernels.py's _DqnArgs.
struct DqnArgs {
  float* p[8];          // w1 b1 w2 b2 wp bp wv bv, updated in place
  float* mu[8];         // Adam's first moments, in place
  float* nu[8];         // Adam's second moments, in place
  const float* tgt[6];  // the target network's w1 b1 w2 b2 wp bp
  // staged batch: obs [B, O], next_obs [B, O], rewards [B], dones [B],
  // actions [B] (int32 bits)
  const float* batch;
  float* stats;  // [3]: Huber loss mean, mean |td|, mean q
  int B, O, H, A;
  int R;  // rows a tile: the batch passes through shared memory R rows at a time
  float gamma, b1, b2, omb1, omb2, eps, bc1, bc2, wd, nlr;
};

// One network's weights in shared memory; w2's rows padded to H + 1.
struct SmemNet {
  float *w1, *b1, *w2, *b2, *wp, *bp;
};

__host__ __device__ inline int dqn_net_floats(int O, int H, int A) {
  return O * H + H + H * (H + 1) + H + H * A + A;
}

// The online network's gradient: w1 b1 w2 b2 wp bp, unpadded.
__host__ __device__ inline int dqn_grad_floats(int O, int H, int A) {
  return O * H + H + H * H + H + H * A + A;
}

// Shared memory of K13 at R rows a tile: two networks, the gradient, the
// tile's obs and next_obs, h1 and h2 (rows padded to H + 1), q, the online
// next Q, the target next Q, and the block's reduction buffer.
__host__ __device__ inline long long dqn_smem_floats(int R, int O, int H, int A) {
  return 2LL * dqn_net_floats(O, H, A) + dqn_grad_floats(O, H, A) + 2LL * R * O +
         2LL * R * (H + 1) + 3LL * R * A + kLossThreads;
}

__device__ float* carve_net(float* base, SmemNet* n, int O, int H, int A) {
  n->w1 = base;
  n->b1 = n->w1 + O * H;
  n->w2 = n->b1 + H;
  n->b2 = n->w2 + H * (H + 1);
  n->wp = n->b2 + H;
  n->bp = n->wp + H * A;
  return n->bp + A;
}

__device__ void load_net(SmemNet n, const float* const* g, int O, int H, int A) {
  const int t = threadIdx.x, T = blockDim.x;
  for (int e = t; e < O * H; e += T) n.w1[e] = g[0][e];
  for (int e = t; e < H; e += T) n.b1[e] = g[1][e];
  for (int e = t; e < H * H; e += T) n.w2[(e / H) * (H + 1) + e % H] = g[2][e];
  for (int e = t; e < H; e += T) n.b2[e] = g[3][e];
  for (int e = t; e < H * A; e += T) n.wp[e] = g[4][e];
  for (int e = t; e < A; e += T) n.bp[e] = g[5][e];
}

// out(m, n) = s0(m, n) + the sum over k < K, k ascending, of X[m*sxm +
// k*sxk] * Y[k*syk + n*syn] for m < M, n < N, strided over the block's
// threads; f(m, n, sum) takes each one. An entry's thread is fixed by (M,
// N), so a gradient summed over tiles (s0 its sum so far) adds the rows in
// batch order, as one sum over the whole batch would.
struct Zero {
  __device__ float operator()(int, int) const { return 0.0f; }
};

template <class S, class F>
__device__ __forceinline__ void block_mm(const float* X, int sxm, int sxk, const float* Y,
                                         int syk, int syn, int M, int N, int K, S s0, F f) {
  for (int e = threadIdx.x; e < M * N; e += blockDim.x) {
    const int m = e / N, n = e - (e / N) * N;
    const float* x = X + m * sxm;
    const float* y = Y + n * syn;
    float s = s0(m, n);
    for (int k = 0; k < K; ++k) s = s + x[k * sxk] * y[k * syk];
    f(m, n, s);
  }
}

// h1 = tanh(x @ w1 + b1), h2 = tanh(h1 @ w2 + b2), q = h2 @ wp + bp.
__device__ void trunk_and_head(const SmemNet& n, const float* x, float* h1, float* h2,
                               float* q, int B, int O, int H, int A) {
  const int L = H + 1;
  block_mm(x, O, 1, n.w1, H, 1, B, H, O, Zero(),
           [&](int b, int i, float s) { h1[b * L + i] = tanhf(s + n.b1[i]); });
  __syncthreads();
  block_mm(h1, L, 1, n.w2, L, 1, B, H, H, Zero(),
           [&](int b, int j, float s) { h2[b * L + j] = tanhf(s + n.b2[j]); });
  __syncthreads();
  block_mm(h2, L, 1, n.wp, A, 1, B, A, H, Zero(),
           [&](int b, int a, float s) { q[b * A + a] = s + n.bp[a]; });
  __syncthreads();
}

// AdamW.update's step of entry i of one parameter from its gradient g (a:
// K12's or K13's arguments).
template <class Args>
__device__ __forceinline__ void adam(const Args& a, int which, long long i, float g) {
  float* p = a.p[which];
  float* mu = a.mu[which];
  float* nu = a.nu[which];
  const float m1 = mu[i] * a.b1 + g * a.omb1;
  const float v1 = nu[i] * a.b2 + (g * g) * a.omb2;
  const float denom = sqrtf(v1 / a.bc2) + a.eps;
  float u = (m1 / a.bc1) / denom;
  const float pv = p[i];
  u = u + pv * a.wd;
  p[i] = pv + u * a.nlr;
  mu[i] = m1;
  nu[i] = v1;
}

__global__ void __launch_bounds__(kLossThreads) dqn_update_kernel(DqnArgs a) {
  extern __shared__ float smem[];
  const int B = a.B, O = a.O, H = a.H, A = a.A, R = a.R, L = H + 1;
  const int t = threadIdx.x, T = blockDim.x;
  SmemNet on, tg;
  float* cur = carve_net(smem, &on, O, H, A);
  cur = carve_net(cur, &tg, O, H, A);
  float* gw1 = cur;
  float* gb1 = gw1 + O * H;
  float* gw2 = gb1 + H;
  float* gb2 = gw2 + H * H;
  float* gwp = gb2 + H;
  float* gbp = gwp + H * A;
  float* x = gbp + A;
  float* xn = x + R * O;
  float* h1 = xn + R * O;
  float* h2 = h1 + R * L;
  float* q = h2 + R * L;
  float* qo = q + R * A;
  float* qt = qo + R * A;
  float* red = qt + R * A;
  const float* rewards = a.batch + 2LL * B * O;
  const float* dones = rewards + B;
  const int* actions = reinterpret_cast<const int*>(dones + B);

  load_net(on, a.p, O, H, A);
  load_net(tg, a.tgt, O, H, A);
  for (int e = t; e < dqn_grad_floats(O, H, A); e += T) gw1[e] = 0.0f;
  const float nb = (float)B;
  float s_loss = 0.0f, s_abs = 0.0f, s_q = 0.0f;
  for (int r0 = 0; r0 < B; r0 += R) {
    const int M = min(R, B - r0);
    for (int e = t; e < M * O; e += T) {
      x[e] = a.batch[(long long)r0 * O + e];
      xn[e] = a.batch[(long long)(B + r0) * O + e];
    }
    __syncthreads();
    // the three trunks: online and target on next_obs, then online on obs
    // (its h1, h2 kept for the backward)
    trunk_and_head(on, xn, h1, h2, qo, M, O, H, A);
    trunk_and_head(tg, xn, h1, h2, qt, M, O, H, A);
    trunk_and_head(on, x, h1, h2, q, M, O, H, A);

    // the TD head, its stats and dq (into q, row by row)
    for (int b = t; b < M; b += T) {
      const float* qor = qo + b * A;
      int an = 0;
      for (int k = 1; k < A; ++k)
        if (qor[k] > qor[an]) an = k;
      const float q_next = qt[b * A + an];
      const float target = rewards[r0 + b] + (a.gamma * (1.0f - dones[r0 + b])) * q_next;
      float* qr = q + b * A;
      const int act = actions[r0 + b];
      const float td = qr[act] - target;
      const float ab = fabsf(td);
      const float quad = fminf(ab, 1.0f);
      const float lin = ab - quad;
      s_loss = s_loss + (0.5f * (quad * quad) + 1.0f * lin);
      s_abs = s_abs + ab;
      for (int k = 0; k < A; ++k) {
        s_q = s_q + qr[k];
        qr[k] = 0.0f;
      }
      // huber's backward: ct 1/B on the row's loss
      const float ct = 1.0f / nb;
      const float ct_lin = 1.0f * ct;
      const float ct_quad = (0.5f * ct) * (2.0f * quad) - ct_lin;
      const float ct_abs = ct_lin + ct_quad * balanced(ab, quad, 1.0f);
      qr[act] = td > 0.0f ? ct_abs : (td < 0.0f ? -ct_abs : 0.0f);
    }
    __syncthreads();
    const float* dq = q;

    // the head: d wp += h2^T dq, d bp += the sum of dq
    block_mm(h2, 1, L, dq, A, 1, H, A, M, [&](int j, int k) { return gwp[j * A + k]; },
             [&](int j, int k, float s) { gwp[j * A + k] = s; });
    for (int k = t; k < A; k += T) {
      float s = gbp[k];
      for (int b = 0; b < M; ++b) s = s + dq[b * A + k];
      gbp[k] = s;
    }
    __syncthreads();
    // dz2 = (dq @ wp^T) * (1 - h2^2), into h2
    block_mm(dq, A, 1, on.wp, 1, A, M, H, A, Zero(), [&](int b, int j, float s) {
      const float y = h2[b * L + j];
      h2[b * L + j] = s * (1.0f - y * y);
    });
    __syncthreads();
    // d w2 += h1^T dz2, d b2 += the sum of dz2
    block_mm(h1, 1, L, h2, L, 1, H, H, M, [&](int i, int j) { return gw2[i * H + j]; },
             [&](int i, int j, float s) { gw2[i * H + j] = s; });
    for (int j = t; j < H; j += T) {
      float s = gb2[j];
      for (int b = 0; b < M; ++b) s = s + h2[b * L + j];
      gb2[j] = s;
    }
    __syncthreads();
    // dz1 = (dz2 @ w2^T) * (1 - h1^2), into h1
    block_mm(h2, L, 1, on.w2, 1, L, M, H, H, Zero(), [&](int b, int i, float s) {
      const float y = h1[b * L + i];
      h1[b * L + i] = s * (1.0f - y * y);
    });
    __syncthreads();
    // d w1 += obs^T dz1, d b1 += the sum of dz1
    block_mm(x, 1, O, h1, L, 1, O, H, M, [&](int k, int i) { return gw1[k * H + i]; },
             [&](int k, int i, float s) { gw1[k * H + i] = s; });
    for (int i = t; i < H; i += T) {
      float s = gb1[i];
      for (int b = 0; b < M; ++b) s = s + h1[b * L + i];
      gb1[i] = s;
    }
    __syncthreads();
  }
  const float loss = block_sum(s_loss, red) / nb;
  const float td_abs = block_sum(s_abs, red) / nb;
  const float q_mean = block_sum(s_q, red) / (nb * (float)A);
  if (t == 0) {
    a.stats[0] = loss;
    a.stats[1] = td_abs;
    a.stats[2] = q_mean;
  }
  // Adam on every entry; the unread value head's gradient is 0
  for (int e = t; e < O * H; e += T) adam(a, 0, e, gw1[e]);
  for (int e = t; e < H; e += T) adam(a, 1, e, gb1[e]);
  for (int e = t; e < H * H; e += T) adam(a, 2, e, gw2[e]);
  for (int e = t; e < H; e += T) adam(a, 3, e, gb2[e]);
  for (int e = t; e < H * A; e += T) adam(a, 4, e, gwp[e]);
  for (int e = t; e < A; e += T) adam(a, 5, e, gbp[e]);
  for (int e = t; e <= H; e += T) adam(a, e < H ? 6 : 7, e < H ? e : 0, 0.0f);
}


// ------------------------------------------------------------------ K12

// K12's arguments, mirrored field for field by rllib_kernels.py's _PgArgs.
struct PgArgs {
  float* p[8];   // w1 b1 w2 b2 wp bp wv bv, updated in place
  float* mu[8];  // Adam's first moments, in place
  float* nu[8];  // Adam's second moments, in place
  // staged batch of B rows: obs [B, O], actions [B] (int32 bits), returns
  // [B], logp_old [B] (read in PPO's mode only), mask [B]
  const float* batch;
  float* stats;  // [3]: total, pg, vf
  int B, O, H, A;
  int P;     // the cluster's blocks: block r takes rows [r*B/P, (r+1)*B/P)
  int R;     // rows a tile: a block passes its rows through shared memory R at a time
  int mode;  // 0 PG, 1 PPO with the ratio clipped to [lo, hi]
  float lo, hi, b1, b2, omb1, omb2, eps, bc1, bc2, wd, nlr;
};

constexpr int kPgThreads = 1024;
constexpr int kMaxCluster = 16;  // a non-portable cluster size sm_90 allows
constexpr int kPgSums = 4;       // the most sums one block_sums call takes
// the warps' partials, the block's exchanged partials (8), the cluster's sums (8)
constexpr int kPgRed = 32 * kPgSums + 16;

// The network in shared memory: the trunk, then the head [H, A + 1] whose
// column A is the value head (wv), and its bias [A + 1] (bv last).
__host__ __device__ inline int pg_net_floats(int O, int H, int A) {
  return O * H + H + H * (H + 1) + H + (H + 1) * (A + 1);
}

// The gradient, unpadded, in the network's order: w1 b1 w2 b2, the head, its bias.
__host__ __device__ inline int pg_grad_floats(int O, int H, int A) {
  return O * H + H + H * H + H + (H + 1) * (A + 1);
}

// Shared memory of K12 with at most Q rows a block, R a tile: the network,
// the gradient, the block's rows' logits and v, the tile's obs, h1 and h2
// (rows padded to H + 1), and the reductions' scratch.
__host__ __device__ inline long long pg_smem_floats(int Q, int R, int O, int H, int A) {
  return (long long)pg_net_floats(O, H, A) + pg_grad_floats(O, H, A) + (long long)Q * (A + 1) +
         (long long)R * (O + 2 * (H + 1)) + kPgRed;
}

__device__ void load_pg_net(const SmemNet& n, const PgArgs& a, int O, int H, int A) {
  const int t = threadIdx.x, T = blockDim.x, W = A + 1;
  for (int e = t; e < O * H; e += T) n.w1[e] = a.p[0][e];
  for (int e = t; e < H; e += T) n.b1[e] = a.p[1][e];
  for (int e = t; e < H * H; e += T) n.w2[(e / H) * (H + 1) + e % H] = a.p[2][e];
  for (int e = t; e < H; e += T) n.b2[e] = a.p[3][e];
  for (int e = t; e < H * W; e += T) {
    const int j = e / W, c = e - j * W;
    n.wp[e] = c < A ? a.p[4][j * A + c] : a.p[6][j];
  }
  for (int c = t; c < W; c += T) n.bp[c] = c < A ? a.p[5][c] : a.p[7][0];
}

// Entry e of the gradient's layout as (parameter, index): the head's column
// A is wv, its bias's entry A is bv.
__device__ __forceinline__ void pg_entry(int e, int O, int H, int A, int* which, int* idx) {
  const int W = A + 1;
  const int n0 = O * H, n1 = n0 + H, n2 = n1 + H * H, n3 = n2 + H, n4 = n3 + H * W;
  if (e < n0) {
    *which = 0;
    *idx = e;
  } else if (e < n1) {
    *which = 1;
    *idx = e - n0;
  } else if (e < n2) {
    *which = 2;
    *idx = e - n1;
  } else if (e < n3) {
    *which = 3;
    *idx = e - n2;
  } else if (e < n4) {
    const int f = e - n3, j = f / W, c = f - j * W;
    *which = c < A ? 4 : 6;
    *idx = c < A ? j * A + c : j;
  } else {
    const int c = e - n4;
    *which = c < A ? 5 : 7;
    *idx = c < A ? c : 0;
  }
}

// The sums over the block of N values a thread: a fixed shuffle tree in each
// warp, then every thread adds the warps' partials in warp order, so every
// thread holds the same bits.
template <int N>
__device__ __forceinline__ void block_sums(float (&v)[N], float* red) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, nw = blockDim.x >> 5;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float x = v[i];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x = x + __shfl_down_sync(0xffffffffu, x, o);
    if (lane == 0) red[w * N + i] = x;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float s = 0.0f;
    for (int k = 0; k < nw; ++k) s = s + red[k * N + i];
    v[i] = s;
  }
  __syncthreads();
}

// Slots [i0, i1) of part[], summed over the cluster's blocks in rank order
// (DSMEM reads) into sums[]: every block gets the same bits. Called after the
// cluster.sync() that follows the partials' writes.
__device__ __forceinline__ void cluster_sums(cg::cluster_group& cluster, float* part,
                                             float* sums, int i0, int i1, int P) {
  const int i = i0 + (int)threadIdx.x;
  if (i < i1) {
    float s = 0.0f;
    for (int r = 0; r < P; ++r) s = s + cluster.map_shared_rank(part, r)[i];
    sums[i] = s;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kPgThreads) pg_update_kernel(PgArgs a) {
  extern __shared__ float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int B = a.B, O = a.O, H = a.H, A = a.A, P = a.P, R = a.R, W = A + 1, L = H + 1;
  const int t = threadIdx.x, T = blockDim.x;
  const int Q = (B + P - 1) / P;
  const int G = pg_grad_floats(O, H, A);
  SmemNet net;  // wp, bp: the head [H, W] and its bias [W]
  float* gw1 = carve_net(smem, &net, O, H, W);
  float* gb1 = gw1 + O * H;
  float* gw2 = gb1 + H;
  float* gb2 = gw2 + H * H;
  float* gh = gb2 + H;
  float* gbh = gh + H * W;
  float* kp = gbh + W;      // [Q, W]: the block's rows' logits and v, then their gradient
  float* x = kp + Q * W;    // [R, O]
  float* h1 = x + R * O;    // [R, L]
  float* h2 = h1 + R * L;   // [R, L]
  float* red = h2 + R * L;  // block_sums' scratch
  float* part = red + 32 * kPgSums;
  float* sums = part + 8;
  const int row0 = (int)((long long)rank * B / P);
  const int rows = (int)((long long)(rank + 1) * B / P) - row0;
  const float* obs = a.batch;
  const int* actions = reinterpret_cast<const int*>(a.batch + (long long)B * O);
  const float* returns = a.batch + (long long)B * (O + 1);
  const float* logp_old = returns + B;
  const float* mask = logp_old + B;

  load_pg_net(net, a, O, H, A);
  for (int e = t; e < G; e += T) gw1[e] = 0.0f;
  __syncthreads();
  // pass 1: each tile's trunk and heads; the rows' logits and v kept (with
  // one tile its h1, h2 too, for pass 2)
  const bool one_tile = rows <= R;
  for (int r0 = 0; r0 < rows; r0 += R) {
    const int M = min(R, rows - r0);
    for (int e = t; e < M * O; e += T) x[e] = obs[(long long)(row0 + r0) * O + e];
    __syncthreads();
    trunk_and_head(net, x, h1, h2, kp + r0 * W, M, O, H, W);
  }

  // the cluster's n = max(sum m, 1) and mean of adv = returns - v, then
  // its masked variance
  float s2[2] = {0.0f, 0.0f};
  for (int i = t; i < rows; i += T) {
    const float m = mask[row0 + i];
    s2[0] = s2[0] + m;
    s2[1] = s2[1] + (returns[row0 + i] - kp[i * W + A]) * m;
  }
  block_sums(s2, red);
  if (t == 0) {
    part[0] = s2[0];
    part[1] = s2[1];
  }
  cluster.sync();
  cluster_sums(cluster, part, sums, 0, 2, P);
  const float n = fmaxf(sums[0], 1.0f);
  const float mean = sums[1] / n;
  float s1[1] = {0.0f};
  for (int i = t; i < rows; i += T) {
    const float c = (returns[row0 + i] - kp[i * W + A]) - mean;
    s1[0] = s1[0] + (c * c) * mask[row0 + i];
  }
  block_sums(s1, red);
  if (t == 0) part[2] = s1[0];
  cluster.sync();
  cluster_sums(cluster, part, sums, 2, 3, P);
  const float denom = sqrtf(sums[2] / n) + 1e-6f;
  // the cotangents of total's three terms: 1 for pg, 0.5 for vf, -0.01 for
  // the entropy bonus, each through its "/ n"
  const float ct_sum_pg = -(1.0f / n);
  const float ct_sum_vf = 0.5f / n;
  const float ct_sum_ent = -0.01f / n;

  // pass 2: a tile's loss head and its gradient rows, then the backward
  float s3[3] = {0.0f, 0.0f, 0.0f};
  float ex[kMaxActions], lp[kMaxActions];
  for (int r0 = 0; r0 < rows; r0 += R) {
    const int M = min(R, rows - r0);
    float* dl = kp + r0 * W;
    if (!one_tile) {  // the same code on the same rows: the same bits as pass 1
      for (int e = t; e < M * O; e += T) x[e] = obs[(long long)(row0 + r0) * O + e];
      __syncthreads();
      trunk_and_head(net, x, h1, h2, dl, M, O, H, W);
    }
    for (int b = t; b < M; b += T) {
      const int row = row0 + r0 + b;
      float* xr = dl + b * W;  // the row's logits and v, then their gradient
      const float m = mask[row];
      const int act = actions[row];
      float s;
      log_softmax_row(xr, A, ex, lp, &s);
      const float d = returns[row] - xr[A];
      const float adv = (d - mean) / denom;
      float ct_act;  // the cotangent of logp[act]
      if (a.mode == 0) {
        s3[0] = s3[0] + (lp[act] * adv) * m;
        ct_act = (ct_sum_pg * m) * adv;
      } else {
        const float ratio = expf(lp[act] - logp_old[row]);
        const float r_lo = fmaxf(a.lo, ratio);
        const float r_clip = fminf(a.hi, r_lo);
        const float pa = ratio * adv;
        const float pb = r_clip * adv;
        const float surr = fminf(pa, pb);
        s3[0] = s3[0] + surr * m;
        const float ct_surr = ct_sum_pg * m;
        const float ct_pa = ct_surr * balanced(pa, surr, pb);
        const float ct_pb = ct_surr * balanced(pb, surr, pa);
        const float w_clip = balanced(r_lo, r_clip, a.hi) * balanced(ratio, r_lo, a.lo);
        const float ct_ratio = ct_pa * adv + (ct_pb * adv) * w_clip;
        ct_act = ct_ratio * ratio;
      }
      s3[1] = s3[1] + (d * d) * m;
      float ent = 0.0f;
      for (int k = 0; k < A; ++k) ent = ent + expf(lp[k]) * lp[k];
      s3[2] = s3[2] + (-ent) * m;
      // the entropy's cotangent c on each p * logp; then log_softmax's
      // backward (lp[k] becomes the gradient g[k] once read)
      const float c = -(ct_sum_ent * m);
      float gsum = 0.0f;
      for (int k = 0; k < A; ++k) {
        const float p = expf(lp[k]);
        float gk = c * p + (c * lp[k]) * p;
        if (k == act) gk = gk + ct_act;
        lp[k] = gk;
        gsum = gsum + gk;
      }
      const float ct_s = -gsum / s;
      for (int k = 0; k < A; ++k) xr[k] = lp[k] + ct_s * ex[k];
      xr[A] = -((ct_sum_vf * m) * (2.0f * d));
    }
    __syncthreads();
    // the heads: d[wp | wv] += h2^T [dlogits | dv], d[bp | bv] += their sums
    block_mm(h2, 1, L, dl, W, 1, H, W, M, [&](int j, int c) { return gh[j * W + c]; },
             [&](int j, int c, float s) { gh[j * W + c] = s; });
    for (int c = t; c < W; c += T) {
      float s = gbh[c];
      for (int b = 0; b < M; ++b) s = s + dl[b * W + c];
      gbh[c] = s;
    }
    __syncthreads();
    // dz2 = ([dlogits | dv] @ [wp | wv]^T) * (1 - h2^2), into h2
    block_mm(dl, W, 1, net.wp, 1, W, M, H, W, Zero(), [&](int b, int j, float s) {
      const float y = h2[b * L + j];
      h2[b * L + j] = s * (1.0f - y * y);
    });
    __syncthreads();
    // d w2 += h1^T dz2, d b2 += the sum of dz2
    block_mm(h1, 1, L, h2, L, 1, H, H, M, [&](int i, int j) { return gw2[i * H + j]; },
             [&](int i, int j, float s) { gw2[i * H + j] = s; });
    for (int j = t; j < H; j += T) {
      float s = gb2[j];
      for (int b = 0; b < M; ++b) s = s + h2[b * L + j];
      gb2[j] = s;
    }
    __syncthreads();
    // dz1 = (dz2 @ w2^T) * (1 - h1^2), into h1
    block_mm(h2, L, 1, net.w2, 1, L, M, H, H, Zero(), [&](int b, int i, float s) {
      const float y = h1[b * L + i];
      h1[b * L + i] = s * (1.0f - y * y);
    });
    __syncthreads();
    // d w1 += obs^T dz1, d b1 += the sum of dz1
    block_mm(x, 1, O, h1, L, 1, O, H, M, [&](int k, int i) { return gw1[k * H + i]; },
             [&](int k, int i, float s) { gw1[k * H + i] = s; });
    for (int i = t; i < H; i += T) {
      float s = gb1[i];
      for (int b = 0; b < M; ++b) s = s + h1[b * L + i];
      gb1[i] = s;
    }
    __syncthreads();
  }
  block_sums(s3, red);
  if (t == 0) {
    part[3] = s3[0];
    part[4] = s3[1];
    part[5] = s3[2];
  }
  cluster.sync();  // every block's loss partials and gradient complete
  if (rank == 0) {
    cluster_sums(cluster, part, sums, 3, 6, P);
    if (t == 0) {
      const float pg = -sums[3] / n;
      const float vf = sums[4] / n;
      const float entb = sums[5] / n;
      a.stats[0] = (pg + 0.5f * vf) - 0.01f * entb;
      a.stats[1] = pg;
      a.stats[2] = vf;
    }
  }
  // Adam on this block's slice of the entries, each gradient entry the sum
  // of the P blocks' partials in rank order
  const int e0 = (int)((long long)G * rank / P);
  const int e1 = (int)((long long)G * (rank + 1) / P);
  for (int e = e0 + t; e < e1; e += T) {
    float g = 0.0f;
    for (int r = 0; r < P; ++r) g = g + cluster.map_shared_rank(gw1, r)[e];
    int which, idx;
    pg_entry(e, O, H, A, &which, &idx);
    adam(a, which, idx, g);
  }
  cluster.sync();  // no block exits while a peer still reads its shared memory
}

}  // namespace

extern "C" {

const char* rl_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// The wrappers' one wait a step: the stream's work done, its outputs in
// pinned host memory readable.
int rl_stream_sync(void* stream) {
  return (int)cudaStreamSynchronize((cudaStream_t)stream);
}

// The device address of pinned host memory (the kernels write K11's
// actions and log-probabilities there).
int rl_device_pointer(void* host, void** device) {
  return (int)cudaHostGetDevicePointer(device, host, 0);
}

// K11: params = 6 device pointers (w1 b1 w2 b2 wp bp); obs [B, O]: with
// obs_staged 0 a host pointer of B*O <= kArgObs floats, copied into the
// kernel's arguments; with 1 the card's address of pinned host memory.
// actions, logp: [B] where the card writes (the device address of pinned
// host memory); key_out [2] apart from key_in.
int rl_policy_sample(const float* const* params, const float* obs, int obs_staged,
                     const long long* key_in, int* actions, float* logp, long long* key_out,
                     int B, int O, int H, int A, void* stream) {
  if (B <= 0 || O <= 0 || O > kMaxObs || H <= 0 || H > kMaxHidden || A <= 0 ||
      A > kMaxActions || key_in == key_out || (!obs_staged && B * O > kArgObs)) {
    return (int)cudaErrorInvalidValue;
  }
  PolicyPtrs net;
  for (int i = 0; i < 6; ++i) net.w[i] = params[i];
  ObsArg arg;
  if (!obs_staged) {
    for (int i = 0; i < B * O; ++i) arg.v[i] = obs[i];
  }
  const int blocks = (B + kPolicyRows - 1) / kPolicyRows;
  policy_sample_kernel<<<blocks, kPolicyThreads, 0, (cudaStream_t)stream>>>(
      net, arg, obs_staged ? obs : nullptr, key_in, actions, logp, key_out, B, O, H, A);
  return (int)cudaGetLastError();
}

// K12: one PG (mode 0) or PPO (mode 1) update, params and moments in place,
// stats [3]. args is a PgArgs (a void pointer, as K13's). One cluster of P
// blocks: P, R and the shared memory are mirrored by rllib_kernels.py's
// pg_plan, whose limit check raises.
int rl_pg_update(const void* args, void* stream) {
  const PgArgs& a = *static_cast<const PgArgs*>(args);
  if (a.B <= 0 || a.O <= 0 || a.H <= 0 || a.A <= 0 || a.A > kMaxActions || a.P <= 0 ||
      a.P > kMaxCluster || a.P > a.B || a.R <= 0 || a.mode < 0 || a.mode > 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int Q = (a.B + a.P - 1) / a.P;
  const long long bytes = pg_smem_floats(Q, a.R, a.O, a.H, a.A) * (long long)sizeof(float);
  if (a.R > Q || bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
  static int opted_in = 0;  // the attributes are per function: set them once
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        pg_update_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(pg_update_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
    if (err != cudaSuccess) return (int)err;
    opted_in = 1;
  }
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = (unsigned)a.P;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)a.P, 1, 1);
  cfg.blockDim = dim3(kPgThreads, 1, 1);
  cfg.dynamicSmemBytes = (size_t)bytes;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, pg_update_kernel, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// K13: one DQN update, params and moments in place, stats [3]. args is a
// DqnArgs (a void pointer: a type of this file's anonymous namespace would
// give the entry point internal linkage).
int rl_dqn_update(const void* args, void* stream) {
  const DqnArgs& a = *static_cast<const DqnArgs*>(args);
  if (a.B <= 0 || a.O <= 0 || a.H <= 0 || a.A <= 0 || a.A > kMaxActions || a.R <= 0 ||
      a.R > a.B) {
    return (int)cudaErrorInvalidValue;
  }
  // mirrored by rllib_kernels.py's dqn_smem_bytes, whose limit check raises
  const long long bytes = dqn_smem_floats(a.R, a.O, a.H, a.A) * (long long)sizeof(float);
  if (bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
  static int opted_in = 0;  // the attribute is per function: set it once
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        dqn_update_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    opted_in = 1;
  }
  dqn_update_kernel<<<1, kLossThreads, (size_t)bytes, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
