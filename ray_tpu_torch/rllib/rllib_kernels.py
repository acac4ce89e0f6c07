"""RLlib's device programs: hand-written CUDA kernels (csrc/rllib_kernels.cu,
built on first CUDA use) each beside its plain PyTorch version.

  K11 sample_actions  ray_tpu/rllib/policy.py :49-57 with env_runner.py :51:
                      the runner's key split, the categorical draw over the
                      logits by Gumbel-max on threefry2x32 bits (prng.py is
                      its plain version's arithmetic) and log_softmax at
                      the drawn action; returns the next key, so the key
                      chain stays on the device
  K12 pg_loss         policy.py :71-88 (pg_update) and :105-127
                      (ppo_update): the loss head past the trunk and its
                      gradient with respect to the logits and the value
  K13 dqn_loss        policy.py :160-179 (dqn_update): the double-DQN TD
                      head and Huber loss past the three trunks, and dq

K12 and K13 write the loss and its gradient in one launch. ``PGLoss`` and
``DQNLoss`` are autograd Functions whose backward scales that saved
gradient by the incoming cotangent of the total loss; the trunk's products
and Adam stay torch ops (policy.py).

Their plain versions spell out the reference's steps and the gradients of
its ``jax.value_and_grad``: jax.nn.log_softmax as x - max - log(sum exp(x -
max)), the sum in action order; jnp.minimum, jnp.clip and optax.huber_loss
with lax.min / lax.max's balanced gradient (half to each side at a tie:
every PPO row whose ratio lies inside the clip range on the first epoch,
the clip ends, |td| = 1); every division of a tensor a true division of two
tensors (``tensor / python_scalar`` multiplies by the reciprocal on CUDA).

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises — there is no fallback from one to the
other. Each wrapper counts the calls that launched its kernel in
``launches`` (under a lock: env runners sample from threads of one
process). On the card K11 equals its plain version bit for bit (actions,
log-probabilities and keys); K12 and K13 sum the batch in another order
than torch.sum, so they agree within a tolerance, and two launches give the
same bits.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

from ray_tpu_torch.rllib import prng
from ray_tpu_torch.util import cuda_build
from ray_tpu_torch.util.device import current_stream, device_of

_SRC = Path(__file__).resolve().parent / "csrc" / "rllib_kernels.cu"
#: --fmad=false: K11 must equal its plain version bit for bit
NVCC_FLAGS = cuda_build.BASE_FLAGS + ("--fmad=false",)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "rl_sample_actions": ([_P] * 5 + [_I, _I, _P], _I),
    "rl_pg_loss": ([_P] * 9 + [_I, _I, _I, _F, _F, _P], _I),
    "rl_dqn_loss": ([_P] * 8 + [_I, _I, _F, _P], _I),
    "rl_error_string": ([_I], ctypes.c_char_p),
}

LIBRARY = cuda_build.CudaLibrary("rllib", _SRC, NVCC_FLAGS, _SIGNATURES)

MAX_ACTIONS = 64
#: a draw may differ from JAX's only where the top-2 gap of logits + Gumbel
#: noise is below this (logf on the card, XLA's log, and the logits' last
#: bits differ by an ulp); as MOE_TIE_GAP for the expert layer's routing
RL_TIE_GAP = 1e-5
#: PPO's clip range (policy.py :100 ppo_update's default)
PPO_CLIP = 0.2
_PG, _PPO = 0, 1
_count_lock = threading.Lock()


def _count(fn) -> None:
    with _count_lock:
        fn.launches += 1


def _check(lib, rc: int, kernel: str) -> None:
    if rc != 0:
        msg = lib.rl_error_string(rc).decode(errors="replace")
        raise RuntimeError(f"CUDA kernel {kernel} failed to launch: {msg} ({rc})")


def _check_rows(what: str, x: torch.Tensor) -> None:
    if x.dim() != 2 or x.dtype != torch.float32 or min(x.shape) == 0 \
            or x.shape[1] > MAX_ACTIONS:
        raise ValueError(f"{what}: {tuple(x.shape)} {x.dtype} (float32 [B, A], 0 < A <= "
                         f"{MAX_ACTIONS}, needed)")


def _check_vectors(what: str, B: int, **vectors) -> None:
    for name, t in vectors.items():
        want = torch.int32 if name == "actions" else torch.float32
        if t.shape != (B,) or t.dtype != want:
            raise ValueError(f"{what}: {name} {tuple(t.shape)} {t.dtype} ({want} [{B}] "
                             "needed)")


def _contiguous(what: str, *tensors) -> None:
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{what}: tensors must be contiguous")


def _div(a, b: torch.Tensor) -> torch.Tensor:
    """a / b as a true division of two tensors (a may be a Python float)."""
    if not torch.is_tensor(a):
        a = torch.full((), a, dtype=torch.float32, device=b.device)
    return torch.div(a, b)


def _sum_in_order(x: torch.Tensor) -> torch.Tensor:
    """The sum over the last axis, column by column, as the kernels take it."""
    s = x[..., 0]
    for a in range(1, x.shape[-1]):
        s = s + x[..., a]
    return s


def log_softmax_plain(x: torch.Tensor):
    """jax.nn.log_softmax over the last axis, step for step: (shifted, e,
    s, logp) with shifted = x - max, e = exp(shifted), s their sum in
    action order, logp = shifted - log(s)."""
    shifted = x - x.max(dim=-1, keepdim=True).values
    e = torch.exp(shifted)
    s = _sum_in_order(e)
    return shifted, e, s, shifted - torch.log(s)[..., None]


# ------------------------------------------------------------------ K11


def sample_actions_plain(logits: torch.Tensor, key: torch.Tensor):
    """Plain version of K11: key, sub = split(key); actions =
    categorical(sub, logits); logp = log_softmax(logits)[actions]. Returns
    (actions int32 [B], logp float32 [B], the next key)."""
    next_key, bits = prng.split_and_bits(key, logits.shape)
    actions = prng.categorical_of_bits(bits.to(logits.device), logits)
    shifted, _, s, _ = log_softmax_plain(logits)
    at = shifted.gather(1, actions.long()[:, None])[:, 0]
    return actions, at - torch.log(s), next_key.to(logits.device)


def sample_actions(logits: torch.Tensor, key: torch.Tensor):
    """K11. logits [B, A] float32, key int64 [2] (a JAX threefry key's two
    uint32 words) -> (actions int32 [B], logp float32 [B], next key int64
    [2]), drawn as the reference's runner draws one step: key, sub =
    jax.random.split(key); jax.random.categorical(sub, logits) and its
    log-probability; the next key is split's first half."""
    _check_rows("sample_actions", logits)
    if key.shape != (2,) or key.dtype != torch.int64:
        raise ValueError(f"sample_actions: key {tuple(key.shape)} {key.dtype} (int64 [2] "
                         "needed)")
    dev = device_of(logits, key)
    if dev.type == "cpu":
        return sample_actions_plain(logits, key)
    _contiguous("sample_actions", logits, key)
    B, A = logits.shape
    lib = LIBRARY.load()
    actions = torch.empty(B, dtype=torch.int32, device=dev)
    logp = torch.empty(B, dtype=torch.float32, device=dev)
    key_out = torch.empty(2, dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        rc = lib.rl_sample_actions(logits.data_ptr(), key.data_ptr(), actions.data_ptr(),
                                   logp.data_ptr(), key_out.data_ptr(), B, A,
                                   current_stream(dev))
    _check(lib, rc, "sample_actions")
    _count(sample_actions)
    return actions, logp, key_out


sample_actions.launches = 0


# ------------------------------------------------------------------ K12


def _balanced(x, z, y):
    """lax.min / lax.max's gradient weight for x in op(x, y) = z."""
    return _div((x == z).float(), torch.where(y == z, 2.0, 1.0))


def ppo_surrogate(ratio: torch.Tensor, adv: torch.Tensor, clip: float):
    """PPO's surrogate min(ratio * adv, clip(ratio, 1 - clip, 1 + clip) *
    adv) (jnp.clip is maximum then minimum) and the weights of its gradient
    as lax.min and lax.max give them: (surr, w_a, w_b, w_clip) with d surr
    / d ratio = w_a * adv + w_b * adv * w_clip. At a tie each side takes
    half: inside the clip range w_a = w_b = 1/2; at ratio = 1 + clip with
    adv > 0 also w_clip = 1/2, so the derivative is 3/4 of adv."""
    lo = torch.tensor(1 - clip, dtype=torch.float32, device=ratio.device)
    hi = torch.tensor(1 + clip, dtype=torch.float32, device=ratio.device)
    r_lo = torch.maximum(lo, ratio)
    r_clip = torch.minimum(hi, r_lo)
    pa, pb = ratio * adv, r_clip * adv
    surr = torch.minimum(pa, pb)
    w_clip = _balanced(r_lo, r_clip, hi) * _balanced(ratio, r_lo, lo)
    return surr, _balanced(pa, surr, pb), _balanced(pb, surr, pa), w_clip


def pg_loss_plain(logits, v, actions, returns, mask, logp_old=None, clip=None):
    """Plain version of K12: PG (clip None) or PPO. Returns (losses [3] =
    total, pg, vf; dlogits [B, A]; dv [B]), the gradient of total."""
    n = torch.clamp_min(mask.sum(), 1.0)
    adv = returns - v
    mean = _div((adv * mask).sum(), n)
    c = adv - mean
    denom = torch.sqrt(_div(((c * c) * mask).sum(), n)) + 1e-6
    adv_n = _div(c, denom)
    shifted, e, s, lp = log_softmax_plain(logits)
    idx = actions.long()[:, None]
    act = lp.gather(1, idx)[:, 0]
    ct_sum_pg = -_div(1.0, n)
    if clip is None:
        pg_terms = (act * adv_n) * mask
        ct_act = (ct_sum_pg * mask) * adv_n
    else:
        ratio = torch.exp(act - logp_old)
        surr, w_a, w_b, w_clip = ppo_surrogate(ratio, adv_n, clip)
        pg_terms = surr * mask
        ct_surr = ct_sum_pg * mask
        ct_ratio = (ct_surr * w_a) * adv_n + ((ct_surr * w_b) * adv_n) * w_clip
        ct_act = ct_ratio * ratio
    d = returns - v
    ent = -_sum_in_order(torch.exp(lp) * lp)
    pg = -_div(pg_terms.sum(), n)
    vf = _div(((d * d) * mask).sum(), n)
    entb = _div((ent * mask).sum(), n)
    total = (pg + 0.5 * vf) - 0.01 * entb
    cvec = -(_div(-0.01, n) * mask)
    p = torch.exp(lp)
    g = cvec[:, None] * p + (cvec[:, None] * lp) * p
    g = g.scatter_add(1, idx, ct_act[:, None])
    ct_s = _div(-_sum_in_order(g), s)
    dlogits = g + ct_s[:, None] * e
    dv = -((_div(0.5, n) * mask) * (2.0 * d))
    return torch.stack([total, pg, vf]), dlogits, dv


def pg_loss(logits, v, actions, returns, mask, logp_old=None, clip=None):
    """K12. logits [B, A], v, returns, mask [B] float32, actions [B] int32,
    and for PPO (clip a float, e.g. PPO_CLIP) logp_old [B] -> (losses [3]
    = total, pg, vf; dlogits [B, A]; dv [B]): the loss of pg_update (clip
    None) or ppo_update and its gradient with respect to logits and v."""
    _check_rows("pg_loss", logits)
    B, A = logits.shape
    vecs = dict(v=v, actions=actions, returns=returns, mask=mask)
    if clip is not None:
        if logp_old is None:
            raise ValueError("pg_loss: PPO (clip given) needs logp_old")
        vecs["logp_old"] = logp_old
    _check_vectors("pg_loss", B, **vecs)
    dev = device_of(logits, *vecs.values())
    if dev.type == "cpu":
        return pg_loss_plain(logits, v, actions, returns, mask, logp_old, clip)
    _contiguous("pg_loss", logits, *vecs.values())
    lib = LIBRARY.load()
    losses = torch.empty(3, dtype=torch.float32, device=dev)
    dlogits = torch.empty_like(logits)
    dv = torch.empty_like(v)
    mode = _PG if clip is None else _PPO
    lo, hi = (0.0, 0.0) if clip is None else (1 - clip, 1 + clip)
    with torch.cuda.device(dev):
        rc = lib.rl_pg_loss(logits.data_ptr(), v.data_ptr(), actions.data_ptr(),
                            returns.data_ptr(), mask.data_ptr(),
                            None if clip is None else logp_old.data_ptr(), losses.data_ptr(),
                            dlogits.data_ptr(), dv.data_ptr(), B, A, mode, lo, hi,
                            current_stream(dev))
    _check(lib, rc, "pg_loss")
    _count(pg_loss)
    return losses, dlogits, dv


pg_loss.launches = 0


class PGLoss(torch.autograd.Function):
    """losses [3] = total, pg, vf of K12; the backward gives logits and v
    K12's gradient of total scaled by total's cotangent."""

    @staticmethod
    def forward(ctx, logits, v, actions, returns, mask, logp_old, clip):
        losses, dlogits, dv = pg_loss(logits.detach(), v.detach(), actions, returns, mask,
                                      logp_old, clip)
        ctx.save_for_backward(dlogits, dv)
        return losses

    @staticmethod
    def backward(ctx, g):
        dlogits, dv = ctx.saved_tensors
        return dlogits * g[0], dv * g[0], None, None, None, None, None


# ------------------------------------------------------------------ K13


def dqn_loss_plain(q, qn_online, qn_target, actions, rewards, dones, gamma):
    """Plain version of K13. Returns (losses [3] = loss, mean |td|, mean q;
    dq [B, A])."""
    B, A = q.shape
    nb = torch.tensor(float(B), dtype=torch.float32, device=q.device)
    a_next = torch.argmax(qn_online, dim=-1)
    q_next = qn_target.gather(1, a_next[:, None])[:, 0]
    g32 = torch.tensor(gamma, dtype=torch.float32, device=q.device)
    target = rewards + (g32 * (1.0 - dones)) * q_next
    idx = actions.long()[:, None]
    td = q.gather(1, idx)[:, 0] - target
    ab = torch.abs(td)
    one = torch.ones((), dtype=torch.float32, device=q.device)
    quad = torch.minimum(ab, one)
    lin = ab - quad
    huber = 0.5 * (quad * quad) + 1.0 * lin
    ct = _div(1.0, nb)
    ct_lin = 1.0 * ct
    ct_quad = (0.5 * ct) * (2.0 * quad) - ct_lin
    ct_abs = ct_lin + ct_quad * _balanced(ab, quad, one)
    ct_td = torch.where(td > 0, ct_abs, torch.where(td < 0, -ct_abs, 0.0))
    dq = torch.zeros_like(q).scatter_(1, idx, ct_td[:, None])
    losses = torch.stack([_div(huber.sum(), nb), _div(ab.sum(), nb),
                          _div(q.sum(), nb * A)])
    return losses, dq


def dqn_loss(q, qn_online, qn_target, actions, rewards, dones, gamma: float):
    """K13. q, qn_online, qn_target [B, A] float32 (Q of obs, and of
    next_obs by the online and the target network), actions [B] int32,
    rewards, dones [B] float32 -> (losses [3] = Huber loss mean, mean
    |td|, mean q; dq [B, A]): dqn_update's loss past the trunks and its
    gradient with respect to q."""
    _check_rows("dqn_loss", q)
    B, A = q.shape
    for name, t in (("qn_online", qn_online), ("qn_target", qn_target)):
        if t.shape != q.shape or t.dtype != torch.float32:
            raise ValueError(f"dqn_loss: {name} {tuple(t.shape)} {t.dtype} (as q needed)")
    _check_vectors("dqn_loss", B, actions=actions, rewards=rewards, dones=dones)
    dev = device_of(q, qn_online, qn_target, actions, rewards, dones)
    if dev.type == "cpu":
        return dqn_loss_plain(q, qn_online, qn_target, actions, rewards, dones, gamma)
    _contiguous("dqn_loss", q, qn_online, qn_target, actions, rewards, dones)
    lib = LIBRARY.load()
    losses = torch.empty(3, dtype=torch.float32, device=dev)
    dq = torch.empty_like(q)
    with torch.cuda.device(dev):
        rc = lib.rl_dqn_loss(q.data_ptr(), qn_online.data_ptr(), qn_target.data_ptr(),
                             actions.data_ptr(), rewards.data_ptr(), dones.data_ptr(),
                             losses.data_ptr(), dq.data_ptr(), B, A, float(gamma),
                             current_stream(dev))
    _check(lib, rc, "dqn_loss")
    _count(dqn_loss)
    return losses, dq


dqn_loss.launches = 0


class DQNLoss(torch.autograd.Function):
    """losses [3] of K13; the backward gives q K13's dq scaled by the
    loss's cotangent (qn_online and qn_target carry no gradient)."""

    @staticmethod
    def forward(ctx, q, qn_online, qn_target, actions, rewards, dones, gamma):
        losses, dq = dqn_loss(q.detach(), qn_online, qn_target, actions, rewards, dones,
                              gamma)
        ctx.save_for_backward(dq)
        return losses

    @staticmethod
    def backward(ctx, g):
        (dq,) = ctx.saved_tensors
        return dq * g[0], None, None, None, None, None, None


#: the kernels of this module by name, each with its `launches` counter
KERNELS = {
    "sample_actions": sample_actions,
    "pg_loss": pg_loss,
    "dqn_loss": dqn_loss,
}


def launch_counts() -> dict:
    with _count_lock:
        return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    with _count_lock:
        for fn in KERNELS.values():
            fn.launches = 0
