"""RLlib's device programs: hand-written CUDA kernels (csrc/rllib_kernels.cu,
built on first CUDA use) each beside its plain PyTorch version.

  K11 sample_actions  ray_tpu/rllib/policy.py :49-57 with env_runner.py :51:
                      the runner's whole step in one launch: the trunk and
                      the logits of the observation, the key split, the
                      categorical draw by Gumbel-max on threefry2x32 bits
                      (prng.py is its plain version's arithmetic) and
                      log_softmax at the drawn action; returns the next key,
                      so the key chain stays on the device
  K12 pg_loss         policy.py :71-88 (pg_update) and :105-127
                      (ppo_update): the loss head past the trunk and its
                      gradient with respect to the logits and the value
  K13 dqn_update      policy.py :150-185: the whole DQN update in one
                      launch: three trunks, the double-DQN TD head and Huber
                      loss, the backward through the online trunk and the
                      Adam step of every parameter

K12 writes the loss and its gradient in one launch: ``PGLoss`` is an
autograd Function whose backward scales that saved gradient by the incoming
cotangent of the total loss; PG's and PPO's trunk and Adam stay torch ops
(policy.py).

The plain versions spell out the reference's steps and the gradients of
its ``jax.value_and_grad``: jax.nn.log_softmax as x - max - log(sum exp(x -
max)), the sum in action order; jnp.minimum, jnp.clip and optax.huber_loss
with lax.min / lax.max's balanced gradient (half to each side at a tie:
every PPO row whose ratio lies inside the clip range on the first epoch,
the clip ends, |td| = 1); every division of a tensor a true division of two
tensors (``tensor / python_scalar`` multiplies by the reciprocal on CUDA).
K11's plain version is the trunk as torch ops and ``draw_plain``; K13's is
the update as torch ops under autograd with ``DQNLoss`` and AdamW.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises — there is no fallback from one to the
other. Each wrapper counts the calls that launched its kernel in
``launches`` (under a lock: env runners sample from threads of one
process). On the card the kernels sum in another order than cuBLAS and
torch.sum, so they agree with their plain versions within the tolerances
below (K11's keys bit for bit, its actions outside RL_TIE_GAP), and two
launches give the same bits.
"""

from __future__ import annotations

import contextlib
import ctypes
import threading
import weakref
from pathlib import Path

import numpy as np
import torch

from ray_tpu_torch.rllib import prng
from ray_tpu_torch.util import cuda_build
from ray_tpu_torch.util.device import current_stream, device_of

_SRC = Path(__file__).resolve().parent / "csrc" / "rllib_kernels.cu"
#: --fmad=false: each step rounds as its plain version's torch op (K11's
#: draw bit for bit, Adam's moments as AdamW.update rounds them)
NVCC_FLAGS = cuda_build.BASE_FLAGS + ("--fmad=false",)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


class _DqnArgs(ctypes.Structure):
    """K13's argument block: csrc/rllib_kernels.cu's DqnArgs, field for field."""
    _fields_ = [("p", _P * 8), ("mu", _P * 8), ("nu", _P * 8), ("tgt", _P * 6),
                ("batch", _P), ("stats", _P),
                ("B", _I), ("O", _I), ("H", _I), ("A", _I), ("R", _I)] + [
                (name, _F) for name in ("gamma", "b1", "b2", "omb1", "omb2", "eps", "bc1",
                                        "bc2", "wd", "nlr")]


_SIGNATURES = {
    "rl_policy_sample": ([_P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _P], _I),
    "rl_pg_loss": ([_P] * 9 + [_I, _I, _I, _F, _F, _P], _I),
    "rl_dqn_update": ([ctypes.POINTER(_DqnArgs), _P], _I),
    "rl_stream_sync": ([_P], _I),
    "rl_device_pointer": ([_P, ctypes.POINTER(_P)], _I),
    "rl_error_string": ([_I], ctypes.c_char_p),
}

LIBRARY = cuda_build.CudaLibrary("rllib", _SRC, NVCC_FLAGS, _SIGNATURES)

MAX_ACTIONS = 64
#: K11 on the card: one thread a hidden unit, and the observation's width
MAX_HIDDEN = 256
MAX_OBS = 64
#: K11: observations of at most this many floats ride in the kernel's
#: arguments; wider ones are staged in pinned memory the card reads
ARG_OBS = 256
#: K13: one block's shared memory on sm_90 (csrc kMaxSmem)
DQN_MAX_SMEM = 232_448
_LOSS_THREADS = 1024
#: a draw may differ from JAX's only where the top-2 gap of logits + Gumbel
#: noise is below this (logf on the card, XLA's log, and the logits' last
#: bits differ by an ulp); as MOE_TIE_GAP for the expert layer's routing
RL_TIE_GAP = 1e-5
#: K11 against its plain version on the card: K11 sums each product over
#: its inner index in order where cuBLAS sums in its own order, so the
#: logits differ by a few ulps of the sum of |h2 * wp| (up to ~1e-6 at
#: logits of a few units; the same sums in both orders on the CPU differ
#: by 9.5e-7), and log_softmax at the draw carries that into logp through
#: both x - max and log(sum); the draws agree outside RL_TIE_GAP
RL_LOGP_TOL = 4e-6
#: K13 against its plain version on the card. The stats within 1e-5
#: relative (RL_CARD_TOL: sums in another order). The params and moments:
#: the trunks' products summed in another order move the gradient g by
#: ulps, which Adam's moments carry at their own scale (mu, nu within
#: "moments_rel" of their largest entry); at Adam's first step u = g / |g|,
#: so an entry whose |g| lies within that noise of 0 flips its step's sign,
#: 2 lr: in each tensor, every entry within 2 lr times the updates taken of
#: its plain value ("params_lr_units", the outer bound: it catches a NaN or
#: a wild entry), and at least "params_share" of its entries, all but one
#: where that allows none, within "params_abs" (as MOE_GRAD_GOLDEN_TOL's
#: "98 % within"). The value head, whose gradient is 0, bit-equal.
DQN_UPDATE_TOL = {"moments_rel": 1e-4, "params_lr_units": 2.0, "params_abs": 1e-6,
                  "params_share": 0.98}
#: PPO's clip range (policy.py :100 ppo_update's default)
PPO_CLIP = 0.2
_PG, _PPO = 0, 1
#: the policy's tensors K11 reads, and every parameter K13 updates, in the
#: reference's params-dict order
POLICY_NAMES = ("w1", "b1", "w2", "b2", "wp", "bp")
PARAM_NAMES = POLICY_NAMES + ("wv", "bv")
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


def _on(dev: torch.device):
    """`dev` as the current device for a launch (a no-op when it is)."""
    if torch.cuda.current_device() == dev.index:
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


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


def _device_pointer(lib, host: torch.Tensor) -> int:
    """The card's address of a pinned host tensor."""
    out = _P()
    _check(lib, lib.rl_device_pointer(host.data_ptr(), ctypes.byref(out)), "device pointer")
    return out.value


# ------------------------------------------------------------------ K11


def _policy_shapes(what: str, net):
    """(O, H, A) of the policy's tensors; raises on a wrong shape or type."""
    w = [getattr(net, n) for n in POLICY_NAMES]
    if w[0].dim() != 2:
        raise ValueError(f"{what}: w1 {tuple(w[0].shape)} ([O, H] needed)")
    O, H = w[0].shape
    A = w[4].shape[-1] if w[4].dim() == 2 else 0
    want = ((O, H), (H,), (H, H), (H,), (H, A), (A,))
    for name, t, shape in zip(POLICY_NAMES, w, want):
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"{what}: {name} {tuple(t.shape)} {t.dtype} (float32 {shape} "
                             "needed)")
    if not 0 < A <= MAX_ACTIONS:
        raise ValueError(f"{what}: {A} actions (0 < A <= {MAX_ACTIONS} needed)")
    return O, H, A


def policy_sample_limits(O: int, H: int, A: int) -> None:
    """Raise unless K11 on the card takes a policy of these widths."""
    if not (0 < O <= MAX_OBS and 0 < H <= MAX_HIDDEN and 0 < A <= MAX_ACTIONS):
        raise ValueError(f"sample_actions on the card: obs {O}, hidden {H}, actions {A} "
                         f"(at most {MAX_OBS}, {MAX_HIDDEN}, {MAX_ACTIONS})")


def draw_plain(logits: torch.Tensor, key: torch.Tensor):
    """The draw of K11's plain version: key, sub = split(key); actions =
    categorical(sub, logits); logp = log_softmax(logits)[actions]. Returns
    (actions int32 [B], logp float32 [B], the next key)."""
    next_key, bits = prng.split_and_bits(key, logits.shape)
    actions = prng.categorical_of_bits(bits.to(logits.device), logits)
    shifted, _, s, _ = log_softmax_plain(logits)
    at = shifted.gather(1, actions.long()[:, None])[:, 0]
    return actions, at - torch.log(s), next_key.to(logits.device)


@torch.no_grad()
def sample_actions_plain(net, obs, key: torch.Tensor):
    """Plain version of K11: the logits trunk(obs) @ wp + bp as torch ops
    on the policy's device, then draw_plain."""
    x = torch.as_tensor(obs, dtype=torch.float32).to(net.w1.device)
    return draw_plain((net.trunk(x) @ net.wp + net.bp).contiguous(), key)


class SampleBuffers:
    """K11's buffers for one caller on one card (each env runner owns its
    own): pinned host actions and logp that the kernel writes, readable
    after the wrapper's one synchronisation; two device keys the chain
    alternates between; a pinned staging buffer for observations wider than
    the kernel's arguments; and the policy it last checked, so that a
    runner's steps skip the checks while its tensors stay where they are. A
    call's actions and logp are views into these buffers, overwritten by the
    next call."""

    def __init__(self, dev, rows: int):
        lib = LIBRARY.load()
        self.dev, self.rows = torch.device(dev), int(rows)
        self.actions = torch.empty(self.rows, dtype=torch.int32, pin_memory=True)
        self.logp = torch.empty(self.rows, dtype=torch.float32, pin_memory=True)
        self._out = (_device_pointer(lib, self.actions), _device_pointer(lib, self.logp))
        self.keys = torch.empty(2, 2, dtype=torch.int64, device=self.dev)
        self._stage = None
        self._policy = (None, None, None)  # (pointers, their C array, (O, H, A))

    def checked(self, tensors):
        """(the C array of the policy's pointers, (O, H, A)) if these are
        the tensors last checked in, else None."""
        ptrs, array, widths = self._policy
        if ptrs is None or ptrs != tuple(t.data_ptr() for t in tensors):
            return None
        return array, widths

    def check_in(self, tensors, widths):
        ptrs = tuple(t.data_ptr() for t in tensors)
        self._policy = (ptrs, (_P * 6)(*ptrs), widths)
        return self._policy[1]

    def next_key(self, key: torch.Tensor) -> torch.Tensor:
        return self.keys[1] if key.data_ptr() == self.keys[0].data_ptr() else self.keys[0]

    def stage(self, obs: np.ndarray) -> int:
        """obs copied into pinned memory; its address on the card."""
        n = obs.size
        if self._stage is None or self._stage[0].numel() < n:
            host = torch.empty(n, dtype=torch.float32, pin_memory=True)
            self._stage = (host, _device_pointer(LIBRARY.load(), host))
        self._stage[0].numpy()[:n] = obs.reshape(-1)
        return self._stage[1]


def sample_actions(net, obs, key: torch.Tensor, buffers: SampleBuffers = None,
                   sync: bool = True):
    """K11. net: the policy (w1 [O, H], b1, w2 [H, H], b2, wp [H, A], bp
    float32), obs [B, O] (numpy or a tensor), key int64 [2] (a JAX
    threefry key's two uint32 words) -> (actions int32 [B], logp float32
    [B], next key int64 [2]), drawn as the reference's runner draws one
    step: key, sub = jax.random.split(key); sample_actions(params, obs,
    sub). On the card one launch and one synchronisation: actions and logp
    come back in pinned host memory (`buffers`', or fresh ones), the key on
    the card. sync False leaves the synchronisation to the caller (timing
    by CUDA events): the outputs are not readable before it."""
    if key.shape != (2,) or key.dtype != torch.int64 or not key.is_contiguous():
        raise ValueError(f"sample_actions: key {tuple(key.shape)} {key.dtype} (contiguous "
                         "int64 [2] needed)")
    tensors = [getattr(net, n) for n in POLICY_NAMES]
    checked = None if buffers is None else buffers.checked(tensors)
    if checked is None:
        O, H, A = _policy_shapes("sample_actions", net)
        dev = device_of(net.w1, key)
    else:
        O, H, A = checked[1]
        dev = buffers.dev
        if key.device != dev:
            raise ValueError(f"sample_actions: key on {key.device}, the policy on {dev}")
    shape = np.shape(obs)
    if len(shape) != 2 or shape[1] != O or shape[0] == 0:
        raise ValueError(f"sample_actions: obs {tuple(shape)} ([B, {O}] needed)")
    if dev.type == "cpu":
        return sample_actions_plain(net, obs, key)
    if checked is None:
        if device_of(*tensors) != dev:
            raise ValueError("sample_actions: the policy and the key on different devices")
        _contiguous("sample_actions", *tensors)
        policy_sample_limits(O, H, A)
    obs = np.ascontiguousarray(obs.numpy() if torch.is_tensor(obs) else obs, np.float32)
    B = shape[0]
    if buffers is None:
        buffers = SampleBuffers(dev, B)
    elif buffers.dev != dev or buffers.rows < B:
        raise ValueError(f"sample_actions: buffers for {buffers.rows} rows on {buffers.dev}, "
                         f"{B} rows on {dev} given")
    params = buffers.check_in(tensors, (O, H, A)) if checked is None else checked[0]
    lib = LIBRARY.load()
    if B * O <= ARG_OBS:
        obs_ptr, obs_staged = obs.ctypes.data, 0
    else:
        obs_ptr, obs_staged = buffers.stage(obs), 1
    key_out = buffers.next_key(key)
    with _on(dev):
        stream = current_stream(dev)
        rc = lib.rl_policy_sample(params, obs_ptr, obs_staged, key.data_ptr(),
                                  buffers._out[0], buffers._out[1], key_out.data_ptr(), B, O,
                                  H, A, stream)
        _check(lib, rc, "sample_actions")
        _count(sample_actions)
        if sync:
            _check(lib, lib.rl_stream_sync(stream), "sample_actions")
    if B == buffers.rows:
        return buffers.actions, buffers.logp, key_out
    return buffers.actions[:B], buffers.logp[:B], key_out


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
    """The TD head of K13's plain version: (losses [3] = loss, mean |td|,
    mean q; dq [B, A])."""
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


class DQNLoss(torch.autograd.Function):
    """losses [3] of dqn_loss_plain; the backward gives q its dq scaled by
    the loss's cotangent (qn_online and qn_target carry no gradient)."""

    @staticmethod
    def forward(ctx, q, qn_online, qn_target, actions, rewards, dones, gamma):
        losses, dq = dqn_loss_plain(q.detach(), qn_online, qn_target, actions, rewards,
                                    dones, gamma)
        ctx.save_for_backward(dq)
        return losses

    @staticmethod
    def backward(ctx, g):
        (dq,) = ctx.saved_tensors
        return dq * g[0], None, None, None, None, None, None


#: K13's batch: the keys, their dtypes and widths (O for an observation)
DQN_BATCH = (("obs", np.float32, True), ("next_obs", np.float32, True),
             ("rewards", np.float32, False), ("dones", np.float32, False),
             ("actions", np.int32, False))


def _dqn_batch(batch, B: int, O: int):
    """The batch's arrays as numpy, each checked against [B] or [B, O]."""
    out = {}
    for name, dtype, wide in DQN_BATCH:
        v = batch[name]
        v = v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)
        want = (B, O) if wide else (B,)
        if v.shape != want:
            raise ValueError(f"dqn_update: {name} {v.shape} ({want} needed)")
        out[name] = np.ascontiguousarray(v, dtype)
    return out


def dqn_smem_bytes(R: int, O: int, H: int, A: int) -> int:
    """K13's shared memory at R rows a tile (csrc dqn_smem_floats): both
    networks (w2's rows padded to H + 1), the online network's gradient,
    the tile's obs and next_obs, h1 and h2 (padded), three [R, A] Q blocks
    and the block's reduction buffer."""
    net = O * H + H + H * (H + 1) + H + H * A + A
    grad = O * H + H + H * H + H + H * A + A
    return 4 * (2 * net + grad + 2 * R * O + 2 * R * (H + 1) + 3 * R * A + _LOSS_THREADS)


def dqn_tile_rows(B: int, O: int, H: int, A: int) -> int:
    """The rows of a batch of B that K13 holds in shared memory at once: all
    of them where they fit, else as many as fit (the update then passes
    the batch in tiles). Raises where not one row fits beside the two
    networks and the gradient, or past MAX_ACTIONS actions."""
    fixed = dqn_smem_bytes(0, O, H, A)
    rows = (DQN_MAX_SMEM - fixed) // (dqn_smem_bytes(1, O, H, A) - fixed)
    if not 0 < A <= MAX_ACTIONS or rows < 1:
        raise ValueError(
            f"dqn_update on the card: obs {O}, hidden {H}, actions {A}: the two networks "
            f"and the gradient with one row need {dqn_smem_bytes(1, O, H, A)} bytes of one "
            f"block's shared memory (at most {DQN_MAX_SMEM}: hidden up to 135 at obs 4 "
            f"and 2 actions), and at most {MAX_ACTIONS} actions")
    return min(B, rows)


def zero_missing_grads(net) -> None:
    for p in net.parameters():  # a head the loss does not read (DQN's
        if p.grad is None:      # value head): a zero gradient, as jax.grad's
            p.grad = torch.zeros_like(p)


def dqn_update_plain(net, target_net, opt_state, optimizer, batch, gamma: float):
    """Plain version of K13: the online and target trunks as torch ops, the
    TD head DQNLoss, autograd's backward, then optimizer.update (AdamW).
    net, target_net: the online and target policies (PARAM_NAMES);
    opt_state: their AdamWState, updated in place with net. Returns the
    stats [3] (loss, mean |td|, mean q) on the policy's device."""
    dev = net.w1.device

    def tensor(name, dtype=torch.float32):
        return torch.as_tensor(batch[name]).to(device=dev, dtype=dtype).contiguous()

    for p in net.parameters():
        p.grad = None
    obs, next_obs = tensor("obs"), tensor("next_obs")
    actions = tensor("actions", torch.int32)
    rewards, dones = tensor("rewards"), tensor("dones")
    with torch.no_grad():
        qn_online = (net.trunk(next_obs) @ net.wp + net.bp).contiguous()
        qn_target = (target_net.trunk(next_obs) @ target_net.wp + target_net.bp).contiguous()
    with torch.enable_grad():
        q = net.trunk(obs) @ net.wp + net.bp
        losses = DQNLoss.apply(q, qn_online, qn_target, actions, rewards, dones, gamma)
        losses[0].backward()
    zero_missing_grads(net)
    optimizer.update(net, opt_state)
    return losses.detach()


class DqnStaging:
    """K13's buffers for one learner on one card: one pinned host buffer
    the batch is packed into (obs, next_obs, rewards, dones, actions) and
    its device copy, so a batch crosses in one copy; pinned stats the
    kernel writes; the argument block, rebuilt when a tensor moves."""

    def __init__(self, dev, B: int, O: int):
        lib = LIBRARY.load()
        n = 2 * B * O + 3 * B
        self.dev, self.B, self.O = torch.device(dev), B, O
        self.host = torch.empty(n, dtype=torch.float32, pin_memory=True)
        self.device = torch.empty(n, dtype=torch.float32, device=self.dev)
        self.stats = torch.empty(3, dtype=torch.float32, pin_memory=True)
        self._stats_ptr = _device_pointer(lib, self.stats)
        self._args = (None, None)

    def pack(self, arrays) -> None:
        h = self.host.numpy()
        at = 0
        for name, _, _ in DQN_BATCH:
            v = arrays[name].reshape(-1)
            h[at:at + v.size] = v.view(np.float32)
            at += v.size
        self.device.copy_(self.host, non_blocking=True)

    def args(self, tensors) -> _DqnArgs:
        ptrs = tuple(t.data_ptr() for t in tensors)
        if self._args[0] != ptrs:
            a = _DqnArgs()
            a.p[:], a.mu[:], a.nu[:], a.tgt[:] = ptrs[:8], ptrs[8:16], ptrs[16:24], ptrs[24:]
            a.batch, a.stats = self.device.data_ptr(), self._stats_ptr
            self._args = (ptrs, a)
        return self._args[1]


_STAGING = weakref.WeakKeyDictionary()


def dqn_update(net, target_net, opt_state, optimizer, batch, gamma: float = 0.99,
               sync: bool = True):
    """K13. One DQN update of dqn_update_plain's arguments in one launch on
    the card: params and moments in place, opt_state.count advanced, the
    batch (obs [B, O], next_obs [B, O], rewards, dones [B] float32, actions
    [B] int32; numpy or tensors) staged by one pinned copy, one
    synchronisation for the stats. Returns the stats [3] (loss, mean |td|,
    mean q), on the CPU from the card. sync False leaves the
    synchronisation to the caller (timing by CUDA events) and returns the
    pinned stats the kernel writes, not readable before it."""
    O, H, A = _policy_shapes("dqn_update", net)
    B = len(batch["obs"])
    arrays = _dqn_batch(batch, B, O)
    params = [getattr(net, n) for n in PARAM_NAMES]
    if tuple(params[6].shape) != (H, 1) or tuple(params[7].shape) != (1,):
        raise ValueError("dqn_update: the value head must be wv [H, 1], bv [1]")
    target = [getattr(target_net, n) for n in POLICY_NAMES]
    for t, p in zip(target, params):
        if t.shape != p.shape or t.dtype != p.dtype:
            raise ValueError("dqn_update: the target network's shapes differ from the "
                             "online network's")
    moments = [opt_state.mu[n] for n in PARAM_NAMES] + [opt_state.nu[n] for n in PARAM_NAMES]
    dev = device_of(*params, *target, *moments)
    if dev.type == "cpu":
        return dqn_update_plain(net, target_net, opt_state, optimizer, arrays, gamma)
    R = dqn_tile_rows(B, O, H, A)
    tensors = params + moments + target
    _contiguous("dqn_update", *tensors)
    staging = _STAGING.get(net)
    if staging is None or (staging.dev, staging.B, staging.O) != (dev, B, O):
        staging = _STAGING[net] = DqnStaging(dev, B, O)
    lib = LIBRARY.load()
    opt_state.count += 1
    a = staging.args(tensors)
    a.B, a.O, a.H, a.A, a.R = B, O, H, A, R
    a.gamma = gamma
    a.b1, a.b2 = optimizer.b1, optimizer.b2
    a.omb1, a.omb2 = 1 - optimizer.b1, 1 - optimizer.b2
    a.eps, a.wd, a.nlr = optimizer.eps, optimizer.weight_decay, -optimizer.lr
    a.bc1 = optimizer.bias_correction(optimizer.b1, opt_state.count)
    a.bc2 = optimizer.bias_correction(optimizer.b2, opt_state.count)
    with _on(dev), torch.no_grad():
        stream = current_stream(dev)
        staging.pack(arrays)
        rc = lib.rl_dqn_update(ctypes.byref(a), stream)
        _check(lib, rc, "dqn_update")
        _count(dqn_update)
        if not sync:
            return staging.stats
        _check(lib, lib.rl_stream_sync(stream), "dqn_update")
    return staging.stats.clone()


dqn_update.launches = 0


def dqn_update_mismatch(net, opt_state, ref_net, ref_state, updates: int, lr: float):
    """How far K13's state (net, opt_state) lies from its plain version's
    (ref_net, ref_state) after `updates` updates at learning rate `lr`,
    held to DQN_UPDATE_TOL tensor by tensor: (a description of the first
    bound broken, or None; the measured numbers). The value head wv, bv
    and its moments must be bit-equal: its gradient is exactly 0."""
    tol = DQN_UPDATE_TOL
    got = {"params_max": 0.0, "params_share": 1.0, "moments_rel": 0.0}
    bad = None
    if opt_state.count != ref_state.count:
        bad = f"Adam's count {opt_state.count} against {ref_state.count}"
    for n in PARAM_NAMES:
        mine = (getattr(net, n), opt_state.mu[n], opt_state.nu[n])
        ref = (getattr(ref_net, n), ref_state.mu[n], ref_state.nu[n])
        if n in ("wv", "bv"):
            if bad is None and not all(torch.equal(m, r.to(m.device)) for m, r in zip(mine, ref)):
                bad = f"{n} or its moments not bit-equal to plain (its gradient is 0)"
            continue
        diff = (mine[0] - ref[0].to(mine[0].device)).detach().abs().flatten().cpu()
        share = float((diff <= tol["params_abs"]).double().mean())
        moments = max(float((m - r.to(m.device)).abs().max()
                            / r.abs().max().clamp_min(1e-30))
                      for m, r in zip(mine[1:], ref[1:]))
        got["params_max"] = max(got["params_max"], float(diff.max()))
        got["params_share"] = min(got["params_share"], share)
        got["moments_rel"] = max(got["moments_rel"], moments)
        outside = int((~(diff <= tol["params_abs"])).sum())
        if bad is not None:
            continue
        if not float(diff.max()) <= tol["params_lr_units"] * lr * updates:
            bad = f"{n}: an entry {float(diff.max()):.3e} from its plain value"
        elif outside > max(1, int((1 - tol["params_share"]) * diff.numel())):
            bad = (f"{n}: {outside} of {diff.numel()} entries beyond {tol['params_abs']} "
                   f"(at most {1 - tol['params_share']:.0%}, or one)")
        elif not moments <= tol["moments_rel"]:
            bad = f"{n}: a moment {moments:.3e} of its largest from its plain value"
    return bad, got


#: the kernels of this module by name, each with its `launches` counter
KERNELS = {
    "sample_actions": sample_actions,
    "pg_loss": pg_loss,
    "dqn_update": dqn_update,
}


def launch_counts() -> dict:
    with _count_lock:
        return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    with _count_lock:
        for fn in KERNELS.values():
            fn.launches = 0
