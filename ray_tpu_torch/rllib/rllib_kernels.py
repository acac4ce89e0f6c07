"""RLlib's device programs: hand-written CUDA kernels (csrc/rllib_kernels.cu,
built on first CUDA use) each beside its plain PyTorch version.

  K11 sample_actions  ray_tpu/rllib/policy.py :49-57 with env_runner.py :51:
                      the runner's whole step in one launch: the trunk and
                      the logits of the observation, the key split, the
                      categorical draw by Gumbel-max on threefry2x32 bits
                      (prng.py is its plain version's arithmetic) and
                      log_softmax at the drawn action; returns the next key,
                      so the key chain stays on the device
  K12 pg_update       policy.py :64-97 (pg_update) and :100-136
                      (ppo_update): the whole PG/PPO update in one cluster
                      launch: the trunk and both heads, the masked advantage
                      normalisation, the loss head, the backward through
                      both heads and the trunk and the Adam step of every
                      parameter, the batch's rows spread over the cluster's
                      blocks
  K13 dqn_update      policy.py :150-185: the whole DQN update in one
                      launch: three trunks, the double-DQN TD head and Huber
                      loss, the backward through the online trunk and the
                      Adam step of every parameter

K12 and K13 each take one pinned copy of the batch in (PgStaging,
DqnStaging) and write their stats into pinned host memory, read after one
synchronisation; params and moments are updated in place on the card.

The plain versions spell out the reference's steps and the gradients of
its ``jax.value_and_grad``: jax.nn.log_softmax as x - max - log(sum exp(x -
max)), the sum in action order; jnp.minimum, jnp.clip and optax.huber_loss
with lax.min / lax.max's balanced gradient (half to each side at a tie:
every PPO row whose ratio lies inside the clip range on the first epoch,
the clip ends, |td| = 1); every division of a tensor a true division of two
tensors (``tensor / python_scalar`` multiplies by the reciprocal on CUDA).
K11's plain version is the trunk as torch ops and ``draw_plain``; K12's and
K13's are the update as torch ops under autograd (``PGLoss``, ``DQNLoss``:
autograd Functions whose backward scales the head's gradient by the total
loss's cotangent) with AdamW.

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


class _PgArgs(ctypes.Structure):
    """K12's argument block: csrc/rllib_kernels.cu's PgArgs, field for field."""
    _fields_ = [("p", _P * 8), ("mu", _P * 8), ("nu", _P * 8), ("batch", _P), ("stats", _P),
                ("B", _I), ("O", _I), ("H", _I), ("A", _I), ("P", _I), ("R", _I),
                ("mode", _I)] + [
                (name, _F) for name in ("lo", "hi", "b1", "b2", "omb1", "omb2", "eps", "bc1",
                                        "bc2", "wd", "nlr")]


class _DqnArgs(ctypes.Structure):
    """K13's argument block: csrc/rllib_kernels.cu's DqnArgs, field for field."""
    _fields_ = [("p", _P * 8), ("mu", _P * 8), ("nu", _P * 8), ("tgt", _P * 6),
                ("batch", _P), ("stats", _P),
                ("B", _I), ("O", _I), ("H", _I), ("A", _I), ("R", _I)] + [
                (name, _F) for name in ("gamma", "b1", "b2", "omb1", "omb2", "eps", "bc1",
                                        "bc2", "wd", "nlr")]


_SIGNATURES = {
    "rl_policy_sample": ([_P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _P], _I),
    "rl_pg_update": ([ctypes.POINTER(_PgArgs), _P], _I),
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
#: K12, K13: one block's shared memory on sm_90 (csrc kMaxSmem)
MAX_SMEM = 232_448
_LOSS_THREADS = 1024
#: K12: at most 16 blocks a cluster (a non-portable size sm_90 allows: csrc
#: kMaxCluster), and about this many rows a block below that
PG_MAX_CLUSTER = 16
PG_ROWS_A_BLOCK = 64
#: K12's reduction scratch (csrc kPgRed)
_PG_RED = 32 * 4 + 16
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
#: K12 and K13 against their plain versions on the card. The stats within
#: 1e-5 relative (RL_CARD_TOL: sums in another order; K12's policy loss, a
#: mean of terms of both signs, of pg_term_scale). The params and moments:
#: the trunks' products summed in another order move the gradient g by
#: ulps, which Adam's moments carry at their own scale (mu, nu within
#: "moments_rel" of their largest entry); at Adam's first step u = g / |g|,
#: so an entry whose |g| lies within that noise of 0 flips its step's sign,
#: 2 lr: in each tensor, every entry within 2 lr times the updates taken of
#: its plain value ("params_lr_units", the outer bound: it catches a NaN or
#: a wild entry), and at least "params_share" of its entries, all but one
#: where that allows none, within "params_abs" (as MOE_GRAD_GOLDEN_TOL's
#: "98 % within"). DQN's value head, whose gradient is 0, bit-equal.
UPDATE_TOL = {"moments_rel": 1e-4, "params_lr_units": 2.0, "params_abs": 1e-6,
                  "params_share": 0.98}
#: PPO's clip range (policy.py :100 ppo_update's default)
PPO_CLIP = 0.2
_PG, _PPO = 0, 1
#: the parameters DQN's loss does not read: their gradient is exactly 0
DQN_ZERO_GRAD = ("wv", "bv")
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


class PGLoss(torch.autograd.Function):
    """losses [3] = total, pg, vf of pg_loss_plain; the backward gives
    logits and v its gradient of total scaled by total's cotangent."""

    @staticmethod
    def forward(ctx, logits, v, actions, returns, mask, logp_old, clip):
        losses, dlogits, dv = pg_loss_plain(logits.detach(), v.detach(), actions, returns, mask,
                                            logp_old, clip)
        ctx.save_for_backward(dlogits, dv)
        return losses

    @staticmethod
    def backward(ctx, g):
        dlogits, dv = ctx.saved_tensors
        return dlogits * g[0], dv * g[0], None, None, None, None, None


def zero_missing_grads(net) -> None:
    for p in net.parameters():  # a head the loss does not read (DQN's
        if p.grad is None:      # value head): a zero gradient, as jax.grad's
            p.grad = torch.zeros_like(p)


def pg_update_plain(net, opt_state, optimizer, batch, clip=None):
    """Plain version of K12: the trunk and both heads as torch ops, the
    loss head PGLoss, autograd's backward, then optimizer.update (AdamW).
    batch: a padded batch (obs [B, O], actions, returns, mask [B], and
    logp_old [B] for PPO; numpy or tensors); opt_state is updated in place
    with net. Returns the stats [3] (total, pg, vf) on the policy's
    device."""
    dev = net.w1.device

    def tensor(name, dtype=torch.float32):
        return torch.as_tensor(batch[name]).to(device=dev, dtype=dtype).contiguous()

    for p in net.parameters():
        p.grad = None
    obs = tensor("obs")
    actions = tensor("actions", torch.int32)
    returns, mask = tensor("returns"), tensor("mask")
    logp_old = None if clip is None else tensor("logp_old")
    with torch.enable_grad():
        h = net.trunk(obs)
        logits = h @ net.wp + net.bp
        v = (h @ net.wv + net.bv).squeeze(-1)
        losses = PGLoss.apply(logits, v, actions, returns, mask, logp_old, clip)
        losses[0].backward()
    zero_missing_grads(net)
    optimizer.update(net, opt_state)
    return losses.detach()


#: K12's batch: the keys, their kinds and whether a row is an observation,
#: in the order PgStaging packs them
PG_BATCH = (("obs", "f", True), ("actions", "i", False), ("returns", "f", False),
            ("logp_old", "f", False), ("mask", "f", False))


def _pg_batch(batch, O: int, A: int, clip, rows):
    """The batch's arrays as numpy, each checked (shape, kind, actions in
    range), and (B, n): the rows of the update and the batch's own rows
    that go into it. A batch with a mask is padded already (B = n = its
    rows); one without is a sampled batch, padded (or cut) to `rows` rows
    (its own by default) with the mask 1 on its real ones."""
    if "obs" not in batch or "actions" not in batch or "returns" not in batch:
        raise ValueError("pg_update: the batch needs obs, actions and returns")
    if clip is not None and "logp_old" not in batch:
        raise ValueError("pg_update: PPO (clip given) needs logp_old")
    if "mask" in batch and rows is not None:
        raise ValueError("pg_update: rows pads a sampled batch; this one has a mask")
    out = {}
    n = None
    for name, kind, wide in PG_BATCH:
        if name not in batch:
            continue
        v = batch[name]
        v = v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)
        n = len(v) if n is None else n
        want = (n, O) if wide else (n,)
        if v.shape != want or not np.issubdtype(v.dtype, np.integer if kind == "i"
                                                else np.floating):
            raise ValueError(f"pg_update: {name} {v.shape} {v.dtype} ({want} "
                             f"{'integer' if kind == 'i' else 'float'} needed)")
        out[name] = np.ascontiguousarray(v, np.int32 if kind == "i" else np.float32)
    acts = out["actions"]
    if n == 0 or acts.min() < 0 or acts.max() >= A:
        raise ValueError(f"pg_update: {n} rows, actions outside [0, {A})")
    B = n if rows is None else int(rows)
    return out, B, min(n, B)


def pad_batch(arrays, B: int, n: int):
    """A sampled batch's first n rows padded with zeros to B rows, and its
    mask (1 on those rows): the plain version's input, as the learner
    padded it before K12 took the whole update. A batch with a mask is
    returned as it is."""
    if "mask" in arrays:
        return arrays
    out = {k: np.concatenate([v[:n], np.zeros((B - n,) + v.shape[1:], v.dtype)])
           for k, v in arrays.items()}
    out["mask"] = (np.arange(B) < n).astype(np.float32)
    return out


def pg_cluster_blocks(B: int) -> int:
    """K12's cluster size for a batch of B rows: the least power of two
    that gives a block at most PG_ROWS_A_BLOCK rows, at most
    PG_MAX_CLUSTER."""
    P = 1
    while P < PG_MAX_CLUSTER and P * PG_ROWS_A_BLOCK < B:
        P *= 2
    return P


def pg_smem_bytes(Q: int, R: int, O: int, H: int, A: int) -> int:
    """K12's shared memory with at most Q rows a block and R a tile (csrc
    pg_smem_floats): the network (the value head as column A of the head,
    w2's rows padded to H + 1), its gradient, the block's rows' logits and
    v, the tile's obs, h1 and h2 (padded), and the reductions' scratch."""
    W = A + 1
    net = O * H + H + H * (H + 1) + H + (H + 1) * W
    grad = O * H + H + H * H + H + (H + 1) * W
    return 4 * (net + grad + Q * W + R * (O + 2 * (H + 1)) + _PG_RED)


def pg_plan(B: int, O: int, H: int, A: int):
    """(P, R): K12's cluster of P blocks for a batch of B rows, each block
    passing its rows through shared memory R at a time (all of them where
    they fit). Raises where not one row fits beside the network, its
    gradient and the block's rows' logits, or past MAX_ACTIONS actions."""
    P = pg_cluster_blocks(B)
    Q = -(-B // P)
    fixed = pg_smem_bytes(Q, 0, O, H, A)
    rows = (MAX_SMEM - fixed) // (pg_smem_bytes(Q, 1, O, H, A) - fixed)
    if not 0 < A <= MAX_ACTIONS or B < 1 or rows < 1:
        raise ValueError(
            f"pg_update on the card: batch {B}, obs {O}, hidden {H}, actions {A}: the "
            f"network, its gradient and a block's {Q} rows' logits with one row need "
            f"{pg_smem_bytes(Q, 1, O, H, A)} bytes of one block's shared memory (at most "
            f"{MAX_SMEM}: hidden up to 164 at obs 4, 2 actions and batch 2 048), "
            f"and at most {MAX_ACTIONS} actions")
    return P, min(Q, rows)


def pack_pg_batch(h: np.ndarray, arrays, B: int, O: int, n: int) -> None:
    """K12's staged batch written into h (float32, B * O + 4 * B): obs [B,
    O], actions [B] (int32 bits), returns, logp_old, mask [B]; each the
    first n rows of its array and zeros after them (pad_batch's padding);
    without a mask the mask is 1 on those rows; without logp_old (PG) its
    room is left as it is."""
    obs = h[:B * O].reshape(B, O)
    obs[:n] = arrays["obs"][:n]
    obs[n:] = 0.0
    at = B * O
    for name, kind, _ in PG_BATCH[1:]:
        seg = h[at:at + B].view(np.int32) if kind == "i" else h[at:at + B]
        at += B
        if name in arrays:
            seg[:n] = arrays[name][:n]
        elif name == "mask":
            seg[:n] = 1.0
        else:
            continue
        seg[n:] = 0


class _Staging:
    """A learner's buffers on one card: one pinned host buffer of n floats
    the batch is packed into and its device copy, so a batch crosses in one
    copy; pinned stats [3] the kernel writes; the argument block, rebuilt
    when a tensor moves."""

    def __init__(self, dev, n: int):
        lib = LIBRARY.load()
        self.dev = torch.device(dev)
        self.host = torch.empty(n, dtype=torch.float32, pin_memory=True)
        self.device = torch.empty(n, dtype=torch.float32, device=self.dev)
        self.stats = torch.empty(3, dtype=torch.float32, pin_memory=True)
        self._stats_ptr = _device_pointer(lib, self.stats)
        self._args = (None, None)

    def args(self, tensors):
        """The argument block for params, moments (and K13's target)."""
        ptrs = tuple(t.data_ptr() for t in tensors)
        if self._args[0] != ptrs:
            a = self._struct()
            a.p[:], a.mu[:], a.nu[:] = ptrs[:8], ptrs[8:16], ptrs[16:24]
            if len(ptrs) > 24:
                a.tgt[:] = ptrs[24:]
            a.batch, a.stats = self.device.data_ptr(), self._stats_ptr
            self._args = (ptrs, a)
        return self._args[1]


class PgStaging(_Staging):
    """K12's buffers: the batch's rows written straight into the pinned
    buffer, padding included (obs, actions, returns, logp_old, mask)."""

    _struct = _PgArgs

    def __init__(self, dev, B: int, O: int):
        super().__init__(dev, B * O + 4 * B)
        self.B, self.O = B, O

    def pack(self, arrays, n: int) -> None:
        pack_pg_batch(self.host.numpy(), arrays, self.B, self.O, n)
        self.device.copy_(self.host, non_blocking=True)


_PG_STAGING = weakref.WeakKeyDictionary()


def _check_value_head(what: str, params, H: int) -> None:
    if tuple(params[6].shape) != (H, 1) or tuple(params[7].shape) != (1,) or any(
            t.dtype != torch.float32 for t in params[6:]):
        raise ValueError(f"{what}: the value head must be wv [H, 1], bv [1] float32")


def pg_update(net, opt_state, optimizer, batch, clip=None, sync: bool = True, rows=None):
    """K12. One PG (clip None) or PPO (clip a float, e.g. PPO_CLIP) update
    of pg_update_plain's arguments in one launch on the card: params and
    moments in place, opt_state.count advanced, the batch staged by one
    pinned copy, one synchronisation for the stats. batch: obs [B, O],
    actions [B] int, returns [B], mask [B], and logp_old [B] for PPO (numpy
    or tensors); or a sampled batch without a mask, padded (or cut) to
    `rows` rows with the mask 1 on its real ones. Returns the stats [3]
    (total, pg, vf), on the CPU from the card. sync False leaves the
    synchronisation to the caller (timing by CUDA events) and returns the
    pinned stats the kernel writes, not readable before it."""
    O, H, A = _policy_shapes("pg_update", net)
    params = [getattr(net, n) for n in PARAM_NAMES]
    _check_value_head("pg_update", params, H)
    arrays, B, n = _pg_batch(batch, O, A, clip, rows)
    moments = [opt_state.mu[k] for k in PARAM_NAMES] + [opt_state.nu[k] for k in PARAM_NAMES]
    dev = device_of(*params, *moments)
    if dev.type == "cpu":
        return pg_update_plain(net, opt_state, optimizer, pad_batch(arrays, B, n), clip)
    P, R = pg_plan(B, O, H, A)
    tensors = params + moments
    _contiguous("pg_update", *tensors)
    staging = _PG_STAGING.get(net)
    if staging is None or (staging.dev, staging.B, staging.O) != (dev, B, O):
        staging = _PG_STAGING[net] = PgStaging(dev, B, O)
    lib = LIBRARY.load()
    opt_state.count += 1
    a = staging.args(tensors)
    a.B, a.O, a.H, a.A, a.P, a.R = B, O, H, A, P, R
    a.mode = _PG if clip is None else _PPO
    a.lo, a.hi = (0.0, 0.0) if clip is None else (1 - clip, 1 + clip)
    _adam_args(a, optimizer, opt_state.count)
    with _on(dev), torch.no_grad():
        stream = current_stream(dev)
        staging.pack(arrays, n)
        rc = lib.rl_pg_update(ctypes.byref(a), stream)
        _check(lib, rc, "pg_update")
        _count(pg_update)
        if not sync:
            return staging.stats
        _check(lib, lib.rl_stream_sync(stream), "pg_update")
    return staging.stats.clone()


pg_update.launches = 0


@torch.no_grad()
def pg_term_scale(net, batch, clip=None) -> float:
    """The mean |term| of the policy loss at net's parameters on a padded
    batch (pg_update_plain's): the scale its float32 sums round at. The
    policy loss is a mean of terms of both signs, near 0 where the
    advantages are normalised, so two computations of it are held to this
    scale and not to its own size."""
    dev = net.w1.device
    t = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
    h = net.trunk(t["obs"].float())
    logits = h @ net.wp + net.bp
    adv = t["returns"].float() - (h @ net.wv + net.bv).squeeze(-1)
    m = t["mask"].float()
    n = torch.clamp_min(m.sum(), 1.0)
    c = adv - (adv * m).sum() / n
    adv = c / (torch.sqrt((c * c * m).sum() / n) + 1e-6)
    act = log_softmax_plain(logits)[3].gather(1, t["actions"].long()[:, None])[:, 0]
    if clip is None:
        terms = act * adv
    else:
        terms = ppo_surrogate(torch.exp(act - t["logp_old"].float()), adv, clip)[0]
    return float((terms * m).abs().sum() / n)


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
    rows = (MAX_SMEM - fixed) // (dqn_smem_bytes(1, O, H, A) - fixed)
    if not 0 < A <= MAX_ACTIONS or rows < 1:
        raise ValueError(
            f"dqn_update on the card: obs {O}, hidden {H}, actions {A}: the two networks "
            f"and the gradient with one row need {dqn_smem_bytes(1, O, H, A)} bytes of one "
            f"block's shared memory (at most {MAX_SMEM}: hidden up to 135 at obs 4 "
            f"and 2 actions), and at most {MAX_ACTIONS} actions")
    return min(B, rows)


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


class DqnStaging(_Staging):
    """K13's buffers: the batch packed into the pinned buffer (obs,
    next_obs, rewards, dones, actions)."""

    _struct = _DqnArgs

    def __init__(self, dev, B: int, O: int):
        super().__init__(dev, 2 * B * O + 3 * B)
        self.B, self.O = B, O

    def pack(self, arrays) -> None:
        h = self.host.numpy()
        at = 0
        for name, _, _ in DQN_BATCH:
            v = arrays[name].reshape(-1)
            h[at:at + v.size] = v.view(np.float32)
            at += v.size
        self.device.copy_(self.host, non_blocking=True)


_STAGING = weakref.WeakKeyDictionary()


def _adam_args(a, optimizer, count: int) -> None:
    """AdamW.update's constants at step `count` into K12's or K13's block
    (the bias corrections float32, as optax computes them)."""
    a.b1, a.b2 = optimizer.b1, optimizer.b2
    a.omb1, a.omb2 = 1 - optimizer.b1, 1 - optimizer.b2
    a.eps, a.wd, a.nlr = optimizer.eps, optimizer.weight_decay, -optimizer.lr
    a.bc1 = optimizer.bias_correction(optimizer.b1, count)
    a.bc2 = optimizer.bias_correction(optimizer.b2, count)


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
    _check_value_head("dqn_update", params, H)
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
    _adam_args(a, optimizer, opt_state.count)
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


def update_mismatch(net, opt_state, ref_net, ref_state, updates: int, lr: float,
                    zero_grad=()):
    """How far K12's or K13's state (net, opt_state) lies from its plain
    version's (ref_net, ref_state) after `updates` updates at learning rate
    `lr`, held to UPDATE_TOL tensor by tensor: (a description of the first
    bound broken, or None; the measured numbers). The parameters named in
    `zero_grad` (DQN_ZERO_GRAD for K13, none for K12) and their moments
    must be bit-equal: their gradient is exactly 0."""
    tol = UPDATE_TOL
    got = {"params_max": 0.0, "params_share": 1.0, "moments_rel": 0.0}
    bad = None
    if opt_state.count != ref_state.count:
        bad = f"Adam's count {opt_state.count} against {ref_state.count}"
    for n in PARAM_NAMES:
        mine = (getattr(net, n), opt_state.mu[n], opt_state.nu[n])
        ref = (getattr(ref_net, n), ref_state.mu[n], ref_state.nu[n])
        if n in zero_grad:
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
    "pg_update": pg_update,
    "dqn_update": dqn_update,
}


def launch_counts() -> dict:
    with _count_lock:
        return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    with _count_lock:
        for fn in KERNELS.values():
            fn.launches = 0
