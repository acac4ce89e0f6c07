"""ray_tpu_torch's RLlib kernels (plain PyTorch versions, on the CPU) held
against what they replace in the JAX package, on the same numpy-seeded
inputs.

- prng.py against jax.random: PRNGKey, split, the random bits and the
  uniforms bit for bit (keys, bits, uniform floats); the runner's key chain
  over 512 steps; the Gumbel noise within 4 units of u = ulp(g) + ulp(y) /
  y, y = -log(u) the inner log, within 1 ulp of XLA's (an ulp of the inner
  log near y = 1 is what reaches g, where g's own ulp is far smaller).
- K11's plain version (the runner's whole step: trunk, logits, split and
  draw) against ray_tpu.rllib.policy.sample_actions after jax.random.split
  on the same params, obs and key: the next key equal, draws equal outside
  RL_TIE_GAP (the top-2 gap of logits + noise; more than 0.1 % of rows
  skipped fails), logp within 1e-6 (torch's trunk and XLA's differ by an
  ulp or so); and the wrapper's CPU path bit for bit the head-only plain
  draw on policy.action_logits it replaced.
- K12's (PG and PPO) and K13's loss heads' plain versions against
  jax.value_and_grad of the lines they replace (policy.py :71-88,
  :105-127, :160-179); K12's and K13's wrappers on the CPU bit for bit the
  updates policy.pg_update / ppo_update / dqn_update ran before each took
  the whole update (trunks, PGLoss or DQNLoss, autograd, AdamW), over 3
  updates, and Learner.update bit for bit its form with the learner's own
  padding; K12's pinned batch layout against that padding. Total and
  value losses within 1e-6 relative; the policy loss, a mean of terms of
  both signs, within 2e-6 of the mean |term| (float32 sums in XLA's order
  and in torch's differ by that much; both are that far from the float64
  value); gradients within 1e-6 of their rms plus 16 ulps of the sum of the
  magnitudes added into each entry (log_softmax's backward cancels two
  terms of similar size: JAX's own float32 gradient is up to 3.3e-6 of the
  rms from the float64 one); DQN's loss and aux within 1e-6 relative.
- The tie and clip points, pinned: PPO's surrogate at ratio 1 (inside the
  range), 0.8 and 1.2 (the clip ends: a derivative of 3/4 of adv) against
  jax.grad; the Huber gradient at |td| = 1 (1, the tie split in half twice)
  and at td = 0 (0).

- The wrappers' argument checks, and the card's limits (K11's widths,
  K12's cluster and K13's one block of shared memory) as their own
  functions; the check of a card's update against its plain version
  (update_mismatch) names the bound a fault breaks.

The CUDA kernels are held against these plain versions on the card by
tests/test_torch_rllib_card.py and chip_smoke.py phase 16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.rllib import policy as ref_pol
from ray_tpu_torch.rllib import policy as pol
from ray_tpu_torch.rllib import prng
from ray_tpu_torch.rllib import rllib_kernels as RK
from ray_tpu_torch.rllib.learner import Learner

T = torch.from_numpy
EPS32 = 2.0**-24


def _np(x):
    return np.asarray(x)


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


# ------------------------------------------------------------------ prng


SEEDS = [0, 1, 42, 123_456_789, 2**31 - 1]
SHAPES = [(1, 2), (5, 7), (2048, 2), (3, 4, 5)]


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_and_split_equal_jax(seed):
    key = jax.random.PRNGKey(seed)
    pk = prng.PRNGKey(seed)
    assert pk.tolist() == _np(key).astype(np.int64).tolist()
    for num in (2, 3, 7, 64):
        np.testing.assert_array_equal(prng.split(pk, num).numpy(),
                                      _np(jax.random.split(key, num)).astype(np.int64))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("seed", SEEDS[:3])
def test_prng_bits_and_uniforms_equal_jax(seed, shape):
    sub = jax.random.split(jax.random.PRNGKey(seed))[1]
    psub = prng.split(prng.PRNGKey(seed))[1]
    np.testing.assert_array_equal(prng.random_bits(psub, shape).numpy(),
                                  _np(jax.random.bits(sub, shape, jnp.uint32)).astype(np.int64))
    tiny = float(np.finfo(np.float32).tiny)
    for lo, hi in ((0.0, 1.0), (tiny, 1.0)):
        want = _np(jax.random.uniform(sub, shape, minval=lo, maxval=hi))
        got = prng.uniform(psub, shape, lo, hi).numpy()
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("seed", SEEDS[:3])
def test_prng_gumbel_within_4_units_of_jax(seed):
    sub = jax.random.split(jax.random.PRNGKey(seed))[1]
    psub = prng.split(prng.PRNGKey(seed))[1]
    shape = (2048, 7)
    want = _np(jax.random.gumbel(sub, shape)).astype(np.float64)
    got = prng.gumbel(psub, shape).numpy().astype(np.float64)
    u = prng.uniform(psub, shape, prng.F32_TINY, 1.0).numpy()
    inner_jax, inner = _np(-jnp.log(u)), (-torch.log(T(u))).numpy()
    assert _ulps(inner, inner_jax).max() <= 1
    y = inner.astype(np.float64)
    unit = np.spacing(np.abs(want).astype(np.float32)).astype(np.float64) \
        + np.spacing(inner).astype(np.float64) / y
    err = np.abs(got - want) / unit
    assert err.max() <= 4.0, err.max()


@pytest.mark.parametrize("shape", [(1, 2), (1, 7), (3, 2), (8, 8)], ids=str)
def test_split_and_bits_both_paths_equal_jax(shape):
    """The runner's step: the next key and sub's bits, by the Python-integer
    path (at most SCALAR_LANES elements on the CPU) and the tensor path."""
    key = jax.random.PRNGKey(7)
    nxt, sub = jax.random.split(key)
    want_bits = _np(jax.random.bits(sub, shape, jnp.uint32)).astype(np.int64)
    pk = prng.PRNGKey(7)
    got_key, got_bits = prng.split_and_bits(pk, shape)
    assert got_key.tolist() == _np(nxt).astype(np.int64).tolist()
    np.testing.assert_array_equal(got_bits.numpy(), want_bits)
    keys = prng.split(pk)
    np.testing.assert_array_equal(prng.random_bits(keys[1], shape).numpy(), want_bits)


def test_runner_key_chain_of_512_steps_equals_jax():
    """env_runner.py :45-51: PRNGKey((seed * 1_000_003 + samples) % 2**31),
    split every step; the chain of next keys and sub keys."""
    seed = (3 * 1_000_003 + 1) % 2**31

    def step(key, _):
        key, sub = jax.random.split(key)
        return key, jnp.stack([key, sub])

    _, chain = jax.lax.scan(step, jax.random.PRNGKey(seed), None, length=512)
    chain = _np(chain).astype(np.int64)
    pk = prng.PRNGKey(seed)
    for i in range(512):
        keys = prng.split(pk)
        np.testing.assert_array_equal(keys.numpy(), chain[i], err_msg=f"step {i}")
        nxt, _ = prng.split_and_bits(pk, (1, 2))
        assert nxt.tolist() == chain[i, 0].tolist()
        pk = nxt


def test_prng_key_rejects_out_of_range_seeds():
    for bad in (-1, 2**31):
        with pytest.raises(ValueError):
            prng.PRNGKey(bad)


# ------------------------------------------------------------------ K11


def _ref_params(seed, A, hidden=64):
    return ref_pol.init_params(np.random.default_rng(seed), 4, A, hidden)


def _top2_gap(scores):
    s = np.sort(scores, axis=-1)
    return s[:, -1] - s[:, -2]


@pytest.mark.parametrize("A", [2, 7])
@pytest.mark.parametrize("B", [1, 2048])
def test_sample_actions_plain_equals_jax(B, A):
    """K11's plain version, the whole runner step, on the reference's
    params, obs and key: the next key equal to split's first half, the
    draws equal sample_actions' on split's second outside RL_TIE_GAP, logp
    within 1e-6."""
    params = _ref_params(3, A)
    net = pol.params_from_numpy({k: _np(v) for k, v in params.items()}, "cpu")
    rng = np.random.default_rng(B + A)
    skipped = rows = 0
    for seed in range(40 if B == 1 else 3):
        obs = rng.normal(0, 0.5, (B, 4)).astype(np.float32)
        key = jax.random.PRNGKey(seed)
        nxt, sub = jax.random.split(key)
        want_a, want_lp = ref_pol.sample_actions(params, obs, sub)
        logits = _np(ref_pol.action_logits(params, obs))
        gap = _top2_gap(_np(jax.random.gumbel(sub, logits.shape)) + logits)
        a, lp, got_key = RK.sample_actions(net, obs, prng.PRNGKey(seed))
        assert got_key.tolist() == _np(nxt).astype(np.int64).tolist()
        clean = gap >= RK.RL_TIE_GAP
        np.testing.assert_array_equal(a.numpy()[clean], _np(want_a)[clean])
        np.testing.assert_allclose(lp.numpy(), _np(want_lp), rtol=0, atol=1e-6)
        skipped += int((~clean).sum())
        rows += B
    assert skipped <= 0.001 * rows, (skipped, rows)


@pytest.mark.parametrize("B,A,hidden", [(1, 2, 64), (3, 7, 32), (64, 2, 128)])
def test_sample_actions_cpu_path_is_the_head_only_plain_draw(B, A, hidden):
    """The wrapper on the CPU: bit for bit what the port computed before
    K11 took the trunk, the head-only plain draw on policy.action_logits,
    over a 64-step key chain."""
    net = pol.init_params(np.random.default_rng(hidden + A), 4, A, hidden, device="cpu")
    rng = np.random.default_rng(B)
    k_got = k_want = prng.PRNGKey(B * 7919)
    for _ in range(64):
        obs = rng.normal(0, 1.0, (B, 4)).astype(np.float32)
        a, lp, k_got = pol.sample_actions(net, obs, k_got)
        b, lq, k_want = RK.draw_plain(pol.action_logits(net, obs).contiguous(), k_want)
        assert torch.equal(a, b) and torch.equal(k_got, k_want)
        assert torch.equal(lp.view(torch.int32), lq.view(torch.int32))


def test_sample_actions_wrapper_checks_its_arguments():
    net = pol.init_params(np.random.default_rng(0), 4, 2, 8, device="cpu")
    obs = np.zeros((3, 4), np.float32)
    with pytest.raises(ValueError):
        RK.sample_actions(net, obs, torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError):
        RK.sample_actions(net, np.zeros((3, 5), np.float32), prng.PRNGKey(0))
    with pytest.raises(ValueError):
        RK.sample_actions(net, np.zeros((0, 4), np.float32), prng.PRNGKey(0))
    wide = pol.init_params(np.random.default_rng(0), 4, RK.MAX_ACTIONS + 1, 8, device="cpu")
    with pytest.raises(ValueError):
        RK.sample_actions(wide, obs, prng.PRNGKey(0))
    with torch.no_grad():
        net.b1 = torch.nn.Parameter(torch.zeros(9))
    with pytest.raises(ValueError):
        RK.sample_actions(net, obs, prng.PRNGKey(0))


@pytest.mark.parametrize("O,H,A,ok", [(4, 64, 2, True), (64, 256, 64, True),
                                      (65, 64, 2, False), (4, 257, 2, False),
                                      (4, 64, 65, False)])
def test_sample_actions_card_limits(O, H, A, ok):
    if ok:
        RK.policy_sample_limits(O, H, A)
    else:
        with pytest.raises(ValueError):
            RK.policy_sample_limits(O, H, A)


# ------------------------------------------------------------------ K12


def jax_pg_head(logits, v, batch, ppo, clip=0.2):
    """The loss_fn of pg_update (ppo False) or ppo_update past the trunk,
    as policy.py :71-88 and :105-127 write it."""
    logp_all = jax.nn.log_softmax(logits)
    logp = jnp.take_along_axis(
        logp_all, batch["actions"][:, None].astype(jnp.int32), axis=1).squeeze(-1)
    m = batch["mask"]
    n = jnp.maximum(m.sum(), 1.0)
    adv = batch["returns"] - jax.lax.stop_gradient(v)
    adv = (adv - (adv * m).sum() / n) / (
        jnp.sqrt(((adv - (adv * m).sum() / n) ** 2 * m).sum() / n) + 1e-6)
    if ppo:
        ratio = jnp.exp(logp - batch["logp_old"])
        surr = jnp.minimum(ratio * adv, jnp.clip(ratio, 1 - clip, 1 + clip) * adv)
        pg_loss = -(surr * m).sum() / n
    else:
        pg_loss = -(logp * jax.lax.stop_gradient(adv) * m).sum() / n
    v_loss = (jnp.square(batch["returns"] - v) * m).sum() / n
    entropy = -(jnp.exp(logp_all) * logp_all).sum(-1)
    ent_bonus = (entropy * m).sum() / n
    return pg_loss + 0.5 * v_loss - 0.01 * ent_bonus, (pg_loss, v_loss)


_pg_grad = jax.jit(jax.value_and_grad(jax_pg_head, argnums=(0, 1), has_aux=True),
                   static_argnums=(3,))


def _pg_case(seed, B, A, n_real, first_epoch=False):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(B, A)).astype(np.float32)
    batch = {"actions": rng.integers(0, A, B).astype(np.int32),
             "returns": rng.normal(3, 2, B).astype(np.float32),
             "mask": (np.arange(B) < n_real).astype(np.float32)}
    v = rng.normal(size=B).astype(np.float32)
    lp = np.take_along_axis(_np(jax.nn.log_softmax(logits)), batch["actions"][:, None], 1)[:, 0]
    drift = 0.0 if first_epoch else rng.normal(size=B) * 0.2 * (rng.random(B) < 0.5)
    batch["logp_old"] = (lp + drift).astype(np.float32)
    return logits, v, batch


def _pg_scale(logits, v, batch, ppo):
    """Per entry of dlogits: the sum of the magnitudes added into it (the
    entropy's two terms, the policy term at the action, and log_softmax's
    backward), the scale of its float32 rounding."""
    lp = _np(jax.nn.log_softmax(logits)).astype(np.float64)
    p = np.exp(lp)
    m = batch["mask"].astype(np.float64)
    n = max(m.sum(), 1.0)
    adv = batch["returns"] - v
    c = adv - (adv * m).sum() / n
    adv_n = np.abs(c / (np.sqrt((c * c * m).sum() / n) + 1e-6))
    act = batch["actions"]
    ratio = np.exp(np.take_along_axis(lp, act[:, None], 1)[:, 0] - batch["logp_old"]) \
        if ppo else 1.0
    t = 0.01 / n * m[:, None] * p * (1 + np.abs(lp))
    t[np.arange(len(act)), act] += m / n * adv_n * ratio
    return t + p * t.sum(1, keepdims=True)


def _pg_term_scale(logits, v, batch, ppo):
    """The mean |term| of the policy loss's masked mean (float64)."""
    lp = _np(jax.nn.log_softmax(logits)).astype(np.float64)
    act_lp = np.take_along_axis(lp, batch["actions"][:, None], 1)[:, 0]
    m = batch["mask"].astype(np.float64)
    n = max(m.sum(), 1.0)
    adv = batch["returns"] - v.astype(np.float64)
    c = adv - (adv * m).sum() / n
    adv_n = c / (np.sqrt((c * c * m).sum() / n) + 1e-6)
    if ppo:
        ratio = np.exp(act_lp - batch["logp_old"])
        terms = np.minimum(ratio * adv_n, np.clip(ratio, 0.8, 1.2) * adv_n)
    else:
        terms = act_lp * adv_n
    return np.abs(terms * m).sum() / n


def _assert_pg_matches(losses, dl, dv, want, logits, v, batch, ppo):
    (l, (pg, vl)), (gl, gv) = want
    np.testing.assert_allclose(losses.numpy()[[0, 2]], [l, vl], rtol=1e-6, atol=0)
    assert abs(losses[1].item() - float(pg)) <= 2e-6 * _pg_term_scale(logits, v, batch, ppo)
    gl, gv = _np(gl), _np(gv)
    rms = np.sqrt((gl.astype(np.float64) ** 2).mean())
    tol = 1e-6 * rms + 16 * EPS32 * _pg_scale(logits, v, batch, ppo)
    assert (np.abs(dl.numpy() - gl) <= tol).all(), np.abs(dl.numpy() - gl).max() / rms
    rms_v = np.sqrt((gv.astype(np.float64) ** 2).mean())
    np.testing.assert_allclose(dv.numpy(), gv, rtol=0, atol=1e-6 * rms_v)


@pytest.mark.parametrize("ppo", [False, True], ids=["pg", "ppo"])
@pytest.mark.parametrize("A", [2, 7])
@pytest.mark.parametrize("B,n_real", [(2048, 2048), (2048, 1500), (1024, 1000), (64, 1)])
def test_pg_loss_plain_equals_value_and_grad(ppo, A, B, n_real):
    logits, v, batch = _pg_case(B + A + n_real, B, A, n_real)
    want = _pg_grad(logits, v, batch, ppo)
    got = RK.pg_loss_plain(T(logits), T(v), T(batch["actions"]), T(batch["returns"]),
                           T(batch["mask"]), T(batch["logp_old"]) if ppo else None,
                           RK.PPO_CLIP if ppo else None)
    _assert_pg_matches(*got, want, logits, v, batch, ppo)


def test_ppo_first_epoch_ties_every_row():
    """logp_old = logp: every ratio is 1 (or an ulp from it), inside the
    clip range, so jnp.minimum ties on every row and each product takes
    half of the cotangent."""
    logits, v, batch = _pg_case(5, 1024, 2, 1024, first_epoch=True)
    want = _pg_grad(logits, v, batch, True)
    got = RK.pg_loss_plain(T(logits), T(v), T(batch["actions"]), T(batch["returns"]),
                           T(batch["mask"]), T(batch["logp_old"]), RK.PPO_CLIP)
    _assert_pg_matches(*got, want, logits, v, batch, True)
    lp = RK.log_softmax_plain(T(logits))[3]
    ratio = torch.exp(lp.gather(1, T(batch["actions"]).long()[:, None])[:, 0]
                      - T(batch["logp_old"]))
    surr, w_a, w_b, w_clip = RK.ppo_surrogate(ratio, torch.ones_like(ratio), RK.PPO_CLIP)
    assert (w_a == 0.5).all() and (w_b == 0.5).all() and (w_clip == 1.0).all()


@pytest.mark.parametrize("r,adv", [(1.0, 2.0), (1.2, 2.0), (0.8, 2.0), (1.2, -2.0),
                                   (0.8, -2.0), (1.5, 2.0), (0.5, -2.0), (1.1, 0.0)])
def test_ppo_surrogate_gradient_at_ties_and_clip_ends(r, adv):
    """d/dr of jnp.minimum(r * adv, jnp.clip(r, 0.8, 1.2) * adv) by
    jax.grad against the port's weights; at r = 1.2 with adv 2 it is 1.5."""
    r32, adv32 = np.float32(r), np.float32(adv)
    want = float(jax.grad(lambda x: jnp.minimum(x * adv32, jnp.clip(x, 1 - 0.2, 1 + 0.2)
                                                * adv32))(r32))
    ratio, a = torch.tensor([r32]), torch.tensor([adv32])
    surr, w_a, w_b, w_clip = RK.ppo_surrogate(ratio, a, 0.2)
    got = (w_a * a + w_b * a * w_clip).item()
    assert got == want, (got, want)
    if (r, adv) == (1.2, 2.0):
        assert got == 1.5


# ------------------------------------------------------------------ K12's update


def _pg_learner(seed, B, A, hidden=64, n=None):
    """A policy on the CPU, its Adam state, the optimizer and a padded
    batch of B rows (the first n real)."""
    rng = np.random.default_rng(seed)
    net = pol.init_params(np.random.default_rng(seed), 4, A, hidden, device="cpu")
    opt = pol.make_optimizer(3e-3)
    n = B if n is None else n
    batch = {"obs": rng.normal(0, 0.5, (B, 4)).astype(np.float32),
             "actions": rng.integers(0, A, B).astype(np.int32),
             "returns": rng.uniform(0, 40, B).astype(np.float32),
             "logp_old": np.log(rng.uniform(0.3, 0.7, B)).astype(np.float32),
             "mask": (np.arange(B) < n).astype(np.float32)}
    return net, opt.init(net), opt, batch


def _pg_update_before_k12(net, state, opt, batch, clip):
    """policy.pg_update / ppo_update as the port ran them before K12 took
    the whole update: the trunk and both heads as torch ops, PGLoss under
    autograd, AdamW."""
    for p in net.parameters():
        p.grad = None
    t = {k: torch.as_tensor(v).to(dtype=torch.int32 if k == "actions" else torch.float32)
         .contiguous() for k, v in batch.items()}
    h = net.trunk(t["obs"])
    logits = h @ net.wp + net.bp
    v = (h @ net.wv + net.bv).squeeze(-1)
    losses = RK.PGLoss.apply(logits, v, t["actions"], t["returns"], t["mask"],
                             None if clip is None else t["logp_old"], clip)
    losses[0].backward()
    for p in net.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    opt.update(net, state)
    return losses.detach()


def _assert_same_state(net, state, ref, ref_state):
    assert state.count == ref_state.count
    for n in RK.PARAM_NAMES:
        assert torch.equal(getattr(net, n), getattr(ref, n)), n
        assert torch.equal(state.mu[n], ref_state.mu[n]), n
        assert torch.equal(state.nu[n], ref_state.nu[n]), n


@pytest.mark.parametrize("ppo", [False, True], ids=["pg", "ppo"])
@pytest.mark.parametrize("B,A,n", [(256, 2, 256), (128, 7, 100), (5, 3, 5)])
def test_pg_update_cpu_path_is_the_update_it_replaced(ppo, B, A, n):
    net, state, opt, batch = _pg_learner(B + A, B, A, n=n)
    ref = pol.params_from_numpy(pol.params_to_numpy(net), "cpu")
    ref_state = opt.init(ref)
    clip = RK.PPO_CLIP if ppo else None
    fn = pol.ppo_update if ppo else pol.pg_update
    rng = np.random.default_rng(5)
    for _ in range(3):
        got = fn(net, state, batch, opt)[2]
        want = _pg_update_before_k12(ref, ref_state, opt, batch, clip)
        assert torch.equal(torch.stack([got["total_loss"], got["pg_loss"], got["vf_loss"]]),
                           want)
        batch = dict(batch, obs=rng.normal(0, 0.5, (B, 4)).astype(np.float32))
    assert state.count == 3
    _assert_same_state(net, state, ref, ref_state)
    assert RK.update_mismatch(net, state, ref, ref_state, 3, opt.lr)[0] is None


def _learner_pad_before_k12(batch, size):
    """Learner._pad as it was: the batch cut to size, zeros concatenated,
    the mask 1 on the real rows."""
    n = len(batch["obs"])
    if n > size:
        batch = {k: v[:size] for k, v in batch.items()}
        n = size
    out = {k: torch.from_numpy(np.concatenate([batch[k], np.zeros((size - n,)
                                                                  + batch[k].shape[1:],
                                                                  batch[k].dtype)]))
           for k in ("obs", "actions", "returns", "logp_old")}
    mask = np.zeros(size, np.float32)
    mask[:n] = 1.0
    out["mask"] = torch.from_numpy(mask)
    return out


@pytest.mark.parametrize("algo", ["pg", "ppo"])
@pytest.mark.parametrize("n", [100, 128, 200])
def test_learner_update_cpu_path_is_the_update_it_replaced(algo, n):
    """Learner.update on the CPU, the sampled batch padded (or cut) to
    train_batch_size inside K12's wrapper: bit for bit its form before K12
    (the learner's own padding, then the update as torch ops), over 3
    updates."""
    learner = Learner(4, 2, algo=algo, train_batch_size=128, device="cpu")
    ref = pol.params_from_numpy(learner.get_weights(), "cpu")
    opt = pol.make_optimizer(3e-3)
    ref_state = opt.init(ref)
    rng = np.random.default_rng(n)
    for _ in range(3):
        batch = {"obs": rng.normal(0, 0.5, (n, 4)).astype(np.float32),
                 "actions": rng.integers(0, 2, n).astype(np.int32),
                 "returns": rng.uniform(0, 40, n).astype(np.float32),
                 "logp_old": np.log(rng.uniform(0.3, 0.7, n)).astype(np.float32)}
        got = learner.update(batch)
        want = _pg_update_before_k12(ref, ref_state, opt, _learner_pad_before_k12(batch, 128),
                                     RK.PPO_CLIP if algo == "ppo" else None)
        assert [got["total_loss"], got["pg_loss"], got["vf_loss"]] == want.tolist()
        assert got["num_env_steps_trained"] == min(n, 128)
    _assert_same_state(learner.params, learner.opt_state, ref, ref_state)


@pytest.mark.parametrize("ppo", [False, True], ids=["pg", "ppo"])
@pytest.mark.parametrize("n,rows", [(100, 128), (128, 128), (200, 128), (64, None)])
def test_pg_staging_layout_is_the_padded_batch(ppo, n, rows):
    """K12's pinned batch (pack_pg_batch, over stale contents) read back
    field by field equals pad_batch's padding of the same batch, the
    plain version's input; PG leaves logp_old's room as it was."""
    batch = _pg_learner(n, n, 3)[3]
    if rows is not None:
        del batch["mask"]
    if not ppo:
        del batch["logp_old"]
    arrays, B, m = RK._pg_batch(batch, 4, 3, RK.PPO_CLIP if ppo else None, rows)
    assert (B, m) == ((rows, min(n, rows)) if rows else (n, n))
    h = np.full(B * 4 + 4 * B, 7.0, np.float32)
    RK.pack_pg_batch(h, arrays, B, 4, m)
    want = RK.pad_batch(arrays, B, m)
    np.testing.assert_array_equal(h[:4 * B].reshape(B, 4), want["obs"])
    np.testing.assert_array_equal(h[4 * B:5 * B].view(np.int32), want["actions"])
    np.testing.assert_array_equal(h[5 * B:6 * B], want["returns"])
    if ppo:
        np.testing.assert_array_equal(h[6 * B:7 * B], want["logp_old"])
    else:
        assert (h[6 * B:7 * B] == 7.0).all()
    np.testing.assert_array_equal(h[7 * B:], want["mask"])
    assert want["mask"].sum() == m


PG_BAD_ARGS = ["ppo_without_logp_old", "obs_width", "short_returns", "float_actions",
               "int_obs", "action_past_A", "negative_action", "mask_and_rows", "no_returns",
               "no_rows", "value_head_width"]


@pytest.mark.parametrize("case", PG_BAD_ARGS)
def test_pg_update_wrapper_checks_its_arguments(case):
    """Each bad argument raises before anything moves: the params and
    Adam's count as they were."""
    net, state, opt, batch = _pg_learner(0, 8, 3)
    clip, rows = None, None
    if case == "ppo_without_logp_old":
        batch.pop("logp_old")
        clip = RK.PPO_CLIP
    elif case == "obs_width":
        batch["obs"] = batch["obs"][:, :3]
    elif case == "short_returns":
        batch["returns"] = batch["returns"][:-1]
    elif case == "float_actions":
        batch["actions"] = batch["actions"].astype(np.float32)
    elif case == "int_obs":
        batch["obs"] = batch["obs"].astype(np.int32)
    elif case == "action_past_A":
        batch["actions"][0] = 3
    elif case == "negative_action":
        batch["actions"][0] = -1
    elif case == "mask_and_rows":
        rows = 16
    elif case == "no_returns":
        batch.pop("returns")
    elif case == "no_rows":
        batch = {k: v[:0] for k, v in batch.items()}
    elif case == "value_head_width":
        net.wv = torch.nn.Parameter(torch.zeros(64, 2))
    before = pol.params_to_numpy(net)
    with pytest.raises(ValueError):
        RK.pg_update(net, state, opt, batch, clip, rows=rows)
    assert state.count == 0
    for k, v in pol.params_to_numpy(net).items():
        np.testing.assert_array_equal(v, before[k])


@pytest.mark.parametrize("B,O,H,A,plan", [
    (2048, 4, 64, 2, (16, 128)), (2048, 4, 128, 2, (16, 85)), (2048, 4, 32, 7, (16, 128)),
    (1024, 4, 64, 2, (16, 64)), (256, 4, 64, 2, (4, 64)), (128, 4, 64, 2, (2, 64)),
    (5, 4, 64, 2, (1, 5)), (8192, 4, 64, 2, (16, 350)), (2048, 4, 164, 2, (16, 2)),
    (2048, 4, 165, 2, None), (128, 4, 256, 2, None), (8, 4, 64, 65, None),
    (10**6, 4, 64, 2, None)])
def test_pg_update_card_limits(B, O, H, A, plan):
    """K12's cluster and its rows a tile: P blocks of at most 64 rows up to
    16 blocks; a block's rows in one tile where they fit (the default
    2 048 at hidden 64), else as many as fit (hidden 128: 85 of 128);
    widths or batches where not one row fits, and too many actions, raise
    (as Learner raises at build time on the card)."""
    if plan is None:
        with pytest.raises(ValueError):
            RK.pg_plan(B, O, H, A)
        return
    assert RK.pg_plan(B, O, H, A) == plan
    P, R = plan
    Q = -(-B // P)
    assert P * RK.PG_ROWS_A_BLOCK >= B or P == RK.PG_MAX_CLUSTER
    assert RK.pg_smem_bytes(Q, R, O, H, A) <= RK.MAX_SMEM
    if R < Q:
        assert RK.pg_smem_bytes(Q, R + 1, O, H, A) > RK.MAX_SMEM


def test_pg_update_mismatch_holds_the_value_head_to_the_bounds():
    """For K12 no tensor is held bit-equal (both heads carry a gradient):
    a value head an ulp or so off passes, one 3 lr off is named."""
    net, state, opt, batch = _pg_learner(2, 16, 2)
    pol.pg_update(net, state, batch, opt)
    ref = pol.params_from_numpy(pol.params_to_numpy(net), "cpu")
    ref_state = type(state)(state.count, {n: t.clone() for n, t in state.mu.items()},
                            {n: t.clone() for n, t in state.nu.items()})
    assert RK.update_mismatch(net, state, ref, ref_state, 1, opt.lr)[0] is None
    with torch.no_grad():
        ref.bv += 1e-9
    assert RK.update_mismatch(net, state, ref, ref_state, 1, opt.lr)[0] is None
    assert RK.update_mismatch(net, state, ref, ref_state, 1, opt.lr,
                              RK.DQN_ZERO_GRAD)[0].startswith("bv")
    with torch.no_grad():
        ref.wv[0, 0] += 3 * opt.lr
    assert RK.update_mismatch(net, state, ref, ref_state, 1, opt.lr)[0].startswith("wv: an entry")


@pytest.mark.parametrize("ppo", [False, True], ids=["pg", "ppo"])
def test_pg_term_scale_is_the_mean_abs_term(ppo):
    """pg_term_scale, the scale a card's policy loss is held to, against
    the float64 mean |term| of the reference's lines."""
    net, _, _, batch = _pg_learner(3, 256, 3, n=200)
    with torch.no_grad():
        h = net.trunk(T(batch["obs"]))
        logits, v = (h @ net.wp + net.bp).numpy(), (h @ net.wv + net.bv)[:, 0].numpy()
    want = _pg_term_scale(logits, v, batch, ppo)
    got = RK.pg_term_scale(net, batch, RK.PPO_CLIP if ppo else None)
    assert want > 0.1 and abs(got - want) <= 1e-5 * want


# ------------------------------------------------------------------ K13


def jax_dqn_head(q, q_next_online, q_next_t, batch, gamma=0.99):
    """dqn_update's loss_fn past the three trunks (policy.py :160-179)."""
    qa = jnp.take_along_axis(q, batch["actions"][:, None].astype(jnp.int32), axis=1).squeeze(-1)
    a_next = jnp.argmax(q_next_online, axis=-1)
    q_next = jnp.take_along_axis(q_next_t, a_next[:, None], axis=1).squeeze(-1)
    target = batch["rewards"] + gamma * (1.0 - batch["dones"]) * q_next
    td = qa - jax.lax.stop_gradient(target)
    loss = optax.huber_loss(td, jnp.zeros_like(td)).mean()
    return loss, (jnp.abs(td).mean(), q.mean())


_dqn_grad = jax.jit(jax.value_and_grad(jax_dqn_head, has_aux=True))


def _dqn_case(seed, B, A, ties=False):
    rng = np.random.default_rng(seed)
    q = (rng.normal(size=(B, A)) * 3).astype(np.float32)
    qo = rng.normal(size=(B, A)).astype(np.float32)
    if ties:
        qo[::3, 1] = qo[::3, 0]  # the online argmax takes the first index
    qt = rng.normal(size=(B, A)).astype(np.float32)
    batch = {"actions": rng.integers(0, A, B).astype(np.int32),
             "rewards": np.ones(B, np.float32),
             "dones": (rng.random(B) < 0.1).astype(np.float32)}
    return q, qo, qt, batch


def _dqn_port(q, qo, qt, batch, gamma=0.99):
    return RK.dqn_loss_plain(T(q), T(qo), T(qt), T(batch["actions"]), T(batch["rewards"]),
                       T(batch["dones"]), gamma)


@pytest.mark.parametrize("A", [2, 7])
@pytest.mark.parametrize("B", [128, 33])
def test_dqn_loss_plain_equals_value_and_grad(B, A):
    q, qo, qt, batch = _dqn_case(B * A, B, A, ties=True)
    (l, (ta, qm)), g = _dqn_grad(q, qo, qt, batch)
    losses, dq = _dqn_port(q, qo, qt, batch)
    np.testing.assert_allclose(losses.numpy(), [l, ta, qm], rtol=1e-6, atol=0)
    g = _np(g)
    rms = np.sqrt((g.astype(np.float64) ** 2).mean())
    np.testing.assert_allclose(dq.numpy(), g, rtol=0, atol=1e-6 * rms)
    off = np.arange(A)[None, :] != batch["actions"][:, None]
    assert (dq.numpy()[off] == 0).all()


def test_huber_gradient_pinned_at_one_and_zero():
    """td = q[a] with reward 0 and done 1: optax.huber_loss's gradient is 1
    at |td| = 1 (jnp.minimum's tie split in half, twice), 0 at td = 0, td
    itself inside, the sign outside."""
    tds = np.array([1.0, -1.0, 0.0, 0.5, -0.25, 2.0, -3.0, 1.0], np.float32)
    B, A = len(tds), 2
    q = np.zeros((B, A), np.float32)
    q[:, 1] = tds
    qo = np.zeros((B, A), np.float32)
    qt = np.full((B, A), 7.0, np.float32)
    batch = {"actions": np.ones(B, np.int32), "rewards": np.zeros(B, np.float32),
             "dones": np.ones(B, np.float32)}
    (_, _), g = _dqn_grad(q, qo, qt, batch)
    _, dq = _dqn_port(q, qo, qt, batch)
    want = np.array([1.0, -1.0, 0.0, 0.5, -0.25, 1.0, -1.0, 1.0], np.float32) / B
    np.testing.assert_array_equal(_np(g)[:, 1], want)
    np.testing.assert_array_equal(dq.numpy()[:, 1], want)
    assert (dq.numpy()[:, 0] == 0).all()


def _dqn_learner(seed, B, A, hidden=64):
    rng = np.random.default_rng(seed)
    net = pol.init_params(np.random.default_rng(seed), 4, A, hidden, device="cpu")
    tnet = pol.init_params(np.random.default_rng(seed + 1), 4, A, hidden, device="cpu")
    opt = pol.make_optimizer(1e-3)
    batch = {"obs": rng.normal(0, 0.5, (B, 4)).astype(np.float32),
             "actions": rng.integers(0, A, B).astype(np.int32),
             "rewards": np.ones(B, np.float32),
             "next_obs": rng.normal(0, 0.5, (B, 4)).astype(np.float32),
             "dones": (rng.random(B) < 0.1).astype(np.float32)}
    return net, tnet, opt.init(net), opt, batch


def _dqn_update_before_k13(net, tnet, state, opt, batch, gamma=0.99):
    """policy.dqn_update as the port ran it before K13 took the whole
    update: the trunks as torch ops, the TD head under autograd, AdamW."""
    for p in net.parameters():
        p.grad = None
    t = {k: torch.as_tensor(v).to(dtype=torch.int32 if k == "actions" else torch.float32)
         for k, v in batch.items()}
    with torch.no_grad():
        qo = (net.trunk(t["next_obs"]) @ net.wp + net.bp).contiguous()
        qt = (tnet.trunk(t["next_obs"]) @ tnet.wp + tnet.bp).contiguous()
    q = net.trunk(t["obs"]) @ net.wp + net.bp
    losses = RK.DQNLoss.apply(q, qo, qt, t["actions"], t["rewards"], t["dones"], gamma)
    losses[0].backward()
    for p in net.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    opt.update(net, state)
    return losses.detach()


@pytest.mark.parametrize("B,A", [(128, 2), (32, 7)])
def test_dqn_update_cpu_path_is_the_update_it_replaced(B, A):
    net, tnet, state, opt, batch = _dqn_learner(B + A, B, A)
    ref = pol.params_from_numpy(pol.params_to_numpy(net), "cpu")
    ref_state = opt.init(ref)
    rng = np.random.default_rng(5)
    for _ in range(3):
        got = pol.dqn_update(net, tnet, state, batch, opt)[2]
        want = _dqn_update_before_k13(ref, tnet, ref_state, opt, batch)
        assert torch.equal(torch.stack([got["total_loss"], got["td_error_abs"],
                                        got["q_mean"]]), want)
        batch = dict(batch, obs=rng.normal(0, 0.5, (B, 4)).astype(np.float32))
    assert state.count == ref_state.count == 3
    for n in RK.PARAM_NAMES:
        assert torch.equal(getattr(net, n), getattr(ref, n)), n
        assert torch.equal(state.mu[n], ref_state.mu[n]) and torch.equal(state.nu[n],
                                                                          ref_state.nu[n])
    assert RK.update_mismatch(net, state, ref, ref_state, 3, opt.lr,
                              RK.DQN_ZERO_GRAD)[0] is None


def test_dqn_update_mismatch_names_the_bound_broken():
    net, tnet, state, opt, batch = _dqn_learner(1, 16, 2)
    zero = RK.DQN_ZERO_GRAD
    pol.dqn_update(net, tnet, state, batch, opt)
    ref = pol.params_from_numpy(pol.params_to_numpy(net), "cpu")
    ref_state = type(state)(state.count, {n: t.clone() for n, t in state.mu.items()},
                            {n: t.clone() for n, t in state.nu.items()})
    assert RK.update_mismatch(net, state, ref, ref_state, 1, opt.lr, zero)[0] is None
    with torch.no_grad():
        ref.w2[0, 0] += 3 * opt.lr
    assert RK.update_mismatch(net, state, ref, ref_state, 1, opt.lr,
                              zero)[0].startswith("w2: an entry")
    with torch.no_grad():
        ref.w2[0, 0] -= 3 * opt.lr
        ref_state.mu["w2"][0, 0] *= 1.01
    assert "moment" in RK.update_mismatch(net, state, ref, ref_state, 1, opt.lr, zero)[0]
    with torch.no_grad():
        ref_state.mu["w2"][0, 0] /= 1.01
    assert RK.update_mismatch(net, state, ref, ref_state, 1, opt.lr, zero)[0] is None
    # a fault confined to one bias vector: 2 of its 16 entries, 0.05 % of
    # all the params
    with torch.no_grad():
        ref.b2[:2] += 1e-5
    assert RK.update_mismatch(net, state, ref, ref_state, 1, opt.lr, zero)[0].startswith("b2")
    with torch.no_grad():
        ref.b2[:2] -= 1e-5
        ref.bv += 1e-9
    assert "bv" in RK.update_mismatch(net, state, ref, ref_state, 1, opt.lr, zero)[0]


@pytest.mark.parametrize("B,O,H,A,rows", [(128, 4, 64, 2, 128), (2048, 4, 64, 2, 299),
                                          (32, 4, 128, 7, 9), (128, 4, 128, 2, 16),
                                          (1, 4, 256, 2, None), (8, 4, 64, 65, None)])
def test_dqn_update_card_limits(B, O, H, A, rows):
    """K13's rows a tile: the whole batch where it fits (DQN's 128 at the
    default width), else as many rows as fit; widths where not one row
    fits, and too many actions, raise."""
    if rows is None:
        with pytest.raises(ValueError):
            RK.dqn_tile_rows(B, O, H, A)
        return
    assert RK.dqn_tile_rows(B, O, H, A) == rows
    assert RK.dqn_smem_bytes(rows, O, H, A) <= RK.MAX_SMEM
    if rows < B:
        assert RK.dqn_smem_bytes(rows + 1, O, H, A) > RK.MAX_SMEM


def test_loss_wrappers_check_their_arguments():
    net, state, opt, batch = _pg_learner(0, 4, 2)
    with pytest.raises(ValueError):
        RK.pg_update(net, state, opt, dict(batch, actions=batch["actions"].astype(np.float32)))
    with pytest.raises(ValueError):
        RK.pg_update(net, state, opt, {k: v for k, v in batch.items() if k != "logp_old"},
                     RK.PPO_CLIP)
    assert state.count == 0
    net, tnet, state, opt, batch = _dqn_learner(0, 8, 2)
    batch["next_obs"] = batch["next_obs"][:7]
    with pytest.raises(ValueError):
        RK.dqn_update(net, tnet, state, opt, batch)
    batch = _dqn_learner(0, 8, 2)[4]
    batch["actions"] = batch["actions"][:, None]
    with pytest.raises(ValueError):
        RK.dqn_update(net, tnet, state, opt, batch)


def test_autograd_functions_return_the_saved_gradient():
    """PGLoss and DQNLoss: backward gives the kernel's gradient times the
    total loss's cotangent."""
    logits, v, batch = _pg_case(11, 256, 3, 200)
    lg = T(logits).requires_grad_(True)
    vt = T(v).requires_grad_(True)
    args = (T(batch["actions"]), T(batch["returns"]), T(batch["mask"]))
    losses = RK.PGLoss.apply(lg, vt, *args, None, None)
    (2.0 * losses[0] + 5.0 * losses[1]).backward()
    _, dl, dv = RK.pg_loss_plain(T(logits), T(v), *args)
    assert torch.equal(lg.grad, dl * 2.0) and torch.equal(vt.grad, dv * 2.0)
    q, qo, qt, b = _dqn_case(3, 16, 2)
    qg = T(q).requires_grad_(True)
    out = RK.DQNLoss.apply(qg, T(qo), T(qt), T(b["actions"]), T(b["rewards"]),
                           T(b["dones"]), 0.99)
    out[0].backward()
    assert torch.equal(qg.grad, _dqn_port(q, qo, qt, b)[1])
