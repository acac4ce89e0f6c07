"""The policy: an MLP categorical actor (+ value head) and its updates.

Reference structure being matched: rllib/core/learner/learner.py owns the
train math; rllib/policy/ the action computation. The JAX package jits the
forward and the whole update into single programs. Here two of them are
one hand-written kernel each on the card (rllib_kernels.py): K11 the
runner's whole step (trunk, logits, key split, draw), K13 the whole DQN
update (trunks, TD head, backward, Adam). PG and PPO keep the trunk's
products, tanh and Adam as torch ops under autograd, with K12 the loss
head and its gradient in one launch. On the CPU every program runs its
plain PyTorch version.

Parameters live in a ``PolicyNet`` module named as the reference's dict
(w1 b1 w2 b2 wp bp wv bv); ``init_params`` draws them from a numpy
Generator in the reference's order, so one seed gives the same weights in
both packages. Weights cross between the learner and the runners as
dicts of numpy arrays (``params_to_numpy`` / ``params_from_numpy``).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from ray_tpu_torch.parallel.tpu_train import AdamW, AdamWState
from ray_tpu_torch.rllib import rllib_kernels as RK
from ray_tpu_torch.util.device import resolve_device

PARAM_NAMES = ("w1", "b1", "w2", "b2", "wp", "bp", "wv", "bv")


class PolicyNet(torch.nn.Module):
    """The reference's params dict as a module: the trunk w1/b1, w2/b2
    (tanh), the policy (or Q) head wp/bp, the value head wv/bv."""

    def __init__(self, arrays: Mapping[str, np.ndarray], device="cpu"):
        super().__init__()
        for name in PARAM_NAMES:
            t = torch.tensor(np.asarray(arrays[name], np.float32), device=device)
            self.register_parameter(name, torch.nn.Parameter(t))

    @property
    def device(self) -> torch.device:
        return self.w1.device

    def trunk(self, obs: torch.Tensor) -> torch.Tensor:
        h = torch.tanh(obs @ self.w1 + self.b1)
        return torch.tanh(h @ self.w2 + self.b2)


def init_params(rng: np.random.Generator, obs_size: int, num_actions: int,
                hidden: int = 64, device=None) -> PolicyNet:
    """He-normal weights and zero biases drawn in the reference's order
    (w1, w2, wp, wv), on the card unless `device` says otherwise."""
    def dense(fan_in, fan_out):
        w = rng.normal(0, np.sqrt(2.0 / fan_in), (fan_in, fan_out))
        return w.astype(np.float32), np.zeros(fan_out, np.float32)

    arrays = {}
    for w, b, shape in (("w1", "b1", (obs_size, hidden)), ("w2", "b2", (hidden, hidden)),
                        ("wp", "bp", (hidden, num_actions)), ("wv", "bv", (hidden, 1))):
        arrays[w], arrays[b] = dense(*shape)
    return PolicyNet(arrays, resolve_device(device, what="the policy"))


def params_from_numpy(arrays: Mapping[str, np.ndarray], device=None) -> PolicyNet:
    return PolicyNet(arrays, resolve_device(device, what="the policy"))


def params_to_numpy(net: PolicyNet) -> Dict[str, np.ndarray]:
    return {n: p.detach().cpu().numpy().copy() for n, p in net.named_parameters()}


def load_params(net: PolicyNet, arrays: Mapping[str, np.ndarray]) -> None:
    """Copy numpy weights into net in place."""
    with torch.no_grad():
        for n, p in net.named_parameters():
            p.copy_(torch.as_tensor(np.asarray(arrays[n], np.float32)))


def _obs(net: PolicyNet, obs) -> torch.Tensor:
    return torch.as_tensor(obs, dtype=torch.float32).to(net.device)


@torch.no_grad()
def action_logits(net: PolicyNet, obs) -> torch.Tensor:
    x = _obs(net, obs)
    return net.trunk(x) @ net.wp + net.bp


@torch.no_grad()
def value(net: PolicyNet, obs) -> torch.Tensor:
    x = _obs(net, obs)
    return (net.trunk(x) @ net.wv + net.bv).squeeze(-1)


#: the Q-network reuses the same MLP: the "wp" head read as Q-values
q_values = action_logits


@torch.no_grad()
def sample_actions(net: PolicyNet, obs, key: torch.Tensor, buffers=None):
    """Batched categorical sampling with the key split folded in (K11):
    returns (actions, logprobs, next key), equal to the reference's
    ``key, sub = jax.random.split(key)`` then ``sample_actions(params,
    obs, sub)``. On the card one launch and one synchronisation; actions
    and logprobs come back on the host, in `buffers`
    (rllib_kernels.SampleBuffers) when given."""
    return RK.sample_actions(net, obs, key, buffers)


def make_optimizer(lr: float) -> AdamW:
    """optax.adam(lr)'s counterpart: the port's AdamW in optax's order with
    weight_decay 0 (b1 0.9, b2 0.999, eps 1e-8)."""
    return AdamW(lr, weight_decay=0.0)


def opt_state_from_optax(state, device=None) -> AdamWState:
    """An optax ScaleByAdamState with numpy leaves (or optax.adam's state
    tuple holding one) as the port's AdamWState."""
    if not hasattr(state, "mu"):
        state = next(s for s in state if hasattr(s, "mu"))
    dev = resolve_device(device, what="the optimizer state")

    def tensors(tree):
        return {n: torch.tensor(np.asarray(tree[n], np.float32), device=dev)
                for n in PARAM_NAMES}

    return AdamWState(int(np.asarray(state.count)), tensors(state.mu), tensors(state.nu))


def opt_state_to_numpy(state: AdamWState) -> Dict:
    return {"count": state.count,
            "mu": {n: t.detach().cpu().numpy() for n, t in state.mu.items()},
            "nu": {n: t.detach().cpu().numpy() for n, t in state.nu.items()}}


def _batch(net: PolicyNet, batch, key, dtype=torch.float32) -> torch.Tensor:
    return torch.as_tensor(batch[key]).to(device=net.device, dtype=dtype).contiguous()


def _step(net: PolicyNet, loss: torch.Tensor, opt_state: AdamWState,
          optimizer: AdamW) -> None:
    loss.backward()
    RK.zero_missing_grads(net)
    optimizer.update(net, opt_state)


def _pg_or_ppo(net, opt_state, batch, optimizer, clip):
    for p in net.parameters():
        p.grad = None
    obs = _batch(net, batch, "obs")
    actions = _batch(net, batch, "actions", torch.int32)
    returns, mask = _batch(net, batch, "returns"), _batch(net, batch, "mask")
    logp_old = None if clip is None else _batch(net, batch, "logp_old")
    with torch.enable_grad():
        h = net.trunk(obs)
        logits = h @ net.wp + net.bp
        v = (h @ net.wv + net.bv).squeeze(-1)
        losses = RK.PGLoss.apply(logits, v, actions, returns, mask, logp_old, clip)
        _step(net, losses[0], opt_state, optimizer)
    losses = losses.detach()
    return net, opt_state, {"total_loss": losses[0], "pg_loss": losses[1],
                            "vf_loss": losses[2]}


def pg_update(net: PolicyNet, opt_state: AdamWState, batch, optimizer: AdamW):
    """REINFORCE with a learned value baseline, one step: the loss head and
    its gradient are K12 in its PG mode. batch: obs [B, O], actions [B],
    returns [B] (reward-to-go), mask [B] (1 for real transitions, 0 for
    padding). net and opt_state are updated in place and returned."""
    return _pg_or_ppo(net, opt_state, batch, optimizer, None)


def ppo_update(net: PolicyNet, opt_state: AdamWState, batch, optimizer: AdamW,
               clip: float = RK.PPO_CLIP):
    """PPO-clip surrogate, one epoch over the batch (K12's PPO mode);
    batch additionally carries old logprobs (behavior policy)."""
    return _pg_or_ppo(net, opt_state, batch, optimizer, clip)


def dqn_update(net: PolicyNet, target_net: PolicyNet, opt_state: AdamWState, batch,
               optimizer: AdamW, gamma: float = 0.99):
    """One Q-learning step over a replay batch: double-DQN (the online
    network picks the next action, the frozen target network values it)
    with Huber loss and Adam, the whole step K13 on the card (its plain
    version, torch ops under autograd, on the CPU). batch: obs [B, O],
    actions [B], rewards [B], next_obs [B, O], dones [B]. net and
    opt_state are updated in place and returned."""
    losses = RK.dqn_update(net, target_net, opt_state, optimizer, batch, gamma)
    return net, opt_state, {"total_loss": losses[0], "td_error_abs": losses[1],
                            "q_mean": losses[2]}
