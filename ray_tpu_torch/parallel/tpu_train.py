"""The compute payload the framework orchestrates: the port of
ray_tpu/parallel/tpu_train.py.

This slice ports the single-device forward step and the training step on
one device: ``make_optimizer`` (AdamW, in optax.adamw's order of
operations), ``make_train_state`` and ``make_train_step``, with the
reference's names and signatures. The reference's step is one jitted SPMD
program over a mesh; here it is the forward and backward of ``loss_fn``
(autograd, with the model's hand-written backward kernels) and the
optimizer's update, in place, on one device. A mesh of more than one
device raises: the sharded step is ROADMAP queue 1, item 3.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from ray_tpu_torch.models.transformer import (
    _LAYER_KEYS,
    Transformer,
    TransformerConfig,
    forward,
    grads_to_numpy,
    init_params,
    loss_fn,
    numpy_params,
    params_from_numpy,
    to_numpy,
)
from ray_tpu_torch.util.device import resolve_device

_MESH_TODO = ("ray_tpu_torch: the training state and step run on one device; a mesh of "
              "{} devices (the sharded dp x tp step) is ROADMAP.md queue 1, item 3")

# the port's train step (card or CPU) against the JAX package's one-step
# golden (tests/data/train_golden.npz; train_golden_errors): loss atol;
# per-leaf gradient L2 norms rtol; sampled gradients, atol as a share of
# their leaf's rms (L2 norm over sqrt(size)); sampled parameters after one
# AdamW step atol, and the least share of a leaf's within 1e-6 (an entry
# whose gradient is near 0 can take the other sign, which moves it by
# 2 lr); the second step's loss atol. Measured (CPU / H100): f32 loss 0 /
# 9.5e-7, gradients 2.9e-5 / 5.7e-5 of the rms, params 3.2e-6 / 5.6e-6,
# 99.95 % / 99.95 % within 1e-6; bf16 loss 1.8e-4 / 1.3e-4, second loss
# 5.3e-4 / 5.0e-4, norms 0.16 % / 0.14 %, gradients 0.43 / 0.30 of the rms
# (bf16 products rounded at other places than XLA's, over six layers),
# params 6.0e-4 / 6.0e-4, 98.6 % / 98.7 % within 1e-6.
TRAIN_GOLDEN_TOL = {
    "f32": {"loss": 1e-5, "grad_norm": 1e-4, "grad": 1e-3, "param": 1e-5,
            "param_share": 0.998, "loss2": 1e-5},
    "bf16": {"loss": 2e-3, "grad_norm": 0.01, "grad": 1.0, "param": 7e-4,
             "param_share": 0.95, "loss2": 2e-3},
}


def _mesh_size(mesh) -> int:
    """Devices in `mesh` (None: one). Takes any object with a `size` (an
    int or a method) or a `devices` array."""
    if mesh is None:
        return 1
    size = getattr(mesh, "size", None)
    if callable(size):
        size = size()
    if size is None:
        size = np.asarray(mesh.devices).size
    return int(size)


def _check_mesh(mesh) -> None:
    n = _mesh_size(mesh)
    if n != 1:
        raise NotImplementedError(_MESH_TODO.format(n))


@dataclasses.dataclass
class AdamWState:
    """optax's ScaleByAdamState: the step count and the two moments, one
    float32 tensor per parameter, keyed by the parameter's name in the
    model (``embed``, ``blocks.0.wqkv``, ...)."""
    count: int
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


class AdamW:
    """optax.adamw(lr, weight_decay=weight_decay) (b1 0.9, b2 0.999, eps
    1e-8, eps_root 0, no mask) in optax's order of operations: mu = (1 -
    b1) g + b1 mu; nu = (1 - b2) g^2 + b2 nu; the bias corrections 1 -
    b^count in float32; u = (mu / bc1) / (sqrt(nu / bc2) + eps); u = u + wd
    p (every leaf, norm scales included); p = p + (-lr) u.
    torch.optim.AdamW does the same arithmetic in another order (decay
    first, sqrt(nu) / sqrt(bc2), bias corrections in float64); this one
    follows optax to the rounding. The update is in place, on the
    parameters' own device, from their ``.grad``. Like optax.adamw, which
    takes any pytree, it takes any module with ``named_parameters()`` and
    a ``device`` (the Transformer, the MoE layer)."""

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, lr: float = 3e-4, weight_decay: float = 0.01):
        self.lr, self.weight_decay = float(lr), float(weight_decay)

    def init(self, params: torch.nn.Module) -> AdamWState:
        """Zero moments for every parameter of `params`, by name."""
        zeros = {n: torch.zeros_like(p, dtype=torch.float32)
                 for n, p in params.named_parameters()}
        return AdamWState(0, zeros, {n: torch.zeros_like(z) for n, z in zeros.items()})

    def _bias_correction(self, decay: float, count: int, dev) -> torch.Tensor:
        # 1 - decay ** count in float32, as optax computes it; a device
        # tensor, so that the division is a true division on the card too
        bc = np.float32(1) - np.power(np.float32(decay), np.float32(count))
        return torch.full((), float(bc), dtype=torch.float32, device=dev)

    @torch.no_grad()
    def update(self, params: torch.nn.Module, state: AdamWState) -> AdamWState:
        """One step of every parameter of `params` from its ``.grad``, in
        place; `state` is updated in place and returned."""
        state.count += 1
        dev = params.device
        bc1 = self._bias_correction(self.b1, state.count, dev)
        bc2 = self._bias_correction(self.b2, state.count, dev)
        for name, p in params.named_parameters():
            g = p.grad
            if g is None:
                raise ValueError(f"AdamW.update: {name} has no gradient")
            mu, nu = state.mu[name], state.nu[name]
            mu.mul_(self.b1).add_(g * (1 - self.b1))
            nu.mul_(self.b2).add_((g * g) * (1 - self.b2))
            denom = torch.div(nu, bc2).sqrt_().add_(self.eps)
            u = torch.div(mu, bc1).div_(denom)
            u.add_(p * self.weight_decay)
            p.add_(u.mul_(-self.lr))
        return state


def make_optimizer(lr: float = 3e-4, weight_decay: float = 0.01) -> AdamW:
    """optax.adamw(lr, weight_decay=weight_decay)'s counterpart: b1 0.9,
    b2 0.999, eps 1e-8, eps_root 0, decay on every leaf."""
    return AdamW(lr, weight_decay)


def make_train_state(cfg: TransformerConfig, mesh=None, seed: int = 0, lr: float = 3e-4,
                     device=None):
    """(params, opt_state, tx, param_shardings) as the reference returns
    them: the model from ``init_params`` with a CPU ``torch.Generator``
    seeded with `seed` (the same weights on any device), with
    requires_grad on; AdamW's zero state; the optimizer; and None for the
    shardings. `mesh` is None or a one-device mesh; larger meshes raise
    NotImplementedError. Runs on the card unless `device` says otherwise."""
    _check_mesh(mesh)
    dev = resolve_device(device, what="make_train_state")
    params = init_params(cfg, torch.Generator().manual_seed(seed), device=dev)
    params.requires_grad_(True)
    tx = make_optimizer(lr)
    return params, tx.init(params), tx, None


def make_train_step(cfg: TransformerConfig, mesh, tx: AdamW, param_shardings=None):
    """Returns (train_step, batch_sharding=None). train_step(params,
    opt_state, batch) -> (params, opt_state, loss): the gradients set to
    None, loss_fn's forward and backward, and the optimizer's update, in
    place on params and opt_state (the reference donates both). batch is
    {"tokens": [B, S + 1]} as a numpy array or a tensor; the loss is a
    0-d float32 tensor on the params' device."""
    _check_mesh(mesh)

    def train_step(params: Transformer, opt_state: AdamWState, batch: Dict):
        tokens = torch.as_tensor(batch["tokens"], device=params.device)
        for p in params.parameters():
            p.grad = None
        with torch.enable_grad():
            loss = loss_fn(params, {"tokens": tokens}, cfg)
            loss.backward()
        tx.update(params, opt_state)
        return params, opt_state, loss.detach()

    return train_step, None


def opt_state_to_numpy(opt_state: AdamWState) -> Dict:
    """{"count", "mu", "nu"} with the moments as the reference's pytrees
    of float32 numpy arrays (layers stacked), to compare with optax's
    ScaleByAdamState."""
    def tree(moments: Dict[str, torch.Tensor]) -> Dict:
        arr = {n: t.detach().to("cpu", torch.float32).numpy().copy()
               for n, t in moments.items()}
        n_layers = len({n.split(".")[1] for n in arr if n.startswith("blocks.")})
        layers = {key: np.stack([arr[f"blocks.{i}.{key}"] for i in range(n_layers)])
                  for key in _LAYER_KEYS}
        return {"embed": arr["embed"], "unembed": arr["unembed"], "ln_f": arr["ln_f"],
                "layers": layers}

    return {"count": opt_state.count, "mu": tree(opt_state.mu), "nu": tree(opt_state.nu)}


def train_golden_errors(golden, dt_name: str, device=None) -> Dict[str, float]:
    """The port's train step against the JAX package's one-step golden
    (tests/data/train_golden.npz, loaded as a mapping): at the golden's
    weights (numpy_params of its seed, in dtype `dt_name`, "f32" or "bf16")
    and tokens, one step and the second step's loss. Returns the largest
    error of each kind that TRAIN_GOLDEN_TOL bounds (param_share: the
    smallest share, over the leaves, of sampled parameters within 1e-6)."""
    cfg = TransformerConfig(dtype={"f32": torch.float32, "bf16": torch.bfloat16}[dt_name])
    tree = numpy_params(cfg, int(golden["weight_seed"]))
    model = params_from_numpy(tree, cfg, device=device).requires_grad_(True)
    tx = make_optimizer()
    state = tx.init(model)
    step, _ = make_train_step(cfg, None, tx)
    batch = {"tokens": golden["tokens"]}
    loss = float(step(model, state, batch)[2])
    grads, params1 = grads_to_numpy(model), to_numpy(model)
    loss2 = float(step(model, state, batch)[2])
    err = {"loss": abs(loss - float(golden[f"loss_{dt_name}"])),
           "loss2": abs(loss2 - float(golden[f"loss2_{dt_name}"])), "grad_norm": 0.0,
           "grad": 0.0, "param": 0.0, "param_share": 1.0}
    for i, name in enumerate(str(n) for n in golden["leaves"]):
        g, p = grads, params1
        for key in name.split("."):
            g, p = g[key], p[key]
        want_norm = float(golden[f"grad_norm_{dt_name}"][i])
        err["grad_norm"] = max(err["grad_norm"],
                               abs(np.linalg.norm(g.astype(np.float64)) / want_norm - 1))
        pos = golden[f"pos_{name}"]
        rms = want_norm / np.sqrt(g.size)
        err["grad"] = max(err["grad"], float(
            np.abs(g.reshape(-1)[pos] - golden[f"grad_{dt_name}_{name}"]).max()) / rms)
        d = np.abs(p.reshape(-1)[pos] - golden[f"param1_{dt_name}_{name}"])
        err["param"] = max(err["param"], float(d.max()))
        err["param_share"] = min(err["param_share"], float((d <= 1e-6).mean()))
    return {k: float(e) for k, e in err.items()}


def train_golden_violations(err: Dict[str, float], dt_name: str) -> Dict[str, float]:
    """The entries of train_golden_errors' result outside TRAIN_GOLDEN_TOL."""
    tol = TRAIN_GOLDEN_TOL[dt_name]
    return {k: e for k, e in err.items()
            if (e < tol[k] if k == "param_share" else not e <= tol[k])}


def make_forward_step(cfg: TransformerConfig, device=None):
    """Single-device forward (the reference's jitted forward step):
    returns fwd(params, tokens) -> logits [B, S, V] float32, computed
    without autograd. Runs on the card unless `device` says otherwise;
    raises without one. Tokens may be a numpy array or a tensor; params
    must be a Transformer on that device."""
    dev = resolve_device(device, what="make_forward_step")

    def fwd(params: Transformer, tokens) -> torch.Tensor:
        if params.device != dev:
            raise ValueError(f"params on {params.device}, the step runs on {dev}")
        tokens = torch.as_tensor(tokens, device=dev)
        with torch.no_grad():
            return forward(params, tokens, cfg)

    return fwd
