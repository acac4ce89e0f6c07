"""The compute payload the framework orchestrates: the port of
ray_tpu/parallel/tpu_train.py.

The single-device forward step and the training step: ``make_optimizer``
(AdamW, in optax.adamw's order of operations), ``make_train_state`` and
``make_train_step``, with the reference's names and signatures. The
reference's step is one jitted SPMD program over a mesh; here it is the
forward and backward of ``loss_fn`` (autograd, with the model's
hand-written backward kernels) and the optimizer's update, in place.

Over a port mesh (``parallel.mesh.Mesh`` with axes "dp" and "tp") every
rank runs the same step on its shards (``models.transformer.shard_params``,
the Megatron layout of ``param_partition_specs``): its "dp" block of the
batch, the "tp" collectives inside the forward and its recompute, then one
psum over "dp" of a flat buffer of every gradient and the loss, divided by
dp, and AdamW on the shards, its moments mirroring them. The conjugate "tp"
collectives give the leaves replicated over "tp" (the norm scales) the
same gradient on every rank of the line, so nothing is summed over "tp"
again; and the psum's result is the same bits on every rank, so every
replicated leaf stays bit-equal across the ranks that hold it. A weight's
gradient on a rank is its product's own, rounded to the dtype as the
one-device step's is (for its "dp" block), before the float32 psum.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

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
    param_partition_specs,
    params_from_numpy,
    shard_params,
    to_numpy,
)
from ray_tpu_torch.parallel.mesh import Mesh
from ray_tpu_torch.util.device import resolve_device

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


def _check_mesh(cfg: TransformerConfig, mesh) -> Optional[Mesh]:
    """The port mesh to shard over, or None for one device (no mesh, or a
    mesh of one device of any kind, train.prepare_mesh's for one worker
    too). Raises ValueError for a larger mesh that is not a port Mesh with
    axes ("dp", "tp"), or whose tp does not divide the heads and d_ff."""
    if mesh is None or _mesh_size(mesh) == 1:
        return None
    if not isinstance(mesh, Mesh):
        raise ValueError(f"a mesh of {_mesh_size(mesh)} devices must be a "
                         f"ray_tpu_torch.parallel.mesh.Mesh, not {type(mesh).__name__}")
    if mesh.axis_names != ("dp", "tp"):
        raise ValueError(f"the train step's mesh has axes {mesh.axis_names}, "
                         "('dp', 'tp') needed")
    tp = mesh.shape["tp"]
    if cfg.n_heads % tp or cfg.d_ff % tp:
        raise ValueError(f"tp={tp} does not divide the {cfg.n_heads} heads and d_ff "
                         f"{cfg.d_ff}")
    return mesh


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

    @staticmethod
    def bias_correction(decay: float, count: int) -> np.float32:
        """1 - decay ** count in float32, as optax computes it."""
        return np.float32(1) - np.power(np.float32(decay), np.float32(count))

    def _bias_correction(self, decay: float, count: int, dev) -> torch.Tensor:
        # a device tensor, so that the division is a true division on the
        # card too
        bc = self.bias_correction(decay, count)
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
    requires_grad on; AdamW's zero state; the optimizer; and the
    shardings. Without a mesh (or with one of one device) the shardings are
    None and it runs on the card unless `device` says otherwise. Over a
    port Mesh with axes ("dp", "tp"), every rank draws the whole model from
    the seed and keeps its shard (shard_params) on the mesh's device, so
    its leaves equal the one-device state's slices; the shardings are
    param_partition_specs(cfg). Raises ValueError for other meshes of more
    than one device (_check_mesh). A port Mesh of one rank puts the state on
    its device when `device` is None."""
    if device is None and isinstance(mesh, Mesh):
        device = mesh.device
    mesh = _check_mesh(cfg, mesh)
    tx = make_optimizer(lr)
    if mesh is None:
        dev = resolve_device(device, what="make_train_state")
        params = init_params(cfg, torch.Generator().manual_seed(seed), device=dev)
        shardings = None
    else:
        whole = init_params(cfg, torch.Generator().manual_seed(seed), device="cpu")
        params = shard_params(whole, cfg, mesh)
        shardings = param_partition_specs(cfg)
    params.requires_grad_(True)
    return params, tx.init(params), tx, shardings


def make_train_step(cfg: TransformerConfig, mesh, tx: AdamW, param_shardings=None):
    """Returns (train_step, batch_sharding). train_step(params, opt_state,
    batch) -> (params, opt_state, loss): the gradients set to None,
    loss_fn's forward and backward, and the optimizer's update, in place on
    params and opt_state (the reference donates both). batch is {"tokens":
    [B, S + 1]} as a numpy array or a tensor; the loss is a 0-d float32
    tensor on the params' device.

    Over a port Mesh with axes ("dp", "tp") (_check_mesh), params are the
    rank's shards (make_train_state) and batch is the global batch, as the
    reference's step takes it: every rank passes the same tokens and takes
    its "dp" block (rows [i B/dp, (i+1) B/dp) at axis_index("dp") = i), which
    batch_sharding = ("dp", None) names. The loss is the global mean, the
    psum over "dp" of the local means divided by dp; every gradient is
    psummed over "dp" and divided by dp, all of them and the loss in one
    flat float32 buffer, one collective a step. Without a mesh
    batch_sharding is None."""
    mesh = _check_mesh(cfg, mesh)

    def train_step(params: Transformer, opt_state: AdamWState, batch: Dict):
        tokens = torch.as_tensor(batch["tokens"], device=params.device)
        if mesh is not None:
            dp, i = mesh.shape["dp"], mesh.axis_index("dp")
            if tokens.shape[0] % dp:
                raise ValueError(f"train_step: a batch of {tokens.shape[0]} over dp={dp}")
            n = tokens.shape[0] // dp
            tokens = tokens[i * n:(i + 1) * n]
        for p in params.parameters():
            p.grad = None
        with torch.enable_grad():
            loss = loss_fn(params, {"tokens": tokens}, cfg, mesh)
            loss.backward()
        loss = loss.detach()
        if mesh is not None and mesh.shape["dp"] > 1:
            loss = _mean_over_dp(params, loss, mesh)
        tx.update(params, opt_state)
        return params, opt_state, loss

    return train_step, (None if mesh is None else ("dp", None))


def _mean_over_dp(params: Transformer, loss: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every gradient of params and the loss averaged over "dp", in place
    for the gradients: one psum of one flat float32 buffer, divided by dp
    (the leaves in named_parameters' order, the same offsets on every rank
    of a "tp" line). Returns the mean loss."""
    grads = [p.grad for p in params.parameters()]
    flat = torch.cat([g.reshape(-1).float() for g in grads] + [loss.reshape(1).float()])
    flat = mesh.psum(flat, "dp").div_(mesh.shape["dp"])
    at = 0
    for g in grads:
        g.copy_(flat[at:at + g.numel()].view_as(g))
        at += g.numel()
    return flat[at].clone()


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


def opt_state_from_numpy(tree: Dict, params: Transformer) -> AdamWState:
    """The inverse of opt_state_to_numpy: AdamW's state for `params` (on
    their device) from {"count", "mu", "nu"} as it gives them, bit for
    bit."""
    def moments(stacked: Dict) -> Dict[str, torch.Tensor]:
        out = {}
        for name, p in params.named_parameters():
            parts = name.split(".")
            a = stacked[name] if len(parts) == 1 else stacked["layers"][parts[2]][int(parts[1])]
            a = np.ascontiguousarray(a, dtype=np.float32)
            if a.shape != tuple(p.shape):
                raise ValueError(f"opt_state_from_numpy: {name} has shape {a.shape}, "
                                 f"{tuple(p.shape)} expected")
            out[name] = torch.from_numpy(a).to(p.device)
        return out

    return AdamWState(int(tree["count"]), moments(tree["mu"]), moments(tree["nu"]))


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
