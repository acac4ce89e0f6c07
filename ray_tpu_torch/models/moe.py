"""Mixture-of-experts FFN: the port of ray_tpu/models/moe.py to PyTorch and
hand-written Hopper kernels.

Top-1 (Switch) routing with GShard-style dispatch to a fixed capacity C
a (group, expert): a token past its expert's capacity is dropped and
contributes zero, so every shape is static. Layout: x [G, S, D] (G token
groups), expert weights [E, D, F] and [E, F, D], the experts' rows
[E, G, C, D].

The parameters are an ``nn.Module`` (``MoE``) holding float32 master
weights in the reference's layout: ``router [D, E]``, ``w1 [E, D, F]``,
``w2 [E, F, D]``. ``moe_params_from_numpy`` / ``moe_to_numpy`` carry the
reference's pytree across bit for bit.

``moe_ffn`` follows the reference op for op:
- the router product ``x.float() @ router`` in float32 (TF32 stays off,
  PyTorch's default);
- K9a (``moe_kernels.moe_route``): softmax, top-1 expert, gate, position
  in expert, capacity drop, and the per-group sums of the aux loss;
- K9b (``moe_dispatch``): the kept tokens' rows into the experts' slots,
  in ``cfg.dtype``;
- the two expert products stay ``torch.bmm``, as the reference leaves them
  to XLA: on the card a bf16 product goes to the tensor cores with a
  float32 result (``out_dtype=torch.float32``, CUDA only); elsewhere the
  values are widened first (``preferred_element_type=float32``). GELU is
  the tanh form (``jax.nn.gelu``'s default), on float32, then rounded to
  ``cfg.dtype``;
- K9c (``moe_combine``): each token's expert row times its gate, in x's
  dtype.

Training: when gradients are on and x or a parameter requires one,
``moe_ffn`` runs through autograd Functions whose backwards follow the
reference's jax.grad jaxpr: K9a', K9b' and K9c' (``moe_kernels``) for the
routing, dispatch and combine, and the experts' transposes as float32
library products, each cotangent rounded once to its operand's dtype
(``_ExpertProduct``). ``loss.backward()`` then leaves jax.grad's
counterpart in the parameters' ``.grad`` (``moe_grads_to_numpy``), and
``parallel.make_optimizer()``'s AdamW steps the layer. Parameters are built
with ``requires_grad=False``; training turns it on with
``requires_grad_(True)``. Otherwise the forward runs without autograd, with
the same launches as before.

Expert parallelism (``moe_ffn(..., mesh=...)``): over a ``parallel.mesh``
with axes "dp" and "ep", each rank passes its "dp" block of x (the
reference's ``P("dp", None, None)``: the same block on every rank of an
"ep" line) and holds E / ep experts (``moe_partition_specs``,
``shard_moe_params``). It routes (K9a) and dispatches (K9b) its tokens,
sends each "ep" peer the rows of that peer's experts in one all-to-all of
[E, G_l, C, D], runs its experts' products on what it received, brings the
slabs back with a second all-to-all and combines (K9c): y is its "dp"
block. The aux loss is the global one, its sums over every group taken by
a ``psum`` over "dp". Every rank of an "ep" line routes the same tokens, so
each expert's products run once for each of the ep copies of the "dp"
block that reach it, as the reference's layout implies.

Its backward runs through the same autograd Functions (K9a'-c', the
experts' transposes), each all-to-all's backward the inverse all-to-all
and the aux sums' psum's backward a psum of its cotangent over "dp"; the
experts' weight gradients stay float32 partial sums until their psum
(``_ExpertProductPartial``). The
rule that makes the gradients the reference's: every rank scales its
local loss by 1 / (dp·ep) (``mesh_loss_scale``), since the global loss is
the sum of every rank's local loss over dp·ep (each "dp" block is on ep
ranks and the aux loss on all); then ``reduce_moe_grads`` psums each
gradient over exactly the axes its leaf is replicated on: the router over
"dp" and "ep", the experts over "dp", x's block over "ep". Summing the ep
copies of an expert's rows counts each token once, with that scale.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ray_tpu_torch.models import moe_kernels
from ray_tpu_torch.util.device import resolve_device


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int = 256
    d_ff: int = 512
    n_experts: int = 8
    capacity_factor: float = 1.25
    dtype: torch.dtype = torch.bfloat16


_KEYS = ("router", "w1", "w2")

# the port's moe_ffn (card or CPU) against the JAX package's (the golden
# tests/data/moe_golden.npz: MoEConfig() on x [2, 2048, 256] float32 with a
# skewed router, ~27 % of tokens dropped; and the small configs of
# tests/test_torch_moe.py): (y atol, aux atol) by expert dtype. float32:
# the same products summed in another order (~2.4e-6 at full width, |y| up
# to ~2.4, the CPU port against the golden). bfloat16: h is rounded to bf16
# after a float32 sum taken in another order, so one rounding of h can
# differ by 2**-8 relative and the second product carries that on (~7e-4
# at full width on the CPU).
MOE_GOLDEN_TOL = {"f32": (2e-5, 1e-6), "bf16": (5e-3, 1e-6)}
# the port's one training step of the layer (card or CPU) against the JAX
# package's golden (tests/data/moe_grad_golden.npz; moe_grad_golden_errors):
# loss and aux atol; per-leaf gradient L2 norms rtol; sampled gradients
# (router, w1, w2, x), atol as a share of their leaf's rms; sampled
# parameters after one AdamW step atol, and the least share of a leaf's
# within 1e-6 (an entry whose gradient is near 0 can take the other sign,
# which moves it by 2 lr). Measured on the CPU: f32 loss 0, aux 0, norms
# 2.5e-8, gradients 4.8e-6 of the rms, params 6.3e-8, all within 1e-6;
# bf16 loss 7.5e-9, aux 0, norms 8.5e-7, gradients 5.3e-3 of the rms (a
# product's cotangent rounded to bf16 on the other side), params 1.0e-6,
# 99.98 % within 1e-6.
MOE_GRAD_GOLDEN_TOL = {
    "f32": {"loss": 1e-6, "aux": 1e-6, "grad_norm": 1e-5, "grad": 1e-4, "param": 1e-5,
            "param_share": 0.999},
    "bf16": {"loss": 1e-5, "aux": 1e-6, "grad_norm": 1e-4, "grad": 0.05, "param": 7e-4,
             "param_share": 0.98},
}
MOE_GRAD_LEAVES = ("router", "w1", "w2", "x")
# a group is held against the golden only if every token's two largest
# router probabilities differ by at least this: the card's router product
# (cuBLAS) and the reference's differ in their last bits, and a near-tie
# can flip a token's expert, which shifts every later position in that
# group and those two experts
MOE_TIE_GAP = 1e-5


def _shapes(cfg: MoEConfig, experts: Optional[int] = None) -> Dict[str, tuple]:
    """The weights' shapes, w1 and w2 for `experts` of them (all when None)."""
    E, D, F_ = cfg.n_experts, cfg.d_model, cfg.d_ff
    El = experts or E
    return {"router": (D, E), "w1": (El, D, F_), "w2": (El, F_, D)}


def _fan_in(cfg: MoEConfig) -> Dict[str, int]:
    return {"router": cfg.d_model, "w1": cfg.d_model, "w2": cfg.d_ff}


def _capacity(cfg: MoEConfig, S: int) -> int:
    return max(1, int(S * cfg.capacity_factor / cfg.n_experts))


class MoE(nn.Module):
    """The expert layer's float32 weights and forward. Built on the card
    unless `device` says otherwise (raises without one). `experts`: the
    experts it holds, cfg.n_experts unless it is one rank's share
    (shard_moe_params)."""

    def __init__(self, cfg: MoEConfig, device=None, experts: Optional[int] = None):
        super().__init__()
        dev = resolve_device(device, what="the MoE layer")
        if cfg.n_experts > moe_kernels.MAX_EXPERTS:
            raise ValueError(f"MoE: {cfg.n_experts} experts (at most "
                             f"{moe_kernels.MAX_EXPERTS})")
        if dev.type == "cuda":
            moe_kernels.LIBRARY.load()  # build the kernels now, not in the first call
        self.cfg = cfg
        for name, shape in _shapes(cfg, experts).items():
            setattr(self, name, nn.Parameter(
                torch.zeros(shape, dtype=torch.float32, device=dev), requires_grad=False))

    @property
    def device(self) -> torch.device:
        return self.router.device

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return moe_ffn(self, x, self.cfg)


def init_moe_params(cfg: MoEConfig, generator: torch.Generator, device=None) -> MoE:
    """Random weights as the reference draws them (normal / sqrt(fan_in)),
    from an explicit generator. The numbers differ from jax.random's for
    the same seed; tests carry weights across with moe_params_from_numpy."""
    model = MoE(cfg, device)
    with torch.no_grad():
        for name, fan_in in _fan_in(cfg).items():
            p = getattr(model, name)
            draw = torch.randn(p.shape, generator=generator, dtype=torch.float32,
                               device=generator.device)
            p.copy_(draw / math.sqrt(fan_in))
    return model


# --------------------------------------------------- weights carried across


def numpy_moe_params(cfg: MoEConfig, seed: int) -> Dict:
    """The reference's pytree of float32 numpy arrays, drawn from a numpy
    seed with the reference's init distribution. The one source of weights
    that the tests (for the JAX package and the port alike) and
    chip_smoke.py share."""
    rng = np.random.default_rng(seed)
    shapes, fans = _shapes(cfg), _fan_in(cfg)
    return {k: rng.standard_normal(shapes[k], dtype=np.float32)
            / np.float32(math.sqrt(fans[k])) for k in _KEYS}


def numpy_moe_inputs(tree: Dict, shape: tuple, seed: int, skew: float = 1.0) -> np.ndarray:
    """Tokens x [G, S, D] float32 from a numpy seed: standard normal plus
    `skew` times the unit vector of the router's column 0, which sends
    extra tokens to expert 0 as a trained, imbalanced router does, so the
    capacity drops some (MoEConfig() at skew 1.0: ~27 % of tokens). The
    inputs that the tests and chip_smoke.py share."""
    x = np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)
    col = np.asarray(tree["router"], np.float32)[:, 0]
    return (x + np.float32(skew) * (col / np.linalg.norm(col))).astype(np.float32)


def moe_weights_checksum(tree: Dict) -> str:
    """sha256 of the pytree's float32 bytes, leaves in a fixed order."""
    h = hashlib.sha256()
    for key in _KEYS:
        h.update(key.encode() + np.ascontiguousarray(tree[key], np.float32).tobytes())
    return h.hexdigest()


def moe_params_from_numpy(tree: Dict, cfg: MoEConfig, device=None) -> MoE:
    """The port's module from the reference's pytree of numpy arrays.
    Values are copied bit for bit."""
    model = MoE(cfg, device)
    with torch.no_grad():
        for key in _KEYS:
            p, a = getattr(model, key), np.asarray(tree[key])
            if a.shape != tuple(p.shape):
                raise ValueError(f"moe_params_from_numpy: {key} has shape {a.shape}, "
                                 f"{tuple(p.shape)} expected")
            p.copy_(torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)))
    return model


def moe_to_numpy(model: MoE) -> Dict:
    """The inverse of moe_params_from_numpy: the reference's pytree of
    float32 numpy arrays."""
    return {k: getattr(model, k).detach().to("cpu", torch.float32).numpy().copy()
            for k in _KEYS}


def moe_grads_to_numpy(model: MoE) -> Dict:
    """The parameters' gradients (``.grad``, from a backward through
    moe_ffn) as the reference's pytree, the counterpart of jax.grad's."""
    grads = {k: getattr(model, k).grad for k in _KEYS}
    missing = [k for k, g in grads.items() if g is None]
    if missing:
        raise ValueError(f"moe_grads_to_numpy: no gradient for {missing}; run a backward "
                         "through moe_ffn with requires_grad on first")
    return {k: g.detach().to("cpu", torch.float32).numpy().copy() for k, g in grads.items()}


def moe_partition_specs() -> Dict[str, tuple]:
    """The reference's moe_partition_specs as tuples of axis names, one
    entry a dimension (None: not split): the router whole on every rank,
    the experts of w1 and w2 split over "ep"."""
    return {
        "router": (None, None),
        "w1": ("ep", None, None),
        "w2": ("ep", None, None),
    }


def shard_moe_params(params, cfg: MoEConfig, mesh, axis: str = "ep") -> MoE:
    """This rank's share of the layer by moe_partition_specs: the whole
    router and the E / ep experts at its coordinate on `axis` of `mesh`
    (parallel.mesh.make_mesh), from a MoE or the reference's numpy tree of
    every expert, on the mesh's device. Values are copied bit for bit."""
    tree = moe_to_numpy(params) if isinstance(params, MoE) else params
    ep, idx = mesh.shape[axis], mesh.axis_index(axis)
    if cfg.n_experts % ep:
        raise ValueError(f"shard_moe_params: {cfg.n_experts} experts over {axis}={ep}")
    n = cfg.n_experts // ep
    local = {}
    for key, spec in moe_partition_specs().items():
        a = np.asarray(tree[key], np.float32)
        local[key] = a[idx * n:(idx + 1) * n] if spec[0] == axis else a
    model = MoE(cfg, mesh.device, experts=n)
    with torch.no_grad():
        for key in _KEYS:
            getattr(model, key).copy_(torch.from_numpy(np.ascontiguousarray(local[key])))
    return model


# ------------------------------------------------------------------ forward


def _expert_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a [E, G, C, K] @ w [E, K, N], both in the expert dtype, with the
    products summed in float32 (the reference's
    preferred_element_type=float32) -> [E, G, C, N] float32."""
    E, G, C, K = a.shape
    a = a.reshape(E, G * C, K)
    if a.device.type == "cuda" and a.dtype == torch.bfloat16:
        out = torch.bmm(a, w, out_dtype=torch.float32)
    else:
        out = torch.bmm(a.float(), w.float())
    return out.reshape(E, G, C, -1)


class _ExpertProduct(torch.autograd.Function):
    """_expert_matmul, with the reference's transposes as its backward: the
    cotangent g [E, G, C, N] is float32, and da = g @ w^T and dw = a^T @ g
    are float32 products of the dtype-rounded values (TF32 off), each
    rounded once to its operand's dtype (for w the dtype-cast weight; the
    cast's own backward widens it to the float32 master's gradient)."""

    @staticmethod
    def forward(ctx, a, w):
        ctx.save_for_backward(a, w)
        return _expert_matmul(a, w)

    @staticmethod
    def backward(ctx, g):
        a, w = ctx.saved_tensors
        da, dw = _expert_product_grads(ctx, a, w, g)
        return da, None if dw is None else dw.to(w.dtype)


def _expert_product_grads(ctx, a, w, g):
    """da rounded to a's dtype, and dw in float32 (not yet rounded)."""
    E, G, C, K = a.shape
    g = g.reshape(E, G * C, -1).float()
    da = dw = None
    if ctx.needs_input_grad[0]:
        da = torch.bmm(g, w.float().transpose(1, 2)).to(a.dtype).reshape(a.shape)
    if ctx.needs_input_grad[1]:
        dw = torch.bmm(a.reshape(E, G * C, K).float().transpose(1, 2), g)
    return da, dw


class _ExpertProductPartial(torch.autograd.Function):
    """The mesh form's expert product, from the float32 master weight w
    (cast to `dtype` inside): the same forward and da as _ExpertProduct;
    dw stays float32, this rank's partial sum, which reduce_moe_grads sums
    over "dp" and then rounds to `dtype` once, as the one-device product's
    dw is rounded once over every group."""

    @staticmethod
    def forward(ctx, a, w_master, dtype):
        w = w_master.to(dtype)
        ctx.save_for_backward(a, w)
        return _expert_matmul(a, w)

    @staticmethod
    def backward(ctx, g):
        a, w = ctx.saved_tensors
        return (*_expert_product_grads(ctx, a, w, g), None)


def moe_ffn(params: MoE, x: torch.Tensor, cfg: Optional[MoEConfig] = None,
            mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-1 (Switch) MoE FFN. x [G, S, D] -> (y [G, S, D] in x's dtype,
    aux_loss [] float32), on the device of `params`.

    aux_loss is the Switch load-balancing loss
    (E * sum_e[frac_tokens_e * mean_prob_e]); add it to the task loss.
    Differentiable in x and the parameters when gradients are on and one of
    them requires a gradient; otherwise computed without autograd.

    With `mesh` (a parallel.mesh.Mesh with axes "dp" and "ep"): x is this
    rank's "dp" block [G/dp, S, D], `params` its experts
    (shard_moe_params), y its "dp" block and aux the global loss;
    differentiable (the module docstring's rule: mesh_loss_scale, then
    reduce_moe_grads after the backward).
    """
    cfg = cfg or params.cfg
    if x.dim() != 3 or x.shape[-1] != cfg.d_model:
        raise ValueError(f"moe_ffn: x {tuple(x.shape)} ([G, S, {cfg.d_model}] needed)")
    if x.device != params.device:
        raise ValueError(f"moe_ffn: x on {x.device}, params on {params.device}")
    x = x.contiguous()
    grad = torch.is_grad_enabled() and (x.requires_grad or params.router.requires_grad
                                        or params.w1.requires_grad or params.w2.requires_grad)
    if mesh is not None:
        with torch.set_grad_enabled(grad):
            return _moe_ffn_mesh(params, x, cfg, mesh)
    if grad:
        return _moe_ffn_autograd(params, x, cfg)
    with torch.no_grad():
        return _moe_ffn_forward(params, x, cfg)


def _moe_ffn_forward(params: MoE, x: torch.Tensor, cfg: MoEConfig):
    G, S, _ = x.shape
    C = _capacity(cfg, S)
    logits = torch.matmul(x.float(), params.router)  # [G, S, E]
    _, gate, slot, token_of_slot, stats = moe_kernels.moe_route(logits, C)
    expert_in = moe_kernels.moe_dispatch(x, token_of_slot, cfg.dtype)  # [E, G, C, D]
    h = F.gelu(_expert_matmul(expert_in, params.w1.to(cfg.dtype)), approximate="tanh")
    out = _expert_matmul(h.to(cfg.dtype), params.w2.to(cfg.dtype))
    y = moe_kernels.moe_combine(out, slot, gate, x.dtype)
    return y, moe_kernels.aux_loss(stats, G * S)[1]


def _moe_ffn_mesh(params: MoE, x: torch.Tensor, cfg: MoEConfig, mesh):
    """moe_ffn over mesh axes "dp" and "ep", through the autograd Functions
    (a graph only where gradients are on): routing, dispatch and combine on
    this rank's tokens; the [E, G_l, C, D] rows to their experts' ranks and
    back by two all-to-alls over "ep"; the aux loss's sums over every group
    by a psum over "dp" (in _Route)."""
    from ray_tpu_torch.parallel.mesh import Mesh, all_to_all_with_grad

    if not isinstance(mesh, Mesh) or set(mesh.axis_names) != {"dp", "ep"}:
        raise ValueError(f"moe_ffn: mesh {mesh!r} is not a ray_tpu_torch.parallel.mesh.Mesh "
                         "with axes 'dp' and 'ep'")
    ep = mesh.shape["ep"]
    E = cfg.n_experts
    if E % ep or params.w1.shape[0] != E // ep:
        raise ValueError(f"moe_ffn: {params.w1.shape[0]} experts on this rank, "
                         f"{E} over ep={ep} (shard_moe_params) needed")
    G, S, _ = x.shape
    C = _capacity(cfg, S)
    logits = torch.matmul(x.float(), params.router)  # [G, S, E]
    gate, aux, slot, token_of_slot = moe_kernels._Route.apply(logits, C, mesh)
    expert_in = moe_kernels._Dispatch.apply(x, token_of_slot, slot, cfg.dtype)  # [E, G, C, D]
    # my experts' rows from every rank of the ep line: [E/ep, ep * G, C, D]
    rows = all_to_all_with_grad(expert_in, mesh, "ep", 0, 1)
    h = F.gelu(_ExpertProductPartial.apply(rows, params.w1, cfg.dtype), approximate="tanh")
    out = _ExpertProductPartial.apply(h.to(cfg.dtype), params.w2, cfg.dtype)
    # every expert's output for my groups: [E, G, C, D]
    out = all_to_all_with_grad(out, mesh, "ep", 1, 0)
    y = moe_kernels._Combine.apply(out, gate, slot, token_of_slot, x.dtype)
    return y, aux


def mesh_loss_scale(mesh) -> float:
    """The factor 1 / (dp·ep) by which each rank scales its local loss
    before the backward through moe_ffn(mesh=...) (the module docstring's
    rule)."""
    return 1.0 / (mesh.shape["dp"] * mesh.shape["ep"])


def reduce_moe_grads(params: MoE, mesh, x: Optional[torch.Tensor] = None) -> None:
    """After a backward of the local loss scaled by mesh_loss_scale: each
    gradient psummed, in place, over exactly the axes its leaf is
    replicated on: the router's, w1's and w2's over "dp" (one flat float32
    buffer; the experts' float32 partial sums rounded to the expert dtype
    after it, as the one-device layer rounds their sum once), then the
    router's and x's (when given, x requiring a gradient) over "ep" (a
    second). The results are the same bits on every rank that holds the
    leaf."""
    grads = [params.router.grad, params.w1.grad, params.w2.grad]
    if any(g is None for g in grads):
        raise ValueError("reduce_moe_grads: run a backward through moe_ffn(mesh=...) first")
    flat = mesh.psum(torch.cat([g.reshape(-1) for g in grads]), "dp")
    at = 0
    for i, g in enumerate(grads):
        part = flat[at:at + g.numel()].view_as(g)
        g.copy_(part if i == 0 else part.to(params.cfg.dtype))
        at += g.numel()
    over_ep = [params.router.grad] + ([] if x is None else [x.grad])
    flat = mesh.psum(torch.cat([g.reshape(-1).float() for g in over_ep]), "ep")
    at = 0
    for g in over_ep:
        g.copy_(flat[at:at + g.numel()].view_as(g))
        at += g.numel()


def _moe_ffn_autograd(params: MoE, x: torch.Tensor, cfg: MoEConfig):
    """moe_ffn with a graph: the same kernels through their autograd
    Functions. x is read twice, by the router (x.float()) and by K9b, so
    autograd adds dx's two parts in x's dtype, each rounded first, as the
    reference's jaxpr does."""
    G, S, _ = x.shape
    C = _capacity(cfg, S)
    logits = torch.matmul(x.float(), params.router)  # [G, S, E]
    gate, aux, slot, token_of_slot = moe_kernels._Route.apply(logits, C)
    expert_in = moe_kernels._Dispatch.apply(x, token_of_slot, slot, cfg.dtype)
    h = F.gelu(_ExpertProduct.apply(expert_in, params.w1.to(cfg.dtype)), approximate="tanh")
    out = _ExpertProduct.apply(h.to(cfg.dtype), params.w2.to(cfg.dtype))
    y = moe_kernels._Combine.apply(out, gate, slot, token_of_slot, x.dtype)
    return y, aux


@torch.no_grad()
def reference_moe_ffn(params: MoE, x: torch.Tensor, cfg: Optional[MoEConfig] = None):
    """Dense reference without capacity drops, for tests (the reference's
    reference_moe_ffn, in plain PyTorch): every token goes through every
    expert, then its argmax expert's row is kept, times its gate."""
    cfg = cfg or params.cfg
    probs = moe_kernels.softmax_plain(torch.matmul(x.float(), params.router))
    expert = probs.argmax(-1)
    gate = probs.gather(-1, expert[..., None])[..., 0]
    w1, w2 = (w.to(cfg.dtype).float() for w in (params.w1, params.w2))
    h = F.gelu(torch.einsum("gsd,edf->gsef", x.to(cfg.dtype).float(), w1), approximate="tanh")
    out = torch.einsum("gsef,efd->gsed", h.to(cfg.dtype).float(), w2)
    G, S, _, D = out.shape
    sel = out.gather(2, expert[..., None, None].expand(G, S, 1, D))[:, :, 0, :]
    return (sel * gate[..., None]).to(x.dtype)


# ------------------------------------------------------- the training golden


def moe_grad_golden_errors(golden, dt_name: str, device=None) -> Dict[str, float]:
    """The port's one training step of the layer against the JAX package's
    golden (tests/data/moe_grad_golden.npz, loaded as a mapping): at the
    golden's weights and tokens (float32 x, requiring a gradient) in the
    expert dtype `dt_name` ("f32" or "bf16"), the reference test's loss
    (y ** 2).mean() + 0.01 * aux, its backward and one AdamW step (lr 3e-4,
    weight decay 0.01). Returns the largest error of each kind that
    MOE_GRAD_GOLDEN_TOL bounds (param_share: the smallest share, over the
    parameters, of sampled entries within 1e-6)."""
    from ray_tpu_torch.parallel.tpu_train import make_optimizer

    cfg = MoEConfig(dtype={"f32": torch.float32, "bf16": torch.bfloat16}[dt_name])
    tree = numpy_moe_params(cfg, int(golden["weight_seed"]))
    x = numpy_moe_inputs(tree, tuple(int(n) for n in golden["shape"]), int(golden["x_seed"]),
                         float(golden["skew"]))
    model = moe_params_from_numpy(tree, cfg, device=device).requires_grad_(True)
    xt = torch.from_numpy(x).to(model.device).requires_grad_(True)
    tx = make_optimizer(float(golden["lr"]), float(golden["weight_decay"]))
    state = tx.init(model)
    y, aux = moe_ffn(model, xt)
    loss = (y.float() ** 2).mean() + 0.01 * aux
    loss.backward()
    grads = dict(moe_grads_to_numpy(model), x=xt.grad.float().cpu().numpy())
    tx.update(model, state)
    params1 = moe_to_numpy(model)
    err = {"loss": abs(float(loss.detach()) - float(golden[f"loss_{dt_name}"])),
           "aux": abs(float(aux.detach()) - float(golden[f"aux_{dt_name}"])), "grad_norm": 0.0,
           "grad": 0.0, "param": 0.0, "param_share": 1.0}
    for i, name in enumerate(MOE_GRAD_LEAVES):
        g = grads[name]
        want_norm = float(golden[f"grad_norm_{dt_name}"][i])
        err["grad_norm"] = max(err["grad_norm"],
                               abs(np.linalg.norm(g.astype(np.float64)) / want_norm - 1))
        pos = golden[f"pos_{name}"]
        rms = want_norm / np.sqrt(g.size)
        err["grad"] = max(err["grad"], float(
            np.abs(g.reshape(-1)[pos] - golden[f"grad_{dt_name}_{name}"]).max()) / rms)
        if name in params1:
            d = np.abs(params1[name].reshape(-1)[pos] - golden[f"param1_{dt_name}_{name}"])
            err["param"] = max(err["param"], float(d.max()))
            err["param_share"] = min(err["param_share"], float((d <= 1e-6).mean()))
    return {k: float(e) for k, e in err.items()}


def moe_grad_golden_violations(err: Dict[str, float], dt_name: str) -> Dict[str, float]:
    """The entries of moe_grad_golden_errors' result outside
    MOE_GRAD_GOLDEN_TOL."""
    tol = MOE_GRAD_GOLDEN_TOL[dt_name]
    return {k: e for k, e in err.items()
            if (e < tol[k] if k == "param_share" else not e <= tol[k])}
