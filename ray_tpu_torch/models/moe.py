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

The forward runs without autograd in this slice (``torch.no_grad``):
training, with the backward kernels, is a later slice. Expert parallelism
over a mesh (``mesh``, ``moe_partition_specs``) belongs to the multi-card
work (ROADMAP queue 1, item 3).
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
# a group is held against the golden only if every token's two largest
# router probabilities differ by at least this: the card's router product
# (cuBLAS) and the reference's differ in their last bits, and a near-tie
# can flip a token's expert, which shifts every later position in that
# group and those two experts
MOE_TIE_GAP = 1e-5


def _shapes(cfg: MoEConfig) -> Dict[str, tuple]:
    E, D, F_ = cfg.n_experts, cfg.d_model, cfg.d_ff
    return {"router": (D, E), "w1": (E, D, F_), "w2": (E, F_, D)}


def _fan_in(cfg: MoEConfig) -> Dict[str, int]:
    return {"router": cfg.d_model, "w1": cfg.d_model, "w2": cfg.d_ff}


def _capacity(cfg: MoEConfig, S: int) -> int:
    return max(1, int(S * cfg.capacity_factor / cfg.n_experts))


class MoE(nn.Module):
    """The expert layer's float32 weights and forward. Built on the card
    unless `device` says otherwise (raises without one)."""

    def __init__(self, cfg: MoEConfig, device=None):
        super().__init__()
        dev = resolve_device(device, what="the MoE layer")
        if cfg.n_experts > moe_kernels.MAX_EXPERTS:
            raise ValueError(f"MoE: {cfg.n_experts} experts (at most "
                             f"{moe_kernels.MAX_EXPERTS})")
        if dev.type == "cuda":
            moe_kernels.LIBRARY.load()  # build the kernels now, not in the first call
        self.cfg = cfg
        for name, shape in _shapes(cfg).items():
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


@torch.no_grad()
def moe_ffn(params: MoE, x: torch.Tensor, cfg: Optional[MoEConfig] = None,
            mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-1 (Switch) MoE FFN. x [G, S, D] -> (y [G, S, D] in x's dtype,
    aux_loss [] float32), on the device of `params`.

    aux_loss is the Switch load-balancing loss
    (E * sum_e[frac_tokens_e * mean_prob_e]); add it to the task loss.
    """
    if mesh is not None:
        raise NotImplementedError(
            "moe_ffn: a mesh (expert parallelism, the all-to-all over 'ep') is the "
            "multi-card work (ROADMAP queue 1, item 3); pass mesh=None")
    cfg = cfg or params.cfg
    if x.dim() != 3 or x.shape[-1] != cfg.d_model:
        raise ValueError(f"moe_ffn: x {tuple(x.shape)} ([G, S, {cfg.d_model}] needed)")
    if x.device != params.device:
        raise ValueError(f"moe_ffn: x on {x.device}, params on {params.device}")
    x = x.contiguous()
    G, S, _ = x.shape
    E, C = cfg.n_experts, _capacity(cfg, S)
    logits = torch.matmul(x.float(), params.router)  # [G, S, E]
    _, gate, slot, token_of_slot, stats = moe_kernels.moe_route(logits, C)
    expert_in = moe_kernels.moe_dispatch(x, token_of_slot, cfg.dtype)  # [E, G, C, D]
    h = F.gelu(_expert_matmul(expert_in, params.w1.to(cfg.dtype)), approximate="tanh")
    out = _expert_matmul(h.to(cfg.dtype), params.w2.to(cfg.dtype))
    y = moe_kernels.moe_combine(out, slot, gate, x.dtype)

    n_tokens = G * S
    frac_tokens = stats[:, 0].sum(0) / n_tokens  # [E]
    mean_prob = stats[:, 1].sum(0) / n_tokens  # [E]
    aux = E * torch.sum(frac_tokens * mean_prob)
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
