"""Flagship model: decoder-only transformer, the port of
ray_tpu/models/transformer.py to PyTorch and hand-written Hopper kernels.

The parameters are an ``nn.Module`` (``Transformer``, an ``nn.ModuleList``
of ``Block``s) holding float32 master weights in the reference's layout:
``embed [V, D]``, ``unembed [D, V]``, ``ln_f [D]`` and, per block, ``wqkv
[D, 3D]``, ``wo [D, D]``, ``w1 [D, F]``, ``w2 [F, D]``, ``ln1 [D]``, ``ln2
[D]``. ``params_from_numpy`` / ``to_numpy`` carry the reference's pytree
(layers stacked on a leading axis) across bit for bit.

The forward follows the reference op for op, in the activation dtype
(bfloat16 by default) with float32 softmax and norms:
- ``_rmsnorm`` is K10a, ``_qkv_rope`` (the qkv split and ``_rope`` on q and
  k) K10b, and ``_attention`` the whole-sequence form of K8
  (models/kernels.py). The reference's ``_attention`` rounds the
  probabilities to bf16 before P·V; K8 keeps them in float32, as the
  reference's ``reference_attention`` and ring attention do, so the port's
  logits differ from the reference's by that rounding in bf16 (tolerance
  stated in tests/test_torch_transformer.py).
- The weight products stay ``torch.matmul``, as the reference leaves them
  to XLA; TF32 stays off (PyTorch's default). GELU is the tanh form
  (``jax.nn.gelu``'s default). The unembedding multiplies the
  dtype-rounded values and sums in float32, as
  ``preferred_element_type=float32`` does.

The forward runs without autograd in this slice (``torch.no_grad``):
training, with backward kernels, is a later slice. Sharding
(``param_partition_specs``) belongs to the multi-card work.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ray_tpu_torch.models import kernels
from ray_tpu_torch.util.device import resolve_device


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32768
    d_model: int = 512
    n_heads: int = 8
    n_layers: int = 6
    d_ff: int = 2048
    max_seq_len: int = 2048
    dtype: torch.dtype = torch.bfloat16
    rope_theta: float = 10000.0

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


_LAYER_KEYS = ("wqkv", "wo", "w1", "w2", "ln1", "ln2")


def _layer_shapes(cfg: TransformerConfig) -> Dict[str, tuple]:
    D, F_ = cfg.d_model, cfg.d_ff
    return {"wqkv": (D, 3 * D), "wo": (D, D), "w1": (D, F_), "w2": (F_, D),
            "ln1": (D,), "ln2": (D,)}


class Block(nn.Module):
    """One transformer block's float32 weights (norm scales start at 1)."""

    def __init__(self, cfg: TransformerConfig, device: torch.device):
        super().__init__()
        self.cfg = cfg
        for name, shape in _layer_shapes(cfg).items():
            init = torch.ones if name.startswith("ln") else torch.zeros
            setattr(self, name, nn.Parameter(
                init(shape, dtype=torch.float32, device=device), requires_grad=False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _layer(x, self, self.cfg)


class Transformer(nn.Module):
    """The flagship transformer's parameters and forward. Built on the card
    unless `device` says otherwise (raises without one)."""

    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        dev = resolve_device(device, what="the transformer")
        if dev.type == "cuda":
            kernels.LIBRARY.load()  # build the kernels now, not in the first call
        self.cfg = cfg
        V, D = cfg.vocab_size, cfg.d_model
        self.embed = nn.Parameter(torch.zeros((V, D), device=dev), requires_grad=False)
        self.unembed = nn.Parameter(torch.zeros((D, V), device=dev), requires_grad=False)
        self.ln_f = nn.Parameter(torch.ones((D,), device=dev), requires_grad=False)
        self.blocks = nn.ModuleList(Block(cfg, dev) for _ in range(cfg.n_layers))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return forward(self, tokens, self.cfg)


def init_params(cfg: TransformerConfig, generator: torch.Generator,
                device=None) -> Transformer:
    """Random weights as the reference draws them (normal / sqrt(fan_in),
    norm scales 1), from an explicit generator. The numbers differ from
    jax.random's for the same seed; tests carry weights across with
    params_from_numpy instead."""
    model = Transformer(cfg, device)

    def normal_(p, fan_in):
        draw = torch.randn(p.shape, generator=generator, dtype=torch.float32,
                           device=generator.device)
        p.copy_(draw / math.sqrt(fan_in))

    D, F_ = cfg.d_model, cfg.d_ff
    with torch.no_grad():
        normal_(model.embed, D)
        normal_(model.unembed, D)
        for blk in model.blocks:
            for name, fan_in in (("wqkv", D), ("wo", D), ("w1", D), ("w2", F_)):
                normal_(getattr(blk, name), fan_in)
    return model


# --------------------------------------------------- weights carried across


def numpy_params(cfg: TransformerConfig, seed: int) -> Dict:
    """The reference's pytree of float32 numpy arrays, drawn from a numpy
    seed with the reference's init distribution. The one source of weights
    that the tests (for the JAX package and the port alike) and
    chip_smoke.py share."""
    rng = np.random.default_rng(seed)
    L, D, F_, V = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab_size

    def normal(shape, fan_in):
        return rng.standard_normal(shape, dtype=np.float32) / np.float32(math.sqrt(fan_in))

    embed = normal((V, D), D)
    unembed = normal((D, V), D)
    per_layer = [{"wqkv": normal((D, 3 * D), D), "wo": normal((D, D), D),
                  "w1": normal((D, F_), D), "w2": normal((F_, D), F_)} for _ in range(L)]
    layers = {k: np.stack([p[k] for p in per_layer]) for k in ("wqkv", "wo", "w1", "w2")}
    layers["ln1"] = np.ones((L, D), np.float32)
    layers["ln2"] = np.ones((L, D), np.float32)
    return {"embed": embed, "unembed": unembed, "ln_f": np.ones((D,), np.float32),
            "layers": layers}


# the port's forward (card or CPU) against the JAX package's golden
# (tests/data/transformer_golden.npz): logits atol, loss atol, and the share
# of positions whose argmax must agree. The reference rounds the attention
# probabilities to bf16 before P·V and the port does not; at six layers that
# moves bf16 logits by ~0.05 (max |logit| ~4.9) and flips the argmax of
# ~1.5 % of positions (the CPU port against the golden).
GOLDEN_TOL = {"f32": (1e-3, 1e-4, 0.999), "bf16": (0.15, 5e-3, 0.95)}


def weights_checksum(tree: Dict) -> str:
    """sha256 of the pytree's float32 bytes, leaves in a fixed order."""
    h = hashlib.sha256()
    for key in ("embed", "unembed", "ln_f"):
        h.update(key.encode() + np.ascontiguousarray(tree[key], np.float32).tobytes())
    for key in _LAYER_KEYS:
        h.update(key.encode() + np.ascontiguousarray(tree["layers"][key], np.float32).tobytes())
    return h.hexdigest()


def params_from_numpy(tree: Dict, cfg: TransformerConfig, device=None) -> Transformer:
    """The port's module from the reference's pytree as nested numpy arrays
    (layers stacked on a leading axis). Values are copied bit for bit."""
    model = Transformer(cfg, device)
    L = cfg.n_layers

    def put(p, a, name):
        a = np.asarray(a)
        if a.shape != tuple(p.shape):
            raise ValueError(f"params_from_numpy: {name} has shape {a.shape}, "
                             f"{tuple(p.shape)} expected")
        p.copy_(torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)))

    with torch.no_grad():
        for key in ("embed", "unembed", "ln_f"):
            put(getattr(model, key), tree[key], key)
        for key in _LAYER_KEYS:
            stacked = np.asarray(tree["layers"][key])
            if stacked.shape[:1] != (L,):
                raise ValueError(f"params_from_numpy: layers.{key} has shape "
                                 f"{stacked.shape}, {L} layers expected")
            for blk, a in zip(model.blocks, stacked):
                put(getattr(blk, key), a, f"layers.{key}")
    return model


def to_numpy(model: Transformer) -> Dict:
    """The inverse of params_from_numpy: the reference's pytree of float32
    numpy arrays."""
    def arr(p):
        return p.detach().to("cpu", torch.float32).numpy().copy()

    return {
        "embed": arr(model.embed), "unembed": arr(model.unembed), "ln_f": arr(model.ln_f),
        "layers": {k: np.stack([arr(getattr(b, k)) for b in model.blocks])
                   for k in _LAYER_KEYS},
    }


# ------------------------------------------------------------------ forward


def _rmsnorm(x, scale):
    return kernels.rmsnorm(x, scale)


def _qkv_rope(qkv, cfg: TransformerConfig):
    """The split of qkv [B, S, 3D] into q, k, v [B, S, H, Dh] with the
    rotary embedding on q and k (the reference's split, reshape and _rope)."""
    return kernels.rope_split(qkv, cfg.n_heads, cfg.rope_theta)


def _attention(q, k, v, cfg: TransformerConfig):
    """Causal attention, q, k, v [B, S, H, Dh]; softmax in float32."""
    return kernels.attention(q, k, v, causal=True)


def _layer(x, blk: Block, cfg: TransformerConfig):
    """One transformer block. x: [B, S, D] in cfg.dtype."""
    B, S, D = x.shape
    h = _rmsnorm(x, blk.ln1)
    qkv = torch.matmul(h, blk.wqkv.to(cfg.dtype))
    q, k, v = _qkv_rope(qkv, cfg)
    attn = _attention(q, k, v, cfg).reshape(B, S, D)
    x = x + torch.matmul(attn, blk.wo.to(cfg.dtype))
    h = _rmsnorm(x, blk.ln2)
    ff = F.gelu(torch.matmul(h, blk.w1.to(cfg.dtype)), approximate="tanh")
    return x + torch.matmul(ff, blk.w2.to(cfg.dtype))


@torch.no_grad()
def forward(params: Transformer, tokens: torch.Tensor,
            cfg: Optional[TransformerConfig] = None) -> torch.Tensor:
    """tokens [B, S] (int) -> logits [B, S, V] float32."""
    cfg = cfg or params.cfg
    x = F.embedding(tokens, params.embed).to(cfg.dtype)
    for blk in params.blocks:
        x = _layer(x, blk, cfg)
    x = _rmsnorm(x, params.ln_f)
    return _unembed(x, params.unembed.to(cfg.dtype))


def _unembed(x, w):
    """x [B, S, D] @ w [D, V] with the dtype-rounded values multiplied and
    summed in float32 (the reference's preferred_element_type=float32). On
    the card a bf16 product goes to the tensor cores with a float32 result
    (``torch.mm(..., out_dtype=float32)``, CUDA only); elsewhere the values
    are widened first."""
    if x.device.type == "cuda" and x.dtype == torch.bfloat16:
        B, S, D = x.shape
        return torch.mm(x.reshape(B * S, D), w, out_dtype=torch.float32).reshape(B, S, -1)
    return torch.matmul(x.float(), w.float())


@torch.no_grad()
def loss_fn(params: Transformer, batch: Dict,
            cfg: Optional[TransformerConfig] = None) -> torch.Tensor:
    """Next-token cross-entropy. batch: {"tokens": [B, S]}. No gradient in
    this slice."""
    tokens = batch["tokens"]
    logits = forward(params, tokens[:, :-1], cfg)
    targets = tokens[:, 1:].long()
    logp = torch.log_softmax(logits, dim=-1)
    ll = torch.gather(logp, -1, targets[..., None])[..., 0]
    return -ll.mean()
