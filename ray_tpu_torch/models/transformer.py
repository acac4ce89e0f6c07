"""Flagship model: decoder-only transformer, the port of
ray_tpu/models/transformer.py to PyTorch and hand-written Hopper kernels.

The parameters are an ``nn.Module`` (``Transformer``, an ``nn.ModuleList``
of ``Block``s) holding float32 master weights in the reference's layout:
``embed [V, D]``, ``unembed [D, V]``, ``ln_f [D]`` and, per block, ``wqkv
[D, 3D]``, ``wo [D, D]``, ``w1 [D, F]``, ``w2 [F, D]``, ``ln1 [D]``, ``ln2
[D]``. ``params_from_numpy`` / ``to_numpy`` carry the reference's pytree
(layers stacked on a leading axis) across bit for bit; ``grads_to_numpy``
gives the parameters' ``.grad`` in the same pytree.

The forward follows the reference op for op, in the activation dtype
(bfloat16 by default) with float32 softmax and norms:
- ``_rmsnorm`` is K10a, ``_qkv_rope`` (the qkv split and ``_rope`` on q and
  k) K10b, and ``_attention`` the whole-sequence form of K8 with the
  probabilities rounded to the dtype before P·V, as the reference's
  ``_attention`` rounds them (models/kernels.py). Each is an autograd
  Function whose backward is a hand-written kernel too (K10a', K10b', K8').
- The embedding casts the table to the dtype and then gathers, so its
  gradient accumulates in the dtype, as the reference's does.
- The weight products stay ``torch.matmul``, as the reference leaves them
  to XLA; TF32 stays off (PyTorch's default). GELU is the tanh form
  (``jax.nn.gelu``'s default). The unembedding multiplies the
  dtype-rounded values and sums in float32, as
  ``preferred_element_type=float32`` does; its backward is the reference's
  transposes (``_Unembed``).

With autograd enabled each block runs under
``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` on the scan
body): the backward recomputes a block's forward instead of keeping its
activations. ``loss_fn`` is differentiable; training lives in
``ray_tpu_torch.parallel.tpu_train``.

Tensor parallelism (``mesh=``, a ``parallel.mesh.Mesh`` with axis "tp"):
the Megatron layout of ``param_partition_specs``. Each rank holds a
``Transformer`` built with ``tp`` whose leaves are its shards
(``shard_params``; ``gather_params`` is the inverse): ``wqkv`` and ``w1``
column-parallel, ``wo`` and ``w2`` row-parallel, ``embed`` split by columns,
``unembed`` by rows, the norm scales whole. ``wqkv``'s block is the rank's
H/tp heads' q, k and v columns, so K10b and K8 run unchanged on its heads
and ``wo``'s row block lines up with them; it is the one leaf whose block
differs from what the reference's ``NamedSharding`` gives the rank (that
is columns [t·3D/tp, (t+1)·3D/tp), all of q and half of k at tp = 2, which
XLA reshards). The collectives are ``parallel.mesh``'s conjugate pair: a
block's input goes through ``copy_to`` (its backward psums over "tp"), and
``wo``'s and ``w2``'s partial products through one ``reduce_from`` each. The
partial products are float32 (the dtype-rounded values multiplied and
summed in float32, ``torch.mm(..., out_dtype=float32)`` on the card), summed
in float32 by the psum and rounded to the dtype once after it, as the
one-device product rounds once; the sum's order is the only difference.
The embedding is looked up on the rank's D/tp columns and all-gathered;
the unembedding all-gathers ``unembed``'s [D/tp, V] rows (in the dtype) and
multiplies on every rank, its backward keeping the rank's slice of the
weight's gradient: a gather of V·D/tp values a step, where a psum of the
partial float32 logits would move [B, S, V]. Every rank of a "tp" line then
holds the same residual stream, norms, logits and loss, bit for bit, and
the norm scales' gradients too. The recompute repeats the forward's
collectives in the backward, in one order on every rank.
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
from torch.utils.checkpoint import checkpoint

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


def _layer_shapes(cfg: TransformerConfig, tp: int = 1) -> Dict[str, tuple]:
    """A block's leaves' shapes; with tp, one rank's shards."""
    D, F_ = cfg.d_model, cfg.d_ff
    return {"wqkv": (D, 3 * D // tp), "wo": (D // tp, D), "w1": (D, F_ // tp),
            "w2": (F_ // tp, D), "ln1": (D,), "ln2": (D,)}


class Block(nn.Module):
    """One transformer block's float32 weights (norm scales start at 1);
    with tp, one rank's shards."""

    def __init__(self, cfg: TransformerConfig, device: torch.device, tp: int = 1):
        super().__init__()
        self.cfg = cfg
        for name, shape in _layer_shapes(cfg, tp).items():
            init = torch.ones if name.startswith("ln") else torch.zeros
            setattr(self, name, nn.Parameter(
                init(shape, dtype=torch.float32, device=device), requires_grad=False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _layer(x, self, self.cfg)


class Transformer(nn.Module):
    """The flagship transformer's parameters and forward. Built on the card
    unless `device` says otherwise (raises without one). `tp`: the size of
    the "tp" axis whose rank's shards it holds (shard_params), 1 for the
    whole model."""

    def __init__(self, cfg: TransformerConfig, device=None, tp: int = 1):
        super().__init__()
        dev = resolve_device(device, what="the transformer")
        _check_tp(cfg, tp)
        if dev.type == "cuda":
            kernels.LIBRARY.load()  # build the kernels now, not in the first call
        self.cfg, self.tp = cfg, tp
        V, D = cfg.vocab_size, cfg.d_model
        self.embed = nn.Parameter(torch.zeros((V, D // tp), device=dev), requires_grad=False)
        self.unembed = nn.Parameter(torch.zeros((D // tp, V), device=dev), requires_grad=False)
        self.ln_f = nn.Parameter(torch.ones((D,), device=dev), requires_grad=False)
        self.blocks = nn.ModuleList(Block(cfg, dev, tp) for _ in range(cfg.n_layers))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return forward(self, tokens, self.cfg)


def _check_tp(cfg: TransformerConfig, tp: int) -> None:
    if tp < 1 or cfg.n_heads % tp or cfg.d_ff % tp:
        raise ValueError(f"tp={tp} does not divide the {cfg.n_heads} heads and d_ff "
                         f"{cfg.d_ff}")


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
# of positions whose argmax must agree. With the attention probabilities
# rounded to bf16 as the reference rounds them, the bf16 forward on the CPU
# is within 0.0507 of the golden's logits (max |logit| ~4.9), the loss
# within 2.4e-4, and 98.3 % of argmaxes agree: what remains is the bf16
# products, GELU and residual adds rounding at other places in XLA and in
# PyTorch, compounded over six layers (the rounded probabilities alone
# agree with the reference's bit for bit on 99.96 % of outputs). On the
# H100: 0.0461, 6.3e-5 and 98.14 %. The bounds keep a margin of ~1.5x on
# the logits, 4x on the loss and 1.1 points on the argmax over the worse
# of the two. (They were 0.15, 5e-3 and 0.95 while the port kept the
# probabilities in float32.)
GOLDEN_TOL = {"f32": (1e-3, 1e-4, 0.999), "bf16": (0.08, 1e-3, 0.97)}


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


def _tree(model: Transformer, leaf) -> Dict:
    """The reference's pytree of float32 numpy arrays, leaf(p) of each
    parameter p."""
    def arr(p):
        t = leaf(p)
        if t is None:
            raise ValueError("no gradient: run loss_fn(...).backward() first")
        return t.detach().to("cpu", torch.float32).numpy().copy()

    return {
        "embed": arr(model.embed), "unembed": arr(model.unembed), "ln_f": arr(model.ln_f),
        "layers": {k: np.stack([arr(getattr(b, k)) for b in model.blocks])
                   for k in _LAYER_KEYS},
    }


def to_numpy(model: Transformer) -> Dict:
    """The inverse of params_from_numpy: the reference's pytree of float32
    numpy arrays."""
    return _tree(model, lambda p: p)


def grads_to_numpy(model: Transformer) -> Dict:
    """The parameters' gradients (``.grad``, from a backward of loss_fn) as
    the reference's pytree, the counterpart of jax.grad(loss_fn)'s."""
    return _tree(model, lambda p: p.grad)


# ------------------------------------------------------------ tensor parallel


def param_partition_specs(cfg: TransformerConfig) -> Dict:
    """The reference's Megatron layout over mesh axis "tp" as tuples of
    axis names, one entry a dimension of the reference's leaf (layers
    stacked first; None: not split)."""
    return {
        "embed": (None, "tp"),
        "unembed": ("tp", None),
        "ln_f": (None,),
        "layers": {
            "wqkv": (None, None, "tp"),  # column parallel
            "wo": (None, "tp", None),    # row parallel
            "w1": (None, None, "tp"),
            "w2": (None, "tp", None),
            "ln1": (None, None),
            "ln2": (None, None),
        },
    }


def _qkv_columns(D: int, tp: int, t: int) -> np.ndarray:
    """The columns of wqkv [D, 3D] that tp rank t holds: its H/tp heads'
    q, then k, then v columns."""
    own = np.arange(t * D // tp, (t + 1) * D // tp)
    return np.concatenate([own, D + own, 2 * D + own])


def _shard(a: np.ndarray, name: str, spec: tuple, D: int, tp: int, t: int) -> np.ndarray:
    """Rank t's block of the reference's leaf `a` under `spec`."""
    if "tp" not in spec:
        return a
    if name == "wqkv":
        return a[..., _qkv_columns(D, tp, t)]
    dim = spec.index("tp")
    n = a.shape[dim] // tp
    return np.take(a, np.arange(t * n, (t + 1) * n), axis=dim)


def shard_params(params, cfg: TransformerConfig, mesh) -> Transformer:
    """This rank's shard of every leaf by param_partition_specs, from a
    Transformer or the reference's numpy tree of the whole model, on the
    mesh's device, copied bit for bit: a Transformer built with tp =
    mesh.shape["tp"]. wqkv's block is the rank's heads' q, k and v
    columns, not the reference's NamedSharding block (module docstring)."""
    tree = to_numpy(params) if isinstance(params, Transformer) else params
    tp, t = mesh.shape["tp"], mesh.axis_index("tp")
    specs, D = param_partition_specs(cfg), cfg.d_model
    local = {k: _shard(np.asarray(tree[k], np.float32), k, specs[k], D, tp, t)
             for k in ("embed", "unembed", "ln_f")}
    local["layers"] = {k: _shard(np.asarray(tree["layers"][k], np.float32), k,
                                 specs["layers"][k], D, tp, t) for k in _LAYER_KEYS}
    model = Transformer(cfg, mesh.device, tp=tp)
    with torch.no_grad():
        for key in ("embed", "unembed", "ln_f"):
            getattr(model, key).copy_(torch.from_numpy(np.ascontiguousarray(local[key])))
        for key in _LAYER_KEYS:
            for blk, a in zip(model.blocks, local["layers"][key]):
                getattr(blk, key).copy_(torch.from_numpy(np.ascontiguousarray(a)))
    return model


def gather_params(model: Transformer, mesh) -> Dict:
    """The inverse of shard_params: the reference's numpy tree of the whole
    model, on every rank. A collective over "tp": every rank's sharded
    leaves in one flat all-gather."""
    cfg, tp = model.cfg, mesh.shape["tp"]
    if model.tp != tp:
        raise ValueError(f"gather_params: shards of tp={model.tp} on a mesh of tp={tp}")
    mine = to_numpy(model)
    specs, D = param_partition_specs(cfg), cfg.d_model
    split = [("embed", mine["embed"], specs["embed"]),
             ("unembed", mine["unembed"], specs["unembed"])]
    split += [(k, mine["layers"][k], specs["layers"][k]) for k in _LAYER_KEYS
              if "tp" in specs["layers"][k]]
    flat = torch.from_numpy(np.concatenate([a.reshape(-1) for _, a, _ in split]))
    every = mesh.all_gather(flat.to(mesh.device), "tp").reshape(tp, -1).cpu().numpy()
    whole = {"ln_f": mine["ln_f"], "layers": {k: mine["layers"][k] for k in ("ln1", "ln2")}}
    at = 0
    for name, a, spec in split:
        parts = [every[t, at:at + a.size].reshape(a.shape) for t in range(tp)]
        at += a.size
        if name == "wqkv":
            full = np.empty(a.shape[:-1] + (3 * D,), np.float32)
            for t, part in enumerate(parts):
                full[..., _qkv_columns(D, tp, t)] = part
        else:
            full = np.concatenate(parts, axis=spec.index("tp"))
        if name in ("embed", "unembed"):
            whole[name] = full
        else:
            whole["layers"][name] = full
    return whole


# ------------------------------------------------------------------ forward


def _rmsnorm(x, scale):
    return kernels.rmsnorm(x, scale)


def _qkv_rope(qkv, cfg: TransformerConfig):
    """The split of qkv [B, S, 3D] into q, k, v [B, S, H, Dh] with the
    rotary embedding on q and k (the reference's split, reshape and _rope)."""
    return kernels.rope_split(qkv, cfg.n_heads, cfg.rope_theta)


def _attention(q, k, v, cfg: TransformerConfig):
    """Causal attention, q, k, v [B, S, H, Dh]; softmax in float32, the
    probabilities rounded to the dtype before P·V, as the reference's."""
    return kernels.attention(q, k, v, causal=True, round_probs=True)


def _layer(x, blk: Block, cfg: TransformerConfig, mesh=None):
    """One transformer block. x: [B, S, D] in cfg.dtype."""
    if mesh is not None:
        return _layer_tp(x, blk, cfg, mesh)
    B, S, D = x.shape
    h = _rmsnorm(x, blk.ln1)
    qkv = torch.matmul(h, blk.wqkv.to(cfg.dtype))
    q, k, v = _qkv_rope(qkv, cfg)
    attn = _attention(q, k, v, cfg).reshape(B, S, D)
    x = x + torch.matmul(attn, blk.wo.to(cfg.dtype))
    h = _rmsnorm(x, blk.ln2)
    ff = F.gelu(torch.matmul(h, blk.w1.to(cfg.dtype)), approximate="tanh")
    return x + torch.matmul(ff, blk.w2.to(cfg.dtype))


class _PartialProduct(torch.autograd.Function):
    """a [B, S, K] @ w [K, N], both in the dtype, as a float32 partial sum
    of a row-parallel product: the dtype-rounded values multiplied and
    summed in float32 (_unembed_product). Its backward is the one-device
    product's: the cotangent (the dtype's values, widened by the cast after
    the psum) back in the dtype, da = g @ w^T and dw = a^T @ g as dtype
    products."""

    @staticmethod
    def forward(ctx, a, w):
        ctx.save_for_backward(a, w)
        return _unembed_product(a, w)

    @staticmethod
    def backward(ctx, g):
        a, w = ctx.saved_tensors
        B, S, K = a.shape
        g2 = g.reshape(B * S, -1).to(a.dtype)
        da = dw = None
        if ctx.needs_input_grad[0]:
            da = torch.matmul(g2, w.t()).reshape(B, S, K)
        if ctx.needs_input_grad[1]:
            dw = torch.matmul(a.reshape(B * S, K).t(), g2)
        return da, dw


def _layer_tp(x, blk: Block, cfg: TransformerConfig, mesh):
    """One block on a rank's shards: x [B, S, D] whole (the same on every
    rank of the "tp" line), the rank's H/tp heads, and one psum over "tp"
    after each row-parallel product."""
    from ray_tpu_torch.parallel.mesh import copy_to, reduce_from

    B, S, D = x.shape
    tp = mesh.shape["tp"]
    h = copy_to(_rmsnorm(x, blk.ln1), mesh, "tp")
    qkv = torch.matmul(h, blk.wqkv.to(cfg.dtype))  # [B, S, 3D/tp]: the rank's heads
    q, k, v = kernels.rope_split(qkv, cfg.n_heads // tp, cfg.rope_theta)
    attn = _attention(q, k, v, cfg).reshape(B, S, D // tp)
    part = _PartialProduct.apply(attn, blk.wo.to(cfg.dtype))
    x = x + reduce_from(part, mesh, "tp").to(cfg.dtype)
    h = copy_to(_rmsnorm(x, blk.ln2), mesh, "tp")
    ff = F.gelu(torch.matmul(h, blk.w1.to(cfg.dtype)), approximate="tanh")
    part = _PartialProduct.apply(ff, blk.w2.to(cfg.dtype))
    return x + reduce_from(part, mesh, "tp").to(cfg.dtype)


def _check_mesh_model(params: "Transformer", mesh) -> None:
    if "tp" not in mesh.shape or params.tp != mesh.shape["tp"]:
        raise ValueError(f"forward: shards of tp={params.tp} on a mesh of "
                         f"{dict(mesh.shape)} (shard_params over the mesh's \"tp\" needed)")


def forward(params: Transformer, tokens: torch.Tensor,
            cfg: Optional[TransformerConfig] = None, mesh=None) -> torch.Tensor:
    """tokens [B, S] (int) -> logits [B, S, V] float32. With autograd
    enabled each block is recomputed in the backward (checkpointed), as
    the reference's jax.checkpoint does; ln_f and the unembedding are not.
    With `mesh`, params are this rank's shards (shard_params) and every
    rank of the "tp" line returns the same logits (module docstring)."""
    cfg = cfg or params.cfg
    if mesh is None:
        x = params.embed.to(cfg.dtype)[tokens]
        unembed = params.unembed.to(cfg.dtype)
    else:
        from ray_tpu_torch.parallel.mesh import gather_from

        _check_mesh_model(params, mesh)
        x = gather_from(params.embed.to(cfg.dtype)[tokens], mesh, "tp", dim=-1)
        unembed = gather_from(params.unembed.to(cfg.dtype), mesh, "tp", dim=0)
    remat = torch.is_grad_enabled()
    for blk in params.blocks:
        if remat:
            x = checkpoint(_layer, x, blk, cfg, mesh, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            x = _layer(x, blk, cfg, mesh)
    x = _rmsnorm(x, params.ln_f)
    return _Unembed.apply(x, unembed)


def _unembed_product(x, w):
    """x [B, S, D] @ w [D, V] with the dtype-rounded values multiplied and
    summed in float32 (the reference's preferred_element_type=float32). On
    the card a bf16 product goes to the tensor cores with a float32 result
    (``torch.mm(..., out_dtype=float32)``, CUDA only); elsewhere the values
    are widened first."""
    if x.device.type == "cuda" and x.dtype == torch.bfloat16:
        B, S, D = x.shape
        return torch.mm(x.reshape(B * S, D), w, out_dtype=torch.float32).reshape(B, S, -1)
    return torch.matmul(x.float(), w.float())


class _Unembed(torch.autograd.Function):
    """The unembedding, with the reference's transposes as its backward:
    dx = (g @ w_f32^T) in float32, rounded to x's dtype; dw = (x_f32^T @ g)
    in float32, rounded to w's dtype (the dtype-cast weight; the cast's own
    backward widens it to the float32 master's gradient). Both are float32
    library products (TF32 off)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _unembed_product(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        B, S, D = x.shape
        g2 = g.reshape(B * S, -1).float()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = torch.matmul(g2, w.float().t()).to(x.dtype).reshape(B, S, D)
        if ctx.needs_input_grad[1]:
            dw = torch.matmul(x.reshape(B * S, D).float().t(), g2).to(w.dtype)
        return dx, dw


def loss_fn(params: Transformer, batch: Dict,
            cfg: Optional[TransformerConfig] = None, mesh=None) -> torch.Tensor:
    """Next-token cross-entropy. batch: {"tokens": [B, S]}. Differentiable:
    ``loss_fn(...).backward()`` leaves jax.grad(loss_fn)'s counterpart in
    the parameters' ``.grad`` (for those with requires_grad). With `mesh`,
    the loss of these tokens on this rank's shards (forward), and the
    gradients of its shards."""
    tokens = batch["tokens"]
    logits = forward(params, tokens[:, :-1], cfg, mesh)
    targets = tokens[:, 1:].long()
    logp = torch.log_softmax(logits, dim=-1)
    ll = torch.gather(logp, -1, targets[..., None])[..., 0]
    return -ll.mean()
