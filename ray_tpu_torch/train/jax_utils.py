"""Training utilities: mesh preparation and pytree checkpointing, the port
of ray_tpu/train/jax_utils.py.

Reference analog: python/ray/train/torch/train_loop_utils.py
(prepare_model/prepare_data_loader wrap torch DDP + CUDA placement). In the
JAX package a worker owns every local device and the mesh is a
``jax.sharding.Mesh``; in the port a worker process owns one device and the
mesh is ``parallel.mesh.Mesh`` over the ranks of the default process group
that JaxBackend's rendezvous formed, so ``prepare_mesh`` puts the world size
on the first axis where the reference puts every device.

The checkpoint keeps the reference's ``pytree_leaves.npz`` exactly
(``leaf_i`` in jax's flatten order, the same dtypes). The reference pickles a
jax ``PyTreeDef`` beside it, which the port can neither write nor read, so
the structure goes to a JSON file of the port's own
(``pytree_structure.json``); a checkpoint the JAX package wrote loads only
its leaves, and ``load_pytree`` on it raises, naming the file.
"""

from __future__ import annotations

import json
import os
from typing import Any, Optional, Sequence

import numpy as np
import torch

from ray_tpu_torch.air.checkpoint import Checkpoint
from ray_tpu_torch.util.device import resolve_device


def prepare_mesh(axis_names: Sequence[str] = ("dp",),
                 axis_sizes: Optional[Sequence[int]] = None, device=None):
    """A Mesh over the ranks of the default process group, on this worker's
    device (the card unless `device` is "cpu"; raises without one).

    `axis_sizes` defaults to the world size on the first axis and 1 on the
    others. Every rank of the group calls it with the same arguments, after
    the rendezvous: an axis over part of the group makes subgroups, which
    every rank creates in the same order (``parallel.mesh.make_mesh``).
    Without a process group (one worker) it is a mesh of one rank, which
    ``make_train_state`` and ``make_train_step`` take as one device.
    """
    import torch.distributed as dist

    from ray_tpu_torch.parallel.mesh import Mesh, make_mesh

    axis_names = tuple(axis_names)
    grouped = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if grouped else 1
    if axis_sizes is None:
        axis_sizes = (world,) + (1,) * (len(axis_names) - 1)
    axis_sizes = tuple(int(s) for s in axis_sizes)
    if grouped:
        return make_mesh(axis_names, shape=axis_sizes, device=device)
    if len(axis_sizes) != len(axis_names) or int(np.prod(axis_sizes)) != 1:
        raise ValueError(f"mesh shape {axis_sizes} for axes {axis_names} without a "
                         "process group: one rank")
    dev = resolve_device(device, what="prepare_mesh")
    return Mesh(axis_names, axis_sizes, np.zeros(axis_sizes, np.int64), 0,
                {a: None for a in axis_names}, dev)


def prepare_data_shard(array, mesh, axis: str = "dp"):
    """The global batch as ``make_train_step``'s step takes it: one tensor
    on the mesh's device, not sliced. The step takes its own block along
    `axis` (``axis_index``), so the batch is sliced once, in the step; the
    reference returns a global ``jax.Array`` sharded over `axis`, which its
    jitted step reads the same way."""
    if axis not in mesh.shape:
        raise ValueError(f"mesh has no axis {axis!r} (axes {mesh.axis_names})")
    n = mesh.shape[axis]
    if array.shape[0] % n:
        raise ValueError(f"a batch of {array.shape[0]} rows over {axis}={n}")
    return torch.as_tensor(array, device=mesh.device)


# ----------------------------------------------------------- pytree ckpts

_TREE_FILE = "pytree_structure.json"
_ARRS_FILE = "pytree_leaves.npz"
_REF_TREE_FILE = "pytree_structure.pkl"  # the JAX package's pickled PyTreeDef


def _flatten(tree: Any, leaves: list):
    """jax.tree.flatten's order and structure for dicts (keys sorted),
    lists, tuples and None (no leaf); anything else is one leaf."""
    if tree is None:
        return {"t": "none"}
    if isinstance(tree, dict):
        keys = sorted(tree)
        if not all(isinstance(k, str) for k in keys):
            raise TypeError(f"save_pytree: dict keys must be strings, got {keys}")
        return {"t": "dict", "keys": keys, "c": [_flatten(tree[k], leaves) for k in keys]}
    if type(tree) in (list, tuple):
        return {"t": type(tree).__name__, "c": [_flatten(x, leaves) for x in tree]}
    leaves.append(tree)
    return {"t": "leaf"}


def _unflatten(node: dict, leaves) -> Any:
    t = node["t"]
    if t == "none":
        return None
    if t == "leaf":
        return next(leaves)
    children = [_unflatten(c, leaves) for c in node["c"]]
    if t == "dict":
        return dict(zip(node["keys"], children))
    return children if t == "list" else tuple(children)


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            raise TypeError("save_pytree: numpy has no bfloat16; cast the tensor to "
                            "float32 first (exact)")
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_pytree(tree: Any, directory: str) -> Checkpoint:
    """Write a pytree of numpy arrays, scalars or tensors (moved to the
    host) as the reference's npz of leaves + the port's JSON structure."""
    os.makedirs(directory, exist_ok=True)
    leaves: list = []
    structure = _flatten(tree, leaves)
    np.savez(
        os.path.join(directory, _ARRS_FILE),
        **{f"leaf_{i}": _host(a) for i, a in enumerate(leaves)},
    )
    with open(os.path.join(directory, _TREE_FILE), "w") as f:
        json.dump({"n_leaves": len(leaves), "tree": structure}, f)
    return Checkpoint.from_directory(directory)


def load_pytree(checkpoint: Checkpoint) -> Any:
    """The pytree save_pytree wrote, its leaves numpy arrays (as the
    reference's load gives them)."""
    with checkpoint.as_directory() as d:
        path = os.path.join(d, _TREE_FILE)
        if not os.path.exists(path):
            if os.path.exists(os.path.join(d, _REF_TREE_FILE)):
                raise ValueError(
                    f"{d} holds {_REF_TREE_FILE}, the JAX package's pickled PyTreeDef, "
                    f"which the port cannot read; its leaves are in {_ARRS_FILE} "
                    f"(leaf_i in jax's flatten order), the structure is not")
            raise FileNotFoundError(f"{d} has no {_TREE_FILE}")
        with open(path) as f:
            meta = json.load(f)
        data = np.load(os.path.join(d, _ARRS_FILE))
        leaves = [data[f"leaf_{i}"] for i in range(len(data.files))]
    if len(leaves) != meta["n_leaves"]:
        raise ValueError(f"{path} names {meta['n_leaves']} leaves, {_ARRS_FILE} holds "
                         f"{len(leaves)}")
    return _unflatten(meta["tree"], iter(leaves))
