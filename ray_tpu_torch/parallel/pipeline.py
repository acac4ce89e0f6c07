"""Pipeline parallelism over a mesh axis: the GPipe schedule, the port of
ray_tpu/parallel/pipeline.py.

Every rank of the "pp" axis runs one stage. The M microbatches go through
M + P - 1 ticks: at tick t stage 0 takes microbatch t, every stage applies
its function to what it holds, the last stage emits microbatch t - (P - 1),
and the activations move one hop down the pipe (``Mesh.ppermute``, no
wraparound: stage 0 receives zeros). Only the last stage writes the
outputs, so a ``psum`` over the axis replicates them on every rank. The
bubble is the usual (P - 1) / (M + P - 1).

The stage function must be shape-preserving ([B_m, ...] -> [B_m, ...]).
"""

from __future__ import annotations

from typing import Any, Callable

import torch


def _tree_map(fn, tree):
    """`fn` over the tensors of a tree of dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _tree_leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _tree_leaves(v)]
    return [tree]


def pipeline_apply(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor], stage_params: Any,
                   x_microbatches: torch.Tensor, mesh, axis_name: str = "pp") -> torch.Tensor:
    """Run `x_microbatches` [M, B_m, ...] through the P stages of
    `axis_name` of `mesh` (parallel.mesh.make_mesh).

    stage_params: a tree (dicts, lists, tuples) of tensors whose leaves have
    the leading dim n_stages == the axis size, as the reference takes them;
    the rank at coordinate i applies ``stage_fn(params_i, x)``.
    x_microbatches is the same on every rank. Returns the last stage's
    outputs [M, B_m, ...], the same on every rank."""
    n_stages = mesh.shape[axis_name]
    for leaf in _tree_leaves(stage_params):
        if leaf.shape[0] != n_stages:
            raise ValueError(
                f"stage param leading dim {leaf.shape[0]} != "
                f"mesh axis {axis_name}={n_stages}"
            )
    p, idx = n_stages, mesh.axis_index(axis_name)
    my_params = _tree_map(lambda leaf: leaf[idx], stage_params)
    M = x_microbatches.shape[0]
    fwd = [(i, i + 1) for i in range(p - 1)]  # no wraparound
    outputs = torch.zeros_like(x_microbatches)
    x = torch.zeros_like(x_microbatches[0])
    for t in range(M + p - 1):
        if idx == 0 and t < M:  # stage 0 injects microbatch t
            x = x_microbatches[t]
        y = stage_fn(my_params, x)
        out_t = t - (p - 1)  # the last stage emits once the pipe is full
        if idx == p - 1 and out_t >= 0:
            outputs[out_t] = y
        x = mesh.ppermute(y, axis_name, fwd)  # stage 0 receives zeros
    # only the last stage wrote; psum replicates the result everywhere
    return mesh.psum(outputs, axis_name)


def reference_pipeline(stage_fn, stage_params, x_microbatches):
    """Sequential reference for tests: apply the stages one after another."""
    n_stages = _tree_leaves(stage_params)[0].shape[0]
    out = []
    for m in range(x_microbatches.shape[0]):
        x = x_microbatches[m]
        for s in range(n_stages):
            x = stage_fn(_tree_map(lambda leaf: leaf[s], stage_params), x)
        out.append(x)
    return torch.stack(out)
