"""Device meshes over ``torch.distributed`` ranks: the port of
ray_tpu/parallel/mesh.py.

The reference lays devices out as a ``jax.sharding.Mesh`` and lets XLA
insert the collectives over its axes. Here a mesh lays the ranks of a
process group out row-major, as ``np.array(devices).reshape(shape)`` lays
out the reference's devices, and holds one subgroup for each axis; the
collectives over an axis are methods of the mesh, named as ``jax.lax``
names them (``psum``, ``all_gather``, ``all_to_all``, ``ppermute``), and are
the only place where ``parallel/`` and ``models/`` call ``torch.distributed``.

One code path serves the gloo and NCCL backends, on CPU or CUDA tensors.
gloo takes CUDA tensors in ``all_reduce``, ``all_gather`` and
``all_to_all_single`` (even and uneven splits), staging them through the
host; it has no CUDA ``send``/``recv`` (a send reads the device pointer as
host memory and aborts the process) and no list ``all_to_all`` at all (a
probe with 4 gloo ranks on one NVIDIA H100, PERF.md). So ``ppermute`` is
one ``all_to_all_single`` with uneven splits: a rank sends its whole tensor
to its one target and receives from its one source, every other split
empty; and ``all_to_all`` stacks its chunks into one ``all_to_all_single``.

Axis conventions (the reference's):
  "dp"  data parallel      "tp"  tensor parallel   "sp"  sequence parallel
  "pp"  pipeline stages    "ep"  expert parallel
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ray_tpu_torch.util.device import resolve_device


def mesh_shape_for(n: int, axes: Sequence[str]) -> Tuple[int, ...]:
    """Factor n devices into a mesh shape, biggest factors to the *last*
    (innermost/fastest-ICI) axes: tp wants the tightest links."""
    shape = [1] * len(axes)
    remaining = n
    for i in range(len(axes) - 1, 0, -1):
        f = _largest_factor_leq(remaining, int(np.sqrt(remaining)) + 1)
        shape[i] = f
        remaining //= f
    shape[0] = remaining
    return tuple(shape)


def _largest_factor_leq(n: int, cap: int) -> int:
    best = 1
    for f in range(1, cap + 1):
        if n % f == 0:
            best = f
    return best


class Mesh:
    """The ranks of a process group laid out row-major over named axes,
    seen from one rank: ``shape[axis]``, this rank's coordinate on each
    axis (``axis_index``), one subgroup an axis (the ranks that differ from
    this one only on that axis, in axis order) and the device the rank's
    tensors lie on. Built by ``make_mesh``."""

    def __init__(self, axis_names, shape, ranks, rank, groups, device):
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, shape))
        self.devices = ranks  # the group's global ranks, laid out [shape]
        coords = np.argwhere(ranks == rank)[0]
        self._coords = dict(zip(self.axis_names, (int(c) for c in coords)))
        self._groups = groups  # axis -> ProcessGroup, None for an axis of size 1
        self.device = device

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def axis_index(self, axis: str) -> int:
        """This rank's coordinate on `axis` (``jax.lax.axis_index``)."""
        return self._coords[axis]

    def _group(self, axis: str):
        if axis not in self.shape:
            raise ValueError(f"mesh has no axis {axis!r} (axes {self.axis_names})")
        return self._groups[axis]

    # ---------------------------------------------------------- collectives

    def all_gather(self, x: torch.Tensor, axis: str, *, dim: int = 0) -> torch.Tensor:
        """Every rank's `x` along `axis`, concatenated along `dim` in axis
        order (``jax.lax.all_gather(..., tiled=True)``)."""
        import torch.distributed as dist

        g = self._group(axis)
        if g is None:
            return x.clone()
        parts = [torch.empty_like(x) for _ in range(self.shape[axis])]
        dist.all_gather(parts, x.contiguous(), group=g)
        return torch.cat(parts, dim=dim)

    def psum(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """The sum of every rank's `x` along `axis` (``jax.lax.psum``), the
        same bits on every rank; `x` is not modified."""
        import torch.distributed as dist

        out = x.clone().contiguous()
        g = self._group(axis)
        if g is not None:
            dist.all_reduce(out, group=g)
        return out

    def all_to_all(self, x: torch.Tensor, axis: str, split_axis: int,
                   concat_axis: int) -> torch.Tensor:
        """``jax.lax.all_to_all(x, axis, split_axis, concat_axis, tiled=True)``:
        `x` cut into shape[axis] equal chunks along `split_axis`, chunk j
        sent to the rank at coordinate j; the chunks received concatenated
        along `concat_axis` in the senders' axis order."""
        import torch.distributed as dist

        p = self.shape[axis]
        g = self._group(axis)
        if x.shape[split_axis] % p:
            raise ValueError(f"all_to_all: dim {split_axis} of {tuple(x.shape)} does not "
                             f"divide over axis {axis!r} of size {p}")
        if g is None:
            return x.clone()
        inp = torch.stack(x.chunk(p, dim=split_axis)).contiguous()
        out = torch.empty_like(inp)
        dist.all_to_all_single(out, inp, group=g)
        return torch.cat(out.unbind(0), dim=concat_axis)

    def ppermute(self, x: torch.Tensor, axis: str,
                 perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
        """``jax.lax.ppermute``: for each (src, dst) in `perm` (axis
        coordinates), the rank at src sends `x` to the rank at dst; a rank
        that no pair sends to gets zeros. One all_to_all_single with uneven
        splits: this rank's whole `x` to its target, its source's whole `x`
        back, every other split empty."""
        import torch.distributed as dist

        me = self.axis_index(axis)
        dst = [d for s, d in perm if s == me]
        src = [s for s, d in perm if d == me]
        if len(dst) > 1 or len(src) > 1:
            raise ValueError(f"ppermute: {perm} sends to or from coordinate {me} twice")
        g = self._group(axis)
        if g is None:
            return x.clone() if src else torch.zeros_like(x)
        n = x.numel()
        in_splits = [0] * self.shape[axis]
        out_splits = [0] * self.shape[axis]
        if dst:
            in_splits[dst[0]] = n
        if src:
            out_splits[src[0]] = n
        inp = x.contiguous().reshape(-1) if dst else x.new_empty(0)
        out = x.new_empty(n if src else 0)
        dist.all_to_all_single(out, inp, output_split_sizes=out_splits,
                               input_split_sizes=in_splits, group=g)
        return out.reshape(x.shape) if src else torch.zeros_like(x)


def make_mesh(axes: Sequence[str] = ("dp", "tp"), shape: Optional[Sequence[int]] = None,
              group=None, device=None) -> Mesh:
    """A mesh over the ranks of `group` (the default process group when
    None), laid out row-major in `shape` (``mesh_shape_for`` when None).

    A collective call: every rank of the group calls it with the same
    arguments. An axis whose ranks are the whole group uses `group` itself;
    every other axis of more than one rank gets subgroups from
    ``dist.new_group``, which every rank of the default group must create in
    the same order, so a mesh with such an axis is made over the default
    group only. Its tensors lie on the card unless `device` is "cpu"
    (raises without a card)."""
    import torch.distributed as dist

    dev = resolve_device(device, what="the mesh")
    if group is None:
        group = dist.group.WORLD
    ranks = list(dist.get_process_group_ranks(group))
    n = len(ranks)
    if shape is None:
        shape = mesh_shape_for(n, axes)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} for axes {tuple(axes)}")
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} != {n} devices")
    layout = np.array(ranks).reshape(shape)
    me = dist.get_rank()
    groups = {}
    for i, axis in enumerate(axes):
        if shape[i] == 1:
            groups[axis] = None
        elif shape[i] == n:
            groups[axis] = group
        else:
            if group is not dist.group.WORLD:
                raise ValueError("make_mesh: an axis over part of a subgroup needs "
                                 "subgroups of the default group; pass group=None")
            lines = np.moveaxis(layout, i, -1).reshape(-1, shape[i])
            for line in lines:  # every rank makes every subgroup, in this order
                g = dist.new_group([int(r) for r in line])
                if me in line:
                    groups[axis] = g
    return Mesh(axes, shape, layout, me, groups, dev)
