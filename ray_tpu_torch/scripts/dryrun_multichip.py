"""Every strategy across ranks at small shapes: the port's counterpart of
``__graft_entry__.dryrun_multichip``.

    python -m ray_tpu_torch.scripts.dryrun_multichip 4            # on the card
    python -m ray_tpu_torch.scripts.dryrun_multichip 4 --device cpu

Spawns `n_ranks` processes with a file rendezvous, one gloo process group
(CPU tensors, or CUDA tensors staged through the host by gloo; rank r on
card r modulo the cards there are, so several ranks may share one card).
Each rank runs the reference's checks over meshes of every rank:
  - the dp x tp train step (float32: vocab 512, d_model 128, tp * 2 heads,
    2 layers, d_ff 256, tokens [dp * 2, 33] from a seed), its loss finite
    and within 1e-5 of the one-rank step's on the same weights and tokens;
  - ring attention over "sp" against the unsharded reference attention;
  - Ulysses over "sp" against the same;
  - the pipeline over "pp" against the stages applied in sequence;
  - the expert layer over "dp" x "ep", finite, against the one-rank layer;
  - the sharded scheduler over the ranks against K1, exactly.
Every rank has a deadline and gloo a timeout: a rank that fails or hangs
makes the call raise.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import tempfile
import time
from datetime import timedelta

import numpy as np

R = 16  # resource columns of the scheduler's problem
TOL = 1e-4  # the reference's rtol and atol for sp (float32)
TRAIN_TOL = 1e-5  # the dp x tp step's loss against the one-rank step's (float32)


def _sched_problem(n_ranks: int):
    """The reference's scheduler problem: 16 nodes a rank, 4 classes, seed 0."""
    rng = np.random.default_rng(0)
    n_nodes = 16 * n_ranks
    total = np.zeros((n_nodes, R), np.float32)
    total[:, 0] = rng.integers(4, 33, n_nodes)
    alive = np.ones(n_nodes, bool)
    demands = np.zeros((4, R), np.float32)
    demands[:, 0] = rng.integers(1, 4, 4)
    counts = rng.integers(0, 50, 4).astype(np.int32)
    return total.copy(), total, alive, demands, counts


def _close(name, got, want, tol=TOL) -> float:
    err = float((got.double() - want.double()).abs().max())
    if not err <= tol + tol * float(want.double().abs().max()):
        raise AssertionError(f"dryrun_multichip: {name} max abs err {err} (tol {tol})")
    return err


def _checks(n: int, rank: int, dev) -> dict:
    """One rank's checks; every rank calls the collectives in one order."""
    import torch

    from ray_tpu_torch.models import moe as PM
    from ray_tpu_torch.models.transformer import TransformerConfig
    from ray_tpu_torch.parallel import make_mesh, make_train_state, make_train_step
    from ray_tpu_torch.parallel import pipeline_apply, ulysses_attention
    from ray_tpu_torch.parallel.pipeline import reference_pipeline
    from ray_tpu_torch.parallel.ring_attention import reference_attention, ring_attention
    from ray_tpu_torch.sched import kernel_shard as KS, kernel_torch as KT

    import torch.distributed as dist

    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    res = {}
    # dp x tp: the train step on every rank's shards, then one rank's step
    mesh_tp = make_mesh(("dp", "tp"), device=dev)
    dp, tp = mesh_tp.shape["dp"], mesh_tp.shape["tp"]
    cfg = TransformerConfig(vocab_size=512, d_model=128, n_heads=tp * 2, n_layers=2,
                            d_ff=256, max_seq_len=64, dtype=torch.float32)
    tokens = np.random.default_rng(6).integers(0, cfg.vocab_size, (dp * 2, 33)).astype(np.int32)
    params, opt_state, tx, shardings = make_train_state(cfg, mesh_tp)
    step, _ = make_train_step(cfg, mesh_tp, tx, shardings)
    loss = step(params, opt_state, {"tokens": T(tokens)})[2]
    if not math.isfinite(float(loss)):
        raise AssertionError(f"dryrun_multichip: non-finite loss {float(loss)}")
    params1, opt_state1, tx1, _ = make_train_state(cfg, device=dev)
    loss1 = make_train_step(cfg, None, tx1)[0](params1, opt_state1, {"tokens": T(tokens)})[2]
    res["train"] = abs(float(loss) - float(loss1))
    if not res["train"] <= TRAIN_TOL:
        raise AssertionError(f"dryrun_multichip: the dp x tp step's loss {float(loss)} != the "
                             f"one-rank step's {float(loss1)} (tol {TRAIN_TOL})")
    res["train_loss"] = float(loss)
    # sp: ring attention, then Ulysses (heads divisible by sp)
    mesh_sp = make_mesh(("sp",), device=dev)
    for name, shape, seed in (("ring", (2, n * 8, 2, 16), 1), ("ulysses", (2, n * 8, n, 16), 2)):
        rng = np.random.default_rng(seed)
        q, k, v = (T(rng.standard_normal(shape, dtype=np.float32)) for _ in range(3))
        Sb = shape[1] // n
        blk = slice(rank * Sb, (rank + 1) * Sb)
        fn = ring_attention if name == "ring" else ulysses_attention
        out = fn(q[:, blk].contiguous(), k[:, blk].contiguous(), v[:, blk].contiguous(),
                 mesh_sp, causal=True)
        res[name] = _close(name, out, reference_attention(q, k, v, causal=True)[:, blk])
    # pp: the stages over every rank
    mesh_pp = make_mesh(("pp",), device=dev)
    d = 16
    rng = np.random.default_rng(3)
    stage_w = T(rng.standard_normal((n, d, d), dtype=np.float32) / np.float32(math.sqrt(d)))
    x_mb = T(rng.standard_normal((2 * n, 2, d), dtype=np.float32))
    stage = lambda w, x: torch.tanh(x @ w)  # noqa: E731
    out = pipeline_apply(stage, stage_w, x_mb, mesh_pp)
    if not bool(torch.isfinite(out).all()):
        raise AssertionError("dryrun_multichip: the pipeline's output is not finite")
    res["pipeline"] = _close("pipeline", out, reference_pipeline(stage, stage_w, x_mb))
    # ep: the expert layer over dp x ep, each rank its dp block of x
    mesh_ep = make_mesh(("dp", "ep"), device=dev)
    dp, ep = mesh_ep.shape["dp"], mesh_ep.shape["ep"]
    cfg = PM.MoEConfig(d_model=16, d_ff=32, n_experts=ep * 2, capacity_factor=2.0,
                       dtype=torch.float32)
    tree = PM.numpy_moe_params(cfg, 4)
    x = np.random.default_rng(5).standard_normal((dp * 2, 8, cfg.d_model), dtype=np.float32)
    gblk = slice(mesh_ep.axis_index("dp") * 2, mesh_ep.axis_index("dp") * 2 + 2)
    y, aux = PM.moe_ffn(PM.shard_moe_params(tree, cfg, mesh_ep), T(x[gblk]), cfg,
                        mesh=mesh_ep)
    if not (bool(torch.isfinite(y).all()) and math.isfinite(float(aux))):
        raise AssertionError("dryrun_multichip: the expert layer's output is not finite")
    y1, aux1 = PM.moe_ffn(PM.moe_params_from_numpy(tree, cfg, device=dev), T(x), cfg)
    res["moe"] = _close("moe", y, y1[gblk], 2e-5)
    res["moe_aux"] = _close("moe aux", aux, aux1, 1e-6)
    # the sharded scheduler over every rank, decisions equal to K1's
    prob = _sched_problem(n)
    a_sh, _ = KS.make_sharded_scheduler(dist.group.WORLD, device=dev)(*prob)
    a_1, _ = KT.schedule_classes(*(T(p) for p in prob))
    if not torch.equal(a_sh, a_1):
        raise AssertionError("dryrun_multichip: the sharded scheduler's decisions != K1's")
    res["sched_placed"] = int(a_sh.sum())
    res["meshes"] = {"dp x tp": [mesh_tp.shape["dp"], mesh_tp.shape["tp"]], "sp": n, "pp": n,
                     "dp x ep": [dp, ep], "experts": cfg.n_experts}
    return res


def _rank_main(rank: int, n: int, device: str, tmp: str, timeout_s: float) -> None:
    import torch
    import torch.distributed as dist

    if device == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
        dev = torch.device("cuda", torch.cuda.current_device())
    else:
        dev = torch.device("cpu")
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous", rank=rank,
                            world_size=n, timeout=timedelta(seconds=timeout_s))
    try:
        res = _checks(n, rank, dev)
        with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_ranks: int, device=None, timeout_s: float = 300.0) -> dict:
    """Run every check on `n_ranks` spawned ranks (on the card unless
    `device` is "cpu"; raises without a card). Returns rank 0's results
    (each check's max abs error against its reference, the scheduler's
    placed count, the meshes). Raises if a rank fails or any rank is still
    running after `timeout_s` seconds, after killing every rank."""
    import torch.multiprocessing as mp

    from ray_tpu_torch.util.device import resolve_device

    dev = resolve_device(device, what="dryrun_multichip")
    if dev.type == "cuda":  # build the kernels once, before the ranks load them
        from ray_tpu_torch.models import kernels as MK, moe_kernels as EK
        from ray_tpu_torch.sched import _build
        from ray_tpu_torch.util import cuda_build

        cuda_build.build_all([_build.LIBRARY, MK.LIBRARY, MK.LIBRARY_SM90, EK.LIBRARY])
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(_rank_main, args=(n_ranks, dev.type, tmp, timeout_s),
                                 nprocs=n_ranks, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout_s
        try:
            while not ctx.join(timeout=0.5):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"dryrun_multichip({n_ranks}): ranks still running "
                                       f"after {timeout_s} s")
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
        with open(os.path.join(tmp, "rank0.json")) as f:
            return json.load(f)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_ranks", type=int)
    ap.add_argument("--device", default=None, help="cpu, or the card (default)")
    args = ap.parse_args(argv)
    res = dryrun_multichip(args.n_ranks, args.device)
    print(f"dryrun_multichip({args.n_ranks}): {json.dumps(res)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
