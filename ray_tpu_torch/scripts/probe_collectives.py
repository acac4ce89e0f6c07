"""Which torch.distributed collectives take CUDA tensors with several
processes on one card, and what each costs there.

    python -m ray_tpu_torch.scripts.probe_collectives [--ranks 4]

Each collective runs in a process group of its own (a refused CUDA pointer
can abort a process, so no collective shares a group with another): gloo
over `--ranks` processes on card 0, every rank timing 50 calls after one
warm call by the host clock around a synchronised loop. Then whether NCCL
takes two ranks on the one card. Prints one line a collective, as
"<name>: <json by rank>", and the card's name and power limit first.
The times are those of processes sharing one card, their tensors staged
through the host by gloo: never times across cards.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import tempfile
import time
from datetime import timedelta

REPS = 50
DEADLINE_S = 60
BLOCK = (8, 512, 8, 64)  # one K block of the ring over sp = 4 at the flagship's widths

COLLECTIVES = ("all_reduce", "all_reduce_int64_read", "all_gather", "all_gather_int64_read",
               "all_gather_into_tensor", "all_gather_block_bf16", "all_to_all_single",
               "all_to_all_single_uneven", "ring_hop_block_bf16", "all_to_all_list",
               "broadcast", "subgroup_all_reduce", "send_recv")


def _collective(name, rank, world, dev):
    """fn() running collective `name` once, and check(result) -> bool."""
    import torch
    import torch.distributed as dist

    x = torch.full((4,), float(rank + 1), device=dev)
    one = torch.ones(1, dtype=torch.int64, device=dev)
    blk = torch.full(BLOCK, float(rank), dtype=torch.bfloat16, device=dev)
    nxt, prv = (rank + 1) % world, (rank - 1) % world

    def hop(t):
        ins, outs = [0] * world, [0] * world
        ins[nxt] = outs[prv] = t.numel()
        out = torch.empty_like(t)
        dist.all_to_all_single(out.view(-1), t.reshape(-1), output_split_sizes=outs,
                               input_split_sizes=ins)
        return out

    def gather(t):
        parts = [torch.empty_like(t) for _ in range(world)]
        dist.all_gather(parts, t)
        return parts

    def reduce(t, group=None):
        t = t.clone()
        dist.all_reduce(t, group=group)
        return t

    def send_recv():
        t = x.clone()
        if rank == 0:
            dist.send(t, dst=1)
        elif rank == 1:
            dist.recv(t, src=0)
        return t

    def a2a_list():
        outs = [torch.empty(16, device=dev) for _ in range(world)]
        dist.all_to_all(outs, [torch.full((16,), 10.0 * rank + j, device=dev)
                               for j in range(world)])
        return outs

    def a2a_even():
        t = torch.full((world * 1024,), float(rank), device=dev)
        out = torch.empty_like(t)
        dist.all_to_all_single(out, t)
        return out

    def into_tensor():
        out = torch.empty(world * 4, device=dev)
        dist.all_gather_into_tensor(out, x)
        return out

    def broadcast():
        t = x.clone()
        dist.broadcast(t, src=0)
        return t

    sub = None
    if name == "subgroup_all_reduce":  # every rank makes every group, in one order
        pairs = [dist.new_group([r, r + 1]) for r in range(0, world - 1, 2)]
        sub = pairs[min(rank // 2, len(pairs) - 1)]
    total = world * (world + 1) / 2
    table = {
        "all_reduce": (lambda: reduce(x), lambda y: float(y[0]) == total),
        "all_reduce_int64_read": (lambda: int(reduce(one)), lambda y: y == world),
        "all_gather": (lambda: gather(x), lambda p: [float(t[0]) for t in p]
                       == [r + 1.0 for r in range(world)]),
        "all_gather_int64_read": (lambda: int(torch.stack(gather(one)).sum()),
                                  lambda y: y == world),
        "all_gather_into_tensor": (into_tensor, lambda t: float(t[-1]) == world),
        "all_gather_block_bf16": (lambda: gather(blk), lambda p: float(p[-1][0, 0, 0, 0])
                                  == world - 1),
        "all_to_all_single": (a2a_even, lambda t: float(t[-1]) == world - 1),
        "all_to_all_single_uneven": (lambda: hop(x), lambda t: float(t[0]) == prv + 1),
        "ring_hop_block_bf16": (lambda: hop(blk), lambda t: float(t[0, 0, 0, 0]) == prv),
        "all_to_all_list": (a2a_list, lambda o: [float(t[0]) for t in o]
                            == [10.0 * j + rank for j in range(world)]),
        "broadcast": (broadcast, lambda t: float(t[0]) == 1.0),
        "subgroup_all_reduce": (lambda: reduce(x, sub), lambda y: bool(torch.isfinite(y).all())),
        "send_recv": (send_recv, lambda t: rank != 1 or float(t[0]) == 1.0),
    }
    return table[name]


def _gloo_rank(rank, world, tmp, name):
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous", rank=rank,
                            world_size=world, timeout=timedelta(seconds=DEADLINE_S))
    fn, check = _collective(name, rank, world, dev)
    try:
        ok = bool(check(fn()))
        torch.cuda.synchronize()
        res = {"ok": ok}
        if ok:
            t = time.perf_counter()
            for _ in range(REPS):
                fn()
            torch.cuda.synchronize()
            res["ms"] = (time.perf_counter() - t) / REPS * 1e3
    except RuntimeError as e:  # a collective gloo refuses with an error
        res = {"ok": False, "error": f"{type(e).__name__}: {str(e)[:300]}"}
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()


def _nccl_rank(rank, world, tmp, name):
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    try:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/rendezvous", rank=rank,
                                world_size=world, timeout=timedelta(seconds=30))
        t = torch.ones(4, device="cuda")
        dist.all_reduce(t)
        torch.cuda.synchronize()
        res = {"ok": True, "value": float(t[0])}
    except RuntimeError as e:  # DistBackendError is a RuntimeError
        res = {"ok": False, "error": f"{type(e).__name__}: {str(e)[:400]}"}
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


def _run(target, world, name) -> dict:
    """Spawn `world` ranks of target; every rank's result (None for a rank
    that died or outlived the deadline, which is then killed)."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(target, args=(world, tmp, name), nprocs=world, join=False,
                                 start_method="spawn")
        deadline = time.monotonic() + DEADLINE_S
        died = None
        try:
            while time.monotonic() < deadline:
                if ctx.join(timeout=0.5):
                    break
        except mp.ProcessExitedException as e:  # a rank aborted: the probe's finding
            died = str(e)
        except mp.ProcessRaisedException as e:
            died = str(e).strip().splitlines()[-1]
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
        res = {}
        for r in range(world):
            path = os.path.join(tmp, f"rank{r}.json")
            res[r] = json.load(open(path)) if os.path.exists(path) else None
        if died:
            res["died"] = died
        elif any(v is None for v in res.values()):
            res["died"] = f"deadline {DEADLINE_S} s"
        return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=4)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("probe_collectives: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    for name in COLLECTIVES:
        print(f"gloo {args.ranks} ranks {name}: {json.dumps(_run(_gloo_rank, args.ranks, name))}",
              flush=True)
    print(f"nccl 2 ranks on one card: {json.dumps(_run(_nccl_rank, 2, 'all_reduce'))}",
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
