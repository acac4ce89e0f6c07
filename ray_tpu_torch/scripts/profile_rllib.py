"""Where an RLlib runner step and a DQN update spend their host time on the
card.

    python ray_tpu_torch/scripts/profile_rllib.py [--steps 512] [--updates 64] [--root DIR]

Run by path: it imports ray_tpu_torch from DIR (by default the checkout
that holds it), so that with DIR another checkout (such as the parent
commit unpacked beside this one) one call on the card measures two trees
in turns with the same script.

Runner step (CartPole-v1, hidden 64, one observation a step): one
EnvRunner.sample fragment of `steps` steps, each part timed by the host
clock: the policy call (policy.sample_actions) and, inside it, K11's
wrapper (rllib_kernels.sample_actions) and its C calls (the launch and the
synchronisation; a tree without them reports none), the environment's
step, and the rest of the loop (the reads of the action and the
log-probability). Then whole fragments: one runner alone, and two runners
in two threads of one process, as the Algorithm's actors run in a local
runtime: what the second adds to a step is the GIL's and the card's
sharing. DQN: `updates` updates of DQNLearner at batch 128
(tests/test_rllib.py:160's), each by the host clock (the learner reads
its stats, so each ends synchronised).

Prints one JSON line: the card's name and power limit, microseconds a
step by part, the fragments' microseconds a step, and the DQN update's
milliseconds. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import functools
import json
import subprocess
import sys
import time
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np


def _card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


class _Timers:
    """Inclusive host seconds of named callables, patched in place."""

    def __init__(self):
        self.seconds = defaultdict(float)
        self.calls = defaultdict(int)
        self._restore = []

    def wrap(self, owner, name: str, label: str) -> None:
        fn = getattr(owner, name, None)
        if fn is None:
            return

        @functools.wraps(fn)  # keeps a kernel wrapper's launch counter
        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.seconds[label] += time.perf_counter() - t0
                self.calls[label] += 1

        setattr(owner, name, timed)
        self._restore.append((owner, name, fn))

    def restore(self) -> None:
        for owner, name, fn in reversed(self._restore):
            setattr(owner, name, fn)
        self._restore.clear()


def runner_step_split(steps: int = 512) -> dict:
    """Microseconds a step of one EnvRunner.sample fragment of `steps`
    steps, by part: the policy call (policy.sample_actions) and, inside
    it, K11's wrapper and its launch and synchronisation calls; the
    environment's step; the rest of the loop (reading the action and the
    log-probability, the buffers' appends)."""
    from ray_tpu_torch.rllib import policy as pol, rllib_kernels as RK
    from ray_tpu_torch.rllib.env_runner import EnvRunner

    weights = pol.params_to_numpy(pol.init_params(np.random.default_rng(0), 4, 2, 64,
                                                  device="cpu"))
    runner = EnvRunner("CartPole-v1", seed=0, rollout_fragment_length=steps, device="cuda")
    runner.sample(weights)  # warm: the policy's copy, the buffers, the kernel
    lib = RK.LIBRARY.load()
    timers = _Timers()
    timers.wrap(pol, "sample_actions", "policy_call")
    timers.wrap(RK, "sample_actions", "kernel_wrapper")
    timers.wrap(lib, "rl_policy_sample", "launch_call")
    timers.wrap(lib, "rl_stream_sync", "sync_call")
    timers.wrap(runner.env, "step", "env_step")
    t0 = time.perf_counter()
    try:
        runner.sample(weights)
    finally:
        whole = time.perf_counter() - t0
        timers.restore()
    us = {k: v / steps * 1e6 for k, v in timers.seconds.items()}
    us["step"] = whole / steps * 1e6
    us["rest_of_loop"] = us["step"] - us.get("policy_call", 0.0) - us.get("env_step", 0.0)
    us["kernel_wrapper_own"] = us.get("kernel_wrapper", 0.0) - us.get(
        "launch_call", 0.0) - us.get("sync_call", 0.0)
    return {"us_a_step": us, "launches_a_step": timers.calls.get("launch_call", 0) / steps}


def fragments(steps: int = 512) -> dict:
    """Microseconds a step of whole EnvRunner.sample fragments: one runner
    alone, then two runners in two threads."""
    from ray_tpu_torch.rllib import policy as pol
    from ray_tpu_torch.rllib.env_runner import EnvRunner

    weights = pol.params_to_numpy(pol.init_params(np.random.default_rng(0), 4, 2, 64,
                                                  device="cpu"))
    runners = [EnvRunner("CartPole-v1", seed=s, rollout_fragment_length=steps, device="cuda")
               for s in (0, 1)]
    for r in runners:
        r.sample(weights)  # warm: the policy's copy and the kernels
    t0 = time.perf_counter()
    runners[0].sample(weights)
    alone = (time.perf_counter() - t0) / steps * 1e6
    with ThreadPoolExecutor(2) as pool:
        t0 = time.perf_counter()
        list(pool.map(lambda r: r.sample(weights), runners))
        both = (time.perf_counter() - t0) / steps * 1e6
    return {"one_runner_us_a_step": alone, "two_runner_threads_us_a_step": both}


def dqn_updates(updates: int = 64) -> dict:
    """DQNLearner.update's host ms at batch 128 (each ends in a read)."""
    from ray_tpu_torch.rllib.learner import DQNLearner

    rng = np.random.default_rng(0)
    learner = DQNLearner(4, 2, lr=1e-3, device="cuda")
    B = 128

    def batch():
        return {"obs": rng.normal(0, 0.5, (B, 4)).astype(np.float32),
                "actions": rng.integers(0, 2, B).astype(np.int32),
                "rewards": np.ones(B, np.float32),
                "next_obs": rng.normal(0, 0.5, (B, 4)).astype(np.float32),
                "dones": (rng.random(B) < 0.1).astype(np.float32)}

    batches = [batch() for _ in range(updates + 4)]
    for b in batches[:4]:
        learner.update(b)
    ms = []
    for b in batches[4:]:
        t0 = time.perf_counter()
        learner.update(b)
        ms.append((time.perf_counter() - t0) * 1e3)
    return {"update_ms_median": float(np.median(ms)), "update_ms_mean": float(np.mean(ms)),
            "updates": updates}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=512)
    ap.add_argument("--updates", type=int, default=64)
    ap.add_argument("--root", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, args.root or str(Path(__file__).resolve().parents[2]))
    import torch

    if not torch.cuda.is_available():
        print("profile_rllib: no CUDA device", file=sys.stderr)
        return 1
    import ray_tpu_torch

    out = {"card": _card_line(), "root": args.root or "this checkout",
           "package": ray_tpu_torch.__file__,
           "runner_step": runner_step_split(args.steps),
           "fragments": fragments(args.steps), "dqn": dqn_updates(args.updates)}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
