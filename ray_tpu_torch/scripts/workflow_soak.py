"""Workflow resume soak: kill the driver mid-workflow repeatedly; every
completed step must execute exactly once across all resumes.

Run as: python -m ray_tpu_torch.scripts.workflow_soak. A 12-step DAG's driver
is SIGKILLed ~1.1-1.9s after its runtime is up (and has run one task) and
re-run (workflow.run with the same id resumes from storage). Each step's result persists before the next
starts, so a resumed run re-executes only a step killed mid-way.
"""
import os, select, subprocess, sys, tempfile, time

# the checkout that holds this package: the driver imports it from there
REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
driver = r'''
import json, os, sys, time
import ray_tpu_torch
from ray_tpu_torch import workflow

ray_tpu_torch.init(num_cpus=4)
# one task first: the scheduler's first round on the card loads its kernels
ray_tpu_torch.get(ray_tpu_torch.remote(lambda: None).remote())
print("WF-READY", flush=True)
root = sys.argv[1]
marks = sys.argv[2]

def mark(tag):
    with open(marks, "a") as f:
        f.write(tag + "\n")

def s_fn(tag, *deps):
    time.sleep(0.25)
    mark(tag)
    return tag

s = workflow.step(s_fn)
# 12-step chain with some fan-in
a = s("a"); b = s("b", a); c = s("c", a)
d = s("d", b, c)
prev = d
for i in range(8):
    prev = s(f"e{i}", prev)
out = workflow.run(prev, "soak-wf", storage_root=root)
print("WF-DONE", out, flush=True)
'''


def main():
    root = tempfile.mkdtemp(prefix="wf_soak_")
    marks = os.path.join(root, "marks.txt")
    attempts = 0
    while attempts < 60:
        attempts += 1
        p = subprocess.Popen([sys.executable, "-c", driver, root, marks],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                             env=dict(os.environ, PYTHONPATH=REPO))
        # the kill window opens once the driver's runtime is up: importing
        # torch, opening the scheduler's device and its first round take
        # longer than the window
        head = ""
        deadline = time.time() + 120
        while "WF-READY" not in head and time.time() < deadline:
            if select.select([p.stdout], [], [], 1.0)[0]:
                chunk = os.read(p.stdout.fileno(), 4096)  # unbuffered: the rest
                if not chunk:                             # stays for communicate
                    break
                head += chunk.decode(errors="replace")
        try:
            out, _ = p.communicate(timeout=1.1 + (attempts % 4) * 0.25)
            out = head + out
            if "WF-DONE" in out:
                print("completed after", attempts, "attempts", flush=True)
                break
            print("attempt", attempts, "exited without done:", out[-200:], flush=True)
        except subprocess.TimeoutExpired:
            p.kill()
            p.communicate()
    lines = open(marks).read().split()
    from collections import Counter
    dup = {k: v for k, v in Counter(lines).items() if v > 1}
    expected = {"a", "b", "c", "d"} | {f"e{i}" for i in range(8)}
    print("steps executed:", len(lines), "distinct:", len(set(lines)))
    print("missing:", sorted(expected - set(lines)))
    print("re-executed steps (should be FEW, only kills mid-step):", dup)
    assert expected <= set(lines), "missing steps!"
    print("WF SOAK OK")


if __name__ == "__main__":
    main()
