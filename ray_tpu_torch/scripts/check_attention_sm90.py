"""Build report of the tensor-core K8 (both forms) and K8'
(ray_tpu_torch/models/csrc/attention_sm90.cu) on the card.

    python -m ray_tpu_torch.scripts.check_attention_sm90

Builds the source once more with -Xptxas -v into build/torch_ext/ and
prints each kernel's registers, spills and stack, and its SASS opcode
counts (HGMMA: the wgmma products; UTMALDG: the TMA tile loads; LDL / STL:
local memory) from cuobjdump -sass; one JSON line last, with the card's
name and power limit. The kernels' times are chip_smoke.py's (6a, 9a),
their correctness at every head width the `cuda` tests' (README).
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

import torch


def build_report(K, cuda_build) -> dict:
    """ptxas's registers and spills, and SASS opcode counts, by kernel."""
    out = cuda_build.BUILD_DIR / "check_attention_sm90.so"
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cmd = [cuda_build.nvcc(), *K.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(out), str(K._SRC_SM90)]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError("nvcc failed:\n" + r.stdout + r.stderr)
    report = {"nvcc_s": time.perf_counter() - t0, "kernels": {}}

    def short(mangled):
        m = re.search(r"attention_sm90_(fwd|block|bwd_dq|bwd_dkv)_kernelILi(\d+)", mangled)
        return f"{m.group(1)}<{m.group(2)}>" if m else None

    name = None
    for line in (r.stdout + r.stderr).splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = short(m.group(1))
        elif name:
            k = report["kernels"].setdefault(name, {})
            m = re.search(r"Used (\d+) registers", line)
            if m:
                k["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores", line)
            if m:
                k["stack_bytes"], k["spill_store_bytes"] = int(m.group(1)), int(m.group(2))
    cuobjdump = os.path.join(os.path.dirname(cuda_build.nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(out)], capture_output=True, text=True,
                          check=True).stdout
    name = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = short(m.group(1))
            if name:
                report["kernels"].setdefault(name, {}).update(HGMMA=0, UTMALDG=0, LDL=0, STL=0)
        elif name:
            for op in ("HGMMA", "UTMALDG", "LDL", "STL"):
                if re.search(rf"\b{op}\b", line):
                    report["kernels"][name][op] += 1
    return report


def main() -> int:
    if not torch.cuda.is_available():
        print("check_attention_sm90: needs a CUDA device", file=sys.stderr)
        return 2
    from ray_tpu_torch.models import kernels as K
    from ray_tpu_torch.scripts.profile_model import _card
    from ray_tpu_torch.util import cuda_build

    out = {"card": _card(), "build": build_report(K, cuda_build)}
    for name, k in sorted(out["build"]["kernels"].items()):
        print(f"{name}: {k}", flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
