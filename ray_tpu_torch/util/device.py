"""Device helpers shared by the port's kernel wrappers.

Entry points run on the card unless the caller asks for the CPU, and never
fall back to the CPU quietly; a wrapper finds the one device its tensors lie
on and launches on PyTorch's current stream there.
"""

from __future__ import annotations

import torch


def resolve_device(device=None, *, what: str = "this entry point",
                   cpu_hint: str = "pass device='cpu'") -> torch.device:
    """The device an entry point runs on: CUDA unless `device` says
    otherwise. Raises when CUDA is asked for (or defaulted to) and there
    is no card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"ray_tpu_torch: {what} runs on a CUDA device, but "
                f"torch.cuda.is_available() is False; {cpu_hint} to run the "
                "plain PyTorch versions on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev} for {what}")
    return dev


def device_of(*tensors) -> torch.device:
    """The one device all tensors lie on; raise on a mix."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def current_stream(dev: torch.device) -> int:
    """PyTorch's current stream on `dev`, as the integer a C entry point takes."""
    return torch.cuda.current_stream(dev).cuda_stream
