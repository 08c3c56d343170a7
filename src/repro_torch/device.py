"""Device resolution shared by the port's entry points.

Every entry point runs on the card unless the caller asks for the CPU: there
is no silent CPU path.  Under ``FakeTensorMode`` (the dry run,
``launch/dryrun.py``) a ``cuda`` device needs no card: tensors made there
are fake ones, with shapes and no data.
"""
from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available() and not fake_mode_active():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def fake_mode_active() -> bool:
    """Whether a ``FakeTensorMode`` is on (the dry run)."""
    return torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE) is not None
