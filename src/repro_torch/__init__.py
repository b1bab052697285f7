"""PyTorch + CUDA port of the BrSGD system (``src/repro`` is the JAX
reference it is checked against).

The port imports torch and numpy only.  Its entry points run on the
card unless the caller passes ``device="cpu"``; on the CPU every kernel
wrapper takes its plain PyTorch version, on a CUDA tensor it launches
the hand-written CUDA kernel or raises.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The torch.device an entry point runs on.  ``"cuda"`` (the
    default of every entry point) raises when no card is present — the
    port never drops to the CPU unless it is asked to.  On the card,
    TF32 is switched off for matmuls and cuDNN convolutions so float32
    stays float32 on the whole path."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={device!r} requested but torch.cuda.is_available() "
                f"is False; pass device='cpu' to run the plain versions")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return dev
