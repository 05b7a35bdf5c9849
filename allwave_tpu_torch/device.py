"""Which torch device the port runs on.

The choice is explicit. An aligner takes a `device`; when it is None the
reference package's own knob decides: ALLWAVE_PLATFORM=cpu runs the
plain PyTorch versions of the kernels on the CPU, and any other value,
or none, means the CUDA kernels on the current GPU. Asking for CUDA
without a usable GPU raises: the port never carries on silently on the
CPU.
"""

from __future__ import annotations

import os

import torch


def resolve_device(device=None) -> torch.device:
    if device is None:
        plat = os.environ.get("ALLWAVE_PLATFORM", "")
        device = "cpu" if plat == "cpu" else "cuda"
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "allwave_tpu_torch: a CUDA device was requested but "
                "torch.cuda.is_available() is False (set ALLWAVE_PLATFORM=cpu "
                "to run the plain PyTorch versions on the CPU)"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev
