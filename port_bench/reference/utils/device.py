"""The device rule of the port's entry points: the card unless the caller
asks for another device, and an error, not the CPU, where there is none."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises where it names CUDA and no
    CUDA device is present, so that a scene or a camera never lands on the
    CPU unasked."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"no CUDA device for the tensors (device={str(device)!r}, "
            "torch.cuda.is_available() is false); pass device=\"cpu\" to put "
            "the scene or the camera on the CPU")
    return dev
