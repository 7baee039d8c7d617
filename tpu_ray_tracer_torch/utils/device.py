"""The device rule of the port's entry points: the card unless the caller
asks for another device, and an error, not the CPU, where there is none;
and the card's name and power limit, which every measurement is written
beside."""

from __future__ import annotations

import subprocess

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


def smi_line(index: int = 0) -> str:
    """The name and power limit of card ``index`` as nvidia-smi gives them
    (``--query-gpu=name,power.limit``, one CSV line)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[index]
