"""Backend tiers and their priority, and the device of the entry points.

Counterpart of the JAX package's ``utils/platform.py``. The "backends" are
implementation *tiers*:

  * ``ref``  — plain PyTorch golden, written from the JAX package's core ops
  * ``cuda`` — hand-written Hopper kernels (``backends/cuda``); on a CPU
    tensor each kernel wrapper runs its plain PyTorch version

``MOJO_BACKEND`` selects a tier explicitly; otherwise ``cuda`` goes first,
on a machine with a GPU and without one alike.

The entry points (the models, the session) run on the card unless the
caller names another device: :func:`resolve_device` never falls back to
the CPU. :func:`is_deterministic` reads ``MOJO_DETERMINISTIC`` (JAX :68);
``backends.enable_deterministic`` applies it.
"""

from __future__ import annotations

import os

import torch

ALL_TIERS = ("ref", "cuda")
BACKEND_PRIORITY = ("cuda", "ref")


def resolve_device(device=None) -> torch.device:
    """The device of an entry point: ``None`` means the card (``cuda``);
    anything else is taken as given. Without a GPU, ``None`` raises: a
    caller that wants the CPU says ``device="cpu"``."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the entry points run on the card by default; "
            "pass device='cpu' to run on the CPU"
        )
    return torch.device("cuda")


def is_deterministic() -> bool:
    return os.environ.get("MOJO_DETERMINISTIC", "0") == "1"
