"""Backend tiers and their priority.

Counterpart of the JAX package's ``utils/platform.py``. The "backends" are
implementation *tiers*:

  * ``ref``  — plain PyTorch golden, written from the JAX package's core ops
  * ``cuda`` — hand-written Hopper kernels (``backends/cuda``); on a CPU
    tensor each kernel wrapper runs its plain PyTorch version

``MOJO_BACKEND`` selects a tier explicitly; otherwise ``cuda`` goes first,
on a machine with a GPU and without one alike.
"""

ALL_TIERS = ("ref", "cuda")
BACKEND_PRIORITY = ("cuda", "ref")
