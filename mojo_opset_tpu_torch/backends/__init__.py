"""Backend tiers: importing ``backends.cuda`` registers the hand-written
Hopper kernels' tier beside the golden ``ref`` tier.

``MOJO_DETERMINISTIC=1`` (counterpart of the JAX package's
``backends/__init__.py:20-29``) applies :func:`enable_deterministic` when
this package is imported, which ``import mojo_opset_tpu_torch`` does: the
torch form of JAX's "highest" matmul precision and of run-to-run
reproducible kernels. ``utils.platform.is_deterministic()`` reads the
variable.
"""

import os

CUBLAS_DETERMINISTIC_WORKSPACES = (":4096:8", ":16:8")


def enable_deterministic() -> None:
    """Put PyTorch in a bit-reproducible configuration: deterministic
    algorithms (an op with none raises; ``torch.empty`` fills with NaN),
    a cuBLAS workspace config that allows them (read when the first cuBLAS
    handle is made, so call this before any matmul on the card), no TF32
    in matmuls or cuDNN, cuDNN's deterministic algorithms without
    benchmarking, and fp32 matmuls at "highest" precision."""
    import torch

    if os.environ.get("CUBLAS_WORKSPACE_CONFIG") not in CUBLAS_DETERMINISTIC_WORKSPACES:
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = CUBLAS_DETERMINISTIC_WORKSPACES[0]
    torch.use_deterministic_algorithms(True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.set_float32_matmul_precision("highest")


if os.environ.get("MOJO_DETERMINISTIC", "0") == "1":
    enable_deterministic()
