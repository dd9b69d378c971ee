"""Kernel A: RMSNorm (``csrc/rmsnorm.cu``) and its plain PyTorch version.

Replaces the JAX package's ``backends/pallas/kernels/norms.py:45``
(``rmsnorm``). ``launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from mojo_opset_tpu_torch.backends.cuda import build
from mojo_opset_tpu_torch.core.operators.normalization import rms_norm as rmsnorm_plain

launches = 0


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm over the last dim of ``x``; fp32 ``weight`` (D,).

    A CPU tensor takes the plain version; a CUDA tensor the kernel."""
    build.require_no_grad("rmsnorm", x, weight)
    if x.device.type == "cpu":
        return rmsnorm_plain(x, weight, eps)
    return _rmsnorm_kernel(x, weight, eps)


def _rmsnorm_kernel(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    global launches
    D = x.shape[-1]
    code = build.dtype_code(x)
    build.require_device(x.device, weight)
    build.require(x.is_contiguous(), "rmsnorm: x must be contiguous")
    build.require(
        weight.dtype == torch.float32 and weight.shape == (D,) and weight.is_contiguous(),
        f"rmsnorm: weight must be contiguous float32 ({D},), got {weight.dtype} {tuple(weight.shape)}",
    )
    out = torch.empty_like(x)
    vec = (D * x.element_size()) % 16 == 0 and x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    build.launch(
        "mojo_rmsnorm", x.device,
        x.data_ptr(), weight.data_ptr(), out.data_ptr(), x.numel() // max(D, 1), D, float(eps), int(vec), code,
    )
    launches += 1
    return out
