"""Kernel E: RMSNorm + per-token int8 quant (``csrc/rmsnorm_quant.cu``) and
its plain PyTorch version.

Replaces the JAX package's ``backends/pallas/kernels/norms.py:131``
(``rmsnorm_quant``). ``launches`` counts kernel launches. ``layout``
picks the register kernel (kernel A's row layouts, ``norms.row_layout``)
from the width, the dtype and the pointers alone; other widths take the
generic kernel.
"""

from __future__ import annotations

from typing import Optional

import torch

from mojo_opset_tpu_torch.backends.cuda import build
from mojo_opset_tpu_torch.backends.cuda.kernels.norms import row_layout
from mojo_opset_tpu_torch.core.operators.normalization import rms_norm_quant as rmsnorm_quant_plain

launches = 0

MAX_DIM = 8192  # the generic kernel: 256 threads x 32 elements held per thread


def layout(x: torch.Tensor, weight: torch.Tensor, smooth_scale: Optional[torch.Tensor] = None,
           q_min: float = -128.0, q_max: float = 127.0):
    """(threads a row, 16-byte vectors a thread) of the register kernel for
    ``x``'s rows, or None (the generic kernel): ``norms.row_layout`` of the
    width and dtype, when x, the weight and the smooth scale start on
    16-byte boundaries and the limits are integers within int8's range (the
    register kernel rounds and clamps in an integer's float form)."""
    if any(t is not None and t.data_ptr() % 16 for t in (x, weight, smooth_scale)):
        return None
    if not all(float(v).is_integer() and -128 <= v <= 127 for v in (q_min, q_max)):
        return None
    return row_layout(x.shape[-1], x.dtype)


def rmsnorm_quant(
    x: torch.Tensor,
    weight: torch.Tensor,
    eps: float,
    smooth_scale: Optional[torch.Tensor] = None,
    q_min: float = -128.0,
    q_max: float = 127.0,
):
    """RMSNorm over the last dim of ``x`` (fp32 ``weight`` (D,), optional
    fp32 ``smooth_scale`` (D,)), then per-row int8 quant. Returns ``(int8 q
    of x's shape, fp32 scale (..., 1))``.

    A CPU tensor takes the plain version; a CUDA tensor the kernel."""
    build.require_no_grad("rmsnorm_quant", x, weight, smooth_scale)
    if x.device.type == "cpu":
        return rmsnorm_quant_plain(x, weight, eps, smooth_scale, q_min, q_max)
    return _rmsnorm_quant_kernel(x, weight, eps, smooth_scale, q_min, q_max)


def _rmsnorm_quant_kernel(x, weight, eps, smooth_scale, q_min, q_max):
    global launches
    D = x.shape[-1]
    code = build.dtype_code(x)
    build.require(0 < D <= MAX_DIM, f"rmsnorm_quant takes 0 < D <= {MAX_DIM}, got {D}")
    build.require(x.is_contiguous(), "rmsnorm_quant: x must be contiguous")
    for name, t in (("weight", weight), ("smooth_scale", smooth_scale)):
        if t is not None:
            build.require_device(x.device, t)
            build.require(
                t.dtype == torch.float32 and t.shape == (D,) and t.is_contiguous(),
                f"rmsnorm_quant: {name} must be contiguous float32 ({D},), got {t.dtype} {tuple(t.shape)}",
            )
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    scale = torch.empty(x.shape[:-1] + (1,), dtype=torch.float32, device=x.device)
    tpr, vpt = layout(x, weight, smooth_scale, q_min, q_max) or (0, 0)
    build.launch(
        "mojo_rmsnorm_quant", x.device,
        x.data_ptr(), weight.data_ptr(), None if smooth_scale is None else smooth_scale.data_ptr(),
        q.data_ptr(), scale.data_ptr(), x.numel() // D, D, float(eps), float(q_min), float(q_max),
        int((D * x.element_size()) % 16 == 0 and x.data_ptr() % 16 == 0), tpr, vpt, code,
    )
    launches += 1
    return q, scale
