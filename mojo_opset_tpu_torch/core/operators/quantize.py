"""Quantization ops (counterpart of the JAX package's
``core/operators/quantize.py``: ``MojoStaticQuant`` :42, ``MojoDequant``
:66, ``MojoDynamicQuant`` :81).

Plain PyTorch: the JAX package has no Pallas kernel for these, so the port
has no kernel tier for them either. Rounding is ``torch.round`` (half to
even, as ``jnp.round``); division by the scale, as the JAX golden divides.
The MoE variants wait for the MoE slice.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
from torch import nn

from mojo_opset_tpu_torch.core.operator import MojoOperator

INT8_RANGE = (-128.0, 127.0)
DEQUANT_DTYPES = (torch.float16, torch.bfloat16, torch.float32)


def _require_int8(quant_dtype: torch.dtype) -> None:
    if quant_dtype != torch.int8:
        raise NotImplementedError(f"Unsupported quant_dtype: {quant_dtype}, expected torch.int8")


def dynamic_quant(x: torch.Tensor, q_max: float = 127.0, q_min: float = -128.0):
    """Per-row symmetric int8 quant over the last dim; a row whose scale is
    under 1e-6 (an all-zero row) gets scale 1. Returns ``(q, scale (..., 1))``."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1, keepdim=True).clamp(min=1e-12) / q_max
    scale = torch.where(scale < 1e-6, 1.0, scale)
    q = torch.round(xf / scale).clamp(q_min, q_max).to(torch.int8)
    return q, scale


class MojoStaticQuant(MojoOperator):
    """Quantize with a static scale parameter; returns ``(q, scale)``."""

    def __init__(self, input_size: Union[int, Tuple[int, ...]], quant_dtype=torch.int8, *, device=None):
        super().__init__()
        _require_int8(quant_dtype)
        self.input_size = (input_size,) if isinstance(input_size, int) else tuple(input_size)
        self.scale = nn.Parameter(torch.ones(self.input_size, device=device), requires_grad=False)
        self.quant_dtype = quant_dtype
        self.q_min, self.q_max = INT8_RANGE

    def forward(self, input: torch.Tensor):
        trailing = tuple(input.shape[-len(self.input_size):])
        if trailing != self.input_size:
            raise ValueError(f"input trailing dims {trailing} must match scale shape {self.input_size}.")
        q = torch.round(input.float() / self.scale.float()).clamp(self.q_min, self.q_max)
        return q.to(self.quant_dtype), self.scale

    def extra_repr(self) -> str:
        return f"input_size={self.input_size}, quant_dtype={self.quant_dtype}"


class MojoDequant(MojoOperator):
    def __init__(self, output_dtype=torch.bfloat16):
        super().__init__()
        if output_dtype not in DEQUANT_DTYPES:
            raise NotImplementedError(f"Unsupported output_dtype: {output_dtype}")
        self.output_dtype = output_dtype

    def forward(self, input: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
        return (input.float() * scale.float()).to(self.output_dtype)

    def extra_repr(self) -> str:
        return f"output_dtype={self.output_dtype}"


class MojoDynamicQuant(MojoOperator):
    """Per-token symmetric dynamic int8 quant with an optional SmoothQuant
    ``inv_smooth_scale``; returns ``(q_int8, scale (..., 1))``."""

    def __init__(self, input_size: Optional[int] = None, quant_dtype=torch.int8, *, device=None):
        super().__init__()
        _require_int8(quant_dtype)
        self.input_size = input_size
        self.inv_smooth_scale = (
            None
            if input_size is None
            else nn.Parameter(torch.ones((input_size,), device=device), requires_grad=False)
        )
        self.quant_dtype = quant_dtype
        self.q_min, self.q_max = INT8_RANGE

    def forward(self, input: torch.Tensor):
        x = input.float()
        if self.inv_smooth_scale is not None:
            x = x * self.inv_smooth_scale
        return dynamic_quant(x, self.q_max, self.q_min)

    def extra_repr(self) -> str:
        return f"input_size={self.input_size}, quant_dtype={self.quant_dtype}"
