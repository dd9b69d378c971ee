"""Quantization ops (counterpart of the JAX package's
``core/operators/quantize.py``: ``_repeat_by_counts`` :29,
``MojoStaticQuant`` :42, ``MojoDequant`` :66, ``MojoDynamicQuant`` :81,
``MojoMoEDynamicQuant`` :109, ``MojoDequantSwiGLUQuant`` :143).

Plain PyTorch: the JAX package has no Pallas kernel for these, so the port
has no kernel tier for them either. Rounding is ``torch.round`` (half to
even, as ``jnp.round``); division by the scale, as the JAX golden divides.
The MoE variants find each row's expert on the device
(:func:`repeat_by_counts`): none reads the counts back to the host.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
from torch import nn

from mojo_opset_tpu_torch.core.operator import MojoOperator
from mojo_opset_tpu_torch.utils.platform import resolve_device

INT8_RANGE = (-128.0, 127.0)
DEQUANT_DTYPES = (torch.float16, torch.bfloat16, torch.float32)


def repeat_by_counts(values: torch.Tensor, counts: torch.Tensor, rows: int) -> torch.Tensor:
    """Row ``r`` of the result is ``values[g]`` for the group ``g`` that
    holds row ``r`` when group ``g`` owns ``counts[g]`` consecutive rows.
    Found on the device by a search of the counts' running sum, so the
    counts are never read to the host; rows past the groups' end take the
    last group's values, as the JAX helper's clamped gather does."""
    ends = torch.cumsum(counts.to(torch.int64), 0)
    group = torch.searchsorted(ends, torch.arange(rows, device=values.device), right=True)
    return values.index_select(0, group.clamp_(max=values.shape[0] - 1))


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
        self.scale = nn.Parameter(torch.ones(self.input_size, device=resolve_device(device)), requires_grad=False)
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
            else nn.Parameter(torch.ones((input_size,), device=resolve_device(device)), requires_grad=False)
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


class MojoMoEDynamicQuant(MojoOperator):
    """Per-token dynamic int8 quant after per-expert smooth scales
    ``inv_smooth_scale`` (E, input_size): the rows are grouped by
    ``token_count``, each row scaled by its expert's row. Returns
    ``(q_int8 of the input's shape, scale (..., 1))``."""

    def __init__(self, expert_num: int, input_size: int, quant_dtype=torch.int8, *, device=None):
        super().__init__()
        _require_int8(quant_dtype)
        self.expert_num = expert_num
        self.input_size = input_size
        self.inv_smooth_scale = nn.Parameter(torch.ones((expert_num, input_size), device=resolve_device(device)),
                                             requires_grad=False)
        self.quant_dtype = quant_dtype
        self.q_min, self.q_max = INT8_RANGE

    def forward(self, input: torch.Tensor, token_count: torch.Tensor):
        if input.ndim < 2:
            raise ValueError(f"input must have at least 2 dims for MoE dynamic quant, got {input.ndim}.")
        rows = input.reshape(-1, input.shape[-1])
        x = rows.float() * repeat_by_counts(self.inv_smooth_scale.float(), token_count, rows.shape[0])
        q, scale = dynamic_quant(x, self.q_max, self.q_min)
        return q.reshape(input.shape), scale.reshape(input.shape[:-1] + (1,))

    def extra_repr(self) -> str:
        return f"expert_num={self.expert_num}, input_size={self.input_size}, quant_dtype={self.quant_dtype}"


class MojoDequantSwiGLUQuant(MojoOperator):
    """Dequant -> SwiGLU -> requant, the w8a8 MoE inner activation.

    ``x`` (tokens, 2H) is scaled by the per-expert ``weight_scale`` (E, 2H)
    (and a per-token ``activation_scale``), offset by ``bias``, split in
    halves, activated (``silu(left) * right`` with ``activate_left``, else
    ``silu(right) * left``), scaled by the per-expert ``quant_scale`` (E, H)
    and quantized per token (no floor on the scale past 1e-12 / 127, as in
    the JAX op). With ``token_count`` the rows are grouped by expert;
    without it row ``r`` takes expert row ``r`` of the scales, broadcast as
    the JAX op broadcasts them. Returns ``(q_int8 (tokens, H), scale
    (tokens, 1))``. No model calls it.
    """

    def __init__(self, expert_num: int, hidden_size: int, quant_dtype=torch.int8, activate_left: bool = False,
                 quant_mode: int = 1, *, device=None, dtype=None):
        super().__init__()
        _require_int8(quant_dtype)
        if quant_mode != 1:
            raise NotImplementedError("Only dynamic quant_mode=1 is currently supported.")
        self.expert_num = expert_num
        self.hidden_size = hidden_size
        device, dtype = resolve_device(device), dtype or torch.float32
        self.weight_scale = nn.Parameter(torch.ones((expert_num, 2 * hidden_size), device=device, dtype=dtype),
                                         requires_grad=False)
        self.quant_scale = nn.Parameter(torch.ones((expert_num, hidden_size), device=device, dtype=dtype),
                                        requires_grad=False)
        self.quant_dtype = quant_dtype
        self.activate_left = activate_left
        self.quant_mode = quant_mode
        self.q_min, self.q_max = INT8_RANGE

    def forward(self, x: torch.Tensor, activation_scale: Optional[torch.Tensor] = None,
                bias: Optional[torch.Tensor] = None, quant_offset: Optional[torch.Tensor] = None,
                token_count: Optional[torch.Tensor] = None):
        if x.ndim != 2:
            raise ValueError(f"x must be 2D (tokens, 2H), got {tuple(x.shape)}")
        if x.shape[-1] % 2 != 0:
            raise ValueError(f"x last dim must be even for SwiGLU split, got {x.shape[-1]}")
        if quant_offset is not None:
            raise NotImplementedError("quant_offset is not supported.")
        tokens = x.shape[0]

        def per_row(values):
            return values if token_count is None else repeat_by_counts(values, token_count, tokens)

        xf = x.float() * per_row(self.weight_scale.float())
        if activation_scale is not None:
            xf = xf * activation_scale.float()[:, None]
        if bias is not None:
            bias = bias.float()
            xf = xf + (per_row(bias) if bias.ndim == 2 else bias)
        left, right = xf.chunk(2, dim=-1)
        silu = torch.nn.functional.silu
        out = silu(left) * right if self.activate_left else silu(right) * left
        out = out * per_row(self.quant_scale.float())
        scale = out.abs().amax(dim=-1, keepdim=True).clamp(min=1e-12) / self.q_max
        return torch.round(out / scale).clamp(self.q_min, self.q_max).to(self.quant_dtype), scale

    def extra_repr(self) -> str:
        return (f"expert_num={self.expert_num}, hidden_size={self.hidden_size}, quant_dtype={self.quant_dtype}, "
                f"activate_left={self.activate_left}, quant_mode={self.quant_mode}")
