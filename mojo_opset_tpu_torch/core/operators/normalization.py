"""The normalization ops (counterpart of the JAX package's
``core/operators/normalization.py``: ``_layer_norm`` :47,
``MojoLayerNorm`` :70, ``MojoRMSNorm`` :90, ``MojoGroupRMSNorm`` :105,
``MojoRMSNormQuant`` :130, ``MojoLayerNormQuant`` :157, the residual-add
family ``MojoResidualAdd{RMS,Layer}Norm`` :193/:225 and
``MojoResidualAdd{RMS,Layer}NormQuant`` :255/:306, helpers ``_quant_range``
:27 and ``_dynamic_quant`` :61).

Statistics in fp32, result cast back to the input dtype. The weights are
fp32 unless ``dtype`` says otherwise, as the JAX ops create them, and lie
on the card unless ``device`` names another. The
residual-add ops keep the reference's quirks: the sum is taken in the
inputs' promoted dtype before the norm; in ``post`` the RMSNorm-quant op
keeps the fp32 normed value as the residual, the LayerNorm-quant op the
un-normed sum.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from mojo_opset_tpu_torch.core.operator import MojoOperator
from mojo_opset_tpu_torch.utils.platform import resolve_device


def _rms_norm_f32(x: torch.Tensor, weight: Optional[torch.Tensor], eps: float) -> torch.Tensor:
    xf = x.float()
    normed = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    return normed if weight is None else normed * weight.float()


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """``(x * rsqrt(mean(x^2) + eps)) * w`` in fp32, cast to x's dtype."""
    return _rms_norm_f32(x, weight, eps).to(x.dtype)


def _layer_norm_f32(x: torch.Tensor, weight: Optional[torch.Tensor], bias: Optional[torch.Tensor],
                    eps: float) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    normed = (xf - mean) * torch.rsqrt(var + eps)
    if weight is not None:
        normed = normed * weight.float()
    if bias is not None:
        normed = normed + bias.float()
    return normed


def layer_norm(x: torch.Tensor, weight: Optional[torch.Tensor], bias: Optional[torch.Tensor],
               eps: float) -> torch.Tensor:
    """``(x - mean) * rsqrt(var + eps)`` (biased variance) in fp32, times
    ``weight`` and plus ``bias`` where given, cast to x's dtype."""
    return _layer_norm_f32(x, weight, bias, eps).to(x.dtype)


def quant_range(quant_dtype: torch.dtype, symmetric: bool = True) -> tuple[float, float]:
    if quant_dtype != torch.int8:
        raise NotImplementedError(f"Unsupported quant_dtype: {quant_dtype}, expected torch.int8")
    return (-128.0 if symmetric else 0.0), 127.0


def rms_norm_quant(
    x: torch.Tensor,
    weight: torch.Tensor,
    eps: float,
    smooth_scale: Optional[torch.Tensor] = None,
    q_min: float = -128.0,
    q_max: float = 127.0,
):
    """RMSNorm in fp32 (times ``smooth_scale`` if given), then per-row
    ``scale = max(amax|normed|, 1e-12) / q_max`` and
    ``q = clamp(round(normed / scale), q_min, q_max)``, rounding half to
    even. Unlike ``dynamic_quant`` a zero row keeps its 1e-12 / q_max
    scale. Returns ``(int8 q of x's shape, fp32 scale (..., 1))``."""
    return _dynamic_quant(_rms_norm_f32(x, weight, eps), smooth_scale, q_min, q_max)


def _dynamic_quant(normed: torch.Tensor, smooth_scale: Optional[torch.Tensor], q_min: float, q_max: float):
    if smooth_scale is not None:
        normed = normed * smooth_scale.float()
    scale = normed.abs().amax(dim=-1, keepdim=True).clamp(min=1e-12) / q_max
    q = torch.round(normed / scale).clamp(q_min, q_max).to(torch.int8)
    return q, scale


def _norm_param(shape, fill: float, device, dtype=None) -> nn.Parameter:
    """A constant-filled parameter on ``device``: the card unless another
    is named (``utils.platform.resolve_device``)."""
    return nn.Parameter(torch.full(shape, fill, device=resolve_device(device), dtype=dtype or torch.float32),
                        requires_grad=False)


def _check_norm_pos(norm_pos: str) -> str:
    if norm_pos not in ("pre", "post"):
        raise ValueError("norm_pos should be 'pre' or 'post'")
    return norm_pos


class MojoLayerNorm(MojoOperator):
    def __init__(self, norm_size: int, eps: float = 1e-5, elementwise_affine: bool = True, *, device=None,
                 dtype=None):
        super().__init__()
        self.norm_size = norm_size
        self.elementwise_affine = elementwise_affine
        self.variance_epsilon = eps
        if elementwise_affine:
            self.weight = _norm_param((norm_size,), 1.0, device, dtype)
            self.bias = _norm_param((norm_size,), 0.0, device, dtype)
        else:
            self.weight = self.bias = None

    def forward(self, hidden_state: torch.Tensor) -> torch.Tensor:
        """LayerNorm over the last dim; same shape/dtype as input."""
        return layer_norm(hidden_state, self.weight, self.bias, self.variance_epsilon)

    def extra_repr(self) -> str:
        return (f"norm_size={self.norm_size}, variance_epsilon={self.variance_epsilon}, "
                f"elementwise_affine={self.elementwise_affine}")


class MojoRMSNorm(MojoOperator):
    def __init__(self, norm_size: int, eps: float = 1e-5, *, device=None, dtype=None):
        super().__init__()
        self.norm_size = norm_size
        self.weight = _norm_param((norm_size,), 1.0, device, dtype)
        self.variance_epsilon = eps

    def forward(self, hidden_state: torch.Tensor) -> torch.Tensor:
        """RMSNorm over the last dim; same shape/dtype as input."""
        return rms_norm(hidden_state, self.weight, self.variance_epsilon)

    def extra_repr(self) -> str:
        return f"norm_size={self.norm_size}, variance_epsilon={self.variance_epsilon}"


class MojoRMSNormQuant(MojoOperator):
    """Fused RMSNorm + dynamic per-token int8 quant; returns ``(q, scale)``."""

    def __init__(self, norm_size: int, eps: float = 1e-5, quant_dtype=torch.int8, symmetric: bool = True,
                 *, device=None):
        super().__init__()
        self.norm_size = norm_size
        self.variance_epsilon = eps
        self.weight = _norm_param((norm_size,), 1.0, device)
        self.quant_dtype = quant_dtype
        self.symmetric = symmetric
        self.q_min, self.q_max = quant_range(quant_dtype, symmetric)

    def forward(self, hidden_state: torch.Tensor, smooth_scale: Optional[torch.Tensor] = None):
        return rms_norm_quant(hidden_state, self.weight, self.variance_epsilon, smooth_scale, self.q_min, self.q_max)

    def extra_repr(self) -> str:
        return (
            f"norm_size={self.norm_size}, variance_epsilon={self.variance_epsilon}, "
            f"quant_dtype={self.quant_dtype}, symmetric={self.symmetric}"
        )


class MojoGroupRMSNorm(MojoOperator):
    """RMSNorm applied independently to each tensor of a list, group ``g``
    scaled by weight row ``g`` (none without ``elementwise_affine``)."""

    def __init__(self, num_groups: int, norm_size: int, eps: float, elementwise_affine: bool = True, *,
                 device=None, dtype=None):
        super().__init__()
        self.num_groups = num_groups
        self.norm_size = norm_size
        self.elementwise_affine = elementwise_affine
        self.variance_epsilon = eps
        self.weight = _norm_param((num_groups, norm_size), 1.0, device, dtype) if elementwise_affine else None

    def forward(self, input_groups: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        return [_rms_norm_f32(input_groups[g], None if self.weight is None else self.weight[g],
                              self.variance_epsilon).to(input_groups[g].dtype) for g in range(self.num_groups)]

    def extra_repr(self) -> str:
        return f"num_groups={self.num_groups}, norm_size={self.norm_size}, variance_epsilon={self.variance_epsilon}"


class MojoLayerNormQuant(MojoOperator):
    """Fused LayerNorm + dynamic per-token int8 quant; returns ``(q, scale)``."""

    def __init__(self, norm_size: int, eps: float = 1e-5, elementwise_affine: bool = True, quant_dtype=torch.int8,
                 symmetric: bool = True, *, device=None, dtype=None):
        super().__init__()
        self.norm_size = norm_size
        self.variance_epsilon = eps
        self.elementwise_affine = elementwise_affine
        self.weight = _norm_param((norm_size,), 1.0, device, dtype) if elementwise_affine else None
        self.bias = _norm_param((norm_size,), 0.0, device, dtype) if elementwise_affine else None
        self.quant_dtype = quant_dtype
        self.symmetric = symmetric
        self.q_min, self.q_max = quant_range(quant_dtype, symmetric)

    def forward(self, hidden_state: torch.Tensor, smooth_scale: Optional[torch.Tensor] = None):
        normed = _layer_norm_f32(hidden_state, self.weight, self.bias, self.variance_epsilon)
        return _dynamic_quant(normed, smooth_scale, self.q_min, self.q_max)

    def extra_repr(self) -> str:
        return (
            f"norm_size={self.norm_size}, variance_epsilon={self.variance_epsilon}, "
            f"elementwise_affine={self.elementwise_affine}, quant_dtype={self.quant_dtype}, "
            f"symmetric={self.symmetric}"
        )


class MojoResidualAddRMSNorm(MojoOperator):
    """Residual add + RMSNorm; returns ``(hidden, residual)``:

      * pre:  residual = hidden + residual; hidden = rms(residual)
      * post: hidden = rms(hidden + residual); residual = hidden

    The sum is in the inputs' promoted dtype, the normed output in hidden's.
    The cuda tier runs kernel P (``csrc/rmsnorm.cu``), which keeps the sum
    in fp32 instead (JAX's Pallas kernel does too)."""

    def __init__(self, norm_size: int, eps: float = 1e-5, norm_pos: str = "pre", *, device=None, dtype=None):
        super().__init__()
        self.norm_size = norm_size
        self.variance_epsilon = float(eps)
        self.weight = _norm_param((norm_size,), 1.0, device, dtype)
        self.norm_pos = _check_norm_pos(norm_pos)

    def forward(self, hidden_state: torch.Tensor, residual: torch.Tensor):
        dtype = hidden_state.dtype
        total = hidden_state + residual
        hidden_state = _rms_norm_f32(total, self.weight, self.variance_epsilon).to(dtype)
        return hidden_state, (total if self.norm_pos == "pre" else hidden_state)

    def extra_repr(self) -> str:
        return f"norm_size={self.norm_size}, variance_epsilon={self.variance_epsilon}, norm_pos={self.norm_pos!r}"


class MojoResidualAddLayerNorm(MojoOperator):
    """Residual add + LayerNorm; returns ``(hidden, residual)`` as
    ``MojoResidualAddRMSNorm`` does."""

    def __init__(self, norm_size: int, eps: float = 1e-5, norm_pos: str = "pre", *, device=None, dtype=None):
        super().__init__()
        self.norm_size = norm_size
        self.variance_epsilon = float(eps)
        self.weight = _norm_param((norm_size,), 1.0, device, dtype)
        self.bias = _norm_param((norm_size,), 0.0, device, dtype)
        self.norm_pos = _check_norm_pos(norm_pos)

    def forward(self, hidden_state: torch.Tensor, residual: torch.Tensor):
        dtype = hidden_state.dtype
        total = hidden_state + residual
        hidden_state = _layer_norm_f32(total, self.weight, self.bias, self.variance_epsilon).to(dtype)
        return hidden_state, (total if self.norm_pos == "pre" else hidden_state)

    def extra_repr(self) -> str:
        return f"norm_size={self.norm_size}, variance_epsilon={self.variance_epsilon}, norm_pos={self.norm_pos!r}"


class MojoResidualAddRMSNormQuant(MojoOperator):
    """Residual add + RMSNorm + dynamic per-token int8 quant; returns
    ``(q, residual, scale)``. In ``post`` the residual is the fp32 normed
    value (reference normalization.py:521)."""

    def __init__(self, norm_size: int, eps: float = 1e-5, norm_pos: str = "pre", quant_dtype=torch.int8,
                 symmetric: bool = True, *, device=None, dtype=None):
        super().__init__()
        self.norm_size = norm_size
        self.variance_epsilon = float(eps)
        self.norm_pos = _check_norm_pos(norm_pos)
        self.weight = _norm_param((norm_size,), 1.0, device, dtype)
        self.quant_dtype = quant_dtype
        self.symmetric = symmetric
        self.q_min, self.q_max = quant_range(quant_dtype, symmetric)

    def forward(self, hidden_state: torch.Tensor, residual: torch.Tensor,
                smooth_scale: Optional[torch.Tensor] = None):
        total = hidden_state + residual
        normed = _rms_norm_f32(total, self.weight, self.variance_epsilon)
        q, scale = _dynamic_quant(normed, smooth_scale, self.q_min, self.q_max)
        return q, (total if self.norm_pos == "pre" else normed), scale

    def extra_repr(self) -> str:
        return (
            f"norm_size={self.norm_size}, variance_epsilon={self.variance_epsilon}, "
            f"norm_pos={self.norm_pos!r}, quant_dtype={self.quant_dtype}, symmetric={self.symmetric}"
        )


class MojoResidualAddLayerNormQuant(MojoOperator):
    """Residual add + LayerNorm + dynamic per-token int8 quant; returns
    ``(q, residual, scale)``. The residual is the un-normed sum in both
    positions (reference normalization.py:634)."""

    def __init__(self, norm_size: int, eps: float = 1e-5, elementwise_affine: bool = True, norm_pos: str = "pre",
                 quant_dtype=torch.int8, symmetric: bool = True, *, device=None, dtype=None):
        super().__init__()
        self.norm_size = norm_size
        self.variance_epsilon = float(eps)
        self.norm_pos = _check_norm_pos(norm_pos)
        self.elementwise_affine = elementwise_affine
        self.weight = _norm_param((norm_size,), 1.0, device, dtype) if elementwise_affine else None
        self.bias = _norm_param((norm_size,), 0.0, device, dtype) if elementwise_affine else None
        self.quant_dtype = quant_dtype
        self.symmetric = symmetric
        self.q_min, self.q_max = quant_range(quant_dtype, symmetric)

    def forward(self, hidden_state: torch.Tensor, residual: torch.Tensor,
                smooth_scale: Optional[torch.Tensor] = None):
        total = hidden_state + residual
        normed = _layer_norm_f32(total, self.weight, self.bias, self.variance_epsilon)
        q, scale = _dynamic_quant(normed, smooth_scale, self.q_min, self.q_max)
        return q, total, scale

    def extra_repr(self) -> str:
        return (
            f"norm_size={self.norm_size}, variance_epsilon={self.variance_epsilon}, "
            f"elementwise_affine={self.elementwise_affine}, norm_pos={self.norm_pos!r}, "
            f"quant_dtype={self.quant_dtype}, symmetric={self.symmetric}"
        )
