"""LayerNorm, RMSNorm and RMSNorm + per-token quant (counterpart of the JAX
package's ``core/operators/normalization.py``: ``_layer_norm`` :47,
``MojoLayerNorm`` :70, ``MojoRMSNorm`` :90,
``MojoRMSNormQuant`` :130, helpers ``_quant_range`` :27 and
``_dynamic_quant`` :61).

Statistics in fp32, result cast back to the input dtype. The weights are
fp32 unless ``dtype`` says otherwise, as the JAX ops create them.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from mojo_opset_tpu_torch.core.operator import MojoOperator


def _rms_norm_f32(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    normed = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    return normed * weight.float()


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """``(x * rsqrt(mean(x^2) + eps)) * w`` in fp32, cast to x's dtype."""
    return _rms_norm_f32(x, weight, eps).to(x.dtype)


def layer_norm(x: torch.Tensor, weight: Optional[torch.Tensor], bias: Optional[torch.Tensor],
               eps: float) -> torch.Tensor:
    """``(x - mean) * rsqrt(var + eps)`` (biased variance) in fp32, times
    ``weight`` and plus ``bias`` where given, cast to x's dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    normed = (xf - mean) * torch.rsqrt(var + eps)
    if weight is not None:
        normed = normed * weight.float()
    if bias is not None:
        normed = normed + bias.float()
    return normed.to(x.dtype)


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
    normed = _rms_norm_f32(x, weight, eps)
    if smooth_scale is not None:
        normed = normed * smooth_scale.float()
    scale = normed.abs().amax(dim=-1, keepdim=True).clamp(min=1e-12) / q_max
    q = torch.round(normed / scale).clamp(q_min, q_max).to(torch.int8)
    return q, scale


class MojoLayerNorm(MojoOperator):
    def __init__(self, norm_size: int, eps: float = 1e-5, elementwise_affine: bool = True, *, device=None,
                 dtype=None):
        super().__init__()
        self.norm_size = norm_size
        self.elementwise_affine = elementwise_affine
        self.variance_epsilon = eps
        dtype = dtype or torch.float32
        if elementwise_affine:
            self.weight = nn.Parameter(torch.ones((norm_size,), device=device, dtype=dtype), requires_grad=False)
            self.bias = nn.Parameter(torch.zeros((norm_size,), device=device, dtype=dtype), requires_grad=False)
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
        self.weight = nn.Parameter(
            torch.ones((norm_size,), device=device, dtype=dtype or torch.float32), requires_grad=False
        )
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
        self.weight = nn.Parameter(torch.ones((norm_size,), device=device), requires_grad=False)
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
