"""Dense and int8 GEMMs (counterpart of the JAX package's
``core/operators/gemm.py``: ``MojoGemm`` :23, ``MojoQuantGemm`` :144).

The JAX package leaves the dense projections to XLA dots, so the port
leaves them to ``torch.matmul``: ``MojoGemm`` has no kernel tier. The int8
GEMM had a Pallas kernel, so ``MojoQuantGemm`` has one in the cuda tier
(``csrc/int8_matmul.cu``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

QUANT_OUTPUT_DTYPES = (torch.float16, torch.bfloat16, torch.float32)

from mojo_opset_tpu_torch.core.operator import MojoOperator


class MojoGemm(MojoOperator):
    """nn.Linear-alike: ``y = x @ W^T + b`` with weight stored ``(out, in)``,
    drawn from U(-1/sqrt(in), 1/sqrt(in)) like the JAX package."""

    def __init__(
        self,
        in_features: int,
        out_features: int,
        bias: bool = True,
        *,
        device=None,
        dtype=None,
    ):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        dtype = dtype or torch.float32
        self.weight = nn.Parameter(
            torch.empty((out_features, in_features), device=device, dtype=dtype), requires_grad=False
        )
        self.bias = (
            nn.Parameter(torch.empty((out_features,), device=device, dtype=dtype), requires_grad=False)
            if bias
            else None
        )
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        bound = 1.0 / (self.in_features**0.5)
        self.weight.uniform_(-bound, bound, generator=generator)
        if self.bias is not None:
            self.bias.uniform_(-bound, bound, generator=generator)

    def forward(self, input: torch.Tensor) -> torch.Tensor:
        # bf16/f16 matmuls accumulate in fp32 and round once, as the JAX
        # op's preferred_element_type=float32 + cast does
        out = torch.matmul(input, self.weight.t())
        if self.bias is not None:
            out = out + self.bias
        return out.to(input.dtype)

    def extra_repr(self) -> str:
        return f"in_features={self.in_features}, out_features={self.out_features}, bias={self.bias is not None}"


def quant_matmul_reference(
    x: torch.Tensor,
    weight: torch.Tensor,
    input_scale: torch.Tensor,
    weight_scale: torch.Tensor,
    trans_weight: bool,
    output_dtype: torch.dtype,
) -> torch.Tensor:
    """``out[m, n] = (sum_k x[m, k] * w[k, n]) * input_scale[m] * weight_scale[n]``.

    The integer sums are taken in float64, which holds them exactly
    (|sum| <= K * 128^2 < 2^53; fp32 would round past 2^24, and
    ``torch.matmul`` takes no integer dtype on CUDA). They round once to
    fp32, as the JAX op's int32 -> fp32 cast does, and the epilogue runs
    in fp32 with one rounding to ``output_dtype``.
    """
    w = weight.t() if trans_weight else weight  # (K, N)
    acc = torch.matmul(x.double(), w.double()).float()
    input_scale = input_scale.float()
    if input_scale.ndim == 1:
        input_scale = input_scale[:, None]
    return (acc * input_scale * weight_scale.float()[None, :]).to(output_dtype)


class MojoQuantGemm(MojoOperator):
    """int8 x int8 -> int32 GEMM dequantized by the per-token input scale
    and the per-channel weight scale; output in ``output_dtype``.

    ``weight`` is int8 ``(K, N)``, or ``(N, K)`` with ``trans_weight`` (the
    model's layout); ``weight_scale`` is float32 ``(N,)``. The JAX op
    defaults its scale to bf16 but its converter writes fp32, and a bf16
    value widens to fp32 exactly, so the port keeps fp32. Both are filled
    by ``modeling.qwen3.quantize_qwen3`` or ``load_numpy_state``; a new op
    holds zeros and ones.
    """

    def __init__(
        self,
        in_features: int,
        out_features: int,
        output_dtype=torch.bfloat16,
        trans_weight: bool = False,
        quant_dtype=torch.int8,
        weight_dtype=torch.int8,
        *,
        device=None,
    ):
        super().__init__()
        if weight_dtype == "int4":
            raise NotImplementedError(
                "int4 (w4a8) QuantGemm weights come with the speculative-decoding slice "
                "(ROADMAP.md queue 1 item 7, kernel int4_matmul.py::int4_scaled_matmul)"
            )
        if quant_dtype != torch.int8 or weight_dtype != torch.int8:
            raise NotImplementedError(
                f"QuantGemm takes int8 activations and weights, got {quant_dtype}, {weight_dtype}")
        if output_dtype not in QUANT_OUTPUT_DTYPES:
            raise NotImplementedError(f"Unsupported output_dtype: {output_dtype}")
        self.in_features = in_features
        self.out_features = out_features
        self.output_dtype = output_dtype
        self.trans_weight = trans_weight
        shape = (out_features, in_features) if trans_weight else (in_features, out_features)
        self.weight = nn.Parameter(torch.zeros(shape, dtype=torch.int8, device=device), requires_grad=False)
        self.weight_scale = nn.Parameter(torch.ones((out_features,), device=device), requires_grad=False)

    def forward(self, input: torch.Tensor, input_scale: torch.Tensor) -> torch.Tensor:
        if input.ndim != 2:
            raise ValueError(f"input must be 2D, got shape {tuple(input.shape)}.")
        return quant_matmul_reference(
            input, self.weight, input_scale, self.weight_scale, self.trans_weight, self.output_dtype)

    def extra_repr(self) -> str:
        return (
            f"in_features={self.in_features}, out_features={self.out_features}, "
            f"output_dtype={self.output_dtype}, trans_weight={self.trans_weight}"
        )
