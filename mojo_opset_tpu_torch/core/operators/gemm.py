"""Dense, grouped, int8 and packed-int4 GEMMs (counterpart of the JAX
package's ``core/operators/gemm.py``: ``MojoGemm`` :23, ``MojoGroupGemm``
:76, ``INT4_BLOCK`` and the int4 packing :115-141, ``MojoQuantGemm`` :144).

The JAX package leaves the dense projections to XLA dots, so the port
leaves them to ``torch.matmul``: ``MojoGemm`` has no kernel tier. The
grouped, int8 and int4 GEMMs had Pallas kernels, so the cuda tier has
three (``csrc/group_gemm.cu``, ``csrc/int8_matmul.cu``,
``csrc/int4_matmul.cu``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

QUANT_OUTPUT_DTYPES = (torch.float16, torch.bfloat16, torch.float32)

from mojo_opset_tpu_torch.core.operator import MojoOperator
from mojo_opset_tpu_torch.utils.platform import resolve_device


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
        device = resolve_device(device)
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


def grouped_matmul_reference(
    x: torch.Tensor, weight: torch.Tensor, group_sizes: torch.Tensor, trans_weight: bool = False
) -> torch.Tensor:
    """``out[r] = x[r] @ W[group_of(r)]`` for ``x`` (M, K) with rows sorted
    by group and ``weight`` (G, K, N), or (G, N, K) with ``trans_weight``.

    A per-group loop over the counts read to the host (a sync per call on
    a card). fp32 sums, one rounding to ``x.dtype``. Rows past the groups'
    end are zero; a group that runs past row M is cut there.
    """
    w = weight.transpose(1, 2) if trans_weight else weight  # (G, K, N)
    out = torch.zeros((x.shape[0], w.shape[2]), dtype=x.dtype, device=x.device)
    start = 0
    for g, n in enumerate(group_sizes.tolist()):
        stop = min(start + max(n, 0), x.shape[0])
        if stop > start:
            out[start:stop] = torch.matmul(x[start:stop].float(), w[g].float()).to(x.dtype)
        start = stop
    return out


class MojoGroupGemm(MojoOperator):
    """Ragged grouped GEMM: 2-D input split row-wise by ``group_list``
    counts, per-group weight ``(G, Din, Dout)``, or ``(G, Dout, Din)`` with
    ``trans_weight`` (the experts' layout). Output in the input dtype, fp32
    sums. The golden is a per-group loop (JAX ``core/operators/gemm.py:76``)."""

    def __init__(self, weight: torch.Tensor, trans_weight: bool = False):
        super().__init__()
        if weight.ndim != 3:
            raise ValueError(f"weight must be 3-D (G, Din, Dout), got shape {tuple(weight.shape)}")
        self.weight = nn.Parameter(weight, requires_grad=False)
        self.trans_weight = trans_weight

    def _check(self, input: torch.Tensor, group_list: torch.Tensor) -> None:
        if input.ndim != 2:
            raise ValueError(f"input must be 2-D, got shape {tuple(input.shape)}")
        if group_list.shape != (self.weight.shape[0],):
            raise ValueError(f"group_list must hold one count per group ({self.weight.shape[0]}), "
                             f"got shape {tuple(group_list.shape)}")

    def forward(self, input: torch.Tensor, group_list: torch.Tensor) -> torch.Tensor:
        self._check(input, group_list)
        return grouped_matmul_reference(input, self.weight, group_list, self.trans_weight)

    def extra_repr(self) -> str:
        return (f"weight_shape={tuple(self.weight.shape)}, weight_dtype={self.weight.dtype}, "
                f"trans_weight={self.trans_weight}")


INT4_BLOCK = 128  # output channels of one packed-int4 group (see pack_int4_rows)


def pack_int4_rows(w_q: torch.Tensor) -> torch.Tensor:
    """Pack int4 values (int8 storage, range [-8, 7]) of an (N, K) weight two
    per byte along the output-channel axis, in groups of 128 rows: packed
    row ``j*64 + r`` holds channel ``j*128 + r`` in its low nibble and
    channel ``j*128 + 64 + r`` in its high nibble. Returns (N // 2, K) int8.
    The JAX package's layout, bit for bit."""
    n, k = w_q.shape
    if n % INT4_BLOCK:
        raise ValueError(f"int4 packing needs N % {INT4_BLOCK} == 0, got {n}")
    b = w_q.to(torch.int8).reshape(n // INT4_BLOCK, INT4_BLOCK, k)
    lo, hi = b[:, : INT4_BLOCK // 2], b[:, INT4_BLOCK // 2:]
    return ((hi << 4) | (lo & 15)).reshape(n // 2, k)


def unpack_int4_rows(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_int4_rows`: (N // 2, K) int8 -> (N, K) int8;
    ``lo = ((p & 15) ^ 8) - 8``, ``hi = p >> 4`` (arithmetic)."""
    n2, k = packed.shape
    b = packed.reshape(n2 * 2 // INT4_BLOCK, INT4_BLOCK // 2, k)
    lo = ((b & 15) ^ 8) - 8
    return torch.cat([lo, b >> 4], dim=1).reshape(n2 * 2, k)


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
    """int8 (or packed-int4) x int8 -> int32 GEMM dequantized by the
    per-token input scale and the per-channel weight scale; output in
    ``output_dtype``.

    ``weight`` is int8 ``(K, N)``, or ``(N, K)`` with ``trans_weight`` (the
    model's layout); ``weight_scale`` is float32 ``(N,)``. The JAX op
    defaults its scale to bf16 but its converter writes fp32, and a bf16
    value widens to fp32 exactly, so the port keeps fp32. Both are filled
    by ``modeling.qwen3.quantize_qwen3`` or ``load_numpy_state``; a new op
    holds zeros and ones. ``weight_dtype="int4"`` stores the weight packed
    two channels per byte, int8 ``(N // 2, K)`` (:func:`pack_int4_rows`);
    it needs ``trans_weight`` and ``N % 128 == 0``.
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
        if quant_dtype != torch.int8 or weight_dtype not in (torch.int8, "int4"):
            raise NotImplementedError(
                f"QuantGemm takes int8 activations and int8 or int4 weights, got {quant_dtype}, {weight_dtype}")
        if output_dtype not in QUANT_OUTPUT_DTYPES:
            raise NotImplementedError(f"Unsupported output_dtype: {output_dtype}")
        self.in_features = in_features
        self.out_features = out_features
        self.output_dtype = output_dtype
        self.trans_weight = trans_weight
        self.weight_dtype = weight_dtype
        if weight_dtype == "int4":
            if not trans_weight or out_features % INT4_BLOCK:
                raise ValueError(
                    f"int4 weights need trans_weight=True and out_features % {INT4_BLOCK} == 0, "
                    f"got trans_weight={trans_weight}, out_features={out_features}")
            shape = (out_features // 2, in_features)
        else:
            shape = (out_features, in_features) if trans_weight else (in_features, out_features)
        device = resolve_device(device)
        self.weight = nn.Parameter(torch.zeros(shape, dtype=torch.int8, device=device), requires_grad=False)
        self.weight_scale = nn.Parameter(torch.ones((out_features,), device=device), requires_grad=False)

    def forward(self, input: torch.Tensor, input_scale: torch.Tensor) -> torch.Tensor:
        if input.ndim != 2:
            raise ValueError(f"input must be 2D, got shape {tuple(input.shape)}.")
        weight = unpack_int4_rows(self.weight) if self.weight_dtype == "int4" else self.weight
        return quant_matmul_reference(
            input, weight, input_scale, self.weight_scale, self.trans_weight, self.output_dtype)

    def extra_repr(self) -> str:
        return (
            f"in_features={self.in_features}, out_features={self.out_features}, "
            f"output_dtype={self.output_dtype}, trans_weight={self.trans_weight}, "
            f"weight_dtype={self.weight_dtype}"
        )
