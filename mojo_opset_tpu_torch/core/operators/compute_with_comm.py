"""Compute+comm ops: the tensor-, sequence- and Ulysses-parallel building blocks.

Counterpart of the JAX package's ``core/operators/compute_with_comm.py``
(``MojoGemmAllReduce`` :67, ``MojoAllGatherGemm`` :88, ``MojoGemmAll2All``
:107, ``MojoGemmReduceScatter`` :133, ``MojoQuantGemmAll2All`` :156,
``MojoAll2AllQuantGemm`` :189). JAX runs them inside ``shard_map`` over a
mesh axis; here each takes a ``torch.distributed`` group (``group``, the
axis's group from ``parallel.mesh``) and calls the comm layer's
collectives (``runtime.comm_context``) on plain local tensors: NCCL on the
card, gloo on the CPU. ``group=None`` is the single-rank identity, as JAX's
``axis_name=None``.

As in JAX, ``trans_weight=False`` means the weight is stored ``(N, K)``
and ``trans_weight=True`` means ``(K, N)``. The GEMMs sum in fp32 and round
once to the input dtype; the int8 GEMMs take exact integer sums (float64)
and dequantize in fp32. These ops are the golden (``ref``) tier; the JAX
xla tier's overlapped forms of ``MojoAllGatherGemm`` and
``MojoGemmReduceScatter`` (a ring that computes the same thing) are their
``cuda`` tier (``backends/cuda/operators/compute_with_comm.py``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from mojo_opset_tpu_torch.core.operator import MojoOperator
from mojo_opset_tpu_torch.runtime import comm_context as comm


def _gemm(input, weight, bias, trans_weight):
    w = weight if trans_weight else weight.t()
    out = torch.matmul(input.float(), w.float()).to(input.dtype)
    if bias is not None:
        out = out + bias
    return out


def _quant_gemm(input, weight, weight_scale, per_token_scale, trans_weight, output_dtype):
    w = weight if trans_weight else weight.t()
    out = torch.matmul(input.double(), w.double()).float()
    scale = weight_scale.float()
    token_scale = per_token_scale.float()
    while scale.ndim < out.ndim:
        scale = scale[None]
    while token_scale.ndim < out.ndim:
        token_scale = token_scale[..., None]
    return (out * scale * token_scale).to(output_dtype)


def _param(t: Optional[torch.Tensor]):
    return None if t is None else nn.Parameter(t, requires_grad=False)


class _CommGemmBase:
    """Shared configuration of the six ops (a mixin; the ops are core ops)."""

    def _init_common(self, weight, bias, trans_weight, group):
        if not isinstance(trans_weight, bool):
            raise TypeError("trans_weight must be bool.")
        self.weight = _param(weight)
        self.bias = _param(bias)
        self.trans_weight = trans_weight
        self.group = group

    def extra_repr(self) -> str:
        return (f"weight_shape={tuple(self.weight.shape)}, has_bias={self.bias is not None}, "
                f"trans_weight={self.trans_weight}, world={comm.group_size(self.group)}")


class MojoGemmAllReduce(_CommGemmBase, MojoOperator):
    """Row-parallel TP: ``all_reduce(input @ W) [+ bias]``; the bias is added
    after the sum (every rank holds all of it)."""

    def __init__(self, weight, bias=None, trans_weight: bool = False, group=None):
        super().__init__()
        self._init_common(weight, bias, trans_weight, group)

    def forward(self, input: torch.Tensor) -> torch.Tensor:
        output = comm.all_reduce(_gemm(input, self.weight, None, self.trans_weight), self.group)
        if self.bias is not None:
            output = output + self.bias
        return output


class MojoAllGatherGemm(_CommGemmBase, MojoOperator):
    """Sequence parallel: all-gather the input along ``gather_dim``, then the GEMM."""

    def __init__(self, weight, bias=None, trans_weight: bool = False, group=None, gather_dim: int = 0):
        super().__init__()
        self._init_common(weight, bias, trans_weight, group)
        self.gather_dim = gather_dim

    def forward(self, input: torch.Tensor) -> torch.Tensor:
        input = comm.all_gather(input, self.group, dim=self.gather_dim)
        return _gemm(input, self.weight, self.bias, self.trans_weight)


class MojoGemmAll2All(_CommGemmBase, MojoOperator):
    """Ulysses: the GEMM, then an all-to-all that trades the shard axis
    (``scatter_dim`` out, ``gather_dim`` in)."""

    def __init__(self, weight, bias=None, trans_weight: bool = False, group=None, scatter_dim: int = 0,
                 gather_dim: int = 1):
        super().__init__()
        self._init_common(weight, bias, trans_weight, group)
        self.scatter_dim = scatter_dim
        self.gather_dim = gather_dim

    def forward(self, input: torch.Tensor) -> torch.Tensor:
        output = _gemm(input, self.weight, self.bias, self.trans_weight)
        return comm.all_to_all(output, self.group, self.scatter_dim, self.gather_dim)

    def extra_repr(self) -> str:
        return super().extra_repr() + f", scatter_dim={self.scatter_dim}, gather_dim={self.gather_dim}"


class MojoGemmReduceScatter(_CommGemmBase, MojoOperator):
    """Sequence parallel: the GEMM, then a reduce-scatter back to shards along ``scatter_dim``."""

    def __init__(self, weight, bias=None, trans_weight: bool = False, group=None, scatter_dim: int = 0):
        super().__init__()
        self._init_common(weight, bias, trans_weight, group)
        self.scatter_dim = scatter_dim

    def forward(self, input: torch.Tensor) -> torch.Tensor:
        output = _gemm(input, self.weight, self.bias, self.trans_weight)
        return comm.reduce_scatter(output, self.group, dim=self.scatter_dim)

    def extra_repr(self) -> str:
        return super().extra_repr() + f", scatter_dim={self.scatter_dim}"


class MojoQuantGemmAll2All(_CommGemmBase, MojoOperator):
    """int8 GEMM, then an all-to-all that splits the output columns and
    gathers rows. ``estimate_shmem_size_mb`` keeps the reference's API (NCCL
    owns its buffers)."""

    def __init__(self, weight, weight_scale, trans_weight: bool = False, group=None,
                 output_dtype=torch.bfloat16, use_internal_format: bool = True, comm_context=None):
        super().__init__()
        self._init_common(weight, None, trans_weight, group)
        self.weight_scale = _param(weight_scale)
        self.output_dtype = output_dtype
        self.use_internal_format = use_internal_format
        self.comm_context = comm_context

    def forward(self, input, per_token_scale, workspace=None):
        output = _quant_gemm(input, self.weight, self.weight_scale, per_token_scale, self.trans_weight,
                             self.output_dtype)
        return comm.all_to_all(output, self.group, output.ndim - 1, 0)

    def estimate_shmem_size_mb(self, **kwargs) -> int:
        return 20


class MojoAll2AllQuantGemm(_CommGemmBase, MojoOperator):
    """An all-to-all that splits rows and gathers K shards, then the int8
    GEMM on this rank's rows (their per-token scales sliced to match)."""

    def __init__(self, weight, weight_scale, trans_weight: bool = False, group=None,
                 output_dtype=torch.bfloat16, use_internal_format: bool = True, comm_context=None):
        super().__init__()
        self._init_common(weight, None, trans_weight, group)
        self.weight_scale = _param(weight_scale)
        self.output_dtype = output_dtype
        self.use_internal_format = use_internal_format
        self.comm_context = comm_context

    def forward(self, input, per_token_scale, workspace=None):
        if self.group is not None:
            n, rank = comm.group_size(self.group), comm.group_rank(self.group)
            input = comm.all_to_all(input, self.group, 0, input.ndim - 1)
            rows = per_token_scale.shape[0] // n
            per_token_scale = per_token_scale[rank * rows:(rank + 1) * rows]
        return _quant_gemm(input, self.weight, self.weight_scale, per_token_scale, self.trans_weight,
                           self.output_dtype)

    def estimate_shmem_size_mb(self, **kwargs) -> int:
        return 20
