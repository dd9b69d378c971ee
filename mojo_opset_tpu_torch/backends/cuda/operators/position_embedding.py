"""cuda-tier ApplyRoPE: token-first (T, H, D) on kernel B
(``csrc/rope.cu``), head-first (B, H, S, D) or (H, T, D) on kernel M
(``csrc/rope_head_first.cu``), as the JAX tier sends the head-first layout
to ``rope_head_first`` (``backends/pallas/operators/position_embedding.py:41-57``).
Token-first (T, H, D) with tables in another dtype than q's (fp32 tables
beside bf16 rows, which the TPU kernel casts to fp32, rope.py:90-92) goes
to M through its token-first view (B takes tables in q's dtype only).

Forms neither kernel takes go to the golden ``MojoApplyRoPE.forward``, as
the JAX tier sends them to its golden (:33-67), each call counted in
``CudaApplyRoPE.golden_calls``: partial-rope tables (``cos.shape[-1] < D``,
the ``nope_dim`` lanes passing through), token-first inputs that are not
(T, H, D) (e.g. DeepSeek-V3.2's indexer's (B, S, H, D)), and tables whose
leading shape the kernel cannot take (B wants (T, D); M (S, D) or
(B, S, D)).
"""

from __future__ import annotations

from typing import Tuple

import torch

from mojo_opset_tpu_torch.backends.cuda.functions.position_embedding import rotate_layout
from mojo_opset_tpu_torch.backends.cuda.kernels.rope import rope_token_first
from mojo_opset_tpu_torch.backends.cuda.kernels.rope_head_first import rope_head_first
from mojo_opset_tpu_torch.core.operators.position_embedding import MojoApplyRoPE


def kernel_takes(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor, head_first: bool) -> bool:
    """Whether kernel B (token-first) or M (head-first) takes this call's
    form: full-width tables, and the layouts and table shapes above."""
    D = q.shape[-1]
    if q.ndim != k.ndim or cos.shape[-1] != D:
        return False
    if not head_first:
        return q.ndim == 3 and tuple(cos.shape) == (q.shape[0], D)
    if q.ndim == 3:  # (H, T, D), a (T, D) table
        return tuple(cos.shape) == (q.shape[1], D)
    if q.ndim == 4:
        B, _, S, _ = q.shape
        return tuple(cos.shape) in ((S, D), (B, S, D))
    return False


class CudaApplyRoPE(MojoApplyRoPE):
    golden_calls = 0

    def forward(
        self,
        q: torch.Tensor,
        k: torch.Tensor,
        cos: torch.Tensor,
        sin: torch.Tensor,
        head_first: bool = True,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        if not kernel_takes(q, k, cos, head_first):
            CudaApplyRoPE.golden_calls += 1
            return super().forward(q, k, cos, sin, head_first)
        if head_first or cos.dtype != q.dtype:
            return rotate_layout(rope_head_first, q, k, cos, sin, head_first)
        return rope_token_first(q, k, cos, sin)
