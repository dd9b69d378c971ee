"""cuda-tier paged attention (kernels C and D, ``csrc/paged_decode.cu`` and
``csrc/paged_prefill.cu``), and the same kernels over int8 (C8) pages
(C' and D'). The KV-dequant ops take no ``compute_dtype=torch.int8``, no
``query_scale`` and no ``mask`` here: those raise, they do not fall back
to the golden."""

from __future__ import annotations

from typing import Optional

import torch

from mojo_opset_tpu_torch.backends.cuda.kernels.paged_decode import paged_decode_gqa
from mojo_opset_tpu_torch.backends.cuda.kernels.paged_prefill import paged_prefill_gqa
from mojo_opset_tpu_torch.core.operators.attention import MojoPagedDecodeGQA, MojoPagedPrefillGQA
from mojo_opset_tpu_torch.experimental.operators.kv_quant_attention import (
    MojoPagedDecodeGQAWithKVDequant,
    MojoPagedPrefillGQAWithKVDequant,
)


def _check_kernel_options(op, query_scale, mask) -> None:
    if op.compute_dtype == torch.int8:
        raise NotImplementedError("compute_dtype=torch.int8 runs in the golden tier only (MOJO_BACKEND=ref)")
    op._check_unported(query_scale, mask)


class CudaPagedDecodeGQA(MojoPagedDecodeGQA):
    def forward(
        self,
        query: torch.Tensor,
        key_cache: torch.Tensor,
        value_cache: torch.Tensor,
        total_seq_lens: torch.Tensor,
        block_tables: torch.Tensor,
        softmax_scale: Optional[float] = None,
        *,
        max_total_seq_len: Optional[int] = None,
    ) -> torch.Tensor:
        return paged_decode_gqa(
            query, key_cache, value_cache, total_seq_lens, block_tables,
            softmax_scale, self.gqa_layout, self.kv_layout,
        )


class CudaPagedPrefillGQA(MojoPagedPrefillGQA):
    def forward(
        self,
        query: torch.Tensor,
        key_cache: torch.Tensor,
        value_cache: torch.Tensor,
        cu_q_lens: torch.Tensor,
        block_tables: torch.Tensor,
        softmax_scale: Optional[float] = None,
        cu_total_seq_lens: Optional[torch.Tensor] = None,
        *,
        max_q_len: Optional[int] = None,
        max_total_seq_len: Optional[int] = None,
    ) -> torch.Tensor:
        return paged_prefill_gqa(
            query, key_cache, value_cache, cu_q_lens, block_tables, softmax_scale, cu_total_seq_lens,
            self.gqa_layout, self.kv_layout, is_causal=self.is_causal, max_q_len=max_q_len,
        )


class CudaPagedDecodeGQAWithKVDequant(MojoPagedDecodeGQAWithKVDequant):
    def forward(
        self,
        query: torch.Tensor,
        query_scale: Optional[torch.Tensor],
        key_cache: torch.Tensor,
        key_scale: torch.Tensor,
        value_cache: torch.Tensor,
        value_scale: torch.Tensor,
        total_seq_lens: torch.Tensor,
        block_tables: torch.Tensor,
        softmax_scale: Optional[float] = None,
        mask: Optional[torch.Tensor] = None,
        *,
        max_total_seq_len: Optional[int] = None,
    ) -> torch.Tensor:
        _check_kernel_options(self, query_scale, mask)
        return paged_decode_gqa(
            query, key_cache, value_cache, total_seq_lens, block_tables, softmax_scale, self.gqa_layout, "HND",
            key_scale, value_scale,
        )


class CudaPagedPrefillGQAWithKVDequant(MojoPagedPrefillGQAWithKVDequant):
    def forward(
        self,
        query: torch.Tensor,
        query_scale: Optional[torch.Tensor],
        key_cache: torch.Tensor,
        key_scale: torch.Tensor,
        value_cache: torch.Tensor,
        value_scale: torch.Tensor,
        cu_q_lens: torch.Tensor,
        block_tables: torch.Tensor,
        softmax_scale: Optional[float] = None,
        cu_total_seq_lens: Optional[torch.Tensor] = None,
        mask: Optional[torch.Tensor] = None,
        max_q_len: Optional[int] = None,
        max_total_seq_len: Optional[int] = None,
    ) -> torch.Tensor:
        _check_kernel_options(self, query_scale, mask)
        return paged_prefill_gqa(
            query, key_cache, value_cache, cu_q_lens, block_tables, softmax_scale, cu_total_seq_lens,
            self.gqa_layout, "HND", is_causal=self.is_causal, max_q_len=max_q_len,
            key_scale=key_scale, value_scale=value_scale,
        )
