"""cuda-tier paged MLA attention on kernel I (``csrc/mla_decode.cu``).

Counterpart of the JAX package's ``backends/pallas/operators/mla.py``
(``PallasPagedDecodeMLA``) and, for prefill, of its XLA tier
(``XlaPagedPrefillMLA``, ``backends/xla/operators/mla.py:103``), which has
no Pallas kernel. Both ops absorb ``kv_b_proj`` into the queries
(``q_lat = W_uk^T q_nope``, scale folded in, in the cache's dtype), run
kernel I in the latent space and apply ``W_uv`` to its normalized latent
output; the two products with the weights are plain batched matmuls. Decode
passes one kernel row per sequence; prefill one per packed query token,
with its sequence and its causal limit ``min(kv_len, q_abs + 1)`` built on
the device, so neither syncs with the host.

The attention sink goes to the kernel too (it folds the sink into the
softmax sum), and any latent width r whose rows are whole 16-byte rows:
the TPU wrapper's fallbacks (its ``r % 128`` alignment and its sink) are
TPU matters. Widths the kernel does not take (``mla_decode.takes``: r or
dr not whole 16-byte rows, a bf16/fp16 tile past shared memory, fp32 past
the scalar kernel's r 512 / r + dr 576) take the golden op, counted in
``golden_calls``, as JAX's Pallas op sends ``r % 128 != 0`` to its XLA
tier (``backends/pallas/operators/mla.py:36``). ``attend`` is the latent
attention the op runs; a plain twin on the card sets it to
``mla_decode_absorbed_plain``.
"""

from __future__ import annotations

from typing import Optional

import torch

from mojo_opset_tpu_torch.backends.cuda.kernels.mla_decode import mla_decode_absorbed, takes
from mojo_opset_tpu_torch.core.operators.attention import (
    assert_paged_decode_contract,
    assert_paged_prefill_contract,
    seq_lens_from_cu,
)
from mojo_opset_tpu_torch.experimental.operators.mla import MojoPagedDecodeMLA, MojoPagedPrefillMLA, _token_batch


def _absorbed(op, query, compressed_kv_cache, k_pe_cache, row_lens, block_tables, row_seqs, softmax_scale, attended):
    """``op.attend`` over the latent caches, between the two absorbed weight
    products; rows where ``attended`` is False give zeros."""
    H, dn, dv = op.num_heads, op.qk_nope_head_dim, op.v_head_dim
    w = op.kv_b_proj.float().reshape(H, dn + dv, -1)  # W_uk (H, dn, r) | W_uv (H, dv, r)
    q = query.float() * op._scale(softmax_scale)
    q_lat = torch.einsum("thd,hdr->thr", q[..., :dn], w[:, :dn]).to(compressed_kv_cache.dtype).contiguous()
    q_pe = q[..., dn:].to(k_pe_cache.dtype).contiguous()
    out_lat = op.attend(q_lat, q_pe, compressed_kv_cache, k_pe_cache, row_lens, block_tables, row_seqs, op.attn_sink)
    out = torch.einsum("thr,hdr->thd", out_lat, w[:, dn:])
    return torch.where(attended[:, None, None], out, 0.0).to(query.dtype)


def _golden(cls, compressed_kv_cache, k_pe_cache) -> bool:
    """Whether the call takes the golden (kernel I does not take the
    caches' widths); counted in ``cls.golden_calls``."""
    if takes(compressed_kv_cache.dtype, compressed_kv_cache.shape[-1], k_pe_cache.shape[-1]):
        return False
    cls.golden_calls += 1
    return True


class CudaPagedDecodeMLA(MojoPagedDecodeMLA):
    attend = staticmethod(mla_decode_absorbed)
    golden_calls = 0

    def forward(
        self,
        query: torch.Tensor,  # (B, H, dn + dr)
        compressed_kv_cache: torch.Tensor,  # (N, 1, bs, r)
        k_pe_cache: torch.Tensor,  # (N, 1, bs, dr)
        total_seq_lens: torch.Tensor,
        block_tables: torch.Tensor,
        softmax_scale: Optional[float] = None,
    ) -> torch.Tensor:
        assert_paged_decode_contract(block_tables, total_seq_lens)
        if _golden(CudaPagedDecodeMLA, compressed_kv_cache, k_pe_cache):
            return super().forward(query, compressed_kv_cache, k_pe_cache, total_seq_lens, block_tables,
                                   softmax_scale)
        return _absorbed(self, query, compressed_kv_cache, k_pe_cache, total_seq_lens, block_tables, None,
                         softmax_scale, total_seq_lens > 0)


class CudaPagedPrefillMLA(MojoPagedPrefillMLA):
    attend = staticmethod(mla_decode_absorbed)
    golden_calls = 0

    def forward(
        self,
        query: torch.Tensor,  # (T, H, dn + dr)
        compressed_kv_cache: torch.Tensor,
        k_pe_cache: torch.Tensor,
        cu_q_lens: torch.Tensor,
        block_tables: torch.Tensor,
        softmax_scale: Optional[float] = None,
        cu_total_seq_lens: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        assert_paged_prefill_contract(cu_q_lens, block_tables, cu_total_seq_lens)
        if _golden(CudaPagedPrefillMLA, compressed_kv_cache, k_pe_cache):
            return super().forward(query, compressed_kv_cache, k_pe_cache, cu_q_lens, block_tables, softmax_scale,
                                   cu_total_seq_lens)
        q_lens = seq_lens_from_cu(cu_q_lens)
        kv_lens = q_lens if cu_total_seq_lens is None else seq_lens_from_cu(cu_total_seq_lens)
        batch, q_pos = _token_batch(cu_q_lens, query.shape[0], q_lens.shape[0])
        kv_len_t = kv_lens[batch]
        row_lens = kv_len_t
        if self.is_causal:  # query row i of sequence b sits at kv_len - q_len + i and sees positions <= it
            row_lens = torch.minimum(kv_len_t, kv_len_t - q_lens[batch] + q_pos + 1)
        return _absorbed(self, query, compressed_kv_cache, k_pe_cache, row_lens.clamp(min=0).to(torch.int32),
                         block_tables, batch.to(torch.int32), softmax_scale, kv_len_t > 0)
