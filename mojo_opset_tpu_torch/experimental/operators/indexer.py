"""DeepSeek-V3.2's lightning indexer: the scores that pick each query's
top-k keys (counterpart of the JAX package's
``experimental/operators/indexer.py``: ``MojoLightningIndexer`` :29,
``MojoIndexer`` :59).

``MojoIndexer.forward`` takes the int8 key cache and its scales and
returns them, as the JAX op does; here they are written in place and the
same tensors come back. Its RoPE runs through ``MojoApplyRoPE`` on 4-D
token-first q and k with a ``qk_rope_head_dim``-wide table on
``head_dim``-wide heads: a partial table, which the cuda tier sends to the
golden, counted in ``CudaApplyRoPE.golden_calls``. The top-k is a stable
descending sort cut at k: equal scores (the ``-inf`` a causal mask leaves
in a prefill row) come lower index first, as ``jax.lax.top_k`` orders them.
"""

from __future__ import annotations

from typing import Optional

import torch

from mojo_opset_tpu_torch.core.operator import MojoOperator
from mojo_opset_tpu_torch.core.operators.gemm import MojoGemm
from mojo_opset_tpu_torch.core.operators.normalization import MojoLayerNorm
from mojo_opset_tpu_torch.core.operators.position_embedding import MojoApplyRoPE
from mojo_opset_tpu_torch.core.operators.quantize import MojoDynamicQuant
from mojo_opset_tpu_torch.experimental.operators.activation import MojoRotateActivation
from mojo_opset_tpu_torch.utils.platform import resolve_device


def topk_indices(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` largest entries of the last axis, largest first,
    equal entries lower index first (``jax.lax.top_k``'s order)."""
    return torch.sort(scores, dim=-1, descending=True, stable=True).indices[..., :k]


class MojoLightningIndexer(MojoOperator):
    def forward(
        self,
        query: torch.Tensor,  # (B, M, H, K)
        query_scale: torch.Tensor,  # (B, M, H)
        key: torch.Tensor,  # (B, N, K)
        key_scale: Optional[torch.Tensor] = None,  # (B, N) or (N,)
    ) -> torch.Tensor:
        """index_score (B, M, N) = sum_h relu(q_h . k) * q_scale_h * k_scale,
        in fp32."""
        B, M, H, K = query.shape
        N = key.shape[1]
        if query_scale.shape != (B, M, H):
            raise ValueError(f"query_scale must be [B, M, H], got {tuple(query_scale.shape)}")
        if key_scale is None:
            key_scale = torch.ones((B, N), dtype=torch.float32, device=query.device)
        elif key_scale.ndim == 1:
            if key_scale.shape[0] != N:
                raise ValueError(f"key_scale must be [N] or [B, N], got {tuple(key_scale.shape)}")
            key_scale = key_scale.float()[None].expand(B, N)
        elif key_scale.shape != (B, N):
            raise ValueError(f"key_scale must be [B, N], got {tuple(key_scale.shape)}")
        dots = torch.einsum("bmhk,bnk->bmhn", query.float(), key.float())
        scored = torch.relu(dots) * query_scale.float()[..., None]
        return scored.sum(dim=2) * key_scale.float()[:, None, :]


def _linear(gemm: MojoGemm, x: torch.Tensor) -> torch.Tensor:
    """``gemm`` on x in the weight's dtype, cast back to x's: the JAX op's
    matmul of a bf16 input on fp32 weights."""
    return gemm(x.to(gemm.weight.dtype)).to(x.dtype)


class MojoIndexer(MojoOperator):
    """The indexer block: q from the q-LoRA latent (``wq_b``), k from the
    hidden states (``wk``, then ``k_norm``), RoPE on the last
    ``qk_rope_head_dim`` lanes, the Hadamard rotation, per-row int8 quant,
    the lightning score against the key cache, and the top-k. The weights
    are fp32, as the JAX op's, drawn from ``generator`` on ``device``: the
    card unless another is named."""

    def __init__(
        self,
        dim: int = 7168,
        n_heads: int = 128,
        head_dim: int = 128,
        qk_rope_head_dim: int = 64,
        topk: int = 2048,
        q_lora_rank: int = 1536,
        max_batch_size: int = 128,
        max_seq_len: int = 32768,
        *,
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        device = resolve_device(device)
        self.dim = dim
        self.n_heads = n_heads
        self.head_dim = head_dim
        self.rope_head_dim = qk_rope_head_dim
        self.topk = topk
        self.q_lora_rank = q_lora_rank
        self.softmax_scale = head_dim**-0.5
        self.max_batch_size = max_batch_size
        self.max_seq_len = max_seq_len
        self.wq_b = MojoGemm(q_lora_rank, n_heads * head_dim, bias=False, device=device)
        self.wk = MojoGemm(dim, head_dim, bias=False, device=device)
        self.k_norm = MojoLayerNorm(head_dim, device=device)
        self.weights_proj = MojoGemm(dim, n_heads, bias=False, device=device)
        self.rope = MojoApplyRoPE()
        self.activation = MojoRotateActivation()
        self.quant = MojoDynamicQuant()
        self.lightning_indexer = MojoLightningIndexer()
        for gemm in (self.wq_b, self.wk, self.weights_proj):
            gemm.reset_parameters(generator=generator)

    def init_cache(self, batch_size: Optional[int] = None, seq_len: Optional[int] = None):
        """Zeroed ``(k_cache (B, S, head_dim) int8, k_scale_cache (B, S)
        fp32)`` on the weights' device."""
        b, s = batch_size or self.max_batch_size, seq_len or self.max_seq_len
        device = self.wk.weight.device
        return (torch.zeros((b, s, self.head_dim), dtype=torch.int8, device=device),
                torch.zeros((b, s), dtype=torch.float32, device=device))

    def forward(
        self,
        x: torch.Tensor,  # (B, S, dim)
        qr: torch.Tensor,  # (B, S, q_lora_rank)
        start_pos: int,
        freqs_cis: torch.Tensor,  # complex (S, rope_dim / 2)
        mask: Optional[torch.Tensor],
        k_cache: torch.Tensor,  # (B, max_seq, head_dim) int8
        k_scale_cache: torch.Tensor,  # (B, max_seq) fp32
    ):
        """Returns ``(topk_indices (B, S, min(topk, end)), index_score (B, S,
        end), k_cache, k_scale_cache)``, ``end = start_pos + S``; the step's
        keys and scales are written into the caches at ``start_pos``."""
        bsz, seqlen, _ = x.shape
        end_pos = start_pos + seqlen
        if end_pos > k_cache.shape[1] or bsz > k_cache.shape[0]:
            raise ValueError(f"positions [{start_pos}, {end_pos}) of {bsz} rows do not fit the cache "
                             f"{tuple(k_cache.shape)}")
        q = _linear(self.wq_b, qr).reshape(bsz, seqlen, self.n_heads, self.head_dim)
        k = self.k_norm(_linear(self.wk, x))

        cos = torch.cat([freqs_cis.real, freqs_cis.real], dim=-1)
        sin = torch.cat([freqs_cis.imag, freqs_cis.imag], dim=-1)
        q, k = self.rope(q, k[:, :, None, :], cos, sin, head_first=False)
        k = k[:, :, 0, :]

        q_quant, q_scale = self.quant(self.activation(q))
        k_quant, k_scale = self.quant(self.activation(k))
        q_scale = q_scale[..., 0]
        if k_scale.ndim == 3:
            k_scale = k_scale.amax(dim=-1)
        k_cache[:bsz, start_pos:end_pos] = k_quant.to(k_cache.dtype)
        k_scale_cache[:bsz, start_pos:end_pos] = k_scale.float()

        weights = self.weights_proj(x.float()) * self.n_heads**-0.5
        weights = weights * q_scale * self.softmax_scale
        index_score = self.lightning_indexer(q_quant.float(), weights, key=k_cache[:bsz, :end_pos].float(),
                                             key_scale=k_scale_cache[:bsz, :end_pos])
        if mask is not None:
            index_score = index_score + mask
        return topk_indices(index_score, min(self.topk, end_pos)), index_score, k_cache, k_scale_cache

    def extra_repr(self) -> str:
        return (f"dim={self.dim}, n_heads={self.n_heads}, head_dim={self.head_dim}, "
                f"rope_head_dim={self.rope_head_dim}, topk={self.topk}, q_lora_rank={self.q_lora_rank}")
