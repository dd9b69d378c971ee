"""Rotary position embedding (counterpart of
the JAX package's ``core/operators/position_embedding.py:43,118``)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from mojo_opset_tpu_torch.core.operator import MojoOperator


def varlen_position_ids(
    total_tokens: int,
    cu_q_lens: torch.Tensor,
    total_seq_lens: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Per-token positions for varlen layouts.

    Token t in batch i gets position ``context_len_i + (t - cu_q_lens[i])``
    where ``context_len_i = total_seq_lens[i] - q_lens[i]`` (0 if absent).
    """
    token_ids = torch.arange(total_tokens, dtype=torch.int32, device=cu_q_lens.device)
    batch = torch.searchsorted(cu_q_lens, token_ids, right=True) - 1
    batch = batch.clamp(0, cu_q_lens.shape[0] - 2)
    pos_in_seq = token_ids - cu_q_lens[batch]
    if total_seq_lens is not None:
        context = total_seq_lens - (cu_q_lens[1:] - cu_q_lens[:-1])
        return (context[batch] + pos_in_seq).to(torch.int32)
    return pos_in_seq.to(torch.int32)


class MojoRotaryEmbedding(MojoOperator):
    """cos/sin generation for RoPE.

    Modes:
      1. varlen prefill: x [T, H] + cu_q_lens (+ total_seq_lens) -> cos/sin [T, D]
      2. padded prefill: x [B, S, H], no ids -> cos/sin [S, D]
      3. decode / explicit: position_ids [...] -> cos/sin [..., D]
    ``inv_freq`` is a non-persistent buffer: it is recomputed, never loaded.
    """

    def __init__(self, rope_theta: float, rope_dim: int, attention_scaling: float = 1.0, *, device=None):
        super().__init__()
        self.rope_theta = rope_theta
        self.rope_dim = rope_dim
        self.attention_scaling = attention_scaling
        inv_freq = 1.0 / (
            rope_theta ** (torch.arange(0, rope_dim, 2, dtype=torch.float32, device=device) / rope_dim)
        )
        self.register_buffer("inv_freq", inv_freq, persistent=False)

    def forward(
        self,
        x: torch.Tensor,
        cu_q_lens: Optional[torch.Tensor] = None,
        total_seq_lens: Optional[torch.Tensor] = None,
        position_ids: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        if position_ids is not None and cu_q_lens is not None:
            raise ValueError("At most one of cu_q_lens or position_ids should be provided")
        if cu_q_lens is not None:
            if x.ndim != 2:
                raise ValueError("x must be 2D: [T, D] for varlen")
            position_ids = varlen_position_ids(x.shape[0], cu_q_lens, total_seq_lens)
        elif position_ids is None:
            position_ids = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)

        freqs = position_ids[..., None].float() * self.inv_freq
        emb = torch.cat([freqs, freqs], dim=-1)
        return emb.cos() * self.attention_scaling, emb.sin() * self.attention_scaling

    def extra_repr(self) -> str:
        return (
            f"rope_theta={self.rope_theta}, rope_dim={self.rope_dim}, "
            f"attention_scaling={self.attention_scaling}"
        )


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


class MojoApplyRoPE(MojoOperator):
    """Rotate-half RoPE with partial-rope (``nope_dim``) support and
    head-first/token-first layouts. The golden computes in the input dtype,
    as the JAX golden does."""

    def __init__(self, interleaved: bool = False):
        super().__init__()
        if interleaved:
            raise NotImplementedError("interleaved impl is not supported yet.")
        self.interleaved = interleaved

    def extra_repr(self) -> str:
        return f"interleaved={self.interleaved}"

    @staticmethod
    def _apply_rope(q, k, cos, sin):
        rope_dim = cos.shape[-1]
        nope_dim = q.shape[-1] - rope_dim
        if nope_dim > 0:
            q_nope, q = q[..., :nope_dim], q[..., nope_dim:]
            k_nope, k = k[..., :nope_dim], k[..., nope_dim:]

        q_rot = (q * cos + rotate_half(q) * sin).to(q.dtype)
        k_rot = (k * cos + rotate_half(k) * sin).to(k.dtype)

        if nope_dim > 0:
            q_rot = torch.cat([q_nope, q_rot], dim=-1)
            k_rot = torch.cat([k_nope, k_rot], dim=-1)
        return q_rot, k_rot

    def forward(
        self,
        q: torch.Tensor,
        k: torch.Tensor,
        cos: torch.Tensor,
        sin: torch.Tensor,
        head_first: bool = True,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Layouts: varlen [T,N,D]/[N,T,D]; padded [B,S,N,D]/[B,N,S,D];
        decode [B,N,D]/[N,B,D]; cos/sin broadcast over the head axis."""
        if q.ndim != k.ndim or q.ndim not in (3, 4):
            raise ValueError("q and k must both be 3D or 4D")
        if cos.shape != sin.shape:
            raise ValueError("cos and sin must have the same shape")
        head_axis = -3 if head_first else -2
        return self._apply_rope(q, k, cos.unsqueeze(head_axis), sin.unsqueeze(head_axis))
