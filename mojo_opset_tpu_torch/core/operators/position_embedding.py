"""Rotary position embedding (counterpart of the JAX package's
``core/operators/position_embedding.py``: ``MojoRotaryEmbedding`` :43 with
its ``init_max_length`` table, ``MojoApplyRoPE`` :118, ``MojoMRoPE`` :167,
``MojoVisionRotaryEmbedding2D`` :242 and ``MojoApplyVisionRoPE2D`` :295).
Plain ops: XLA computes them in JAX."""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

import torch

from mojo_opset_tpu_torch.core.operator import MojoOperator
from mojo_opset_tpu_torch.utils.platform import resolve_device


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
    With ``init_max_length`` the cos/sin rows of positions below it are
    tabulated at construction and looked up. ``inv_freq`` and the tables
    are non-persistent buffers: recomputed, never loaded, and on the card
    unless ``device`` names another.
    """

    def __init__(self, rope_theta: float, rope_dim: int, attention_scaling: float = 1.0,
                 init_max_length: Optional[int] = None, *, device=None):
        super().__init__()
        self.rope_theta = rope_theta
        self.rope_dim = rope_dim
        self.attention_scaling = attention_scaling
        self.init_max_length = init_max_length
        device = resolve_device(device)
        inv_freq = 1.0 / (
            rope_theta ** (torch.arange(0, rope_dim, 2, dtype=torch.float32, device=device) / rope_dim)
        )
        self.register_buffer("inv_freq", inv_freq, persistent=False)
        if init_max_length is not None:
            cos, sin = self._cos_sin(torch.arange(init_max_length, dtype=torch.float32, device=device))
            self.register_buffer("cos", cos, persistent=False)
            self.register_buffer("sin", sin, persistent=False)

    def _cos_sin(self, positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        freqs = positions[..., None].float() * self.inv_freq
        emb = torch.cat([freqs, freqs], dim=-1)
        return emb.cos() * self.attention_scaling, emb.sin() * self.attention_scaling

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

        if self.init_max_length is None:
            return self._cos_sin(position_ids)
        position_ids = position_ids.long()
        return self.cos[position_ids], self.sin[position_ids]

    def extra_repr(self) -> str:
        return (
            f"rope_theta={self.rope_theta}, rope_dim={self.rope_dim}, "
            f"attention_scaling={self.attention_scaling}, init_max_length={self.init_max_length}"
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


class MojoMRoPE(MojoOperator):
    """Qwen2-VL's multimodal 3-axis RoPE over flattened (tokens, H * D) q and
    k: the first ``2 * sum(mrope_section)`` lanes of each head rotate, the
    rest pass. A (3, T, half) table takes each axis' section (or, with
    ``is_interleaved``, the t/h/w lanes interleaved); a (T, half) table is
    used as it is."""

    @staticmethod
    def _apply_interleaved_mrope(cos_table, sin_table, mrope_section: List[int]):
        out = []
        for table in (cos_table, sin_table):
            merged = table[0].clone()
            for axis in (1, 2):
                merged[..., axis:mrope_section[axis] * 3:3] = table[axis, ..., axis:mrope_section[axis] * 3:3]
            out.append(merged)
        return out[0], out[1]

    def forward(
        self,
        query: torch.Tensor,
        key: torch.Tensor,
        cos_table: torch.Tensor,
        sin_table: torch.Tensor,
        mrope_section: List[int],
        is_interleaved: bool = False,
        head_dim: Optional[int] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        num_tokens, num_tokens_k = query.shape[0], key.shape[0]
        rope_dim = sum(mrope_section) * 2
        half = rope_dim // 2
        head_dim = rope_dim if head_dim is None else head_dim
        query = query.reshape(num_tokens, query.shape[1] // head_dim, head_dim)
        key = key.reshape(num_tokens_k, key.shape[1] // head_dim, head_dim)

        if cos_table.ndim == 3:
            if is_interleaved:
                cos_table, sin_table = self._apply_interleaved_mrope(cos_table, sin_table, mrope_section)
            else:
                offsets = np.cumsum([0, *mrope_section]).tolist()
                cos_table = torch.cat([cos_table[i, ..., offsets[i]:offsets[i + 1]]
                                       for i in range(len(mrope_section))], dim=-1)
                sin_table = torch.cat([sin_table[i, ..., offsets[i]:offsets[i + 1]]
                                       for i in range(len(mrope_section))], dim=-1)
        cos = cos_table.reshape(num_tokens, half)[:, None, :]
        sin = sin_table.reshape(num_tokens, half)[:, None, :]

        def rotate(x):
            h1, h2 = x[..., :half], x[..., half:rope_dim]
            return torch.cat([h1 * cos - h2 * sin, h2 * cos + h1 * sin, x[..., rope_dim:]], dim=-1)

        return rotate(query).reshape(num_tokens, -1), rotate(key).reshape(num_tokens_k, -1)


class MojoVisionRotaryEmbedding2D(MojoOperator):
    """2-D vision RoPE tables over per-image ``grid_hw`` (B, 2): each
    token's (row, column) positions, grouped in ``adapooling_factor``
    squares, give cos/sin (T, rope_dim). ``grid_hw`` is host metadata: the
    positions are built on the host with numpy. ``inv_freq`` lies on the
    card unless ``device`` names another."""

    def __init__(self, rope_theta: float = 10000.0, rope_dim: int = 64, adapooling_factor: int = 1, *,
                 device=None):
        super().__init__()
        if adapooling_factor < 1:
            raise ValueError("adapooling_factor must be >= 1")
        if rope_dim % 4 != 0:
            raise ValueError("vision 2D rope_dim must be divisible by 4")
        self.rope_theta = rope_theta
        self.rope_dim = rope_dim
        self.adapooling_factor = adapooling_factor
        rotary_dim = rope_dim // 2
        device = resolve_device(device)
        inv_freq = 1.0 / (
            rope_theta ** (torch.arange(0, rotary_dim, 2, dtype=torch.float32, device=device) / rotary_dim)
        )
        self.register_buffer("inv_freq", inv_freq, persistent=False)

    def extra_repr(self) -> str:
        return (f"rope_theta={self.rope_theta}, rope_dim={self.rope_dim}, "
                f"adapooling_factor={self.adapooling_factor}")

    def _build_position_ids(self, grid_hw) -> np.ndarray:
        grid = np.asarray(grid_hw.cpu() if isinstance(grid_hw, torch.Tensor) else grid_hw)
        if grid.ndim != 2 or grid.shape[-1] != 2:
            raise ValueError("grid_hw must be [B, 2]")
        f = self.adapooling_factor
        pos_ids = []
        for gh, gw in grid.tolist():
            gh, gw = int(gh), int(gw)
            if gh <= 0 or gw <= 0:
                raise ValueError("grid height/width must be positive")
            if gh % f or gw % f:
                raise ValueError("grid dims must be divisible by adapooling_factor")
            hpos = np.broadcast_to(np.arange(gh)[:, None], (gh, gw))
            wpos = np.broadcast_to(np.arange(gw)[None, :], (gh, gw))
            pos_ids.append(np.stack([p.reshape(gh // f, f, gw // f, f).transpose(0, 2, 1, 3).reshape(-1)
                                     for p in (hpos, wpos)], axis=-1))
        return np.concatenate(pos_ids, axis=0)

    def forward(self, grid_hw) -> Tuple[torch.Tensor, torch.Tensor]:
        pos_ids = torch.from_numpy(self._build_position_ids(grid_hw)).to(self.inv_freq.device)
        max_grid_size = int(np.asarray(grid_hw.cpu() if isinstance(grid_hw, torch.Tensor) else grid_hw).max())
        table = torch.arange(max_grid_size, dtype=torch.float32, device=self.inv_freq.device)[:, None] * self.inv_freq
        freqs = table[pos_ids].reshape(pos_ids.shape[0], -1)
        emb = torch.cat([freqs, freqs], dim=-1)
        return emb.cos(), emb.sin()


class MojoApplyVisionRoPE2D(MojoOperator):
    """Full-head-dim RoPE on packed vision tokens q, k (T, N, D) with
    prebuilt cos/sin (T, D), in fp32, cast back to each input's dtype.
    (The JAX op's helper is ``_apply``; here that name is
    ``nn.Module._apply``, which ``.to()`` calls.)"""

    @staticmethod
    def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        return (xf * cos[:, None, :] + rotate_half(xf) * sin[:, None, :]).to(x.dtype)

    def forward(self, q, k, cos, sin) -> Tuple[torch.Tensor, torch.Tensor]:
        if q.ndim != 3 or k.ndim != 3:
            raise ValueError("q and k must be 3D packed token-first tensors")
        if cos.ndim != 2 or cos.shape != sin.shape:
            raise ValueError("cos and sin must be 2D tables of one shape")
        if q.shape[0] != cos.shape[0] or k.shape[0] != cos.shape[0]:
            raise ValueError("q, k and the tables must have the same number of tokens")
        if q.shape[-1] != cos.shape[-1]:
            raise ValueError("vision rope rotates the full head_dim")
        return self._rotate(q, cos, sin), self._rotate(k, cos, sin)
