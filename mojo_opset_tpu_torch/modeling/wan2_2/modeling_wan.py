"""Wan2.2 DiT video diffusion backbone.

Counterpart of the JAX package's ``modeling/wan2_2/modeling_wan.py``
(``sinusoidal_embedding_1d`` :33, ``rope_params`` :41, ``WanSelfAttention``
:57, ``WanCrossAttention`` :105, ``WanAttentionBlock`` :121, ``Head`` :151,
``WanConfig`` :166, ``WanModel`` :183): the t2v, i2v and ti2v variants, the
patch embedding (a strided 3-D convolution), 6-way AdaLN modulation blocks,
the 3-D grid RoPE and unpatchify. Module names follow the JAX package's, so
``state_dict()`` keys equal its ``utils.hf.state_dict_of`` keys; the complex
RoPE table ``freqs`` is recomputed, not loaded.

The attention runs ``MojoSdpa``: maskless (every clip fills ``seq_len``)
on kernel J, and with the (B, 1, 1, S) key-padding mask of a ragged batch
on kernel O (``CudaSdpa``). The q/k norms are ``MojoRMSNorm`` (kernel A).

``WanConfig.dtype`` is the parameters' dtype: bf16 gives the JAX package's
serving cast (``benchmark/dit_protocol.py:135-141``, every floating
parameter in bf16) while latents stay fp32 at the model's boundary. The
patch embedding is an fp32 convolution, as in JAX: on the card it is full
fp32 only with ``torch.backends.cudnn.allow_tf32 = False``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mojo_opset_tpu_torch.core.operators import MojoGelu, MojoGemm, MojoLayerNorm, MojoRMSNorm, MojoSdpa, MojoSilu
from mojo_opset_tpu_torch.experimental.operators import MojoGridRoPE
from mojo_opset_tpu_torch.utils.platform import resolve_device


def sinusoidal_embedding_1d(dim: int, position: torch.Tensor) -> torch.Tensor:
    """(N,) positions -> (N, dim) fp32 ``[cos, sin]`` of ``pos * 10000^(-i / half)``."""
    assert dim % 2 == 0
    half = dim // 2
    pos = position.float()
    sinusoid = torch.outer(pos, torch.pow(10000.0, -torch.arange(half, dtype=torch.float32, device=pos.device) / half))
    return torch.cat([torch.cos(sinusoid), torch.sin(sinusoid)], dim=1)


def rope_params(max_seq_len: int, dim: int, theta: float = 10000.0, device=None) -> torch.Tensor:
    """(max_seq_len, dim / 2) complex64 unit phases ``exp(i * pos * theta^(-2j / dim))``,
    computed in float64 on the host."""
    assert dim % 2 == 0
    freqs = np.outer(np.arange(max_seq_len), 1.0 / np.power(theta, np.arange(0, dim, 2).astype(np.float64) / dim))
    return torch.from_numpy(np.exp(1j * freqs).astype(np.complex64)).to(device)


class WanSelfAttention(nn.Module):
    def __init__(self, dim, num_heads, window_size=(-1, -1), qk_norm=True, eps=1e-6, *, device=None, dtype=None):
        super().__init__()
        assert dim % num_heads == 0
        self.dim = dim
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.window_size = window_size
        self.qk_norm = qk_norm
        self.eps = eps
        self.q, self.k, self.v, self.o = (MojoGemm(dim, dim, device=device, dtype=dtype) for _ in range(4))
        self.norm_q = MojoRMSNorm(dim, eps=eps, device=device, dtype=dtype) if qk_norm else None
        self.norm_k = MojoRMSNorm(dim, eps=eps, device=device, dtype=dtype) if qk_norm else None
        self.sdpa = MojoSdpa()
        self.grid_rope = MojoGridRoPE()

    @staticmethod
    def _qk_norm(norm, x):
        return norm(x) if norm is not None else x

    @staticmethod
    def _key_mask(lens: Optional[torch.Tensor], b: int, s: int) -> Optional[torch.Tensor]:
        """(B, 1, 1, S) bool mask hiding the padded keys (JAX :79-84)."""
        if lens is None:
            return None
        return (torch.arange(s, device=lens.device)[None, :] < lens.reshape(b, 1))[:, None, None, :]

    def forward(self, x, seq_lens, grid_sizes, freqs):
        b, s = x.shape[:2]
        n, d = self.num_heads, self.head_dim
        q = self._qk_norm(self.norm_q, self.q(x)).reshape(b, s, n, d)
        k = self._qk_norm(self.norm_k, self.k(x)).reshape(b, s, n, d)
        v = self.v(x).reshape(b, s, n, d)
        qr = self.grid_rope(q, grid_sizes, freqs).transpose(1, 2)
        kr = self.grid_rope(k, grid_sizes, freqs).transpose(1, 2)
        out = self.sdpa(qr, kr, v.transpose(1, 2), attn_mask=self._key_mask(seq_lens, b, s))
        return self.o(out.transpose(1, 2).reshape(b, s, self.dim))


class WanCrossAttention(WanSelfAttention):
    def forward(self, x, context, context_lens):
        b = x.shape[0]
        n, d = self.num_heads, self.head_dim
        q = self._qk_norm(self.norm_q, self.q(x)).reshape(b, -1, n, d)
        k = self._qk_norm(self.norm_k, self.k(context)).reshape(b, -1, n, d)
        v = self.v(context).reshape(b, -1, n, d)
        out = self.sdpa(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                        attn_mask=self._key_mask(context_lens, b, k.shape[1]))
        return self.o(out.transpose(1, 2).reshape(b, q.shape[1], self.dim))


class WanAttentionBlock(nn.Module):
    def __init__(self, dim, ffn_dim, num_heads, window_size=(-1, -1), qk_norm=True, cross_attn_norm=False, eps=1e-6,
                 *, device=None, dtype=None):
        super().__init__()
        self.dim = dim
        self.norm1 = MojoLayerNorm(dim, eps, elementwise_affine=False)
        self.self_attn = WanSelfAttention(dim, num_heads, window_size, qk_norm, eps, device=device, dtype=dtype)
        self.norm3 = MojoLayerNorm(dim, eps, device=device, dtype=dtype) if cross_attn_norm else None
        self.cross_attn = WanCrossAttention(dim, num_heads, (-1, -1), qk_norm, eps, device=device, dtype=dtype)
        self.norm2 = MojoLayerNorm(dim, eps, elementwise_affine=False)
        self.ffn_in = MojoGemm(dim, ffn_dim, device=device, dtype=dtype)
        self.ffn_act = MojoGelu(approximate=True)
        self.ffn_out = MojoGemm(ffn_dim, dim, device=device, dtype=dtype)
        self.modulation = nn.Parameter(torch.empty((1, 6, dim), device=device, dtype=dtype or torch.float32),
                                       requires_grad=False)
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """N(0, 1) / sqrt(dim), as JAX draws the modulation."""
        self.modulation.normal_(generator=generator).div_(self.dim**0.5)

    def forward(self, x, e, seq_lens, grid_sizes, freqs, context, context_lens):
        # e: (B, L1, 6, C); the modulation broadcasts over the sequence axis
        e6 = self.modulation[None] + e
        e_parts = [e6[:, :, i, :] for i in range(6)]
        y = self.self_attn(self.norm1(x) * (1 + e_parts[1]) + e_parts[0], seq_lens, grid_sizes, freqs)
        x = x + y * e_parts[2]
        x = x + self.cross_attn(self.norm3(x) if self.norm3 is not None else x, context, context_lens)
        y = self.ffn_out(self.ffn_act(self.ffn_in(self.norm2(x) * (1 + e_parts[4]) + e_parts[3])))
        return x + y * e_parts[5]


class Head(nn.Module):
    def __init__(self, dim, out_dim, patch_size, eps=1e-6, *, device=None, dtype=None):
        super().__init__()
        self.dim = dim
        self.out_dim = out_dim
        self.patch_size = tuple(patch_size)
        self.norm = MojoLayerNorm(dim, eps, elementwise_affine=False)
        self.head = MojoGemm(dim, math.prod(patch_size) * out_dim, device=device, dtype=dtype)
        self.modulation = nn.Parameter(torch.empty((1, 2, dim), device=device, dtype=dtype or torch.float32),
                                       requires_grad=False)
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.modulation.normal_(generator=generator).div_(self.dim**0.5)

    def forward(self, x, e):
        e2 = self.modulation[None] + e[:, :, None, :]  # (B, L1, 2, C)
        return self.head(self.norm(x) * (1 + e2[:, :, 1, :]) + e2[:, :, 0, :])


@dataclass
class WanConfig:
    model_type: str = "t2v"
    patch_size: Tuple[int, int, int] = (1, 2, 2)
    text_len: int = 512
    in_dim: int = 16
    dim: int = 2048
    ffn_dim: int = 8192
    freq_dim: int = 256
    text_dim: int = 4096
    out_dim: int = 16
    num_heads: int = 16
    num_layers: int = 32
    window_size: Tuple[int, int] = (-1, -1)
    qk_norm: bool = True
    cross_attn_norm: bool = True
    eps: float = 1e-6
    dtype: torch.dtype = torch.float32  # every floating parameter's


class WanModel(nn.Module):
    """Wan diffusion backbone for text-to-video, image-to-video and ti2v.

    ``forward(x, t, context, seq_len, y=None)``: ``x`` a list of latents
    (C_in, F, H, W), ``t`` (B,) or (B, seq_len) timesteps, ``context`` a list
    of (L, text_dim) text embeddings (padded to ``text_len``). Returns the
    fp32 velocities (C_out, F, H, W). The model is built on the card unless
    ``device`` names another (``utils.platform.resolve_device``);
    ``generator`` draws the weights with the JAX package's distributions
    (otherwise torch's default RNG does).
    """

    def __init__(self, config: Optional[WanConfig] = None, device=None, generator: Optional[torch.Generator] = None,
                 **overrides):
        super().__init__()
        cfg = config or WanConfig(**overrides)
        assert cfg.model_type in ("t2v", "i2v", "ti2v", "s2v")
        device = resolve_device(device)
        self.cfg = cfg
        d = cfg.dim // cfg.num_heads
        assert cfg.dim % cfg.num_heads == 0 and d % 2 == 0
        dt = cfg.dtype
        self.in_dim = cfg.in_dim * 2 if cfg.model_type == "i2v" else cfg.in_dim
        self.patch_weight = nn.Parameter(torch.empty((cfg.dim, self.in_dim, *cfg.patch_size), device=device, dtype=dt),
                                         requires_grad=False)
        self.patch_bias = nn.Parameter(torch.empty((cfg.dim,), device=device, dtype=dt), requires_grad=False)
        self.text_in = MojoGemm(cfg.text_dim, cfg.dim, device=device, dtype=dt)
        self.text_act = MojoGelu(approximate=True)
        self.text_out = MojoGemm(cfg.dim, cfg.dim, device=device, dtype=dt)
        self.time_in = MojoGemm(cfg.freq_dim, cfg.dim, device=device, dtype=dt)
        self.time_act = MojoSilu()
        self.time_out = MojoGemm(cfg.dim, cfg.dim, device=device, dtype=dt)
        self.time_proj = MojoGemm(cfg.dim, cfg.dim * 6, device=device, dtype=dt)
        self.blocks = nn.ModuleList(
            WanAttentionBlock(cfg.dim, cfg.ffn_dim, cfg.num_heads, cfg.window_size, cfg.qk_norm, cfg.cross_attn_norm,
                              cfg.eps, device=device, dtype=dt)
            for _ in range(cfg.num_layers))
        self.head = Head(cfg.dim, cfg.out_dim, cfg.patch_size, cfg.eps, device=device, dtype=dt)
        # complex64, outside the module state: Module.to(dtype) would cast a complex buffer to a real dtype
        self.freqs = torch.cat([rope_params(1024, d - 4 * (d // 6), device=device),
                                rope_params(1024, 2 * (d // 6), device=device),
                                rope_params(1024, 2 * (d // 6), device=device)], dim=1)
        self.reset_parameters()
        if generator is not None:
            from mojo_opset_tpu_torch.utils.weights import init_random_

            init_random_(self, generator)
            self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """The patch embedding's U(-1/sqrt(fan_in), 1/sqrt(fan_in)), as JAX draws it."""
        bound = 1.0 / math.sqrt(self.in_dim * math.prod(self.cfg.patch_size))
        self.patch_weight.uniform_(-bound, bound, generator=generator)
        self.patch_bias.uniform_(-bound, bound, generator=generator)

    def _patch_embed(self, u: torch.Tensor):
        """u (C_in, F, H, W) -> (1, L, dim) tokens in the parameter dtype, and
        the (F, H, W) grid: an fp32 strided convolution, VALID padding."""
        out = F.conv3d(u[None].float(), self.patch_weight.float(), self.patch_bias.float(), stride=self.cfg.patch_size)
        grid = tuple(out.shape[2:])
        tokens = out.reshape(1, self.cfg.dim, -1).transpose(1, 2)
        return tokens.to(self.patch_weight.dtype), grid

    def calculate_freqs(self, grid_sizes: Sequence[Tuple[int, int, int]], seq_len: int) -> List[torch.Tensor]:
        """Per sample, the (F*H*W, 1, head_dim/2) complex phases of its grid."""
        c = (self.cfg.dim // self.cfg.num_heads) // 2
        sizes = [c - 2 * (c // 3), c // 3, c // 3]
        offs = np.cumsum([0] + sizes)
        parts = [self.freqs[:, offs[i]:offs[i + 1]] for i in range(3)]
        freqs_list = []
        for f, h, w in grid_sizes:
            fi = torch.cat([parts[0][:f].reshape(f, 1, 1, -1).expand(f, h, w, sizes[0]),
                            parts[1][:h].reshape(1, h, 1, -1).expand(f, h, w, sizes[1]),
                            parts[2][:w].reshape(1, 1, w, -1).expand(f, h, w, sizes[2])], dim=-1)
            freqs_list.append(fi.reshape(f * h * w, 1, -1))
        return freqs_list

    def unpatchify(self, x: torch.Tensor, grid_sizes) -> List[torch.Tensor]:
        c, p = self.cfg.out_dim, self.cfg.patch_size
        out = []
        for i, v in enumerate(grid_sizes):
            u = x[i, :math.prod(v)].reshape(*v, *p, c).permute(6, 0, 3, 1, 4, 2, 5)  # fhwpqrc -> cfphqwr
            out.append(u.reshape(c, *[a * b for a, b in zip(v, p)]))
        return out

    def forward(self, x: List[torch.Tensor], t: torch.Tensor, context: List[torch.Tensor], seq_len: int,
                y: Optional[List[torch.Tensor]] = None) -> List[torch.Tensor]:
        cfg = self.cfg
        if cfg.model_type == "i2v":
            assert y is not None
        if y is not None:
            x = [torch.cat([u, v], dim=0) for u, v in zip(x, y)]
        tokens, grid_sizes = [], []
        for u in x:
            tok, grid = self._patch_embed(u)
            tokens.append(tok)
            grid_sizes.append(grid)
        # token counts come from shapes: when every clip fills seq_len the key-padding mask is all-True, so none is
        # passed and the attention stays on the maskless kernel (JAX :293-301)
        lens = [tok.shape[1] for tok in tokens]
        assert max(lens) <= seq_len
        seq_lens = None if all(n == seq_len for n in lens) else torch.tensor(lens, dtype=torch.int32,
                                                                             device=tokens[0].device)
        xcat = torch.cat([F.pad(tok, (0, 0, 0, seq_len - tok.shape[1])) for tok in tokens])

        # uniform t (the standard denoise step) runs the time MLPs at one position per batch row and broadcasts
        # over the sequence (JAX :303-318)
        wdt = self.patch_weight.dtype
        bt = t.shape[0]
        tl = 1 if t.ndim == 1 else seq_len
        emb = sinusoidal_embedding_1d(cfg.freq_dim, t.reshape(-1)).reshape(bt, tl, -1).to(wdt)
        e = self.time_out(self.time_act(self.time_in(emb)))
        e0 = self.time_proj(self.time_act(e)).reshape(bt, tl, 6, cfg.dim)

        ctx = torch.stack([F.pad(u, (0, 0, 0, cfg.text_len - u.shape[0])) for u in context]).to(wdt)
        ctx = self.text_out(self.text_act(self.text_in(ctx)))

        freqs_list = self.calculate_freqs(grid_sizes, seq_len)
        h = xcat
        for block in self.blocks:
            h = block(h, e0, seq_lens, grid_sizes, freqs_list, ctx, None)
        h = self.head(h, e)
        return [u.float() for u in self.unpatchify(h, grid_sizes)]
