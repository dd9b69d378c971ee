"""umT5 text encoder for Wan2.2.

Counterpart of the JAX package's ``modeling/wan2_2/modeling_t5.py``
(``fp16_clamp`` :24, ``T5LayerNorm`` :31, ``T5Attention`` :45,
``T5FeedForward`` :82, ``T5SelfAttention`` :94, ``T5CrossAttention`` :115,
``T5Encoder`` :139, ``T5Decoder`` :166, ``T5Model`` :198,
``umt5_xxl_encoder`` :218, ``T5EncoderModel`` :229). Dropout is an inference
no-op. Module names follow the JAX package's, so ``state_dict()`` keys equal
its ``utils.hf.state_dict_of`` keys.

The attention is ``MojoSdpa`` with scale 1 and an additive fp32 bias (the
relative position bias, ``finfo(float32).min`` where the mask is 0). The
JAX Pallas tier sends a float bias to the golden, and so does the port's
``CudaSdpa``, counted in its ``golden_calls``: once a layer a call. No
kernel runs in the encoder.

``dtype`` is the GEMMs' and the token embedding's dtype (bf16 is Wan2.2's
T5 dtype); the norms' weights and the relative bias stay fp32, as in JAX.
The models are built on the card unless ``device`` names another
(``utils.platform.resolve_device``); ``generator`` draws every weight with
the JAX package's distributions.
"""

from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn

from mojo_opset_tpu_torch.core.operators import MojoEmbedding, MojoGelu, MojoGemm, MojoRMSNorm, MojoSdpa
from mojo_opset_tpu_torch.experimental.operators import MojoRelativeEmbedding
from mojo_opset_tpu_torch.utils.platform import resolve_device


def fp16_clamp(x: torch.Tensor) -> torch.Tensor:
    """fp16 values clipped to +-(fp16 max - 1000); other dtypes as they are."""
    if x.dtype == torch.float16:
        clamp = torch.finfo(torch.float16).max - 1000
        return x.clamp(-clamp, clamp)
    return x


class T5LayerNorm(nn.Module):
    """RMS-style T5 norm (no mean subtraction): fp32 statistics and weight,
    the result in x's dtype."""

    def __init__(self, dim: int, eps: float = 1e-6, *, device=None):
        super().__init__()
        self.dim = dim
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=resolve_device(device)), requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        normed = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + self.eps)
        return (self.weight * normed).to(x.dtype)


class T5Attention(nn.Module):
    def __init__(self, dim, dim_attn, num_heads, dropout=0.1, *, device=None, dtype=None):
        super().__init__()
        assert dim_attn % num_heads == 0
        self.dim = dim
        self.dim_attn = dim_attn
        self.num_heads = num_heads
        self.head_dim = dim_attn // num_heads
        self.q = MojoGemm(dim, dim_attn, bias=False, device=device, dtype=dtype)
        self.k = MojoGemm(dim, dim_attn, bias=False, device=device, dtype=dtype)
        self.v = MojoGemm(dim, dim_attn, bias=False, device=device, dtype=dtype)
        self.o = MojoGemm(dim_attn, dim, bias=False, device=device, dtype=dtype)
        self.attn = MojoSdpa(scale=1.0)

    def forward(self, x, context=None, mask=None, pos_bias=None):
        """``mask`` (B, Lk) or (B, Lq, Lk), 0 where a key is hidden;
        ``pos_bias`` (1 or B, heads, Lq, Lk)."""
        context = x if context is None else context
        b, n, c = x.shape[0], self.num_heads, self.head_dim
        q = self.q(x).reshape(b, -1, n, c)
        k = self.k(context).reshape(b, -1, n, c)
        v = self.v(context).reshape(b, -1, n, c)

        attn_bias = torch.zeros((b, n, q.shape[1], k.shape[1]), dtype=torch.float32, device=x.device)
        if pos_bias is not None:
            attn_bias = attn_bias + pos_bias
        if mask is not None:
            assert mask.ndim in (2, 3)
            m = mask[:, None, None, :] if mask.ndim == 2 else mask[:, None]
            attn_bias = torch.where(m == 0, torch.finfo(torch.float32).min, attn_bias)

        out = self.attn(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), attn_mask=attn_bias)
        return self.o(out.transpose(1, 2).reshape(b, -1, n * c))


class T5FeedForward(nn.Module):
    """``fc2(fc1(x) * gelu_tanh(gate(x)))``."""

    def __init__(self, dim, dim_ffn, dropout=0.1, *, device=None, dtype=None):
        super().__init__()
        self.gate = MojoGemm(dim, dim_ffn, bias=False, device=device, dtype=dtype)
        self.act = MojoGelu(approximate=True)
        self.fc1 = MojoGemm(dim, dim_ffn, bias=False, device=device, dtype=dtype)
        self.fc2 = MojoGemm(dim_ffn, dim, bias=False, device=device, dtype=dtype)

    def forward(self, x):
        return self.fc2(self.fc1(x) * self.act(self.gate(x)))


class T5SelfAttention(nn.Module):
    def __init__(self, dim, dim_attn, dim_ffn, num_heads, num_buckets, shared_pos=True, dropout=0.1, *, device=None,
                 dtype=None):
        super().__init__()
        self.shared_pos = shared_pos
        self.norm1 = T5LayerNorm(dim, device=device)
        self.attn = T5Attention(dim, dim_attn, num_heads, dropout, device=device, dtype=dtype)
        self.norm2 = T5LayerNorm(dim, device=device)
        self.ffn = T5FeedForward(dim, dim_ffn, dropout, device=device, dtype=dtype)
        self.pos_embedding = (None if shared_pos
                              else MojoRelativeEmbedding(num_buckets, num_heads, bidirectional=True, device=device))

    def forward(self, x, mask=None, pos_bias=None):
        e = pos_bias if self.shared_pos else self.pos_embedding(x.shape[1], x.shape[1])
        x = fp16_clamp(x + self.attn(self.norm1(x), mask=mask, pos_bias=e))
        return fp16_clamp(x + self.ffn(self.norm2(x)))


class T5CrossAttention(nn.Module):
    def __init__(self, dim, dim_attn, dim_ffn, num_heads, num_buckets, shared_pos=True, dropout=0.1, *, device=None,
                 dtype=None):
        super().__init__()
        self.shared_pos = shared_pos
        self.norm1 = MojoRMSNorm(dim, eps=1e-6, device=device)
        self.self_attn = T5Attention(dim, dim_attn, num_heads, dropout, device=device, dtype=dtype)
        self.norm2 = MojoRMSNorm(dim, eps=1e-6, device=device)
        self.cross_attn = T5Attention(dim, dim_attn, num_heads, dropout, device=device, dtype=dtype)
        self.norm3 = MojoRMSNorm(dim, eps=1e-6, device=device)
        self.ffn = T5FeedForward(dim, dim_ffn, dropout, device=device, dtype=dtype)
        self.pos_embedding = (None if shared_pos
                              else MojoRelativeEmbedding(num_buckets, num_heads, bidirectional=False, device=device))

    def forward(self, x, mask=None, encoder_states=None, encoder_mask=None, pos_bias=None):
        e = pos_bias if self.shared_pos else self.pos_embedding(x.shape[1], x.shape[1])
        x = fp16_clamp(x + self.self_attn(self.norm1(x), mask=mask, pos_bias=e))
        x = fp16_clamp(x + self.cross_attn(self.norm2(x), context=encoder_states, mask=encoder_mask))
        return fp16_clamp(x + self.ffn(self.norm3(x)))


def _init(model: nn.Module, generator: Optional[torch.Generator]) -> None:
    if generator is not None:
        from mojo_opset_tpu_torch.utils.weights import init_random_

        init_random_(model, generator)


class T5Encoder(nn.Module):
    """``forward(ids (B, L), mask (B, L) or None)`` -> (B, L, dim) hidden
    states in the embedding's dtype. ``vocab`` is a vocabulary size or a
    ``MojoEmbedding`` to share."""

    def __init__(self, vocab, dim, dim_attn, dim_ffn, num_heads, num_layers, num_buckets, shared_pos=True,
                 dropout=0.1, *, device=None, dtype=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.shared_pos = shared_pos
        self.token_embedding = (vocab if isinstance(vocab, MojoEmbedding)
                                else MojoEmbedding(vocab, dim, device=device, dtype=dtype))
        self.pos_embedding = (MojoRelativeEmbedding(num_buckets, num_heads, bidirectional=True, device=device)
                              if shared_pos else None)
        self.blocks = nn.ModuleList(
            T5SelfAttention(dim, dim_attn, dim_ffn, num_heads, num_buckets, shared_pos, dropout, device=device,
                            dtype=dtype)
            for _ in range(num_layers))
        self.norm = T5LayerNorm(dim, device=device)
        _init(self, generator)

    def forward(self, ids, mask=None):
        x = self.token_embedding(ids)
        e = self.pos_embedding(x.shape[1], x.shape[1]) if self.shared_pos else None
        for block in self.blocks:
            x = block(x, mask, pos_bias=e)
        return self.norm(x)


class T5Decoder(nn.Module):
    """``forward(ids, mask, encoder_states, encoder_mask)``: causal
    self-attention (a (B, L) mask is combined with the causal one) and
    cross-attention to the encoder's states."""

    def __init__(self, vocab, dim, dim_attn, dim_ffn, num_heads, num_layers, num_buckets, shared_pos=True,
                 dropout=0.1, *, device=None, dtype=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.shared_pos = shared_pos
        self.token_embedding = (vocab if isinstance(vocab, MojoEmbedding)
                                else MojoEmbedding(vocab, dim, device=device, dtype=dtype))
        self.pos_embedding = (MojoRelativeEmbedding(num_buckets, num_heads, bidirectional=False, device=device)
                              if shared_pos else None)
        self.blocks = nn.ModuleList(
            T5CrossAttention(dim, dim_attn, dim_ffn, num_heads, num_buckets, shared_pos, dropout, device=device,
                             dtype=dtype)
            for _ in range(num_layers))
        self.norm = T5LayerNorm(dim, device=device)
        _init(self, generator)

    def forward(self, ids, mask=None, encoder_states=None, encoder_mask=None):
        b, s = ids.shape
        if mask is None:
            mask = torch.ones((1, s, s), device=ids.device).tril()
        elif mask.ndim == 2:
            mask = mask[:, None, :].expand(b, s, s).float().tril()
        x = self.token_embedding(ids)
        e = self.pos_embedding(x.shape[1], x.shape[1]) if self.shared_pos else None
        for block in self.blocks:
            x = block(x, mask, encoder_states, encoder_mask, pos_bias=e)
        return self.norm(x)


class T5Model(nn.Module):
    """Encoder-decoder with one shared token embedding and an untied head:
    ``forward(encoder_ids, encoder_mask, decoder_ids, decoder_mask)`` ->
    (B, Ld, vocab_size) logits."""

    def __init__(self, vocab_size, dim, dim_attn, dim_ffn, num_heads, encoder_layers, decoder_layers, num_buckets,
                 shared_pos=True, dropout=0.1, *, device=None, dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.vocab_size = vocab_size
        self.dim = dim
        self.token_embedding = MojoEmbedding(vocab_size, dim, device=device, dtype=dtype)
        self.encoder = T5Encoder(self.token_embedding, dim, dim_attn, dim_ffn, num_heads, encoder_layers, num_buckets,
                                 shared_pos, dropout, device=device, dtype=dtype)
        self.decoder = T5Decoder(self.token_embedding, dim, dim_attn, dim_ffn, num_heads, decoder_layers, num_buckets,
                                 shared_pos, dropout, device=device, dtype=dtype)
        self.head = MojoGemm(dim, vocab_size, bias=False, device=device, dtype=dtype)
        _init(self, generator)

    def forward(self, encoder_ids, encoder_mask, decoder_ids, decoder_mask):
        x = self.encoder(encoder_ids, encoder_mask)
        x = self.decoder(decoder_ids, decoder_mask, x, encoder_mask)
        return self.head(x)


def umt5_xxl_encoder(vocab_size: int = 256384, *, device=None, dtype=None,
                     generator: Optional[torch.Generator] = None, **overrides) -> T5Encoder:
    """The umT5-xxl encoder Wan2.2 uses (google/umt5-xxl, config.json): dim
    4096, ffn 10240, 64 heads, 24 layers, 32 buckets, a relative bias in
    every layer, vocabulary 256384; ``overrides`` replace any of them."""
    kwargs = dict(dim=4096, dim_attn=4096, dim_ffn=10240, num_heads=64, num_layers=24, num_buckets=32,
                  shared_pos=False, dropout=0.1)
    kwargs.update(overrides)
    return T5Encoder(vocab_size, device=device, dtype=dtype, generator=generator, **kwargs)


class T5EncoderModel:
    """Inference wrapper: encode pre-tokenized, padded ids under their mask
    and return each row cut to its mask's length (the caller tokenizes)."""

    def __init__(self, encoder: T5Encoder):
        self.encoder = encoder

    def __call__(self, ids: torch.Tensor, mask: torch.Tensor) -> List[torch.Tensor]:
        context = self.encoder(ids, mask)
        seq_lens = mask.to(torch.int32).sum(dim=1).tolist()
        return [context[i, :n] for i, n in enumerate(seq_lens)]
