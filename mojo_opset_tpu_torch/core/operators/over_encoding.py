"""Over-encoding: n-gram hashed token ids and their mega embeddings.

Counterpart of the JAX package's ``core/operators/over_encoding.py``
(``n_gram_ids`` :29, ``MojoOverEncodingNGram`` :59, the NF4 codebook and
helpers :106-147, ``MojoNF4DequantEmbedding`` :149, ``MojoOverEncoding``
:204).

The rolling modular hash runs in int64 on the ids' device; the per-step
multipliers ``ori_vocab_size ** i mod m`` are exact Python integers, as
the JAX op's carry chain on the host (:41-56). The varlen path reads
``q_lens`` on the host and hashes each sequence against its own history,
as the JAX op does. ``cpu_only`` and ``mega_embedding_cpu_only`` are hints
that move nothing (JAX :178): every table lies where it was given or
built.
"""

from __future__ import annotations

import itertools
from typing import List, Optional

import torch
from torch import nn

from mojo_opset_tpu_torch.core.operator import MojoOperator
from mojo_opset_tpu_torch.core.operators.embedding import MojoEmbedding
from mojo_opset_tpu_torch.core.operators.gemm import MojoGemm
from mojo_opset_tpu_torch.utils.platform import resolve_device


def n_gram_ids(
    input_ids: torch.Tensor,
    history: torch.Tensor,
    oe_vocab_sizes: List[int],
    oe_vocab_offsets: List[int],
    n_grams: List[int],
    ori_vocab_size: int,
) -> torch.Tensor:
    """int64 ids ``(..., S, num_grams)`` of each token's n-grams: for gram
    n with table size m, ``(id_t + sum_i id_{t-i} * (V^i mod m)) mod m``
    summed step by step, plus the table's offset; ``history`` (..., Hlen)
    holds the tokens before ``input_ids`` (..., S)."""
    ids = input_ids.long()
    complete = torch.cat([history.long().to(ids.device), ids], dim=-1)
    S, L = ids.shape[-1], complete.shape[-1]
    grams_out = []
    for gram_idx, gram in enumerate(n_grams):
        m = int(oe_vocab_sizes[gram_idx])
        gid = ids
        carry = ori_vocab_size
        for i in range(1, int(gram)):
            prev = complete[..., L - i - S: L - i]
            gid = (gid + prev * (carry % m)) % m
            carry = carry * ori_vocab_size % m
        grams_out.append(gid + int(oe_vocab_offsets[gram_idx]))
    return torch.stack(grams_out, dim=-1)


def _offsets(vocab_sizes: List[int]) -> List[int]:
    return [0, *itertools.accumulate(vocab_sizes[:-1])]


class MojoOverEncodingNGram(MojoOperator):
    def __init__(self, ori_vocab_size: int, oe_vocab_sizes: List[int], oe_grams: List[int]):
        super().__init__()
        self.ori_vocab_size = ori_vocab_size
        self.oe_vocab_sizes = [int(v) for v in oe_vocab_sizes]
        self.oe_grams = [int(g) for g in oe_grams]
        self.oe_vocab_offsets = _offsets(self.oe_vocab_sizes)

    def _ids(self, input_ids, history):
        return n_gram_ids(input_ids, history, self.oe_vocab_sizes, self.oe_vocab_offsets, self.oe_grams,
                          self.ori_vocab_size)

    def forward(self, input_ids: torch.Tensor, oe_history_input: torch.Tensor,
                q_lens: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, S) ids and (B, Hlen) histories, or packed (T,) ids with
        ``q_lens`` (B,) and one history row a sequence -> int64 ids with a
        trailing gram axis."""
        if q_lens is not None:
            if input_ids.ndim != 1 or oe_history_input.ndim != 2:
                raise ValueError("the varlen path takes (T,) ids and (B, Hlen) histories")
            parts, off = [], 0
            for i, n in enumerate(torch.as_tensor(q_lens).tolist()):
                parts.append(self._ids(input_ids[off: off + n], oe_history_input[i]))
                off += n
            return torch.cat(parts, dim=0)
        if input_ids.ndim != 2 or oe_history_input.ndim != 2 or oe_history_input.shape[0] != input_ids.shape[0]:
            raise ValueError(f"ids (B, S) need histories (B, Hlen), got {tuple(input_ids.shape)} and "
                             f"{tuple(oe_history_input.shape)}")
        return self._ids(input_ids, oe_history_input)

    def extra_repr(self) -> str:
        return (f"ori_vocab_size={self.ori_vocab_size}, oe_vocab_sizes={self.oe_vocab_sizes}, "
                f"oe_grams={self.oe_grams}")


# -- NF4 ---------------------------------------------------------------

NF4_CODEBOOK = (
    -1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
    -0.28444138169288635, -0.18477343022823334, -0.09105003625154495, 0.0,
    0.07958029955625534, 0.16093020141124725, 0.24611230194568634,
    0.33791524171829224, 0.44070982933044434, 0.5626170039176941,
    0.7229568362236023, 1.0,
)


def get_nf4_codebook(dtype=torch.float16, device=None) -> torch.Tensor:
    return torch.tensor(NF4_CODEBOOK, dtype=dtype, device=device)


def unpack_nf4_int8_to_uint4(packed: torch.Tensor) -> torch.Tensor:
    """(R, C) bytes -> (R, 2C) 4-bit codes, the low nibble first."""
    if packed.ndim != 2:
        raise ValueError(f"`packed` must be 2D, got shape={tuple(packed.shape)}")
    q = packed.to(torch.uint8)
    return torch.stack([q & 0x0F, (q >> 4) & 0x0F], dim=-1).reshape(packed.shape[0], packed.shape[1] * 2)


def dequantize_nf4_rows(
    nf4_qweight: torch.Tensor,
    nf4_scale: torch.Tensor,
    nf4_mean: torch.Tensor,
    *,
    group_size: int,
    codebook: Optional[torch.Tensor] = None,
    output_dtype=torch.bfloat16,
) -> torch.Tensor:
    """``codebook[code] * scale + mean`` per group of ``group_size`` lanes,
    in fp32, cast to ``output_dtype``."""
    num_rows, num_groups = nf4_scale.shape
    embedding_dim = num_groups * group_size
    if tuple(nf4_qweight.shape) != (num_rows, embedding_dim // 2):
        raise ValueError(f"qweight {tuple(nf4_qweight.shape)} does not pack ({num_rows}, {embedding_dim})")
    if codebook is None:
        codebook = get_nf4_codebook(device=nf4_qweight.device)
    q_idx = unpack_nf4_int8_to_uint4(nf4_qweight).reshape(num_rows, num_groups, group_size).long()
    values = codebook[q_idx].float()
    out = values * nf4_scale.float()[..., None] + nf4_mean.float()[..., None]
    return out.reshape(num_rows, embedding_dim).to(output_dtype)


class MojoNF4DequantEmbedding(MojoOperator):
    """NF4-packed embedding ``(rows, dim / 2)`` bytes with per-group scale
    and mean ``(rows, dim / group_size)``, dequantized on lookup. Ids are
    taken relative to ``vocab_start_id``; ids outside the table give zero
    rows. The tensors stay on the device they come on; ``cpu_only`` is a
    hint that moves nothing."""

    def __init__(self, qweight: torch.Tensor, scale: torch.Tensor, mean: torch.Tensor, *, group_size: int,
                 vocab_start_id: int = 0, cpu_only: bool = False, output_dtype=torch.bfloat16):
        super().__init__()
        if qweight.ndim != 2 or scale.ndim != 2 or mean.ndim != 2:
            raise ValueError("NF4 embedding tensors must all be 2D")
        if scale.shape != mean.shape:
            raise ValueError("`scale` and `mean` must have the same shape")
        if group_size <= 0:
            raise ValueError(f"`group_size` must be > 0, got {group_size}")
        self.embedding_dim = scale.shape[1] * group_size
        if qweight.shape[1] * 2 != self.embedding_dim:
            raise ValueError("`qweight` incompatible with `scale`/group_size")
        self.group_size = group_size
        self.output_dtype = output_dtype if output_dtype is not None else torch.bfloat16
        self.vocab_start_id = vocab_start_id
        self.cpu_only = cpu_only
        self.weight = nn.Parameter(qweight, requires_grad=False)
        self.scale = nn.Parameter(scale, requires_grad=False)
        self.mean = nn.Parameter(mean, requires_grad=False)
        self.register_buffer("codebook", get_nf4_codebook(device=qweight.device), persistent=False)

    def forward(self, input: torch.Tensor) -> torch.Tensor:
        local = input.reshape(-1).long() - self.vocab_start_id
        n = self.weight.shape[0]
        valid = (local >= 0) & (local < n)
        safe = local.clamp(0, n - 1)
        rows = dequantize_nf4_rows(self.weight[safe], self.scale[safe], self.mean[safe], group_size=self.group_size,
                                   codebook=self.codebook, output_dtype=self.output_dtype)
        rows = torch.where(valid[:, None], rows, torch.zeros((), dtype=rows.dtype, device=rows.device))
        return rows.reshape(*input.shape, self.embedding_dim)

    def extra_repr(self) -> str:
        return (f"embedding_dim={self.embedding_dim}, group_size={self.group_size}, "
                f"vocab_start_id={self.vocab_start_id}, output_dtype={self.output_dtype}")


class MojoOverEncoding(MojoOperator):
    """Over-tokenized embedding: the token's own embedding beside its
    n-grams' mega-table rows, concatenated and projected back by
    ``oe_up_proj`` (no bias). The mega table is dense ``(sum(oe_vocab_sizes),
    oe_embed_dim)``, or NF4 when weight, scale and mean are all given.
    Weights not given are drawn like the JAX op's (embeddings N(0, 1), the
    projection U(+-1/sqrt(in))) from ``generator``, on ``device``: the card
    unless another is named."""

    def __init__(
        self,
        ori_vocab_size: int,
        ori_embed_dim: int,
        oe_embed_dim: int,
        oe_vocab_sizes: List[int],
        oe_grams: List[int],
        _ori_embedding_weight: Optional[torch.Tensor] = None,
        _mega_embedding_weight: Optional[torch.Tensor] = None,
        _mega_embedding_scale: Optional[torch.Tensor] = None,
        _mega_embedding_mean: Optional[torch.Tensor] = None,
        _mega_embedding_group_size: int = 1,
        _mega_embedding_vocab_start_id: int = 0,
        mega_embedding_cpu_only: bool = False,
        *,
        device=None,
        dtype=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        device = resolve_device(device)
        self.ori_vocab_size = ori_vocab_size
        self.ori_embed_dim = ori_embed_dim
        self.oe_embed_dim = oe_embed_dim
        self.oe_vocab_sizes = [int(v) for v in oe_vocab_sizes]
        self.oe_grams = [int(g) for g in oe_grams]
        self.oe_vocab_offsets = _offsets(self.oe_vocab_sizes)
        self.mega_embedding_cpu_only = mega_embedding_cpu_only
        nf4_dtype, dtype = dtype, dtype or torch.float32  # as JAX: no dtype gives fp32 tables, a bf16 NF4 output

        self.ori_embedding = MojoEmbedding(ori_vocab_size, ori_embed_dim, device=device, dtype=dtype)
        nf4 = all(t is not None for t in (_mega_embedding_weight, _mega_embedding_scale, _mega_embedding_mean))
        if nf4:
            self.oe_mega_embedding = MojoNF4DequantEmbedding(
                _mega_embedding_weight, _mega_embedding_scale, _mega_embedding_mean,
                group_size=_mega_embedding_group_size, vocab_start_id=_mega_embedding_vocab_start_id,
                cpu_only=mega_embedding_cpu_only, output_dtype=nf4_dtype)
        else:
            self.oe_mega_embedding = MojoEmbedding(sum(self.oe_vocab_sizes), oe_embed_dim, device=device, dtype=dtype)
        self.oe_up_proj = MojoGemm(len(self.oe_vocab_sizes) * oe_embed_dim + ori_embed_dim, ori_embed_dim,
                                   bias=False, device=device, dtype=dtype)
        self.ngram = MojoOverEncodingNGram(ori_vocab_size, self.oe_vocab_sizes, self.oe_grams)
        for module in (self.ori_embedding, self.oe_up_proj, *(() if nf4 else (self.oe_mega_embedding,))):
            module.reset_parameters(generator=generator)
        with torch.no_grad():
            if _ori_embedding_weight is not None:
                self.ori_embedding.weight.copy_(_ori_embedding_weight)
            if _mega_embedding_weight is not None and not nf4:
                self.oe_mega_embedding.weight.copy_(_mega_embedding_weight)

    def forward(self, input_tensor: torch.Tensor, oe_history_input: torch.Tensor,
                q_lens: Optional[torch.Tensor] = None) -> torch.Tensor:
        oe_ids = self.ngram(input_tensor, oe_history_input, q_lens)  # (..., G)
        oe_result = self.oe_mega_embedding(oe_ids)  # (..., G, oe_dim)
        wte_result = self.ori_embedding(input_tensor)
        concat = torch.cat([wte_result, oe_result.reshape(*oe_result.shape[:-2], -1).to(wte_result.dtype)], dim=-1)
        return self.oe_up_proj(concat)

    def extra_repr(self) -> str:
        return (f"ori_vocab_size={self.ori_vocab_size}, ori_embed_dim={self.ori_embed_dim}, "
                f"oe_embed_dim={self.oe_embed_dim}, oe_vocab_sizes={self.oe_vocab_sizes}, "
                f"oe_grams={self.oe_grams}, mega_embedding_cpu_only={self.mega_embedding_cpu_only}")
