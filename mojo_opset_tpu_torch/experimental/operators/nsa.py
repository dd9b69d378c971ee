"""Native Sparse Attention (NSA): three branches mixed by a per-head gate.

Counterpart of the JAX package's ``experimental/operators/nsa.py`` (helpers
:35-85, ``_NSAMixin`` :87 with the short-context fallback :101-107,
``MojoDecodeNSA`` :136, ``MojoPagedDecodeNSA`` :159, ``MojoPrefillNSA``
:193, ``MojoPagedPrefillNSA`` :217).

Each query row attends (1) the context mean-pooled in blocks of
``compress_ratio`` keys, (2) the ``num_selected_blocks`` blocks of
``block_size`` keys with the largest compressed attention, and (3) its
last ``window_size`` keys; ``sigmoid(q . gate_proj)`` (H, 3) mixes them.
A context shorter than one compression block attends its raw keys in the
compressed branch (JAX :101-107).

The goldens walk the sequences (and, in the prefills, the query rows) on
the host, reading the lengths and tables once, as the JAX goldens do. The
block selection runs on the tensors' device: a stable descending sort of
the block scores, the first ``num_selected_blocks`` kept. JAX sorts on the
host with ``np.argsort``; the sets agree wherever the cut falls between
unequal scores. Only one block can score exactly 0 (a trailing block with
fewer than ``compress_ratio`` keys holds no compressed key), so an exact
tie at the cut needs two equal softmax sums, which continuous data does not
give; should one occur, the lower block index wins here.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from mojo_opset_tpu_torch.core.operator import MojoOperator
from mojo_opset_tpu_torch.core.operators.attention import (
    assert_paged_decode_contract,
    assert_paged_prefill_contract,
    seq_lens_from_cu,
)
from mojo_opset_tpu_torch.utils.platform import resolve_device


def nsa_compress_kv(k: torch.Tensor, v: torch.Tensor, compress_ratio: int):
    """Mean-pool (S, H, D) keys and values in blocks of ``compress_ratio``
    (a trailing partial block dropped)."""
    S, H, D = k.shape
    n = (S // compress_ratio) * compress_ratio
    return (k[:n].reshape(-1, compress_ratio, H, D).mean(dim=1), v[:n].reshape(-1, compress_ratio, H, D).mean(dim=1))


def nsa_select_blocks(query: torch.Tensor, comp_k: torch.Tensor, sl: int, softmax_scale: float, compress_ratio: int,
                      block_size: int, num_selected_blocks: int) -> torch.Tensor:
    """(H, sl) keep-mask of each head's selected blocks: block b scores the
    sum of the softmaxed compressed scores over its ``block_size //
    compress_ratio`` compressed keys (0 where it holds none), and the
    ``min(num_selected_blocks, ceil(sl / block_size))`` best blocks are
    kept, ties to the lower index."""
    H = query.shape[0]
    C = comp_k.shape[0]
    qk = torch.softmax(torch.einsum("hd,chd->hc", query.float(), comp_k.float()) * softmax_scale, dim=-1)
    per_block = block_size // compress_ratio
    num_blocks = math.ceil(sl / block_size)
    if per_block == 0:
        block_score = torch.zeros((H, num_blocks), device=query.device)
    else:
        width = num_blocks * per_block
        qk = qk[:, :width] if C >= width else torch.nn.functional.pad(qk, (0, width - C))
        block_score = qk.reshape(H, num_blocks, per_block).sum(dim=-1)
    num_sel = min(num_selected_blocks, num_blocks)
    top = torch.sort(block_score, dim=-1, descending=True, stable=True).indices[:, :num_sel]
    selected = torch.zeros((H, num_blocks), dtype=torch.bool, device=query.device).scatter_(1, top, True)
    return selected[:, torch.arange(sl, device=query.device) // block_size]


def nsa_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, softmax_scale: float,
               mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q (Tq, H, D) over k/v (Tk, H, D), ``mask`` (H, Tk) True = keep: fp32
    softmax (a fully masked row 0), probabilities cast to q's dtype."""
    scores = torch.einsum("thd,shd->ths", q.float(), k.float()) * softmax_scale
    if mask is not None:
        scores = scores.masked_fill(~mask[None], float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    if mask is not None:
        probs = torch.nan_to_num(probs, nan=0.0)
    return torch.einsum("ths,shd->thd", probs.to(q.dtype), v)


def nsa_gate(query: torch.Tensor, gate_proj: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(torch.einsum("...hd,hdc->...hc", query.float(), gate_proj.float()))


def _paged_keys(cache: torch.Tensor, table_row: list, kv_len: int) -> torch.Tensor:
    """A sequence's first ``kv_len`` keys (kv_len, H, D) from HND pages,
    its table cut at the first -1 (which must not wrap to the last block)."""
    blk = cache.shape[2]
    bids = table_row[: -(-kv_len // blk)]
    bids = bids[: next((j for j, b in enumerate(bids) if b < 0), len(bids))]
    idx = torch.tensor(bids, dtype=torch.long, device=cache.device)
    return cache[idx].transpose(1, 2).reshape(-1, cache.shape[1], cache.shape[3])[:kv_len]


class _NSAMixin:
    def _init_nsa(self, num_heads, head_dim, compress_ratio, num_selected_blocks, block_size, window_size,
                  is_causal, device, generator):
        self.num_heads = num_heads
        self.head_dim = head_dim
        self.compress_ratio = compress_ratio
        self.num_selected_blocks = num_selected_blocks
        self.block_size = block_size
        self.window_size = window_size
        self.is_causal = is_causal
        self.gate_proj = nn.Parameter(torch.empty((num_heads, head_dim, 3), device=resolve_device(device)),
                                      requires_grad=False)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """``gate_proj`` from N(0, 0.02), fp32, as the JAX op draws it."""
        self.gate_proj.normal_(0.0, 0.02, generator=generator)

    def _decode_core(self, q_i, k_i, v_i, sl, softmax_scale):
        """One query row q_i (H, D) over its first ``sl`` keys (sl, H, D)."""
        if sl <= 0:
            return torch.zeros_like(q_i)
        if sl >= self.compress_ratio:
            comp_k, comp_v = nsa_compress_kv(k_i, v_i, self.compress_ratio)
        else:  # the short-context fallback: the raw keys (pooling would leave none)
            comp_k, comp_v = k_i[:sl], v_i[:sl]
        sel_mask = nsa_select_blocks(q_i, comp_k, sl, softmax_scale, self.compress_ratio, self.block_size,
                                     self.num_selected_blocks)
        start = max(0, sl - self.window_size)
        q_u = q_i[None]
        out_comp = nsa_attend(q_u, comp_k, comp_v, softmax_scale)[0]
        out_sel = nsa_attend(q_u, k_i, v_i, softmax_scale, mask=sel_mask)[0]
        out_win = nsa_attend(q_u, k_i[start:sl], v_i[start:sl], softmax_scale)[0]
        g = nsa_gate(q_i, self.gate_proj)  # (H, 3)
        out = g[..., 0:1] * out_comp + g[..., 1:2] * out_sel + g[..., 2:3] * out_win
        return out.to(q_i.dtype)

    def extra_repr(self) -> str:
        return (f"num_heads={self.num_heads}, head_dim={self.head_dim}, compress_ratio={self.compress_ratio}, "
                f"num_selected_blocks={self.num_selected_blocks}, block_size={self.block_size}, "
                f"window_size={self.window_size}, is_causal={self.is_causal}")


class MojoDecodeNSA(_NSAMixin, MojoOperator):
    def __init__(self, num_heads, head_dim, compress_ratio=4, num_selected_blocks=16, block_size=64, window_size=512,
                 is_causal=True, *, device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self._init_nsa(num_heads, head_dim, compress_ratio, num_selected_blocks, block_size, window_size, is_causal,
                       device, generator)

    def forward(self, query, key, value, total_seq_lens=None, softmax_scale=None):
        """q (B, H, D) over dense k/v (B, S, H, D), each row its first
        ``total_seq_lens[b]`` keys (all S without lengths)."""
        B, H, D = query.shape
        S = key.shape[1]
        if softmax_scale is None:
            softmax_scale = 1.0 / math.sqrt(D)
        lens = [S] * B if total_seq_lens is None else torch.as_tensor(total_seq_lens).tolist()
        return torch.stack([self._decode_core(query[i], key[i, :sl], value[i, :sl], sl, softmax_scale)
                            for i, sl in enumerate(lens)])


class MojoPagedDecodeNSA(_NSAMixin, MojoOperator):
    def __init__(self, num_heads, head_dim, compress_ratio=4, num_selected_blocks=16, block_size=64, window_size=512,
                 is_causal=True, *, device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self._init_nsa(num_heads, head_dim, compress_ratio, num_selected_blocks, block_size, window_size, is_causal,
                       device, generator)

    def forward(self, query, key_cache, value_cache, total_seq_lens, block_tables, softmax_scale=None):
        """q (B, H, D) over HND pages (N, H, bs, D)."""
        assert_paged_decode_contract(block_tables, total_seq_lens)
        B, H, D = query.shape
        if softmax_scale is None:
            softmax_scale = 1.0 / math.sqrt(D)
        lens, table = total_seq_lens.tolist(), block_tables.tolist()
        outs = []
        for i, sl in enumerate(lens):
            if sl <= 0:
                outs.append(torch.zeros_like(query[i]))
                continue
            if table[i][0] < 0:
                raise ValueError("Paged decode requires a valid block table for rows with kv lens > 0.")
            k_i, v_i = (_paged_keys(c, table[i], sl) for c in (key_cache, value_cache))
            outs.append(self._decode_core(query[i], k_i, v_i, sl, softmax_scale))
        return torch.stack(outs)


class MojoPrefillNSA(_NSAMixin, MojoOperator):
    def __init__(self, num_heads, head_dim, compress_ratio=4, num_selected_blocks=16, block_size=64, window_size=512,
                 is_causal=True, *, device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self._init_nsa(num_heads, head_dim, compress_ratio, num_selected_blocks, block_size, window_size, is_causal,
                       device, generator)

    def forward(self, query, key, value, cu_q_lens, softmax_scale=None):
        """Packed q/k/v (T, H, D); row t of a sequence sees its first t + 1
        keys (causal) or all of them."""
        if cu_q_lens.dtype != torch.int32:
            raise ValueError(f"cu_q_lens must be int32, got {cu_q_lens.dtype}")
        T, H, D = query.shape
        if softmax_scale is None:
            softmax_scale = 1.0 / math.sqrt(D)
        cu = cu_q_lens.tolist()
        out = torch.zeros_like(query)
        for s, e in zip(cu[:-1], cu[1:]):
            for t in range(e - s):
                t_sl = t + 1 if self.is_causal else e - s
                out[s + t] = self._decode_core(query[s + t], key[s: s + t_sl], value[s: s + t_sl], t_sl,
                                               softmax_scale)
        return out


class MojoPagedPrefillNSA(_NSAMixin, MojoOperator):
    def __init__(self, num_heads, head_dim, compress_ratio=4, num_selected_blocks=16, block_size=64, window_size=512,
                 is_causal=True, *, device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self._init_nsa(num_heads, head_dim, compress_ratio, num_selected_blocks, block_size, window_size, is_causal,
                       device, generator)

    def forward(self, query, key_cache, value_cache, cu_q_lens, block_tables, softmax_scale=None,
                cu_total_seq_lens=None):
        """Packed q (T, H, D) over HND pages; row t of a sequence with q_len
        rows and kv_len keys sees its first ``kv_len - q_len + t + 1`` keys
        (causal) or all of them."""
        assert_paged_prefill_contract(cu_q_lens, block_tables, cu_total_seq_lens)
        T, H, D = query.shape
        if softmax_scale is None:
            softmax_scale = 1.0 / math.sqrt(D)
        cu = cu_q_lens.tolist()
        kv_lens = seq_lens_from_cu(cu_q_lens if cu_total_seq_lens is None else cu_total_seq_lens).tolist()
        table = block_tables.tolist()
        out = torch.zeros_like(query)
        for i, kv_len in enumerate(kv_lens):
            qs, qe = cu[i], cu[i + 1]
            q_len = qe - qs
            if q_len == 0 or kv_len <= 0:
                continue
            if table[i][0] < 0:
                raise ValueError("Paged prefill requires a valid block table for rows with kv lens > 0.")
            k_seq, v_seq = (_paged_keys(c, table[i], kv_len) for c in (key_cache, value_cache))
            for t in range(q_len):
                t_kv = kv_len - q_len + t + 1 if self.is_causal else kv_len
                out[qs + t] = self._decode_core(query[qs + t], k_seq[:t_kv], v_seq[:t_kv], t_kv, softmax_scale)
        return out
