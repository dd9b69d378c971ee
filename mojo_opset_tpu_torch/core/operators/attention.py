"""GQA attention: paged varlen prefill and one-token decode, and the dense
ops of the training path (decode, padded prefill, SDPA, packed varlen SWA).

Counterpart of the JAX package's ``core/operators/attention.py`` (helpers
:51-151, ``window_mask_rows`` :113, ``MojoDecodeGQA`` :154,
``MojoPagedDecodeGQA`` :198, ``MojoPrefillGQA`` :272,
``MojoPagedPrefillGQA`` :308, ``MojoSdpa`` :401, ``_SWAConfigMixin``
:440, ``MojoPagedPrefillSWA`` :471, ``MojoPagedDecodeSWA`` :532, ``MojoSWA`` :575).

Shape contracts (identical to the JAX package):
  * paged caches: HND ``(n_blocks, n_kv_heads, block_size, head_dim)`` or
    NHD ``(n_blocks, block_size, n_kv_heads, head_dim)``
  * ``cu_q_lens`` / ``total_seq_lens`` / ``block_tables``: int32, one
    table row per sequence (``assert_paged_*_contract``, :33-48 there;
    here they raise ``ValueError``)
  * GQA layouts: ``AABB`` (repeat_interleave) vs ``ABAB`` (tiled repeat)
  * softmax in fp32, probabilities cast back to the input dtype.

The decode golden is the JAX one, vectorized over the batch. The prefill
golden loops over sequences on the host (it reads ``cu_q_lens`` back):
the JAX golden's per-token gather of every sequence's keys is
``T * K * Hq * D`` elements, 14 GB per layer at a 1650-token batch of
Qwen3-4B. The dense goldens are the JAX ones, vectorized with masks.

Custom masks (``mask``, read only when ``is_causal`` is False) keep the JAX
ops' two contracts, which deliberately differ (JAX :243-262, :378-391):
the decode reads row ``total_seq_len`` of a 2-D ``(rows, Tm)`` or per-batch
3-D ``(B, rows, Tm)`` mask with True = EXCLUDE; the prefill reads rows
``q_abs`` (each query row's absolute position) with True = KEEP. Columns
past ``Tm`` count as False in both (the decode keeps them, the prefill
drops them). ``MojoPagedPrefillSWA`` (JAX :471) is the prefill with
``window_mask_rows`` on absolute positions.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from mojo_opset_tpu_torch.core.operator import MojoOperator
from mojo_opset_tpu_torch.core.operators.kv_cache import KV_LAYOUTS

GQA_LAYOUTS = ("AABB", "ABAB")


def _require_int32(name: str, t: torch.Tensor) -> None:
    if t.dtype != torch.int32:
        raise ValueError(f"{name} must be int32, got {t.dtype}")


def assert_paged_prefill_contract(
    cu_q_lens: torch.Tensor, block_tables: torch.Tensor, cu_total_seq_lens: Optional[torch.Tensor]
) -> None:
    """int32 ``cu_q_lens``/``block_tables``/``cu_total_seq_lens``, a 2-D
    table with one row per sequence."""
    _require_int32("cu_q_lens", cu_q_lens)
    _require_int32("block_tables", block_tables)
    if block_tables.ndim != 2 or block_tables.shape[0] != cu_q_lens.shape[0] - 1:
        raise ValueError(
            f"block_tables must be 2-D with one row per sequence ({cu_q_lens.shape[0] - 1}), "
            f"got {tuple(block_tables.shape)}"
        )
    if cu_total_seq_lens is not None:
        _require_int32("cu_total_seq_lens", cu_total_seq_lens)
        if cu_total_seq_lens.shape != cu_q_lens.shape:
            raise ValueError(
                f"cu_total_seq_lens must match cu_q_lens {tuple(cu_q_lens.shape)}, "
                f"got {tuple(cu_total_seq_lens.shape)}"
            )


def assert_paged_decode_contract(block_tables: torch.Tensor, total_seq_lens: torch.Tensor) -> None:
    """int32 ``block_tables``/``total_seq_lens``, a 2-D table with one row
    per sequence."""
    _require_int32("block_tables", block_tables)
    _require_int32("total_seq_lens", total_seq_lens)
    if block_tables.ndim != 2 or block_tables.shape[0] != total_seq_lens.shape[0]:
        raise ValueError(
            f"block_tables must be 2-D with one row per sequence ({total_seq_lens.shape[0]}), "
            f"got {tuple(block_tables.shape)}"
        )


def seq_lens_from_cu(cu_seqlens: torch.Tensor) -> torch.Tensor:
    return cu_seqlens[1:] - cu_seqlens[:-1]


def expand_gqa(kv: torch.Tensor, group: int, layout: str, head_axis: int) -> torch.Tensor:
    """Expand KV heads to match query heads.

    ``AABB`` repeats each head ``group`` times contiguously
    (repeat_interleave); ``ABAB`` tiles the whole head block.
    """
    if group == 1:
        return kv
    if layout == "AABB":
        return kv.repeat_interleave(group, dim=head_axis)
    reps = [1] * kv.ndim
    reps[head_axis] = group
    return kv.repeat(*reps)


def paged_cache_dims(cache: torch.Tensor, kv_layout: str = "HND"):
    """Normalize paged-cache dims to ``(N_blocks, Hkv, block_size, D)``."""
    if kv_layout == "HND":
        n, hkv, bs, d = cache.shape
    elif kv_layout == "NHD":
        n, bs, hkv, d = cache.shape
    else:
        raise ValueError(f"kv_layout must be one of {KV_LAYOUTS}, got {kv_layout}")
    return n, hkv, bs, d


def gather_paged_kv(cache: torch.Tensor, block_tables: torch.Tensor, kv_layout: str = "HND") -> torch.Tensor:
    """Gather a paged cache into dense per-sequence KV.

    block_tables ``(B, NB)`` -> ``(B, NB*bs, Hkv, D)``; invalid block ids
    are clamped to block 0 and callers mask by sequence length.
    """
    gathered = cache[block_tables.clamp(0, cache.shape[0] - 1).long()]
    if kv_layout == "HND":
        gathered = gathered.transpose(2, 3)  # (B, NB, bs, Hkv, D)
    b, nb, bs, hkv, d = gathered.shape
    return gathered.reshape(b, nb * bs, hkv, d)


def masked_softmax(scores: torch.Tensor, mask: torch.Tensor, out_dtype) -> torch.Tensor:
    """fp32 softmax over the last axis with a boolean keep-mask; fully
    masked rows give zeros."""
    scores = scores.masked_fill(~mask, float("-inf"))
    m = scores.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isneginf(m), 0.0, m)
    p = torch.exp(scores - m)
    denom = p.sum(dim=-1, keepdim=True)
    probs = torch.where(denom > 0, p / denom.clamp(min=1e-38), 0.0)
    return probs.to(out_dtype)


def _check_layouts(gqa_layout: str, kv_layout: str) -> None:
    if gqa_layout not in GQA_LAYOUTS:
        raise ValueError(f"gqa_layout must be one of {GQA_LAYOUTS}, got {gqa_layout}")
    if kv_layout not in KV_LAYOUTS:
        raise ValueError(f"kv_layout must be one of {KV_LAYOUTS}, got {kv_layout}")


def _mask_columns(rows: torch.Tensor, width: int) -> torch.Tensor:
    """Bool mask rows cut or padded with False to ``width`` columns."""
    rows = rows.bool()[..., :width]
    if rows.shape[-1] < width:
        rows = torch.nn.functional.pad(rows, (0, width - rows.shape[-1]), value=False)
    return rows


def decode_mask_rows(mask: torch.Tensor, total_seq_lens: torch.Tensor, K: int) -> torch.Tensor:
    """(B, K) keys the decode's custom mask EXCLUDES: row ``total_seq_lens``
    (clamped to the mask's rows) of a 2-D mask, or of each batch's mask
    (JAX :243-262)."""
    if mask.ndim == 2:
        rows = mask[total_seq_lens.clamp(0, mask.shape[0] - 1).long()]
    else:
        batch = torch.arange(mask.shape[0], device=mask.device)
        rows = mask[batch, total_seq_lens.clamp(0, mask.shape[1] - 1).long()]
    return _mask_columns(rows, K)


def decode_keep_mask(total_seq_lens: torch.Tensor, K: int, local_window_size: Optional[int],
                     global_window_size: Optional[int], mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, K) keys a decode row sees: its first ``total_seq_lens`` keys and,
    with a window, ``window_mask_rows`` of them for the row at
    ``total_seq_lens - 1``; with a custom ``mask``, none it excludes."""
    kv_pos = torch.arange(K, dtype=torch.int32, device=total_seq_lens.device)
    keep = kv_pos[None, :] < total_seq_lens[:, None]
    if local_window_size is not None or global_window_size is not None:
        keep = keep & window_mask_rows((total_seq_lens - 1)[:, None], kv_pos[None, :], local_window_size,
                                       global_window_size)[:, 0, :]
    if mask is not None:
        keep = keep & ~decode_mask_rows(mask.to(keep.device), total_seq_lens, K)
    return keep


def paged_decode_reference(
    query: torch.Tensor,
    key_cache: torch.Tensor,
    value_cache: torch.Tensor,
    total_seq_lens: torch.Tensor,
    block_tables: torch.Tensor,
    softmax_scale: Optional[float],
    gqa_layout: str,
    kv_layout: str,
    local_window_size: Optional[int] = None,
    global_window_size: Optional[int] = None,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Golden paged decode: gather the pages, expand GQA, fp32 softmax.
    With a window, the query row at ``total_seq_lens - 1`` keeps
    ``window_mask_rows`` of its keys (JAX ``MojoPagedDecodeSWA`` :532); a
    custom ``mask`` excludes the keys ``decode_mask_rows`` names."""
    assert_paged_decode_contract(block_tables, total_seq_lens)
    B, Hq, D = query.shape
    _, Hkv, _, _ = paged_cache_dims(key_cache, kv_layout)
    group = Hq // Hkv
    if softmax_scale is None:
        softmax_scale = 1.0 / math.sqrt(D)

    k = expand_gqa(gather_paged_kv(key_cache, block_tables, kv_layout), group, gqa_layout, 2)
    v = expand_gqa(gather_paged_kv(value_cache, block_tables, kv_layout), group, gqa_layout, 2)
    K = k.shape[1]

    scores = torch.einsum("bhd,bkhd->bhk", query.float(), k.float()) * softmax_scale
    valid = decode_keep_mask(total_seq_lens, K, local_window_size, global_window_size, mask)[:, None, :]
    probs = masked_softmax(scores, valid, query.dtype)
    out = torch.einsum("bhk,bkhd->bhd", probs, v.to(query.dtype))
    out = torch.where((total_seq_lens > 0)[:, None, None], out, 0)
    return out.to(query.dtype)


def prefill_sequences(
    key_cache: torch.Tensor,
    value_cache: torch.Tensor,
    cu_q_lens: torch.Tensor,
    block_tables: torch.Tensor,
    cu_total_seq_lens: Optional[torch.Tensor],
    kv_layout: str,
    is_causal: bool = True,
    mask: Optional[torch.Tensor] = None,
    local_window_size: Optional[int] = None,
    global_window_size: Optional[int] = None,
):
    """The golden prefill's walk over sequences that have query and KV
    tokens: yields ``(q0, q1, k, v, keep)`` with k/v ``(kv_len, Hkv, D)``
    gathered from the pages and the keep-mask ``(q1 - q0, kv_len)``.

    Query row i of sequence b sits at absolute position
    ``q_abs = kv_len[b] - q_len[b] + i`` and (causal) sees
    ``window_mask_rows`` of the keys (without a window: those at positions
    <= it); non-causal, every key, or with a custom ``mask`` the columns of
    its rows ``q_abs`` (2-D, or batch b's of a 3-D mask) that are True.
    """
    _, _, bs, _ = paged_cache_dims(key_cache, kv_layout)
    cu = cu_q_lens.tolist()
    kv_lens = seq_lens_from_cu(cu_q_lens if cu_total_seq_lens is None else cu_total_seq_lens).tolist()
    mask = None if mask is None else mask.to(key_cache.device)
    for b, kv_len in enumerate(kv_lens):
        q0, q1 = cu[b], cu[b + 1]
        if q1 <= q0 or kv_len <= 0:
            continue
        table = block_tables[b : b + 1, : -(-kv_len // bs)]
        k = gather_paged_kv(key_cache, table, kv_layout)[0, :kv_len]
        v = gather_paged_kv(value_cache, table, kv_layout)[0, :kv_len]
        kv_pos = torch.arange(kv_len, device=key_cache.device)
        q_abs = kv_len - (q1 - q0) + torch.arange(q1 - q0, device=key_cache.device)
        if is_causal:
            keep = window_mask_rows(q_abs, kv_pos, local_window_size, global_window_size)
        elif mask is not None:
            rows = q_abs.clamp(0, mask.shape[-2] - 1)
            keep = _mask_columns(mask[rows] if mask.ndim == 2 else mask[b, rows], kv_len)
        else:
            keep = torch.ones((q1 - q0, kv_len), dtype=torch.bool, device=key_cache.device)
        yield q0, q1, k, v, keep


def paged_prefill_reference(
    query: torch.Tensor,
    key_cache: torch.Tensor,
    value_cache: torch.Tensor,
    cu_q_lens: torch.Tensor,
    block_tables: torch.Tensor,
    softmax_scale: Optional[float],
    cu_total_seq_lens: Optional[torch.Tensor],
    gqa_layout: str,
    kv_layout: str,
    is_causal: bool = True,
    mask: Optional[torch.Tensor] = None,
    local_window_size: Optional[int] = None,
    global_window_size: Optional[int] = None,
) -> torch.Tensor:
    """Golden varlen paged prefill, one sequence at a time
    (``prefill_sequences``, which reads the mask and the windows)."""
    assert_paged_prefill_contract(cu_q_lens, block_tables, cu_total_seq_lens)
    T, Hq, D = query.shape
    _, Hkv, _, _ = paged_cache_dims(key_cache, kv_layout)
    group = Hq // Hkv
    if softmax_scale is None:
        softmax_scale = 1.0 / math.sqrt(D)

    out = torch.zeros_like(query)
    for q0, q1, k, v, keep in prefill_sequences(
        key_cache, value_cache, cu_q_lens, block_tables, cu_total_seq_lens, kv_layout, is_causal, mask,
        local_window_size, global_window_size,
    ):
        k = expand_gqa(k, group, gqa_layout, 1)  # (K, Hq, D)
        v = expand_gqa(v, group, gqa_layout, 1)
        scores = torch.einsum("qhd,khd->hqk", query[q0:q1].float(), k.float()) * softmax_scale
        probs = masked_softmax(scores, keep[None], query.dtype)
        out[q0:q1] = torch.einsum("hqk,khd->qhd", probs, v.to(query.dtype))
    return out


class MojoPagedDecodeGQA(MojoOperator):
    """Paged decode GQA: q (B, Hq, D), one token per sequence, over a
    blocked KV cache. ``total_seq_lens`` counts the new token. A non-causal
    call reads ``mask`` (the decode contract: True = exclude)."""

    def __init__(self, is_causal: bool = True, gqa_layout: str = "AABB", kv_layout: str = "HND"):
        super().__init__()
        _check_layouts(gqa_layout, kv_layout)
        self.is_causal = is_causal
        self.gqa_layout = gqa_layout
        self.kv_layout = kv_layout

    def forward(
        self,
        query: torch.Tensor,
        key_cache: torch.Tensor,
        value_cache: torch.Tensor,
        total_seq_lens: torch.Tensor,
        block_tables: torch.Tensor,
        softmax_scale: Optional[float] = None,
        mask: Optional[torch.Tensor] = None,
        *,
        max_total_seq_len: Optional[int] = None,
    ) -> torch.Tensor:
        return paged_decode_reference(
            query, key_cache, value_cache, total_seq_lens, block_tables,
            softmax_scale, self.gqa_layout, self.kv_layout, mask=None if self.is_causal else mask,
        )

    def extra_repr(self) -> str:
        return f"is_causal={self.is_causal}, gqa_layout={self.gqa_layout}, kv_layout={self.kv_layout}"


class MojoPagedPrefillGQA(MojoOperator):
    """Varlen paged prefill GQA: q (T, Hq, D) + cu_q_lens + paged cache.
    Chunked prefill via ``cu_total_seq_lens`` (kv_len >= q_len). A
    non-causal call reads ``mask`` (the prefill contract: True = keep)."""

    def __init__(self, is_causal: bool = True, gqa_layout: str = "AABB", kv_layout: str = "HND"):
        super().__init__()
        _check_layouts(gqa_layout, kv_layout)
        self.is_causal = is_causal
        self.gqa_layout = gqa_layout
        self.kv_layout = kv_layout

    def forward(
        self,
        query: torch.Tensor,
        key_cache: torch.Tensor,
        value_cache: torch.Tensor,
        cu_q_lens: torch.Tensor,
        block_tables: torch.Tensor,
        softmax_scale: Optional[float] = None,
        cu_total_seq_lens: Optional[torch.Tensor] = None,
        mask: Optional[torch.Tensor] = None,
        max_q_len: Optional[int] = None,
        max_total_seq_len: Optional[int] = None,
    ) -> torch.Tensor:
        return paged_prefill_reference(
            query, key_cache, value_cache, cu_q_lens, block_tables, softmax_scale,
            cu_total_seq_lens, self.gqa_layout, self.kv_layout, self.is_causal, mask,
        )

    def extra_repr(self) -> str:
        return f"is_causal={self.is_causal}, gqa_layout={self.gqa_layout}, kv_layout={self.kv_layout}"


def segment_of(cu_seqlens: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """The sequence of each packed row: the last ``b`` with
    ``cu_seqlens[b] <= row``, clamped to ``[0, B - 1]`` (JAX :601-604)."""
    return (torch.searchsorted(cu_seqlens, rows.to(cu_seqlens.dtype), right=True) - 1).clamp(0, cu_seqlens.shape[0] - 2)


def window_mask_rows(
    q_abs: torch.Tensor,
    kv_positions: torch.Tensor,
    local_window_size: Optional[int],
    global_window_size: Optional[int],
) -> torch.Tensor:
    """Keep-mask ``(..., rows, keys)``: causal, and with either window set,
    causal AND (local window OR global window). ``q_abs`` is each query
    row's absolute kv position."""
    causal = q_abs[..., :, None] >= kv_positions[..., None, :]
    if local_window_size is None and global_window_size is None:
        return causal
    win = torch.zeros_like(causal)
    if local_window_size is not None:
        win = win | (q_abs[..., :, None] <= kv_positions[..., None, :] + local_window_size)
    if global_window_size is not None:
        win = win | (kv_positions < global_window_size)[..., None, :]
    return causal & win


class MojoDecodeGQA(MojoOperator):
    """Non-paged GQA decode: q (B, Hq, D), one token per sequence, over
    dense k/v (B, Hkv, S, D); ``total_seq_lens`` masks each row's keys."""

    def __init__(self, is_causal: bool = True, gqa_layout: str = "AABB"):
        super().__init__()
        _check_layouts(gqa_layout, "HND")
        self.is_causal = is_causal
        self.gqa_layout = gqa_layout

    def forward(
        self,
        query: torch.Tensor,
        key: torch.Tensor,
        value: torch.Tensor,
        total_seq_lens: Optional[torch.Tensor] = None,
        softmax_scale: Optional[float] = None,
    ) -> torch.Tensor:
        B, Hq, D = query.shape
        _, Hkv, S, _ = key.shape
        if softmax_scale is None:
            softmax_scale = 1.0 / math.sqrt(D)
        k = expand_gqa(key, Hq // Hkv, self.gqa_layout, head_axis=1)
        v = expand_gqa(value, Hq // Hkv, self.gqa_layout, head_axis=1)
        scores = torch.einsum("bhd,bhsd->bhs", query.float(), k.float()) * softmax_scale
        if total_seq_lens is not None:
            valid = torch.arange(S, device=query.device)[None, None, :] < total_seq_lens[:, None, None]
        else:
            valid = torch.ones_like(scores, dtype=torch.bool)
        out = torch.einsum("bhs,bhsd->bhd", masked_softmax(scores, valid, query.dtype), v)
        if total_seq_lens is not None:
            out = torch.where((total_seq_lens > 0)[:, None, None], out, 0)
        return out.to(query.dtype)

    def extra_repr(self) -> str:
        return f"is_causal={self.is_causal}, gqa_layout={self.gqa_layout}"


class MojoPrefillGQA(MojoOperator):
    """Padded dense causal GQA prefill: q (B, Hq, S, D), k/v (B, Hkv, S, D)
    -> out (B, S, Hq, D). ``cu_q_lens`` is checked to be int32 and not read
    further: causality alone keeps a valid row off the pad keys after it."""

    def __init__(self, is_causal: bool = True, gqa_layout: str = "ABAB"):
        super().__init__()
        _check_layouts(gqa_layout, "HND")
        self.is_causal = is_causal
        self.gqa_layout = gqa_layout

    def forward(
        self,
        query: torch.Tensor,
        k_cache: torch.Tensor,
        v_cache: torch.Tensor,
        cu_q_lens: torch.Tensor,
        softmax_scale: Optional[float] = None,
    ) -> torch.Tensor:
        _require_int32("cu_q_lens", cu_q_lens)
        if not self.is_causal:
            raise NotImplementedError("MojoPrefillGQA is causal only")
        B, Hq, S, D = query.shape
        group = Hq // k_cache.shape[1]
        k = expand_gqa(k_cache, group, self.gqa_layout, head_axis=1)
        v = expand_gqa(v_cache, group, self.gqa_layout, head_axis=1)
        scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(D)
        scores = torch.einsum("bhqd,bhkd->bhqk", query.float(), k.float()) * scale
        causal = torch.ones((S, S), dtype=torch.bool, device=query.device).tril()
        out = torch.einsum("bhqk,bhkd->bhqd", masked_softmax(scores, causal[None, None], query.dtype), v)
        return out.transpose(1, 2).to(query.dtype)  # (B, S, Hq, D)

    def extra_repr(self) -> str:
        return f"is_causal={self.is_causal}, gqa_layout={self.gqa_layout}"


class MojoSdpa(MojoOperator):
    """Scaled dot-product attention over ``(..., H, L, D)``: ``scale``
    (default 1/sqrt(D)), ``enable_gqa`` (kv heads repeated, AABB) and a
    boolean (True = attend) or additive mask. A row whose mask hides every
    key gives NaN, as the JAX golden's softmax does."""

    def __init__(self, scale: Optional[float] = None, enable_gqa: bool = False):
        super().__init__()
        self.scale = scale
        self.enable_gqa = enable_gqa

    def forward(
        self,
        query: torch.Tensor,
        key: torch.Tensor,
        value: torch.Tensor,
        attn_mask: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        scale = self.scale if self.scale is not None else 1.0 / math.sqrt(query.shape[-1])
        k, v = key, value
        if self.enable_gqa and query.shape[-3] != key.shape[-3]:
            group = query.shape[-3] // key.shape[-3]
            k = k.repeat_interleave(group, dim=-3)
            v = v.repeat_interleave(group, dim=-3)
        scores = torch.einsum("...qd,...kd->...qk", query.float(), k.float()) * scale
        if attn_mask is not None:
            if attn_mask.dtype == torch.bool:
                scores = torch.where(attn_mask, scores, float("-inf"))
            else:
                scores = scores + attn_mask.float()
        probs = torch.softmax(scores, dim=-1).to(query.dtype)
        return torch.einsum("...qk,...kd->...qd", probs, v).to(query.dtype)

    def extra_repr(self) -> str:
        return f"scale={self.scale}, enable_gqa={self.enable_gqa}"


class _SWAConfigMixin:
    """Constructor and config of the sliding-window family (a plain mixin:
    only the classes that list it beside ``MojoOperator`` are core ops)."""

    def __init__(
        self,
        is_causal: bool = True,
        gqa_layout: str = "AABB",
        global_window_size: Optional[int] = None,
        local_window_size: Optional[int] = None,
        kv_layout: str = "HND",
    ):
        super().__init__()
        _check_layouts(gqa_layout, kv_layout)
        self.is_causal = is_causal
        self.gqa_layout = gqa_layout
        self.global_window_size = global_window_size
        self.local_window_size = local_window_size
        self.kv_layout = kv_layout

    def extra_repr(self) -> str:
        return (
            f"is_causal={self.is_causal}, gqa_layout={self.gqa_layout}, "
            f"global_window_size={self.global_window_size}, local_window_size={self.local_window_size}"
        )


class MojoPagedPrefillSWA(_SWAConfigMixin, MojoOperator):
    """Varlen paged prefill with the sliding/global window (JAX :471-529):
    ``MojoPagedPrefillGQA`` whose query row at absolute position ``q_abs``
    sees (causal) ``window_mask_rows`` of its sequence's keys; non-causal,
    all of them. A sequence with no keys gives 0 rows."""

    def forward(
        self,
        query: torch.Tensor,
        key_cache: torch.Tensor,
        value_cache: torch.Tensor,
        cu_q_lens: torch.Tensor,
        block_table: torch.Tensor,
        softmax_scale: Optional[float] = None,
        cu_total_seq_lens: Optional[torch.Tensor] = None,
        *,
        max_q_len: Optional[int] = None,
        max_total_seq_len: Optional[int] = None,
    ) -> torch.Tensor:
        return paged_prefill_reference(
            query, key_cache, value_cache, cu_q_lens, block_table, softmax_scale, cu_total_seq_lens,
            self.gqa_layout, self.kv_layout, self.is_causal, None, self.local_window_size, self.global_window_size,
        )


class MojoPagedDecodeSWA(_SWAConfigMixin, MojoOperator):
    """Paged decode with the sliding/global window: ``MojoPagedDecodeGQA``
    whose one query row, at ``total_seq_lens - 1``, sees (causal)
    ``window_mask_rows`` of its keys; non-causal, all of them. A row with
    ``total_seq_lens == 0`` gives 0."""

    def forward(
        self,
        query: torch.Tensor,
        key_cache: torch.Tensor,
        value_cache: torch.Tensor,
        total_seq_lens: torch.Tensor,
        block_table: torch.Tensor,
        softmax_scale: Optional[float] = None,
        *,
        max_total_seq_len: Optional[int] = None,
    ) -> torch.Tensor:
        windows = (self.local_window_size, self.global_window_size) if self.is_causal else (None, None)
        return paged_decode_reference(
            query, key_cache, value_cache, total_seq_lens, block_table, softmax_scale, self.gqa_layout,
            self.kv_layout, *windows,
        )


class MojoSWA(_SWAConfigMixin, MojoOperator):
    """Dense varlen sliding-window attention: packed q (T, Hq, D) and k/v
    (Tk, Hkv, D), sequences given by ``cu_q_lens`` and
    ``cu_total_seq_lens``. Query row i of sequence b sits at
    ``kv_len[b] - q_len[b] + i``; it sees keys of its own sequence, and
    (causal) ``window_mask_rows`` of them. The golden materializes the
    (T, Hq, Tk) scores."""

    def forward(
        self,
        query: torch.Tensor,
        key: torch.Tensor,
        value: torch.Tensor,
        cu_q_lens: torch.Tensor,
        cu_total_seq_lens: torch.Tensor,
        softmax_scale: Optional[float] = None,
    ) -> torch.Tensor:
        _require_int32("cu_q_lens", cu_q_lens)
        _require_int32("cu_total_seq_lens", cu_total_seq_lens)
        T, Hq, D = query.shape
        Tk, Hkv, _ = key.shape
        if softmax_scale is None:
            softmax_scale = 1.0 / math.sqrt(D)
        q_lens, kv_lens = seq_lens_from_cu(cu_q_lens), seq_lens_from_cu(cu_total_seq_lens)
        rows = torch.arange(T, dtype=torch.int32, device=query.device)
        q_batch = segment_of(cu_q_lens, rows)
        q_abs = kv_lens[q_batch] - q_lens[q_batch] + rows - cu_q_lens[q_batch]
        keys = torch.arange(Tk, dtype=torch.int32, device=query.device)
        k_batch = segment_of(cu_total_seq_lens, keys)
        k_pos = keys - cu_total_seq_lens[k_batch]

        kx = expand_gqa(key, Hq // Hkv, self.gqa_layout, head_axis=1)
        vx = expand_gqa(value, Hq // Hkv, self.gqa_layout, head_axis=1)
        scores = torch.einsum("thd,khd->thk", query.float(), kx.float()) * softmax_scale
        keep = q_batch[:, None] == k_batch[None, :]
        if self.is_causal:
            keep = keep & window_mask_rows(q_abs, k_pos, self.local_window_size, self.global_window_size)
        probs = masked_softmax(scores, keep[:, None, :], query.dtype)
        return torch.einsum("thk,khd->thd", probs, vx).to(query.dtype)
