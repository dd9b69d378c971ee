"""Paged KV-cache store (counterpart of the JAX package's
``core/operators/kv_cache.py``: ``drop_invalid`` :26,
``assert_paged_kv_store_contract`` :35, ``build_paged_kv_chunk_metadata``
:41, ``build_paged_kv_token_indices`` :93, ``MojoStorePagedKVCache`` :129).

The JAX op returns updated caches (in place under jit with donated
buffers); this one writes into the caches it is given with one
``index_put_`` per cache, and returns them. No host sync on the table path:
destinations are computed on the device from the block table. The
``chunk_metadata`` path takes the JAX op's eager plan of
``(src_start, dst_block, dst_offset, len)`` rows and expands it to tokens
on the host, as the JAX op does (:178-190).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from mojo_opset_tpu_torch.core.operator import MojoOperator

KV_LAYOUTS = ("HND", "NHD")


def drop_invalid(dst_block: torch.Tensor, n_rows: int) -> torch.Tensor:
    """The ``-1`` sentinel (any negative block) remapped to ``n_rows``, a
    block past the cache's last, so that a write that drops out-of-range
    rows drops it; a negative index would name the LAST block instead
    (Python-style wrap), which is what the JAX op's remap guards against."""
    return torch.where(dst_block >= 0, dst_block, n_rows).to(torch.int32)


def assert_paged_kv_store_contract(chunk_metadata: torch.Tensor) -> None:
    """An int32 ``(rows, 4)`` plan."""
    if chunk_metadata.dtype != torch.int32 or chunk_metadata.ndim != 2 or chunk_metadata.shape[1] != 4:
        raise ValueError(f"chunk_metadata must be int32 (rows, 4), got {chunk_metadata.dtype} "
                         f"{tuple(chunk_metadata.shape)}")


def build_paged_kv_chunk_metadata(
    block_table: torch.Tensor,
    cu_q_lens: Optional[torch.Tensor],
    context_kv_lens: torch.Tensor,
    block_size: int,
) -> torch.Tensor:
    """Store plan: int32 rows ``(src_token_start, dst_block_id,
    dst_block_offset, chunk_len)``, one for each (sequence, block) that new
    tokens land in, sequences in order, blocks in table order (JAX :41-90).
    Without ``cu_q_lens`` (decode) sequence i's one new token i lands at
    position ``context_kv_lens[i]``. Tokens at a negative context, past the
    table or on a ``-1`` block get no row. Built with torch on the table's
    device; the row count depends on the data, so the call syncs."""
    dev = block_table.device
    bt = block_table.to(torch.int32)
    ctx = context_kv_lens.to(device=dev, dtype=torch.int32)
    batch_size, max_blocks = ctx.shape[0], bt.shape[1]
    if batch_size == 0 or max_blocks == 0:
        return torch.empty((0, 4), dtype=torch.int32, device=dev)
    if cu_q_lens is None:
        src = torch.arange(batch_size, dtype=torch.int32, device=dev)
        safe_ctx = ctx.clamp(min=0)
        logical = safe_ctx // block_size
        physical = bt[src.long(), logical.clamp(0, max_blocks - 1).long()]
        valid = (ctx >= 0) & (logical < max_blocks) & (physical >= 0)
        rows = torch.stack([src, physical, safe_ctx % block_size, torch.ones_like(src)], dim=-1)
        return rows[valid].to(torch.int32)
    cu = cu_q_lens.to(device=dev, dtype=torch.int32)
    q_lens = cu[1:] - cu[:-1]
    block_start = torch.arange(max_blocks, dtype=torch.int32, device=dev)[None, :] * block_size
    seq_start, seq_end = ctx[:, None], (ctx + q_lens)[:, None]
    overlap_start = torch.maximum(seq_start, block_start)
    chunk_lens = (torch.minimum(seq_end, block_start + block_size) - overlap_start).clamp(min=0)
    valid = (q_lens > 0)[:, None] & (ctx >= 0)[:, None] & (chunk_lens > 0) & (bt >= 0)
    rows = torch.stack([cu[:-1, None] + (overlap_start - seq_start), bt, overlap_start - block_start, chunk_lens],
                       dim=-1)
    return rows[valid].to(torch.int32)


def chunk_token_indices(chunk_metadata: torch.Tensor, n_blocks: int, block_size: int):
    """A chunk plan expanded to one ``(src, dst_block, dst_offset)`` a token,
    on the host (JAX :178-190); tokens whose block or offset lies outside
    the cache are dropped, as the JAX op's ``mode='drop'`` write drops them
    (a ``-1`` block through ``drop_invalid``)."""
    m = chunk_metadata.cpu().long()
    lens = m[:, 3].clamp(min=0)
    row = torch.repeat_interleave(torch.arange(m.shape[0]), lens)
    step = torch.arange(row.shape[0]) - torch.repeat_interleave(lens.cumsum(0) - lens, lens)
    src, blk, off = m[row, 0] + step, drop_invalid(m[row, 1], n_blocks).long(), m[row, 2] + step
    keep = (blk < n_blocks) & (off >= 0) & (off < block_size)
    return src[keep], blk[keep], off[keep]


def build_paged_kv_token_indices(
    block_table: torch.Tensor,
    cu_q_lens: Optional[torch.Tensor],
    context_kv_lens: torch.Tensor,
    block_size: int,
    total_tokens: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token destination plan.

    Returns ``(dst_block (T,), dst_offset (T,))``: token t of the packed
    new-KV tensor lands at block ``dst_block[t]``, row ``dst_offset[t]``.
    Tokens without a destination get ``dst_block = -1``.
    """
    ctx = context_kv_lens.to(torch.int32)
    B = ctx.shape[0]
    max_blocks = block_table.shape[1]
    token_ids = torch.arange(total_tokens, dtype=torch.int32, device=ctx.device)
    if cu_q_lens is None:
        batch = token_ids.long()  # decode: token i belongs to sequence i
        pos = ctx
    else:
        batch = (torch.searchsorted(cu_q_lens, token_ids, right=True) - 1).clamp(0, B - 1)
        pos = ctx[batch] + (token_ids - cu_q_lens[batch])
    logical = pos.clamp(min=0) // block_size
    valid = (pos >= 0) & (logical < max_blocks)
    physical = block_table[batch, logical.clamp(0, max_blocks - 1).long()]
    valid = valid & (physical >= 0)
    dst_block = torch.where(valid, physical, -1).to(torch.int32)
    dst_offset = (pos.clamp(min=0) % block_size).to(torch.int32)
    return dst_block, dst_offset


def _dedupe_invalid(dst_block: torch.Tensor, dst_offset: torch.Tensor, n_blocks: int):
    """Source rows and destinations for one ``index_put_`` without a sync.

    A token without a destination repeats the write of the first token
    that has one (same slot, same value), so duplicate indices carry equal
    values and the scatter stays deterministic; the JAX op drops such
    tokens with ``mode='drop'``. When no token has a destination, every
    write rewrites block 0 row 0 with its own content.
    """
    valid = dst_block >= 0
    first = torch.argmax(valid.to(torch.int32))
    src = torch.where(valid, torch.arange(valid.shape[0], device=valid.device), first)
    any_valid = valid.any()
    blk = torch.where(any_valid, dst_block[src], 0).clamp(0, n_blocks - 1).long()
    off = torch.where(any_valid, dst_offset[src], 0).long()
    return src, blk, off, any_valid


def _rows(cache: torch.Tensor, blk: torch.Tensor, off: torch.Tensor, kv_layout: str) -> torch.Tensor:
    # HND: cache[blk, :, off] is (T, Hkv, D), the advanced indices around
    # the head slice move to the front
    return cache[blk, off] if kv_layout == "NHD" else cache[blk, :, off]


def _write(cache: torch.Tensor, blk: torch.Tensor, off: torch.Tensor, rows: torch.Tensor, kv_layout: str) -> None:
    if kv_layout == "NHD":
        cache[blk, off] = rows.to(cache.dtype)
    else:
        cache[blk, :, off] = rows.to(cache.dtype)


class MojoStorePagedKVCache(MojoOperator):
    """Scatter new K/V tokens ``(T, Hkv, D)`` into a paged cache, in place.

    Destinations come from ``(block_table, cu_q_lens, context_kv_lens)``
    (the JAX op's jittable contract: computed on the device, tokens without
    a block are dropped), from the JAX op's ``chunk_metadata`` plan
    (``build_paged_kv_chunk_metadata``; not mixed with the tables, an empty
    plan writes nothing), or precomputed as ``token_indices = (dst_block,
    dst_offset)`` with one valid slot per token (the session builds it once
    per step, so the layers launch two scatters and nothing else).

    ``kv_layout``: "HND" = (N, Hkv, bs, D); "NHD" = (N, bs, Hkv, D), token
    rows contiguous (the Qwen3 default).
    """

    def __init__(self, kv_layout: str = "HND"):
        super().__init__()
        if kv_layout not in KV_LAYOUTS:
            raise ValueError(f"kv_layout must be one of {KV_LAYOUTS}, got {kv_layout}")
        self.kv_layout = kv_layout

    def extra_repr(self) -> str:
        return f"kv_layout={self.kv_layout}"

    def forward(
        self,
        key_states: torch.Tensor,
        value_states: torch.Tensor,
        key_cache: torch.Tensor,
        value_cache: torch.Tensor,
        block_table: Optional[torch.Tensor] = None,
        cu_q_lens: Optional[torch.Tensor] = None,
        context_kv_lens: Optional[torch.Tensor] = None,
        *,
        chunk_metadata: Optional[torch.Tensor] = None,
        token_indices: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        return store_paged_kv(
            key_states, value_states, key_cache, value_cache, self.kv_layout,
            block_table, cu_q_lens, context_kv_lens, token_indices, chunk_metadata,
        )


def store_paged_kv(
    key_states: torch.Tensor,
    value_states: torch.Tensor,
    key_cache: torch.Tensor,
    value_cache: torch.Tensor,
    kv_layout: str,
    block_table: Optional[torch.Tensor] = None,
    cu_q_lens: Optional[torch.Tensor] = None,
    context_kv_lens: Optional[torch.Tensor] = None,
    token_indices: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    chunk_metadata: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write K/V rows ``(T, Hkv, D)`` into the caches in place (see
    ``MojoStorePagedKVCache``); returns the caches."""
    if not (key_states.ndim == 3 and key_states.shape == value_states.shape):
        raise ValueError("key/value states must be (token_num, kv_head_num, head_dim)")
    store_paged_rows(((key_states, key_cache), (value_states, value_cache)), kv_layout,
                     block_table, cu_q_lens, context_kv_lens, token_indices, chunk_metadata)
    return key_cache, value_cache


def store_paged_rows(
    pairs,
    kv_layout: str,
    block_table: Optional[torch.Tensor] = None,
    cu_q_lens: Optional[torch.Tensor] = None,
    context_kv_lens: Optional[torch.Tensor] = None,
    token_indices: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    chunk_metadata: Optional[torch.Tensor] = None,
) -> None:
    """Write each ``(states (T, Hkv, D), cache)`` pair's rows into its paged
    cache in place, all at the same token slots; the caches may differ in
    ``D`` (MLA's latent and rope caches)."""
    T = pairs[0][0].shape[0]
    if chunk_metadata is not None:
        if block_table is not None or cu_q_lens is not None or context_kv_lens is not None or token_indices is not None:
            raise ValueError("chunk_metadata is not mixed with block_table/cu_q_lens/context_kv_lens/token_indices")
        assert_paged_kv_store_contract(chunk_metadata)
        cache0 = pairs[0][1]
        block_size = cache0.shape[2] if kv_layout == "HND" else cache0.shape[1]
        src, blk, off = (t.to(cache0.device) for t in chunk_token_indices(chunk_metadata, cache0.shape[0],
                                                                            block_size))
        if src.numel():
            for states, cache in pairs:
                _write(cache, blk, off, states[src], kv_layout)
        return
    if T == 0:
        return
    if token_indices is not None:
        if block_table is not None or cu_q_lens is not None or context_kv_lens is not None:
            raise ValueError("token_indices is not mixed with block_table/cu_q_lens/context_kv_lens")
        blk, off = token_indices
        for states, cache in pairs:
            _write(cache, blk, off, states, kv_layout)
        return

    if block_table is None or context_kv_lens is None:
        raise ValueError("block_table and context_kv_lens are required without token_indices")
    cache0 = pairs[0][1]
    block_size = cache0.shape[2] if kv_layout == "HND" else cache0.shape[1]
    dst_block, dst_offset = build_paged_kv_token_indices(block_table, cu_q_lens, context_kv_lens, block_size, T)
    src, blk, off, any_valid = _dedupe_invalid(dst_block, dst_offset, cache0.shape[0])
    for states, cache in pairs:
        rows = torch.where(any_valid, states[src].to(cache.dtype), _rows(cache, blk, off, kv_layout))
        _write(cache, blk, off, rows, kv_layout)
