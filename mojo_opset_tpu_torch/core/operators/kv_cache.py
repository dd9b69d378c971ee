"""Paged KV-cache store (counterpart of
the JAX package's ``core/operators/kv_cache.py:93,129``).

The JAX op returns updated caches (in place under jit with donated
buffers); this one writes into the caches it is given with one
``index_put_`` per cache, and returns them. No host sync: destinations are
computed on the device from the block table.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from mojo_opset_tpu_torch.core.operator import MojoOperator

KV_LAYOUTS = ("HND", "NHD")


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

    Destinations come either from ``(block_table, cu_q_lens,
    context_kv_lens)`` (the JAX op's jittable contract: computed on the
    device, tokens without a block are dropped), or precomputed as
    ``token_indices = (dst_block, dst_offset)`` with one valid slot per
    token (the counterpart of the JAX op's host-built ``chunk_metadata``
    plan; the session builds it once per step, so the layers launch two
    scatters and nothing else).

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
        token_indices: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        return store_paged_kv(
            key_states, value_states, key_cache, value_cache, self.kv_layout,
            block_table, cu_q_lens, context_kv_lens, token_indices,
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
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write K/V rows ``(T, Hkv, D)`` into the caches in place (see
    ``MojoStorePagedKVCache``); returns the caches."""
    if not (key_states.ndim == 3 and key_states.shape == value_states.shape):
        raise ValueError("key/value states must be (token_num, kv_head_num, head_dim)")
    store_paged_rows(((key_states, key_cache), (value_states, value_cache)), kv_layout,
                     block_table, cu_q_lens, context_kv_lens, token_indices)
    return key_cache, value_cache


def store_paged_rows(
    pairs,
    kv_layout: str,
    block_table: Optional[torch.Tensor] = None,
    cu_q_lens: Optional[torch.Tensor] = None,
    context_kv_lens: Optional[torch.Tensor] = None,
    token_indices: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> None:
    """Write each ``(states (T, Hkv, D), cache)`` pair's rows into its paged
    cache in place, all at the same token slots; the caches may differ in
    ``D`` (MLA's latent and rope caches)."""
    T = pairs[0][0].shape[0]
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
