"""Experimental paged KV caches: the MLA latent store, the int8 (C8)
store with its dequantizing read-back, and the low-rank label store.

Counterpart of the JAX package's ``experimental/operators/kv_cache.py``
(``MojoStorePagedMLAKVCache`` :24, ``MojoStorePagedKVCacheC8`` :52,
``MojoDequantFromPagedKVCache`` :93, ``MojoStoreLowrank`` :143). The C8 caches are int8 HND
``(N, Hkv, block_size, D)`` with per-channel fp32 scales ``(Hkv, D)``; the
MLA caches are ``(N, 1, block_size, r)`` latents and ``(N, 1, block_size,
dr)`` rope keys. The stores write in place, like the bf16 store, where the
JAX stores return new arrays (an XLA scatter there too: no kernel).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from mojo_opset_tpu_torch.core.operator import MojoOperator
from mojo_opset_tpu_torch.core.operators.kv_cache import drop_invalid, store_paged_kv, store_paged_rows


class MojoStorePagedMLAKVCache(MojoOperator):
    """Append compressed-KV latents ``(T, r)`` and rope keys ``(T, dr)`` to
    the paged caches ``(N, 1, block_size, r)`` and ``(N, 1, block_size,
    dr)``, in place; returns the caches.

    Destinations as in ``MojoStorePagedKVCache``: ``(block_table,
    cu_q_lens, context_kv_lens)`` computed on the device (tokens without a
    block are dropped, as the JAX op's ``mode="drop"`` does), or the
    session's precomputed ``token_indices``. The rope cache is exactly
    ``dr`` wide: the JAX session's padding of it to 128 lanes is a TPU
    matter.
    """

    def forward(
        self,
        compressed_kv_states: torch.Tensor,
        k_pe_states: torch.Tensor,
        compressed_kv_cache: torch.Tensor,
        k_pe_cache: torch.Tensor,
        block_table: Optional[torch.Tensor] = None,
        cu_q_lens: Optional[torch.Tensor] = None,
        context_kv_lens: Optional[torch.Tensor] = None,
        *,
        token_indices: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        for states, cache, name in ((compressed_kv_states, compressed_kv_cache, "compressed_kv"),
                                    (k_pe_states, k_pe_cache, "k_pe")):
            if states.ndim != 2 or cache.ndim != 4 or cache.shape[1] != 1 or cache.shape[3] != states.shape[1]:
                raise ValueError(f"{name}: states (T, D) into a cache (N, 1, block_size, D), got "
                                 f"{tuple(states.shape)} and {tuple(cache.shape)}")
        store_paged_rows(((compressed_kv_states[:, None], compressed_kv_cache), (k_pe_states[:, None], k_pe_cache)),
                         "HND", block_table, cu_q_lens, context_kv_lens, token_indices)
        return compressed_kv_cache, k_pe_cache


def quantize_kv(states: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``clamp(round(x / scale), -128, 127)`` as int8, per channel."""
    return torch.round(states.float() / scale.float()).clamp(-128, 127).to(torch.int8)


class MojoStorePagedKVCacheC8(MojoOperator):
    """Quantize new K/V tokens ``(T, Hkv, D)`` to int8 with the per-channel
    scales ``(Hkv, D)`` and write them into the int8 HND caches, in place.

    Destinations as in ``MojoStorePagedKVCache``: ``(block_table,
    cu_q_lens, context_kv_lens)`` computed on the device, or the session's
    precomputed ``token_indices``.
    """

    def forward(
        self,
        key_states: torch.Tensor,
        value_states: torch.Tensor,
        key_cache: torch.Tensor,
        value_cache: torch.Tensor,
        key_scale: torch.Tensor,
        value_scale: torch.Tensor,
        block_table: Optional[torch.Tensor] = None,
        cu_q_lens: Optional[torch.Tensor] = None,
        context_kv_lens: Optional[torch.Tensor] = None,
        *,
        chunk_metadata: Optional[torch.Tensor] = None,
        token_indices: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        if chunk_metadata is not None:  # as the JAX op (experimental/operators/kv_cache.py:72-76)
            raise NotImplementedError("C8 store uses the per-token plan; pass block_table/cu_q_lens/context_kv_lens")
        if key_cache.dtype != torch.int8 or value_cache.dtype != torch.int8:
            raise ValueError(f"C8 caches must be int8, got {key_cache.dtype}, {value_cache.dtype}")
        return store_paged_kv(
            quantize_kv(key_states, key_scale), quantize_kv(value_states, value_scale),
            key_cache, value_cache, "HND", block_table, cu_q_lens, context_kv_lens, token_indices,
        )


class MojoDequantFromPagedKVCache(MojoOperator):
    """Gather and dequantize int8 paged K/V back into packed per-token K/V
    ``(total_seq, H, D)``; returns ``(key, value)``.

    ``key``/``value`` are templates: sequence i's ``context_lengths[i]``
    tokens land at rows ``context_seq_offset[i]`` on (default: the
    running sum of the lengths); other rows keep the template's values.
    Reads the lengths back to the host, as the JAX golden does.
    """

    def forward(
        self,
        *,
        key: torch.Tensor,
        value: Optional[torch.Tensor] = None,
        key_cache: torch.Tensor,
        key_cache_scale: torch.Tensor,
        value_cache: Optional[torch.Tensor] = None,
        value_cache_scale: Optional[torch.Tensor] = None,
        context_lengths: torch.Tensor = None,
        max_context_len: int = 0,
        context_seq_offset: Optional[torch.Tensor] = None,
        block_tables: torch.Tensor = None,
    ):
        lens = [int(n) for n in torch.as_tensor(context_lengths).tolist()]
        if context_seq_offset is None:
            offsets = [sum(lens[:i]) for i in range(len(lens))]
        else:
            offsets = [int(o) for o in torch.as_tensor(context_seq_offset).tolist()]
        bs = key_cache.shape[2]
        table = torch.as_tensor(block_tables).tolist()

        def fill(out, cache, scale):
            out = out.clone()
            for i, n in enumerate(lens):
                if n <= 0:
                    continue
                blocks = table[i][: -(-n // bs)]
                blocks = blocks[: next((j for j, b in enumerate(blocks) if b < 0), len(blocks))]
                dense = torch.cat([cache[b] for b in blocks], dim=-2)[:, :n]  # (H, n, D)
                deq = dense.float() * scale.float()[:, None, :]
                out[offsets[i] : offsets[i] + dense.shape[1]] = deq.transpose(0, 1).to(out.dtype)
            return out

        key = fill(key, key_cache, key_cache_scale)
        if value is not None and value_cache is not None and value_cache_scale is not None:
            value = fill(value, value_cache, value_cache_scale)
        return key, value


class MojoStoreLowrank(MojoOperator):
    """Write low-rank latent states ``key_lr`` (T, N, D) into a BNSD label
    cache ``(B, N, S, D)`` at ``(block_idxs[t], :, token_idxs[t])`` for the
    first ``token_num`` tokens, in place; returns the cache. A ``-1`` (any
    negative) block is dropped through ``drop_invalid``, never written to
    the last block; a negative token index counts from the end, as a JAX
    index does, and one still outside the cache is dropped (JAX
    ``mode='drop'``)."""

    def forward(
        self,
        label_cache: torch.Tensor,
        key_lr: torch.Tensor,
        block_idxs: torch.Tensor,
        token_idxs: torch.Tensor,
        token_num: int,
    ) -> torch.Tensor:
        if block_idxs.dtype != torch.int32 or token_idxs.dtype != torch.int32:
            raise ValueError(f"block_idxs and token_idxs must be int32, got {block_idxs.dtype}, {token_idxs.dtype}")
        if label_cache.ndim != 4 or key_lr.ndim != 3:
            raise ValueError(f"label_cache must be BNSD and key_lr SND, got {tuple(label_cache.shape)}, "
                             f"{tuple(key_lr.shape)}")
        n_blocks, S = label_cache.shape[0], label_cache.shape[2]
        blocks = drop_invalid(block_idxs[:token_num], n_blocks).long()
        tokens = token_idxs[:token_num].long()
        tokens = torch.where(tokens < 0, tokens + S, tokens)
        keep = (blocks < n_blocks) & (tokens >= 0) & (tokens < S)
        label_cache[blocks[keep], :, tokens[keep]] = key_lr[:token_num][keep].to(label_cache.dtype)
        return label_cache
