"""Paged-attention runtime session.

Counterpart of the JAX package's ``runtime/session.py`` (``AttentionMetadata``
:33, ``KVCaches`` :67, ``PagedAttentionRuntimeState`` :166,
``PagedAttentionGenerationModel`` :354, ``FusedDecode`` :447):
  * the block allocator (free stack, block tables, sequence lengths) is
    host-side numpy, ported as it stands, so its block tables equal the
    JAX session's;
  * the per-layer KV caches are device tensors that the store op writes
    in place;
  * each step's host values (``max_q_len``, ``max_total_seq_len``) and
    device metadata (``cu_q_lens``, ``cu_total_seq_lens``, the KV store's
    token slots) are built once per step from numpy, so no layer reads a
    device value back or rebuilds an index.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from mojo_opset_tpu_torch.core.operators.sampling import MojoTopKSampling
from mojo_opset_tpu_torch.runtime.config import MojoConfig
from mojo_opset_tpu_torch.utils.platform import resolve_device


@dataclass
class AttentionMetadata:
    """One step's attention metadata: device tensors plus host ints.

    ``total_seq_lens`` count this step's tokens. ``token_indices`` (block,
    row) gives each token's cache slot for the KV store.
    """

    cu_q_lens: Optional[torch.Tensor]
    total_seq_lens: torch.Tensor
    block_tables: torch.Tensor
    is_prefill: bool
    token_indices: Tuple[torch.Tensor, torch.Tensor]
    cu_total_seq_lens: Optional[torch.Tensor] = None
    max_q_len: int = 1
    max_total_seq_len: int = 0


class KVCaches:
    """Per-layer paged K/V cache tensors.

    ``caches.key(layer)`` / ``caches.value(layer)`` give one layer's
    tensors. The caches update in place: the store op writes into these
    tensors, where the JAX package returns new arrays.

    An int8 (C8) cache also holds per-layer ``(Hkv, D)`` fp32 channel
    scales, ``key_scale(layer)`` / ``value_scale(layer)``, zero until the
    first prefill calibrates them. They too update in place (the model
    ``copy_``s into them), so a decode window such as ``FusedDecode`` that
    holds the session's tensors sees every update without a change.
    """

    def __init__(self, keys: List[torch.Tensor], values: List[torch.Tensor],
                 key_scales: List[torch.Tensor] = (), value_scales: List[torch.Tensor] = ()):
        self.keys = list(keys)
        self.values = list(values)
        self.key_scales = list(key_scales)
        self.value_scales = list(value_scales)

    @classmethod
    def create(
        cls, num_layers: int, cache_shape: Tuple[int, int, int, int], dtype: torch.dtype, device=None
    ) -> "KVCaches":
        def zeros(shape, dt):
            return [torch.zeros(shape, dtype=dt, device=device) for _ in range(num_layers)]

        if dtype == torch.int8:  # HND (N, Hkv, bs, D) -> channel scales (Hkv, D)
            scale_shape = (cache_shape[1], cache_shape[3])
            return cls(zeros(cache_shape, dtype), zeros(cache_shape, dtype),
                       zeros(scale_shape, torch.float32), zeros(scale_shape, torch.float32))
        return cls(zeros(cache_shape, dtype), zeros(cache_shape, dtype))

    def key(self, layer_idx: int) -> torch.Tensor:
        return self.keys[layer_idx]

    def value(self, layer_idx: int) -> torch.Tensor:
        return self.values[layer_idx]

    def key_scale(self, layer_idx: int) -> torch.Tensor:
        return self.key_scales[layer_idx]

    def value_scale(self, layer_idx: int) -> torch.Tensor:
        return self.value_scales[layer_idx]


class PagedAttentionRuntimeState:
    """Session: host-side block allocator + device-side caches (int8 with
    channel scales, in HND, when the config sets ``kv_cache_quant``). The
    caches live on ``device``, the card unless the caller names another
    (``utils.platform.resolve_device``); ``from_model`` takes the model's."""

    def __init__(
        self,
        config: MojoConfig,
        batch_size: int,
        dtype: Optional[torch.dtype] = None,
        block_size: int = 128,
        max_blocks_per_seq: Optional[int] = None,
        device=None,
    ):
        mc = config.model_config
        self.config = config
        self.batch_size = batch_size
        self.num_layers = mc.num_layers
        self.dtype = dtype or mc.dtype
        self.block_size = block_size
        self.num_kv_heads = mc.num_kv_heads
        self.head_dim = mc.head_dim
        self.device = resolve_device(device)

        self.max_blocks_per_seq = max_blocks_per_seq or (
            (mc.max_position_embeddings + block_size - 1) // block_size
        )
        total_blocks = batch_size * self.max_blocks_per_seq

        self.block_tables = np.full((batch_size, self.max_blocks_per_seq), -1, np.int32)
        self.total_seq_lens = np.zeros((batch_size,), np.int32)
        self.free_blocks = np.arange(total_blocks, dtype=np.int32)
        self.num_free_blocks = total_blocks

        self.kv_layout = mc.kv_layout
        self.caches = self._create_caches(total_blocks)

    def _create_caches(self, total_blocks: int) -> KVCaches:
        """The per-layer K/V pages: a subclass with other caches (MLA's
        latents) overrides this, so nothing is allocated twice."""
        if self.config.model_config.kv_cache_quant:
            self.dtype = torch.int8
        if self.dtype == torch.int8:  # the C8 store and attention ops read HND
            self.kv_layout = "HND"
        if self.kv_layout == "NHD":
            cache_shape = (total_blocks, self.block_size, self.num_kv_heads, self.head_dim)
        else:
            cache_shape = (total_blocks, self.num_kv_heads, self.block_size, self.head_dim)
        return KVCaches.create(self.num_layers, cache_shape, self.dtype, self.device)

    @classmethod
    def from_model(cls, model, batch_size: int, *, block_size: int = 128, dtype=None, **kw):
        kw.setdefault("device", next(model.parameters()).device)
        return cls(model.config, batch_size, dtype=dtype, block_size=block_size, **kw)

    # -- allocator ------------------------------------------------------
    def _allocate_blocks(self, num_blocks: int) -> np.ndarray:
        if num_blocks > self.num_free_blocks:
            raise ValueError("PagedAttentionRuntimeState: Out of paged KV cache memory.")
        allocated = self.free_blocks[self.num_free_blocks - num_blocks : self.num_free_blocks]
        self.num_free_blocks -= num_blocks
        return allocated

    def free_block_count(self) -> int:
        return self.num_free_blocks

    def _reserve(self, q_lens: np.ndarray) -> np.ndarray:
        previous = self.total_seq_lens.copy()
        for batch_idx in range(self.batch_size):
            context_len = int(previous[batch_idx])
            append_len = int(q_lens[batch_idx])
            old_blocks = -(-context_len // self.block_size)
            new_blocks = -(-(context_len + append_len) // self.block_size)
            for b in range(old_blocks, new_blocks):
                # a valid entry is a block this sequence still owns from a
                # reserve that was rolled back: reuse it instead of leaking
                if self.block_tables[batch_idx, b] < 0:
                    self.block_tables[batch_idx, b] = self._allocate_blocks(1)[0]
        self.total_seq_lens = previous + q_lens
        return previous

    def reset(self) -> None:
        """Release every sequence, keeping the cache tensors: a server
        reuses one session's cache pool across requests."""
        for batch_idx in range(self.batch_size):
            if int(self.total_seq_lens[batch_idx]) > 0:
                self.release_sequence(batch_idx)

    def release_sequence(self, batch_idx: int) -> None:
        """Return a finished sequence's blocks to the pool: every valid row
        entry, since a speculative rollback can leave reserved blocks past
        the rewound length."""
        row = self.block_tables[batch_idx]
        valid = row[row >= 0]
        self.free_blocks[self.num_free_blocks : self.num_free_blocks + valid.size] = valid[::-1]
        self.num_free_blocks += valid.size
        self.block_tables[batch_idx, :] = -1
        self.total_seq_lens[batch_idx] = 0

    # -- step input preparation ------------------------------------------
    def _tensor(self, array: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(array), device=self.device)

    def token_slots(self, positions: np.ndarray, batch: np.ndarray) -> Tuple[torch.Tensor, torch.Tensor]:
        """Cache (block, row) of the tokens at ``positions`` of sequences
        ``batch``, as device tensors; the blocks must be reserved."""
        blocks = self.block_tables[batch, positions // self.block_size].astype(np.int64)
        return self._tensor(blocks), self._tensor((positions % self.block_size).astype(np.int64))

    def _metadata(self, cu_q_lens, q_lens, positions) -> AttentionMetadata:
        cu_total = np.concatenate([[0], np.cumsum(self.total_seq_lens)]).astype(np.int32)
        return AttentionMetadata(
            cu_q_lens=None if cu_q_lens is None else self._tensor(cu_q_lens),
            total_seq_lens=self._tensor(self.total_seq_lens),
            block_tables=self._tensor(self.block_tables),
            is_prefill=cu_q_lens is not None,
            token_indices=self.token_slots(positions, np.repeat(np.arange(self.batch_size), q_lens)),
            cu_total_seq_lens=None if cu_q_lens is None else self._tensor(cu_total),
            max_q_len=int(q_lens.max(initial=0)),
            max_total_seq_len=int(self.total_seq_lens.max(initial=0)),
        )

    def prepare_prefill_inputs(self, input_ids, q_lens):
        input_ids = np.asarray(input_ids).reshape(-1).astype(np.int32)
        q_lens = np.ones(self.batch_size, np.int32) if q_lens is None else np.asarray(q_lens, np.int32)
        if int(q_lens.sum()) != input_ids.size:
            raise ValueError(
                "Prefill input_ids length must match the sum of q_lens: "
                f"{input_ids.size} != {int(q_lens.sum())}"
            )
        context_kv_lens = self._reserve(q_lens)
        positions = np.concatenate(
            [np.arange(c, c + n, dtype=np.int32) for c, n in zip(context_kv_lens, q_lens)] or [np.empty(0, np.int32)]
        )
        cu_q_lens = np.concatenate([[0], np.cumsum(q_lens)]).astype(np.int32)
        meta = self._metadata(cu_q_lens, q_lens, positions)
        return self._tensor(input_ids), self._tensor(positions), meta

    def prepare_decode_inputs(self, input_ids):
        """One token per sequence. A device tensor of tokens (the previous
        step's argmax) stays on the device: no host round trip."""
        if isinstance(input_ids, torch.Tensor):
            ids = input_ids.reshape(-1).to(self.device)
        else:
            ids = self._tensor(np.asarray(input_ids).reshape(-1).astype(np.int32))
        if ids.numel() != self.batch_size:
            raise ValueError(
                f"Decode input_ids must provide exactly one token per sequence: "
                f"{ids.numel()} != {self.batch_size}"
            )
        q_lens = np.ones(self.batch_size, np.int32)
        positions = self._reserve(q_lens)  # each token sits at its sequence's old length
        meta = self._metadata(None, q_lens, positions)
        return ids, self._tensor(positions), meta


class PagedAttentionGenerationModel:
    """Wraps a model for session-managed paged generation.

    Prefill computes ``lm_head_indices = cu_q_lens[1:] - 1`` so only the
    last token of each sequence hits the LM head. The model call is
    ``model(input_ids, positions, metadata, caches, lm_head_indices)``;
    it writes the session's caches in place and returns logits.
    ``session_cls`` builds each new session (``MLARuntimeState`` for
    DeepSeek's latent caches), as in the JAX package; the generators and
    ``FusedDecode`` take their sessions from here.
    """

    def __init__(self, model, *, block_size: int = 128, session_cls=PagedAttentionRuntimeState):
        self.model = model
        self.block_size = block_size
        self.session_cls = session_cls

    def _new_session(self, input_ids, context_input_len):
        batch_size = (
            int(np.asarray(context_input_len).size) if context_input_len is not None else int(len(input_ids))
        )
        return self.session_cls.from_model(self.model, batch_size, block_size=self.block_size)

    @torch.inference_mode()
    def __call__(self, input_ids, context_input_len=None, session=None):
        if session is None:
            session = self._new_session(input_ids, context_input_len)
        if context_input_len is not None:
            ids, positions, meta = session.prepare_prefill_inputs(input_ids, context_input_len)
            lm_head_indices = meta.cu_q_lens[1:] - 1
        else:
            ids, positions, meta = session.prepare_decode_inputs(input_ids)
            lm_head_indices = None
        logits = self.model(ids, positions, meta, session.caches, lm_head_indices=lm_head_indices)
        return logits, session


class FusedDecode:
    """A window of decode steps with no host sync inside it.

    The KV blocks, positions and cache slots of all ``n_steps`` are
    prepared on the host up front and copied once; each step then feeds
    the tokens it samples on the device straight into the next: the
    argmax (``sample_method="greedy"``) or a top-k sample
    (``sample_method="topk"``, ``top_k``) drawn from ``generator``. EOS
    handling happens on the host afterwards. (The JAX package compiles the
    window into one ``lax.scan``; CUDA graphs are the later step here.) An
    int8 (C8) session needs nothing more: its channel scales, like its
    caches, are tensors updated in place, and decode steps only read them.
    """

    def __init__(self, model, sample_method: str = "greedy", top_k: int = 50):
        if sample_method not in ("greedy", "topk"):
            raise ValueError(f"unknown sample method {sample_method!r}")
        self.model = model
        self.sample_method = sample_method
        self.top_k = top_k
        self._topk = MojoTopKSampling(top_k=top_k) if sample_method == "topk" else None

    def sample(self, logits: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        if self._topk is None:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        return self._topk(logits, generator)[1][:, 0].to(torch.int32)

    @torch.inference_mode()
    def __call__(self, session: PagedAttentionRuntimeState, first_tokens, n_steps: int,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Returns tokens (n_steps, B) int32 on the device; the session's
        caches and lengths advance by ``n_steps``. Top-k draws from
        ``generator`` (default: one seeded 0 for the window)."""
        if generator is None and self._topk is not None:
            generator = torch.Generator(device=session.device).manual_seed(0)
        lens0 = session.total_seq_lens.copy()
        ones = np.ones(session.batch_size, np.int32)
        for _ in range(n_steps):
            session._reserve(ones)
        block_tables = session._tensor(session.block_tables)
        positions = lens0[None, :] + np.arange(n_steps, dtype=np.int32)[:, None]  # (n_steps, B)
        slot_blocks, slot_rows = session.token_slots(
            positions, np.broadcast_to(np.arange(session.batch_size), positions.shape))
        positions_t, lens_t = session._tensor(positions), session._tensor(positions + 1)
        max_len0 = int(lens0.max(initial=0))
        tokens = torch.as_tensor(first_tokens, device=session.device).reshape(-1)
        out = []
        for i in range(n_steps):
            meta = AttentionMetadata(
                cu_q_lens=None,
                total_seq_lens=lens_t[i],
                block_tables=block_tables,
                is_prefill=False,
                token_indices=(slot_blocks[i], slot_rows[i]),
                max_total_seq_len=max_len0 + i + 1,
            )
            logits = self.model(tokens, positions_t[i], meta, session.caches, lm_head_indices=None)
            tokens = self.sample(logits, generator)
            out.append(tokens)
        return torch.stack(out) if out else torch.empty((0, session.batch_size), dtype=torch.int32)
