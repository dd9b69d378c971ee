"""Paged-attention runtime session.

Counterpart of the JAX package's ``runtime/session.py`` (``AttentionMetadata``
:33, ``KVCaches`` :67, ``PagedAttentionRuntimeState`` :166,
``PagedAttentionGenerationModel`` :354, ``FusedDecode`` :447):
  * the block allocator's state (free stack and its count, block tables,
    sequence lengths) is the session's own numpy buffers, updated in
    place, which each step's metadata copies. A reserve and a release run
    in the native C++ allocator (``runtime/native/``) over those buffers
    where it builds, as the JAX session picks it (``MOJO_NATIVE``), else
    in numpy; both hand blocks out in one order, so their block tables
    equal the JAX session's. A reserve is transactional: one that
    overflows a sequence's table or runs out of blocks raises and changes
    nothing;
  * the per-layer KV caches are device tensors that the store op writes
    in place;
  * each step's host values (``max_q_len``, ``max_total_seq_len``) and
    device metadata (``cu_q_lens``, ``cu_total_seq_lens``, the KV store's
    token slots) are built once per step from numpy, so no layer reads a
    device value back or rebuilds an index;
  * on the card, decode steps and ``FusedDecode`` windows replay from CUDA
    graphs (``runtime/compile_cache.py``), as the JAX package jits them
    through its ``CompiledStepPool``: the host builds a step's metadata and
    the graph's static buffers take a copy. Inside a graph no host int may
    vary, so a decode step's ``max_total_seq_len`` is the block table's
    capacity (no decode kernel reads it; kernel C sizes its split from the
    table's width). Prefill stays eager;
  * a step's host preparation is spanned (``utils.tracing.span``):
    ``mojo.session.prefill_inputs`` and ``mojo.session.decode_arrays``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from mojo_opset_tpu_torch.core.operators.sampling import MojoTopKSampling
from mojo_opset_tpu_torch.runtime.compile_cache import CompiledStepPool, resolve_device_graph
from mojo_opset_tpu_torch.runtime.config import MojoConfig
from mojo_opset_tpu_torch.runtime.native import NativeBlockAllocator, native_available
from mojo_opset_tpu_torch.utils.platform import resolve_device
from mojo_opset_tpu_torch.utils.tracing import span


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
    (``utils.platform.resolve_device``); ``from_model`` takes the model's.
    ``allocator`` says which allocator runs its reserves and releases:
    ``"native"`` or ``"numpy"``."""

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
        self.num_kv_heads = mc.local_num_kv_heads  # a tensor-parallel rank's heads
        self.head_dim = mc.head_dim
        self.device = resolve_device(device)

        self.max_blocks_per_seq = max_blocks_per_seq or (
            (mc.max_position_embeddings + block_size - 1) // block_size
        )
        total_blocks = batch_size * self.max_blocks_per_seq

        self.block_tables = np.full((batch_size, self.max_blocks_per_seq), -1, np.int32)
        self.total_seq_lens = np.zeros((batch_size,), np.int32)
        # the free stack: free_blocks[:_num_free[0]] are free, the top handed out first
        self.free_blocks = np.arange(total_blocks, dtype=np.int32)
        self._num_free = np.array([total_blocks], np.int32)
        self._native = (NativeBlockAllocator(batch_size, self.max_blocks_per_seq, total_blocks, block_size,
                                             self.free_blocks, self._num_free)
                        if native_available() else None)
        self.allocator = "numpy" if self._native is None else "native"

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
    @property
    def num_free_blocks(self) -> int:
        return int(self._num_free[0])

    def _allocate_blocks(self, num_blocks: int) -> np.ndarray:
        free = self.num_free_blocks
        if num_blocks > free:
            raise ValueError("PagedAttentionRuntimeState: Out of paged KV cache memory.")
        self._num_free[0] = free - num_blocks
        return self.free_blocks[free - num_blocks : free].copy()

    def free_block_count(self) -> int:
        return self.num_free_blocks

    def _reserve(self, q_lens: np.ndarray) -> np.ndarray:
        """Reserve ``q_lens[i]`` more tokens on each sequence; returns the
        lengths before. Transactional, as the native allocator: a sequence
        past its table (``ValueError("sequence exceeds
        max_blocks_per_seq")``) or more blocks than are free raises before
        anything changes."""
        q_lens = np.ascontiguousarray(q_lens, np.int32)
        if q_lens.shape != (self.batch_size,):
            raise ValueError(f"q_lens must hold one length per sequence: {q_lens.shape} != ({self.batch_size},)")
        if self._native is not None:
            return self._native.reserve(q_lens, self.total_seq_lens, self.block_tables)
        previous = self.total_seq_lens.copy()
        old_blocks = -(-previous // self.block_size)
        new_blocks = -(-(previous + q_lens) // self.block_size)
        if (new_blocks > self.max_blocks_per_seq).any():
            raise ValueError("sequence exceeds max_blocks_per_seq")
        # a valid entry past the length is a block this sequence still owns
        # from a reserve that was rolled back: it is reused, not replaced
        needed = sum(int((self.block_tables[i, old_blocks[i]:new_blocks[i]] < 0).sum())
                     for i in range(self.batch_size))
        if needed > self.num_free_blocks:
            raise ValueError("PagedAttentionRuntimeState: Out of paged KV cache memory.")
        for batch_idx in range(self.batch_size):
            for b in range(old_blocks[batch_idx], new_blocks[batch_idx]):
                if self.block_tables[batch_idx, b] < 0:
                    self.block_tables[batch_idx, b] = self._allocate_blocks(1)[0]
        self.total_seq_lens += q_lens
        return previous

    def reset(self) -> None:
        """Release every sequence, keeping the cache tensors: a server
        reuses one session's cache pool across requests."""
        for batch_idx in range(self.batch_size):
            if int(self.total_seq_lens[batch_idx]) > 0:
                self.release_sequence(batch_idx)

    def renew(self) -> None:
        """Back to a new session's state, keeping the cache tensors (and so
        the graphs that baked their addresses): every block free in its
        first order, no sequence, an int8 cache's channel scales 0
        (uncalibrated, as a new session's first prefill finds them)."""
        self.free_blocks[:] = np.arange(self.free_blocks.size, dtype=np.int32)
        self._num_free[0] = self.free_blocks.size
        self.block_tables.fill(-1)
        self.total_seq_lens[:] = 0
        for scale in self.caches.key_scales + self.caches.value_scales:
            scale.zero_()

    def release_sequence(self, batch_idx: int) -> None:
        """Return a finished sequence's blocks to the pool: every valid row
        entry, since a speculative rollback can leave reserved blocks past
        the rewound length."""
        if self._native is not None:
            self._native.release(batch_idx, self.total_seq_lens, self.block_tables)
            return
        row = self.block_tables[batch_idx]
        valid = row[row >= 0]
        free = self.num_free_blocks
        self.free_blocks[free : free + valid.size] = valid[::-1]
        self._num_free[0] = free + valid.size
        self.block_tables[batch_idx, :] = -1
        self.total_seq_lens[batch_idx] = 0

    # -- step input preparation ------------------------------------------
    def _tensor(self, array: np.ndarray) -> torch.Tensor:
        """A copy on the session's device (never a view of the host
        tables, which later reserves update in place)."""
        return torch.tensor(array, device=self.device)

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
        with span("mojo.session.prefill_inputs"):
            input_ids = np.asarray(input_ids).reshape(-1).astype(np.int32)
            q_lens = np.ones(self.batch_size, np.int32) if q_lens is None else np.asarray(q_lens, np.int32)
            if int(q_lens.sum()) != input_ids.size:
                raise ValueError(
                    "Prefill input_ids length must match the sum of q_lens: "
                    f"{input_ids.size} != {int(q_lens.sum())}"
                )
            context_kv_lens = self._reserve(q_lens)
            positions = np.concatenate(
                [np.arange(c, c + n, dtype=np.int32) for c, n in zip(context_kv_lens, q_lens)]
                or [np.empty(0, np.int32)]
            )
            cu_q_lens = np.concatenate([[0], np.cumsum(q_lens)]).astype(np.int32)
            meta = self._metadata(cu_q_lens, q_lens, positions)
            return self._tensor(input_ids), self._tensor(positions), meta

    def decode_arrays(self, n_steps: int = 1) -> Tuple[np.ndarray, ...]:
        """Reserve ``n_steps`` tokens per sequence; the host arrays of those
        steps' inputs, each (n_steps, B) but the table: positions, lengths
        after each step, the block table and the KV store's (block, row).
        Its span's args are the allocator's state before the reserve."""
        free = self.num_free_blocks
        with span("mojo.session.decode_arrays", blocks_allocated=self.free_blocks.size - free, free_blocks=free):
            lens0 = self.total_seq_lens.copy()
            ones = np.ones(self.batch_size, np.int32)
            for _ in range(n_steps):
                self._reserve(ones)
            positions = lens0[None, :] + np.arange(n_steps, dtype=np.int32)[:, None]
            batch = np.broadcast_to(np.arange(self.batch_size), positions.shape)
            blocks = self.block_tables[batch, positions // self.block_size].astype(np.int64)
            rows = (positions % self.block_size).astype(np.int64)
            return positions, positions + 1, self.block_tables.copy(), blocks, rows


def decode_step(model, block_size: int, caches: KVCaches, tokens, positions, lens, block_tables, slot_blocks,
                slot_rows) -> torch.Tensor:
    """One decode step on device tensors, as a graph captures it: the
    logits (B, V). ``max_total_seq_len`` is the table's capacity."""
    meta = AttentionMetadata(
        cu_q_lens=None,
        total_seq_lens=lens,
        block_tables=block_tables,
        is_prefill=False,
        token_indices=(slot_blocks, slot_rows),
        max_total_seq_len=block_tables.shape[1] * block_size,
    )
    return model(tokens, positions, meta, caches, lm_head_indices=None)


class PagedAttentionGenerationModel:
    """Wraps a model for session-managed paged generation.

    Prefill computes ``lm_head_indices = cu_q_lens[1:] - 1`` so only the
    last token of each sequence hits the LM head. The model call is
    ``model(input_ids, positions, metadata, caches, lm_head_indices)``;
    it writes the session's caches in place and returns logits.
    ``session_cls`` builds each new session (``MLARuntimeState`` for
    DeepSeek's latent caches), as in the JAX package; the generators and
    ``FusedDecode`` take their sessions from here.

    ``device_graph`` (JAX's ``jit``): decode steps replay from one CUDA
    graph per session and batch (``CompiledStepPool``). ``None`` reads the
    model config's ``runtime_config.use_device_graph`` on the card and is
    off on the CPU; ``True`` for a model off the card raises. Prefill runs
    eagerly either way.
    """

    def __init__(self, model, *, block_size: int = 128, session_cls=PagedAttentionRuntimeState,
                 device_graph: Optional[bool] = None):
        self.model = model
        self.block_size = block_size
        self.session_cls = session_cls
        self.device_graph = resolve_device_graph(device_graph, model)
        self._pool = CompiledStepPool(
            lambda *args: decode_step(model, *args), donate_argnums=(1,), static_argnums=(0,), name="decode step",
        ) if self.device_graph else None

    def _new_session(self, input_ids, context_input_len):
        batch_size = (
            int(np.asarray(context_input_len).size) if context_input_len is not None else int(len(input_ids))
        )
        return self.session_cls.from_model(self.model, batch_size, block_size=self.block_size)

    @torch.inference_mode()
    def __call__(self, input_ids, context_input_len=None, session=None):
        if session is None:
            session = self._new_session(input_ids, context_input_len)
        if context_input_len is None:
            return self._decode(session, input_ids), session
        ids, positions, meta = session.prepare_prefill_inputs(input_ids, context_input_len)
        logits = self.model(ids, positions, meta, session.caches, lm_head_indices=meta.cu_q_lens[1:] - 1)
        return logits, session

    def _decode(self, session: PagedAttentionRuntimeState, input_ids) -> torch.Tensor:
        """One token per sequence. Tokens on the device (the previous
        step's argmax) stay there: no host round trip. With graphs the
        host's arrays go to the graph's buffers."""
        tokens = _tokens(input_ids)
        if tokens.numel() != session.batch_size:
            raise ValueError(
                f"Decode input_ids must provide exactly one token per sequence: "
                f"{tokens.numel()} != {session.batch_size}"
            )
        positions, lens, tables, blocks, rows = session.decode_arrays()
        arrays = (positions[0], lens[0], tables, blocks[0], rows[0])
        if self._pool is None:
            return decode_step(self.model, session.block_size, session.caches, tokens.to(session.device),
                               *map(session._tensor, arrays))
        args = (session.block_size, session.caches, tokens, *map(torch.from_numpy, arrays))
        return self._pool.get_runner(*args)(*args)

    def runners(self) -> list:
        """The decode graphs held now (one per live session and batch)."""
        return self._pool.runners() if self._pool is not None else []


def _tokens(ids) -> torch.Tensor:
    """(B,) int32 tokens: a device tensor stays on its device, host ids go to a CPU tensor."""
    if isinstance(ids, torch.Tensor):
        return ids.reshape(-1).to(torch.int32)
    return torch.from_numpy(np.ascontiguousarray(np.asarray(ids).reshape(-1), dtype=np.int32))


class FusedDecode:
    """A window of decode steps with no host sync inside it.

    The KV blocks, positions and cache slots of all ``n_steps`` are
    prepared on the host up front and copied once; each step then feeds
    the tokens it samples on the device straight into the next: the
    argmax (``sample_method="greedy"``) or a top-k sample
    (``sample_method="topk"``, ``top_k``) drawn from ``generator``. EOS
    handling happens on the host afterwards. On the card the whole window
    is one CUDA graph per session and ``n_steps`` (``device_graph``, as in
    ``PagedAttentionGenerationModel``), the counterpart of the JAX
    package's ``lax.scan``; a top-k window registers its generator with
    the graph, so each replay draws new numbers. An int8 (C8) session
    needs nothing more: its channel scales, like its caches, are tensors
    updated in place, and decode steps only read them.
    """

    def __init__(self, model, sample_method: str = "greedy", top_k: int = 50, device_graph: Optional[bool] = None):
        if sample_method not in ("greedy", "topk"):
            raise ValueError(f"unknown sample method {sample_method!r}")
        self.model = model
        self.sample_method = sample_method
        self.top_k = top_k
        self._topk = MojoTopKSampling(top_k=top_k) if sample_method == "topk" else None
        self.device_graph = resolve_device_graph(device_graph, model)
        self._pool = CompiledStepPool(self._window, donate_argnums=(1,), static_argnums=(0, 9),
                                      name="FusedDecode window") if self.device_graph else None
        self._generators: dict = {}  # device -> the window's default generator, reseeded 0 each call

    def sample(self, logits: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        if self._topk is None:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        return self._topk(logits, generator)[1][:, 0].to(torch.int32)

    def _window(self, block_size, caches, tokens, positions, lens, block_tables, slot_blocks, slot_rows, generator,
                n_steps) -> torch.Tensor:
        out = []
        for i in range(n_steps):
            logits = decode_step(self.model, block_size, caches, tokens, positions[i], lens[i], block_tables,
                                 slot_blocks[i], slot_rows[i])
            tokens = self.sample(logits, generator)
            out.append(tokens)
        return torch.stack(out)

    @torch.inference_mode()
    def __call__(self, session: PagedAttentionRuntimeState, first_tokens, n_steps: int,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Returns tokens (n_steps, B) int32 on the device; the session's
        caches and lengths advance by ``n_steps``. Top-k draws from
        ``generator`` (default: one seeded 0 for the window)."""
        if generator is None and self._topk is not None:
            if session.device not in self._generators:
                self._generators[session.device] = torch.Generator(device=session.device)
            generator = self._generators[session.device].manual_seed(0)
        if n_steps == 0:
            return torch.empty((0, session.batch_size), dtype=torch.int32, device=session.device)
        arrays = session.decode_arrays(n_steps)
        tokens = _tokens(first_tokens)
        if self._pool is None:
            args = (session.block_size, session.caches, tokens.to(session.device), *map(session._tensor, arrays),
                    generator, n_steps)
            return self._window(*args)
        args = (session.block_size, session.caches, tokens, *map(torch.from_numpy, arrays), generator, n_steps)
        return self._pool.get_runner(*args)(*args)
