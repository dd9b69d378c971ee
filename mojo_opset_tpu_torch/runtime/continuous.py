"""Continuous batching over the paged-KV session.

Counterpart of the JAX package's ``runtime/continuous.py:30-475``: a fixed
pool of B slots decodes in lock-step; a finished sequence releases its KV
blocks to the pool (``session.release_sequence``, host-side allocator),
and queued requests enter free slots through one mixed prefill whose
``q_lens`` are zero except at the admitted slots. Admission can run in
chunks (``max_prefill_chunk``), reuse cached prompt prefixes
(``prefix_cache_blocks``) and pad its token count to a bucket through a
scratch slot (``bucket_admits``); decode can run in windows of
``decode_window`` steps (``FusedDecode``). ``SpeculativeContinuousBatchingGenerator``
advances every slot by speculative rounds (``SpeculativeDecoder.round``).

On the card (``device_graph``, as in ``PagedAttentionGenerationModel``)
the decode steps, windows and rounds replay from CUDA graphs: the
batcher's session and slots persist, so one graph per window length (and
one per step, draft round and verify) serves every round; an admission
only rewrites the block table and the lengths that each replay copies in.
"""

from __future__ import annotations

from collections import deque
from typing import List, Optional, Sequence

import numpy as np
import torch

from mojo_opset_tpu_torch.runtime.compile_cache import BUCKETS as ADMIT_BUCKETS
from mojo_opset_tpu_torch.runtime.compile_cache import round_up_bucket
from mojo_opset_tpu_torch.runtime.session import FusedDecode, PagedAttentionGenerationModel
from mojo_opset_tpu_torch.runtime.speculative import SpeculativeDecoder


class ContinuousBatchingGenerator:
    """Continuous-batching serving loop, greedy unless given a sampler.

    ``submit(ids)`` enqueues a request and returns its request id;
    ``run()`` drains the queue and returns outputs keyed by request id.
    """

    def __init__(self, model, batch_slots: int = 8, block_size: int = 128,
                 max_new_tokens: int = 64, eos_token_id: Optional[int] = None,
                 pad_token_id: int = 0, decode_window: int = 1,
                 bucket_admits: bool = False,
                 max_prefill_chunk: Optional[int] = None,
                 sampler=None, seed: int = 0,
                 prefix_cache_blocks: int = 0, device_graph: Optional[bool] = None):
        self.gm = PagedAttentionGenerationModel(model, block_size=block_size, device_graph=device_graph)
        self.B = batch_slots
        self.block_size = block_size
        self.max_new_tokens = max_new_tokens
        self.eos_token_id = eos_token_id
        self.pad_token_id = pad_token_id
        # bucket_admits: every admission's total token count is padded to a
        # bucket in a scratch slot, so the real slots' q_lens stay exact
        # (causal attention and last-token logits untouched); the scratch
        # slot's garbage blocks are released before every admission
        self.bucket_admits = bool(bucket_admits)
        self._scratch = batch_slots if bucket_admits else None
        self._nslots = batch_slots + (1 if bucket_admits else 0)
        # admit long prompts in chunks of at most this many tokens (chunked
        # prefill: context > 0 with is_prefill); bounds the latency spike a
        # long prompt gives its decoding neighbours
        self.max_prefill_chunk = max_prefill_chunk
        self._pending: List[Optional[np.ndarray]] = [None] * self.B  # unprefilled prompt remainder
        # any MojoSampler; greedy argmax when None (decode_window fuses
        # greedy sampling, so a sampler takes the step-by-step path)
        self.sampler = sampler
        self._generator = torch.Generator(device=next(model.parameters()).device).manual_seed(seed)
        if sampler is not None and decode_window > 1:
            raise ValueError("decode_window > 1 currently implies greedy sampling")
        # Prefix caching: when a request completes, the KV blocks its
        # prompt fills are donated to a host-side cache keyed by the
        # prompt prefix; a later request with a matching block-aligned
        # prefix points its block table at the shared (read-only) blocks
        # and prefills only the suffix. Cache-owned blocks are withheld
        # from the pool up to ``prefix_cache_blocks``; 0 disables.
        self.prefix_cache_blocks = int(prefix_cache_blocks)
        self._prefix_cache: dict = {}  # prompt-prefix bytes -> block ids
        self._prefix_block_ids: set = set()  # cache-owned, withheld from the pool
        self._prefix_owned = 0
        self._slot_shared_blocks: List[int] = [0] * self.B  # leading shared blocks
        self._slot_prompt: List[Optional[np.ndarray]] = [None] * self.B
        # decode_window > 1: windows of lock-step steps (FusedDecode)
        # between admission checks; finished slots decode garbage for the
        # rest of the window, truncated at EOS and reclaimed on admission
        self.decode_window = max(1, int(decode_window))
        self._fused = FusedDecode(model, device_graph=device_graph) if self.decode_window > 1 else None
        self.session = None
        self._queue: deque = deque()
        self._next_id = 0
        # per-slot state (the scratch slot, if any, has none)
        self._req_id = [-1] * self.B
        self._out: List[List[int]] = [[] for _ in range(self.B)]
        self._cur = np.full(self._nslots, pad_token_id, np.int32)
        self._results = {}

    def submit(self, ids: Sequence[int]) -> int:
        ids = np.asarray(ids, np.int32).reshape(-1)
        if ids.size == 0:
            # a zero-length admission would read its neighbour's logits row
            raise ValueError("empty prompt")
        rid = self._next_id
        self._next_id += 1
        self._queue.append((rid, ids))
        return rid

    # -- internals -----------------------------------------------------------
    def _free_slots(self) -> List[int]:
        return [s for s in range(self.B) if self._req_id[s] < 0]

    def _pop_admitted(self):
        """(slot, request id, prompt) for each free slot the queue fills."""
        return [(s, *self._queue.popleft()) for s in self._free_slots()[:len(self._queue)]]

    def _prefill_call(self, q_lens: np.ndarray, chunks: dict) -> np.ndarray:
        """One mixed varlen prefill; returns each slot's last-token
        sample (garbage for the zero-length slots, never read)."""
        if self.bucket_admits:
            if int(self.session.total_seq_lens[self._scratch]) > 0:
                self.session.release_sequence(self._scratch)
            total = int(q_lens.sum())
            q_lens[self._scratch] = round_up_bucket(total, ADMIT_BUCKETS) - total
            chunks[self._scratch] = np.full(q_lens[self._scratch], self.pad_token_id, np.int32)
        flat = [chunks[s] for s in range(self._nslots) if q_lens[s]]
        flat = np.concatenate(flat) if flat else np.empty((0,), np.int32)
        logits, self.session = self.gm(flat, context_input_len=q_lens, session=self.session)
        return self._sample(logits)

    def _sample(self, logits: torch.Tensor) -> np.ndarray:
        if self.sampler is None:
            return torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()
        return self.sampler(logits, generator=self._generator).cpu().numpy().astype(np.int32)

    def _start_slot(self, s: int, tok: int) -> None:
        self._out[s] = [tok]
        self._cur[s] = tok
        self._maybe_finish(s, tok)

    def _admit(self) -> None:
        """Fill free slots from the queue with one mixed prefill (long
        prompts enter in chunks when ``max_prefill_chunk`` is set)."""
        admitted = self._pop_admitted()
        if not admitted:
            return
        q_lens = np.zeros(self._nslots, np.int32)
        chunks = {}
        for s, _, ids in admitted:
            if int(self.session.total_seq_lens[s]) > 0:
                self._release_slot(s)  # reclaim a parked slot's blocks
            self._slot_prompt[s] = ids
            n_tok, shared_ids = self._prefix_lookup(ids)
            if n_tok:
                # the table's head points at the shared blocks; only the
                # suffix is prefilled, from context n_tok
                nb = n_tok // self.session.block_size
                self.session.block_tables[s, :nb] = shared_ids[:nb]
                self.session.total_seq_lens[s] = n_tok
                self._slot_shared_blocks[s] = nb
                ids = ids[n_tok:]
            c = self.max_prefill_chunk
            if c is not None and ids.size > c:
                chunks[s], self._pending[s] = ids[:c], ids[c:]
            else:
                chunks[s], self._pending[s] = ids, None
            q_lens[s] = chunks[s].size
        first = self._prefill_call(q_lens, chunks)
        for s, rid, _ in admitted:
            self._req_id[s] = rid
            if self._pending[s] is None:
                self._start_slot(s, int(first[s]))

    def _continue_prefill(self) -> bool:
        """Advance partially prefilled prompts by one chunk; True if any
        slot was mid-prefill."""
        pend = [s for s in range(self.B) if self._pending[s] is not None]
        if not pend:
            return False
        q_lens = np.zeros(self._nslots, np.int32)
        chunks = {}
        completing = []
        c = self.max_prefill_chunk
        for s in pend:
            ids = self._pending[s]
            if ids.size > c:
                chunks[s], self._pending[s] = ids[:c], ids[c:]
            else:
                chunks[s], self._pending[s] = ids, None
                completing.append(s)
            q_lens[s] = chunks[s].size
        first = self._prefill_call(q_lens, chunks)
        for s in completing:
            self._start_slot(s, int(first[s]))
        return True

    # -- prefix caching -------------------------------------------------------
    def _longest_cached(self, prompt: np.ndarray, n_max: int):
        """Longest cached block-aligned prefix of at most ``n_max`` tokens.
        Every shorter full-block prefix of a cached one is cached too, so
        an ascending scan that stops at the first miss is exact."""
        bs = self.session.block_size
        n, hit = 0, None
        m = bs
        while m <= n_max:
            h = self._prefix_cache.get(prompt[:m].tobytes())
            if h is None:
                break
            n, hit = m, h
            m += bs
        return n, hit

    def _prefix_lookup(self, prompt: np.ndarray):
        """Longest cached block-aligned proper prefix (at least one token
        stays to prefill, so the admission gets logits)."""
        if not self.prefix_cache_blocks or self.session is None:
            return 0, None
        bs = self.session.block_size
        return self._longest_cached(prompt, (int(prompt.size) - 1) // bs * bs)

    def _prefix_donate(self, s: int) -> None:
        """Donate a finished slot's full prompt blocks to the cache."""
        if not self.prefix_cache_blocks:
            return
        prompt = self._slot_prompt[s]
        if prompt is None or self._pending[s] is not None:
            return
        bs = self.session.block_size
        n_full = int(prompt.size) // bs
        # what is cached now: a request with the same prompt may have
        # donated since this slot was admitted, and donating its duplicate
        # blocks would withhold them from the pool with no entry naming them
        m_tok, head = self._longest_cached(prompt, n_full * bs)
        m = m_tok // bs
        if n_full <= m:
            return  # cached already; this slot's blocks are freed
        row = self.session.block_tables[s]
        new_ids = [int(row[b]) for b in range(m, n_full)]
        if any(i < 0 for i in new_ids) or self._prefix_owned + len(new_ids) > self.prefix_cache_blocks:
            return
        # the chain's head is the cached blocks (this slot's own head
        # blocks up to m are duplicates, released with the slot)
        chain = ([int(b) for b in head[:m]] if head is not None else []) + new_ids
        for nb in range(m + 1, n_full + 1):
            self._prefix_cache[prompt[: nb * bs].tobytes()] = np.asarray(chain[:nb], np.int32)
        self._prefix_block_ids.update(new_ids)
        self._prefix_owned += len(new_ids)

    def _release_slot(self, s: int) -> None:
        """Release a real slot: cache-owned block ids leave its row first,
        so only the slot's own blocks return to the pool."""
        if self._prefix_block_ids:
            row = self.session.block_tables[s]
            row[np.isin(row, np.fromiter(self._prefix_block_ids, np.int32))] = -1
        self.session.release_sequence(s)
        self._slot_shared_blocks[s] = 0
        self._slot_prompt[s] = None

    def _maybe_finish(self, s: int, tok: int) -> None:
        done = len(self._out[s]) >= self.max_new_tokens or (
            self.eos_token_id is not None and tok == self.eos_token_id)
        if done:
            self._results[self._req_id[s]] = np.asarray(self._out[s], np.int32)
            self._req_id[s] = -1
            self._out[s] = []
            self._prefix_donate(s)
            self._release_slot(s)
            self._cur[s] = self.pad_token_id

    def _active(self) -> List[int]:
        return [s for s in range(self.B) if self._req_id[s] >= 0]

    def _append(self, s: int, tok: int) -> None:
        self._out[s].append(tok)
        self._cur[s] = tok
        self._maybe_finish(s, tok)

    def _ensure_sessions(self) -> None:
        if self.session is None:
            self.session = self.gm._new_session(None, np.ones(self._nslots, np.int32))

    def run(self):
        """Drain the queue; returns {request_id: np.ndarray of new tokens}."""
        self._ensure_sessions()
        while self._queue or self._active():
            self._admit()
            if self._continue_prefill():
                continue  # no decode while any slot is mid-prefill
            if not self._active():
                continue
            if self._fused is not None:
                # the tightest remaining budget bounds the window, so no
                # active slot overshoots max_new_tokens
                w = max(1, min(self.decode_window,
                               min(self.max_new_tokens - len(self._out[s]) for s in self._active())))
                window = self._fused(self.session, torch.from_numpy(self._cur), w).cpu().numpy()  # (w, slots)
                for t in range(w):
                    for s in self._active():
                        self._append(s, int(window[t, s]))
                continue
            # lock-step decode: parked slots feed pad tokens into slot-local
            # garbage that admission reclaims
            logits, self.session = self.gm(self._cur, session=self.session)
            toks = self._sample(logits)
            for s in self._active():
                self._append(s, int(toks[s]))
        out, self._results = self._results, {}
        return out


class SpeculativeContinuousBatchingGenerator(ContinuousBatchingGenerator):
    """Continuous batching + speculative decoding: each round advances
    every active slot by 1..k+1 tokens (``SpeculativeDecoder.round``: k
    draft steps and one chunked-prefill verify); admission refills freed
    slots on both sessions. Greedy and lossless, like its parts."""

    def __init__(self, model, draft_model, speculative_k: int = 4, **kw):
        kw.pop("decode_window", None)  # the speculative round is the window
        if kw.pop("bucket_admits", False):
            raise ValueError("bucket_admits is not supported with speculative rounds yet")
        if kw.pop("max_prefill_chunk", None) is not None:
            raise ValueError("chunked-prefill admission is not supported with speculative rounds yet")
        if kw.pop("prefix_cache_blocks", 0):
            raise ValueError("prefix caching is not supported with speculative rounds yet")
        if kw.get("sampler") is not None:
            raise ValueError("speculative rounds are greedy-only; a sampler would be silently ignored")
        super().__init__(model, **kw)
        self.spec = SpeculativeDecoder(model, draft_model, k=speculative_k, mode="greedy",
                                       block_size=self.block_size, device_graph=kw.get("device_graph"))
        self.dgm = PagedAttentionGenerationModel(draft_model, block_size=self.block_size,
                                                 device_graph=kw.get("device_graph"))
        self.dsession = None

    def _ensure_sessions(self) -> None:
        super()._ensure_sessions()
        if self.dsession is None:
            self.dsession = self.dgm._new_session(None, np.ones(self.B, np.int32))

    def _release_slot(self, s: int) -> None:
        super()._release_slot(s)
        if self.dsession is not None:
            self.dsession.release_sequence(s)

    def _admit(self) -> None:
        admitted = self._pop_admitted()
        if not admitted:
            return
        q_lens = np.zeros(self.B, np.int32)
        chunks = {s: ids for s, _, ids in admitted}
        for s, _, ids in admitted:
            if int(self.session.total_seq_lens[s]) > 0 or int(self.dsession.total_seq_lens[s]) > 0:
                self._release_slot(s)
            q_lens[s] = ids.size
        flat = np.concatenate([chunks[s] for s in range(self.B) if q_lens[s]])
        logits, self.session = self.gm(flat, context_input_len=q_lens, session=self.session)
        _, self.dsession = self.dgm(flat, context_input_len=q_lens, session=self.dsession)
        first = torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()
        for s, rid, _ in admitted:
            self._req_id[s] = rid
            self._start_slot(s, int(first[s]))

    def run(self):
        self._ensure_sessions()
        while self._queue or self._active():
            self._admit()
            if not self._active():
                continue
            emitted, counts, next_cur = self.spec.round((self.session, self.dsession), self._cur)
            next_cur = next_cur.cpu().numpy()
            for s in self._active():
                chunk = emitted[s, :min(int(counts[s]), self.max_new_tokens - len(self._out[s]))]
                if self.eos_token_id is not None:
                    hits = np.nonzero(chunk == self.eos_token_id)[0]
                    if hits.size:
                        chunk = chunk[: int(hits[0]) + 1]
                self._out[s].extend(int(t) for t in chunk)
                self._cur[s] = next_cur[s]
                # a chunk cut at EOS ends in EOS, one cut at the budget fills it: both finish here
                self._maybe_finish(s, int(chunk[-1]))
        out, self._results = self._results, {}
        return out
