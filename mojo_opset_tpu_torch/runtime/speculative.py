"""Speculative decoding over the paged-KV runtime.

Counterpart of the JAX package's ``runtime/speculative.py:39-413``: a
draft model proposes ``k`` tokens per round and the target checks them in
ONE chunked-prefill forward (q_len = k + 1 per sequence, all positions'
logits). Rolling back rejected tokens rewinds the sessions' lengths; the
paged store overwrites the dead slots on the next round, and the
allocator reuses the blocks a rolled-back reserve left (session
``_reserve``).

Each round's metadata is built on the device from the lengths and the
block-table tensor: positions, the KV store's cache slots (a gather of
the block table), ``cu_q_lens = arange(B + 1) * (k + 1)`` and
``cu_total_seq_lens``. ``max_q_len = k + 1`` is a host int known in
advance (the prefill kernel sizes its grid with it); ``max_total_seq_len``
is read by no kernel, so the table's capacity serves. So ``fused_window``
keeps every round of a window on the device and reads back once; ``round``
reads back once per round. On the card (``device_graph``, as in
``PagedAttentionGenerationModel``) the draft's k + 1 steps and the
target's verify each replay from a CUDA graph keyed by the batch, ``k``
and the session, the JAX package's ``_draft_pool`` and ``_verify_pool``
(:58-93); the acceptance runs eagerly between them, and the prefill too.
The decoder keeps one pair of sessions per batch size for its generate
calls, renewed each call, so their graphs replay across calls.

Modes:
  * ``greedy``: draft greedy, target greedy, accept the longest matching
    prefix. Lossless: the stream equals vanilla greedy decoding of the
    target.
  * ``reject``: the simplified ``MojoRejectSampling`` contract (accept
    while target_p / draft_p >= u); the correction token is sampled from
    the target distribution at the first rejected position ``m``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from mojo_opset_tpu_torch.core.operators.sampling import MojoRejectSampling, sample_from_probs
from mojo_opset_tpu_torch.runtime.compile_cache import CompiledStepPool, resolve_device_graph
from mojo_opset_tpu_torch.runtime.session import (
    AttentionMetadata,
    PagedAttentionGenerationModel,
    PagedAttentionRuntimeState,
)


def _cache_slots(block_tables: torch.Tensor, positions: torch.Tensor, block_size: int):
    """Cache (block, row) of ``positions`` (B, n) of each sequence, as
    flat int64 tensors, from the device block table (B, max_blocks)."""
    blocks = torch.gather(block_tables, 1, (positions // block_size).long())
    return blocks.reshape(-1).long(), (positions % block_size).reshape(-1).long()


class SpeculativeDecoder:
    """Draft-model speculative decoding; both models share tokenizer and
    vocab. ``k`` draft tokens are proposed per round and verified by one
    chunked-prefill forward of the target."""

    def __init__(self, target_model, draft_model, k: int = 4, mode: str = "greedy", block_size: int = 128,
                 device_graph: Optional[bool] = None):
        if mode not in ("greedy", "reject"):
            raise ValueError(f"mode must be 'greedy' or 'reject', got {mode!r}")
        self.target = target_model
        self.draft = draft_model
        self.k = int(k)
        self.mode = mode
        self.block_size = block_size
        self.reject_op = MojoRejectSampling()
        self.device_graph = resolve_device_graph(device_graph, target_model)
        self._target_gm = PagedAttentionGenerationModel(target_model, block_size=block_size,
                                                        device_graph=self.device_graph)
        self._draft_gm = PagedAttentionGenerationModel(draft_model, block_size=block_size,
                                                       device_graph=self.device_graph)
        self._draft_pool = self._verify_pool = None
        if self.device_graph:
            self._draft_pool = CompiledStepPool(self._draft_steps, donate_argnums=(0,), static_argnums=(4, 5),
                                                name="speculative draft round")
            self._verify_pool = CompiledStepPool(self._verify, donate_argnums=(0,), name="speculative verify")
        self._sessions: dict = {}  # batch size -> the generate calls' sessions
        self.last_rounds = 0

    # -- session plumbing --------------------------------------------------
    def new_sessions(self, batch_size: int):
        t = PagedAttentionRuntimeState.from_model(self.target, batch_size, block_size=self.block_size)
        d = PagedAttentionRuntimeState.from_model(self.draft, batch_size, block_size=self.block_size)
        return t, d

    def prefill(self, sessions, input_ids, q_lens) -> torch.Tensor:
        """Prefill both models on the prompt; returns the target's first
        greedy token per sequence (device, int32)."""
        tsess, dsess = sessions
        logits, _ = self._target_gm(input_ids, context_input_len=q_lens, session=tsess)
        self._draft_gm(input_ids, context_input_len=q_lens, session=dsess)
        return torch.argmax(logits, dim=-1).to(torch.int32)

    @staticmethod
    def _rollback(session: PagedAttentionRuntimeState, new_lens: np.ndarray) -> None:
        """Rewind per-sequence lengths after rejected tokens; the blocks
        stay with the sequence."""
        session.total_seq_lens[:] = new_lens.astype(np.int32)

    # -- one round on the device ---------------------------------------------
    def _draft_steps(self, caches, cur, lens, block_tables, n_steps: int, with_probs: bool):
        """``n_steps`` greedy draft decode steps from ``cur`` at ``lens`` on
        the draft's ``caches``; returns tokens (B, n_steps) int32 and, with
        ``with_probs``, their softmax probabilities (B, n_steps)."""
        max_len = block_tables.shape[1] * self.block_size
        toks, probs = [], []
        tok = cur
        for i in range(n_steps):
            pos = lens + i
            meta = AttentionMetadata(
                cu_q_lens=None,
                total_seq_lens=pos + 1,
                block_tables=block_tables,
                is_prefill=False,
                token_indices=_cache_slots(block_tables, pos[:, None], self.block_size),
                max_total_seq_len=max_len,
            )
            logits = self.draft(tok, pos, meta, caches, lm_head_indices=None)
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
            toks.append(tok)
            if with_probs:
                p = torch.softmax(logits.float(), dim=-1)
                probs.append(torch.gather(p, 1, tok.long()[:, None])[:, 0])
        return torch.stack(toks, dim=1), (torch.stack(probs, dim=1) if with_probs else None)

    def _verify(self, caches, window, lens, block_tables) -> torch.Tensor:
        """One chunked prefill of the target over ``window`` (B, k+1) at
        ``lens`` on its ``caches``; returns the logits of every position
        (B, k+1, V)."""
        B, q = window.shape
        max_len = block_tables.shape[1] * self.block_size
        pos = lens[:, None] + torch.arange(q, dtype=torch.int32, device=lens.device)
        total = lens + q
        meta = AttentionMetadata(
            cu_q_lens=torch.arange(B + 1, dtype=torch.int32, device=lens.device) * q,
            total_seq_lens=total,
            block_tables=block_tables,
            is_prefill=True,
            token_indices=_cache_slots(block_tables, pos, self.block_size),
            cu_total_seq_lens=torch.cat([total.new_zeros(1), torch.cumsum(total, 0).to(torch.int32)]),
            max_q_len=q,
            max_total_seq_len=max_len,
        )
        logits = self.target(window.reshape(-1), pos.reshape(-1), meta, caches, lm_head_indices=None)
        return logits.reshape(B, q, -1)

    @staticmethod
    def _run(pool, fn, *args):
        """``fn(*args)`` replayed from ``pool``'s graph, or eagerly without one."""
        return fn(*args) if pool is None else pool.get_runner(*args)(*args)

    def _round_on_device(self, sessions, cur, lens, t_bt, d_bt, generator: Optional[torch.Generator]):
        """Draft k + 1 steps (the last stores d_k's KV, so a round that
        accepts all leaves the draft ready at context + k + 1), verify,
        accept. Returns device tensors ``emitted`` (B, k+1) int32, ``m``
        (B,) accepted drafts, ``next_cur`` (B,) int32: the correction or
        bonus token, which ``emitted[b, m[b]]`` also holds."""
        tsess, dsess = sessions
        k = self.k
        drafted, draft_p = self._run(self._draft_pool, self._draft_steps, dsess.caches, cur, lens, d_bt, k + 1,
                                     self.mode == "reject")
        d_toks = drafted[:, :k]
        logits = self._run(self._verify_pool, self._verify, tsess.caches, torch.cat([cur[:, None], d_toks], dim=1),
                           lens, t_bt)
        if self.mode == "greedy":
            t_arg = torch.argmax(logits, dim=-1).to(torch.int32)  # (B, k+1)
            match = (d_toks == t_arg[:, :k]).to(torch.int32)
            m = torch.where(match.all(dim=1), k, torch.argmin(match, dim=1))
            next_cur = torch.gather(t_arg, 1, m[:, None])[:, 0]
        else:
            probs = torch.softmax(logits.float(), dim=-1)
            _, m = self.reject_op(probs, d_toks, draft_p[:, :k], generator)
            pick = sample_from_probs(probs, generator)[..., 0]  # (B, k+1)
            next_cur = torch.gather(pick, 1, m[:, None])[:, 0].to(torch.int32)
        cols = torch.arange(k + 1, device=m.device)[None, :]
        emitted = torch.where(cols == m[:, None], next_cur[:, None], torch.cat([d_toks, torch.zeros_like(cur)[:, None]], 1))
        return emitted, m, next_cur

    def _begin(self, sessions, cur_tokens, budget: int):
        """Reserve ``budget`` tokens per sequence in both sessions; the
        round's device inputs."""
        tsess, dsess = sessions
        lens0 = tsess.total_seq_lens.copy()
        need = np.full(dsess.batch_size, budget, np.int32)
        tsess._reserve(need)
        dsess._reserve(need)
        cur = torch.as_tensor(cur_tokens, device=tsess.device).reshape(-1).to(torch.int32)
        return lens0, tsess._tensor(lens0), tsess._tensor(tsess.block_tables), dsess._tensor(dsess.block_tables), cur

    @torch.inference_mode()
    def round(self, sessions, cur_tokens, generator: Optional[torch.Generator] = None):
        """Advance every sequence by 1..k+1 tokens.

        Returns ``(emitted (B, k+1) int32, counts (B,) how many of the
        k+1 slots are real, next_cur_tokens (B,) on the device)``.
        ``cur_tokens`` is the last emitted token per sequence (not yet in
        either KV cache)."""
        lens0, lens, t_bt, d_bt, cur = self._begin(sessions, cur_tokens, self.k + 1)
        emitted, m, next_cur = self._round_on_device(sessions, cur, lens, t_bt, d_bt, generator)
        emitted, m = emitted.cpu().numpy(), m.cpu().numpy().astype(np.int64)
        for session in sessions:  # both caches keep exactly context + 1 + m valid rows
            self._rollback(session, lens0 + 1 + m)
        return emitted, m + 1, next_cur

    # -- fused window: every round of the window on the device ----------------
    @torch.inference_mode()
    def fused_window(self, sessions, cur_tokens, rounds: int):
        """Run ``rounds`` greedy rounds with the lengths on the device and
        one read-back at the end; blocks for the worst case (rounds * (k+1)
        tokens per sequence) are reserved up front.

        Returns ``(emitted (rounds, B, k+1) np.int32, counts (rounds, B)
        np.int64, next_cur (B,) on the device)``; both sessions' lengths
        are synced from the device afterwards."""
        if self.mode != "greedy":
            raise ValueError("fused windows support greedy mode only")
        lens0, lens, t_bt, d_bt, cur = self._begin(sessions, cur_tokens, rounds * (self.k + 1))
        emits, accepted = [], []
        for _ in range(rounds):
            emitted, m, cur = self._round_on_device(sessions, cur, lens, t_bt, d_bt, None)
            lens = lens + 1 + m.to(torch.int32)
            emits.append(emitted)
            accepted.append(m)
        B = lens.numel()
        flat = torch.cat([torch.stack(emits).reshape(-1).long(), torch.stack(accepted).reshape(-1), lens.long()])
        flat = flat.cpu().numpy()  # the window's one read-back
        n_emit = rounds * B * (self.k + 1)
        emitted = flat[:n_emit].reshape(rounds, B, self.k + 1).astype(np.int32)
        counts = flat[n_emit:n_emit + rounds * B].reshape(rounds, B) + 1
        for session in sessions:
            self._rollback(session, flat[n_emit + rounds * B:])
        return emitted, counts, cur

    # -- generate loops ------------------------------------------------------
    @staticmethod
    def _emit(out, filled, done, b, chunk, max_new_tokens, eos_token_id) -> None:
        """Append one round's real tokens of sequence ``b``, stopping at
        the budget and after its first EOS."""
        chunk = chunk[: int(max_new_tokens - filled[b])]
        if eos_token_id is not None:
            hits = np.nonzero(chunk == eos_token_id)[0]
            if hits.size:
                chunk = chunk[: int(hits[0]) + 1]
                done[b] = True
        out[b, filled[b]:filled[b] + chunk.size] = chunk
        filled[b] += chunk.size

    def _sessions_for(self, batch_size: int):
        """Sessions for a generate call: new ones, or with graphs the
        decoder's pair for this batch size, renewed, whose graphs replay."""
        if not self.device_graph:
            return self.new_sessions(batch_size)
        if batch_size not in self._sessions:
            self._sessions[batch_size] = self.new_sessions(batch_size)
        for session in self._sessions[batch_size]:
            session.renew()
        return self._sessions[batch_size]

    def _start(self, input_ids, q_lens, max_new_tokens, eos_token_id):
        q_lens = np.asarray(q_lens, np.int32)
        B = q_lens.size
        sessions = self._sessions_for(B)
        cur = self.prefill(sessions, input_ids, q_lens)
        out = np.zeros((B, max_new_tokens), np.int32)
        out[:, 0] = cur.cpu().numpy()  # the first token comes from the prefill
        filled = np.ones(B, np.int64)
        done = np.zeros(B, bool) if eos_token_id is None else out[:, 0] == eos_token_id
        return sessions, cur, out, filled, done

    @staticmethod
    def _finish(out, filled, done, eos_token_id):
        """After a sequence's first EOS every slot holds EOS, as in the
        generator loop's batch-serving semantics."""
        if eos_token_id is not None:
            for b in np.nonzero(done & (filled < out.shape[1]))[0]:
                out[b, filled[b]:] = eos_token_id
        return out

    def generate_fused(self, input_ids, q_lens, max_new_tokens: int, eos_token_id: Optional[int] = None,
                       rounds_per_window: Optional[int] = None) -> np.ndarray:
        """Greedy speculative generate in fused windows: the same stream as
        :meth:`generate` (both lossless against vanilla greedy); the host
        reads the device once per window."""
        sessions, cur, out, filled, done = self._start(input_ids, q_lens, max_new_tokens, eos_token_id)
        # the first window is sized for full acceptance (k+1 tokens a
        # round); where acceptance ran lower, small windows top it up
        if rounds_per_window is None:
            rounds_per_window = max(1, -(-(int(max_new_tokens) - 1) // (self.k + 1)))
        topup = min(4, rounds_per_window)
        rounds, first = 0, True
        while ((filled < max_new_tokens) & ~done).any():
            w = rounds_per_window if first else topup
            first = False
            emitted, counts, cur = self.fused_window(sessions, cur, w)
            rounds += w
            for r in range(w):
                for b in range(out.shape[0]):
                    if not done[b] and filled[b] < max_new_tokens:
                        self._emit(out, filled, done, b, emitted[r, b, :counts[r, b]], max_new_tokens, eos_token_id)
        self.last_rounds = rounds
        return self._finish(out, filled, done, eos_token_id)

    def generate(self, input_ids, q_lens, max_new_tokens: int, generator: Optional[torch.Generator] = None,
                 eos_token_id: Optional[int] = None) -> np.ndarray:
        """Speculative generate; returns (B, max_new_tokens) ids. With
        ``eos_token_id``, everything after a sequence's first EOS is EOS.
        ``reject`` mode draws from ``generator`` (default: one seeded 0)."""
        sessions, cur, out, filled, done = self._start(input_ids, q_lens, max_new_tokens, eos_token_id)
        if self.mode == "reject" and generator is None:
            # each round draws fresh acceptance and correction randomness
            generator = torch.Generator(device=cur.device).manual_seed(0)
        rounds = 0
        while ((filled < max_new_tokens) & ~done).any():
            emitted, counts, cur = self.round(sessions, cur, generator=generator)
            for b in range(out.shape[0]):
                if not done[b]:
                    self._emit(out, filled, done, b, emitted[b, :counts[b]], max_new_tokens, eos_token_id)
            rounds += 1
        self.last_rounds = rounds
        return self._finish(out, filled, done, eos_token_id)
