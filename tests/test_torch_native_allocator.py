"""The port's native (C++) block allocator and the session's reserve.

The nine cases of the JAX package's tests/base/test_native_allocator.py on
the port's copy of the allocator, then: a randomized reserve / release /
rollback sequence in which the port's native path, its numpy path and the
JAX session give bit-identical tables and free counts; a failed reserve
(a sequence past its table, or more blocks than are free) that leaves
either port path exactly as it was and raises the JAX session's
``ValueError`` (ROADMAP queue 3, Repaired: the reserve); the tables staying the
session's own buffers; ``MOJO_NATIVE``.
"""

import numpy as np
import pytest
import torch

from mojo_opset_tpu_torch.runtime import native as native_mod
from mojo_opset_tpu_torch.runtime.config import MojoConfig, MojoModelConfig
from mojo_opset_tpu_torch.runtime.native import NativeBlockAllocator, native_available
from mojo_opset_tpu_torch.runtime.session import PagedAttentionRuntimeState

PATHS = ("native", "numpy")


def _python_reserve(q_lens, seq_lens, block_tables, free_blocks, num_free, block_size):
    prev = seq_lens.copy()
    for i in range(len(seq_lens)):
        oldb = -(-int(prev[i]) // block_size)
        newb = -(-(int(prev[i]) + int(q_lens[i])) // block_size)
        if newb > oldb:
            n = newb - oldb
            if n > num_free:
                raise ValueError("oom")
            block_tables[i, oldb:newb] = free_blocks[num_free - n : num_free]
            num_free -= n
    seq_lens += q_lens
    return prev, num_free


def _config(max_pos=64, **kw):
    return MojoConfig(model_config=MojoModelConfig(
        model_name="t", hidden_size=32, head_dim=16, num_heads=2, num_kv_heads=1, num_layers=1, vocab_size=64,
        max_position_embeddings=max_pos, dtype=torch.float32, **kw))


def _session(monkeypatch, path, batch=2, block_size=8, max_pos=64):
    monkeypatch.setenv("MOJO_NATIVE", "1" if path == "native" else "0")
    session = PagedAttentionRuntimeState(_config(max_pos), batch_size=batch, block_size=block_size, device="cpu")
    assert session.allocator == path
    return session


def _state(session):
    return session.block_tables.copy(), session.total_seq_lens.copy(), session.free_block_count()


# ---------------------------------------------------------------- JAX's cases


def test_reserve_parity_randomized():
    rng = np.random.default_rng(0)
    B, MBS, bs = 4, 16, 8
    total = B * MBS
    nat = NativeBlockAllocator(B, MBS, total, bs)
    n_seq = np.zeros(B, np.int32)
    n_bt = np.full((B, MBS), -1, np.int32)
    p_seq = np.zeros(B, np.int32)
    p_bt = np.full((B, MBS), -1, np.int32)
    p_free = np.arange(total, dtype=np.int32)
    p_nfree = total
    for _ in range(10):
        q = rng.integers(0, 6, B).astype(np.int32)
        ctx_n = nat.reserve(q, n_seq, n_bt)
        ctx_p, p_nfree = _python_reserve(q, p_seq, p_bt, p_free, p_nfree, bs)
        np.testing.assert_array_equal(ctx_n, ctx_p)
        np.testing.assert_array_equal(n_seq, p_seq)
        np.testing.assert_array_equal(n_bt, p_bt)
        assert nat.num_free_blocks == p_nfree


def test_oom_is_transactional():
    nat = NativeBlockAllocator(2, 8, 8, 4)
    seq = np.zeros(2, np.int32)
    bt = np.full((2, 8), -1, np.int32)
    nat.reserve(np.array([16, 12], np.int32), seq, bt)  # 4 + 3 blocks
    seq_before, bt_before = seq.copy(), bt.copy()
    with pytest.raises(ValueError, match="Out of paged KV cache memory"):
        nat.reserve(np.array([0, 16], np.int32), seq, bt)  # needs 4, has 1
    np.testing.assert_array_equal(seq, seq_before)
    np.testing.assert_array_equal(bt, bt_before)
    assert nat.num_free_blocks == 1


def test_per_seq_table_overflow():
    nat = NativeBlockAllocator(1, 2, 8, 4)
    seq = np.zeros(1, np.int32)
    bt = np.full((1, 2), -1, np.int32)
    with pytest.raises(ValueError, match="max_blocks_per_seq"):
        nat.reserve(np.array([12], np.int32), seq, bt)


def test_release_and_reuse():
    nat = NativeBlockAllocator(2, 4, 8, 4)
    seq = np.zeros(2, np.int32)
    bt = np.full((2, 4), -1, np.int32)
    nat.reserve(np.array([8, 8], np.int32), seq, bt)
    assert nat.num_free_blocks == 4
    nat.release(0, seq, bt)
    assert nat.num_free_blocks == 6
    assert seq[0] == 0 and (bt[0] == -1).all()
    nat.reserve(np.array([16, 0], np.int32), seq, bt)  # released blocks are reusable
    assert nat.num_free_blocks == 2
    assert (bt[0, :4] >= 0).all()


def test_session_uses_native_and_matches_fallback(monkeypatch):
    """A session on the native allocator and one on numpy give identical
    tables across prefill and decode."""
    sessions = []
    for path in PATHS:
        s = _session(monkeypatch, path)
        s.prepare_prefill_inputs(np.arange(10, dtype=np.int32), np.array([6, 4], np.int32))
        for _ in range(5):
            s.decode_arrays()
        sessions.append(s)
    a, b = sessions
    assert a._native is not None and b._native is None
    np.testing.assert_array_equal(a.block_tables, b.block_tables)
    np.testing.assert_array_equal(a.total_seq_lens, b.total_seq_lens)
    assert a.free_block_count() == b.free_block_count()


@pytest.mark.parametrize("path", PATHS)
def test_release_after_rollback_no_leak(monkeypatch, path):
    """A rollback (speculative rewind) leaks no block on release."""
    sess = _session(monkeypatch, path, batch=1, block_size=16, max_pos=256)
    free0 = sess.free_block_count()
    for _ in range(10):
        # grow to 15, reserve 4 (crosses into a 2nd block), rewind to 16
        sess.total_seq_lens[:] = 0
        sess._reserve(np.array([15], np.int32))
        sess._reserve(np.array([4], np.int32))
        sess.total_seq_lens[:] = np.int32(16)
        sess.release_sequence(0)
    assert sess.free_block_count() == free0, f"leaked {free0 - sess.free_block_count()} blocks after rollbacks"


@pytest.mark.parametrize("path", PATHS)
def test_reserve_reuse_after_rollback(monkeypatch, path):
    """A reserve after a rollback reuses the entry the sequence still owns
    instead of overwriting it with a fresh block."""
    sess = _session(monkeypatch, path, batch=1, block_size=16, max_pos=256)
    sess._reserve(np.array([15], np.int32))
    sess._reserve(np.array([4], np.int32))  # crosses into block 2
    owned = int(sess.block_tables[0, 1])
    assert owned >= 0
    sess.total_seq_lens[:] = np.int32(16)  # speculative rewind
    free_before = sess.free_block_count()
    sess._reserve(np.array([4], np.int32))  # 16 -> 20, needs block 2
    assert int(sess.block_tables[0, 1]) == owned, "entry not reused"
    assert sess.free_block_count() == free_before, "allocated a duplicate"


# ---------------------------------------------------------------- against JAX's session


def _jax_session(monkeypatch, batch, block_size, max_pos):
    import jax.numpy as jnp

    from mojo_opset_tpu.runtime.config import MojoConfig as JaxConfig
    from mojo_opset_tpu.runtime.config import MojoModelConfig as JaxModelConfig
    from mojo_opset_tpu.runtime.session import PagedAttentionRuntimeState as JaxSession

    monkeypatch.setenv("MOJO_NATIVE", "1")  # JAX's transactional allocator
    cfg = JaxConfig(model_config=JaxModelConfig(
        num_layers=1, hidden_size=32, num_heads=2, num_kv_heads=1, head_dim=16, vocab_size=64,
        max_position_embeddings=max_pos, dtype=jnp.float32))
    session = JaxSession(cfg, batch_size=batch, block_size=block_size)
    assert session._native is not None
    return session


def _apply(session, op, arg):
    """One step of the sequence; ``"raised"`` where the session refused it."""
    if op == "reserve":
        try:
            return session._reserve(arg).tolist()
        except ValueError as exc:
            return str(exc)
    if op == "release":
        session.release_sequence(arg)
    else:  # rewind: a speculative rollback of ``arg`` tokens on every sequence
        session.total_seq_lens[:] = np.maximum(session.total_seq_lens - arg, 0)
    return None


def test_randomized_sequence_equals_jax_session(monkeypatch):
    rng = np.random.default_rng(24)
    B, bs, max_pos = 3, 8, 96  # 12 blocks a sequence, 36 in all
    steps = []
    for _ in range(120):
        kind = rng.choice(["reserve", "reserve", "reserve", "release", "rewind"])
        if kind == "reserve":
            steps.append(("reserve", rng.integers(0, 30, B).astype(np.int32)))
        elif kind == "release":
            steps.append(("release", int(rng.integers(0, B))))
        else:
            steps.append(("rewind", int(rng.integers(1, 6))))
    jax_session = _jax_session(monkeypatch, B, bs, max_pos)
    ports = [_session(monkeypatch, path, batch=B, block_size=bs, max_pos=max_pos) for path in PATHS]
    refused = 0
    for op, arg in steps:
        want = _apply(jax_session, op, arg)
        refused += isinstance(want, str)
        for port in ports:
            assert _apply(port, op, arg) == want, (op, arg, port.allocator)
            np.testing.assert_array_equal(port.block_tables, jax_session.block_tables)
            np.testing.assert_array_equal(port.total_seq_lens, jax_session.total_seq_lens)
            assert port.free_block_count() == jax_session.free_block_count()
        native, numpy_ = ports  # one free stack, in one order
        np.testing.assert_array_equal(native.free_blocks[:native.free_block_count()],
                                      numpy_.free_blocks[:numpy_.free_block_count()])
    assert refused >= 5  # the sequence runs out of blocks and past tables, not only the happy path


# ---------------------------------------------------------------- the repair: a transactional reserve


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("q_lens", ([16, 80], [80, 0]))
def test_failed_reserve_changes_nothing(monkeypatch, path, q_lens):
    """A tiny Qwen3's session (max_position_embeddings 64, batch 2, block 16:
    4 blocks a sequence, 8 in all): 80 tokens overflow a table. JAX's
    session raises ``ValueError`` and keeps every block; the port's
    numpy path once took blocks row by row and raised ``IndexError``,
    leaking five (``reset`` releases only rows with a length)."""
    session = _session(monkeypatch, path, block_size=16, max_pos=64)
    before = _state(session)
    tables, lens = session.block_tables, session.total_seq_lens
    with pytest.raises(ValueError, match="sequence exceeds max_blocks_per_seq"):
        session._reserve(np.array(q_lens, np.int32))
    after = _state(session)
    np.testing.assert_array_equal(after[0], before[0])
    np.testing.assert_array_equal(after[1], before[1])
    assert after[2] == before[2] == 8
    assert session.block_tables is tables and session.total_seq_lens is lens
    jax_session = _jax_session(monkeypatch, 2, 16, 64)
    with pytest.raises(ValueError, match="sequence exceeds max_blocks_per_seq"):
        jax_session._reserve(np.array(q_lens, np.int32))
    assert jax_session.free_block_count() == 8 and (jax_session.block_tables == -1).all()


@pytest.mark.parametrize("path", PATHS)
def test_out_of_blocks_changes_nothing(monkeypatch, path):
    """Running out of blocks (five of eight held elsewhere, as a prefix
    cache holds them) refuses the whole reserve before row 0 takes any."""
    session = _session(monkeypatch, path, block_size=16, max_pos=64)
    held = session._allocate_blocks(5)
    np.testing.assert_array_equal(held, [3, 4, 5, 6, 7])
    before = _state(session)
    with pytest.raises(ValueError, match="Out of paged KV cache memory"):
        session._reserve(np.array([32, 32], np.int32))  # 2 + 2 blocks, 3 free
    after = _state(session)
    for got, want in zip(after[:2], before[:2]):
        np.testing.assert_array_equal(got, want)
    assert after[2] == before[2] == 3
    session._reserve(np.array([32, 16], np.int32))  # 3 blocks fit
    np.testing.assert_array_equal(session.block_tables[:, :2], [[2, 1], [0, -1]])
    assert session.free_block_count() == 0


@pytest.mark.parametrize("path", PATHS)
def test_tables_stay_the_sessions_buffers(monkeypatch, path):
    """Reserve, release, renew and ``_allocate_blocks`` update the tables and
    the free stack in place (the native allocator works on the session's
    own buffers); the step's metadata holds copies, never views of them."""
    session = _session(monkeypatch, path)
    tables, lens, stack = session.block_tables, session.total_seq_lens, session.free_blocks
    if path == "native":
        assert session._native.free_blocks is stack and session._native.num_free is session._num_free
    _, _, meta = session.prepare_prefill_inputs(np.arange(9, dtype=np.int32), np.array([5, 4], np.int32))
    seen = meta.total_seq_lens.clone(), meta.block_tables.clone()
    session.decode_arrays(3)
    assert torch.equal(meta.total_seq_lens, seen[0]) and torch.equal(meta.block_tables, seen[1])
    session.release_sequence(1)
    assert session.free_block_count() == 16 - 1
    np.testing.assert_array_equal(session._allocate_blocks(3), [12, 13, 14])
    assert session.free_block_count() == 12
    session.renew()
    assert session.block_tables is tables and session.total_seq_lens is lens and session.free_blocks is stack
    assert (tables == -1).all() and (lens == 0).all() and session.free_block_count() == 16
    np.testing.assert_array_equal(stack, np.arange(16))
    with pytest.raises(ValueError, match="Out of paged KV cache memory"):
        session._allocate_blocks(17)
    assert session.free_block_count() == 16


def test_mojo_native_selects_and_requires(monkeypatch):
    monkeypatch.setenv("MOJO_NATIVE", "0")
    assert not native_available()
    monkeypatch.delenv("MOJO_NATIVE")
    assert native_available()  # g++ builds it here
    assert native_mod.library_path().exists()
    assert native_mod.library_path().parent.name == "_build"
    # a library that does not build: the numpy path by default, an error under MOJO_NATIVE=1
    monkeypatch.setattr(native_mod, "_lib", None)
    monkeypatch.setattr(native_mod, "_lib_tried", False)
    monkeypatch.setattr(native_mod, "build", lambda: (_ for _ in ()).throw(OSError("no compiler")))
    assert not native_available()
    assert PagedAttentionRuntimeState(_config(), batch_size=1, block_size=8, device="cpu").allocator == "numpy"
    monkeypatch.setenv("MOJO_NATIVE", "1")
    with pytest.raises(RuntimeError, match="MOJO_NATIVE=1 but the native allocator did not build: no compiler"):
        PagedAttentionRuntimeState(_config(), batch_size=1, block_size=8, device="cpu")
