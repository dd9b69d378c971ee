"""Port parity for Multi-head Latent Attention: the four MLA goldens, the
latent store and kernel I's plain version of mojo_opset_tpu_torch against
mojo_opset_tpu, on the CPU.

The same numpy inputs (``np.random.default_rng``) and the same
``kv_b_proj`` go through the JAX op and the port's op. The goldens are
held to JAX's golden tier; kernel I's plain version (what the port's
``cuda`` tier runs on CPU tensors) to JAX's Pallas kernel in interpret
mode, which is how the JAX package runs it on the CPU, and to JAX's XLA
tier, whose absorbed scan it ports.

Tolerances, and why: fp32 everywhere, atol = rtol = 1e-5 (one fp32
algorithm, sums in another order; the absorbed tiers also multiply by the
weights in another order than the goldens' decompression); the store's
caches exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mojo_opset_tpu.experimental.operators as jx
import mojo_opset_tpu_torch as tm
from mojo_opset_tpu.backends.pallas.kernels.mla_decode import mla_decode_absorbed as jax_mla_kernel
from mojo_opset_tpu_torch.backends.cuda import kernels
from mojo_opset_tpu_torch.backends.cuda.kernels.mla_decode import mla_decode_absorbed, mla_decode_absorbed_plain
from mojo_opset_tpu_torch.utils.acc import check_tol_diff

F32 = dict(atol=1e-5, rtol=1e-5)
H, DN, DR, DV, R = 4, 16, 8, 16, 16  # heads, nope, rope, value, latent widths
BS = 16


def randn(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def i32(a):
    return np.asarray(a, np.int32)


def jax_op(core, tier, sink=None, **kw):
    op = core.get_backend_impl(tier, strict=True)(H, DN, DR, DV, R, use_attn_sink=sink is not None,
                                                 key=jax.random.PRNGKey(3), **kw)
    return op if sink is None else op.replace(attn_sink=jnp.asarray(sink))


def port_ops(core, jax_like, **kw):
    """Every tier of the port's op, holding the JAX op's weights."""
    ops = {}
    for tier in core.get_registered_backends():
        op = core.get_backend_impl(tier, strict=True)(H, DN, DR, DV, R, use_attn_sink=jax_like.attn_sink is not None,
                                                     device="cpu", **kw)
        op.kv_b_proj.data.copy_(torch.from_numpy(np.array(jax_like.kv_b_proj)))
        if jax_like.attn_sink is not None:
            op.attn_sink.data.copy_(torch.from_numpy(np.array(jax_like.attn_sink)))
        ops[tier] = op
    return ops


def paged_caches(lens, n_cols, seed):
    """Latent and rope caches with a table that gives each sequence its
    pages in a shuffled order, -1 past its last page."""
    n_blocks = sum(-(-n // BS) for n in lens) + 2
    c, pe = randn(seed, (n_blocks, 1, BS, R)), randn(seed + 1, (n_blocks, 1, BS, DR))
    perm = np.random.default_rng(seed + 2).permutation(n_blocks)
    rows, used = [], 0
    for n in lens:
        need = -(-n // BS)
        rows.append(list(perm[used:used + need]) + [-1] * (n_cols - need))
        used += need
    return c, pe, i32(rows)


SINK = randn(99, (H,))

DECODE_CASES = {  # lens, table columns, softmax scale, sink
    "plain": ([5, 17, 33], 3, None, None),
    "zero_length": ([0, 9, 1], 2, None, None),
    "padded_table": ([3, 16], 4, None, None),
    "scale_override": ([20, 7], 2, 0.3, None),
    "sink": ([12, 40, 0], 3, None, SINK),
}


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_paged_decode_matches_jax(case):
    lens, cols, scale, sink = DECODE_CASES[case]
    c, pe, table = paged_caches(lens, cols, seed=len(lens) + cols)
    q = randn(7, (len(lens), H, DN + DR))
    want = {t: np.asarray(jax_op(jx.MojoPagedDecodeMLA, t, sink)(
        jnp.asarray(q), jnp.asarray(c), jnp.asarray(pe), jnp.asarray(i32(lens)), jnp.asarray(table), scale))
        for t in ("ref", "xla")}
    check_tol_diff(want["xla"], want["ref"], **F32)
    kernels.reset_launch_counts()
    for tier, op in port_ops(tm.MojoPagedDecodeMLA, jax_op(jx.MojoPagedDecodeMLA, "ref", sink)).items():
        got = op(torch.from_numpy(q), torch.from_numpy(c), torch.from_numpy(pe), torch.from_numpy(i32(lens)),
                 torch.from_numpy(table), scale)
        assert got.shape == (len(lens), H, DV) and got.dtype == torch.float32
        check_tol_diff(got, want["ref" if tier == "ref" else "xla"], **F32)
        assert not got[np.asarray(lens) == 0].any()
    assert kernels.launch_counts()["mla_decode"] == 0  # CPU tensors: the plain version


PREFILL_CASES = {  # q lens, kv lens (None: no cu_total_seq_lens), softmax scale, sink, causal
    "plain": ([5, 17, 1], None, None, None, True),
    "chunked": ([3, 6, 1], [19, 6, 33], None, None, True),
    "zero_length": ([4, 0, 2], [4, 0, 9], None, None, True),
    "scale_override": ([6, 9], [6, 20], 0.25, None, True),
    "sink": ([7, 2], [30, 2], None, SINK, True),
    "non_causal": ([5, 8], [12, 8], None, None, False),
}


@pytest.mark.parametrize("case", sorted(PREFILL_CASES))
def test_paged_prefill_matches_jax(case):
    q_lens, kv_lens, scale, sink, causal = PREFILL_CASES[case]
    kv = q_lens if kv_lens is None else kv_lens
    c, pe, table = paged_caches(kv, max(-(-n // BS) for n in kv) + 1, seed=sum(kv))
    cu_q = i32(np.concatenate([[0], np.cumsum(q_lens)]))
    cu_kv = None if kv_lens is None else i32(np.concatenate([[0], np.cumsum(kv_lens)]))
    q = randn(8, (int(sum(q_lens)), H, DN + DR))
    jargs = (jnp.asarray(q), jnp.asarray(c), jnp.asarray(pe), jnp.asarray(cu_q), jnp.asarray(table), scale,
             None if cu_kv is None else jnp.asarray(cu_kv))
    want = {t: np.asarray(jax_op(jx.MojoPagedPrefillMLA, t, sink, is_causal=causal)(*jargs)) for t in ("ref", "xla")}
    check_tol_diff(want["xla"], want["ref"], **F32)
    ops = port_ops(tm.MojoPagedPrefillMLA, jax_op(jx.MojoPagedPrefillMLA, "ref", sink), is_causal=causal)
    kernels.reset_launch_counts()
    for tier, op in ops.items():
        got = op(torch.from_numpy(q), torch.from_numpy(c), torch.from_numpy(pe), torch.from_numpy(cu_q),
                 torch.from_numpy(table), scale, None if cu_kv is None else torch.from_numpy(cu_kv))
        assert got.shape == (q.shape[0], H, DV)
        check_tol_diff(got, want["ref" if tier == "ref" else "xla"], **F32)
    assert kernels.launch_counts()["mla_decode"] == 0


@pytest.mark.parametrize("sink", [False, True], ids=["no_sink", "sink"])
def test_decode_non_paged_matches_jax(sink):
    B, S = 3, 11
    jop = jax_op(jx.MojoDecodeMLA, "ref", SINK if sink else None)
    q, ckv, kpe = randn(1, (B, H, DN + DR)), randn(2, (B, S, R)), randn(3, (B, S, 1, DR))
    lens = i32([11, 4, 0])
    want = jop(jnp.asarray(q), jnp.asarray(ckv), jnp.asarray(kpe), jnp.asarray(lens), 0.2)
    op = port_ops(tm.MojoDecodeMLA, jop)["ref"]
    got = op(torch.from_numpy(q), torch.from_numpy(ckv), torch.from_numpy(kpe), torch.from_numpy(lens), 0.2)
    check_tol_diff(got, np.asarray(want), **F32)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "non_causal"])
def test_prefill_non_paged_matches_jax(causal):
    jop = jax_op(jx.MojoPrefillMLA, "ref", is_causal=causal)
    cu = i32([0, 4, 4, 11])
    T = int(cu[-1])
    q, ckv, kpe = randn(4, (T, H, DN + DR)), randn(5, (T, R)), randn(6, (T, 1, DR))
    want = jop(jnp.asarray(q), jnp.asarray(ckv), jnp.asarray(kpe), jnp.asarray(cu))
    op = port_ops(tm.MojoPrefillMLA, jop, is_causal=causal)["ref"]
    got = op(torch.from_numpy(q), torch.from_numpy(ckv), torch.from_numpy(kpe), torch.from_numpy(cu))
    check_tol_diff(got, np.asarray(want), **F32)


def test_paged_ops_enforce_the_contract():
    op = tm.MojoPagedDecodeMLA.get_backend_impl("ref")(H, DN, DR, DV, R, device="cpu")
    c, pe, table = paged_caches([3], 1, seed=0)
    q = torch.from_numpy(randn(0, (1, H, DN + DR)))
    with pytest.raises(ValueError, match="int32"):
        op(q, torch.from_numpy(c), torch.from_numpy(pe), torch.tensor([3]), torch.from_numpy(table))
    with pytest.raises(ValueError, match="one row per sequence"):
        op(q, torch.from_numpy(c), torch.from_numpy(pe), torch.tensor([3, 1], dtype=torch.int32),
           torch.from_numpy(table))


# ---------------------------------------------------------------- the latent store


@pytest.mark.parametrize("mode", ["prefill", "chunk", "decode"])
def test_mla_store_matches_jax(mode):
    """The port's rope cache is exactly dr wide: it equals the first dr
    lanes of the JAX session's lane-padded cache."""
    n_blocks, table = 6, i32([[4, 1, -1], [0, 5, 2]])
    c0, pe0 = randn(10, (n_blocks, 1, BS, R)), randn(11, (n_blocks, 1, BS, DR))
    if mode == "decode":
        cu, ctx = None, i32([17, 40])
    else:
        cu = i32([0, 5, 12]) if mode == "prefill" else i32([0, 3, 5])
        ctx = i32([0, 0]) if mode == "prefill" else i32([14, 30])
    T = 2 if cu is None else int(cu[-1])
    ckv, kpe = randn(12, (T, R)), randn(13, (T, DR))
    pe_wide = np.concatenate([pe0, np.zeros((n_blocks, 1, BS, 128 - DR), np.float32)], -1)
    want_c, want_pe = jx.MojoStorePagedMLAKVCache()(
        jnp.asarray(ckv), jnp.asarray(kpe), jnp.asarray(c0), jnp.asarray(pe_wide), jnp.asarray(table),
        None if cu is None else jnp.asarray(cu), jnp.asarray(ctx))
    c_t, pe_t = torch.from_numpy(c0.copy()), torch.from_numpy(pe0.copy())
    got_c, got_pe = tm.MojoStorePagedMLAKVCache()(
        torch.from_numpy(ckv), torch.from_numpy(kpe), c_t, pe_t, torch.from_numpy(table),
        None if cu is None else torch.from_numpy(cu), torch.from_numpy(ctx))
    assert got_c is c_t and got_pe is pe_t  # in place
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    np.testing.assert_array_equal(got_pe.numpy(), np.asarray(want_pe)[..., :DR])


def test_mla_store_takes_the_sessions_token_slots():
    c, pe = torch.zeros(3, 1, BS, R), torch.zeros(3, 1, BS, DR)
    ckv, kpe = torch.from_numpy(randn(14, (2, R))), torch.from_numpy(randn(15, (2, DR)))
    slots = (torch.tensor([2, 0]), torch.tensor([5, 15]))
    tm.MojoStorePagedMLAKVCache()(ckv, kpe, c, pe, token_indices=slots)
    assert torch.equal(c[2, 0, 5], ckv[0]) and torch.equal(c[0, 0, 15], ckv[1]) and torch.equal(pe[0, 0, 15], kpe[1])
    assert int((c != 0).any(-1).sum()) == 2
    with pytest.raises(ValueError, match="k_pe"):
        tm.MojoStorePagedMLAKVCache()(ckv, kpe, c, torch.zeros(3, 1, BS, 128), token_indices=slots)


# ---------------------------------------------------------------- kernel I's plain version


@pytest.mark.parametrize("lens", [[5, 17, 33], [0, 16, 1], [40]], ids=["three", "zero_and_edges", "one"])
def test_plain_version_matches_jax_kernel_in_interpret_mode(lens):
    """JAX's Pallas kernel (interpret=True) on the same absorbed queries:
    the normalized latent, 0 for a zero-length sequence."""
    c, pe, table = paged_caches(lens, 4, seed=20 + len(lens))
    q_lat, q_pe = randn(21, (len(lens), H, R), 0.3), randn(22, (len(lens), H, DR), 0.3)
    want = jax_mla_kernel(jnp.asarray(q_lat), jnp.asarray(q_pe), jnp.asarray(c), jnp.asarray(pe),
                          jnp.asarray(i32(lens)), jnp.asarray(table), pages_per_fetch=2, interpret=True)
    got = mla_decode_absorbed(torch.from_numpy(q_lat), torch.from_numpy(q_pe), torch.from_numpy(c),
                              torch.from_numpy(pe), torch.from_numpy(i32(lens)), torch.from_numpy(table))
    assert got.shape == (len(lens), H, R) and got.dtype == torch.float32
    check_tol_diff(got, np.asarray(want), **F32)


def test_plain_version_row_mode_equals_decode_rows():
    """Prefill's row mode: a row of sequence b limited to n positions is
    the decode of sequence b at length n."""
    lens = [9, 30]
    c, pe, table = [torch.from_numpy(a) for a in paged_caches(lens, 2, seed=30)]
    rows = [(1, 30), (0, 1), (1, 7), (0, 9), (1, 0)]
    q_lat, q_pe = torch.from_numpy(randn(31, (5, H, R))), torch.from_numpy(randn(32, (5, H, DR)))
    seqs, limits = torch.tensor([s for s, _ in rows], dtype=torch.int32), torch.tensor([n for _, n in rows],
                                                                                        dtype=torch.int32)
    got = mla_decode_absorbed_plain(q_lat, q_pe, c, pe, limits, table, seqs, torch.from_numpy(SINK))
    for i, (s, n) in enumerate(rows):
        one = mla_decode_absorbed_plain(q_lat[i:i + 1], q_pe[i:i + 1], c, pe, torch.tensor([n], dtype=torch.int32),
                                        table[s:s + 1], None, torch.from_numpy(SINK))
        check_tol_diff(got[i], one[0], **F32)
    assert not got[4].any()
