"""Port parity, op by op: mojo_opset_tpu_torch against mojo_opset_tpu.

The same numpy inputs (``np.random.default_rng``) go through the JAX op
(its ``ref`` tier, and for the four kernel ops its ``pallas`` tier in
interpret mode, as tests/accuracy/operators/test_pallas_tier.py runs it)
and through both tiers of the port on the CPU, where the ``cuda`` tier runs
its kernels' plain versions. fp32 tolerance: atol = rtol = 1e-5 (one fp32
algorithm, sums in another order); bf16 cases hold to the bf16 row of
BASELINE.md "Accuracy baselines".
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mojo_opset_tpu as jm
import mojo_opset_tpu_torch as tm
from mojo_opset_tpu_torch.utils.acc import check_tol_diff, tols_for

F32 = dict(atol=1e-5, rtol=1e-5)
BF16 = tols_for(torch.bfloat16)


@pytest.fixture()
def _interpret(monkeypatch):
    monkeypatch.setenv("MOJO_PALLAS_INTERPRET", "1")


def jax_op(core, tier, *args, **kwargs):
    return core.get_backend_impl(tier, strict=True)(*args, **kwargs)


def port_ops(core, *args, **kwargs):
    """The op in each of the port's tiers that it has (ref, and cuda where a kernel exists)."""
    return [core.get_backend_impl(t, strict=True)(*args, **kwargs) for t in core.get_registered_backends()]


def to_torch(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def close(port_out, jax_out, tol=F32):
    if isinstance(jax_out, (tuple, list)):
        jax_out = [np.asarray(a, dtype=np.float32) for a in jax_out]
    else:
        jax_out = np.asarray(jax_out, dtype=np.float32)
    check_tol_diff(port_out, jax_out, **tol)


def test_embedding():
    rng = np.random.default_rng(0)
    w = rng.standard_normal((50, 24)).astype(np.float32)
    ids = rng.integers(0, 50, (3, 7)).astype(np.int32)
    op_j = jax_op(jm.MojoEmbedding, "ref", 50, 24).replace(weight=jnp.asarray(w))
    want = op_j(jnp.asarray(ids))
    for op in port_ops(tm.MojoEmbedding, 50, 24, device="cpu"):
        op.weight.copy_(torch.from_numpy(w))
        close(op(torch.from_numpy(ids)), want)


@pytest.mark.parametrize("bias", [False, True])
def test_gemm(bias):
    rng = np.random.default_rng(1)
    w = rng.standard_normal((48, 32)).astype(np.float32)
    b = rng.standard_normal(48).astype(np.float32)
    x = rng.standard_normal((5, 32)).astype(np.float32)
    op_j = jax_op(jm.MojoGemm, "ref", weight=jnp.asarray(w), bias=bias)
    if bias:
        op_j = op_j.replace(bias=jnp.asarray(b))
    want = op_j(jnp.asarray(x))
    for op in port_ops(tm.MojoGemm, 32, 48, bias=bias, device="cpu"):
        op.weight.copy_(torch.from_numpy(w))
        if bias:
            op.bias.copy_(torch.from_numpy(b))
        close(op(torch.from_numpy(x)), want)


def test_silu():
    x = np.random.default_rng(2).standard_normal((4, 33)).astype(np.float32)
    want = jax_op(jm.MojoSilu, "ref")(jnp.asarray(x))
    for op in port_ops(tm.MojoSilu):
        close(op(torch.from_numpy(x)), want)


@pytest.mark.usefixtures("_interpret")
@pytest.mark.parametrize("jax_tier", ["ref", "pallas"])
@pytest.mark.parametrize("shape", [(16, 64), (3, 8, 128), (5, 2560)])
def test_rmsnorm(jax_tier, shape):
    rng = np.random.default_rng(3)
    x = rng.standard_normal(shape).astype(np.float32)
    w = (rng.random(shape[-1]) + 0.5).astype(np.float32)
    want = jax_op(jm.MojoRMSNorm, jax_tier, shape[-1], eps=1e-6).replace(weight=jnp.asarray(w))(jnp.asarray(x))
    for op in port_ops(tm.MojoRMSNorm, shape[-1], eps=1e-6, device="cpu"):
        op.weight.copy_(torch.from_numpy(w))
        close(op(torch.from_numpy(x)), want)


def test_rmsnorm_bf16_keeps_dtype():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((6, 128)).astype(np.float32)
    w = (rng.random(128) + 0.5).astype(np.float32)
    want = jax_op(jm.MojoRMSNorm, "ref", 128, eps=1e-6).replace(weight=jnp.asarray(w))(
        jnp.asarray(x, jnp.bfloat16))
    for op in port_ops(tm.MojoRMSNorm, 128, eps=1e-6, device="cpu"):
        op.weight.copy_(torch.from_numpy(w))
        out = op(torch.from_numpy(x).to(torch.bfloat16))
        assert out.dtype == torch.bfloat16
        close(out, np.asarray(want.astype(jnp.float32)), BF16)


def test_rotary_embedding_modes():
    rng = np.random.default_rng(5)
    pos = rng.integers(0, 300, (2, 5)).astype(np.int32)
    cu = np.array([0, 3, 3, 8], np.int32)
    total = np.array([5, 2, 9], np.int32)
    op_j = jax_op(jm.MojoRotaryEmbedding, "ref", 1e6, 64)
    ops = port_ops(tm.MojoRotaryEmbedding, 1e6, 64, device="cpu")
    x = np.zeros((8, 16), np.float32)
    for op in ops:
        close(op(torch.zeros(2, 5, 16), position_ids=torch.from_numpy(pos)),
              op_j(jnp.zeros((2, 5, 16)), position_ids=jnp.asarray(pos)))
        close(op(torch.from_numpy(x), cu_q_lens=torch.from_numpy(cu), total_seq_lens=torch.from_numpy(total)),
              op_j(jnp.asarray(x), cu_q_lens=jnp.asarray(cu), total_seq_lens=jnp.asarray(total)))
        close(op(torch.zeros(2, 7, 16)), op_j(jnp.zeros((2, 7, 16))))


def _rope_inputs(rng, q_shape, k_shape, table_shape):
    q = rng.standard_normal(q_shape).astype(np.float32)
    k = rng.standard_normal(k_shape).astype(np.float32)
    ang = rng.random(table_shape).astype(np.float32) * 6.0
    return q, k, np.cos(ang), np.sin(ang)


@pytest.mark.usefixtures("_interpret")
@pytest.mark.parametrize("jax_tier", ["ref", "pallas"])
@pytest.mark.parametrize("n_tokens", [5, 16])
def test_apply_rope_token_first(jax_tier, n_tokens):
    q, k, cos, sin = _rope_inputs(np.random.default_rng(6), (n_tokens, 4, 128), (n_tokens, 2, 128), (n_tokens, 128))
    want = jax_op(jm.MojoApplyRoPE, jax_tier)(*map(jnp.asarray, (q, k, cos, sin)), head_first=False)
    for op in port_ops(tm.MojoApplyRoPE):
        close(op(*to_torch(q, k, cos, sin), head_first=False), want)


def test_apply_rope_head_first():
    q, k, cos, sin = _rope_inputs(np.random.default_rng(7), (2, 4, 6, 32), (2, 2, 6, 32), (6, 32))
    want = jax_op(jm.MojoApplyRoPE, "ref")(*map(jnp.asarray, (q, k, cos, sin)), head_first=True)
    for op in port_ops(tm.MojoApplyRoPE):
        close(op(*to_torch(q, k, cos, sin), head_first=True), want)


def test_apply_rope_bf16():
    q, k, cos, sin = _rope_inputs(np.random.default_rng(8), (9, 4, 64), (9, 2, 64), (9, 64))
    args_j = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, cos, sin)]
    want = jax_op(jm.MojoApplyRoPE, "ref")(*args_j, head_first=False)
    for op in port_ops(tm.MojoApplyRoPE):
        out = op(*[t.to(torch.bfloat16) for t in to_torch(q, k, cos, sin)], head_first=False)
        assert out[0].dtype == torch.bfloat16
        close(out, [np.asarray(w.astype(jnp.float32)) for w in want], BF16)


# ---------------------------------------------------------------- paged KV


def _paged_case(seed, lens, hkv, head_dim, block_size, layout, n_blocks=40, n_cols=None):
    """Caches with random contents and a shuffled block table covering ``lens``."""
    rng = np.random.default_rng(seed)
    shape = (n_blocks, hkv, block_size, head_dim) if layout == "HND" else (n_blocks, block_size, hkv, head_dim)
    kc = rng.standard_normal(shape).astype(np.float32)
    vc = rng.standard_normal(shape).astype(np.float32)
    n_cols = n_cols or max(1, max(-(-n // block_size) for n in lens))
    perm = rng.permutation(n_blocks)
    table = np.full((len(lens), n_cols), -1, np.int32)
    used = 0
    for i, n in enumerate(lens):
        need = -(-n // block_size)
        table[i, :need] = perm[used:used + need]
        used += need
    return rng, kc, vc, table


@pytest.mark.parametrize("layout", ["HND", "NHD"])
@pytest.mark.parametrize("mode", ["prefill", "decode"])
def test_store_paged_kv_cache(layout, mode):
    ctx = np.array([0, 5, 3], np.int32)
    q_lens = np.array([6, 3, 0], np.int32) if mode == "prefill" else np.ones(3, np.int32)
    rng, kc, vc, table = _paged_case(9, ctx + q_lens, 2, 16, 4, layout, n_cols=4)
    T = int(q_lens.sum())
    k = rng.standard_normal((T, 2, 16)).astype(np.float32)
    v = rng.standard_normal((T, 2, 16)).astype(np.float32)
    cu = np.concatenate([[0], np.cumsum(q_lens)]).astype(np.int32) if mode == "prefill" else None
    want = jax_op(jm.MojoStorePagedKVCache, "ref", kv_layout=layout)(
        *map(jnp.asarray, (k, v, kc, vc, table)), None if cu is None else jnp.asarray(cu), jnp.asarray(ctx))
    for op in port_ops(tm.MojoStorePagedKVCache, kv_layout=layout):
        k_t, v_t, kc_t, vc_t, table_t, ctx_t = to_torch(k, v, kc, vc, table, ctx)
        out = op(k_t, v_t, kc_t, vc_t, table_t, None if cu is None else torch.from_numpy(cu), ctx_t)
        assert out[0] is kc_t and out[1] is vc_t  # written in place
        check_tol_diff(out, [np.asarray(w) for w in want], atol=0.0, rtol=0.0)


def test_store_paged_kv_cache_drops_tokens_without_a_block():
    ctx = np.array([0, 6], np.int32)
    q_lens = np.array([3, 4], np.int32)  # sequence 1 runs past its 2-block table row
    rng, kc, vc, table = _paged_case(10, [3, 8], 1, 8, 4, "NHD", n_cols=2)
    k = rng.standard_normal((7, 1, 8)).astype(np.float32)
    cu = np.array([0, 3, 7], np.int32)
    want = jax_op(jm.MojoStorePagedKVCache, "ref", kv_layout="NHD")(
        *map(jnp.asarray, (k, k, kc, vc, table, cu, ctx)))
    for op in port_ops(tm.MojoStorePagedKVCache, kv_layout="NHD"):
        out = op(*to_torch(k, k, kc, vc, table, cu, ctx))
        check_tol_diff(out, [np.asarray(w) for w in want], atol=0.0, rtol=0.0)


# JAX's group sizes (tests/accuracy/operators/test_attention_edges.py:136: (16, 2), (8, 8), (7, 7)) and a group
# above kernel C's former cap of 16
HEADS = {"mha": (4, 4), "group4": (8, 2), "group8": (16, 2), "mha8": (8, 8), "mha7": (7, 7), "mqa32": (32, 1)}


def _attn_args(case, q):
    return [jnp.asarray(a) for a in case], [torch.from_numpy(a) for a in case], jnp.asarray(q), torch.from_numpy(q)


# (JAX tier, softmax scale) pairs: the pallas tier runs in interpret mode,
# so it takes the default scale only
JAX_RUNS = (("ref", None), ("ref", 0.3), ("pallas", None))


@pytest.mark.usefixtures("_interpret")
@pytest.mark.parametrize("heads", sorted(HEADS))
@pytest.mark.parametrize("layout", ["HND", "NHD"])
@pytest.mark.parametrize("gqa", ["AABB", "ABAB"])
def test_paged_decode_gqa(heads, layout, gqa):
    hq, hkv = HEADS[heads]
    lens = np.array([7, 0, 1, 13, 4], np.int32)  # a zero-length row; 13 crosses pages of 4
    rng, kc, vc, table = _paged_case(11, lens, hkv, 16, 4, layout)
    q = rng.standard_normal((len(lens), hq, 16)).astype(np.float32)
    (kc_j, vc_j, lens_j, table_j), torch_args, q_j, q_t = _attn_args((kc, vc, lens, table), q)
    for jax_tier, scale in JAX_RUNS:
        want = jax_op(jm.MojoPagedDecodeGQA, jax_tier, gqa_layout=gqa, kv_layout=layout)(
            q_j, kc_j, vc_j, lens_j, table_j, scale)
        for op in port_ops(tm.MojoPagedDecodeGQA, gqa_layout=gqa, kv_layout=layout):
            close(op(q_t, *torch_args, scale), want)


@pytest.mark.usefixtures("_interpret")
@pytest.mark.parametrize("heads", sorted(HEADS))
@pytest.mark.parametrize("layout", ["HND", "NHD"])
@pytest.mark.parametrize("gqa", ["AABB", "ABAB"])
def test_paged_prefill_gqa(heads, layout, gqa):
    hq, hkv = HEADS[heads]
    # chunked rows (kv > q), a zero-length row, q < 8 rows, page crossings
    q_lens = np.array([5, 0, 9, 1, 3], np.int32)
    kv_lens = np.array([5, 0, 14, 6, 3], np.int32)
    rng, kc, vc, table = _paged_case(12, kv_lens, hkv, 16, 4, layout)
    cu_q = np.concatenate([[0], np.cumsum(q_lens)]).astype(np.int32)
    cu_kv = np.concatenate([[0], np.cumsum(kv_lens)]).astype(np.int32)
    q = rng.standard_normal((int(cu_q[-1]), hq, 16)).astype(np.float32)
    (kc_j, vc_j, cu_j, table_j, cukv_j), torch_args, q_j, q_t = _attn_args((kc, vc, cu_q, table, cu_kv), q)
    kc_t, vc_t, cu_t, table_t, cukv_t = torch_args
    for jax_tier, scale in JAX_RUNS:
        want = jax_op(jm.MojoPagedPrefillGQA, jax_tier, gqa_layout=gqa, kv_layout=layout)(
            q_j, kc_j, vc_j, cu_j, table_j, scale, cukv_j)
        for op in port_ops(tm.MojoPagedPrefillGQA, gqa_layout=gqa, kv_layout=layout):
            close(op(q_t, kc_t, vc_t, cu_t, table_t, scale, cukv_t, max_q_len=int(q_lens.max())), want)


@pytest.mark.parametrize("layout", ["HND", "NHD"])
def test_prefill_without_context_lengths(layout):
    q_lens = np.array([4, 11], np.int32)
    rng, kc, vc, table = _paged_case(13, q_lens, 2, 16, 4, layout)
    cu_q = np.concatenate([[0], np.cumsum(q_lens)]).astype(np.int32)
    q = rng.standard_normal((15, 8, 16)).astype(np.float32)
    want = jax_op(jm.MojoPagedPrefillGQA, "ref", kv_layout=layout)(*map(jnp.asarray, (q, kc, vc, cu_q, table)))
    for op in port_ops(tm.MojoPagedPrefillGQA, kv_layout=layout):
        close(op(*to_torch(q, kc, vc, cu_q, table), max_q_len=11), want)


@pytest.mark.parametrize("gqa", ["AABB", "ABAB"])
def test_single_token_prefill_equals_decode(gqa):
    lens = np.array([9, 1, 4], np.int32)
    rng, kc, vc, table = _paged_case(14, lens, 2, 16, 4, "NHD")
    q = rng.standard_normal((3, 8, 16)).astype(np.float32)
    cu_q = np.arange(4, dtype=np.int32)
    cu_kv = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    q_t, kc_t, vc_t, lens_t, table_t, cu_t, cukv_t = to_torch(q, kc, vc, lens, table, cu_q, cu_kv)
    for prefill, decode in zip(port_ops(tm.MojoPagedPrefillGQA, gqa_layout=gqa, kv_layout="NHD"),
                               port_ops(tm.MojoPagedDecodeGQA, gqa_layout=gqa, kv_layout="NHD")):
        close(prefill(q_t, kc_t, vc_t, cu_t, table_t, None, cukv_t, max_q_len=1),
              decode(q_t, kc_t, vc_t, lens_t, table_t).numpy())


def test_paged_attention_bf16_keeps_dtype():
    lens = np.array([6, 10], np.int32)
    rng, kc, vc, table = _paged_case(15, lens, 2, 64, 4, "NHD")
    q = rng.standard_normal((2, 8, 64)).astype(np.float32)
    want = jax_op(jm.MojoPagedDecodeGQA, "ref", kv_layout="NHD")(
        *[jnp.asarray(a, jnp.bfloat16) for a in (q, kc, vc)], jnp.asarray(lens), jnp.asarray(table))
    for op in port_ops(tm.MojoPagedDecodeGQA, kv_layout="NHD"):
        q_t, kc_t, vc_t = [t.to(torch.bfloat16) for t in to_torch(q, kc, vc)]
        out = op(q_t, kc_t, vc_t, *to_torch(lens, table))
        assert out.dtype == torch.bfloat16
        close(out, np.asarray(want.astype(jnp.float32)), BF16)


CONTRACT_FAULTS = {
    "int64_lengths": lambda lens, table: (lens.long(), table),
    "short_table": lambda lens, table: (lens, table[:-1]),
}


@pytest.mark.parametrize("fault", sorted(CONTRACT_FAULTS))
@pytest.mark.parametrize("mode", ["decode", "prefill"])
def test_paged_attention_input_contract(mode, fault):
    """The goldens hold the JAX contract (core/operators/attention.py:33-48
    there): int32 lengths and tables, one table row per sequence."""
    lens = np.array([6, 9], np.int32)
    rng, kc, vc, table = _paged_case(16, lens, 2, 16, 4, "NHD")
    kc_t, vc_t, table_t = to_torch(kc, vc, table)
    if mode == "decode":
        q = torch.from_numpy(rng.standard_normal((2, 8, 16)).astype(np.float32))
        seq, tab = CONTRACT_FAULTS[fault](torch.from_numpy(lens), table_t)
        op = tm.MojoPagedDecodeGQA.get_backend_impl("ref")(kv_layout="NHD")
        with pytest.raises(ValueError, match="int32|one row per sequence"):
            op(q, kc_t, vc_t, seq, tab)
    else:
        q = torch.from_numpy(rng.standard_normal((15, 8, 16)).astype(np.float32))
        cu, tab = CONTRACT_FAULTS[fault](torch.tensor([0, 6, 15], dtype=torch.int32), table_t)
        op = tm.MojoPagedPrefillGQA.get_backend_impl("ref")(kv_layout="NHD")
        with pytest.raises(ValueError, match="int32|one row per sequence"):
            op(q, kc_t, vc_t, cu, tab, None, cu)
