"""Port parity for the KV store's chunk plan and for over-encoding, against
the JAX package's ``core/operators/kv_cache.py`` and
``core/operators/over_encoding.py`` on the same numpy inputs.

Tolerances: integer outputs (chunk plans, n-gram ids, NF4 codes) and the
stores' caches (copies) are exact; the NF4 rows and the over-encoding
output in fp32 at atol = rtol = 1e-5 (one ``codebook * scale + mean`` and
an fp32 projection, XLA may fuse the multiply-add); the default NF4 path
rounds its rows to bf16 on both sides, then projects in fp32: the bf16
ladder (``utils/acc.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mojo_opset_tpu as jm
import mojo_opset_tpu.core.operators.kv_cache as jkv
import mojo_opset_tpu.core.operators.over_encoding as joe
import mojo_opset_tpu_torch as tm
import mojo_opset_tpu_torch.core.operators.kv_cache as tkv
import mojo_opset_tpu_torch.core.operators.over_encoding as toe
from mojo_opset_tpu.utils.hf import state_dict_of
from mojo_opset_tpu_torch.utils.acc import check_tol_diff, tols_for
from mojo_opset_tpu_torch.utils.weights import load_numpy_state

F32 = dict(atol=1e-5, rtol=1e-5)
EXACT = dict(atol=0.0, rtol=0.0)
# a shuffled table with -1 holes, a -1 tail, and a row with no blocks
TABLE = np.array([[5, 2, -1, 7], [1, 0, 3, -1], [-1, -1, -1, -1], [4, 6, 8, 9]], np.int32)


# ---------------------------------------------------------------- the chunk plan


@pytest.mark.parametrize("case", ["prefill", "chunked", "decode", "negative-context", "past-the-table"])
def test_chunk_metadata_matches_jax(case):
    """Exact, row for row: the same rows in the same order."""
    bs = 4
    ctx, q_lens = {
        "prefill": ([0, 0, 0, 0], [9, 5, 3, 16]),
        "chunked": ([3, 6, 0, 10], [7, 0, 2, 5]),
        "decode": ([0, 7, 2, 15], None),
        "negative-context": ([-1, 2, 0, 4], [3, 4, 1, 2]),
        "past-the-table": ([14, 15, 0, 16], None),
    }[case]
    ctx = np.array(ctx, np.int32)
    cu = None if q_lens is None else np.concatenate([[0], np.cumsum(q_lens)]).astype(np.int32)
    want = np.asarray(jkv.build_paged_kv_chunk_metadata(jnp.asarray(TABLE), None if cu is None else jnp.asarray(cu),
                                                        jnp.asarray(ctx), bs))
    got = tkv.build_paged_kv_chunk_metadata(torch.from_numpy(TABLE), None if cu is None else torch.from_numpy(cu),
                                            torch.from_numpy(ctx), bs)
    assert got.dtype == torch.int32 and got.shape == want.shape
    assert np.array_equal(got.numpy(), want)
    assert torch.equal(tm.build_paged_kv_chunk_metadata(torch.from_numpy(TABLE[:0]), None, torch.zeros(0), bs),
                       torch.zeros((0, 4), dtype=torch.int32))


@pytest.mark.parametrize("layout", ["HND", "NHD"])
def test_store_with_chunk_metadata_matches_jax_and_the_table_path(layout):
    rng = np.random.default_rng(5)
    bs, n_blocks, hkv, d = 4, 12, 2, 8
    shape = (n_blocks, hkv, bs, d) if layout == "HND" else (n_blocks, bs, hkv, d)
    kc, vc = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    ctx, q_lens = np.array([3, 6, 0, 10], np.int32), [7, 0, 2, 5]
    cu = np.concatenate([[0], np.cumsum(q_lens)]).astype(np.int32)
    k, v = (rng.standard_normal((int(cu[-1]), hkv, d)).astype(np.float32) for _ in range(2))
    plan = np.array(jkv.build_paged_kv_chunk_metadata(jnp.asarray(TABLE), jnp.asarray(cu), jnp.asarray(ctx), bs))
    want = jm.MojoStorePagedKVCache.get_backend_impl("ref")(kv_layout=layout)(
        *map(jnp.asarray, (k, v, kc, vc)), chunk_metadata=jnp.asarray(plan))
    got = tm.MojoStorePagedKVCache(kv_layout=layout)(*map(torch.from_numpy, (k, v, kc.copy(), vc.copy())),
                                                     chunk_metadata=torch.from_numpy(plan))
    for g, w in zip(got, want):
        check_tol_diff(g, np.asarray(w), **EXACT)
    by_table = tm.MojoStorePagedKVCache(kv_layout=layout)(
        *map(torch.from_numpy, (k, v, kc.copy(), vc.copy(), TABLE, cu, ctx)))
    for g, w in zip(got, by_table):
        assert torch.equal(g, w)


def test_store_chunk_metadata_drops_invalid_rows_and_refuses_mixing():
    """A plan row on block -1 is dropped, not written to the last block (the
    JAX op's ``drop_invalid``); an empty plan writes nothing; a plan is not
    mixed with tables; the C8 store refuses plans, as JAX's does."""
    kc, vc = torch.zeros(3, 1, 4, 2), torch.zeros(3, 1, 4, 2)
    k = torch.ones(6, 1, 2)
    plan = torch.tensor([[0, -1, 0, 4], [4, 1, 2, 2]], dtype=torch.int32)
    want = jm.MojoStorePagedKVCache.get_backend_impl("ref")()(
        *map(jnp.asarray, (k.numpy(), k.numpy(), kc.numpy(), vc.numpy())), chunk_metadata=jnp.asarray(plan.numpy()))
    op = tm.MojoStorePagedKVCache()
    got = op(k, k, kc, vc, chunk_metadata=plan)
    check_tol_diff(got[0], np.asarray(want[0]), **EXACT)
    assert not kc[2].any() and kc[1, 0, 2:].eq(1).all() and int(kc.sum()) == 4
    before = kc.clone()
    op(k, k, kc, vc, chunk_metadata=torch.zeros((0, 4), dtype=torch.int32))
    assert torch.equal(kc, before)
    with pytest.raises(ValueError, match="not mixed"):
        op(k, k, kc, vc, torch.zeros(1, 1, dtype=torch.int32), chunk_metadata=plan)
    with pytest.raises(ValueError, match="int32"):
        op(k, k, kc, vc, chunk_metadata=plan.long())
    with pytest.raises(NotImplementedError, match="per-token plan"):
        tm.MojoStorePagedKVCacheC8()(k, k, kc.to(torch.int8), vc.to(torch.int8), torch.ones(1, 2), torch.ones(1, 2),
                                     chunk_metadata=plan)
    blocks = torch.tensor([2, -1, 0, -5], dtype=torch.int32)
    assert torch.equal(tkv.drop_invalid(blocks, 3), torch.from_numpy(np.array(jkv.drop_invalid(
        jnp.asarray(blocks.numpy()), 3))))


# ---------------------------------------------------------------- n-gram ids

# Qwen3's vocabulary and the perf descriptor's tables: the products pass 2^31, so int64 is needed
OE = dict(ori_vocab_size=151936, oe_vocab_sizes=[100003, 100019], oe_grams=[2, 3])


def _ids(rng, *shape, high=151936):
    return rng.integers(0, high, shape).astype(np.int32)


def test_n_gram_ids_match_jax_exactly():
    rng = np.random.default_rng(7)
    ids, hist = _ids(rng, 3, 11), _ids(rng, 3, 2)
    want = np.asarray(jm.MojoOverEncodingNGram.get_backend_impl("ref")(**OE)(jnp.asarray(ids), jnp.asarray(hist)))
    got = tm.MojoOverEncodingNGram(**OE)(torch.from_numpy(ids), torch.from_numpy(hist))
    assert got.dtype == torch.int64 and got.shape == (3, 11, 2)
    assert np.array_equal(got.numpy(), want)
    # the largest id in every slot: the wrap of each step's product
    big = np.full((1, 4), 151935, np.int32)
    want = joe.n_gram_ids(jnp.asarray(big), jnp.asarray(big[:, :2]), [100003, 100019], [0, 100003], [2, 3], 151936)
    assert np.array_equal(toe.n_gram_ids(torch.from_numpy(big), torch.from_numpy(big[:, :2]), [100003, 100019],
                                         [0, 100003], [2, 3], 151936).numpy(), np.asarray(want))


def test_n_gram_ids_varlen_matches_jax_exactly():
    rng = np.random.default_rng(8)
    lens = np.array([4, 0, 7, 1], np.int32)
    ids, hist = _ids(rng, int(lens.sum())), _ids(rng, 4, 2)
    want = jm.MojoOverEncodingNGram.get_backend_impl("ref")(**OE)(jnp.asarray(ids), jnp.asarray(hist),
                                                                  jnp.asarray(lens))
    got = tm.MojoOverEncodingNGram(**OE)(torch.from_numpy(ids), torch.from_numpy(hist), torch.from_numpy(lens))
    assert np.array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------- NF4


def _nf4(rng, rows, dim, group):
    q = rng.integers(-128, 128, (rows, dim // 2)).astype(np.int8)
    scale = rng.uniform(0.5, 2.0, (rows, dim // group)).astype(np.float32)
    mean = rng.standard_normal((rows, dim // group)).astype(np.float32) * 0.1
    return q, scale, mean


def test_nf4_helpers_match_jax():
    rng = np.random.default_rng(9)
    q, scale, mean = _nf4(rng, 6, 32, 8)
    assert np.array_equal(toe.unpack_nf4_int8_to_uint4(torch.from_numpy(q)).numpy(),
                          np.asarray(joe.unpack_nf4_int8_to_uint4(jnp.asarray(q))))
    assert np.array_equal(toe.get_nf4_codebook().numpy(), np.asarray(joe.get_nf4_codebook()))
    want = joe.dequantize_nf4_rows(*map(jnp.asarray, (q, scale, mean)), group_size=8, output_dtype=jnp.float32)
    got = toe.dequantize_nf4_rows(*map(torch.from_numpy, (q, scale, mean)), group_size=8, output_dtype=torch.float32)
    check_tol_diff(got, np.asarray(want), **F32)


def test_nf4_embedding_vocab_start_and_out_of_range_ids():
    """Ids below ``vocab_start_id`` or past its rows give zero rows."""
    rng = np.random.default_rng(10)
    q, scale, mean = _nf4(rng, 6, 32, 8)
    ids = np.array([[4, 5, 10, 11], [7, 100, -3, 8]], np.int32)
    want = jm.MojoNF4DequantEmbedding.get_backend_impl("ref")(
        *map(jnp.asarray, (q, scale, mean)), group_size=8, vocab_start_id=5, output_dtype=jnp.float32)(jnp.asarray(ids))
    op = tm.MojoNF4DequantEmbedding(*map(torch.from_numpy, (q, scale, mean)), group_size=8, vocab_start_id=5,
                                    output_dtype=torch.float32, cpu_only=True)
    got = op(torch.from_numpy(ids))
    check_tol_diff(got, np.asarray(want), **F32)
    assert got.shape == (2, 4, 32)
    for b, t in ((0, 0), (0, 3), (1, 1), (1, 2)):
        assert not got[b, t].any()
    assert got[0, 1].any() and op.weight.device.type == "cpu"  # cpu_only moves nothing


# ---------------------------------------------------------------- MojoOverEncoding

SMALL = dict(ori_vocab_size=64, ori_embed_dim=16, oe_embed_dim=8, oe_vocab_sizes=[37, 41], oe_grams=[2, 3])


def _pair(rng, nf4, dtype_j, dtype_t):
    kw_j, kw_t = dict(SMALL), dict(SMALL)
    if nf4:
        arrays = _nf4(rng, sum(SMALL["oe_vocab_sizes"]), 8, 4)
        kw_j.update(zip(("_mega_embedding_weight", "_mega_embedding_scale", "_mega_embedding_mean"),
                        map(jnp.asarray, arrays)), _mega_embedding_group_size=4)
        kw_t.update(zip(("_mega_embedding_weight", "_mega_embedding_scale", "_mega_embedding_mean"),
                        map(torch.from_numpy, arrays)), _mega_embedding_group_size=4)
    if dtype_j is not None:
        kw_j["dtype"], kw_t["dtype"] = dtype_j, dtype_t
    jop = jm.MojoOverEncoding.get_backend_impl("ref")(**kw_j, key=jax.random.PRNGKey(3))
    top = tm.MojoOverEncoding(**kw_t, device="cpu", generator=torch.Generator().manual_seed(3))
    load_numpy_state(top, state_dict_of(jop))
    return jop, top


@pytest.mark.parametrize("nf4, dtype", [(False, "float32"), (True, "float32"), (True, None)],
                         ids=["dense", "nf4", "nf4-default-bf16-rows"])
@pytest.mark.parametrize("varlen", [False, True])
def test_over_encoding_matches_jax(nf4, dtype, varlen):
    rng = np.random.default_rng(11)
    jop, top = _pair(rng, nf4, None if dtype is None else getattr(jnp, dtype),
                     None if dtype is None else getattr(torch, dtype))
    if varlen:
        lens = np.array([5, 1, 6], np.int32)
        args = (_ids(rng, int(lens.sum()), high=64), _ids(rng, 3, 2, high=64), lens)
    else:
        args = (_ids(rng, 2, 9, high=64), _ids(rng, 2, 2, high=64))
    want = jop(*map(jnp.asarray, args))
    got = top(*map(torch.from_numpy, args))
    assert got.shape == want.shape and got.dtype == torch.float32
    check_tol_diff(got, np.asarray(want, np.float32), **(F32 if dtype else tols_for(torch.bfloat16)))
