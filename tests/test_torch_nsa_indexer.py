"""Port parity for NSA and DeepSeek-V3.2's indexer, against the JAX
package's ``experimental/operators/nsa.py`` and ``indexer.py`` on the same
numpy inputs and weights.

Tolerances, and why: the NSA outputs and the index scores in fp32 at
atol = rtol = 1e-5 (fp32 softmax and sums in another order); the block
selections and the top-k indices exactly. JAX selects NSA blocks with a
host ``np.argsort`` of the negated scores, the port with a stable
descending sort on the device; on exact ties at the cut the port keeps
the lower block index, and so does numpy here (its sort of at most 16
entries is an insertion sort, which keeps the order of equal keys):
``test_nsa_block_selection_matches_jax`` builds such ties. ``jax.lax.top_k``
puts the lower index first among equal scores; a causal prefill row has
up to ``topk - 1`` ``-inf`` ties, which the port's stable sort orders the
same way. The indexer's int8 key cache may part from JAX's by one level
where an fp32 rounding difference meets a half step (atol 1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mojo_opset_tpu.experimental as jexp
import mojo_opset_tpu_torch.experimental as texp
from mojo_opset_tpu.experimental.operators.nsa import _nsa_select_blocks
from mojo_opset_tpu.utils.hf import state_dict_of
from mojo_opset_tpu_torch.backends.cuda.operators import CudaApplyRoPE
from mojo_opset_tpu_torch.experimental.operators.indexer import topk_indices
from mojo_opset_tpu_torch.experimental.operators.nsa import nsa_select_blocks
from mojo_opset_tpu_torch.utils.acc import check_tol_diff
from mojo_opset_tpu_torch.utils.weights import load_numpy_state

F32 = dict(atol=1e-5, rtol=1e-5)
NSA = dict(num_heads=2, head_dim=8, compress_ratio=2, num_selected_blocks=2, block_size=4, window_size=4)


def _f32(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _nsa_pair(cls_name, **kw):
    kw = {**NSA, **kw}
    jop = getattr(jexp, cls_name).get_backend_impl("ref")(**kw, key=jax.random.PRNGKey(3))
    top = getattr(texp, cls_name)(**kw, device="cpu", generator=torch.Generator().manual_seed(3))
    load_numpy_state(top, state_dict_of(jop))
    return jop, top


def _pages(rng, lens, H, D, bs=4, n_blocks=24):
    kc, vc = _f32(rng, n_blocks, H, bs, D), _f32(rng, n_blocks, H, bs, D)
    cols = max(1, max(-(-n // bs) for n in lens))
    perm, table, used = rng.permutation(n_blocks), np.full((len(lens), cols), -1, np.int32), 0
    for i, n in enumerate(lens):
        table[i, : -(-n // bs)] = perm[used: used - (-n // bs)]
        used += -(-n // bs)
    return kc, vc, table


# ---------------------------------------------------------------- NSA


@pytest.mark.parametrize("sl, num_sel", [(23, 2), (23, 3), (9, 5), (1, 2)], ids=["cut-2", "cut-3", "all", "short"])
def test_nsa_block_selection_matches_jax(sl, num_sel):
    """Exact masks; blocks 1 and 3 (and 0 and 4) carry identical compressed
    keys, so equal scores straddle the cut."""
    rng = np.random.default_rng(sl)
    H, D, cr, block = 3, 8, 2, 4
    q = _f32(rng, H, D)
    C = sl // cr if sl >= cr else sl
    comp = _f32(rng, C, H, D)
    per = block // cr
    for a, b in ((1, 3), (0, 4)):
        if (b + 1) * per <= C:
            comp[b * per:(b + 1) * per] = comp[a * per:(a + 1) * per]
    want = np.asarray(_nsa_select_blocks(jnp.asarray(q), jnp.asarray(comp), sl, 0.35, cr, block, num_sel))
    got = nsa_select_blocks(torch.from_numpy(q), torch.from_numpy(comp), sl, 0.35, cr, block, num_sel)
    assert np.array_equal(got.numpy(), want)


def test_nsa_decode_matches_jax_and_falls_back_for_short_context():
    """Row 2 (one key) is shorter than a compression block: the compressed
    branch attends the raw key (JAX :101-107); row 1 is empty (0)."""
    rng = np.random.default_rng(1)
    jop, top = _nsa_pair("MojoDecodeNSA")
    q, k, v = _f32(rng, 3, 2, 8), _f32(rng, 3, 13, 2, 8), _f32(rng, 3, 13, 2, 8)
    lens = np.array([13, 0, 1], np.int32)
    want = jop(*map(jnp.asarray, (q, k, v, lens)))
    got = top(*map(torch.from_numpy, (q, k, v, lens)))
    check_tol_diff(got, np.asarray(want), **F32)
    assert not got[1].any()
    # one key: every branch is that key's value, mixed by the summed gate
    gate = torch.sigmoid(torch.einsum("hd,hdc->hc", torch.from_numpy(q[2]), top.gate_proj)).sum(-1, keepdim=True)
    check_tol_diff(got[2], gate * torch.from_numpy(v[2, 0]), **F32)


def test_nsa_paged_decode_matches_jax():
    rng = np.random.default_rng(2)
    jop, top = _nsa_pair("MojoPagedDecodeNSA")
    lens = np.array([19, 0, 1, 8], np.int32)
    kc, vc, table = _pages(rng, lens, 2, 8)
    q = _f32(rng, 4, 2, 8)
    want = jop(*map(jnp.asarray, (q, kc, vc, lens, table)))
    check_tol_diff(top(*map(torch.from_numpy, (q, kc, vc, lens, table))), np.asarray(want), **F32)


@pytest.mark.parametrize("causal", [True, False])
def test_nsa_prefill_matches_jax_and_its_last_token_the_decode(causal):
    rng = np.random.default_rng(3)
    jop, top = _nsa_pair("MojoPrefillNSA", is_causal=causal)
    cu = np.array([0, 3, 3, 12], np.int32)
    q, k, v = _f32(rng, 12, 2, 8), _f32(rng, 12, 2, 8), _f32(rng, 12, 2, 8)
    want = jop(*map(jnp.asarray, (q, k, v, cu)))
    got = top(*map(torch.from_numpy, (q, k, v, cu)))
    check_tol_diff(got, np.asarray(want), **F32)
    _, dec = _nsa_pair("MojoDecodeNSA")
    last = dec(torch.from_numpy(q[11:12]), torch.from_numpy(k[None, 3:]), torch.from_numpy(v[None, 3:]),
               torch.tensor([9], dtype=torch.int32))
    check_tol_diff(got[11], last[0], **F32)


def test_nsa_paged_prefill_matches_jax_chunked():
    rng = np.random.default_rng(4)
    jop, top = _nsa_pair("MojoPagedPrefillNSA")
    q_lens, kv_lens = [5, 0, 3], [21, 2, 3]
    kc, vc, table = _pages(rng, kv_lens, 2, 8)
    cu = np.concatenate([[0], np.cumsum(q_lens)]).astype(np.int32)
    cukv = np.concatenate([[0], np.cumsum(kv_lens)]).astype(np.int32)
    q = _f32(rng, 8, 2, 8)
    want = jop(*map(jnp.asarray, (q, kc, vc, cu, table)), None, jnp.asarray(cukv))
    got = top(*map(torch.from_numpy, (q, kc, vc, cu, table)), None, torch.from_numpy(cukv))
    check_tol_diff(got, np.asarray(want), **F32)


# ---------------------------------------------------------------- the indexer


@pytest.mark.parametrize("key_scale", ["none", "per-key", "per-batch"])
def test_lightning_indexer_matches_jax(key_scale):
    rng = np.random.default_rng(5)
    q, qs, k = _f32(rng, 2, 3, 4, 8), np.abs(_f32(rng, 2, 3, 4)), _f32(rng, 2, 5, 8)
    ks = {"none": None, "per-key": np.abs(_f32(rng, 5)), "per-batch": np.abs(_f32(rng, 2, 5))}[key_scale]
    want = jexp.MojoLightningIndexer.get_backend_impl("ref")()(*map(jnp.asarray, (q, qs, k)),
                                                               None if ks is None else jnp.asarray(ks))
    got = texp.MojoLightningIndexer()(*map(torch.from_numpy, (q, qs, k)), None if ks is None else torch.from_numpy(ks))
    check_tol_diff(got, np.asarray(want), **F32)


def test_topk_order_matches_jax_lax_top_k_on_ties():
    """Rows of a causal prefill (``-inf`` past the diagonal) and rows with
    repeated finite scores: the same indices in the same order."""
    rng = np.random.default_rng(6)
    scores = np.round(rng.standard_normal((2, 9, 9)), 1).astype(np.float32)  # repeated values
    scores = scores + np.triu(np.full((9, 9), -np.inf, np.float32), 1)
    for k in (1, 4, 9):
        _, want = jax.lax.top_k(jnp.asarray(scores), k)
        assert np.array_equal(topk_indices(torch.from_numpy(scores), k).numpy(), np.asarray(want))


def _indexer_pair(**kw):
    jop = jexp.MojoIndexer.get_backend_impl("ref")(**kw, key=jax.random.PRNGKey(7))
    top = texp.MojoIndexer(**kw, device="cpu", generator=torch.Generator().manual_seed(7))
    load_numpy_state(top, state_dict_of(jop))
    return jop, top


def test_indexer_matches_jax_prefill_then_decode():
    """A causal prefill of 8 tokens (rows with up to ``topk - 1`` ``-inf``
    ties), then two single-token steps; RoPE takes the cuda tier's counted
    golden route (a 8-wide table on 16-wide 4-D token-first heads)."""
    kw = dict(dim=32, n_heads=4, head_dim=16, qk_rope_head_dim=8, topk=6, q_lora_rank=8, max_batch_size=2,
              max_seq_len=16)
    jop, top = _indexer_pair(**kw)
    assert isinstance(top.rope, CudaApplyRoPE)
    rng = np.random.default_rng(8)
    jkc, jks = jop.init_cache(2, 16)
    tkc, tks = top.init_cache(2, 16)
    angles = rng.uniform(0, 6, (16, 4)).astype(np.float32)
    freqs = np.exp(1j * angles).astype(np.complex64)
    for start, S in ((0, 8), (8, 1), (9, 1)):
        x, qr = _f32(rng, 2, S, 32), _f32(rng, 2, S, 8)
        mask = np.triu(np.full((S, start + S), -np.inf, np.float32), start + 1) if S > 1 else None
        jidx, jscore, jkc, jks = jop(jnp.asarray(x), jnp.asarray(qr), start, jnp.asarray(freqs[start:start + S]),
                                     None if mask is None else jnp.asarray(mask), jkc, jks)
        before = CudaApplyRoPE.golden_calls
        tidx, tscore, tkc, tks = top(torch.from_numpy(x), torch.from_numpy(qr), start,
                                     torch.from_numpy(freqs[start:start + S]),
                                     None if mask is None else torch.from_numpy(mask), tkc, tks)
        assert CudaApplyRoPE.golden_calls == before + 1
        check_tol_diff(tscore, np.asarray(jscore), **F32)
        assert tidx.shape == jidx.shape == (2, S, min(6, start + S))
        assert np.array_equal(tidx.numpy(), np.asarray(jidx))
        check_tol_diff(tkc, np.asarray(jkc), atol=1.0, rtol=0.0)
        check_tol_diff(tks, np.asarray(jks), **F32)
