"""Port parity for the paged attention ops' custom masks and the windowed
prefills: ``MojoPagedDecodeGQA`` / ``MojoPagedPrefillGQA`` with ``mask``
(and their int8-page forms), ``MojoPagedPrefillSWA``,
``MojoPagedPrefillSWAWithKVDequant`` and ``MojoPagedDecodeNstepSWA``,
against the JAX package's goldens and, where JAX has one, its Pallas tier
in interpret mode (which sends masked calls to its golden).

The two mask contracts differ on purpose, as in JAX: the decode reads row
``total_seq_len`` with True = exclude, the prefill rows ``q_abs`` with
True = keep; each is tested with a 2-D and a per-batch 3-D mask, narrower
and wider than the gathered keys. In the cuda tier a masked call takes the
golden, counted in ``golden_calls`` (decode: only when not causal, as
JAX's Pallas decode; prefill: any mask, as JAX's Pallas prefill); an
unmasked call keeps kernels C and D (here their plain versions, which
count no golden route).

Tolerance: fp32 everywhere, atol = rtol = 1e-5 (fp32 softmax, sums in
another order; the int8 pages are dequantized in fp32 on both sides).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mojo_opset_tpu as jm
import mojo_opset_tpu.experimental as jexp
import mojo_opset_tpu_torch as tm
from mojo_opset_tpu_torch.backends.cuda.operators import (
    CudaPagedDecodeGQA,
    CudaPagedDecodeGQAWithKVDequant,
    CudaPagedDecodeSWA,
    CudaPagedPrefillGQA,
    CudaPagedPrefillGQAWithKVDequant,
)
from mojo_opset_tpu_torch.utils.acc import check_tol_diff

F32 = dict(atol=1e-5, rtol=1e-5)
# (local, global): local only, global only, both, a local window covering the context, none
WINDOWS = {"local": (5, None), "global": (None, 3), "both": (5, 3), "local-covers-context": (64, None),
           "none": (None, None)}
DECODE_LENS = np.array([13, 0, 1, 30, 6], np.int32)  # a zero-length row, one key, rows across pages of 4
# a sequence with no new rows but a prefix, one with one row and one key
Q_LENS, KV_LENS = [5, 0, 6, 1], [12, 3, 9, 1]


@pytest.fixture()
def _interpret(monkeypatch):
    monkeypatch.setenv("MOJO_PALLAS_INTERPRET", "1")


def _paged(seed, lens, hkv, head_dim, block_size, layout, dtype=np.float32, n_blocks=24):
    """Caches and a shuffled block table covering ``lens`` (-1 past each row's pages)."""
    rng = np.random.default_rng(seed)
    shape = (n_blocks, hkv, block_size, head_dim) if layout == "HND" else (n_blocks, block_size, hkv, head_dim)
    if dtype == np.int8:
        kc, vc = (rng.integers(-127, 128, shape).astype(np.int8) for _ in range(2))
    else:
        kc, vc = (rng.standard_normal(shape).astype(dtype) for _ in range(2))
    n_cols = max(1, max(-(-int(n) // block_size) for n in lens))
    perm, table, used = rng.permutation(n_blocks), np.full((len(lens), n_cols), -1, np.int32), 0
    for i, n in enumerate(lens):
        need = -(-int(n) // block_size)
        table[i, :need] = perm[used:used + need]
        used += need
    return rng, kc, vc, table


def _cu(lens):
    return np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)


def _mask(rng, form, batch, rows, cols, p_true):
    shape = (rows, cols) if form == "2d" else (batch, rows, cols)
    return rng.random(shape) < p_true


def _jt(*arrays):
    return [jnp.asarray(a) for a in arrays], [torch.from_numpy(np.asarray(a)) for a in arrays]


def _tiers(core, **kwargs):
    return [core.get_backend_impl(t, strict=True)(**kwargs) for t in ("ref", "cuda")]


# ---------------------------------------------------------------- decode: True = exclude


@pytest.mark.usefixtures("_interpret")
@pytest.mark.parametrize("form", ["2d", "3d"])
@pytest.mark.parametrize("cols", [20, 40], ids=["narrower", "wider"])  # the gathered keys are 32
@pytest.mark.parametrize("layout, gqa", [("HND", "AABB"), ("NHD", "ABAB")])
def test_paged_decode_mask_matches_jax(form, cols, layout, gqa):
    rng, kc, vc, table = _paged(31, DECODE_LENS, 2, 16, 4, layout)
    q = rng.standard_normal((len(DECODE_LENS), 8, 16)).astype(np.float32)
    mask = _mask(rng, form, len(DECODE_LENS), 35, cols, 0.3)
    (jq, jk, jv, jl, jb, jmask), (tq, tk, tv, tl, tb, tmask) = _jt(q, kc, vc, DECODE_LENS, table, mask)
    kwargs = dict(is_causal=False, gqa_layout=gqa, kv_layout=layout)
    wants = [jm.MojoPagedDecodeGQA.get_backend_impl(t, strict=True)(**kwargs)(jq, jk, jv, jl, jb, None, jmask)
             for t in ("ref", "pallas")]
    ref, cuda = _tiers(tm.MojoPagedDecodeGQA, **kwargs)
    before = CudaPagedDecodeGQA.golden_calls
    for op in (ref, cuda):
        got = op(tq, tk, tv, tl, tb, None, tmask)
        for want in wants:
            check_tol_diff(got, np.asarray(want), **F32)
    assert CudaPagedDecodeGQA.golden_calls == before + 1
    unmasked = ref(tq, tk, tv, tl, tb)
    assert not torch.allclose(got[0], unmasked[0])  # the mask changed row 0
    assert not got[1].any()  # total_seq_lens == 0 gives 0


def test_paged_decode_causal_ignores_the_mask_and_keeps_kernel_c():
    rng, kc, vc, table = _paged(32, DECODE_LENS, 2, 16, 4, "HND")
    q = rng.standard_normal((len(DECODE_LENS), 8, 16)).astype(np.float32)
    _, (tq, tk, tv, tl, tb, tmask) = _jt(q, kc, vc, DECODE_LENS, table, np.ones((40, 32), bool))
    op = tm.MojoPagedDecodeGQA()
    assert isinstance(op, CudaPagedDecodeGQA)
    before = CudaPagedDecodeGQA.golden_calls
    check_tol_diff(op(tq, tk, tv, tl, tb, None, tmask), op(tq, tk, tv, tl, tb), atol=0.0, rtol=0.0)
    assert CudaPagedDecodeGQA.golden_calls == before


# ---------------------------------------------------------------- prefill: True = keep


@pytest.mark.usefixtures("_interpret")
@pytest.mark.parametrize("form", ["2d", "3d"])
@pytest.mark.parametrize("rows, cols", [(16, 10), (6, 20)], ids=["narrower", "clamped-rows"])
@pytest.mark.parametrize("layout, gqa", [("HND", "AABB"), ("NHD", "ABAB")])
def test_paged_prefill_mask_matches_jax(form, rows, cols, layout, gqa):
    rng, kc, vc, table = _paged(33, KV_LENS, 2, 16, 4, layout)
    q = rng.standard_normal((sum(Q_LENS), 8, 16)).astype(np.float32)
    mask = _mask(rng, form, len(Q_LENS), rows, cols, 0.7)
    (jq, jk, jv, jcu, jb, jcukv, jmask), (tq, tk, tv, tcu, tb, tcukv, tmask) = _jt(
        q, kc, vc, _cu(Q_LENS), table, _cu(KV_LENS), mask)
    kwargs = dict(is_causal=False, gqa_layout=gqa, kv_layout=layout)
    wants = [jm.MojoPagedPrefillGQA.get_backend_impl(t, strict=True)(**kwargs)(jq, jk, jv, jcu, jb, None, jcukv,
                                                                               jmask)
             for t in ("ref", "pallas")]
    before = CudaPagedPrefillGQA.golden_calls
    for op in _tiers(tm.MojoPagedPrefillGQA, **kwargs):
        got = op(tq, tk, tv, tcu, tb, None, tcukv, tmask)
        for want in wants:
            check_tol_diff(got, np.asarray(want), **F32)
    assert CudaPagedPrefillGQA.golden_calls == before + 1


def test_paged_prefill_any_mask_takes_the_counted_golden_and_unmasked_keeps_kernel_d():
    """As JAX's Pallas prefill (:98-106), a causal call with a mask takes the
    golden too (which ignores the mask); without one it stays on D."""
    rng, kc, vc, table = _paged(34, KV_LENS, 2, 16, 4, "HND")
    q = rng.standard_normal((sum(Q_LENS), 8, 16)).astype(np.float32)
    _, (tq, tk, tv, tcu, tb, tcukv) = _jt(q, kc, vc, _cu(Q_LENS), table, _cu(KV_LENS))
    op = tm.MojoPagedPrefillGQA()
    before = CudaPagedPrefillGQA.golden_calls
    plain = op(tq, tk, tv, tcu, tb, None, tcukv)
    assert CudaPagedPrefillGQA.golden_calls == before
    masked = op(tq, tk, tv, tcu, tb, None, tcukv, torch.zeros(16, 16, dtype=torch.bool))
    assert CudaPagedPrefillGQA.golden_calls == before + 1
    check_tol_diff(masked, plain, **F32)


# ---------------------------------------------------------------- windowed prefill


@pytest.mark.parametrize("window", sorted(WINDOWS))
@pytest.mark.parametrize("layout", ["HND", "NHD"])
@pytest.mark.parametrize("gqa", ["AABB", "ABAB"])
def test_paged_prefill_swa_matches_jax(window, layout, gqa):
    local, glob = WINDOWS[window]
    rng, kc, vc, table = _paged(35, KV_LENS, 2, 16, 4, layout)
    q = rng.standard_normal((sum(Q_LENS), 8, 16)).astype(np.float32)
    (jq, jk, jv, jcu, jb, jcukv), (tq, tk, tv, tcu, tb, tcukv) = _jt(q, kc, vc, _cu(Q_LENS), table, _cu(KV_LENS))
    kwargs = dict(gqa_layout=gqa, kv_layout=layout, local_window_size=local, global_window_size=glob)
    want = jm.MojoPagedPrefillSWA.get_backend_impl("ref")(**kwargs)(jq, jk, jv, jcu, jb, None, jcukv)
    op = tm.MojoPagedPrefillSWA(**kwargs)
    got = op(tq, tk, tv, tcu, tb, None, tcukv)
    check_tol_diff(got, np.asarray(want), **F32)
    if window == "none":  # windowless: the causal paged prefill, on kernel D's plain version too
        for prefill in _tiers(tm.MojoPagedPrefillGQA, gqa_layout=gqa, kv_layout=layout):
            check_tol_diff(got, prefill(tq, tk, tv, tcu, tb, None, tcukv), **F32)


def test_paged_prefill_swa_non_causal_and_no_cuda_class():
    rng, kc, vc, table = _paged(36, KV_LENS, 2, 16, 4, "HND")
    q = rng.standard_normal((sum(Q_LENS), 8, 16)).astype(np.float32)
    (jq, jk, jv, jcu, jb, jcukv), (tq, tk, tv, tcu, tb, tcukv) = _jt(q, kc, vc, _cu(Q_LENS), table, _cu(KV_LENS))
    want = jm.MojoPagedPrefillSWA.get_backend_impl("ref")(is_causal=False, local_window_size=2)(
        jq, jk, jv, jcu, jb, None, jcukv)
    op = tm.MojoPagedPrefillSWA(is_causal=False, local_window_size=2)
    assert tm.MojoPagedPrefillSWA.get_registered_backends() == ("ref",)
    check_tol_diff(op(tq, tk, tv, tcu, tb, None, tcukv), np.asarray(want), **F32)


# ---------------------------------------------------------------- int8 pages


def _int8_case(seed, lens, gqa="AABB"):
    rng, kc, vc, table = _paged(seed, lens, 2, 16, 4, "HND", dtype=np.int8)
    ks, vs = (rng.uniform(0.01, 0.05, (2, 16)).astype(np.float32) for _ in range(2))
    return rng, kc, vc, ks, vs, table


@pytest.mark.parametrize("form", ["2d", "3d"])
@pytest.mark.parametrize("gqa", ["AABB", "ABAB"])
def test_kv_dequant_decode_mask_matches_jax(form, gqa):
    rng, kc, vc, ks, vs, table = _int8_case(37, DECODE_LENS)
    q = rng.standard_normal((len(DECODE_LENS), 8, 16)).astype(np.float32)
    mask = _mask(rng, form, len(DECODE_LENS), 35, 24, 0.3)
    jargs, targs = _jt(q, kc, ks, vc, vs, DECODE_LENS, table)
    kwargs = dict(is_causal=False, gqa_layout=gqa, query_dtype=jnp.float32, compute_dtype=jnp.float32)
    want = jexp.MojoPagedDecodeGQAWithKVDequant.get_backend_impl("ref")(**kwargs)(
        jargs[0], None, *jargs[1:], None, jnp.asarray(mask))
    kwargs.update(query_dtype=torch.float32, compute_dtype=torch.float32)
    before = CudaPagedDecodeGQAWithKVDequant.golden_calls
    for op in _tiers(tm.MojoPagedDecodeGQAWithKVDequant, **kwargs):
        check_tol_diff(op(targs[0], None, *targs[1:], None, torch.from_numpy(mask)), np.asarray(want), **F32)
    assert CudaPagedDecodeGQAWithKVDequant.golden_calls == before + 1


@pytest.mark.parametrize("form", ["2d", "3d"])
def test_kv_dequant_prefill_mask_matches_jax(form):
    rng, kc, vc, ks, vs, table = _int8_case(38, KV_LENS)
    q = rng.standard_normal((sum(Q_LENS), 8, 16)).astype(np.float32)
    mask = _mask(rng, form, len(Q_LENS), 16, 10, 0.7)
    jargs, targs = _jt(q, kc, ks, vc, vs, _cu(Q_LENS), table, _cu(KV_LENS))
    kwargs = dict(is_causal=False, query_dtype=jnp.float32, compute_dtype=jnp.float32)
    want = jexp.MojoPagedPrefillGQAWithKVDequant.get_backend_impl("ref")(**kwargs)(
        jargs[0], None, *jargs[1:-1], None, jargs[-1], jnp.asarray(mask))
    kwargs.update(query_dtype=torch.float32, compute_dtype=torch.float32)
    before = CudaPagedPrefillGQAWithKVDequant.golden_calls
    for op in _tiers(tm.MojoPagedPrefillGQAWithKVDequant, **kwargs):
        check_tol_diff(op(targs[0], None, *targs[1:-1], None, targs[-1], torch.from_numpy(mask)), np.asarray(want),
                       **F32)
    assert CudaPagedPrefillGQAWithKVDequant.golden_calls == before + 1


@pytest.mark.parametrize("window", sorted(WINDOWS))
@pytest.mark.parametrize("gqa", ["AABB", "ABAB"])
def test_kv_dequant_prefill_swa_matches_jax(window, gqa):
    local, glob = WINDOWS[window]
    rng, kc, vc, ks, vs, table = _int8_case(39, KV_LENS)
    q = rng.standard_normal((sum(Q_LENS), 8, 16)).astype(np.float32)
    jargs, targs = _jt(q, kc, ks, vc, vs, _cu(Q_LENS), table, _cu(KV_LENS))
    kwargs = dict(gqa_layout=gqa, local_window_size=local, global_window_size=glob, query_dtype=jnp.float32,
                  compute_dtype=jnp.float32)
    want = jexp.MojoPagedPrefillSWAWithKVDequant.get_backend_impl("ref")(**kwargs)(
        jargs[0], None, *jargs[1:-1], None, jargs[-1])
    kwargs.update(query_dtype=torch.float32, compute_dtype=torch.float32)
    got = tm.MojoPagedPrefillSWAWithKVDequant(**kwargs)(targs[0], None, *targs[1:-1], None, targs[-1])
    check_tol_diff(got, np.asarray(want), **F32)


# ---------------------------------------------------------------- n-step windowed decode


@pytest.mark.parametrize("window", sorted(WINDOWS))
@pytest.mark.parametrize("gqa", ["AABB", "ABAB"])
@pytest.mark.parametrize("causal", [True, False])
def test_nstep_swa_matches_jax(window, gqa, causal):
    local, glob = WINDOWS[window]
    lens = np.array([13, 0, 3, 30, 6], np.int32)
    rng, kc, vc, table = _paged(40, lens, 2, 16, 4, "HND")
    q = rng.standard_normal((len(lens), 3, 8, 16)).astype(np.float32)
    jargs, targs = _jt(q, kc, vc, lens, table)
    kwargs = dict(is_causal=causal, gqa_layout=gqa, local_window_size=local, global_window_size=glob)
    want = jexp.MojoPagedDecodeNstepSWA.get_backend_impl("ref")(**kwargs)(*jargs)
    got = tm.MojoPagedDecodeNstepSWA(**kwargs)(*targs)
    check_tol_diff(got, np.asarray(want), **F32)
    assert not got[1].any()


@pytest.mark.parametrize("window", sorted(WINDOWS))
def test_nstep_swa_one_step_equals_paged_decode_swa(window):
    """S = 1: the one row sits at ``total_seq_lens - 1``, the windowed
    decode's row (its golden and kernel C's plain version)."""
    local, glob = WINDOWS[window]
    rng, kc, vc, table = _paged(41, DECODE_LENS, 2, 16, 4, "HND")
    q = rng.standard_normal((len(DECODE_LENS), 1, 8, 16)).astype(np.float32)
    _, (tq, tk, tv, tl, tb) = _jt(q, kc, vc, DECODE_LENS, table)
    kwargs = dict(local_window_size=local, global_window_size=glob)
    got = tm.MojoPagedDecodeNstepSWA(**kwargs)(tq, tk, tv, tl, tb)[:, 0]
    before = CudaPagedDecodeSWA.golden_calls
    for op in _tiers(tm.MojoPagedDecodeSWA, **kwargs):
        check_tol_diff(got, op(tq[:, 0], tk, tv, tl, tb), **F32)
    assert CudaPagedDecodeSWA.golden_calls == before
