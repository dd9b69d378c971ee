"""Port parity for the windowed paged decode: ``MojoPagedDecodeSWA`` and
``MojoPagedDecodeSWAWithKVDequant`` (their goldens and the cuda tier, whose
kernel C / C' runs its plain version on CPU tensors) against the JAX
package's goldens and its Pallas tier (``PallasPagedDecodeSWA``, the TPU
decode kernel with its local/global windows) in interpret mode.

The same numpy caches, tables and queries go to both packages. Tolerances,
and why: fp32 against the JAX golden and the fp32 Pallas kernel, atol =
rtol = 1e-5 (fp32 softmax, sums in another order); the int8 pages against
JAX's Pallas tier, atol 5e-3 and rtol 5e-2, the bound of JAX's own test
(tests/accuracy/operators/test_attention_edges.py:236-239), since that
tier rounds the scale-folded query to bf16 and the port does not.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mojo_opset_tpu as jm
import mojo_opset_tpu.experimental as jexp
import mojo_opset_tpu_torch as tm
from mojo_opset_tpu_torch.backends.cuda.kernels import paged_decode
from mojo_opset_tpu_torch.backends.cuda.operators import CudaPagedDecodeSWA, CudaPagedDecodeSWAWithKVDequant
from mojo_opset_tpu_torch.utils.acc import check_tol_diff

F32 = dict(atol=1e-5, rtol=1e-5)
JAX_PALLAS_INT8 = dict(atol=5e-3, rtol=5e-2)
# (local, global): local only, global only, both, a local window at least as long as the context, none
WINDOWS = {"local": (5, None), "global": (None, 3), "both": (5, 3), "local-covers-context": (64, None),
           "none": (None, None)}
LENS = np.array([13, 0, 1, 30, 6], np.int32)  # a zero-length row, one key, rows across pages of 4


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


def _port_tiers(core, **kwargs):
    return [core.get_backend_impl(t, strict=True)(**kwargs) for t in ("ref", "cuda")]


@pytest.mark.usefixtures("_interpret")
@pytest.mark.parametrize("window", sorted(WINDOWS))
@pytest.mark.parametrize("layout", ["HND", "NHD"])
@pytest.mark.parametrize("gqa", ["AABB", "ABAB"])
def test_paged_decode_swa_matches_jax(window, layout, gqa):
    local, glob = WINDOWS[window]
    rng, kc, vc, table = _paged(21, LENS, 2, 16, 4, layout)
    q = rng.standard_normal((len(LENS), 8, 16)).astype(np.float32)
    kwargs = dict(gqa_layout=gqa, kv_layout=layout, local_window_size=local, global_window_size=glob)
    args_j = [jnp.asarray(a) for a in (q, kc, vc, LENS, table)]
    args_t = [torch.from_numpy(a) for a in (q, kc, vc, LENS, table)]
    wants = [jm.MojoPagedDecodeSWA.get_backend_impl(t, strict=True)(**kwargs)(*args_j) for t in ("ref", "pallas")]
    for op in _port_tiers(tm.MojoPagedDecodeSWA, **kwargs):
        got = op(*args_t)
        for want in wants:
            check_tol_diff(got, np.asarray(want), **F32)
    assert not got[1].any()  # total_seq_lens == 0 gives 0


@pytest.mark.parametrize("local, glob", [(5, None), (None, 0), (0, None)], ids=["local", "global-0", "local-0"])
def test_paged_decode_swa_keeps_the_window(local, glob):
    """The plain kernel path equals attention over exactly the kept keys
    (a global window of 0 alone keeps no key: the row is 0)."""
    rng, kc, vc, table = _paged(22, [17], 1, 8, 4, "HND")
    q = rng.standard_normal((1, 2, 8)).astype(np.float32)
    got = paged_decode.paged_decode_gqa(*(torch.from_numpy(a) for a in (q, kc, vc, np.array([17], np.int32), table)),
                                        local_window=local, global_window=glob)
    k = np.concatenate([kc[b, 0] for b in table[0]])[:17]
    v = np.concatenate([vc[b, 0] for b in table[0]])[:17]
    keep = np.zeros(17, bool)
    if local is not None:
        keep[max(16 - local, 0):] = True
    if glob is not None:
        keep[:glob] = True
    if not keep.any():
        assert not got.any()
        return
    s = q[0] @ k[keep].T / np.sqrt(8)
    p = np.exp(s - s.max(-1, keepdims=True))
    want = (p / p.sum(-1, keepdims=True)) @ v[keep]
    check_tol_diff(got[0], want, **F32)


def test_paged_decode_swa_non_causal_takes_the_counted_golden():
    rng, kc, vc, table = _paged(23, LENS, 2, 16, 4, "NHD")
    q = rng.standard_normal((len(LENS), 8, 16)).astype(np.float32)
    args_t = [torch.from_numpy(a) for a in (q, kc, vc, LENS, table)]
    op = tm.MojoPagedDecodeSWA(is_causal=False, local_window_size=2, kv_layout="NHD")
    assert isinstance(op, CudaPagedDecodeSWA)
    before = CudaPagedDecodeSWA.golden_calls
    got = op(*args_t)
    assert CudaPagedDecodeSWA.golden_calls == before + 1
    want = jm.MojoPagedDecodeSWA.get_backend_impl("ref")(is_causal=False, local_window_size=2, kv_layout="NHD")(
        *(jnp.asarray(a) for a in (q, kc, vc, LENS, table)))
    check_tol_diff(got, np.asarray(want), **F32)
    # non-causal sees every key: the plain decode
    check_tol_diff(got, tm.MojoPagedDecodeGQA.get_backend_impl("ref")(kv_layout="NHD")(*args_t), **F32)
    op(*args_t)
    assert CudaPagedDecodeSWA.golden_calls == before + 2
    causal = tm.MojoPagedDecodeSWA(local_window_size=2, kv_layout="NHD")
    causal(*args_t)
    assert CudaPagedDecodeSWA.golden_calls == before + 2


def _int8_case(seed, gqa, query_dtype=np.float32):
    rng, kc, vc, table = _paged(seed, LENS, 2, 16, 4, "HND", dtype=np.int8)
    ks, vs = (rng.uniform(0.005, 0.02, (2, 16)).astype(np.float32) for _ in range(2))
    q = rng.standard_normal((len(LENS), 8, 16)).astype(query_dtype)
    return q, kc, ks, vc, vs, table


@pytest.mark.usefixtures("_interpret")
@pytest.mark.parametrize("window", ["local", "both", "global", "none"])
@pytest.mark.parametrize("gqa", ["AABB", "ABAB"])
def test_paged_decode_swa_int8_pages_match_jax(window, gqa):
    local, glob = WINDOWS[window]
    q, kc, ks, vc, vs, table = _int8_case(31, gqa)
    kwargs = dict(gqa_layout=gqa, local_window_size=local, global_window_size=glob)
    jargs = [jnp.asarray(a) for a in (q, kc, ks, vc, vs, LENS, table)]
    targs = [torch.from_numpy(a) for a in (q, kc, ks, vc, vs, LENS, table)]

    def jax_run(tier):
        op = jexp.MojoPagedDecodeSWAWithKVDequant.get_backend_impl(tier, strict=True)(
            gqa_layout=gqa, local_window_size=local, global_window_size=glob)
        return np.asarray(op(jargs[0], None, *jargs[1:]), np.float32)

    want_ref, want_pallas = jax_run("ref"), jax_run("pallas")
    for op in _port_tiers(tm.MojoPagedDecodeSWAWithKVDequant, **kwargs):
        got = op(targs[0], None, *targs[1:])
        check_tol_diff(got, want_ref, **F32)
        check_tol_diff(got, want_pallas, **JAX_PALLAS_INT8)
        assert not got[1].any()


def test_paged_decode_swa_int8_golden_routes():
    """int8 compute stays in the golden tier (the cuda tier raises), a
    query scale raises, and a non-causal call takes the counted golden."""
    q, kc, ks, vc, vs, table = _int8_case(32, "AABB")
    targs = [torch.from_numpy(a) for a in (q, kc, ks, vc, vs, LENS, table)]
    jargs = [jnp.asarray(a) for a in (q, kc, ks, vc, vs, LENS, table)]
    want = jexp.MojoPagedDecodeSWAWithKVDequant.get_backend_impl("ref")(
        local_window_size=5, compute_dtype=jnp.int8)(jargs[0], None, *jargs[1:])
    got = tm.MojoPagedDecodeSWAWithKVDequant.get_backend_impl("ref")(
        local_window_size=5, compute_dtype=torch.int8)(targs[0], None, *targs[1:])
    check_tol_diff(got, np.asarray(want), **F32)
    with pytest.raises(NotImplementedError, match="compute_dtype"):
        tm.MojoPagedDecodeSWAWithKVDequant(local_window_size=5, compute_dtype=torch.int8)(targs[0], None, *targs[1:])
    with pytest.raises(NotImplementedError, match="query_scale"):
        tm.MojoPagedDecodeSWAWithKVDequant(local_window_size=5)(targs[0], torch.ones(1), *targs[1:])
    op = tm.MojoPagedDecodeSWAWithKVDequant(is_causal=False, local_window_size=5)
    before = CudaPagedDecodeSWAWithKVDequant.golden_calls
    got = op(targs[0], None, *targs[1:])
    assert CudaPagedDecodeSWAWithKVDequant.golden_calls == before + 1
    want = jexp.MojoPagedDecodeSWAWithKVDequant.get_backend_impl("ref")(is_causal=False, local_window_size=5)(
        jargs[0], None, *jargs[1:])
    check_tol_diff(got, np.asarray(want), **F32)


def test_paged_decode_window_arguments_are_checked():
    rng, kc, vc, table = _paged(24, [5], 1, 8, 4, "HND")
    q = rng.standard_normal((1, 2, 8)).astype(np.float32)
    args = [torch.from_numpy(a) for a in (q, kc, vc, np.array([5], np.int32), table)]
    with pytest.raises(ValueError, match="local_window"):
        paged_decode.paged_decode_gqa(*args, local_window=-1)
    with pytest.raises(ValueError, match="global_window"):
        paged_decode.paged_decode_gqa(*args, global_window=2**31)
