"""Port parity for the training attention: the dense attention goldens,
``MojoSWAFunction`` and kernel J's plain versions of mojo_opset_tpu_torch
against mojo_opset_tpu, on the CPU.

The same numpy inputs go through the JAX op and the port's op. The goldens
(``MojoSWA``, ``MojoSdpa``, ``MojoPrefillGQA``, ``MojoDecodeGQA``) are held
to JAX's golden tier over the JAX package's flash-SWA cases
(``tests/accuracy/functions/test_swa_vjp_pallas.py:40-49``).
``MojoSWAFunction`` on the cuda tier, whose CPU tensors run J's plain
forward and its plain backward (the recompute formulas written out, no
autograd), is held to ``jax.vjp`` of JAX's golden: value, dq, dk, dv. J's
plain version is held to JAX's ``flash_swa`` kernel in interpret mode at a
tiny case (its lse too).

Tolerances, and why: fp32 everywhere; atol = rtol = 1e-5 on values and
2e-5 on gradients (one fp32 algorithm, sums in another order; the
backward recomputes p from lse instead of differentiating the softmax).

A model of the tensor-core kernels' bf16 / fp16 arithmetic (P and dS split
into hi + lo) is held to J's plain versions under chip_smoke.py's relative
limits, and the same model with P and dS rounded once is shown to miss
them (the section at the end says why).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mojo_opset_tpu.core.operators as jo
from mojo_opset_tpu.backends.pallas.kernels import flash_vjp as jax_flash
from mojo_opset_tpu.core.functions.attention import MojoSWAFunction as JaxSWAFunction
import chip_smoke
import mojo_opset_tpu_torch as tm
from mojo_opset_tpu_torch.backends.cuda import build, kernels
from mojo_opset_tpu_torch.backends.cuda.kernels import flash_swa as fs
from mojo_opset_tpu_torch.backends.cuda.operators import CudaSdpa
from mojo_opset_tpu_torch.utils.acc import check_tol_diff

F32 = dict(atol=1e-5, rtol=1e-5)
GRAD = dict(atol=2e-5, rtol=2e-5)

# (q_lens, kv_lens or None for one cu vector, Hq, Hkv, D, causal, local, global): the JAX package's cases
CASES = {
    "single-causal-gqa": ([256], None, 4, 2, 128, True, None, None),
    "varlen-mha": ([192, 64, 300], None, 4, 4, 128, True, None, None),
    "varlen-local-window": ([200, 312], None, 8, 2, 128, True, 128, None),
    "varlen-global-window": ([200, 312], None, 4, 2, 128, True, None, 64),
    "varlen-both-windows": ([130, 382], None, 4, 2, 128, True, 96, 32),
    "non-causal": ([256, 128], None, 4, 2, 128, False, None, None),
    "suffix-q": ([64, 32], [192, 256], 4, 2, 128, True, None, None),
    "d256": ([100], None, 2, 1, 256, True, None, None),
    # beyond JAX's list: a zero-length kv sequence and rows before their sequence's first key
    "zero-length-and-masked-rows": ([5, 3, 0, 4], [2, 0, 6, 4], 4, 2, 32, True, None, None),
    "abab-window-0": ([40, 9], None, 4, 2, 32, True, 0, None),
}


def randn(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def cu_of(lens):
    return np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)


def swa_inputs(name):
    q_lens, kv_lens, hq, hkv, d, causal, lws, gws = CASES[name]
    kv_lens = kv_lens or q_lens
    seed = sum(q_lens) + 7 * hq + d
    q, do = randn(seed, (sum(q_lens), hq, d)), randn(seed + 1, (sum(q_lens), hq, d))
    k, v = randn(seed + 2, (sum(kv_lens), hkv, d)), randn(seed + 3, (sum(kv_lens), hkv, d))
    cfg = dict(is_causal=causal, local_window_size=lws, global_window_size=gws,
               gqa_layout="ABAB" if name.startswith("abab") else "AABB")
    return q, k, v, do, cu_of(q_lens), cu_of(kv_lens), cfg


def jax_swa_vjp(q, k, v, do, cu_q, cu_k, cfg, aligned):
    """Value and (dq, dk, dv) of JAX's golden MojoSWAFunction; one cu array
    for both sides where the case has one (``aligned``), as JAX's tests pass it."""
    fn = JaxSWAFunction.get_backend_impl("ref")(**cfg)
    cq = jnp.asarray(cu_q)
    ck = cq if aligned else jnp.asarray(cu_k)
    y, pull = jax.vjp(lambda q, k, v: fn(q, k, v, cq, ck), *(jnp.asarray(x) for x in (q, k, v)))
    return (y, *pull(jnp.asarray(do)))


@pytest.mark.parametrize("name", CASES)
def test_swa_golden_matches_jax(name):
    q, k, v, _, cu_q, cu_k, cfg = swa_inputs(name)
    want = jo.MojoSWA.get_backend_impl("ref")(**cfg)(*(jnp.asarray(x) for x in (q, k, v, cu_q, cu_k)))
    got = tm.MojoSWA.get_backend_impl("ref")(**cfg)(*(torch.from_numpy(x) for x in (q, k, v, cu_q, cu_k)))
    check_tol_diff(got, np.asarray(want), **F32)


@pytest.mark.parametrize("name", CASES)
def test_swa_function_on_the_cuda_tier_matches_jax_vjp(name):
    """CPU tensors on the cuda tier: J's plain forward and plain backward."""
    q, k, v, do, cu_q, cu_k, cfg = swa_inputs(name)
    aligned = CASES[name][1] is None
    want = jax_swa_vjp(q, k, v, do, cu_q, cu_k, cfg, aligned)
    fn = tm.MojoSWAFunction.get_backend_impl("cuda")(**cfg)
    assert type(fn).__name__ == "CudaSWAFunction"
    qt, kt, vt = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    ct = torch.from_numpy(cu_q)
    kernels.reset_launch_counts()
    y = fn(qt, kt, vt, ct, ct if aligned else torch.from_numpy(cu_k))
    grads = torch.autograd.grad(y, (qt, kt, vt), torch.from_numpy(do))
    assert set(kernels.launch_counts().values()) == {0}  # CPU tensors: the plain versions
    check_tol_diff(y.detach(), np.asarray(want[0]), **F32)
    for got, ref in zip(grads, want[1:]):
        check_tol_diff(got, np.asarray(ref), **GRAD)
    if name.startswith("zero-length"):  # 6 rows see no key and 6 keys no row: o and every gradient are 0 there
        rows = torch.tensor([0, 1, 2, 5, 6, 7])
        assert torch.equal(y[rows], torch.zeros_like(y[rows])) and torch.equal(grads[0][rows], torch.zeros_like(y[rows]))
        for g in grads[1:]:
            assert torch.equal(g[2:8], torch.zeros_like(g[2:8]))


def test_swa_function_runs_its_ops_fwd_and_bwd():
    """CudaSWAFunction delegates to its CudaSWA op, whose ``fwd``/``bwd``
    are the seam a plain twin on the card sets (chip_smoke's twin check)."""
    q, k, v, do, cu_q, _, cfg = swa_inputs("varlen-local-window")
    fn = tm.MojoSWAFunction.get_backend_impl("cuda")(**cfg)
    assert type(fn.swa).__name__ == "CudaSWA"
    called = []
    fn.swa.fwd = lambda *a, **kw: called.append("fwd") or fs.flash_swa_fwd_plain(*a, **kw)
    fn.swa.bwd = lambda *a, **kw: called.append("bwd") or fs.flash_swa_bwd_plain(*a, **kw)
    qt, kt, vt = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    ct = torch.from_numpy(cu_q)
    y = fn(qt, kt, vt, ct, ct)
    torch.autograd.grad(y, (qt, kt, vt), torch.from_numpy(do))
    assert called == ["fwd", "bwd"]


def test_plain_version_matches_jax_kernel_in_interpret_mode():
    """J's plain forward (o and lse) and backward against JAX's flash_swa
    Pallas kernels run in interpret mode, at a tiny varlen GQA case with a
    local window (the JAX kernel takes AABB only)."""
    q_lens, hq, hkv, d, lws = [24, 16], 4, 2, 32, 5
    q, do = randn(1, (40, hq, d)), randn(2, (40, hq, d))
    k, v = randn(3, (40, hkv, d)), randn(4, (40, hkv, d))
    cu = jnp.asarray(cu_of(q_lens))
    scale = 1.0 / np.sqrt(d)
    args = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), cu, cu)
    o_j, lse_j = jax_flash._fwd_call(*args, True, lws, None, scale, True, 256, 256, True)
    _, pull = jax.vjp(lambda q, k, v: jax_flash.flash_swa(q, k, v, cu, cu, True, lws, None, None, True, 256, 256,
                                                          True), *args[:3])
    grads_j = pull(jnp.asarray(do))[:3]

    qt, kt, vt, dot = (torch.from_numpy(x) for x in (q, k, v, do))
    ct = torch.from_numpy(cu_of(q_lens))
    cfg = dict(causal=True, local_window=lws)
    o, lse = fs.flash_swa_fwd_plain(qt, kt, vt, ct, ct, **cfg)
    check_tol_diff(o, np.asarray(o_j), **F32)
    check_tol_diff(lse, np.asarray(lse_j)[:, :40, 0].T, **F32)
    for got, ref in zip(fs.flash_swa_bwd_plain(qt, kt, vt, o, lse, dot, ct, ct, **cfg), grads_j):
        check_tol_diff(got, np.asarray(ref), **GRAD)


@pytest.mark.parametrize("layout", ["AABB", "ABAB"])
def test_packed_causal_swa_equals_masked_sdpa(layout):
    """The training path's attention: MojoSWAFunction over B sequences of S
    packed as (B * S) rows with one cu vector equals MojoSdpa under a tril
    mask on (B, H, S, D), value and gradients (AABB is Sdpa's GQA repeat;
    ABAB is held to Sdpa on kv heads tiled by hand)."""
    B, S, hq, hkv, d = 3, 11, 4, 2, 16
    q, k, v, do = randn(5, (B, S, hq, d)), randn(6, (B, S, hkv, d)), randn(7, (B, S, hkv, d)), randn(8, (B, S, hq, d))
    qt, kt, vt = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    cu = torch.arange(B + 1, dtype=torch.int32) * S
    swa = tm.MojoSWAFunction(is_causal=True, gqa_layout=layout)
    y = swa(qt.reshape(B * S, hq, d), kt.reshape(B * S, hkv, d), vt.reshape(B * S, hkv, d), cu, cu).reshape(B, S, hq, d)
    got = (y, *torch.autograd.grad(y, (qt, kt, vt), torch.from_numpy(do)))

    qr, kr, vr = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    kx, vx = (x.transpose(1, 2) if layout == "AABB" else x.transpose(1, 2).repeat(1, hq // hkv, 1, 1) for x in (kr, vr))
    sdpa = tm.MojoSdpa.get_backend_impl("ref")(enable_gqa=True)
    yr = sdpa(qr.transpose(1, 2), kx, vx, attn_mask=torch.ones(S, S, dtype=torch.bool).tril()).transpose(1, 2)
    want = (yr, *torch.autograd.grad(yr, (qr, kr, vr), torch.from_numpy(do)))
    for g, w in zip(got, want):
        check_tol_diff(g.detach(), w.detach(), **GRAD)


SDPA_CASES = {  # (q shape, kv shape, mask kind, enable_gqa)
    "maskless": ((2, 4, 9, 16), (2, 4, 13, 16), None, False),
    "bool-mask-gqa": ((2, 4, 9, 16), (2, 2, 9, 16), "bool", True),
    "additive-mask": ((1, 2, 7, 32), (1, 2, 7, 32), "add", False),
    "maskless-gqa-3d": ((4, 10, 16), (2, 10, 16), None, True),
}


@pytest.mark.parametrize("name", SDPA_CASES)
@pytest.mark.parametrize("tier", ["ref", "cuda"])
def test_sdpa_matches_jax(name, tier):
    qs, ks, mask_kind, gqa = SDPA_CASES[name]
    q, k, v = randn(11, qs), randn(12, ks), randn(13, ks)
    mask = None
    if mask_kind == "bool":
        mask = np.random.default_rng(14).random((qs[-2], ks[-2])) < 0.7
        mask[:, 0] = True  # every row attends somewhere
    elif mask_kind == "add":
        mask = randn(15, (qs[-2], ks[-2]))
    want = jo.MojoSdpa.get_backend_impl("ref")(enable_gqa=gqa)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None if mask is None else jnp.asarray(mask))
    before = CudaSdpa.golden_calls
    got = tm.MojoSdpa.get_backend_impl(tier)(enable_gqa=gqa)(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), None if mask is None else torch.from_numpy(mask))
    check_tol_diff(got, np.asarray(want), **F32)
    if tier == "cuda":  # a bool mask runs kernel O's route; only an additive mask takes the golden, counted
        assert CudaSdpa.golden_calls - before == (mask_kind == "add")


@pytest.mark.parametrize("layout", ["ABAB", "AABB"])
@pytest.mark.parametrize("tier", ["ref", "cuda"])
def test_prefill_gqa_matches_jax(layout, tier):
    B, hq, hkv, S, d = 2, 4, 2, 12, 16
    q, k, v = randn(21, (B, hq, S, d)), randn(22, (B, hkv, S, d)), randn(23, (B, hkv, S, d))
    cu = np.array([0, 12, 19], np.int32)  # the second sequence is padded: causality keeps its rows off the pads
    want = jo.MojoPrefillGQA.get_backend_impl("ref")(gqa_layout=layout)(*(jnp.asarray(x) for x in (q, k, v, cu)))
    op = tm.MojoPrefillGQA.get_backend_impl(tier)(gqa_layout=layout)
    got = op(*(torch.from_numpy(x) for x in (q, k, v, cu)))
    assert got.shape == (B, S, hq, d)
    check_tol_diff(got, np.asarray(want), **F32)


@pytest.mark.parametrize("layout", ["AABB", "ABAB"])
@pytest.mark.parametrize("lens", [None, [5, 0, 9]], ids=["full", "lens"])
def test_decode_gqa_matches_jax(layout, lens):
    B, hq, hkv, S, d = 3, 8, 2, 9, 16
    q, k, v = randn(31, (B, hq, d)), randn(32, (B, hkv, S, d)), randn(33, (B, hkv, S, d))
    sl = None if lens is None else np.asarray(lens, np.int32)
    want = jo.MojoDecodeGQA.get_backend_impl("ref")(gqa_layout=layout)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None if sl is None else jnp.asarray(sl))
    got = tm.MojoDecodeGQA(gqa_layout=layout)(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), None if sl is None else torch.from_numpy(sl))
    check_tol_diff(got, np.asarray(want), **F32)


def test_cuda_swa_op_carries_gradients():
    """CudaSWA (the operator) runs J under the same autograd Function."""
    q, k, v, do, cu_q, cu_k, cfg = swa_inputs("varlen-both-windows")
    want = jax_swa_vjp(q, k, v, do, cu_q, cu_k, cfg, True)
    qt, kt, vt = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    ct = torch.from_numpy(cu_q)
    y = tm.MojoSWA.get_backend_impl("cuda")(**cfg)(qt, kt, vt, ct, ct)
    for got, ref in zip((y, *torch.autograd.grad(y, (qt, kt, vt), torch.from_numpy(do))), want):
        check_tol_diff(got.detach(), np.asarray(ref), **GRAD)


def test_flash_swa_wrappers_refuse_what_the_kernels_do_not_take():
    """Tensors off the CPU go to the kernels, whose wrappers check first."""
    meta = lambda *shape, dtype=torch.bfloat16: torch.empty(shape, device="meta", dtype=dtype)  # noqa: E731
    cu = meta(3, dtype=torch.int32)
    q, k = meta(10, 8, 128), meta(10, 2, 128)
    with pytest.raises(ValueError, match="head_dim"):  # 96 is taken, padded to 128; 72 is not a multiple of 16
        fs.flash_swa_fwd(meta(10, 8, 72), meta(10, 2, 72), meta(10, 2, 72), cu, cu)
    with pytest.raises(ValueError, match="up to 256"):  # any group is taken (128/1 in chunks of 64)
        fs.flash_swa_fwd(meta(10, 8, 320), meta(10, 1, 320), meta(10, 1, 320), cu, cu)
    with pytest.raises(ValueError, match="multiple of Hkv"):
        fs.flash_swa_fwd(meta(10, 6, 64), meta(10, 4, 64), meta(10, 4, 64), cu, cu)
    with pytest.raises(TypeError, match="float32, float16 or bfloat16"):
        fs.flash_swa_fwd(meta(10, 8, 128, dtype=torch.float64), k, k, cu, cu)
    with pytest.raises(ValueError, match="share one dtype"):
        fs.flash_swa_fwd(q, meta(10, 2, 128, dtype=torch.float16), k, cu, cu)
    with pytest.raises(ValueError, match="contiguous"):
        fs.flash_swa_fwd(meta(8, 10, 128).transpose(0, 1), k, k, cu, cu)
    with pytest.raises(ValueError, match="windows"):
        fs.flash_swa_fwd(q, k, k, cu, cu, local_window=-2)
    with pytest.raises(ValueError, match="int32"):
        fs.flash_swa_fwd(q, k, k, meta(3, dtype=torch.int64), cu)
    with pytest.raises(ValueError, match="both of one B"):
        fs.flash_swa_fwd(q, k, k, cu, meta(4, dtype=torch.int32))
    with pytest.raises(ValueError, match="gqa_layout"):
        fs.flash_swa_fwd(q, k, k, cu, cu, gqa_layout="BBAA")
    with pytest.raises(ValueError, match="float32"):
        fs.flash_swa_dq(q, k, k, q, q, meta(10, 8), cu, cu)
    with pytest.raises(ValueError, match="q's shape"):
        fs.flash_swa_dkv(q, k, k, meta(10, 8, 64), meta(10, 8, dtype=torch.float32),
                         meta(10, 8, dtype=torch.float32), cu, cu)
    assert (fs.launches, fs.launches_dq, fs.launches_dkv) == (0, 0, 0)


def test_flash_swa_never_falls_back(monkeypatch):
    """A tensor off the CPU goes to the kernel: without a build the training
    attention raises instead of running the plain version."""
    monkeypatch.setattr(build, "load_library", lambda: (_ for _ in ()).throw(RuntimeError("no kernels built")))
    meta = lambda *shape, dtype=torch.bfloat16: torch.empty(shape, device="meta", dtype=dtype)  # noqa: E731
    cu = meta(3, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="no kernels built"):
        tm.MojoSWAFunction()(meta(10, 8, 128), meta(10, 2, 128), meta(10, 2, 128), cu, cu)
    with pytest.raises(RuntimeError, match="no kernels built"):
        tm.MojoSdpa(enable_gqa=True)(meta(1, 8, 10, 128), meta(1, 2, 10, 128), meta(1, 2, 10, 128))
    with pytest.raises(RuntimeError, match="no kernels built"):
        tm.MojoPrefillGQA()(meta(1, 8, 10, 128), meta(1, 2, 10, 128), meta(1, 2, 10, 128), meta(2, dtype=torch.int32))


# -- the tensor-core kernels' arithmetic (bf16 / fp16), modelled on the CPU ------------------------------------
#
# Kernels J and O take their bf16 / fp16 products on the tensor cores: operands in the working type, exact
# products, fp32 sums. S = Q K^T and dP = dO V^T take inputs as they are, but P and dS are fp32, so the kernels
# round each to the 2p significant bits that hi + lo of a p-bit type carry (16 for bf16, 22 for fp16) and send
# hi = T(x) and lo = T(x - hi) through two MMAs into one accumulator (csrc/flash_tiles.cuh). The model below repeats
# that arithmetic on dense heads, fed the plain versions' inputs, and is held to the plain versions under
# chip_smoke.py's relative limits (each output, whole tensor and worst row, against its fp32-sum reference): the
# split must keep them, and rounding P and dS once must not, so dropping the split shows here.
# Shape, and why: one causal sequence of 1024 tokens, 4 query heads over 2 kv heads of 128, unit normal inputs
# from a fixed seed, where a single rounding misses every whole-tensor limit by 2.1-3.3x (bf16 2.1-2.6e-3 against
# 1e-3, fp16 2.6-3.3e-4 against 1e-4) and the split stays 2.9-6.8x inside it (bf16 1.2-1.5e-4, fp16 1.5-3.4e-5).


def on_split_grid(x, dtype):
    """fp32 x rounded, half away from zero, to the 2p significant bits hi + lo of dtype carry."""
    drop = 8 if dtype == torch.bfloat16 else 2  # 23 fraction bits less 2p - 1
    u = x.contiguous().view(torch.int32)
    return ((u + (1 << (drop - 1))) & ~((1 << drop) - 1)).view(torch.float32)


def product_in(x, y, dtype, split):
    """x @ y with fp32 x entering as the kernels' A operand: hi + lo of dtype (split) or rounded once."""
    if not split:
        return x.to(dtype).float() @ y
    x = on_split_grid(x, dtype)
    hi = x.to(dtype).float()
    return hi @ y + (x - hi).to(dtype).float() @ y


def tensor_core_model(q, k, v, do, o, keep, scale, split):
    """The kernels' arithmetic on dense heads: q, do, o (H, Sq, D) and k, v (H, Sk, D), one row per query head, in
    the working type; keep (Sq, Sk), every row keeping a key. The forward's P is exp(s - max); the backward reads
    the reference's o, as chip_smoke.py feeds it. Returns fp32 o, dq and per-query-head dk, dv."""
    dtype = q.dtype
    qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
    s = (qf @ kf.transpose(-1, -2) * scale).masked_fill(~keep, float("-inf"))
    m = s.amax(-1, keepdim=True)
    p_tilde = torch.exp(s - m)
    l = p_tilde.sum(-1, keepdim=True)
    p = torch.exp(s - (m + l.log()))
    ds = p * (dof @ vf.transpose(-1, -2) - (dof * o.float()).sum(-1, keepdim=True))
    return (product_in(p_tilde, vf, dtype, split) / l, scale * product_in(ds, kf, dtype, split),
            scale * product_in(ds.transpose(-1, -2), qf, dtype, split),
            product_in(p.transpose(-1, -2), dof, dtype, split))


def _swa_model_errors(dtype, split):
    """(whole, worst row) relative errors of the modelled o, dq, dk, dv against J's plain versions."""
    S, hq, hkv, d = 1024, 4, 2, 128
    q, k, v, do = (torch.from_numpy(randn(90 + i, (S, h, d))).to(dtype) for i, h in enumerate((hq, hkv, hkv, hq)))
    cu = torch.tensor([0, S], dtype=torch.int32)
    o, lse = fs.flash_swa_fwd_plain(q, k, v, cu, cu)
    dq, delta = fs.flash_swa_dq_plain(q, k, v, o, do, lse, cu, cu)
    dk, dv = fs.flash_swa_dkv_plain(q, k, v, do, lse, delta, cu, cu)
    heads = lambda x: x.transpose(0, 1)  # noqa: E731  (T, H, D) <-> (H, T, D)
    om, dqm, dkm, dvm = tensor_core_model(heads(q), heads(fs._heads(k, hq // hkv, "AABB")),
                                          heads(fs._heads(v, hq // hkv, "AABB")), heads(do), heads(o),
                                          torch.ones(S, S, dtype=torch.bool).tril(), d ** -0.5, split)
    dkm, dvm = (fs._group_sum(heads(x), hkv, "AABB") for x in (dkm, dvm))
    got = (heads(om), heads(dqm), dkm, dvm)
    return [chip_smoke.rel_errors(g.to(dtype), w)[:2] for g, w in zip(got, (o, dq, dk, dv))]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=["bf16", "fp16"])
def test_split_p_and_ds_keep_flash_swa_within_its_limits(dtype):
    whole, row = chip_smoke.FLASH_SWA_REL_LIMITS[{torch.bfloat16: "bf16", torch.float16: "fp16"}[dtype]]
    for name, (w, r) in zip(("o", "dq", "dk", "dv"), _swa_model_errors(dtype, split=True)):
        assert w <= whole and r <= row, f"{name}: {w:.3g} / {r:.3g} over {(whole, row)}"


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=["bf16", "fp16"])
def test_p_and_ds_rounded_once_miss_flash_swa_limits(dtype):
    whole = chip_smoke.FLASH_SWA_REL_LIMITS[{torch.bfloat16: "bf16", torch.float16: "fp16"}[dtype]][0]
    errors = _swa_model_errors(dtype, split=False)
    assert all(w > whole for w, _ in errors), f"single rounding read {errors}, within {whole}"


def test_split_grid_makes_a_probability_next_to_one_exactly_one():
    """A row that keeps one key has p = exp(s - lse) = 1 up to fp32 rounding; on the split grid it is exactly 1
    (then a sum of such rows' bf16 products hits the reference's rounding ties exactly), while values the grid
    holds come back unchanged."""
    fp32_next_to_one = torch.tensor([1 - 2 ** -24, 1 + 2 ** -23], dtype=torch.float32)
    assert torch.equal(on_split_grid(fp32_next_to_one, torch.float16), torch.ones(2))
    within_bf16_grid = torch.tensor([1 - 2 ** -24, 1 + 2 ** -23, 1 - 2 ** -18, 1 + 2 ** -17], dtype=torch.float32)
    assert torch.equal(on_split_grid(within_bf16_grid, torch.bfloat16), torch.ones(4))
    x = torch.from_numpy(randn(7, (1000,)))
    for dtype in (torch.bfloat16, torch.float16):
        g = on_split_grid(x, dtype)
        hi = g.to(dtype).float()
        # hi + lo carries the grid value exactly; in fp16 while lo stays normal (|x| >= 2^-3), below that lo's
        # subnormals hold it to 2^-24 absolute
        exact = (hi + (g - hi).to(dtype).float() == g) | ((dtype == torch.float16) & (g.abs() < 2 ** -3))
        assert exact.all()
        assert torch.equal(on_split_grid(g, dtype), g)
        assert ((g - x).abs() <= x.abs() * 2.0 ** -(16 if dtype == torch.bfloat16 else 22)).all()
