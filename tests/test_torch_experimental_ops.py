"""Port parity for the small experimental ops, against the JAX package's
ops on the same numpy inputs and weights: the Hadamard helper and
``MojoRotateActivation``, ``MojoQuantBatchGemmReduceSum``,
``MojoFusedAttnOutputGate``, ``MojoGroupLayerNorm``, ``MojoRMSNormInplace``,
``MojoGroupRMSNormInplace``, ``MojoMRoPEInplace``, ``MojoStoreLowrank`` and
``MojoPagedPrefillSageGQA``.

Tolerances, and why: fp32 ops at atol = rtol = 1e-5; the Hadamard matrix,
the low-rank store (copies) and the reduce-sum GEMM exactly (its int8
products and K = 64 sums are exact in fp32, the two scale multiplies are
rounded in the same order on both sides, and the batch sum is rounded to
bf16 after every add on both sides); Sage as argued at its test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mojo_opset_tpu.core.operators.misc as jmisc
import mojo_opset_tpu.experimental as jexp
import mojo_opset_tpu_torch.experimental as texp
from mojo_opset_tpu.utils.hf import load_state_dict, state_dict_of
from mojo_opset_tpu_torch.core.operators.misc import hadamard
from mojo_opset_tpu_torch.utils.acc import check_tol_diff
from mojo_opset_tpu_torch.utils.weights import load_numpy_state, random_numpy_state

F32 = dict(atol=1e-5, rtol=1e-5)
EXACT = dict(atol=0.0, rtol=0.0)


def _f32(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------- Hadamard rotation


@pytest.mark.parametrize("n", [1, 2, 8, 64])
def test_hadamard_matches_jax_and_is_built_once(n):
    assert np.array_equal(hadamard(n).numpy(), np.asarray(jmisc.hadamard(n)))
    assert hadamard(n) is hadamard(n)
    with pytest.raises(ValueError, match="power of 2"):
        hadamard(12)


@pytest.mark.parametrize("dim", [7, 16, 48], ids=["padded-7", "16", "padded-48"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rotate_activation_matches_jax(dim, dtype):
    """Zero-padded to the next power of two, scaled by the unpadded dim:
    fp32 at 1e-5; bf16 inputs are rotated in fp32 and rounded once, so
    the outputs agree to one bf16 rounding (rtol 2^-7)."""
    x = _f32(np.random.default_rng(dim), 3, 5, dim)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jexp.MojoRotateActivation.get_backend_impl("ref")()(jnp.asarray(x, jdt))
    got = texp.MojoRotateActivation()(torch.from_numpy(x).to(tdt))
    assert got.dtype == tdt and got.shape == x.shape
    check_tol_diff(got, np.asarray(want, np.float32), **(F32 if dtype == "float32" else dict(atol=1e-6, rtol=2**-7)))
    if dim == 16 and dtype == "float32":  # a power of two: orthogonal, norms kept
        check_tol_diff(got.norm(dim=-1), torch.from_numpy(x).norm(dim=-1), atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------- the reduce-sum GEMM


@pytest.mark.parametrize("trans", [False, True])
def test_quant_batch_gemm_reduce_sum_matches_jax_exactly(trans):
    rng = np.random.default_rng(3)
    B, M, K, N = 8, 4, 64, 6
    w = rng.integers(-128, 128, (B, N, K) if trans else (B, K, N)).astype(np.int8)
    x = rng.integers(-128, 128, (B, M, K)).astype(np.int8)
    s1 = rng.uniform(0.001, 0.01, (B, M)).astype(np.float32)
    s2 = rng.uniform(0.001, 0.01, (N,)).astype(np.float32)
    want = jexp.MojoQuantBatchGemmReduceSum.get_backend_impl("ref")(jnp.asarray(w), trans)(
        *map(jnp.asarray, (x, s1, s2)))
    got = texp.MojoQuantBatchGemmReduceSum(torch.from_numpy(w), trans)(*map(torch.from_numpy, (x, s1, s2)))
    assert got.dtype == torch.bfloat16 and got.shape == (M, N)
    check_tol_diff(got, np.asarray(want, np.float32), **EXACT)
    # the batch sum is sequential in bf16: an fp32 sum rounded once lands elsewhere
    wt = torch.from_numpy(w).transpose(1, 2) if trans else torch.from_numpy(w)
    prod = torch.einsum("bmk,bkn->bmn", torch.from_numpy(x).float(), wt.float())
    fp32_sum = (prod * torch.from_numpy(s2) * torch.from_numpy(s1)[:, :, None]).sum(0).to(torch.bfloat16)
    assert not torch.equal(got, fp32_sum)


@pytest.mark.parametrize("trans", [False, True])
def test_quant_batch_gemm_reduce_sum_per_batch_weight_scale(trans):
    """``x2_scale`` (B, N), one weight scale a batch (the form the perf
    descriptor passes; the JAX op broadcasts (N,) alone), against a plain
    reference exactly: the int8 products in fp32, times ``x2[b]`` and
    ``x1[b]``, summed over B in bf16 one batch at a time. The scales differ
    by batch, so one batch's scale applied to all lands elsewhere."""
    rng = np.random.default_rng(5)
    B, M, K, N = 8, 4, 64, 6
    w = torch.from_numpy(rng.integers(-128, 128, (B, N, K) if trans else (B, K, N)).astype(np.int8))
    x = torch.from_numpy(rng.integers(-128, 128, (B, M, K)).astype(np.int8))
    s1 = torch.from_numpy(rng.uniform(0.001, 0.01, (B, M)).astype(np.float32))
    s2 = torch.from_numpy(rng.uniform(0.001, 0.01, (B, N)).astype(np.float32))
    got = texp.MojoQuantBatchGemmReduceSum(w, trans)(x, s1, s2)
    assert got.dtype == torch.bfloat16 and got.shape == (M, N)

    def reference(x2):
        prod = torch.einsum("bmk,bkn->bmn", x.float(), (w.transpose(1, 2) if trans else w).float())
        scaled = prod * x2[:, None, :] * s1[:, :, None]
        acc = torch.zeros((M, N), dtype=torch.bfloat16)
        for b in range(B):
            acc = acc + scaled[b].to(torch.bfloat16)
        return acc

    check_tol_diff(got, reference(s2), **EXACT)
    assert not torch.equal(got, reference(s2[:1].expand(B, N)))  # batch 0's scale on every batch


# ---------------------------------------------------------------- gate and norms


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("form", ["3d", "2d"])
def test_fused_attn_output_gate_matches_jax(bias, form):
    rng = np.random.default_rng(4)
    jop = jexp.MojoFusedAttnOutputGate.get_backend_impl("ref")(16, 2, 3, 8, bias=bias, key=jax.random.PRNGKey(1))
    top = texp.MojoFusedAttnOutputGate(16, 2, 3, 8, bias=bias, device="cpu", generator=torch.Generator().manual_seed(1))
    load_numpy_state(top, state_dict_of(jop))
    h, full, swa = _f32(rng, 5, 16), _f32(rng, 5, 2, 8), _f32(rng, 5, 3, 8)
    if form == "2d":
        full, swa = full.reshape(5, 16), swa.reshape(5, 24)
    want = jop(*map(jnp.asarray, (h, full, swa)))
    check_tol_diff(top(*map(torch.from_numpy, (h, full, swa))), np.asarray(want), **F32)


def _jax_with(jop, arrays):
    return load_state_dict(jop, arrays)


@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_group_norms_match_jax(affine, dtype):
    """Random weights (``random_numpy_state``) in both packages; bf16 inputs
    normalize in fp32 and round once: one bf16 rounding (rtol 2^-7)."""
    rng = np.random.default_rng(5)
    xs = [_f32(rng, 3, 16) * 3 + 1, _f32(rng, 2, 4, 16)]
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    tol = F32 if dtype == "float32" else dict(atol=1e-6, rtol=2**-7)
    for jcls, tcls in ((jexp.MojoGroupLayerNorm, texp.MojoGroupLayerNorm),
                       (jexp.MojoGroupRMSNormInplace, texp.MojoGroupRMSNormInplace)):
        top = tcls(2, 16, 1e-5, affine, device="cpu")
        jop = jcls.get_backend_impl("ref")(2, 16, 1e-5, affine)
        if affine:
            arrays = random_numpy_state(top, 6)
            load_numpy_state(top, arrays)
            jop = _jax_with(jop, arrays)
        wants = jop([jnp.asarray(x, jdt) for x in xs])
        gots = top([torch.from_numpy(x).to(tdt) for x in xs])
        for g, w in zip(gots, wants):
            assert g.dtype == tdt
            check_tol_diff(g, np.asarray(w, np.float32), **tol)


def test_rmsnorm_inplace_matches_jax_and_writes_nothing():
    rng = np.random.default_rng(7)
    top = texp.MojoRMSNormInplace(16, 1e-6, inplace=True, device="cpu")
    arrays = random_numpy_state(top, 8)
    load_numpy_state(top, arrays)
    jop = _jax_with(jexp.MojoRMSNormInplace.get_backend_impl("ref")(16, 1e-6, inplace=True), arrays)
    x = _f32(rng, 4, 16)
    xt = torch.from_numpy(x.copy())
    check_tol_diff(top(xt), np.asarray(jop(jnp.asarray(x))), **F32)
    assert np.array_equal(xt.numpy(), x)  # the flag is API parity: the input is left as it was


@pytest.mark.parametrize("table", ["flat", "3-axis", "3-axis-interleaved"])
def test_mrope_inplace_matches_jax(table):
    rng = np.random.default_rng(9)
    T, n_heads, head_dim, sections = 7, 3, 40, [4, 6, 6]
    half = sum(sections)
    q, k = _f32(rng, T, n_heads * head_dim), _f32(rng, T, head_dim)
    shape = (T, half) if table == "flat" else (3, T, half)
    cos_t, sin_t = _f32(rng, *shape), _f32(rng, *shape)
    interleaved = table == "3-axis-interleaved"
    want = jexp.MojoMRoPEInplace.get_backend_impl("ref")(inplace=True)(
        *map(jnp.asarray, (q, k, cos_t, sin_t)), sections, interleaved, head_dim)
    got = texp.MojoMRoPEInplace(inplace=True)(*map(torch.from_numpy, (q, k, cos_t, sin_t)), sections, interleaved,
                                              head_dim)
    for g, w in zip(got, want):
        check_tol_diff(g, np.asarray(w), **F32)


# ---------------------------------------------------------------- the low-rank store


def test_store_lowrank_matches_jax_and_drops_invalid_blocks():
    """-1 blocks are dropped (never written to the last block), tokens past
    ``token_num`` are not written, a negative token index counts from the
    end as in JAX."""
    rng = np.random.default_rng(10)
    cache = _f32(rng, 4, 2, 8, 16)
    key_lr = _f32(rng, 6, 2, 16)
    blocks = np.array([0, -1, 1, 3, -1, 2], np.int32)
    tokens = np.array([0, 5, 3, -1, 7, 2], np.int32)
    want = jexp.MojoStoreLowrank.get_backend_impl("ref")()(*map(jnp.asarray, (cache, key_lr, blocks, tokens)), 5)
    got = texp.MojoStoreLowrank()(*map(torch.from_numpy, (cache.copy(), key_lr, blocks, tokens)), 5)
    check_tol_diff(got, np.asarray(want), **EXACT)
    assert np.array_equal(got[3, :, :7].numpy(), cache[3, :, :7])  # only row -1 (7) of the last block changed
    assert np.array_equal(got[2].numpy(), cache[2])  # token 5 (block 2) is past token_num


# ---------------------------------------------------------------- Sage


def _sage_case(seed, q_lens, kv_lens, hq=8, hkv=2, d=16, bs=4, n_blocks=24):
    rng = np.random.default_rng(seed)
    T = sum(q_lens)
    q = rng.integers(-127, 128, (T, hq, d)).astype(np.int8)
    qs = rng.uniform(0.005, 0.02, (hq, T)).astype(np.float32)
    kc, vc = (rng.integers(-127, 128, (n_blocks, hkv, bs, d)).astype(np.int8) for _ in range(2))
    ks = rng.uniform(0.005, 0.02, (n_blocks, hkv, bs)).astype(np.float32)
    vs = rng.uniform(0.005, 0.02, (hkv, d)).astype(np.float32)
    cols = max(-(-n // bs) for n in kv_lens)
    perm, table, used = rng.permutation(n_blocks), np.full((len(kv_lens), cols), -1, np.int32), 0
    for i, n in enumerate(kv_lens):
        table[i, : -(-n // bs)] = perm[used: used - (-n // bs)]
        used += -(-n // bs)
    cu = np.concatenate([[0], np.cumsum(q_lens)]).astype(np.int32)
    cukv = np.concatenate([[0], np.cumsum(kv_lens)]).astype(np.int32)
    return rng, [q, qs, kc, ks, vc, vs, cu, table], cukv


@pytest.mark.parametrize("gqa", ["AABB", "ABAB"])
@pytest.mark.parametrize("mode", ["causal", "mask-2d", "mask-3d"])
def test_sage_prefill_matches_jax(gqa, mode):
    """bf16 out of an fp32 pipeline with one rounding step inside: each
    unnormalized ``exp`` score is rounded to a level of 1/127. XLA's and
    PyTorch's ``exp`` may part by an ulp, which can move a score across a
    half level: one level moves a row's output by at most 2 max|v * v_scale|
    / 127, since the row's levels sum to at least 127 (its largest score is
    exp(0)). Atol is that bound, rtol 2^-7 one bf16 rounding of the output."""
    q_lens, kv_lens = [5, 0, 6, 1], [12, 3, 9, 1]
    rng, args, cukv = _sage_case(11, q_lens, kv_lens)
    mask = None
    if mode != "causal":
        shape = (16, 10) if mode == "mask-2d" else (4, 16, 10)
        mask = rng.random(shape) < 0.7
    kwargs = dict(is_causal=mode == "causal", gqa_layout=gqa)
    jargs = [jnp.asarray(a) for a in args] + [None, jnp.asarray(cukv), None if mask is None else jnp.asarray(mask)]
    targs = [torch.from_numpy(a) for a in args] + [None, torch.from_numpy(cukv),
                                                   None if mask is None else torch.from_numpy(mask)]
    want = jexp.MojoPagedPrefillSageGQA.get_backend_impl("ref")(**kwargs)(*jargs)
    got = texp.MojoPagedPrefillSageGQA(**kwargs)(*targs)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    vmax = float(np.abs(args[4].astype(np.float32)).max() * args[5].max())
    check_tol_diff(got, np.asarray(want, np.float32), atol=2 * vmax / 127, rtol=2**-7)
    check_tol_diff(got, np.asarray(want, np.float32), ptol=0.99, atol=1e-6, rtol=2**-7)  # almost all one rounding


def test_ops_with_weights_default_to_the_card(monkeypatch):
    """The ops this slice added that hold weights build on the card unless
    a device is named: without one (and no card) they raise; with
    ``device="cpu"`` every tensor they hold is on the CPU."""
    import mojo_opset_tpu_torch as tm
    from mojo_opset_tpu_torch.modeling.qwen3 import MojoQwen3MoeBlock

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ops = ((texp.MojoFusedAttnOutputGate, 16, 2, 2, 8), (texp.MojoGroupLayerNorm, 2, 8, 1e-6),
           (texp.MojoGroupRMSNormInplace, 2, 8, 1e-6), (texp.MojoRMSNormInplace, 8),
           (texp.MojoDecodeNSA, 2, 8), (texp.MojoPagedPrefillNSA, 2, 8),
           (texp.MojoIndexer, 32, 2, 16, 8, 4, 8), (tm.MojoOverEncoding, 32, 16, 8, [11, 13], [2, 3]),
           (MojoQwen3MoeBlock, 64, 32, 2, 16, 4, 2))
    for op, *args in ops:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            op(*args)
        built = op(*args, device="cpu")
        held = [*built.parameters(), *built.buffers()]
        assert held and all(t.device.type == "cpu" for t in held), op
