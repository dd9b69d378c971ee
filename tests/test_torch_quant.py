"""Port parity for int8 serving: w8a8 weights and the C8 int8 KV cache.

The same numpy inputs (``np.random.default_rng``) go through the JAX op
(its ``ref`` tier, and for the two kernel ops that reach a Pallas kernel
its ``pallas`` tier in interpret mode) and through both tiers of the port
on the CPU, where the ``cuda`` tier runs its kernels' plain versions.

Tolerances, and why:
  * RMSNormQuant: scales to rtol 1e-6 (one fp32 algorithm, sums in another
    order); int8 values off by at most 1 on at most 0.1% of the elements,
    since a sum in another order can move a value across a rounding tie.
  * QuantGemm: fp32 output to rtol 1e-6 (exact int32 sums, one fp32
    epilogue in the same order).
  * C8 store: int8 caches exactly equal.
  * KV-dequant attention: fp32, atol = rtol = 1e-5.
  * The model: prefill logits to atol = rtol = 2e-3, since a tie at a quant
    point moves one int8 value by one step; greedy tokens equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mojo_opset_tpu as jm
import mojo_opset_tpu.experimental.operators as jx
import mojo_opset_tpu_torch as tm
from mojo_opset_tpu.modeling.qwen3 import Qwen3Config as JaxQwen3Config
from mojo_opset_tpu.modeling.qwen3 import Qwen3ForCausalLM as JaxQwen3
from mojo_opset_tpu.modeling.qwen3 import quantize_qwen3 as jax_quantize_qwen3
from mojo_opset_tpu.runtime import GreedySampler as JaxGreedy
from mojo_opset_tpu.runtime import MojoGenerator as JaxGenerator
from mojo_opset_tpu.runtime import PagedAttentionGenerationModel as JaxPaged
from mojo_opset_tpu.utils.hf import state_dict_of
from mojo_opset_tpu_torch.backends.cuda import kernels
from mojo_opset_tpu_torch.modeling.qwen3 import Qwen3Config, Qwen3ForCausalLM, quantize_qwen3
from mojo_opset_tpu_torch.runtime import GreedySampler, MojoGenerator, PagedAttentionGenerationModel
from mojo_opset_tpu_torch.utils.acc import check_tol_diff
from mojo_opset_tpu_torch.utils.weights import load_numpy_state

F32 = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture()
def _interpret(monkeypatch):
    monkeypatch.setenv("MOJO_PALLAS_INTERPRET", "1")


def jax_op(core, tier, *args, **kwargs):
    return core.get_backend_impl(tier, strict=True)(*args, **kwargs)


def port_ops(core, *args, **kwargs):
    return [core.get_backend_impl(t, strict=True)(*args, **kwargs) for t in core.get_registered_backends()]


def assert_int8_close(got, want, frac=1e-3):
    """Off by at most one step, on at most ``frac`` of the elements."""
    diff = np.abs(np.asarray(got, np.int32) - np.asarray(want, np.int32))
    assert diff.max(initial=0) <= 1 and (diff > 0).sum() <= frac * diff.size, (diff.max(), (diff > 0).sum())


# ---------------------------------------------------------------- quant ops


RMSQ_CASES = {
    "8x64_x2": ((8, 64), 2.0, False, False, False),
    "5x2560": ((5, 2560), 1.0, False, False, False),
    "3x4x128": ((3, 4, 128), 1.0, False, False, False),
    "zero_row": ((4, 64), 1.0, True, False, False),
    "smooth": ((6, 128), 1.0, False, True, False),
    "bf16": ((7, 256), 1.0, False, False, True),
}


@pytest.mark.usefixtures("_interpret")
@pytest.mark.parametrize("jax_tier", ["ref", "pallas"])
@pytest.mark.parametrize("case", sorted(RMSQ_CASES))
def test_rmsnorm_quant(jax_tier, case):
    shape, scale, zero_row, smooth, bf16 = RMSQ_CASES[case]
    rng = np.random.default_rng(20)
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    if zero_row:
        x[1] = 0.0
    w = (rng.random(shape[-1]) + 0.5).astype(np.float32)
    s = (rng.random(shape[-1]) + 0.5).astype(np.float32) if smooth else None
    x_j = jnp.asarray(x, jnp.bfloat16) if bf16 else jnp.asarray(x)
    x_t = torch.from_numpy(x).to(torch.bfloat16) if bf16 else torch.from_numpy(x)
    op_j = jax_op(jm.MojoRMSNormQuant, jax_tier, shape[-1], eps=1e-6).replace(weight=jnp.asarray(w))
    q_j, s_j = op_j(x_j, None if s is None else jnp.asarray(s))
    for op in port_ops(tm.MojoRMSNormQuant, shape[-1], eps=1e-6, device="cpu"):
        op.weight.copy_(torch.from_numpy(w))
        q_t, s_t = op(x_t, None if s is None else torch.from_numpy(s))
        assert q_t.dtype == torch.int8 and q_t.shape == shape and s_t.shape == shape[:-1] + (1,)
        check_tol_diff(s_t, np.asarray(s_j), atol=0.0, rtol=1e-6)
        assert_int8_close(q_t.numpy(), np.asarray(q_j))


def test_rmsnorm_quant_zero_row_has_floor_scale():
    op = tm.MojoRMSNormQuant(16, eps=1e-6, device="cpu")
    q, s = op(torch.zeros(2, 16))
    assert torch.equal(q, torch.zeros(2, 16, dtype=torch.int8))
    assert torch.allclose(s, torch.full((2, 1), 1e-12 / 127.0))


def test_dynamic_static_quant_and_dequant():
    rng = np.random.default_rng(21)
    x = rng.standard_normal((5, 48)).astype(np.float32) * 3
    x[2] = 0.0  # scale 1
    inv = (rng.random(48) + 0.5).astype(np.float32)
    for input_size in (None, 48):
        op_j = jax_op(jm.MojoDynamicQuant, "ref", input_size)
        if input_size:
            op_j = op_j.replace(inv_smooth_scale=jnp.asarray(inv))
        q_j, s_j = op_j(jnp.asarray(x))
        for op in port_ops(tm.MojoDynamicQuant, input_size, device="cpu"):
            if input_size:
                op.inv_smooth_scale.copy_(torch.from_numpy(inv))
            q_t, s_t = op(torch.from_numpy(x))
            np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
            check_tol_diff(s_t, np.asarray(s_j), atol=0.0, rtol=1e-6)
            assert float(s_t[2]) == 1.0

    scale = (rng.random(48) * 0.05 + 0.01).astype(np.float32)
    q_j, _ = jax_op(jm.MojoStaticQuant, "ref", 48).replace(scale=jnp.asarray(scale))(jnp.asarray(x))
    for op in port_ops(tm.MojoStaticQuant, 48, device="cpu"):
        op.scale.copy_(torch.from_numpy(scale))
        q_t, s_t = op(torch.from_numpy(x))
        np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
        with pytest.raises(ValueError, match="trailing dims"):
            op(torch.zeros(3, 47))

    qs = rng.integers(-128, 128, (5, 48)).astype(np.int8)
    row_scale = rng.random((5, 1)).astype(np.float32)
    for dtype_j, dtype_t in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        want = jax_op(jm.MojoDequant, "ref", dtype_j)(jnp.asarray(qs), jnp.asarray(row_scale))
        for op in port_ops(tm.MojoDequant, dtype_t):
            got = op(torch.from_numpy(qs), torch.from_numpy(row_scale))
            assert got.dtype == dtype_t
            check_tol_diff(got, np.asarray(want.astype(jnp.float32)), atol=0.0, rtol=0.0)


def _quant_gemm_case(seed, M, K, N, trans_weight):
    rng = np.random.default_rng(seed)
    w = rng.integers(-127, 128, (N, K) if trans_weight else (K, N)).astype(np.int8)
    ws = np.asarray(jnp.asarray(rng.uniform(0.5, 2, N).astype(np.float32), jnp.bfloat16))  # JAX test's bf16
    x = rng.integers(-128, 128, (M, K)).astype(np.int8)
    xs = rng.uniform(0.01, 0.1, M).astype(np.float32)
    return w, ws, x, xs


def _check_quant_gemm(jax_tier, M, K, N, trans_weight):
    w, ws, x, xs = _quant_gemm_case(22, M, K, N, trans_weight)
    op_j = jax_op(jm.MojoQuantGemm, jax_tier, K, N, output_dtype=jnp.float32, trans_weight=trans_weight)
    want = op_j.replace(weight=jnp.asarray(w), weight_scale=jnp.asarray(ws))(jnp.asarray(x), jnp.asarray(xs))
    for op in port_ops(tm.MojoQuantGemm, K, N, output_dtype=torch.float32, trans_weight=trans_weight, device="cpu"):
        assert op.weight.dtype == torch.int8 and op.weight_scale.dtype == torch.float32
        op.weight.copy_(torch.from_numpy(w))
        op.weight_scale.copy_(torch.from_numpy(ws.astype(np.float32)))
        got = op(torch.from_numpy(x), torch.from_numpy(xs))
        check_tol_diff(got, np.asarray(want), atol=0.0, rtol=1e-6)


@pytest.mark.parametrize("trans_weight", [False, True])
@pytest.mark.parametrize("M", [1, 5, 64])
@pytest.mark.parametrize("KN", [(96, 128), (256, 384)])
def test_quant_gemm(trans_weight, M, KN):
    _check_quant_gemm("ref", M, *KN, trans_weight)


@pytest.mark.usefixtures("_interpret")
@pytest.mark.parametrize("MKN,trans_weight", [((64, 256, 128), True), ((64, 128, 256), False)])
def test_quant_gemm_against_pallas_kernel(MKN, trans_weight):
    # M >= 64, M % 8 == 0, K % 128 == 0, N % 128 == 0: the JAX tier reaches int8_matmul.py
    _check_quant_gemm("pallas", *MKN, trans_weight)


def test_quant_gemm_output_dtype_and_unported_int4():
    w, ws, x, xs = _quant_gemm_case(23, 3, 64, 32, True)
    for op in port_ops(tm.MojoQuantGemm, 64, 32, output_dtype=torch.bfloat16, trans_weight=True, device="cpu"):
        op.weight.copy_(torch.from_numpy(w))
        assert op(torch.from_numpy(x), torch.from_numpy(xs)).dtype == torch.bfloat16
    # int4 is ported (tests/test_torch_w4a8.py): packed (N // 2, K) weights, the same output dtype
    for op in port_ops(tm.MojoQuantGemm, 64, 128, output_dtype=torch.bfloat16, trans_weight=True,
                       weight_dtype="int4", device="cpu"):
        assert op.weight.shape == (64, 64) and op.weight.dtype == torch.int8
        assert op(torch.from_numpy(x), torch.from_numpy(xs)).dtype == torch.bfloat16


# ---------------------------------------------------------------- C8 KV cache


def _int8_paged(seed, lens, hkv, head_dim, block_size, n_blocks=24):
    """int8 HND caches, (Hkv, D) scales and a shuffled table covering ``lens``."""
    rng = np.random.default_rng(seed)
    shape = (n_blocks, hkv, block_size, head_dim)
    kc = rng.integers(-127, 128, shape).astype(np.int8)
    vc = rng.integers(-127, 128, shape).astype(np.int8)
    ks = rng.uniform(0.005, 0.02, (hkv, head_dim)).astype(np.float32)
    vs = rng.uniform(0.005, 0.02, (hkv, head_dim)).astype(np.float32)
    n_cols = max(1, max(-(-n // block_size) for n in lens))
    perm = rng.permutation(n_blocks)
    table = np.full((len(lens), n_cols), -1, np.int32)
    used = 0
    for i, n in enumerate(lens):
        need = -(-n // block_size)
        table[i, :need] = perm[used:used + need]
        used += need
    return rng, kc, vc, ks, vs, table


@pytest.mark.parametrize("mode", ["prefill", "decode"])
def test_store_paged_kv_cache_c8(mode):
    ctx = np.array([0, 5, 3], np.int32)
    q_lens = np.array([6, 3, 0], np.int32) if mode == "prefill" else np.ones(3, np.int32)
    rng, kc, vc, ks, vs, table = _int8_paged(24, ctx + q_lens, 2, 16, 4)
    T = int(q_lens.sum())
    k = (rng.standard_normal((T, 2, 16)) * 0.5).astype(np.float32)
    v = (rng.standard_normal((T, 2, 16)) * 0.5).astype(np.float32)
    cu = np.concatenate([[0], np.cumsum(q_lens)]).astype(np.int32) if mode == "prefill" else None
    cu_j, cu_t = (None, None) if cu is None else (jnp.asarray(cu), torch.from_numpy(cu))
    want = jax_op(jx.MojoStorePagedKVCacheC8, "ref")(
        *map(jnp.asarray, (k, v, kc, vc, ks, vs, table)), cu_j, jnp.asarray(ctx))
    for op in port_ops(tm.MojoStorePagedKVCacheC8):
        kc_t, vc_t = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
        out = op(torch.from_numpy(k), torch.from_numpy(v), kc_t, vc_t, torch.from_numpy(ks), torch.from_numpy(vs),
                 torch.from_numpy(table), cu_t, torch.from_numpy(ctx))
        assert out[0] is kc_t and out[0].dtype == torch.int8  # written in place
        np.testing.assert_array_equal(out[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(out[1].numpy(), np.asarray(want[1]))


def test_dequant_from_paged_kv_cache():
    lens = np.array([7, 0, 13], np.int32)
    rng, kc, vc, ks, vs, table = _int8_paged(25, lens, 2, 16, 4)
    template = rng.standard_normal((int(lens.sum()) + 2, 2, 16)).astype(np.float32)
    args = dict(key_cache=kc, key_cache_scale=ks, value_cache=vc, value_cache_scale=vs, context_lengths=lens,
                block_tables=table)
    want = jax_op(jx.MojoDequantFromPagedKVCache, "ref")(
        key=jnp.asarray(template), value=jnp.asarray(template), **{n: jnp.asarray(a) for n, a in args.items()})
    for op in port_ops(tm.MojoDequantFromPagedKVCache):
        got = op(key=torch.from_numpy(template), value=torch.from_numpy(template),
                 **{n: torch.from_numpy(a) for n, a in args.items()})
        check_tol_diff(got, [np.asarray(w) for w in want], **F32)


HEADS = {"mha": (4, 4), "group2": (4, 2)}
COMPUTE = {"fp": torch.float32, "int8": torch.int8}


def _dequant_ops(core, gqa, compute):
    """The port's tiers that take ``compute``: int8 compute is golden only."""
    kw = dict(gqa_layout=gqa, query_dtype=torch.float32, compute_dtype=COMPUTE[compute])
    if compute == "int8":
        cuda_op = core.get_backend_impl("cuda", strict=True)(**kw)
        return [core.get_backend_impl("ref", strict=True)(**kw)], cuda_op
    return port_ops(core, **kw), None


@pytest.mark.parametrize("compute", sorted(COMPUTE))
@pytest.mark.parametrize("heads", sorted(HEADS))
@pytest.mark.parametrize("gqa", ["AABB", "ABAB"])
def test_paged_decode_kv_dequant(compute, heads, gqa):
    hq, hkv = HEADS[heads]
    lens = np.array([7, 0, 1, 13, 4], np.int32)  # a zero-length row; 13 crosses pages of 4
    rng, kc, vc, ks, vs, table = _int8_paged(26, lens, hkv, 16, 4)
    q = rng.standard_normal((len(lens), hq, 16)).astype(np.float32)
    args = (q, kc, ks, vc, vs, lens, table)
    want = jax_op(jx.MojoPagedDecodeGQAWithKVDequant, "ref", gqa_layout=gqa, query_dtype=jnp.float32,
                  compute_dtype=jnp.int8 if compute == "int8" else jnp.float32)
    q_j, kc_j, ks_j, vc_j, vs_j, lens_j, table_j = map(jnp.asarray, args)
    want = want(q_j, None, kc_j, ks_j, vc_j, vs_j, lens_j, table_j)
    q_t, kc_t, ks_t, vc_t, vs_t, lens_t, table_t = (torch.from_numpy(a) for a in args)
    ops, cuda_op = _dequant_ops(tm.MojoPagedDecodeGQAWithKVDequant, gqa, compute)
    for op in ops:
        check_tol_diff(op(q_t, None, kc_t, ks_t, vc_t, vs_t, lens_t, table_t), np.asarray(want), **F32)
    if cuda_op is not None:
        with pytest.raises(NotImplementedError, match="golden tier only"):
            cuda_op(q_t, None, kc_t, ks_t, vc_t, vs_t, lens_t, table_t)


@pytest.mark.parametrize("compute", sorted(COMPUTE))
@pytest.mark.parametrize("heads", sorted(HEADS))
@pytest.mark.parametrize("gqa", ["AABB", "ABAB"])
def test_paged_prefill_kv_dequant(compute, heads, gqa):
    hq, hkv = HEADS[heads]
    q_lens = np.array([5, 0, 9, 1, 3], np.int32)
    kv_lens = np.array([5, 0, 14, 6, 3], np.int32)  # chunked rows (kv > q), a zero-length row
    rng, kc, vc, ks, vs, table = _int8_paged(27, kv_lens, hkv, 16, 4)
    cu_q = np.concatenate([[0], np.cumsum(q_lens)]).astype(np.int32)
    cu_kv = np.concatenate([[0], np.cumsum(kv_lens)]).astype(np.int32)
    q = rng.standard_normal((int(cu_q[-1]), hq, 16)).astype(np.float32)
    args = (q, kc, ks, vc, vs, cu_q, table, cu_kv)
    q_j, kc_j, ks_j, vc_j, vs_j, cu_j, table_j, cukv_j = map(jnp.asarray, args)
    want = jax_op(jx.MojoPagedPrefillGQAWithKVDequant, "ref", gqa_layout=gqa, query_dtype=jnp.float32,
                  compute_dtype=jnp.int8 if compute == "int8" else jnp.float32)(
        q_j, None, kc_j, ks_j, vc_j, vs_j, cu_j, table_j, None, cukv_j)
    q_t, kc_t, ks_t, vc_t, vs_t, cu_t, table_t, cukv_t = (torch.from_numpy(a) for a in args)
    ops, cuda_op = _dequant_ops(tm.MojoPagedPrefillGQAWithKVDequant, gqa, compute)
    for op in ops:
        got = op(q_t, None, kc_t, ks_t, vc_t, vs_t, cu_t, table_t, None, cukv_t, max_q_len=9)
        check_tol_diff(got, np.asarray(want), **F32)
    if cuda_op is not None:
        with pytest.raises(NotImplementedError, match="golden tier only"):
            cuda_op(q_t, None, kc_t, ks_t, vc_t, vs_t, cu_t, table_t, None, cukv_t, max_q_len=9)


def test_kv_dequant_cuda_ops_on_cpu_launch_nothing():
    lens = np.array([6, 9], np.int32)
    rng, kc, vc, ks, vs, table = _int8_paged(28, lens, 2, 64, 4)
    q = torch.from_numpy(rng.standard_normal((2, 8, 64)).astype(np.float32))
    args = [torch.from_numpy(a) for a in (kc, ks, vc, vs, lens, table)]
    kernels.reset_launch_counts()
    cuda_op = tm.MojoPagedDecodeGQAWithKVDequant.get_backend_impl("cuda")(query_dtype=torch.float32,
                                                                           compute_dtype=torch.float32)
    ref_op = tm.MojoPagedDecodeGQAWithKVDequant.get_backend_impl("ref")(query_dtype=torch.float32,
                                                                         compute_dtype=torch.float32)
    check_tol_diff(cuda_op(q, None, *args), ref_op(q, None, *args), atol=0.0, rtol=0.0)
    with pytest.raises(NotImplementedError, match="query_scale"):
        cuda_op(q, torch.ones(2, 8), *args)
    # a causal decode ignores a custom mask (JAX :121) and stays on the kernel's path
    check_tol_diff(cuda_op(q, None, *args, None, torch.ones(16, 16, dtype=torch.bool)), ref_op(q, None, *args),
                   atol=0.0, rtol=0.0)
    assert set(kernels.launch_counts().values()) == {0}


# ---------------------------------------------------------------- the model


TINY = dict(
    hidden_size=128, intermediate_size=256, num_attention_heads=4, num_key_value_heads=2,
    num_hidden_layers=2, head_dim=32, vocab_size=256, max_position_embeddings=128,
)
LENS = np.array([5, 17, 1], np.int32)
BLOCK = 16
STEPS = 8


class Tok:
    eos_token_id = 0


@pytest.fixture(scope="module", params=[False, True], ids=["w8a8", "w8a8_c8"])
def quant_pair(request):
    """(JAX fp32 base, JAX w8a8 model, port fp32 base, port w8a8 model with
    the JAX int8 weights, quant_kv)."""
    quant_kv = request.param
    base_j = JaxQwen3(JaxQwen3Config(**TINY, dtype=jnp.float32, quant_kv=quant_kv), key=jax.random.PRNGKey(7))
    qm_j = jax_quantize_qwen3(base_j)
    base_t = Qwen3ForCausalLM(Qwen3Config(**TINY, dtype=torch.float32, quant_kv=quant_kv), device="cpu")
    load_numpy_state(base_t, state_dict_of(base_j))
    qm_t = Qwen3ForCausalLM(Qwen3Config(**TINY, dtype=torch.float32, quant="w8a8", quant_kv=quant_kv), device="cpu")
    load_numpy_state(qm_t, state_dict_of(qm_j))
    return base_j, qm_j, base_t, qm_t, quant_kv


def _prompt():
    return np.random.default_rng(0).integers(1, TINY["vocab_size"], int(LENS.sum())).astype(np.int32)


def test_quantize_qwen3_matches_jax(quant_pair):
    _, qm_j, base_t, qm_t, _ = quant_pair
    mine = quantize_qwen3(base_t).state_dict()
    want = state_dict_of(qm_j)
    assert set(mine) == {k for k in want if not k.endswith("inv_freq")} == set(qm_t.state_dict())
    for name, t in mine.items():
        if t.dtype == torch.int8:
            np.testing.assert_array_equal(t.numpy(), np.asarray(want[name]), err_msg=name)
        else:
            check_tol_diff(t, np.asarray(want[name]), atol=0.0, rtol=1e-6)
    assert type(qm_t.model.layers[0].input_layernorm).__name__ == "CudaRMSNormQuant"
    assert type(qm_t.model.layers[0].mlp.down_proj).__name__ == "CudaQuantGemm"


def test_quant_prefill_logits_and_scales(quant_pair):
    _, qm_j, _, qm_t, quant_kv = quant_pair
    ids = _prompt()
    logits_j, session_j = JaxPaged(qm_j, block_size=BLOCK, jit=True)(ids, context_input_len=LENS)
    gm = PagedAttentionGenerationModel(qm_t, block_size=BLOCK)
    logits_t, session_t = gm(ids, context_input_len=LENS)
    check_tol_diff(logits_t, np.asarray(logits_j), atol=2e-3, rtol=2e-3)
    key0 = session_t.caches.key(0)
    if not quant_kv:
        assert key0.dtype == torch.float32 and not session_t.caches.key_scales
        return
    assert key0.dtype == torch.int8 and session_t.kv_layout == "HND"
    assert key0.shape == (session_t.block_tables.size, 2, BLOCK, 32)  # (N, Hkv, bs, D)
    for layer in range(TINY["num_hidden_layers"]):
        for mine, want in ((session_t.caches.key_scale(layer), session_j.caches.key_scale(layer)),
                           (session_t.caches.value_scale(layer), session_j.caches.value_scale(layer))):
            assert mine.shape == (2, 32) and mine.dtype == torch.float32
            check_tol_diff(mine, np.asarray(want), atol=0.0, rtol=1e-5)
    # a second prefill chunk on the same session: the scales stay frozen
    frozen = [s.clone() for s in session_t.caches.key_scales + session_t.caches.value_scales]
    more = np.random.default_rng(1).integers(1, TINY["vocab_size"], 6).astype(np.int32)
    gm(more, context_input_len=np.array([2, 3, 1], np.int32), session=session_t)
    for before, after in zip(frozen, session_t.caches.key_scales + session_t.caches.value_scales):
        assert torch.equal(before, after)


@pytest.mark.parametrize("fused", [False, True], ids=["stepwise", "fused"])
def test_quant_greedy_tokens_match(quant_pair, fused):
    """Both of the port's streams are held to JAX's stepwise stream (JAX's
    jitted FusedDecode window is not a stable reference under several
    workers: ROADMAP.md, queue 3); the fused case also holds the port's
    window to the port's stepwise loop."""
    _, qm_j, _, qm_t, _ = quant_pair
    ids = _prompt()
    want = JaxGenerator(JaxPaged(qm_j, block_size=BLOCK, jit=True), Tok(), JaxGreedy(),
                        max_new_tokens=STEPS).generate_from_ids(ids, LENS, ignore_eos=True, silent=True)

    def port_stream(fused_decode):
        return MojoGenerator(PagedAttentionGenerationModel(qm_t, block_size=BLOCK), Tok(), GreedySampler(),
                             max_new_tokens=STEPS).generate_from_ids(ids, LENS, ignore_eos=True,
                                                                     fused_decode=fused_decode)

    got = port_stream(fused)
    assert got.shape == (len(LENS), STEPS)
    np.testing.assert_array_equal(got, np.asarray(want))
    if fused:
        np.testing.assert_array_equal(got, port_stream(False))
