"""Shapes the JAX package computes and the cuda tier once refused, on the CPU.

Each shape either reaches its kernel's launch (tensors on the ``meta``
device go to the kernel wrappers, and a stubbed ``build.load_library``
raises "no kernels built" where the build would start) or takes the
golden through its op, counted in the class's ``golden_calls`` and equal
to the golden op's output on CPU tensors:

- kernels D and J at a group of 71 query heads a kv head (71/1 MQA): the
  kernels take the group in chunks of at most 64 heads;
- kernels C, C', D, D', J and O at head_dim 16, 80 and 96: run at the
  next instantiated width (64, 128), the extra columns zero; a head_dim
  that is no multiple of 16 (8, 24) takes the golden in every attention op;
- kernel I at r 256 and 1024 (one ring stage); r + dr past shared memory
  in bf16, and fp32 past the scalar kernel, take the golden MLA op;
- F and G at K 40 (``CudaQuantGemm``), G at K past ``MAX_K``, H at 16-bit
  K 36 (``CudaGroupGemm``, ``CudaExperts``): the golden.

J's and O's padding is exact: the plain versions on zero-padded q, k, v
(the scale kept at the real head_dim) give the unpadded outputs and
gradients in their first head_dim columns, at fp32 tolerance.
"""

import math

import numpy as np
import pytest
import torch

from mojo_opset_tpu_torch.backends.cuda import build
from mojo_opset_tpu_torch.backends.cuda.kernels import flash_diffusion as fd
from mojo_opset_tpu_torch.backends.cuda.kernels import flash_swa as fs
from mojo_opset_tpu_torch.backends.cuda.kernels import int4_matmul, paged_decode, paged_prefill
from mojo_opset_tpu_torch.backends.cuda.operators import (
    CudaGroupGemm, CudaPagedDecodeGQA, CudaPagedDecodeMLA, CudaPagedPrefillGQA, CudaQuantGemm, CudaSdpa, CudaSWA,
)
from mojo_opset_tpu_torch.backends.cuda.operators.moe import CudaExperts
from mojo_opset_tpu_torch.core.operators import (
    MojoGroupGemm, MojoPagedDecodeGQA, MojoPagedPrefillGQA, MojoQuantGemm, MojoSdpa, MojoSWA,
)
from mojo_opset_tpu_torch.core.operators.gemm import pack_int4_rows
from mojo_opset_tpu_torch.core.operators.moe import MojoExperts
from mojo_opset_tpu_torch.experimental.operators import MojoPagedDecodeMLA
from mojo_opset_tpu_torch.utils.acc import check_tol_diff

F32 = dict(atol=1e-5, rtol=1e-5)
NO_BUILD = "no kernels built"


@pytest.fixture
def no_build(monkeypatch):
    monkeypatch.setattr(build, "load_library", lambda: (_ for _ in ()).throw(RuntimeError(NO_BUILD)))


def meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, device="meta", dtype=dtype)


def i32(*shape):
    return meta(*shape, dtype=torch.int32)


def cpu(seed, *shape, dtype=torch.float32, scale=1.0):
    return torch.from_numpy((np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)).to(dtype)


# ---------------------------------------------------------------- the kernels' launches


@pytest.mark.parametrize("d", [16, 80, 96])
@pytest.mark.parametrize("int8", [False, True], ids=["C", "C_int8"])
def test_paged_decode_reaches_the_launch(no_build, d, int8):
    scales = (meta(2, d, dtype=torch.float32), meta(2, d, dtype=torch.float32)) if int8 else (None, None)
    cache = meta(9, 2, 16, d, dtype=torch.int8 if int8 else torch.bfloat16)
    with pytest.raises(RuntimeError, match=NO_BUILD):
        paged_decode.paged_decode_gqa(meta(3, 16, d), cache, cache, i32(3), i32(3, 4), None, "AABB", "HND", *scales)


@pytest.mark.parametrize("hq, hkv, d", [(71, 1, 128), (16, 2, 16), (16, 2, 80), (16, 2, 96), (142, 2, 96)])
@pytest.mark.parametrize("int8", [False, True], ids=["D", "D_int8"])
def test_paged_prefill_reaches_the_launch(no_build, hq, hkv, d, int8):
    scales = (meta(hkv, d, dtype=torch.float32), meta(hkv, d, dtype=torch.float32)) if int8 else (None, None)
    cache = meta(9, hkv, 16, d, dtype=torch.int8 if int8 else torch.bfloat16)
    with pytest.raises(RuntimeError, match=NO_BUILD):
        paged_prefill.paged_prefill_gqa(meta(40, hq, d), cache, cache, i32(3), i32(2, 4), None, None, "AABB", "HND",
                                        max_q_len=30, key_scale=scales[0], value_scale=scales[1])


@pytest.mark.parametrize("hq, hkv, d", [(71, 1, 128), (16, 4, 16), (16, 4, 80), (16, 4, 96)])
@pytest.mark.parametrize("entry", ["fwd", "dq", "dkv"])
def test_flash_swa_reaches_the_launch(no_build, hq, hkv, d, entry):
    q, k, cu = meta(10, hq, d), meta(10, hkv, d), i32(3)
    lse = meta(10, hq, dtype=torch.float32)
    call = {"fwd": lambda: fs.flash_swa_fwd(q, k, k, cu, cu),
            "dq": lambda: fs.flash_swa_dq(q, k, k, q, q, lse, cu, cu),
            "dkv": lambda: fs.flash_swa_dkv(q, k, k, q, lse, lse, cu, cu)}[entry]
    with pytest.raises(RuntimeError, match=NO_BUILD):
        call()


@pytest.mark.parametrize("d", [16, 80, 96])
@pytest.mark.parametrize("entry", ["fwd", "dq", "dkv"])
def test_flash_diffusion_reaches_the_launch(no_build, d, entry):
    q, k, mask = meta(1, 4, 9, d), meta(1, 2, 9, d), torch.empty(9, 9, device="meta", dtype=torch.bool)
    lse = meta(1, 4, 9, dtype=torch.float32)
    call = {"fwd": lambda: fd.flash_diffusion_fwd(q, k, k, mask),
            "dq": lambda: fd.flash_diffusion_dq(q, k, k, q, q, lse, mask),
            "dkv": lambda: fd.flash_diffusion_dkv(q, k, k, q, lse, lse, mask)}[entry]
    with pytest.raises(RuntimeError, match=NO_BUILD):
        call()


def test_head_dims_the_kernels_take():
    assert [d for d in range(1, 300) if paged_decode.takes_head_dim(d)] == list(range(16, 257, 16))
    assert [paged_decode.padded_head_dim(d) for d in (16, 64, 80, 96, 128, 144, 256)] == [64, 64, 128, 128, 128,
                                                                                         256, 256]


# ---------------------------------------------------------------- J's and O's padding is exact


@pytest.mark.parametrize("d", [16, 80, 96])
def test_flash_swa_padding_is_exact(d):
    cu = torch.tensor([0, 20, 33], dtype=torch.int32)
    q, k, v = cpu(1, 33, 4, d), cpu(2, 33, 2, d), cpu(3, 33, 2, d)
    do = cpu(4, 33, 4, d)
    scale, D = 1 / math.sqrt(d), paged_decode.padded_head_dim(d)
    o, lse = fs.flash_swa_fwd_plain(q, k, v, cu, cu, True, 7, 2)
    po, plse = fs.flash_swa_fwd_plain(*fs.pad_head_dim(D, q, k, v), cu, cu, True, 7, 2, scale)
    check_tol_diff(po[..., :d], o, **F32)
    check_tol_diff(plse, lse, **F32)
    assert not po[..., d:].any()
    want = fs.flash_swa_bwd_plain(q, k, v, o, lse, do, cu, cu, local_window=7, global_window=2)
    got = fs.flash_swa_bwd_plain(*fs.pad_head_dim(D, q, k, v, o), lse, *fs.pad_head_dim(D, do), cu, cu, local_window=7,
                                 global_window=2, scale=scale)
    for g, w in zip(got, want):
        check_tol_diff(g[..., :d], w, **F32)
    assert fs.narrow_head_dim(d, po)[0].is_contiguous()


@pytest.mark.parametrize("d", [16, 96])
def test_flash_diffusion_padding_is_exact(d):
    q, k, v, do = cpu(5, 2, 4, 12, d), cpu(6, 2, 2, 12, d), cpu(7, 2, 2, 12, d), cpu(8, 2, 4, 12, d)
    mask = torch.from_numpy(np.random.default_rng(9).random((12, 12)) < 0.6) | torch.eye(12, dtype=torch.bool)
    scale, D = 1 / math.sqrt(d), paged_decode.padded_head_dim(d)
    o, lse = fd.flash_diffusion_fwd_plain(q, k, v, mask)
    po, plse = fd.flash_diffusion_fwd_plain(*fs.pad_head_dim(D, q, k, v), mask, scale)
    check_tol_diff(po[..., :d], o, **F32)
    check_tol_diff(plse, lse, **F32)
    want = fd.flash_diffusion_bwd_plain(q, k, v, o, lse, do, mask)
    got = fd.flash_diffusion_bwd_plain(*fs.pad_head_dim(D, q, k, v, o), lse, *fs.pad_head_dim(D, do), mask, scale)
    for g, w in zip(got, want):
        check_tol_diff(g[..., :d], w, **F32)


# ---------------------------------------------------------------- the ops' golden routes


def _paged(lens, hkv, d, bs=16, seed=0):
    n_blocks = sum(-(-n // bs) for n in lens) + 2
    kc, vc = cpu(seed, n_blocks, hkv, bs, d), cpu(seed + 1, n_blocks, hkv, bs, d)
    perm = np.random.default_rng(seed).permutation(n_blocks)
    cols = max(-(-n // bs) for n in lens)
    rows, used = [], 0
    for n in lens:
        need = -(-n // bs)
        rows.append(list(perm[used:used + need]) + [-1] * (cols - need))
        used += need
    return kc, vc, torch.tensor(rows, dtype=torch.int32)


@pytest.mark.parametrize("d, golden", [(8, 1), (24, 1), (16, 0), (80, 0), (96, 0)])
def test_paged_attention_ops_take_the_golden_off_the_kernels_head_dims(d, golden):
    lens = [20, 5]
    kc, vc, bt = _paged(lens, 2, d)
    sl = torch.tensor(lens, dtype=torch.int32)
    q = cpu(3, 2, 4, d)
    before = CudaPagedDecodeGQA.golden_calls
    got = CudaPagedDecodeGQA()(q, kc, vc, sl, bt)
    assert CudaPagedDecodeGQA.golden_calls == before + golden
    check_tol_diff(got, MojoPagedDecodeGQA.get_backend_impl("ref")()(q, kc, vc, sl, bt), **F32)
    cu = torch.tensor([0, 20, 25], dtype=torch.int32)
    qp = cpu(4, 25, 4, d)
    before = CudaPagedPrefillGQA.golden_calls
    got = CudaPagedPrefillGQA()(qp, kc, vc, cu, bt, None, cu, max_q_len=20)
    assert CudaPagedPrefillGQA.golden_calls == before + golden
    check_tol_diff(got, MojoPagedPrefillGQA.get_backend_impl("ref")()(qp, kc, vc, cu, bt, None, cu), **F32)


@pytest.mark.parametrize("given, grid", [(None, 25), (20, 20)])
def test_paged_prefill_ops_bound_kernel_d_by_the_packed_length(given, grid, monkeypatch):
    """Without ``max_q_len`` the prefill ops give kernel D the packed token
    count as its grid bound, read from shapes (no host read of
    ``cu_q_lens``: a CUDA-graph capture would refuse one); a given value
    passes through. Both ops, on ``meta`` tensors, where a host read
    raises."""
    from mojo_opset_tpu_torch.backends.cuda.operators import attention
    from mojo_opset_tpu_torch.backends.cuda.operators.attention import CudaPagedPrefillGQAWithKVDequant

    seen = []
    monkeypatch.setattr(attention, "paged_prefill_gqa", lambda *a, max_q_len, **kw: seen.append(max_q_len))
    q, kc, cu, bt = meta(25, 4, 128), meta(4, 2, 16, 128), i32(3), i32(2, 2)
    CudaPagedPrefillGQA()(q, kc, kc, cu, bt, None, cu, max_q_len=given)
    k8, scale = meta(4, 2, 16, 128, dtype=torch.int8), meta(2, 128, dtype=torch.float32)
    CudaPagedPrefillGQAWithKVDequant()(q, None, k8, scale, k8, scale, cu, bt, None, cu, max_q_len=given)
    assert seen == [grid, grid]


@pytest.mark.parametrize("d, golden", [(8, 1), (96, 0)])
def test_dense_attention_ops_take_the_golden_off_the_kernels_head_dims(d, golden):
    cu = torch.tensor([0, 9, 14], dtype=torch.int32)
    q, k, v = cpu(1, 14, 4, d), cpu(2, 14, 2, d), cpu(3, 14, 2, d)
    before = CudaSWA.golden_calls
    check_tol_diff(CudaSWA()(q, k, v, cu, cu), MojoSWA.get_backend_impl("ref")()(q, k, v, cu, cu), **F32)
    assert CudaSWA.golden_calls == before + golden
    qs, ks = cpu(4, 2, 4, 9, d), cpu(5, 2, 2, 9, d)
    mask = torch.ones(9, 9, dtype=torch.bool).tril()
    before = CudaSdpa.golden_calls
    check_tol_diff(CudaSdpa(enable_gqa=True)(qs, ks, ks, mask),
                   MojoSdpa.get_backend_impl("ref")(enable_gqa=True)(qs, ks, ks, mask), **F32)
    assert CudaSdpa.golden_calls == before + golden


def _mla_ops(r, dr, dtype):
    H, dn, dv = 4, 16, 16
    ops = []
    for tier in ("cuda", "ref"):
        op = MojoPagedDecodeMLA.get_backend_impl(tier)(H, dn, dr, dv, r, device="cpu")
        op.kv_b_proj.data.copy_(cpu(11, *op.kv_b_proj.shape, scale=0.1))
        ops.append(op)
    return ops


@pytest.mark.parametrize("r, dr, dtype, golden", [(1024, 128, torch.bfloat16, 1), (640, 64, torch.float32, 1),
                                                  (20, 8, torch.bfloat16, 1), (256, 64, torch.bfloat16, 0),
                                                  (1024, 64, torch.bfloat16, 0)])
def test_mla_op_takes_the_golden_where_kernel_i_cannot(r, dr, dtype, golden):
    op, gold = _mla_ops(r, dr, dtype)
    lens = [20, 3]
    c, pe, bt = _paged(lens, 1, r, seed=12)
    pe = cpu(13, c.shape[0], 1, 16, dr)
    c, pe = c.to(dtype), pe.to(dtype)
    q = cpu(14, 2, 4, 16 + dr).to(dtype)
    sl = torch.tensor(lens, dtype=torch.int32)
    before = CudaPagedDecodeMLA.golden_calls
    got = op(q, c, pe, sl, bt)
    assert CudaPagedDecodeMLA.golden_calls == before + golden
    if golden:
        assert torch.equal(got, gold(q, c, pe, sl, bt))


@pytest.mark.parametrize("weight_dtype, K, golden", [(torch.int8, 40, 1), ("int4", 40, 1), (torch.int8, 48, 0),
                                                     ("int4", 64, 0)])
def test_quant_gemm_takes_the_golden_off_whole_16_byte_rows(weight_dtype, K, golden):
    N = 128
    ops = [MojoQuantGemm.get_backend_impl(t)(K, N, torch.bfloat16, True, weight_dtype=weight_dtype, device="cpu")
           for t in ("cuda", "ref")]
    rng = np.random.default_rng(K)
    w = torch.from_numpy(rng.integers(-8, 8, (N, K)).astype(np.int8))
    for op in ops:
        op.weight.data.copy_(pack_int4_rows(w) if weight_dtype == "int4" else w)
        op.weight_scale.data.copy_(torch.rand(N, generator=torch.Generator().manual_seed(1)))
    x = torch.from_numpy(rng.integers(-128, 128, (5, K)).astype(np.int8))
    xs = torch.rand(5, 1, generator=torch.Generator().manual_seed(2))
    before = CudaQuantGemm.golden_calls
    assert torch.equal(ops[0](x, xs), ops[1](x, xs))
    assert CudaQuantGemm.golden_calls == before + golden


def test_int4_gemm_past_max_k_takes_the_golden():
    K, N = int4_matmul.MAX_K + 16, 128
    op = MojoQuantGemm.get_backend_impl("cuda")(K, N, torch.float32, True, weight_dtype="int4", device="cpu")
    before = CudaQuantGemm.golden_calls
    out = op(torch.ones(1, K, dtype=torch.int8), torch.ones(1, 1))
    assert CudaQuantGemm.golden_calls == before + 1 and out.shape == (1, N)


@pytest.mark.parametrize("dtype, K, golden", [(torch.bfloat16, 36, 1), (torch.float16, 20, 1),
                                              (torch.bfloat16, 40, 0), (torch.float32, 36, 0)])
def test_group_gemm_takes_the_golden_off_whole_16_byte_rows(dtype, K, golden):
    w = cpu(1, 3, K, 24).to(dtype)
    x = cpu(2, 11, K).to(dtype)
    sizes = torch.tensor([4, 0, 7], dtype=torch.int32)
    before = CudaGroupGemm.golden_calls
    check_tol_diff(CudaGroupGemm(w)(x, sizes), MojoGroupGemm.get_backend_impl("ref")(w)(x, sizes), **F32)
    assert CudaGroupGemm.golden_calls == before + golden


def test_experts_take_the_golden_off_whole_16_byte_rows():
    ops = [MojoExperts.get_backend_impl(t)(4, 36, 24, device="cpu", dtype=torch.bfloat16) for t in ("cuda", "ref")]
    for p, q in zip(ops[0].parameters(), ops[1].parameters()):
        q.data.copy_(p.data)
    x, counts = cpu(3, 9, 36).to(torch.bfloat16), torch.tensor([2, 0, 4, 3])
    before = CudaExperts.golden_calls
    assert torch.equal(ops[0](x, counts), ops[1](x, counts))
    assert CudaExperts.golden_calls == before + 1


# ---------------------------------------------------------------- RoPE's golden routes

# (q shape, k shape, table (rows, width), head_first): the forms JAX's Pallas tier sends to its golden
# (backends/pallas/operators/position_embedding.py:33-67) and kernels B and M do not take
ROPE_GOLDEN_FORMS = {
    "token-first partial": ((8, 4, 128), (8, 2, 128), (8, 64), False),
    "token-first 4-D": ((2, 8, 4, 128), (2, 8, 1, 128), (8, 128), False),
    "token-first 4-D partial": ((2, 8, 4, 128), (2, 8, 1, 128), (8, 64), False),
    "head-first partial": ((2, 4, 8, 128), (2, 2, 8, 128), (8, 64), True),
    "head-first 3-D partial": ((4, 8, 128), (2, 8, 128), (8, 32), True),
    "token-first (1, T, D) table": ((8, 4, 64), (8, 2, 64), (1, 8, 64), False),
}


def _rope_inputs(q_shape, k_shape, table):
    rng = np.random.default_rng(sum(q_shape) + table[-1])
    q, k = (rng.standard_normal(s).astype(np.float32) for s in (q_shape, k_shape))
    ang = rng.uniform(0.0, 6.0, table).astype(np.float32)
    return q, k, np.cos(ang), np.sin(ang)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("form", sorted(ROPE_GOLDEN_FORMS))
def test_rope_golden_forms_match_jax_pallas_and_count(form, dtype, monkeypatch):
    """Each form takes the golden, counted once a call in
    ``CudaApplyRoPE.golden_calls``, and equals JAX's Pallas tier (interpret
    mode; its golden for these forms): fp32 at atol = rtol = 1e-5, bf16
    within the bf16 ladder (both goldens round the fp32-table product to
    bf16 once, XLA and PyTorch may fuse the sum differently)."""
    import jax.numpy as jnp

    import mojo_opset_tpu as jm
    from mojo_opset_tpu_torch import MojoApplyRoPE
    from mojo_opset_tpu_torch.backends.cuda.operators import CudaApplyRoPE
    from mojo_opset_tpu_torch.utils.acc import tols_for

    monkeypatch.setenv("MOJO_PALLAS_INTERPRET", "1")
    q_shape, k_shape, table, head_first = ROPE_GOLDEN_FORMS[form]
    q, k, cos, sin = _rope_inputs(q_shape, k_shape, table)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jm.MojoApplyRoPE.get_backend_impl("pallas", strict=True)()(
        jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(cos), jnp.asarray(sin), head_first=head_first)
    op = MojoApplyRoPE()
    assert isinstance(op, CudaApplyRoPE)
    before = CudaApplyRoPE.golden_calls
    got = op(torch.from_numpy(q).to(tdt), torch.from_numpy(k).to(tdt), torch.from_numpy(cos), torch.from_numpy(sin),
             head_first=head_first)
    assert CudaApplyRoPE.golden_calls == before + 1
    tol = F32 if dtype == "float32" else tols_for(tdt)
    for g, w in zip(got, want):
        assert g.dtype == tdt and g.shape == w.shape
        check_tol_diff(g, np.asarray(w, np.float32), **tol)


@pytest.mark.parametrize("q_shape, table, head_first", [((8, 4, 128), (8, 128), False),
                                                        ((2, 4, 8, 128), (8, 128), True),
                                                        ((2, 4, 8, 64), (2, 8, 64), True),
                                                        ((4, 8, 64), (8, 64), True)])
def test_rope_full_tables_stay_on_kernels_b_and_m(q_shape, table, head_first, no_build):
    """Full-width tables in the kernels' layouts reach kernel B or M (on
    ``meta`` tensors: the stubbed build raises) and count no golden route."""
    from mojo_opset_tpu_torch import MojoApplyRoPE
    from mojo_opset_tpu_torch.backends.cuda.operators import CudaApplyRoPE

    k_shape = (*q_shape[:-3], 2, *q_shape[-2:]) if head_first else (*q_shape[:-2], 2, q_shape[-1])
    before = CudaApplyRoPE.golden_calls
    with pytest.raises(RuntimeError, match=NO_BUILD):
        MojoApplyRoPE()(meta(*q_shape), meta(*k_shape), meta(*table), meta(*table), head_first=head_first)
    assert CudaApplyRoPE.golden_calls == before


def test_rope_token_first_fp32_tables_take_kernel_m(no_build, monkeypatch):
    """Token-first (T, H, D) bf16 rows with fp32 (T, D) tables, the form
    JAX's Pallas tier runs on ``rope_token_first`` (its kernel casts the
    tables to fp32), reach kernel M through its token-first view: on
    ``meta`` tensors the stubbed build raises and no golden route is
    counted; on the CPU M's plain version gets the (1, H, T, D) views and
    the result equals JAX's Pallas tier (interpret mode) within the bf16
    ladder."""
    import jax.numpy as jnp

    import mojo_opset_tpu as jm
    from mojo_opset_tpu_torch import MojoApplyRoPE
    from mojo_opset_tpu_torch.backends.cuda.operators import CudaApplyRoPE
    from mojo_opset_tpu_torch.backends.cuda.operators import position_embedding as pe
    from mojo_opset_tpu_torch.utils.acc import tols_for

    before = CudaApplyRoPE.golden_calls
    with pytest.raises(RuntimeError, match=NO_BUILD):
        MojoApplyRoPE()(meta(16, 4, 128), meta(16, 2, 128), meta(16, 128, dtype=torch.float32),
                        meta(16, 128, dtype=torch.float32), head_first=False)
    assert CudaApplyRoPE.golden_calls == before

    monkeypatch.setenv("MOJO_PALLAS_INTERPRET", "1")
    seen, kernel_m = [], pe.rope_head_first

    def rotate(q, k, cos, sin, negate_sin=False):
        seen.append((tuple(q.shape), tuple(k.shape), cos.dtype))
        return kernel_m(q, k, cos, sin, negate_sin)

    monkeypatch.setattr(pe, "rope_head_first", rotate)
    q, k, cos, sin = _rope_inputs((16, 4, 128), (16, 2, 128), (16, 128))
    want = jm.MojoApplyRoPE.get_backend_impl("pallas", strict=True)()(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16), jnp.asarray(cos), jnp.asarray(sin),
        head_first=False)
    got = MojoApplyRoPE()(torch.from_numpy(q).bfloat16(), torch.from_numpy(k).bfloat16(), torch.from_numpy(cos),
                          torch.from_numpy(sin), head_first=False)
    assert seen == [((1, 4, 16, 128), (1, 2, 16, 128), torch.float32)]
    assert CudaApplyRoPE.golden_calls == before
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        check_tol_diff(g, np.asarray(w, np.float32), **tols_for(torch.bfloat16))
