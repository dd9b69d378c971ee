"""Port parity for the normalization ops of slice E: ``MojoGroupRMSNorm``,
``MojoLayerNormQuant`` and the residual-add family
(``MojoResidualAdd{RMS,Layer}Norm``, ``MojoResidualAdd{RMS,Layer}NormQuant``)
of mojo_opset_tpu_torch against mojo_opset_tpu, on the CPU; and kernel P
(``residual_add_rmsnorm``): its plain version against the JAX package's
Pallas kernel in interpret mode, and ``CudaResidualAddRMSNorm`` on CPU
tensors (the plain version) against JAX's golden. Kernel A's lane map: at
the widths the models use, ``norms.row_layout`` splits a row over lanes
that each read a fixed number of 16-byte vectors (each element once, no
lane idle); a plain-PyTorch model of the kernel's reduction order
(per-lane sums, shuffles over the row's lanes, whole warps in order) is
held to ``rms_norm`` and to JAX's Pallas ``rmsnorm`` in interpret mode.
Kernel E (RMSNorm + int8 quant) takes A's row layouts: a model of its sum
order, amax and int8 step (the register kernel at the layouts' widths, the
generic block kernel elsewhere) is held to ``rmsnorm_quant_plain`` and to
JAX's Pallas ``rmsnorm_quant`` in interpret mode (scale rtol 1e-6, int8
values one step apart on at most 0.1%, as tests/test_torch_quant.py holds
the ops), and each of E's routes reaches its launch. Kernel K (the RMSNorm
backward) takes A's row layouts too: a model of its register route (each
team's shuffled sums, dx from the registers, dw per team across its rows,
per block in team order, per column in block order through the column
sum's slices) is held to ``rmsnorm_bwd_plain`` (fp32 1e-5, bf16 the dtype
ladder) and to JAX's Pallas ``rmsnorm_vjp`` in interpret mode, and each of
K's routes reaches its launch with its grid fixed by the shape alone.

The same numpy inputs and weights (carried across with ``load_numpy_state``
from ``state_dict_of``) go through both packages. Tolerances, as in
``tests/test_torch_train_functions.py``: fp32 2e-5 (one algorithm, sums in
another order), bf16 2e-2 and fp16 4e-3 (each side rounds once to the
working type from fp32, at different places). The int8 quant outputs may
part by one step where a sum in another order moves a value across a
rounding tie: at most one step on at most 1% of the values.
"""

import re
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mojo_opset_tpu.core.operators as jo
from mojo_opset_tpu.backends.pallas.kernels.norms import residual_add_rmsnorm as jax_residual_add_rmsnorm
from mojo_opset_tpu.backends.pallas.kernels.norms import rmsnorm as jax_rmsnorm
from mojo_opset_tpu.backends.pallas.kernels.norms import rmsnorm_quant as jax_rmsnorm_quant
from mojo_opset_tpu.backends.pallas.kernels.rmsnorm_vjp import rmsnorm_vjp as jax_rmsnorm_vjp
from mojo_opset_tpu.utils.hf import state_dict_of
import mojo_opset_tpu_torch as tm
from mojo_opset_tpu_torch.backends.cuda import build, kernels
from mojo_opset_tpu_torch.backends.cuda.kernels import norms, rmsnorm_quant, rmsnorm_vjp
from mojo_opset_tpu_torch.utils.acc import check_tol_diff, tols_for
from mojo_opset_tpu_torch.utils.weights import load_numpy_state

EPS = 1e-6
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16),
          "f16": (jnp.float16, torch.float16)}
TOL = {"f32": dict(atol=2e-5, rtol=2e-5), "bf16": dict(atol=2e-2, rtol=2e-2), "f16": dict(atol=4e-3, rtol=4e-3)}
JAX_DTYPE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16, torch.float16: jnp.float16}


def inputs(shape, dtype_name, seed=0, scale=1.0):
    """Two arrays of ``shape`` in the dtype, as JAX arrays and torch tensors
    of the same rounded values."""
    jdt, tdt = DTYPES[dtype_name]
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        a = jnp.asarray(rng.standard_normal(shape) * scale, jdt)
        out += [a, torch.from_numpy(np.array(a, np.float32)).to(tdt)]
    return out


def close(got: torch.Tensor, want, tol) -> None:
    check_tol_diff(got.float(), np.asarray(jnp.asarray(want, jnp.float32)), **tol)


def same_dtype(got: torch.Tensor, want) -> None:
    assert JAX_DTYPE[got.dtype] == want.dtype, (got.dtype, want.dtype)


def pair(name, *args, affine_seed=1, **kwargs):
    """The JAX ref-tier op and the port's ref-tier op, with random weights
    (and biases) set on the JAX side and carried across."""
    jop = getattr(jo, name).get_backend_impl("ref")(*args, **kwargs)
    rng = np.random.default_rng(affine_seed)
    for attr in ("weight", "bias"):
        if getattr(jop, attr, None) is not None:
            value = getattr(jop, attr)
            setattr(jop, attr, jnp.asarray(rng.uniform(0.5, 1.5, value.shape) if attr == "weight"
                                           else rng.standard_normal(value.shape) * 0.1, value.dtype))
    op = getattr(tm, name).get_backend_impl("ref")(*args, **kwargs, device="cpu")
    load_numpy_state(op, state_dict_of(jop))
    return jop, op


def check_quant(got_q: torch.Tensor, got_s: torch.Tensor, want_q, want_s) -> None:
    check_tol_diff(got_s, np.asarray(want_s), atol=0.0, rtol=1e-5)
    diff = (got_q.int() - torch.from_numpy(np.asarray(want_q).astype(np.int32))).abs()
    assert diff.max().item() <= 1 and int((diff > 0).sum()) <= max(1, diff.numel() // 100), diff.max()


@pytest.mark.parametrize("dtype_name", list(DTYPES))
@pytest.mark.parametrize("norm_pos", ["pre", "post"])
@pytest.mark.parametrize("name", ["MojoResidualAddRMSNorm", "MojoResidualAddLayerNorm"])
def test_residual_add_norms_match_jax(name, norm_pos, dtype_name):
    """Both outputs and their dtypes: the sum is taken in the input dtype
    before the norm, and in ``post`` the residual is the normed output."""
    jh, th, jr, tr = inputs((3, 5, 64), dtype_name)
    jop, op = pair(name, 64, EPS, norm_pos)
    for got, want in zip(op(th, tr), jop(jh, jr)):
        same_dtype(got, want)
        close(got, want, TOL[dtype_name])


@pytest.mark.parametrize("dtype_name", list(DTYPES))
@pytest.mark.parametrize("norm_pos", ["pre", "post"])
@pytest.mark.parametrize("name", ["MojoResidualAddRMSNormQuant", "MojoResidualAddLayerNormQuant"])
def test_residual_add_quant_norms_match_jax(name, norm_pos, dtype_name):
    """(q, residual, scale): in ``post`` the RMSNorm op keeps the fp32 normed
    value as the residual, the LayerNorm op the un-normed sum."""
    jh, th, jr, tr = inputs((6, 96), dtype_name, seed=2)
    jop, op = pair(name, 96, EPS, norm_pos=norm_pos)
    (q, res, scale), (jq, jres, jscale) = op(th, tr), jop(jh, jr)
    assert q.dtype == torch.int8 and scale.dtype == torch.float32
    check_quant(q, scale, jq, jscale)
    same_dtype(res, jres)
    close(res, jres, TOL[dtype_name])
    want_fp32 = name == "MojoResidualAddRMSNormQuant" and norm_pos == "post"
    assert (res.dtype == torch.float32) == (want_fp32 or dtype_name == "f32")


def test_residual_add_quant_norms_take_a_smooth_scale():
    jh, th, jr, tr = inputs((4, 64), "f32", seed=3)
    smooth = np.random.default_rng(4).uniform(0.5, 1.5, 64).astype(np.float32)
    for name in ("MojoResidualAddRMSNormQuant", "MojoResidualAddLayerNormQuant"):
        jop, op = pair(name, 64, EPS, norm_pos="pre")
        (q, _, scale), (jq, _, jscale) = op(th, tr, torch.from_numpy(smooth)), jop(jh, jr, jnp.asarray(smooth))
        check_quant(q, scale, jq, jscale)


@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("dtype_name", list(DTYPES))
def test_group_rms_norm_matches_jax(dtype_name, affine):
    jx, tx, jy, ty = inputs((5, 32), dtype_name, seed=5)
    jop, op = pair("MojoGroupRMSNorm", 2, 32, EPS, elementwise_affine=affine)
    assert (op.weight is None) == (not affine) and (affine or not list(op.parameters()))
    outs, wants = op([tx, ty]), jop([jx, jy])
    assert len(outs) == 2
    for got, want in zip(outs, wants):
        same_dtype(got, want)
        close(got, want, TOL[dtype_name])


@pytest.mark.parametrize("smooth", [False, True])
@pytest.mark.parametrize("affine", [True, False])
def test_layer_norm_quant_matches_jax(affine, smooth):
    jx, tx, _, _ = inputs((7, 80), "f32", seed=6, scale=2.0)
    jop, op = pair("MojoLayerNormQuant", 80, EPS, elementwise_affine=affine)
    sm = np.random.default_rng(7).uniform(0.5, 1.5, 80).astype(np.float32) if smooth else None
    (q, scale), (jq, jscale) = (op(tx, None if sm is None else torch.from_numpy(sm)),
                                jop(jx, None if sm is None else jnp.asarray(sm)))
    check_quant(q, scale, jq, jscale)


def test_norm_pos_is_checked():
    for name in ("MojoResidualAddRMSNorm", "MojoResidualAddLayerNorm", "MojoResidualAddRMSNormQuant",
                 "MojoResidualAddLayerNormQuant"):
        with pytest.raises(ValueError, match="norm_pos"):
            getattr(tm, name)(16, norm_pos="middle", device="cpu")


# ------------------------------------------------------------ kernel P


@pytest.mark.parametrize("shape", [(16, 128), (3, 7, 96)], ids=str)
@pytest.mark.parametrize("dtype_name", list(DTYPES))
@pytest.mark.parametrize("norm_pos", ["pre", "post"])
def test_residual_add_rmsnorm_plain_matches_pallas_interpret(norm_pos, dtype_name, shape):
    """P's plain version against the TPU kernel run in interpret mode: both
    keep the sum in fp32 through the norm."""
    jh, th, jr, tr = inputs(shape, dtype_name, seed=8)
    w = np.random.default_rng(9).uniform(0.5, 1.5, shape[-1]).astype(np.float32)
    want = jax_residual_add_rmsnorm(jh, jr, jnp.asarray(w), EPS, norm_pos=norm_pos, interpret=True)
    got = norms.residual_add_rmsnorm_plain(th, tr, torch.from_numpy(w), EPS, norm_pos)
    for g, wnt in zip(got, want):
        same_dtype(g, wnt)
        close(g, wnt, TOL[dtype_name])


@pytest.mark.parametrize("residual_dtype", ["same", "f32"])
@pytest.mark.parametrize("dtype_name", list(DTYPES))
@pytest.mark.parametrize("norm_pos", ["pre", "post"])
def test_cuda_residual_add_rmsnorm_on_cpu_matches_jax_golden(norm_pos, dtype_name, residual_dtype):
    """The cuda tier on CPU tensors runs P's plain version (no launch). It
    returns the golden's dtypes: the new residual in the inputs' promoted
    dtype in ``pre`` (an fp32 residual stays fp32), hidden's in ``post``.
    Its sum is not rounded before the norm, the golden's is: the two part
    within the dtype's ladder."""
    jh, th, jr, tr = inputs((9, 160), dtype_name, seed=10)
    if residual_dtype == "f32":
        jr, tr = jr.astype(jnp.float32), tr.float()
    jop, _ = pair("MojoResidualAddRMSNorm", 160, EPS, norm_pos)
    op = tm.MojoResidualAddRMSNorm(160, EPS, norm_pos, device="cpu")
    assert type(op).__name__ == "CudaResidualAddRMSNorm"
    load_numpy_state(op, state_dict_of(jop))
    kernels.reset_launch_counts()
    got = op(th, tr)
    assert set(kernels.launch_counts().values()) == {0}
    for g, want in zip(got, jop(jh, jr)):
        same_dtype(g, want)
        close(g, want, TOL[dtype_name])


def test_residual_add_rmsnorm_wrapper_refuses_other_dtype_pairs():
    """P takes a residual in hidden's dtype or fp32; any other pairing raises
    (JAX's Pallas tier writes the residual in hidden's dtype whatever it is
    given), on the CPU as on the card."""
    w = torch.ones(8)
    for hidden, residual in ((torch.bfloat16, torch.float16), (torch.float32, torch.bfloat16),
                             (torch.float16, torch.bfloat16)):
        with pytest.raises(ValueError, match="hidden's dtype or float32"):
            norms.residual_add_rmsnorm(torch.ones(2, 8, dtype=hidden), torch.ones(2, 8, dtype=residual), w, EPS)
    with pytest.raises(ValueError, match="norm_pos"):
        norms.residual_add_rmsnorm(torch.ones(2, 8), torch.ones(2, 8), w, EPS, "middle")
    with pytest.raises(ValueError, match="must match hidden"):
        norms.residual_add_rmsnorm(torch.ones(2, 8), torch.ones(3, 8), w, EPS)
    with pytest.raises(ValueError, match="float32"):
        norms.residual_add_rmsnorm(torch.ones(2, 8), torch.ones(2, 8), w.bfloat16(), EPS)


# ------------------------------------------------------------ kernel A

# the widths the models run A at: the q/k head norms, DeepSeek-V3's kv_a, q_a and layer norms, Qwen3-4B's, the Wan
# DiT's and Seed-OSS-36B's layer norms
A_WIDTHS = (128, 512, 1536, 2560, 3072, 5120, 7168)
A_DTYPES = {"bf16": torch.bfloat16, "f16": torch.float16, "f32": torch.float32}


def lane_map(D, dtype):
    """csrc/rmsnorm.cu's register kernel: the elements of a row each of its TPR threads reads, in the order it
    sums them (vector i * TPR + sub, then the vector's elements)."""
    tpr, vpt = norms.row_layout(D, dtype)
    vec = 16 // torch.empty((), dtype=dtype).element_size()
    return torch.tensor([[(i * tpr + sub) * vec + k for i in range(vpt) for k in range(vec)] for sub in range(tpr)])


def generic_map(D, vec, threads):
    """The generic row kernels' pass over a row (each pass, the sum and the scaling, reads it once): thread t
    reads chunks of ``vec`` elements from t * vec, stepping ``threads * vec``."""
    return [[c + k for c in range(t * vec, D, threads * vec) for k in range(vec)] for t in range(threads)]


def lane_model(x, w, eps):
    """A's output as the register kernel computes it: fp32 sums of each lane's elements in its order, a xor
    butterfly over the row's lanes (over 32 at most), then the warps' sums in order; y = (x * inv) * w."""
    rows, D = x.shape
    lanes = lane_map(D, x.dtype)
    tpr = lanes.shape[0]
    xf = x.float()
    part = torch.zeros(rows, tpr)
    for j in range(lanes.shape[1]):
        part = part + xf[:, lanes[:, j]] ** 2
    o = min(tpr, 32) // 2
    while o:
        part = part + part[:, torch.arange(tpr) ^ o]
        o //= 2
    ss = part[:, 0]
    if tpr > 32:
        ss = torch.zeros(rows)
        for warp in range(tpr // 32):
            ss = ss + part[:, 32 * warp]
    inv = 1.0 / torch.sqrt(ss / D + eps)
    return ((xf * inv[:, None]) * w.float()).to(x.dtype)


@pytest.mark.parametrize("dtype_name", list(A_DTYPES))
@pytest.mark.parametrize("D", A_WIDTHS)
def test_rmsnorm_lanes_read_each_element_once_and_none_idles(D, dtype_name):
    dtype = A_DTYPES[dtype_name]
    layout = norms.row_layout(D, dtype)
    if layout is None:  # fp32 rows of 5120 and 7168 take the generic kernels: each pass reads every element once
        assert dtype == torch.float32 and D > 3072
        reads = sorted(c for lane in generic_map(D, 4, 256) for c in lane)
        assert reads == list(range(D))
        return
    tpr, vpt = layout
    lanes = lane_map(D, dtype)
    assert sorted(lanes.flatten().tolist()) == list(range(D))  # every element of a row, once
    assert all(len(lane) == vpt * (16 // torch.empty((), dtype=dtype).element_size()) for lane in lanes.tolist())
    # the row's lanes fill whole warps, or a warp holds whole rows: no lane of a block idles
    assert (tpr <= 32 and 32 % tpr == 0) or tpr % 32 == 0
    assert norms.ROW_BLOCK_THREADS % tpr == 0
    if D == 128 and dtype != torch.float32:
        assert layout == (8, 2)  # 4 rows a warp of 8 lanes with 2 vectors each


@pytest.mark.parametrize("D, dtype_name", [(33, "f32"), (300, "f16"), (300, "bf16"), (96, "bf16")])
def test_rmsnorm_odd_widths_take_the_generic_kernels(D, dtype_name):
    dtype = A_DTYPES[dtype_name]
    assert norms.row_layout(D, dtype) is None
    per_vector = 16 // torch.empty((), dtype=dtype).element_size()
    vec = per_vector if D % per_vector == 0 else 1
    threads = 32 if D <= 256 else 256  # a warp a short row, a block a long one
    assert sorted(c for lane in generic_map(D, vec, threads) for c in lane) == list(range(D))


# fp32 rows of 5120 and 7168 (no model runs them) take the generic kernels
@pytest.mark.parametrize("D, dtype_name", [(D, n) for D in A_WIDTHS for n in A_DTYPES if n != "f32" or D <= 3072])
def test_rmsnorm_lane_model_matches_the_plain_version(D, dtype_name):
    dtype = A_DTYPES[dtype_name]
    rng = np.random.default_rng(D)
    x = torch.from_numpy(rng.standard_normal((6, D)).astype(np.float32) * 2).to(dtype)
    w = torch.from_numpy(rng.uniform(0.5, 1.5, D).astype(np.float32))
    got, want = lane_model(x, w, EPS), norms.rmsnorm_plain(x, w, EPS)
    assert got.dtype == want.dtype
    tol = dict(atol=2e-6, rtol=2e-6) if dtype == torch.float32 else TOL[dtype_name]
    check_tol_diff(got.float(), want.float(), **tol)


@pytest.mark.parametrize("D", [128, 2560])
@pytest.mark.parametrize("dtype_name", ["bf16", "f32"])
def test_rmsnorm_lane_model_matches_pallas_interpret(dtype_name, D):
    jx, tx, _, _ = inputs((16, D), dtype_name, seed=D)
    w = np.random.default_rng(D + 1).uniform(0.5, 1.5, D).astype(np.float32)
    want = jax_rmsnorm(jx, jnp.asarray(w), EPS, interpret=True)
    got = lane_model(tx, torch.from_numpy(w), EPS)
    same_dtype(got, want)
    close(got, want, TOL[dtype_name])


def source_row_layouts():
    """The (threads a row, vectors a thread) pairs that csrc/row_regs.cuh's MOJO_ROW_LAYOUTS names."""
    src = (build.CSRC_DIR / "row_regs.cuh").read_text()
    pairs = re.search(r"#define MOJO_ROW_LAYOUTS\(X\)(.*?)\n\n", src, re.S).group(1)
    return sorted((int(a), int(b)) for a, b in re.findall(r"X\((\d+), (\d+)\)", pairs))


def test_rmsnorm_row_layouts_match_the_kernel_source():
    """A's register kernel instantiates the shared header's layouts, which are norms.ROW_LAYOUTS's pairs."""
    src = (build.CSRC_DIR / "rmsnorm.cu").read_text()
    assert source_row_layouts() == sorted(norms.ROW_LAYOUTS.values())
    assert '#include "row_regs.cuh"' in src and "MOJO_ROW_LAYOUTS(MOJO_ROW_CASE)" in src
    assert f"kRegRowThreads = {norms.ROW_BLOCK_THREADS};" in src


# ------------------------------------------------------------ kernel E

# the widths the models run E at: Qwen3-4B's layer norms (2560), Seed-OSS-36B's (5120); fp32 rows of 5120 take the
# generic kernel
E_WIDTHS = (2560, 5120)
E_DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def butterfly(part, lanes, width):
    """``part`` (rows, lanes) summed by xor shuffles over groups of ``width`` lanes, as the kernels' loops do."""
    o = width // 2
    while o:
        part = part + part[:, torch.arange(lanes) ^ o]
        o //= 2
    return part


def rq_sum_of_squares(xf, dtype):
    """E's fp32 sum of squares of each row in its kernel's order. The register kernel: each lane's elements in
    order, a butterfly over the row's lanes (32 at most), the warps' sums in order. The generic kernel: each of 256
    threads its chunks in order, a butterfly over each warp, the 8 warps' sums in order."""
    rows, D = xf.shape
    layout = norms.row_layout(D, dtype)
    vec = 16 // torch.empty((), dtype=dtype).element_size()
    lanes = lane_map(D, dtype) if layout else generic_map(D, vec if D % vec == 0 else 1, 256)
    threads = len(lanes)
    part = torch.zeros(rows, threads)
    for j in range(max(len(lane) for lane in lanes)):
        cols = torch.tensor([lane[j] if j < len(lane) else -1 for lane in lanes])
        part = part + torch.where(cols >= 0, xf[:, cols.clamp(min=0)] ** 2, torch.zeros(()))
    part = butterfly(part, threads, min(threads, 32))
    ss = torch.zeros(rows)
    for warp in range(max(threads // 32, 1)):
        ss = ss + part[:, 32 * warp]
    return ss


def rq_lane_model(x, w, eps, smooth=None, q_min=-128.0, q_max=127.0):
    """E's outputs as its kernel computes them: the sum of squares in the kernel's order, inv = 1 / sqrt(ss / D +
    eps), normed = (x * inv) * w [* smooth] in fp32, the row's amax (max has no order), scale = max(amax, 1e-12) /
    q_max, q = clamp(rint(normed / scale)) by a true division."""
    xf = x.float()
    inv = 1.0 / torch.sqrt(rq_sum_of_squares(xf, x.dtype) / x.shape[-1] + eps)
    normed = (xf * inv[:, None]) * w
    if smooth is not None:
        normed = normed * smooth
    scale = normed.abs().amax(dim=-1, keepdim=True).clamp(min=1e-12) / q_max
    return torch.round(normed / scale).clamp(q_min, q_max).to(torch.int8), scale


def rn32(x: Fraction) -> float:
    """``x`` rounded to the nearest float32, ties to even (subnormals kept, overflow not reached here)."""
    if x == 0:
        return 0.0
    sign, x = (-1 if x < 0 else 1), abs(x)
    e = x.numerator.bit_length() - x.denominator.bit_length()
    e -= Fraction(2) ** e > x
    quantum = Fraction(2) ** (max(e, -126) - 23)
    units, rest = divmod(x / quantum, 1)
    units += rest > Fraction(1, 2) or (rest == Fraction(1, 2) and units % 2 == 1)
    return sign * float(units * quantum)


def row_quant_step(n: float, scale: float, q_min: float, q_max: float) -> int:
    """csrc/rmsnorm_quant.cu's RowQuant on one value, in exact arithmetic with one float32 rounding an operation:
    the reciprocal, the quotient and its two fused corrections, the addition of 1.5 * 2^23, the clamp."""
    F = Fraction
    rcp = rn32(1 / F(scale))
    q0 = rn32(F(n) * F(rcp))
    q1 = rn32(F(rn32(F(n) - F(q0) * F(scale))) * F(rcp) + F(q0))
    quot = rn32(F(rn32(F(n) - F(q1) * F(scale))) * F(rcp) + F(q1))
    t = min(max(rn32(F(quot) + 12582912), q_min + 12582912), q_max + 12582912)
    return int(t) - 12582912


@pytest.mark.parametrize("scale", [np.float32(2.5) / np.float32(127.0), np.float32(1e-12) / np.float32(127.0),
                                   np.float32(3.3e-3), np.float32(7.0)])
def test_rmsnorm_quant_int8_step_equals_the_division_and_rint_at_ties(scale):
    """The register kernel's int8 step gives clamp(rint(n / scale)) for values whose quotient lies on and within
    three ulps of every tie k + 0.5, where the division's rounding decides the int8 value."""
    scale = float(scale)
    values = []
    for k in range(-129, 128):
        v = np.float32(rn32((k + Fraction(1, 2)) * Fraction(scale)))
        for _ in range(3):
            v = np.nextafter(v, np.float32(-np.inf))
        for _ in range(7):
            values.append(v)
            v = np.nextafter(v, np.float32(np.inf))
    for n in values:
        want = int(np.clip(np.rint(rn32(Fraction(float(n)) / Fraction(scale))), -128, 127))
        assert row_quant_step(float(n), scale, -128.0, 127.0) == want, (n, scale)


def assert_quant_close(got, want):
    """Scales to rtol 1e-6; int8 values at most one step apart, on at most 0.1% of them (a sum in another order
    moves a value across a rounding tie)."""
    (q, s), (q_want, s_want) = got, want
    check_tol_diff(s, np.asarray(s_want), atol=0.0, rtol=1e-6)
    diff = (q.int() - torch.from_numpy(np.asarray(q_want).astype(np.int32))).abs()
    assert diff.max().item() <= 1 and int((diff > 0).sum()) <= 1e-3 * diff.numel(), (diff.max(), (diff > 0).sum())


def rq_inputs(rows, D, dtype, seed, smooth):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((rows, D)).astype(np.float32) * 2).to(dtype)
    x[1] = 0  # a zero row keeps its floor scale
    w = torch.from_numpy(rng.uniform(0.5, 1.5, D).astype(np.float32))
    sm = torch.from_numpy(rng.uniform(0.5, 1.5, D).astype(np.float32)) if smooth else None
    return x, w, sm


@pytest.mark.parametrize("smooth", [False, True])
@pytest.mark.parametrize("dtype_name", list(E_DTYPES))
@pytest.mark.parametrize("D", E_WIDTHS)
def test_rmsnorm_quant_lane_model_matches_the_plain_version(D, dtype_name, smooth):
    x, w, sm = rq_inputs(12, D, E_DTYPES[dtype_name], D, smooth)
    got = rq_lane_model(x, w, EPS, sm)
    want = rmsnorm_quant.rmsnorm_quant_plain(x, w, EPS, sm)
    assert got[0].dtype == torch.int8 and got[1].shape == want[1].shape == (12, 1)
    assert_quant_close(got, (want[0].numpy(), want[1].numpy()))
    assert got[1][1].item() == want[1][1].item() == np.float32(1e-12) / np.float32(127.0)


@pytest.mark.parametrize("dtype_name", list(E_DTYPES))
@pytest.mark.parametrize("D", E_WIDTHS)
def test_rmsnorm_quant_lane_model_matches_pallas_interpret(D, dtype_name):
    x, w, _ = rq_inputs(16, D, E_DTYPES[dtype_name], D + 1, False)
    jx = jnp.asarray(x.float().numpy(), JAX_DTYPE[x.dtype])
    want = jax_rmsnorm_quant(jx, jnp.asarray(w.numpy()), EPS, -128.0, 127.0, interpret=True)
    assert_quant_close(rq_lane_model(x, w, EPS), want)


@pytest.mark.parametrize("D, dtype_name, layout", [(2560, "bf16", (32, 10)), (5120, "bf16", (64, 10)),
                                                   (2560, "f32", (64, 10)), (5120, "f32", None), (300, "bf16", None),
                                                   (33, "f32", None)])
def test_rmsnorm_quant_layouts_are_norms_row_layouts(D, dtype_name, layout):
    dtype = A_DTYPES[dtype_name]
    x, w = torch.zeros(3, D, dtype=dtype), torch.ones(D)
    assert rmsnorm_quant.layout(x, w) == rmsnorm_quant.layout(x, w, torch.ones(D)) == norms.row_layout(D, dtype)
    assert norms.row_layout(D, dtype) == layout


@pytest.mark.parametrize("q_min, q_max", [(-127.5, 127.0), (-128.0, 127.25), (-129.0, 127.0), (-128.0, 200.0)])
def test_rmsnorm_quant_limits_off_int8_take_the_generic_kernel(q_min, q_max):
    x, w = torch.zeros(3, 2560, dtype=torch.bfloat16), torch.ones(2560)
    assert rmsnorm_quant.layout(x, w, None, -127.0, 127.0) == (32, 10)
    assert rmsnorm_quant.layout(x, w, None, q_min, q_max) is None


@pytest.mark.parametrize("which", ["x", "weight", "smooth_scale"])
def test_rmsnorm_quant_unaligned_pointers_take_the_generic_kernel(which):
    def tensor(name, shape, dtype):
        n = int(np.prod(shape))
        return torch.zeros(n + 1, dtype=dtype)[int(name == which):][:n].view(shape)

    x = tensor("x", (3, 2560), torch.bfloat16)
    assert rmsnorm_quant.layout(x, tensor("weight", (2560,), torch.float32),
                                tensor("smooth_scale", (2560,), torch.float32)) is None


def test_rmsnorm_quant_row_layouts_match_the_kernel_source():
    """E's register kernel instantiates the header's layouts (norms.ROW_LAYOUTS's pairs) in A's block size."""
    src = (build.CSRC_DIR / "rmsnorm_quant.cu").read_text()
    assert source_row_layouts() == sorted(norms.ROW_LAYOUTS.values())
    assert '#include "row_regs.cuh"' in src and "MOJO_ROW_LAYOUTS(MOJO_ROW_CASE)" in src
    assert f"kRqRegThreads = {norms.ROW_BLOCK_THREADS};" in src
    # the generic kernel divides; the register kernel divides too, or corrects the reciprocal's quotient twice
    # (the division's bits), so that ties land as in the golden
    assert "rintf(v[j][e] / scale)" in src and "quot = n / scale;" in src
    assert "__fmaf_rn(__fmaf_rn(-q1, scale, n), rcp, q1)" in src


@pytest.mark.parametrize("shape, dtype, smooth, layout", [
    ((1650, 2560), torch.bfloat16, False, (32, 10)), ((4, 5120), torch.bfloat16, True, (64, 10)),
    ((1, 2560), torch.float16, False, (32, 10)), ((6, 5120), torch.float32, True, None),
    ((5, 33), torch.float32, False, None), ((3, 300), torch.float16, True, None),
])
def test_rmsnorm_quant_each_route_reaches_its_launch(monkeypatch, shape, dtype, smooth, layout):
    """Off the CPU the wrapper picks the route from the width, the dtype and the pointers alone and launches once
    with its layout ((0, 0): the generic kernel)."""
    calls = []
    monkeypatch.setattr(build, "launch", lambda name, device, *args: calls.append((name, args)))
    monkeypatch.setattr(rmsnorm_quant, "launches", rmsnorm_quant.launches)
    meta = lambda *s, dtype=torch.float32: torch.empty(s, device="meta", dtype=dtype)  # noqa: E731
    D, before = shape[-1], rmsnorm_quant.launches
    q, scale = rmsnorm_quant.rmsnorm_quant(meta(*shape, dtype=dtype), meta(D), EPS, meta(D) if smooth else None)
    assert q.dtype == torch.int8 and q.shape == shape and scale.shape == shape[:-1] + (1,)
    ((name, args),) = calls
    assert name == "mojo_rmsnorm_quant" and args[5:7] == (shape[0], D)
    assert args[11:13] == (layout or (0, 0)) and rmsnorm_quant.launches == before + 1


# ------------------------------------------------------------ kernel K


def column_sum(part):
    """common.cuh's mojo_column_sum_kernel over (rows, cols) partial rows: slice s of 32 adds rows s, s + 32, ... in
    order, then the 32 slice sums are added in slice order."""
    slices = torch.zeros(32, part.shape[1])
    for r in range(part.shape[0]):
        slices[r % 32] = slices[r % 32] + part[r]
    total = torch.zeros(part.shape[1])
    for sl in slices:
        total = total + sl
    return total


def k_lane_model(x, w, dy, eps, blocks):
    """K's register route as its kernel computes it, for ``blocks`` blocks: per-lane fp32 sums of x^2 and (dy * w) * x
    in the lane's order, a xor butterfly over the row's lanes (32 at most), the warps' sums in order; dx from the
    registers; each team's dw sums over the rows it takes (team t of block b: row t of groups b, b + blocks, ...),
    the block's partial row its teams' sums in team order, dw the column sum of the blocks' rows."""
    rows, D = x.shape
    lanes = lane_map(D, x.dtype)
    tpr = lanes.shape[0]
    rpb = norms.ROW_BLOCK_THREADS // tpr
    xf, dyf = x.float(), dy.float()
    g = dyf * w
    ss, sg = torch.zeros(rows, tpr), torch.zeros(rows, tpr)
    for j in range(lanes.shape[1]):
        cols = lanes[:, j]
        ss = ss + xf[:, cols] ** 2
        sg = sg + g[:, cols] * xf[:, cols]
    ss, sg = butterfly(ss, tpr, min(tpr, 32)), butterfly(sg, tpr, min(tpr, 32))
    ss_row, sg_row = torch.zeros(rows), torch.zeros(rows)
    for warp in range(max(tpr // 32, 1)):
        ss_row, sg_row = ss_row + ss[:, 32 * warp], sg_row + sg[:, 32 * warp]
    rstd = 1.0 / torch.sqrt(ss_row / D + eps)
    coef = rstd * rstd * rstd * (sg_row / D)
    dx = (rstd[:, None] * g - coef[:, None] * xf).to(x.dtype)
    terms = dyf * (xf * rstd[:, None])
    groups = -(-rows // rpb)
    part = torch.zeros(blocks, D)
    for b in range(blocks):
        teams = []
        for t in range(rpb):
            acc = torch.zeros(D)
            for grp in range(b, groups, blocks):
                if grp * rpb + t < rows:
                    acc = acc + terms[grp * rpb + t]
            teams.append(acc)
        total = teams[0]
        for acc in teams[1:]:
            total = total + acc
        part[b] = total
    return dx, column_sum(part)


K_DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def k_inputs(rows, D, dtype, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((rows, D)).astype(np.float32) * 2).to(dtype)
    dy = torch.from_numpy(rng.standard_normal((rows, D)).astype(np.float32)).to(dtype)
    w = torch.from_numpy(rng.uniform(0.5, 1.5, D).astype(np.float32)).to(dtype).float()
    return x, w, dy


# rows that do not divide the block's teams (16 at D 128 bf16, 4 at 2560 bf16, 2 at 2560 fp32), over grids of one
# and of several rounds (sms 1 and 2: the grid is cut from the blocks an SM)
@pytest.mark.parametrize("sms", [1, 2])
@pytest.mark.parametrize("rows", [37, 13])
@pytest.mark.parametrize("dtype_name", list(K_DTYPES))
@pytest.mark.parametrize("D", [128, 2560])
def test_rmsnorm_bwd_lane_model_matches_the_plain_version(D, dtype_name, rows, sms):
    dtype = K_DTYPES[dtype_name]
    x, w, dy = k_inputs(rows, D, dtype, seed=D + rows)
    layout = rmsnorm_vjp.layout(x, dy, w)
    assert layout == norms.row_layout(D, dtype) is not None
    blocks = rmsnorm_vjp.grid_blocks(rows, D, dtype, layout, sms)
    got_dx, got_dw = k_lane_model(x, w, dy, EPS, blocks)
    want_dx, want_dw = rmsnorm_vjp.rmsnorm_bwd_plain(x, w, dy, EPS)
    assert got_dx.dtype == want_dx.dtype == dtype and got_dw.dtype == torch.float32
    check_tol_diff(got_dx.float(), want_dx.float(), **(dict(atol=1e-5, rtol=1e-5) if dtype == torch.float32
                                                       else tols_for(dtype)))
    check_tol_diff(got_dw, want_dw, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype_name", list(K_DTYPES))
@pytest.mark.parametrize("D", [128, 2560])
def test_rmsnorm_bwd_lane_model_matches_pallas_interpret(D, dtype_name):
    """Against JAX's Pallas rmsnorm_vjp in interpret mode, its weight in the rows' dtype, as
    tests/test_torch_train_functions.py runs it; dw's tolerance grows with sqrt(rows)."""
    dtype = K_DTYPES[dtype_name]
    rows = 21
    x, w, dy = k_inputs(rows, D, dtype, seed=D + 7)
    jdt = JAX_DTYPE[dtype]
    jx, jw, jdy = (jnp.asarray(t.float().numpy(), jdt) for t in (x, w, dy))
    _, pull = jax.vjp(lambda a, b: jax_rmsnorm_vjp(a, b, EPS, True), jx, jw)
    want_dx, want_dw = pull(jdy)
    blocks = rmsnorm_vjp.grid_blocks(rows, D, dtype, rmsnorm_vjp.layout(x, dy, w), 1)
    got_dx, got_dw = k_lane_model(x, w, dy, EPS, blocks)
    tol = TOL[dtype_name]
    close(got_dx, want_dx, tol)
    close(got_dw, want_dw, {k: v * rows**0.5 for k, v in tol.items()})


@pytest.mark.parametrize("D, dtype_name, layout", [
    (128, "bf16", (8, 2)), (2560, "bf16", (32, 10)), (5120, "bf16", (64, 10)), (2560, "f32", (64, 10)),
    (128, "f32", (16, 2)), (128, "f16", (8, 2)), (33, "f32", None), (300, "f16", None), (96, "bf16", None),
    (257, "bf16", None), (5120, "f32", None)])
def test_rmsnorm_bwd_layouts_are_norms_row_layouts(D, dtype_name, layout):
    """The register route at A's widths; every other width takes the generic kernels."""
    dtype = A_DTYPES[dtype_name]
    x = torch.zeros(3, D, dtype=dtype)
    assert rmsnorm_vjp.layout(x, torch.zeros_like(x), torch.ones(D)) == norms.row_layout(D, dtype) == layout


@pytest.mark.parametrize("which", ["x", "dy", "weight"])
def test_rmsnorm_bwd_unaligned_views_take_the_generic_kernels(which):
    def tensor(name, shape, dtype):
        n = int(np.prod(shape))
        return torch.zeros(n + 1, dtype=dtype)[int(name == which):][:n].view(shape)

    x, dy = tensor("x", (3, 2560), torch.bfloat16), tensor("dy", (3, 2560), torch.bfloat16)
    assert rmsnorm_vjp.layout(x, dy, tensor("weight", (2560,), torch.float32)) is None


def test_rmsnorm_bwd_layouts_match_the_kernel_source():
    """K's register kernel instantiates the shared header's layouts (norms.ROW_LAYOUTS's pairs) in A's block size,
    and is built to hold the blocks an SM that rmsnorm_vjp.blocks_per_sm counts for its grid."""
    src = (build.CSRC_DIR / "rmsnorm_vjp.cu").read_text()
    assert source_row_layouts() == sorted(norms.ROW_LAYOUTS.values())
    assert '#include "row_regs.cuh"' in src and src.count("MOJO_ROW_LAYOUTS(MOJO_ROW_CASE)") == 2
    assert f"kRegThreads = {norms.ROW_BLOCK_THREADS};" in src
    assert "return values <= 40 ? 4 : 2;" in src
    assert "__launch_bounds__(kRegThreads, reg_min_blocks(VPT * 16 / static_cast<int>(sizeof(T))))" in src
    per = {(8, 2, torch.bfloat16): 4, (16, 2, torch.bfloat16): 4, (32, 10, torch.bfloat16): 2,
           (64, 10, torch.bfloat16): 2, (64, 10, torch.float32): 4, (16, 2, torch.float32): 4}
    for (tpr, vpt, dtype), want in per.items():
        assert rmsnorm_vjp.blocks_per_sm(tpr, vpt, dtype) == want


@pytest.mark.parametrize("shape, dtype, offset, layout, blocks", [
    # the train step's norms on 132 SMs: 1024 groups of 4 rows over 264 resident blocks -> 4 rounds of 256
    ((4096, 2560), torch.bfloat16, 0, (32, 10), 256),
    ((131072, 128), torch.bfloat16, 0, (8, 2), 512), ((32768, 128), torch.bfloat16, 0, (8, 2), 512),
    ((4097, 2560), torch.bfloat16, 0, (32, 10), 257), ((13, 2560), torch.bfloat16, 0, (32, 10), 4),
    ((1, 128), torch.bfloat16, 0, (8, 2), 1), ((5, 5120), torch.bfloat16, 0, (64, 10), 3),
    ((6, 2560), torch.float32, 0, (64, 10), 3),
    # the generic kernels: a block a long row (at most 2 an SM), a warp a short row (8 a block, at most 4 an SM)
    ((4096, 2560), torch.bfloat16, 1, None, 264), ((37, 300), torch.float16, 0, None, 37),
    ((9, 33), torch.float32, 0, None, 2), ((4096, 96), torch.bfloat16, 0, None, 512),
])
def test_rmsnorm_bwd_each_route_reaches_its_launch(monkeypatch, shape, dtype, offset, layout, blocks):
    """Off the CPU the wrapper picks the route from the width, the dtype and the pointers alone, and launches once
    with its layout ((0, 0): the generic kernels) and a grid, the rows of the dw partial buffer, fixed by the
    shape."""
    calls, empties = [], []
    monkeypatch.setattr(build, "launch", lambda name, device, *args: calls.append((name, args)))
    monkeypatch.setattr(rmsnorm_vjp, "launches", rmsnorm_vjp.launches)
    real_empty = torch.empty
    monkeypatch.setattr(rmsnorm_vjp.torch, "empty", lambda *s, **k: empties.append(s) or real_empty(*s, **k))
    n = int(np.prod(shape))
    x = real_empty(n + offset, device="meta", dtype=dtype)[offset:].view(shape)
    dy = real_empty(shape, device="meta", dtype=dtype)
    if offset:  # a meta tensor's storage starts at 0: an element in is unaligned
        assert x.data_ptr() % 16 == x.element_size() * offset
    before = rmsnorm_vjp.launches
    dx, dw = rmsnorm_vjp.rmsnorm_bwd(x, real_empty(shape[-1], device="meta"), dy, EPS)
    assert dx.shape == shape and dx.dtype == dtype and dw.shape == (shape[-1],) and dw.dtype == torch.float32
    ((name, args),) = calls
    assert name == "mojo_rmsnorm_bwd" and args[6:8] == (shape[0], shape[-1]) and args[9] == blocks
    assert args[11:13] == (layout or (0, 0)) and rmsnorm_vjp.launches == before + 1
    assert (blocks, shape[-1]) in empties  # the partial buffer: one row a block
