"""Port parity for the normalization ops of slice E: ``MojoGroupRMSNorm``,
``MojoLayerNormQuant`` and the residual-add family
(``MojoResidualAdd{RMS,Layer}Norm``, ``MojoResidualAdd{RMS,Layer}NormQuant``)
of mojo_opset_tpu_torch against mojo_opset_tpu, on the CPU; and kernel P
(``residual_add_rmsnorm``): its plain version against the JAX package's
Pallas kernel in interpret mode, and ``CudaResidualAddRMSNorm`` on CPU
tensors (the plain version) against JAX's golden.

The same numpy inputs and weights (carried across with ``load_numpy_state``
from ``state_dict_of``) go through both packages. Tolerances, as in
``tests/test_torch_train_functions.py``: fp32 2e-5 (one algorithm, sums in
another order), bf16 2e-2 and fp16 4e-3 (each side rounds once to the
working type from fp32, at different places). The int8 quant outputs may
part by one step where a sum in another order moves a value across a
rounding tie: at most one step on at most 1% of the values.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mojo_opset_tpu.core.operators as jo
from mojo_opset_tpu.backends.pallas.kernels.norms import residual_add_rmsnorm as jax_residual_add_rmsnorm
from mojo_opset_tpu.utils.hf import state_dict_of
import mojo_opset_tpu_torch as tm
from mojo_opset_tpu_torch.backends.cuda import kernels
from mojo_opset_tpu_torch.backends.cuda.kernels import norms
from mojo_opset_tpu_torch.utils.acc import check_tol_diff
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
