"""Port parity for the training Functions of norms, SiLU and RoPE:
``MojoRMSNormFunction``, ``MojoSiluFunction`` and ``MojoApplyRoPEFunction``
of mojo_opset_tpu_torch against mojo_opset_tpu, on the CPU, and
``CudaApplyRoPE``'s head-first route.

The same numpy inputs go through the JAX package's Pallas kernels in
interpret mode (``rmsnorm_vjp``, ``silu_vjp``, ``rope_train``,
``rope_head_first``), as its own tests run them, and its golden Functions;
and through the port's golden tier (autograd of the plain math) and its
cuda tier, which on CPU tensors runs the ``torch.autograd.Function`` over
kernel A's, K's, L's and M's plain versions (K's and L's backward written
out, not autograd). Values and every gradient are compared at the JAX
tests' shapes and dtypes with their tolerances, and why: fp32 2e-5 (one
fp32 algorithm, sums in another order), bf16 2e-2 and fp16 4e-3 (each side
rounds once to the working type from fp32, at different places); RMSNorm's
dw sums over the rows, so its tolerance grows with sqrt(rows), as in
``tests/accuracy/functions/test_rmsnorm_vjp_pallas.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mojo_opset_tpu.backends.pallas.kernels.rmsnorm_vjp import rmsnorm_vjp
from mojo_opset_tpu.backends.pallas.kernels.rope import rope_head_first as jax_rope_head_first
from mojo_opset_tpu.backends.pallas.kernels.rope import rope_train
from mojo_opset_tpu.backends.pallas.kernels.silu_vjp import silu_vjp
from mojo_opset_tpu.core.functions.activation import MojoSiluFunction as JaxSiluFunction
from mojo_opset_tpu.core.functions.normalization import MojoRMSNormFunction as JaxRMSNormFunction
from mojo_opset_tpu.core.functions.position_embedding import MojoApplyRoPEFunction as JaxRoPEFunction
import mojo_opset_tpu_torch as tm
from mojo_opset_tpu_torch.backends.cuda import kernels
from mojo_opset_tpu_torch.backends.cuda.kernels import rmsnorm_vjp as port_rmsnorm_vjp
from mojo_opset_tpu_torch.backends.cuda.kernels import rope_head_first as port_rope
from mojo_opset_tpu_torch.backends.cuda.kernels import silu_vjp as port_silu
from mojo_opset_tpu_torch.utils.acc import check_tol_diff

EPS = 1e-6
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16),
          "f16": (jnp.float16, torch.float16)}
TOL = {"f32": dict(atol=2e-5, rtol=2e-5), "bf16": dict(atol=2e-2, rtol=2e-2), "f16": dict(atol=4e-3, rtol=4e-3)}
TIERS = ["ref", "cuda"]


def to_torch(a: jax.Array, dtype: torch.dtype) -> torch.Tensor:
    """A JAX array as a torch tensor of ``dtype`` (exact: both sides hold the same rounded values)."""
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def close(got: torch.Tensor, want, tol) -> None:
    check_tol_diff(got.detach(), np.asarray(jnp.asarray(want, jnp.float32)), **tol)


def port_function(core, tier, *args):
    fn = core.get_backend_impl(tier, strict=True)(*args)
    assert type(fn).__name__ == ("Ref" if tier == "ref" else "Cuda") + core.__name__[4:]
    return fn


def run_port(fn, inputs, grads, *args, **kwargs):
    """Value(s) of ``fn(*inputs)`` and the gradients of ``inputs`` for the
    output gradient(s) ``grads``; no kernel launches (CPU tensors)."""
    leaves = [t.clone().requires_grad_(True) for t in inputs]
    kernels.reset_launch_counts()
    with torch.enable_grad():
        out = fn(*leaves, *args, **kwargs)
        outs = out if isinstance(out, tuple) else (out,)
        torch.autograd.backward(outs, grads)
    assert set(kernels.launch_counts().values()) == {0}
    return outs, [t.grad for t in leaves]


# ---------------------------------------------------------------- RMSNorm


@functools.lru_cache(maxsize=None)
def _rmsnorm_case(shape, dtype_name):
    """Inputs and the JAX results: (x, w, dy) and {source: (y, dx, dw)} for
    the interpret-mode kernel pair and the golden Function."""
    jdt = DTYPES[dtype_name][0]
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal(shape), jdt)
    w = jnp.asarray(rng.uniform(0.5, 1.5, shape[-1:]), jdt)  # the weight in x's dtype, as JAX's test draws it
    dy = jnp.asarray(rng.standard_normal(shape), jdt)
    golden = JaxRMSNormFunction.get_backend_impl("ref")(eps=EPS)
    want = {}
    for source, f in (("pallas-interpret", lambda x, w: rmsnorm_vjp(x, w, EPS, True)), ("golden", golden)):
        y, pull = jax.vjp(f, x, w)
        want[source] = (y, *pull(dy.astype(y.dtype)))
    return (x, w, dy), want


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("dtype_name", ["f32", "bf16", "f16"])
@pytest.mark.parametrize("shape", [(32, 256), (4, 7, 128), (48, 1024)], ids=str)
def test_rmsnorm_function_matches_jax(shape, dtype_name, tier):
    (x, w, dy), want = _rmsnorm_case(shape, dtype_name)
    tdt = DTYPES[dtype_name][1]
    fn = port_function(tm.MojoRMSNormFunction, tier, EPS)
    (y,), (dx, dw) = run_port(fn, [to_torch(x, tdt), to_torch(w, tdt)], [to_torch(dy, tdt)])
    assert y.dtype == dx.dtype == dw.dtype == tdt
    tol = TOL[dtype_name]
    rows = int(np.prod(shape[:-1]))
    dw_tol = {k: v * rows**0.5 for k, v in tol.items()}
    for source, (y_j, dx_j, dw_j) in want.items():
        close(y, y_j, tol)
        close(dx, dx_j, tol)
        close(dw, dw_j, dw_tol)


def test_rmsnorm_function_takes_an_fp32_weight_with_bf16_rows():
    """The training path's case: bf16 rows, an fp32 weight; dw comes back fp32."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((6, 128)).astype(np.float32)).to(torch.bfloat16)
    w = torch.from_numpy(rng.uniform(0.5, 1.5, 128).astype(np.float32))
    dy = torch.from_numpy(rng.standard_normal((6, 128)).astype(np.float32)).to(torch.bfloat16)
    results = [run_port(port_function(tm.MojoRMSNormFunction, t, EPS), [x, w], [dy]) for t in TIERS]
    (y_r,), (dx_r, dw_r) = results[0]
    (y_c,), (dx_c, dw_c) = results[1]
    assert y_c.dtype == dx_c.dtype == torch.bfloat16 and dw_c.dtype == torch.float32
    check_tol_diff(y_c, y_r, **TOL["bf16"])
    check_tol_diff(dx_c, dx_r, **TOL["bf16"])
    check_tol_diff(dw_c, dw_r, atol=1e-5, rtol=1e-5)


def test_rmsnorm_bwd_plain_is_the_written_out_formula():
    """K's plain version against autograd of the fp32 golden, in fp64 terms."""
    rng = np.random.default_rng(2)
    x, dy = (torch.from_numpy(rng.standard_normal((9, 40))) for _ in range(2))
    w = torch.from_numpy(rng.uniform(0.5, 1.5, 40))
    dx, dw = port_rmsnorm_vjp.rmsnorm_bwd_plain(x.float(), w.float(), dy.float(), EPS)
    xr, wr = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    (xr * torch.rsqrt(xr.square().mean(-1, keepdim=True) + EPS) * wr).backward(dy)
    check_tol_diff(dx, xr.grad, atol=1e-5, rtol=1e-5)
    check_tol_diff(dw, wr.grad, atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------- SiLU


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("shape,dtype_name", [((2, 64, 128), "f32"), ((4, 8, 256), "bf16"), ((16, 384), "f32"),
                                              ((4, 100), "f32")], ids=str)
def test_silu_function_matches_jax(shape, dtype_name, tier):
    """(4, 100) is lane-unaligned: JAX's Pallas tier sends it to the golden
    (``test_conv_silu_vjp_pallas.py:126``), the port's cuda tier runs it,
    and here it is also held to the interpret-mode kernel."""
    jdt, tdt = DTYPES[dtype_name]
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal(shape), jdt)
    do = jnp.asarray(rng.standard_normal(shape), jdt)
    fn = port_function(tm.MojoSiluFunction, tier)
    (y,), (dx,) = run_port(fn, [to_torch(x, tdt)], [to_torch(do, tdt)])
    assert y.dtype == dx.dtype == tdt
    golden = JaxSiluFunction.get_backend_impl("ref")()
    for f in (lambda x: silu_vjp(x, True), golden):
        y_j, pull = jax.vjp(f, x)
        close(y, y_j, TOL[dtype_name])
        close(dx, pull(do.astype(y_j.dtype))[0], TOL[dtype_name])


def test_silu_bwd_plain_is_the_written_out_formula():
    x = torch.linspace(-30.0, 30.0, 301, dtype=torch.float64)
    dy = torch.cos(x)
    xr = x.clone().requires_grad_(True)
    torch.nn.functional.silu(xr).backward(dy)
    check_tol_diff(port_silu.silu_bwd_plain(x.float(), dy.float()), xr.grad, atol=1e-6, rtol=1e-5)


# ---------------------------------------------------------------- RoPE


def _rope_tables(S, D):
    inv = 1.0 / 10000 ** (np.arange(0, D, 2) / D)
    ang = np.arange(S)[:, None] * inv[None, :]
    cos = np.concatenate([np.cos(ang)] * 2, -1).astype(np.float32)
    sin = np.concatenate([np.sin(ang)] * 2, -1).astype(np.float32)
    return cos, sin


@functools.lru_cache(maxsize=None)
def _rope_case(dtype_name, B=2, Hq=4, Hk=2, S=64, D=128):
    """Head-first inputs with fp32 tables, as JAX's test builds them, and
    {source: (q_rot, k_rot, dq, dk)} from ``rope_train`` in interpret mode
    and the golden Function."""
    jdt = DTYPES[dtype_name][0]
    rng = np.random.default_rng(0)
    q = jnp.asarray(rng.standard_normal((B, Hq, S, D)), jdt)
    k = jnp.asarray(rng.standard_normal((B, Hk, S, D)), jdt)
    cos, sin = (jnp.asarray(t) for t in _rope_tables(S, D))
    gq = jnp.asarray(rng.standard_normal((B, Hq, S, D)), jdt)
    gk = jnp.asarray(rng.standard_normal((B, Hk, S, D)), jdt)
    golden = JaxRoPEFunction.get_backend_impl("ref")()
    want = {}
    for source, f in (("pallas-interpret", lambda q, k: rope_train(q, k, cos, sin, True)),
                      ("golden", lambda q, k: golden(q, k, cos, sin))):
        (zq, zk), pull = jax.vjp(f, q, k)
        want[source] = (zq, zk, *pull((gq.astype(zq.dtype), gk.astype(zk.dtype))))
    return (q, k, cos, sin, gq, gk), want


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("layout", ["head-first", "token-first view"])
@pytest.mark.parametrize("dtype_name", ["f32", "bf16", "f16"])
def test_rope_function_matches_jax(dtype_name, layout, tier):
    """Head-first (B, H, S, D), and the same tensors token-first: (B, S, H, D)
    with ``head_first=False``, the training forward's layout, which the
    cuda tier gives kernel M as a transposed view and gets back
    token-first. cos and sin get no gradient on either tier."""
    (q, k, cos, sin, gq, gk), want = _rope_case(dtype_name)
    tdt = DTYPES[dtype_name][1]
    inputs = [to_torch(t, tdt) for t in (q, k)]
    grads = [to_torch(t, tdt) for t in (gq, gk)]
    head_first = layout == "head-first"
    if not head_first:
        inputs = [t.transpose(1, 2).contiguous() for t in inputs]
        grads = [t.transpose(1, 2).contiguous() for t in grads]
    tables = [torch.from_numpy(np.array(t)).requires_grad_(True) for t in (cos, sin)]
    fn = port_function(tm.MojoApplyRoPEFunction, tier)
    (zq, zk), (dq, dk) = run_port(fn, inputs, grads, *tables, head_first=head_first)
    assert all(t.grad is None for t in tables)
    if not head_first:
        assert zq.is_contiguous() and zk.is_contiguous() and dq.is_contiguous()  # token-first, no copy on the way
        zq, zk, dq, dk = (t.transpose(1, 2) for t in (zq, zk, dq, dk))
    assert zq.dtype == dq.dtype == tdt
    for source, outs in want.items():
        for got, w in zip((zq, zk, dq, dk), outs):
            close(got, w, TOL[dtype_name])


def test_rope_function_refuses_mixed_dtypes():
    q, k = torch.zeros(1, 2, 4, 8), torch.zeros(1, 2, 4, 8, dtype=torch.bfloat16)
    cos = sin = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="share one dtype"):
        tm.MojoApplyRoPEFunction.get_backend_impl("cuda")()(q, k, cos, sin)


@pytest.mark.parametrize("shape", [(2, 4, 64, 128), (4, 9, 64)], ids=["B,H,S,D", "H,T,D"])
def test_cuda_apply_rope_head_first_runs_kernel_m(shape):
    """``CudaApplyRoPE`` sends head-first to kernel M (here its plain version,
    launching nothing), against JAX's ``rope_head_first`` in interpret mode
    and the golden op; partial-rope tables take the golden, counted in
    ``CudaApplyRoPE.golden_calls``, as JAX's Pallas tier takes its golden."""
    rng = np.random.default_rng(3)
    S, D = shape[-2:]
    q = rng.standard_normal(shape).astype(np.float32)
    k = rng.standard_normal(shape[:-3] + (2,) + shape[-2:]).astype(np.float32)
    cos, sin = _rope_tables(S, D)
    op = tm.MojoApplyRoPE.get_backend_impl("cuda")()
    kernels.reset_launch_counts()
    got = op(*map(torch.from_numpy, (q, k, cos, sin)), head_first=True)
    assert set(kernels.launch_counts().values()) == {0}
    q4, k4 = (a if a.ndim == 4 else a[None] for a in (q, k))
    want = [jax_rope_head_first(jnp.asarray(a), jnp.asarray(cos), jnp.asarray(sin), True) for a in (q4, k4)]
    if q.ndim == 3:
        want = [w[0] for w in want]
    for g, w in zip(got, want):
        close(g, w, TOL["f32"])
    partial = [torch.from_numpy(a) for a in (q, k, cos[:, : D // 2], sin[:, : D // 2])]
    before = type(op).golden_calls
    got = op(*partial, head_first=True)
    assert type(op).golden_calls == before + 1
    for g, w in zip(got, tm.MojoApplyRoPE.get_backend_impl("ref")()(*partial, head_first=True)):
        close(g, w, TOL["f32"])


def test_rope_head_first_plain_keeps_strides_and_negates_sin():
    """M's plain version on a strided view returns that view's layout; with
    ``negate_sin`` it inverts the forward (for tables whose halves agree)."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((2, 16, 3, 32)).astype(np.float32))  # (B, S, H, D)
    cos, sin = map(torch.from_numpy, _rope_tables(16, 32))
    qv, kv = x.transpose(1, 2), x[:, :, :2].transpose(1, 2)
    q_out, k_out = port_rope.rope_head_first(qv, kv, cos, sin)
    assert q_out.stride() == qv.stride()
    back, _ = port_rope.rope_head_first(q_out, k_out, cos, sin, negate_sin=True)
    check_tol_diff(back, qv, atol=1e-5, rtol=1e-5)


def test_functions_dispatch_to_the_cuda_tier_by_default():
    assert type(tm.MojoRMSNormFunction()).__name__ == "CudaRMSNormFunction"
    assert type(tm.MojoSiluFunction()).__name__ == "CudaSiluFunction"
    assert type(tm.MojoApplyRoPEFunction()).__name__ == "CudaApplyRoPEFunction"
