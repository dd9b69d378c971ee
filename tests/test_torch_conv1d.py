"""Port parity for the causal conv1d of slice E: the golden
(``causal_conv1d``, ``MojoCausalConv1dUpdateState``), kernel Q's plain
versions and ``MojoCausalConv1dFunction``'s tiers of mojo_opset_tpu_torch
against mojo_opset_tpu, on the CPU.

The same numpy inputs go through the JAX package's ``conv1d_train`` (its
Pallas kernel pair in interpret mode, as its own tests run it) and its
golden under ``jax.vjp``; and through the port's ref tier (autograd of the
golden) and its cuda tier, which on CPU tensors runs the
``torch.autograd.Function`` over Q's plain versions (the backward written
out, not autograd). JAX's seven-case matrix
(``tests/accuracy/functions/test_conv_silu_vjp_pallas.py:32-48``) covers W
1, 3, 4 and 8, a chunk shorter than the window, odd T, no bias, a state and
``swish``. Tolerances, as in ``tests/test_torch_train_functions.py``: fp32
2e-5, bf16 2e-2 (each side rounds once to the working type from fp32, at
different places); dw and db sum over B x T rows, so theirs grow with
sqrt(B x T).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mojo_opset_tpu.backends.pallas.kernels.conv1d_vjp import conv1d_train
from mojo_opset_tpu.core.functions.convolution import MojoCausalConv1dFunction as JaxConv1dFunction
from mojo_opset_tpu.core.operators.convolution import MojoCausalConv1dUpdateState as JaxUpdateState
from mojo_opset_tpu.core.operators.convolution import causal_conv1d as jax_causal_conv1d
import mojo_opset_tpu_torch as tm
from mojo_opset_tpu_torch.backends.cuda import build, kernels
from mojo_opset_tpu_torch.backends.cuda.functions.convolution import CudaCausalConv1dFunction, state_grad
from mojo_opset_tpu_torch.backends.cuda.kernels import conv1d_vjp
from mojo_opset_tpu_torch.benchmark import conv1d_window_ab
from mojo_opset_tpu_torch.utils.acc import check_tol_diff

TOL = {jnp.float32: dict(atol=2e-5, rtol=2e-5), jnp.bfloat16: dict(atol=2e-2, rtol=2e-2)}
TORCH = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}

# (B, T, D, W, bias, residual, state, act, dtype): JAX's matrix
CASES = [
    pytest.param(2, 64, 128, 4, True, False, False, "silu", jnp.float32, id="basic-silu"),
    pytest.param(1, 200, 256, 4, True, True, False, None, jnp.float32, id="odd-T-residual"),
    pytest.param(2, 48, 128, 3, False, False, True, "silu", jnp.float32, id="state-nobias-w3"),
    pytest.param(2, 64, 128, 4, True, True, True, "swish", jnp.bfloat16, id="bf16-everything"),
    pytest.param(1, 5, 128, 4, True, False, True, None, jnp.float32, id="chunk-shorter-than-window"),
    pytest.param(2, 96, 128, 8, True, False, True, "silu", jnp.float32, id="wide-window-w8"),
    pytest.param(2, 64, 128, 1, True, False, False, "silu", jnp.float32, id="w1-pointwise"),
]
NAMES = "x w b r s".split()


def to_torch(a, dtype) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def close(got: torch.Tensor, want, tol) -> None:
    check_tol_diff(got.detach().float(), np.asarray(jnp.asarray(want, jnp.float32)), **tol)


@functools.lru_cache(maxsize=None)
def _case(B, T, D, W, bias, residual, state, act, dtype):
    """The inputs (x, w, b, r, s, do; None where the case has none), as
    JAX's test draws them."""
    rng = np.random.default_rng(hash((B, T, D, W, act)) % 2**31)
    x = jnp.asarray(rng.standard_normal((B, T, D)), dtype)
    w = jnp.asarray(rng.standard_normal((D, W)) * 0.5, dtype)
    b = jnp.asarray(rng.standard_normal((D,)) * 0.1, dtype) if bias else None
    r = jnp.asarray(rng.standard_normal((B, T, D)), dtype) if residual else None
    s = jnp.asarray(rng.standard_normal((B, D, W - 1)), dtype) if state and W > 1 else None
    do = jnp.asarray(rng.standard_normal((B, T, D)), dtype)
    return x, w, b, r, s, do


@functools.lru_cache(maxsize=None)
def _jax_results(case):
    """{source: (out, final_state, grads of the given inputs)} for JAX's
    Pallas tier (interpret mode) and its golden, the final state's
    cotangent zero as in JAX's test."""
    x, w, b, r, s, do = _case(*case)
    act = case[7]
    results = {}
    for tier in ("pallas", "ref"):
        fn = JaxConv1dFunction.get_backend_impl(tier, strict=tier != "ref")()
        given = [a for a in (x, w, b, r, s) if a is not None]

        def f(*args):
            it = iter(args)
            full = [next(it) if a is not None else None for a in (x, w, b, r, s)]
            return fn(*full, True, act, None)

        (out, fin), pull = jax.vjp(f, *given)
        results[tier] = (out, fin, pull((do.astype(out.dtype), jnp.zeros_like(fin))))
    return results


def _run_port(tier, case):
    """The port's tier on the case: out, final state and the gradients of
    the given inputs, with no kernel launch (CPU tensors)."""
    x, w, b, r, s, do = _case(*case)
    tdt = TORCH[case[8]]
    leaves = [None if a is None else to_torch(a, tdt).requires_grad_(True) for a in (x, w, b, r, s)]
    fn = tm.MojoCausalConv1dFunction.get_backend_impl(tier, strict=True)()
    assert type(fn).__name__ == ("Ref" if tier == "ref" else "Cuda") + "CausalConv1dFunction"
    kernels.reset_launch_counts()
    with torch.enable_grad():
        out, fin = fn(*leaves, True, case[7], None)
        out.backward(to_torch(do, tdt))
    assert set(kernels.launch_counts().values()) == {0}
    return out, fin, [leaf.grad for leaf in leaves if leaf is not None], [leaf for leaf in leaves if leaf is not None]


@pytest.mark.parametrize("tier", ["ref", "cuda"])
@pytest.mark.parametrize("B,T,D,W,bias,residual,state,act,dtype", CASES)
def test_conv1d_function_matches_jax(B, T, D, W, bias, residual, state, act, dtype, tier):
    """Value, final state and every gradient (dx, dw, db, dresidual, dstate)
    against JAX's interpret-mode kernel pair and its golden."""
    case = (B, T, D, W, bias, residual, state, act, dtype)
    out, fin, grads, leaves = _run_port(tier, case)
    names = [n for n, a in zip(NAMES, _case(*case)[:5]) if a is not None]
    tol = TOL[dtype]
    big = {k: v * (B * T) ** 0.5 for k, v in tol.items()}
    for source, (j_out, j_fin, j_grads) in _jax_results(case).items():
        close(out, j_out, tol)
        close(fin, j_fin, tol)
        for name, got, want, leaf in zip(names, grads, j_grads, leaves):
            assert got.dtype == leaf.dtype and got.shape == leaf.shape, name
            close(got, want, big if name in "wb" else tol)


@pytest.mark.parametrize("B,T,D,W,bias,residual,state,act,dtype", CASES)
def test_conv1d_plain_kernels_match_conv1d_train(B, T, D, W, bias, residual, state, act, dtype):
    """Q's plain forward and backward (and the dstate sliver computed beside
    them) against ``jax.vjp`` of the TPU kernel pair in interpret mode, on
    the kernel's own contract: state rows (B, W-1, D) in x's dtype, the
    residual left out."""
    x, w, b, _, s, do = _case(B, T, D, W, bias, residual, state, act, dtype)
    state_rows = jnp.zeros((B, W - 1, D), dtype) if s is None else jnp.swapaxes(s, 1, 2)
    out, pull = jax.vjp(lambda x, w, b, st: conv1d_train(x, w, b, st, act is not None, True), x, w, b, state_rows)
    jdx, jdw, jdb, jds = pull(do)
    tdt = TORCH[dtype]
    tx, tw, ts, tg = to_torch(x, tdt), to_torch(w, torch.float32), to_torch(state_rows, tdt), to_torch(do, tdt)
    tb = None if b is None else to_torch(b, torch.float32)
    tol = TOL[dtype]
    big = {k: v * (B * T) ** 0.5 for k, v in tol.items()}
    fwd = conv1d_vjp.conv1d_fwd_plain(tx, tw, tb, ts, act is not None)
    assert fwd.dtype == tdt
    close(fwd, out, tol)
    dx, dw, db = conv1d_vjp.conv1d_bwd_plain(tx, tw, tb, ts, tg, act is not None)
    assert dx.dtype == tdt and dw.dtype == db.dtype == torch.float32 and dw.shape == (W, D)
    close(dx, jdx, tol)
    close(dw.t(), jdw, big)
    if b is not None:
        close(db, jdb, big)
    close(state_grad(tx, tw, tb, ts, tg, act is not None), jds, tol)
    # the dispatching wrappers take the plain versions on CPU tensors
    kernels.reset_launch_counts()
    assert torch.equal(conv1d_vjp.conv1d_fwd(tx, tw, tb, ts, act is not None), fwd)
    assert all(torch.equal(p, q) for p, q in zip(conv1d_vjp.conv1d_bwd(tx, tw, tb, ts, tg, act is not None),
                                                 (dx, dw, db)))
    assert set(kernels.launch_counts().values()) == {0}


@pytest.mark.parametrize("output_final_state", [True, False])
@pytest.mark.parametrize("tier", ["ref", "cuda"])
def test_conv1d_function_varlen_matches_jax(tier, output_final_state):
    """``cu_seqlens``: each packed sequence alone, each with its own state
    row; the cuda tier takes the golden and counts it."""
    rng = np.random.default_rng(3)
    D, W = 16, 3
    x = rng.standard_normal((1, 9, D)).astype(np.float32)
    w = (rng.standard_normal((D, W)) * 0.5).astype(np.float32)
    b = (rng.standard_normal(D) * 0.1).astype(np.float32)
    s = rng.standard_normal((2, D, W - 1)).astype(np.float32)
    r = rng.standard_normal((1, 9, D)).astype(np.float32)
    cu = np.array([0, 5, 9], np.int32)
    jfn = JaxConv1dFunction.get_backend_impl("ref")()
    j_out, j_fin = jfn(*map(jnp.asarray, (x, w, b, r, s)), output_final_state, "silu", jnp.asarray(cu))
    fn = tm.MojoCausalConv1dFunction.get_backend_impl(tier)()
    before = CudaCausalConv1dFunction.golden_calls
    out, fin = fn(*map(torch.from_numpy, (x, w, b, r, s)), output_final_state, "silu", torch.from_numpy(cu))
    assert CudaCausalConv1dFunction.golden_calls - before == (tier == "cuda")
    close(out, j_out, TOL[jnp.float32])
    if output_final_state:
        close(fin, j_fin, TOL[jnp.float32])
    else:
        assert fin is None and j_fin is None
    whole, _ = fn(*map(torch.from_numpy, (x[:, :5], w, b, r[:, :5], s[:1])), False, "silu")
    check_tol_diff(out[:, :5], whole, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("with_state,T,W,act", [(True, 10, 4, "silu"), (False, 7, 3, None), (True, 2, 4, "swish"),
                                                 (True, 6, 1, None)])
def test_causal_conv1d_golden_matches_jax(with_state, T, W, act, dtype):
    """The golden's value and final state; a chunk shorter than W-1 carries
    the older history into the final state."""
    rng = np.random.default_rng(T * 10 + W)
    D = 12
    x = jnp.asarray(rng.standard_normal((2, T, D)), dtype)
    w = jnp.asarray(rng.standard_normal((D, W)) * 0.5, dtype)
    b = jnp.asarray(rng.standard_normal(D) * 0.1, dtype)
    s = jnp.asarray(rng.standard_normal((2, D, W - 1)), dtype) if with_state else None
    j_out, j_fin = jax_causal_conv1d(x, w, b, s, True, act)
    tdt = TORCH[dtype]
    out, fin = tm.causal_conv1d(to_torch(x, tdt), to_torch(w, tdt), to_torch(b, tdt),
                                None if s is None else to_torch(s, tdt), True, act)
    assert out.dtype == fin.dtype == tdt and fin.shape == (2, D, W - 1)
    close(out, j_out, TOL[dtype])
    close(fin, j_fin, TOL[dtype])
    if with_state and T < W - 1:  # the older history survives
        close(fin[..., :W - 1 - T], s[..., T:], TOL[dtype])


def test_causal_conv1d_refuses_other_activations():
    with pytest.raises(NotImplementedError, match="activation"):
        tm.causal_conv1d(torch.zeros(1, 4, 2), torch.zeros(2, 3), activation="gelu")
    with pytest.raises(NotImplementedError, match="activation"):
        tm.MojoCausalConv1dFunction()(torch.zeros(1, 4, 2), torch.zeros(2, 3), activation="gelu")


@pytest.mark.parametrize("act", [None, "silu"])
def test_update_state_matches_jax_and_streams(act):
    """UpdateState against JAX's op (the conv in the weight's dtype, the new
    state in the state's), and two chunks streamed through it equal the
    one-shot golden (JAX ``tests/accuracy/functions/test_functions.py:89``)."""
    rng = np.random.default_rng(11)
    B, D, W, T = 2, 4, 4, 10
    w = rng.standard_normal((D, W)).astype(np.float32)
    b = rng.standard_normal(D).astype(np.float32)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    op = tm.MojoCausalConv1dUpdateState()
    jop = JaxUpdateState.get_backend_impl("ref")()
    xt = np.swapaxes(x, 1, 2)
    state, jstate = torch.zeros(B, D, W - 1), jnp.zeros((B, D, W - 1))
    outs = []
    for lo, hi in ((0, 6), (6, T)):
        o, state = op(torch.from_numpy(xt[:, :, lo:hi].copy()), state, torch.from_numpy(w), torch.from_numpy(b), act)
        jo_, jstate = jop(jnp.asarray(xt[:, :, lo:hi]), jstate, jnp.asarray(w), jnp.asarray(b), act)
        close(o, jo_, TOL[jnp.float32])
        close(state, jstate, TOL[jnp.float32])
        outs.append(o)
    full, _ = tm.causal_conv1d(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b), activation=act)
    check_tol_diff(torch.cat(outs, -1).transpose(1, 2), full, atol=1e-5, rtol=1e-5)
    # the state's dtype is kept; the conv runs in the weight's
    o, st = op(torch.ones(1, D, 3, dtype=torch.bfloat16), torch.zeros(1, D, W - 1, dtype=torch.float16),
               torch.from_numpy(w), None, act)
    assert o.dtype == torch.bfloat16 and st.dtype == torch.float16


def test_conv1d_wrappers_refuse_what_the_kernel_does_not_take():
    x, s = torch.zeros(1, 4, 8), torch.zeros(1, 3, 8)
    with pytest.raises(ValueError, match="W <= 16"):
        conv1d_vjp.conv1d_fwd(x, torch.zeros(8, 17), None, torch.zeros(1, 16, 8), True)
    with pytest.raises(ValueError, match="float32"):
        conv1d_vjp.conv1d_fwd(x, torch.zeros(8, 4, dtype=torch.bfloat16), None, s, True)
    with pytest.raises(ValueError, match="state must be"):
        conv1d_vjp.conv1d_fwd(x, torch.zeros(8, 4), None, torch.zeros(1, 8, 3), True)
    with pytest.raises(ValueError, match="g must match x"):
        conv1d_vjp.conv1d_bwd(x, torch.zeros(8, 4), None, s, torch.zeros(1, 4, 8, dtype=torch.float16), True)
    with pytest.raises(ValueError, match=r"\(B, T, D\)"):
        tm.MojoCausalConv1dFunction.get_backend_impl("cuda")()(torch.zeros(4, 8), torch.zeros(8, 4))


def test_window_ab_build_disables_both_narrow_branches():
    """The A/B script's wide build runs the MAXW = 16 instantiation at every W:
    both entry points' W <= 4 branches are switched off, and nothing else."""
    narrow = (build.CSRC_DIR / "conv1d.cu").read_text()
    wide = conv1d_window_ab.wide_source()
    assert conv1d_window_ab.NARROW_BRANCH not in wide and wide.count("if (false) {") == 2
    assert wide.replace("if (false) {", conv1d_window_ab.NARROW_BRANCH) == narrow
