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
sqrt(B x T). Kernel Q's unit map: a model of its launch plan (chunks of
time rows walked by slots, halo rows from x or the state, dz recomputed
past each chunk) gives every row its out, dx and dw/db term exactly once,
and the conv computed through it equals the plain versions (fp32 1e-5) and
JAX's ``conv1d_train`` in interpret mode; each route reaches its launch.
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
from mojo_opset_tpu_torch.benchmark import conv1d_window_ab, kernel_resources
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


def test_kernel_resources_harness_reports_each_named_instantiation(tmp_path):
    """The resource tool's program includes the source and reports each spec's kernel at its threads, dynamic
    shared bytes and grid, in order (the parent's kernels were read with it before the redesign)."""
    specs = ["conv1d_fwd_kernel<__nv_bfloat16, 4, 8>:128:0:2048", "conv1d_bwd_kernel<__nv_bfloat16, 4, 4>:128:0:1024"]
    text = kernel_resources.harness(build.CSRC_DIR / "conv1d.cu", specs)
    assert text.startswith('#include "conv1d.cu"')
    calls = [line.strip() for line in text.splitlines() if line.strip().startswith('report("')]
    assert calls == ['report("conv1d_fwd_kernel<__nv_bfloat16, 4, 8>", conv1d_fwd_kernel<__nv_bfloat16, 4, 8>, 128, 0, '
                     '2048);',
                     'report("conv1d_bwd_kernel<__nv_bfloat16, 4, 4>", conv1d_bwd_kernel<__nv_bfloat16, 4, 4>, 128, 0, '
                     '1024);']


def test_window_ab_build_disables_both_narrow_branches():
    """The A/B script's wide build runs the MAXW = 16 instantiation at every W:
    both entry points' W <= 4 branches are switched off, and nothing else."""
    narrow = (build.CSRC_DIR / "conv1d.cu").read_text()
    wide = conv1d_window_ab.wide_source()
    assert conv1d_window_ab.NARROW_BRANCH not in wide and wide.count("if (false) {") == 2
    assert wide.replace("if (false) {", conv1d_window_ab.NARROW_BRANCH) == narrow


# ---------------------------------------------------------------- kernel Q's unit map


def q_units(B, T, chunk, slots):
    """(slot, sequence, t0, t_own) of each unit, in the order each slot walks them: slot s takes chunks s, s +
    slots, ... of ``chunk`` rows over all sequences."""
    n_chunks = -(-T // chunk)
    return [(sl, q // n_chunks, (q % n_chunks) * chunk, min((q % n_chunks + 1) * chunk, T))
            for sl in range(slots) for q in range(sl, B * n_chunks, slots)]


def q_column_sum(part):
    """common.cuh's column sum: slice s of 32 adds rows s, s + 32, ... in order, then the slices in order."""
    slices = torch.zeros(32, part.shape[1])
    for r in range(part.shape[0]):
        slices[r % 32] = slices[r % 32] + part[r]
    total = torch.zeros(part.shape[1])
    for sl in slices:
        total = total + sl
    return total


def q_model(x, w, b, state, g, act, fwd_plan, bwd_plan):
    """Q's forward and backward computed unit by unit as the kernels walk them, in fp32: each unit reads its rows
    of the stream [state ++ x] (its W-1 halo rows first), the backward recomputes dz up to W-1 rows past its chunk
    for dx, and adds the dw and db terms of its own rows into its slot's partial row, in row order; dw and db are
    the column sum of the slots' rows. Asserts that every (sequence, row) gets its out, its dx and its dw/db term
    exactly once and that no read leaves the stream."""
    B, T, D = x.shape
    W = w.shape[1]
    k = w.float()
    bias = torch.zeros(D) if b is None else b.float()
    stream = torch.cat([state.float(), x.float()], 1)  # stream row u at index u + W - 1

    def row(bb, u):
        assert -(W - 1) <= u < T, (u, T, W)
        return stream[bb, u + W - 1]

    def z_at(bb, t):
        z = bias
        for i in range(W):
            z = z + row(bb, t - (W - 1) + i) * k[:, i]
        return z

    out, seen = torch.zeros(B, T, D), torch.zeros(B, T, dtype=torch.int64)
    chunk, _, slots = fwd_plan
    for _, bb, t0, t_end in q_units(B, T, chunk, slots):
        for t in range(t0, t_end):
            z = z_at(bb, t)
            out[bb, t] = z * torch.sigmoid(z) if act else z
            seen[bb, t] += 1
    assert bool((seen == 1).all())

    chunk, _, slots = bwd_plan
    dx, dx_seen, term_seen = torch.zeros(B, T, D), torch.zeros_like(seen), torch.zeros_like(seen)
    part = torch.zeros(slots, W + 1, D)
    for sl, bb, t0, t_own in q_units(B, T, chunk, slots):
        dz = {}
        for tp in range(t0, min(t_own + W - 1, T)):
            gv = g[bb, tp].float()
            if act:
                z = z_at(bb, tp)
                sig = torch.sigmoid(z)
                gv = gv * (sig * (1 + z * (1 - sig)))
            dz[tp] = gv
        for tp in range(t0, t_own):
            for i in range(W):
                part[sl, i] = part[sl, i] + dz[tp] * row(bb, tp - (W - 1) + i)
            part[sl, W] = part[sl, W] + dz[tp]
            term_seen[bb, tp] += 1
        for j in range(t0, t_own):
            d = torch.zeros(D)
            for i in range(W):
                d = d + dz.get(j + W - 1 - i, torch.zeros(D)) * k[:, i]
            dx[bb, j] = d
            dx_seen[bb, j] += 1
    assert bool((dx_seen == 1).all()) and bool((term_seen == 1).all())
    dwb = q_column_sum(part.reshape(slots, -1)).reshape(W + 1, D)
    return out.to(x.dtype), dx.to(x.dtype), dwb[:W], dwb[W]


def q_inputs(B, T, D, W, dtype, seed, bias=True):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((B, T, D)).astype(np.float32)).to(dtype)
    g = torch.from_numpy(rng.standard_normal((B, T, D)).astype(np.float32)).to(dtype)
    w = torch.from_numpy((rng.standard_normal((D, W)) * 0.4).astype(np.float32))
    b = torch.from_numpy((rng.standard_normal(D) * 0.1).astype(np.float32)) if bias else None
    state = torch.from_numpy(rng.standard_normal((B, W - 1, D)).astype(np.float32)).to(dtype)
    return x, w, b, state, g


def q_plans(B, T, D, W, sms):
    return (conv1d_vjp.plan(B, T, D, W, 4, False, sms), conv1d_vjp.plan(B, T, D, W, 4, True, sms))


# T 1, 5, 130 and 777 are no multiples of the chunk; sms 1 gives several rounds a slot, 132 the card's plan
@pytest.mark.parametrize("sms", [1, 132])
@pytest.mark.parametrize("W", [1, 2, 3, 4, 16])
@pytest.mark.parametrize("T", [1, 5, 130, 777])
def test_conv1d_unit_map_covers_every_row_once_and_matches_the_plain_versions(T, W, sms):
    B, D = 2, 12
    x, w, b, state, g = q_inputs(B, T, D, W, torch.float32, seed=T * 17 + W)
    out, dx, dw, db = q_model(x, w, b, state, g, True, *q_plans(B, T, D, W, sms))
    tol = dict(atol=1e-5, rtol=1e-5)
    big = {k: v * (B * T) ** 0.5 for k, v in tol.items()}  # dw and db sum B x T terms in another order
    check_tol_diff(out, conv1d_vjp.conv1d_fwd_plain(x, w, b, state, True), **tol)
    want_dx, want_dw, want_db = conv1d_vjp.conv1d_bwd_plain(x, w, b, state, g, True)
    check_tol_diff(dx, want_dx, **tol)
    check_tol_diff(dw, want_dw, **big)
    check_tol_diff(db, want_db, **big)


@pytest.mark.parametrize("act", [True, False])
@pytest.mark.parametrize("W", [1, 2, 3, 4])
@pytest.mark.parametrize("T", [5, 130])
def test_conv1d_unit_map_matches_conv1d_train(T, W, act):
    """The conv through the unit map against jax.vjp of the TPU kernel pair in interpret mode, as
    test_conv1d_plain_kernels_match_conv1d_train holds the plain versions; dw and db to sqrt(B x T) x fp32."""
    B, D = 2, 16
    x, w, b, state, g = q_inputs(B, T, D, W, torch.float32, seed=T + W)
    j = lambda t: jnp.asarray(t.numpy())  # noqa: E731
    jout, pull = jax.vjp(lambda xx, ww, bb, st: conv1d_train(xx, ww, bb, st, act, True), j(x), j(w), j(b), j(state))
    jdx, jdw, jdb, _ = pull(j(g))
    out, dx, dw, db = q_model(x, w, b, state, g, act, *q_plans(B, T, D, W, 1))
    tol = TOL[jnp.float32]
    big = {key: v * (B * T) ** 0.5 for key, v in tol.items()}
    close(out, jout, tol)
    close(dx, jdx, tol)
    close(dw.t(), jdw, big)
    close(db, jdb, big)


@pytest.mark.parametrize("W, route", [(1, "exact"), (2, "exact"), (3, "exact"), (4, "exact"), (5, "generic"),
                                      (8, "generic"), (16, "generic")])
def test_conv1d_routes_follow_the_width(W, route):
    """W <= 4 takes the exact-width kernels, W 5-16 the generic ones; the source instantiates the exact widths
    under the W <= 4 branches that benchmark/conv1d_window_ab.py switches off, with the launch bounds that
    conv1d_vjp.blocks_per_sm counts."""
    assert conv1d_vjp.route(W) == route
    src = (build.CSRC_DIR / "conv1d.cu").read_text()
    assert f"kExactMaxW = {conv1d_vjp.EXACT_MAX_W};" in src and f"kMaxW = {conv1d_vjp.MAX_W};" in src
    assert f"kRing = {conv1d_vjp.RING};" in src and f"kExactThreads = {conv1d_vjp.THREADS};" in src
    assert f"kPrefetch = {bool(conv1d_vjp.PREFETCH)}".lower() in src.lower()
    assert all(f"case {n}: fn(ExactTag<{n}, V, kRing, kExactThreads, kPrefetch>{{}}); return true;" in src
               for n in range(1, 5))
    assert "return (BWD ? 256 : 512) / threads;" in src
    assert [conv1d_vjp.blocks_per_sm(bwd, 128) for bwd in (False, True)] == [4, 2]


@pytest.mark.parametrize("shape, W, dtype, offset, want_fwd, want_bwd", [
    # (chunk, slots) of the conv Function's shape and the perf descriptor's, on 132 SMs: 2 channel groups of 1024
    ((8, 8192, 2048), 4, torch.bfloat16, 0, (256, 256), (256, 128)),
    ((8, 2048, 2048), 4, torch.bfloat16, 0, (64, 256), (128, 128)),
    ((8, 8192, 2048), 2, torch.bfloat16, 0, (256, 256), (256, 128)),
    ((8, 257, 2048), 3, torch.float16, 0, (32, 72), (32, 72)),
    ((8, 8192, 2048), 4, torch.bfloat16, 1, (256, 32), (256, 16)),  # unaligned: a channel a thread, 16 groups
    ((2, 777, 72), 16, torch.bfloat16, 0, (256, 1), (256, 8)),  # generic: W in 16 slots
])
def test_conv1d_each_route_reaches_its_launch(monkeypatch, shape, W, dtype, offset, want_fwd, want_bwd):
    """Off the CPU each wrapper launches once with the plan its shapes give (chunk, slots, and the ring and block
    size of the exact route); the backward's partial buffer has one row a slot."""
    calls, empties = [], []
    monkeypatch.setattr(build, "launch", lambda name, device, *args: calls.append((name, args)))
    monkeypatch.setattr(conv1d_vjp, "launches", 0)
    monkeypatch.setattr(conv1d_vjp, "launches_bwd", 0)
    real_empty = torch.empty
    monkeypatch.setattr(conv1d_vjp.torch, "empty", lambda *s, **k: empties.append(s) or real_empty(*s, **k))
    B, T, D = shape
    n = B * T * D
    x = real_empty(n + offset, device="meta", dtype=dtype)[offset:].view(shape)
    g = real_empty(shape, device="meta", dtype=dtype)
    w, b = real_empty(D, W, device="meta"), real_empty(D, device="meta")
    st = real_empty(B, W - 1, D, device="meta", dtype=dtype)
    out = conv1d_vjp.conv1d_fwd(x, w, b, st, True)
    dx, dw, db = conv1d_vjp.conv1d_bwd(x, w, b, st, g, True)
    assert out.shape == dx.shape == shape and dw.shape == (W, D) and db.shape == (D,)
    (fname, fargs), (bname, bargs) = calls
    vec = int(not offset)
    exact = conv1d_vjp.RING, conv1d_vjp.THREADS, conv1d_vjp.PREFETCH
    assert fname == "mojo_conv1d_fwd" and fargs[5:16] == (B, T, D, W, 1, vec, *want_fwd, *exact)
    assert bname == "mojo_conv1d_bwd" and bargs[8:19] == (B, T, D, W, 1, vec, *want_bwd, *exact)
    assert (want_bwd[1], W + 1, D) in empties
    assert conv1d_vjp.launches == 1 and conv1d_vjp.launches_bwd == 1
