"""Port parity for kernel N, the fused linear + cross-entropy: the port's
plain kernel-N path (``FlceVJP`` over ``flce_stats_plain`` and
``flce_backward_plain``, which the cuda tier runs on CPU tensors) against
the JAX package's ``flce`` kernel run in interpret mode, as its own test
runs it (tests/accuracy/functions/test_flce_pallas.py), and against JAX's
golden; the dispatch and golden routes of the two cuda-tier loss
functions; the wrappers' plain pieces; and a tiny Qwen3 train step through
the dispatched op against JAX's train step on ``flce``.

The same numpy inputs go through both packages. Tolerances, and why: the
loss to rtol 1e-5 (atol 1e-6) and the gradients to rtol 1e-4 (atol 1e-5),
the bounds JAX's own test holds its kernel to (fp32, sums in another
order); the tiny model's gradients to atol = rtol = 1e-4 (two layers of
fp32 products and softmaxes, as tests/test_torch_training.py holds them);
bf16 inputs to the bf16 ladder of utils/acc.py against the plain path in
fp32 (dz and the products round to bf16).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mojo_opset_tpu.backends.pallas.kernels.flce import flce as jax_flce_kernel
from mojo_opset_tpu.core.functions.loss import fused_linear_cross_entropy as jax_golden
from mojo_opset_tpu.modeling.qwen3 import Qwen3Config as JaxQwen3Config
from mojo_opset_tpu.modeling.qwen3 import Qwen3ForCausalLM as JaxQwen3
from mojo_opset_tpu.utils.hf import state_dict_of
import mojo_opset_tpu_torch as tm
from mojo_opset_tpu_torch.backends.cuda import kernels
from mojo_opset_tpu_torch.backends.cuda.functions import (
    CudaFusedLinearCrossEntropyFunction,
    CudaFusedLinearCrossEntropyLoss,
    FlceVJP,
)
from mojo_opset_tpu_torch.backends.cuda.kernels import flce
from mojo_opset_tpu_torch.modeling.qwen3 import Qwen3Config, Qwen3ForCausalLM
from mojo_opset_tpu_torch.utils.acc import check_tol_diff, tols_for
from mojo_opset_tpu_torch.utils.weights import load_numpy_state

LOSS = dict(atol=1e-6, rtol=1e-5)
GRAD = dict(atol=1e-5, rtol=1e-4)
MODEL_GRAD = dict(atol=1e-4, rtol=1e-4)
N, H, V = 32, 128, 320  # V deliberately not a multiple of the vocab block (JAX's test shape)
# the option matrix of JAX's test (test_flce_pallas.py:37-44)
CONFIGS = [
    dict(),
    dict(reduction="sum"),
    dict(label_smoothing=0.1),
    dict(lse_square_scale=1e-3),
    dict(softcap=5.0),
    dict(label_smoothing=0.05, lse_square_scale=1e-3, softcap=8.0, reduction="sum"),
]
DEFAULTS = dict(ignore_index=-100, lse_square_scale=0.0, label_smoothing=0.0, reduction="mean", softcap=None)
TINY = dict(hidden_size=64, intermediate_size=128, num_attention_heads=4, num_key_value_heads=2,
            num_hidden_layers=2, head_dim=16, vocab_size=128, max_position_embeddings=128)


def _case(seed=0, n=N, h=H, v=V, ignore_frac=0.25):
    """JAX's test inputs (test_flce_pallas.py:29-34), from numpy."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n, h)) * 0.5).astype(np.float32)
    w = (rng.standard_normal((v, h)) * 0.05).astype(np.float32)
    t = rng.integers(0, v, (n,))
    t[rng.random(n) < ignore_frac] = -100
    return x, w, t.astype(np.int32)


def _port(x, w, t, seed_z=0.0, return_z_loss=False, op=None, **opts):
    """The dispatched op on CPU tensors: (loss, z_loss or None, dx, dw);
    asserts that nothing launched and the golden was not taken."""
    op = op or tm.MojoFusedLinearCrossEntropyFunction(return_z_loss=return_z_loss, **opts)
    assert isinstance(op, CudaFusedLinearCrossEntropyFunction)
    xt, wt = torch.from_numpy(x).requires_grad_(True), torch.from_numpy(w).requires_grad_(True)
    kernels.reset_launch_counts()
    before = CudaFusedLinearCrossEntropyFunction.golden_calls
    out = op(xt, wt, torch.from_numpy(t))
    loss, z = out if return_z_loss else (out, None)
    (loss + (seed_z * z if z is not None else 0.0)).backward()
    assert set(kernels.launch_counts().values()) == {0}
    assert CudaFusedLinearCrossEntropyFunction.golden_calls == before
    return loss.detach(), None if z is None else z.detach(), xt.grad, wt.grad


@pytest.mark.parametrize("cfg", CONFIGS, ids=[str(sorted(c)) for c in CONFIGS])
def test_flce_matches_jax_interpret_kernel(cfg):
    """Value, dx and dw against JAX's ``flce`` in interpret mode and
    against jax.value_and_grad of its golden."""
    x, w, t = _case()
    kw = dict(DEFAULTS, **cfg)

    def kernel(x, w):
        return jax_flce_kernel(x, w, jnp.asarray(t), kw["ignore_index"], kw["lse_square_scale"],
                               kw["label_smoothing"], kw["reduction"], kw["softcap"], True)[0]

    def golden(x, w):
        return jax_golden(x, w, jnp.asarray(t), **kw)

    loss, _, dx, dw = _port(x, w, t, **cfg)
    for fn in (kernel, golden):
        want, (want_dx, want_dw) = jax.value_and_grad(fn, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
        check_tol_diff(loss, np.asarray(want), **LOSS)
        check_tol_diff(dx, np.asarray(want_dx), **GRAD)
        check_tol_diff(dw, np.asarray(want_dw), **GRAD)


def test_flce_z_loss_output_matches_jax_interpret_kernel():
    """JAX's z-loss case (test_flce_pallas.py:69-75), and the z-loss output's
    own gradient (the loss plus 0.5 z_loss)."""
    x, w, t = _case(seed=3)
    want, want_z = jax_flce_kernel(jnp.asarray(x), jnp.asarray(w), jnp.asarray(t), -100, 1e-3, 0.0, "mean", None,
                                   True)
    loss, z, dx, dw = _port(x, w, t, seed_z=0.5, return_z_loss=True, lse_square_scale=1e-3)
    check_tol_diff(loss, np.asarray(want), **LOSS)
    check_tol_diff(z, np.asarray(want_z), **LOSS)

    def both(x, w):
        loss, z = jax_flce_kernel(x, w, jnp.asarray(t), -100, 1e-3, 0.0, "mean", None, True)
        return loss + 0.5 * z

    _, (want_dx, want_dw) = jax.value_and_grad(both, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    check_tol_diff(dx, np.asarray(want_dx), **GRAD)
    check_tol_diff(dw, np.asarray(want_dw), **GRAD)


EDGES = {
    "every-row-ignored": dict(n=N, v=V, ignore_frac=1.1),
    "ragged-vocab": dict(n=N, v=200),  # not a multiple of the port's 128-column tile
    "rows-not-multiple-of-8": dict(n=13, v=V),  # JAX's N % 8 gate does not apply to the port
    "one-row": dict(n=1, v=77, ignore_frac=0.0),
}


@pytest.mark.parametrize("edge", sorted(EDGES))
@pytest.mark.parametrize("reduction", ["mean", "sum"])
def test_flce_edges_match_jax_golden(edge, reduction):
    x, w, t = _case(seed=11, **EDGES[edge])
    kw = dict(DEFAULTS, reduction=reduction, label_smoothing=0.1, lse_square_scale=1e-3)
    want, (want_dx, want_dw) = jax.value_and_grad(
        lambda x, w: jax_golden(x, w, jnp.asarray(t), **kw), argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    loss, _, dx, dw = _port(x, w, t, reduction=reduction, label_smoothing=0.1, lse_square_scale=1e-3)
    check_tol_diff(loss, np.asarray(want), **LOSS)
    check_tol_diff(dx, np.asarray(want_dx), **GRAD)
    check_tol_diff(dw, np.asarray(want_dw), **GRAD)
    if edge == "every-row-ignored":
        assert float(loss) == 0.0 and not dx.any() and not dw.any()


def test_flce_loss_module_takes_the_weight_first():
    x, w, t = _case(seed=5)
    op = tm.MojoFusedLinearCrossEntropyLoss(label_smoothing=0.1)
    assert isinstance(op, CudaFusedLinearCrossEntropyLoss)
    before = CudaFusedLinearCrossEntropyLoss.golden_calls
    xt, wt = torch.from_numpy(x).requires_grad_(True), torch.from_numpy(w).requires_grad_(True)
    loss = op(wt, xt, torch.from_numpy(t))
    loss.backward()
    assert CudaFusedLinearCrossEntropyLoss.golden_calls == before
    want, (want_dx, want_dw) = jax.value_and_grad(
        lambda x, w: jax_flce_kernel(x, w, jnp.asarray(t), -100, 0.0, 0.1, "mean", None, True)[0],
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    check_tol_diff(loss.detach(), np.asarray(want), **LOSS)
    check_tol_diff(xt.grad, np.asarray(want_dx), **GRAD)
    check_tol_diff(wt.grad, np.asarray(want_dw), **GRAD)


GOLDEN_ROUTES = {"bias": dict(bias=True), "ce_weight": dict(ce_weight=True), "none": dict(reduction="none")}


@pytest.mark.parametrize("route", sorted(GOLDEN_ROUTES))
@pytest.mark.parametrize("form", ["function", "loss"])
def test_flce_golden_routes_are_counted(route, form):
    """bias, ce_weight and reduction='none' take the golden, as JAX's tier
    does (backends/pallas/functions/loss.py:26-35), and each call adds one
    to golden_calls."""
    x, w, t = _case(seed=7)
    opts = dict(GOLDEN_ROUTES[route])
    rng = np.random.default_rng(8)
    bias = rng.standard_normal(V).astype(np.float32) if opts.pop("bias", False) else None
    ce_weight = (rng.random(V) + 0.5).astype(np.float32) if opts.pop("ce_weight", False) else None
    cls = CudaFusedLinearCrossEntropyFunction if form == "function" else CudaFusedLinearCrossEntropyLoss
    op = (tm.MojoFusedLinearCrossEntropyFunction if form == "function" else tm.MojoFusedLinearCrossEntropyLoss)(
        **opts)
    assert isinstance(op, cls)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    bt = None if bias is None else torch.from_numpy(bias)
    cw = None if ce_weight is None else torch.from_numpy(ce_weight)
    before = cls.golden_calls
    args = (xt, wt) if form == "function" else (wt, xt)
    got = op(*args, torch.from_numpy(t).long(), bt, cw)
    assert cls.golden_calls == before + 1
    want = jax_golden(jnp.asarray(x), jnp.asarray(w), jnp.asarray(t), None if bias is None else jnp.asarray(bias),
                      None if ce_weight is None else jnp.asarray(ce_weight), **opts)
    check_tol_diff(got, np.asarray(want), **LOSS)


def test_flce_saves_no_logits():
    """The Function keeps x, w, target and lse for the backward: nothing of
    (N, V) size."""
    x, w, t = _case(seed=9)
    xt, wt = torch.from_numpy(x).requires_grad_(True), torch.from_numpy(w).requires_grad_(True)
    loss = tm.MojoFusedLinearCrossEntropyFunction()(xt, wt, torch.from_numpy(t))
    shapes = sorted(tuple(s.shape) for s in loss.grad_fn.saved_tensors)
    assert shapes == sorted([(N, H), (V, H), (N,), (N,)]), shapes


def test_flce_plain_pieces_compose():
    """flce_backward equals flce_dx / flce_dw over flce_dz; run_rows cuts
    dz to the byte budget; only dx or only dw when one is needed."""
    x, w, t = (torch.from_numpy(a) for a in _case(seed=13))
    lse, tl, zs = flce.flce_stats(x, w, t, 4.0)
    want_lse, want_tl, want_zs = flce.flce_stats_plain(x, w, t, 4.0)
    assert torch.equal(lse, want_lse) and torch.equal(tl, want_tl) and torch.equal(zs, want_zs)
    assert not tl[t < 0].any()
    a, c = flce.backward_coefficients(torch.tensor(1.0), torch.tensor(0.0), lse, t, -100, 1e-3, "mean")
    dz = flce.flce_dz(x, w, t, lse, a, c, 4.0, 0.1)
    assert dz.shape == (N, V) and not dz[t < 0].any()
    dx, dw = flce.flce_backward(x, w, t, lse, a, c, 4.0, 0.1)
    assert torch.equal(dx, flce.flce_dx(dz, w)) and torch.equal(dw, flce.flce_dw(dz, x))
    assert flce.flce_backward(x, w, t, lse, a, c, 4.0, 0.1, need_dx=False)[0] is None
    assert flce.flce_backward(x, w, t, lse, a, c, 4.0, 0.1, need_dw=False)[1] is None
    assert flce.run_rows(4096, 151936, 2, flce.DZ_BUDGET_BYTES) == 4096
    assert flce.run_rows(4096, 151936, 2, 2**28) == 2**28 // (151936 * 2)
    assert flce.run_rows(4096, 151937, 2, 1) == 1
    assert set(kernels.launch_counts().values()) == {0}


def test_flce_out_of_vocab_targets_get_no_target_term():
    """A target >= V is out of contract: no target logit, no one-hot term."""
    x, w, t = (torch.from_numpy(a) for a in _case(seed=15, ignore_frac=0.0))
    t[3] = V + 5
    lse, tl, _ = flce.flce_stats(x, w, t)
    assert tl[3] == 0
    a, c = flce.backward_coefficients(torch.tensor(1.0), torch.tensor(0.0), lse, t, -100, 0.0, "sum")
    dz = flce.flce_dz(x, w, t, lse, a, c)
    check_tol_diff(dz[3], torch.softmax(x[3] @ w.T, 0), **GRAD)


def test_flce_bf16_inputs_keep_their_dtype():
    x, w, t = _case(seed=7)
    xb, wb = torch.from_numpy(x).bfloat16().requires_grad_(True), torch.from_numpy(w).bfloat16().requires_grad_(True)
    loss = tm.MojoFusedLinearCrossEntropyFunction()(xb, wb, torch.from_numpy(t))
    loss.backward()
    assert loss.dtype == torch.float32 and xb.grad.dtype == torch.bfloat16 and wb.grad.dtype == torch.bfloat16
    want, (want_dx, want_dw) = jax.value_and_grad(
        lambda x, w: jax_flce_kernel(x, w, jnp.asarray(t), -100, 0.0, 0.0, "mean", None, True)[0],
        argnums=(0, 1))(jnp.asarray(xb.detach().float().numpy()), jnp.asarray(wb.detach().float().numpy()))
    check_tol_diff(loss.detach(), np.asarray(want), **LOSS)
    check_tol_diff(xb.grad, np.asarray(want_dx), **tols_for(torch.bfloat16))
    check_tol_diff(wb.grad, np.asarray(want_dw), **tols_for(torch.bfloat16))


def test_flce_kernel_wrappers_check_their_inputs():
    x, w, t = (torch.from_numpy(a) for a in _case(seed=17))
    with pytest.raises(ValueError, match="softcap"):
        flce.flce_stats(x, w, t, softcap=-1.0)
    with pytest.raises(ValueError, match="share H"):
        flce.flce_stats(x, w[:, :64], t)
    with pytest.raises(RuntimeError, match="forward-only"):
        flce.flce_stats(x.requires_grad_(True), w, t)


@pytest.fixture(scope="module")
def tiny_pair():
    jax_model = JaxQwen3(JaxQwen3Config(**TINY, dtype=jnp.float32), key=jax.random.PRNGKey(7))
    port = Qwen3ForCausalLM(Qwen3Config(**TINY, dtype=torch.float32), device="cpu")
    load_numpy_state(port, state_dict_of(jax_model))
    return jax_model, port


@pytest.mark.parametrize("cfg", [dict(), dict(label_smoothing=0.1, lse_square_scale=1e-3)],
                         ids=["plain", "smoothing-z-loss"])
def test_train_step_on_the_dispatched_loss_matches_jax(tiny_pair, cfg):
    """train_forward + MojoFusedLinearCrossEntropyFunction (the cuda tier,
    kernel N's plain path on CPU tensors): the loss and every parameter's
    gradient, by name, against jax.value_and_grad of the JAX train step on
    ``flce`` in interpret mode. The lm_head is tied: its gradient adds
    into the embedding's."""
    jax_model, port = tiny_pair
    ids = np.random.default_rng(0).integers(1, TINY["vocab_size"], (2, 9)).astype(np.int32)
    inputs, targets = ids[:, :-1], ids[:, 1:].reshape(-1).copy()
    targets[::5] = -100
    kw = dict(DEFAULTS, **cfg)

    def jax_loss(model):
        hidden = model.train_forward(jnp.asarray(inputs))
        return jax_flce_kernel(hidden.reshape(-1, TINY["hidden_size"]), model.lm_head_weight, jnp.asarray(targets),
                               kw["ignore_index"], kw["lse_square_scale"], kw["label_smoothing"], kw["reduction"],
                               kw["softcap"], True)[0]

    want, jax_grads = jax.value_and_grad(jax_loss)(jax_model)
    want_grads = {k: v for k, v in state_dict_of(jax_grads).items() if not k.endswith("inv_freq")}
    port.zero_grad(set_to_none=True)
    port.requires_grad_(True)
    try:
        kernels.reset_launch_counts()
        op = tm.MojoFusedLinearCrossEntropyFunction(**cfg)
        assert isinstance(op, CudaFusedLinearCrossEntropyFunction)
        hidden = port.train_forward(torch.from_numpy(inputs))
        loss = op(hidden.reshape(-1, TINY["hidden_size"]), port.lm_head_weight, torch.from_numpy(targets))
        assert isinstance(loss.grad_fn, FlceVJP._backward_cls)
        loss.backward()
        assert set(kernels.launch_counts().values()) == {0}
        check_tol_diff(loss.detach(), np.asarray(want), **LOSS)
        grads = {name: p.grad for name, p in port.named_parameters()}
        assert set(grads) == set(want_grads)
        for name, g in grads.items():
            assert g is not None, name
            check_tol_diff(g, want_grads[name], **MODEL_GRAD)
    finally:
        port.requires_grad_(False)
        port.zero_grad(set_to_none=True)
