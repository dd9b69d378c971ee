"""Port parity for the training path: the fused linear + CE loss golden,
``MojoFunction.value_and_grad`` and Qwen3's ``train_forward`` of
mojo_opset_tpu_torch against mojo_opset_tpu, on the CPU; a memorization
run on ``torch.optim.AdamW``; and the refusals (quantized models do not
train, forward-only kernels refuse inputs that need a gradient).

The same numpy inputs go through both packages. A tiny fp32 Qwen3 (2
layers, hidden 64, 4/2 heads, head_dim 16, vocab 128) is built in JAX and
its weights go across through ``state_dict_of`` -> ``load_numpy_state``;
JAX's gradients are named by ``state_dict_of`` of the gradient pytree, so
every parameter's gradient is compared by name.

Tolerances, and why: the loss to atol = rtol = 1e-5 (fp32, sums in
another order); gradients to atol = rtol = 1e-4 for the model (two layers
of fp32 products and softmaxes, the attention backward recomputed from
lse) and 1e-5 for the loss alone.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mojo_opset_tpu.core.functions.attention import MojoSWAFunction as JaxSWAFunction
from mojo_opset_tpu.core.functions.loss import fused_linear_cross_entropy as jax_flce
from mojo_opset_tpu.modeling.qwen3 import Qwen3Config as JaxQwen3Config
from mojo_opset_tpu.modeling.qwen3 import Qwen3ForCausalLM as JaxQwen3
from mojo_opset_tpu.utils.hf import state_dict_of
import mojo_opset_tpu_torch as tm
from mojo_opset_tpu_torch.backends.cuda import kernels
from mojo_opset_tpu_torch.backends.cuda.kernels import (
    group_gemm,
    int4_matmul,
    int8_matmul,
    mla_decode,
    norms,
    paged_decode,
    paged_prefill,
    rmsnorm_quant,
    rmsnorm_vjp,
    rope,
    rope_head_first,
    silu_vjp,
)
from mojo_opset_tpu_torch.modeling.qwen3 import Qwen3Config, Qwen3ForCausalLM, quantize_qwen3
from mojo_opset_tpu_torch.utils.acc import check_tol_diff
from mojo_opset_tpu_torch.utils.weights import load_numpy_state

F32 = dict(atol=1e-5, rtol=1e-5)
MODEL_GRAD = dict(atol=1e-4, rtol=1e-4)
TINY = dict(hidden_size=64, intermediate_size=128, num_attention_heads=4, num_key_value_heads=2,
            num_hidden_layers=2, head_dim=16, vocab_size=128, max_position_embeddings=128)


def randn(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


N, H, V = 23, 16, 40
LOSS_CASES = {  # fused_linear_cross_entropy options
    "mean": dict(),
    "sum": dict(reduction="sum"),
    "none": dict(reduction="none"),
    "ignore-index": dict(ignore_index=3),
    "label-smoothing": dict(label_smoothing=0.1),
    "z-loss": dict(lse_square_scale=1e-2, return_z_loss=True),
    "softcap": dict(softcap=2.0),
    "ce-weight-bias": dict(ce_weight=True, bias=True),
    "chunked-mean": dict(chunk_size=5),
    "chunked-sum-all-options": dict(chunk_size=7, reduction="sum", ignore_index=3, label_smoothing=0.2,
                                    lse_square_scale=1e-2, softcap=3.0, ce_weight=True, bias=True,
                                    return_z_loss=True),
    "chunked-mean-z-weights": dict(chunk_size=6, lse_square_scale=1e-2, ce_weight=True, return_z_loss=True,
                                   ignore_index=3),
}


@pytest.mark.parametrize("name", LOSS_CASES)
def test_fused_linear_cross_entropy_matches_jax(name):
    """Value (and z-loss) and the gradients of input, weight and bias."""
    opts = dict(LOSS_CASES[name])
    x, w = randn(1, (N, H)), randn(2, (V, H), 0.3)
    target = np.random.default_rng(3).integers(0, V, N).astype(np.int32)
    target[::4] = 3  # rows the ignore_index cases drop
    bias = randn(4, (V,)) if opts.pop("bias", False) else None
    ce_weight = np.random.default_rng(5).random(V).astype(np.float32) + 0.5 if opts.pop("ce_weight", False) else None
    z = opts.get("return_z_loss", False)
    seed_out = randn(6, (N,)) if opts.get("reduction") == "none" else None

    def scalar(loss, as_array):  # a "none" loss is reduced by fixed weights, so its gradient is not uniform
        return loss.sum() if seed_out is None else (loss * as_array(seed_out)).sum()

    def jax_loss(x, w, b):
        out = jax_flce(x, w, jnp.asarray(target), b, None if ce_weight is None else jnp.asarray(ce_weight), **opts)
        loss, zl = out if z else (out, 0.0)
        return scalar(loss, jnp.asarray) + (zl * 0.5 if z else 0.0), (loss, zl)

    jb = None if bias is None else jnp.asarray(bias)
    (_, (want, want_z)), want_grads = jax.value_and_grad(jax_loss, argnums=(0, 1, 2) if jb is not None else (0, 1),
                                                         has_aux=True)(jnp.asarray(x), jnp.asarray(w), jb)
    xt, wt = torch.from_numpy(x).requires_grad_(True), torch.from_numpy(w).requires_grad_(True)
    bt = None if bias is None else torch.from_numpy(bias).requires_grad_(True)
    fn = tm.MojoFusedLinearCrossEntropyFunction(**opts)
    out = fn(xt, wt, torch.from_numpy(target).long(), bt, None if ce_weight is None else torch.from_numpy(ce_weight))
    loss, zl = out if z else (out, 0.0)
    leaves = [xt, wt] + ([bt] if bt is not None else [])
    grads = torch.autograd.grad(scalar(loss, torch.from_numpy) + (zl * 0.5 if z else 0.0), leaves)
    check_tol_diff(loss.detach(), np.asarray(want), **F32)
    if z:
        check_tol_diff(zl.detach(), np.asarray(want_z), **F32)
    for got, ref in zip(grads, want_grads):
        check_tol_diff(got, np.asarray(ref), **F32)


def test_loss_module_form_takes_the_weight_first():
    x, w = randn(7, (N, H)), randn(8, (V, H), 0.3)
    target = torch.from_numpy(np.random.default_rng(9).integers(0, V, N))
    a = tm.MojoFusedLinearCrossEntropyLoss(chunk_size=8)(torch.from_numpy(w), torch.from_numpy(x), target)
    b = tm.MojoFusedLinearCrossEntropyFunction(chunk_size=8)(torch.from_numpy(x), torch.from_numpy(w), target)
    assert torch.equal(a, b)
    with pytest.raises(NotImplementedError, match="mean/sum"):
        tm.fused_linear_cross_entropy(torch.from_numpy(x), torch.from_numpy(w), target, reduction="none",
                                      chunk_size=8)


def test_value_and_grad_matches_jax():
    """MojoFunction.value_and_grad: the summed output and its gradients."""
    q, k, v = randn(11, (20, 4, 16)), randn(12, (20, 2, 16)), randn(13, (20, 2, 16))
    cu = np.array([0, 12, 20], np.int32)
    jfn = JaxSWAFunction.get_backend_impl("ref")(local_window_size=4)
    want_v, want_g = jfn.value_and_grad(*(jnp.asarray(x) for x in (q, k, v, cu, cu)), argnums=(0, 2))
    fn = tm.MojoSWAFunction(local_window_size=4)
    got_v, got_g = fn.value_and_grad(*(torch.from_numpy(x) for x in (q, k, v, cu, cu)), argnums=(0, 2))
    check_tol_diff(got_v, np.asarray(want_v), atol=1e-4, rtol=1e-5)
    for got, ref in zip(got_g, want_g):
        check_tol_diff(got, np.asarray(ref), **F32)
    _, g = fn.value_and_grad(*(torch.from_numpy(x) for x in (q, k, v, cu, cu)))
    assert isinstance(g, torch.Tensor) and g.shape == q.shape


@pytest.fixture(scope="module")
def tiny_pair():
    jax_model = JaxQwen3(JaxQwen3Config(**TINY, dtype=jnp.float32), key=jax.random.PRNGKey(7))
    port = Qwen3ForCausalLM(Qwen3Config(**TINY, dtype=torch.float32), device="cpu")
    load_numpy_state(port, state_dict_of(jax_model))
    return jax_model, port


@pytest.mark.parametrize("chunk_size", [None, 10], ids=["full", "chunked"])
def test_train_forward_loss_and_every_gradient_match_jax(tiny_pair, chunk_size):
    """train_forward + the loss: the loss and every parameter's gradient,
    by name, against jax.value_and_grad of the JAX model's train step."""
    jax_model, port = tiny_pair
    ids = np.random.default_rng(0).integers(1, TINY["vocab_size"], (2, 9)).astype(np.int32)
    inputs, targets = ids[:, :-1], ids[:, 1:].reshape(-1)

    def jax_loss(model):
        hidden = model.train_forward(jnp.asarray(inputs))
        return jax_flce(hidden.reshape(-1, TINY["hidden_size"]), model.lm_head_weight, jnp.asarray(targets),
                        chunk_size=chunk_size)

    want, jax_grads = jax.value_and_grad(jax_loss)(jax_model)
    want_grads = {k: v for k, v in state_dict_of(jax_grads).items() if not k.endswith("inv_freq")}

    port.zero_grad(set_to_none=True)
    port.requires_grad_(True)
    try:
        kernels.reset_launch_counts()
        hidden = port.train_forward(torch.from_numpy(inputs))
        assert hidden.shape == (2, 8, TINY["hidden_size"])
        loss = tm.fused_linear_cross_entropy(hidden.reshape(-1, TINY["hidden_size"]), port.lm_head_weight,
                                             torch.from_numpy(targets).long(), chunk_size=chunk_size)
        loss.backward()
        assert set(kernels.launch_counts().values()) == {0}  # CPU tensors: the plain versions
        check_tol_diff(loss.detach(), np.asarray(want), **F32)
        grads = {name: p.grad for name, p in port.named_parameters()}
        assert set(grads) == set(want_grads)
        for name, g in grads.items():
            assert g is not None, name
            check_tol_diff(g, want_grads[name], **MODEL_GRAD)
    finally:
        port.requires_grad_(False)
        port.zero_grad(set_to_none=True)


def test_memorization_halves_the_loss():
    """A port of tests/models/test_training.py on torch.optim.AdamW: 30
    steps on one batch halve the loss."""
    cfg = Qwen3Config(hidden_size=32, intermediate_size=64, num_attention_heads=2, num_key_value_heads=2,
                      num_hidden_layers=2, head_dim=16, vocab_size=64, max_position_embeddings=32,
                      dtype=torch.float32)
    model = Qwen3ForCausalLM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    model.requires_grad_(True)
    opt = torch.optim.AdamW(model.parameters(), lr=3e-3)
    ids = torch.from_numpy(np.random.default_rng(1).integers(1, 64, (2, 9)))
    inputs, targets = ids[:, :-1], ids[:, 1:].reshape(-1)
    losses = []
    for _ in range(30):
        opt.zero_grad(set_to_none=True)
        hidden = model.train_forward(inputs)
        loss = tm.fused_linear_cross_entropy(hidden.reshape(-1, 32), model.lm_head_weight, targets)
        loss.backward()
        opt.step()
        losses.append(loss.item())
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 0.5, f"loss did not halve: {losses[0]:.3f} -> {losses[-1]:.3f}"


def test_quantized_models_do_not_train():
    model = Qwen3ForCausalLM(Qwen3Config(**TINY, dtype=torch.float32), device="cpu")
    with pytest.raises(NotImplementedError, match="inference-only"):
        quantize_qwen3(model).train_forward(torch.ones(1, 4, dtype=torch.long))


def _kernel_calls(x):
    """One call of each kernel wrapper but J's (A-I and the training kernels
    K, L and M, which their autograd Functions call) with ``x`` among its
    inputs."""
    t = lambda *shape: torch.zeros(shape)  # noqa: E731
    i8 = lambda *shape: torch.zeros(shape, dtype=torch.int8)  # noqa: E731
    lens, table = torch.tensor([3], dtype=torch.int32), torch.tensor([[0]], dtype=torch.int32)
    cu = torch.tensor([0, 3], dtype=torch.int32)
    yield "rmsnorm", lambda: norms.rmsnorm(x(3, 64), t(64), 1e-6)
    yield "rope_token_first", lambda: rope.rope_token_first(x(3, 4, 64), t(3, 2, 64), t(3, 64), t(3, 64))
    yield "paged_decode_gqa", lambda: paged_decode.paged_decode_gqa(x(1, 4, 64), t(1, 2, 4, 64), t(1, 2, 4, 64),
                                                                     lens, table)
    yield "paged_prefill_gqa", lambda: paged_prefill.paged_prefill_gqa(x(3, 4, 64), t(1, 2, 4, 64), t(1, 2, 4, 64),
                                                                        cu, table)
    yield "rmsnorm_quant", lambda: rmsnorm_quant.rmsnorm_quant(x(3, 64), t(64), 1e-6)
    yield "int8_scaled_matmul", lambda: int8_matmul.int8_scaled_matmul(i8(3, 64), i8(32, 64), x(3, 1), t(32), True,
                                                                        torch.float32)
    yield "int4_scaled_matmul", lambda: int4_matmul.int4_scaled_matmul(i8(3, 64), i8(64, 64), x(3, 1), t(128),
                                                                        torch.float32)
    yield "grouped_matmul", lambda: group_gemm.grouped_matmul(x(4, 64), t(2, 16, 64), torch.tensor(
        [1, 3], dtype=torch.int32), True)
    yield "mla_decode_absorbed", lambda: mla_decode.mla_decode_absorbed(x(1, 4, 32), t(1, 4, 16), t(1, 1, 4, 32),
                                                                        t(1, 1, 4, 16), lens, table)
    yield "rmsnorm_bwd", lambda: rmsnorm_vjp.rmsnorm_bwd(x(3, 64), t(64), t(3, 64), 1e-6)
    yield "silu_fwd", lambda: silu_vjp.silu_fwd(x(3, 64))
    yield "silu_bwd", lambda: silu_vjp.silu_bwd(x(3, 64), t(3, 64))
    yield "rope_head_first", lambda: rope_head_first.rope_head_first(x(1, 4, 3, 64), t(1, 2, 3, 64), t(3, 64),
                                                                     t(3, 64))


@pytest.mark.parametrize("case", list(_kernel_calls(lambda *shape: torch.zeros(shape))),
                         ids=lambda case: case[0] if isinstance(case, tuple) else str(case))
def test_forward_only_kernels_refuse_inputs_that_need_grad(case):
    """Kernels A-I, K, L and M launch through ctypes and record no autograd graph: with
    grad mode on, an input that requires grad raises, on the CPU as on the
    card (the check comes before the device branch). Without grad mode, or
    without such an input, the call runs."""
    name, _ = case
    needs_grad = dict(_kernel_calls(lambda *shape: torch.zeros(shape, requires_grad=True)))[name]
    with pytest.raises(RuntimeError, match=f"{name} is a forward-only kernel"):
        needs_grad()
    with torch.no_grad():
        needs_grad()
    dict(_kernel_calls(lambda *shape: torch.zeros(shape)))[name]()


def test_trainable_model_serves_in_inference_mode_and_refuses_grad_mode():
    """A model whose parameters were turned trainable still serves through
    the runtime, which runs in inference mode; called directly with grad
    mode on, its kernel-tier ops raise instead of dropping the gradients."""
    from mojo_opset_tpu_torch.runtime import PagedAttentionGenerationModel

    model = Qwen3ForCausalLM(Qwen3Config(**TINY, dtype=torch.float32), device="cpu")
    model.requires_grad_(True)
    gm = PagedAttentionGenerationModel(model, block_size=16)
    logits, session = gm(np.arange(1, 6, dtype=np.int32), context_input_len=np.array([5], np.int32))
    assert torch.isfinite(logits).all()
    ids, pos, meta = session.prepare_prefill_inputs(np.arange(6, 9, dtype=np.int32), np.array([3], np.int32))
    with pytest.raises(RuntimeError, match="forward-only kernel"):
        model(ids, pos, meta, session.caches)
