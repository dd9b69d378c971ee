"""Port parity for the Wan2.2 DiT: ``WanModel`` of mojo_opset_tpu_torch
against mojo_opset_tpu's, on the CPU.

A tiny fp32 model of each variant (t2v, ti2v) is built by JAX, its weights
carried over with ``state_dict_of`` -> ``load_numpy_state``, and the same
numpy latents, timesteps and text go through both: a batch whose clips fill
``seq_len`` (no mask: J's path), the two-grid batch of
``tests/models/test_wan22.py:41-52``, and a ragged batch whose key-padding
mask takes ``CudaSdpa``'s masked route (kernel O's plain version here).
``WanSelfAttention`` is held to JAX's on the padded-key case of
``tests/models/test_wan22.py:116``.

Tolerances, and why: atol = rtol = 1e-5 in fp32 (the same algorithm, sums
in another order; the model's outputs are O(1)).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mojo_opset_tpu.benchmark.dit_protocol import dit_step_flops as jax_dit_step_flops
from mojo_opset_tpu.modeling.wan2_2 import WanConfig as JaxWanConfig
from mojo_opset_tpu.modeling.wan2_2 import WanModel as JaxWanModel
from mojo_opset_tpu.modeling.wan2_2 import modeling_wan as jax_wan
from mojo_opset_tpu.utils.hf import state_dict_of
from mojo_opset_tpu_torch.backends.cuda.operators import CudaSdpa
from mojo_opset_tpu_torch.benchmark.dit_protocol import PerfDiTRunner, denoise_step, dit_step_flops
from mojo_opset_tpu_torch.modeling.wan2_2 import WanConfig, WanModel, WanSelfAttention, modeling_wan
from mojo_opset_tpu_torch.utils.acc import check_tol_diff
from mojo_opset_tpu_torch.utils.weights import load_numpy_state

F32 = dict(atol=1e-5, rtol=1e-5)
TINY = dict(patch_size=(1, 2, 2), text_len=8, in_dim=4, dim=32, ffn_dim=64, freq_dim=16, text_dim=24, out_dim=4,
            num_heads=2, num_layers=2)
# (latent shapes, context rows, timesteps, seq_len)
BATCHES = {
    "uniform": ([(4, 2, 8, 8)], [6], [500.0], 32),
    "two-grids": ([(4, 2, 8, 8), (4, 2, 8, 8)], [5, 5], [10.0, 700.0], 32),
    "ragged": ([(4, 2, 8, 8), (4, 1, 8, 6)], [5, 3], [10.0, 700.0], 32),
}


def pair(model_type):
    jax_model = JaxWanModel(JaxWanConfig(model_type=model_type, **TINY), key=jax.random.PRNGKey(0))
    model = WanModel(WanConfig(model_type=model_type, **TINY), device="cpu")
    load_numpy_state(model, state_dict_of(jax_model))
    return jax_model, model


def batch_inputs(name):
    shapes, ctx_rows, t, seq_len = BATCHES[name]
    rng = np.random.default_rng(len(name))
    x = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    ctx = [rng.standard_normal((n, TINY["text_dim"])).astype(np.float32) for n in ctx_rows]
    return x, ctx, np.asarray(t, np.float32), seq_len


@pytest.mark.parametrize("name", BATCHES)
@pytest.mark.parametrize("model_type", ["t2v", "ti2v"])
def test_wan_model_matches_jax(model_type, name):
    jax_model, model = pair(model_type)
    x, ctx, t, seq_len = batch_inputs(name)
    want = jax_model([jnp.asarray(u) for u in x], jnp.asarray(t), [jnp.asarray(c) for c in ctx], seq_len=seq_len)
    before = CudaSdpa.golden_calls
    with torch.inference_mode():
        got = model([torch.from_numpy(u) for u in x], torch.from_numpy(t), [torch.from_numpy(c) for c in ctx],
                     seq_len=seq_len)
    assert CudaSdpa.golden_calls == before
    assert len(got) == len(want)
    for g, w, u in zip(got, want, x):
        assert g.shape == u.shape and g.dtype == torch.float32
        check_tol_diff(g, np.asarray(w), **F32)


def test_wan_i2v_matches_jax():
    """i2v doubles the patch embedding's input channels and takes ``y``."""
    jax_model, model = pair("i2v")
    x, ctx, t, seq_len = batch_inputs("uniform")
    y = [np.random.default_rng(9).standard_normal(u.shape).astype(np.float32) for u in x]
    want = jax_model([jnp.asarray(u) for u in x], jnp.asarray(t), [jnp.asarray(c) for c in ctx], seq_len=seq_len,
                     y=[jnp.asarray(u) for u in y])
    with torch.inference_mode():
        got = model([torch.from_numpy(u) for u in x], torch.from_numpy(t), [torch.from_numpy(c) for c in ctx],
                    seq_len=seq_len, y=[torch.from_numpy(u) for u in y])
    check_tol_diff(got[0], np.asarray(want[0]), **F32)


def test_wan_self_attention_masks_padded_keys():
    """JAX's padded-key case (test_wan22.py:116): a sample padded from 12 to
    20 tokens gives its 12 real rows the unpadded result, and equals JAX's
    attention on the padded input."""
    dim, heads, s_real, s_pad = 64, 4, 12, 20
    jax_attn = jax_wan.WanSelfAttention(dim, heads, key=jax.random.PRNGKey(3))
    attn = WanSelfAttention(dim, heads, device="cpu")
    load_numpy_state(attn, state_dict_of(jax_attn))
    rng = np.random.default_rng(1)
    x_real = rng.standard_normal((1, s_real, dim)).astype(np.float32)
    x_pad = np.concatenate([x_real, rng.standard_normal((1, s_pad - s_real, dim)).astype(np.float32)], axis=1)
    grid = [(1, 3, 4)]
    jfreqs = [jax_wan.rope_params(1024, dim // heads)[:s_real].reshape(s_real, 1, -1)]
    freqs = [modeling_wan.rope_params(1024, dim // heads)[:s_real].reshape(s_real, 1, -1)]
    lens = np.asarray([s_real], np.int32)
    want = np.asarray(jax_attn(jnp.asarray(x_pad), jnp.asarray(lens), np.asarray(grid), jfreqs))
    with torch.inference_mode():
        got = attn(torch.from_numpy(x_pad), torch.from_numpy(lens), grid, freqs)
        alone = attn(torch.from_numpy(x_real), torch.from_numpy(lens), grid, freqs)
    check_tol_diff(got, want, **F32)
    check_tol_diff(got[:, :s_real], alone, **F32)


def test_wan_embeddings_and_flops_match_jax():
    pos = np.asarray([0.0, 1.0, 37.0, 999.0], np.float32)
    check_tol_diff(modeling_wan.sinusoidal_embedding_1d(16, torch.from_numpy(pos)),
                   np.asarray(jax_wan.sinusoidal_embedding_1d(16, jnp.asarray(pos))), **F32)
    got = modeling_wan.rope_params(64, 44)
    assert got.dtype == torch.complex64
    assert np.allclose(got.numpy(), np.asarray(jax_wan.rope_params(64, 44)), atol=1e-6)
    full = dict(TINY, dim=3072, ffn_dim=14336, num_heads=24, num_layers=30)
    for L, T in ((4400, 512), (1560, 64)):
        assert dit_step_flops(WanConfig(**full), L, T) == jax_dit_step_flops(JaxWanConfig(**full), L, T)


def test_wan_bf16_parameters_and_denoise_step():
    """``WanConfig.dtype`` puts every floating parameter in bf16 (the JAX
    package's serving cast) while the RoPE table stays complex64 and the
    velocities fp32; an Euler step keeps the latents' shapes and dtype; the
    timing protocol refuses a model off the card."""
    model = WanModel(WanConfig(model_type="ti2v", dtype=torch.bfloat16, **TINY), device="cpu",
                     generator=torch.Generator().manual_seed(0))
    assert {p.dtype for p in model.parameters()} == {torch.bfloat16}
    assert model.freqs.dtype == torch.complex64
    x, ctx, t, seq_len = batch_inputs("ragged")
    with torch.inference_mode():
        xs, velocity = denoise_step(model, [torch.from_numpy(u) for u in x], torch.from_numpy(t),
                                    [torch.from_numpy(c) for c in ctx], seq_len, -0.25)
    for u, w, v in zip(x, xs, velocity):
        assert w.shape == u.shape and w.dtype == torch.float32 and torch.isfinite(v).all()
    with pytest.raises(RuntimeError, match="times the card"):  # a CPU time is no device time
        PerfDiTRunner(model).denoise([torch.from_numpy(u) for u in x], [torch.from_numpy(c) for c in ctx], seq_len, 1)
