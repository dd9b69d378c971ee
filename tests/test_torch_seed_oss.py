"""Port parity for Seed-OSS serving: the Seed-OSS model of
mojo_opset_tpu_torch against mojo_opset_tpu, on the CPU, in fp32 and w8a8.

A 2-layer fp32 model (hidden 64, 4/2 heads, head_dim 16, vocab 128, q/k/v
biases) is built in JAX and its w8a8 twin comes from JAX's
``quantize_seed_oss``; the weights of both go across through
``state_dict_of`` -> ``load_numpy_state``. Prefill logits hold to atol =
rtol = 1e-4 in fp32 (one algorithm over two layers, sums in another
order) and 2e-3 in w8a8 (a tie at a quant point moves one int8 value by
one step); greedy tokens, stepwise and fused, equal JAX's stepwise stream.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mojo_opset_tpu.modeling.seed_oss import SeedOssConfig as JaxSeedOssConfig
from mojo_opset_tpu.modeling.seed_oss import SeedOssForCausalLM as JaxSeedOss
from mojo_opset_tpu.modeling.seed_oss import quantize_seed_oss as jax_quantize_seed_oss
from mojo_opset_tpu.runtime import GreedySampler as JaxGreedy
from mojo_opset_tpu.runtime import MojoGenerator as JaxGenerator
from mojo_opset_tpu.runtime import PagedAttentionGenerationModel as JaxPaged
from mojo_opset_tpu.utils.hf import state_dict_of
from mojo_opset_tpu_torch.modeling.seed_oss import SeedOssConfig, SeedOssForCausalLM, quantize_seed_oss
from mojo_opset_tpu_torch.runtime import GreedySampler, MojoGenerator, PagedAttentionGenerationModel
from mojo_opset_tpu_torch.utils.acc import check_tol_diff
from mojo_opset_tpu_torch.utils.weights import load_numpy_state

TINY = dict(
    hidden_size=64, intermediate_size=128, num_attention_heads=4, num_key_value_heads=2,
    num_hidden_layers=2, head_dim=16, vocab_size=128, max_position_embeddings=128,
)
LENS = np.array([5, 17, 1], np.int32)
BLOCK = 16
STEPS = 8
LOGIT_TOL = {"fp32": dict(atol=1e-4, rtol=1e-4), "w8a8": dict(atol=2e-3, rtol=2e-3)}


class Tok:
    eos_token_id = 0


@pytest.fixture(scope="module")
def jax_models():
    base = JaxSeedOss(JaxSeedOssConfig(**TINY, dtype=jnp.float32), key=jax.random.PRNGKey(4))
    return {"fp32": base, "w8a8": jax_quantize_seed_oss(base)}


@pytest.fixture(scope="module", params=["fp32", "w8a8"])
def pair(request, jax_models):
    """(JAX model, port model with the JAX weights, mode)."""
    mode = request.param
    port = SeedOssForCausalLM(SeedOssConfig(**TINY, dtype=torch.float32, quant=None if mode == "fp32" else mode),
                              device="cpu")
    load_numpy_state(port, state_dict_of(jax_models[mode]))
    return jax_models[mode], port, mode


def _prompt():
    return np.random.default_rng(0).integers(1, TINY["vocab_size"], int(LENS.sum())).astype(np.int32)


def test_state_dict_keys_match_jax(pair):
    jax_model, port, mode = pair
    keys = set(port.state_dict())
    assert keys == {k for k in state_dict_of(jax_model) if not k.endswith("inv_freq")}
    if mode == "w8a8":  # the biases ride beside the int8 GEMMs; o has none
        assert {"layers.0.self_attn.q_bias", "layers.0.self_attn.v_bias"} <= keys
        assert "layers.0.self_attn.o_bias" not in keys and port.layers[0].self_attn.o_bias is None
        assert port.layers[0].self_attn.q_proj.weight.dtype == torch.int8
    else:
        assert {"layers.0.self_attn.q_proj.bias", "layers.1.self_attn.k_proj.bias"} <= keys
        assert not any(k.endswith(("q_norm.weight", "o_proj.bias", "mlp.up_proj.bias")) for k in keys)


def test_quantize_seed_oss_matches_jax(jax_models):
    base = SeedOssForCausalLM(SeedOssConfig(**TINY, dtype=torch.float32), device="cpu")
    load_numpy_state(base, state_dict_of(jax_models["fp32"]))
    mine, want = quantize_seed_oss(base).state_dict(), state_dict_of(jax_models["w8a8"])
    assert set(mine) == {k for k in want if not k.endswith("inv_freq")}
    for name, t in mine.items():
        if t.dtype == torch.int8:
            np.testing.assert_array_equal(t.numpy(), np.asarray(want[name]), err_msg=name)
        else:
            check_tol_diff(t, np.asarray(want[name]), atol=0.0, rtol=1e-6)
    assert type(quantize_seed_oss(base).layers[0].input_layernorm).__name__ == "CudaRMSNormQuant"


def test_prefill_logits_match_jax(pair):
    jax_model, port, mode = pair
    ids = _prompt()
    logits_j, _ = JaxPaged(jax_model, block_size=BLOCK, jit=False)(ids, context_input_len=LENS)
    logits_t, _ = PagedAttentionGenerationModel(port, block_size=BLOCK)(ids, context_input_len=LENS)
    assert logits_t.shape == (len(LENS), TINY["vocab_size"]) and logits_t.dtype == torch.float32
    check_tol_diff(logits_t, np.asarray(logits_j), **LOGIT_TOL[mode])


@pytest.mark.parametrize("fused", [False, True], ids=["stepwise", "fused"])
def test_greedy_tokens_match(pair, fused):
    """Both of the port's streams are held to JAX's stepwise stream; the fused
    case also holds the port's window to the port's stepwise loop."""
    jax_model, port, _ = pair
    ids = _prompt()
    want = JaxGenerator(JaxPaged(jax_model, block_size=BLOCK, jit=False), Tok(), JaxGreedy(),
                        max_new_tokens=STEPS).generate_from_ids(ids, LENS, ignore_eos=True, silent=True)

    def port_stream(fused_decode):
        return MojoGenerator(PagedAttentionGenerationModel(port, block_size=BLOCK), Tok(), GreedySampler(),
                             max_new_tokens=STEPS).generate_from_ids(ids, LENS, ignore_eos=True,
                                                                     fused_decode=fused_decode)

    got = port_stream(fused)
    assert got.shape == (len(LENS), STEPS)
    np.testing.assert_array_equal(got, np.asarray(want))
    if fused:
        np.testing.assert_array_equal(got, port_stream(False))


def test_config_refuses_what_the_jax_model_does_not_serve():
    with pytest.raises(ValueError, match="quant"):
        SeedOssConfig(quant="w4a8")
    with pytest.raises(NotImplementedError, match="MLP"):
        SeedOssConfig(quant="w8a8", mlp_bias=True)
    assert SeedOssConfig().to_mojo().model_config.extra == {"has_attn_bias": True}
