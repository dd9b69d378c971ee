"""Port parity for the serving slice: the Qwen3 dense model of
mojo_opset_tpu_torch against mojo_opset_tpu, on the CPU.

A 2-layer fp32 model (hidden 64, 4/2 heads, head_dim 16, vocab 128) is
built in JAX; its weights go across through ``state_dict_of`` ->
``load_numpy_state``. Logits hold to atol = rtol = 1e-4 (one fp32
algorithm over two layers, sums in another order); greedy tokens and the
allocator's block tables must be identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mojo_opset_tpu.modeling.qwen3 import Qwen3Config as JaxQwen3Config
from mojo_opset_tpu.modeling.qwen3 import Qwen3ForCausalLM as JaxQwen3
from mojo_opset_tpu.runtime import GreedySampler as JaxGreedy
from mojo_opset_tpu.runtime import MojoGenerator as JaxGenerator
from mojo_opset_tpu.runtime import PagedAttentionGenerationModel as JaxPaged
from mojo_opset_tpu.utils.hf import state_dict_of
from mojo_opset_tpu_torch.modeling.qwen3 import Qwen3Config, Qwen3ForCausalLM
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


class Tok:
    eos_token_id = 0


@pytest.fixture(scope="module", params=["NHD", "HND"])
def pair(request):
    """(JAX model, port model with the JAX weights, layout)."""
    layout = request.param
    jax_model = JaxQwen3(JaxQwen3Config(**TINY, dtype=jnp.float32, kv_layout=layout), key=jax.random.PRNGKey(7))
    port = Qwen3ForCausalLM(Qwen3Config(**TINY, dtype=torch.float32, kv_layout=layout), device="cpu")
    load_numpy_state(port, state_dict_of(jax_model))
    return jax_model, port, layout


def _prompt():
    return np.random.default_rng(0).integers(1, TINY["vocab_size"], int(LENS.sum())).astype(np.int32)


def test_state_dict_keys_match_jax(pair):
    jax_model, port, _ = pair
    jax_keys = {k for k in state_dict_of(jax_model) if not k.endswith("inv_freq")}
    assert set(port.state_dict()) == jax_keys


def test_load_numpy_state_is_strict(pair):
    jax_model, port, _ = pair
    state = dict(state_dict_of(jax_model))
    state.pop("lm_head.weight")
    with pytest.raises(KeyError, match="lm_head.weight"):
        load_numpy_state(port, state)
    state = dict(state_dict_of(jax_model), **{"model.norm.weight": np.ones(3, np.float32)})
    with pytest.raises(ValueError, match="model.norm.weight"):
        load_numpy_state(port, state)


@pytest.mark.parametrize("tier", ["ref", "cuda"])
def test_prefill_logits_and_caches(pair, tier, monkeypatch):
    jax_model, port, layout = pair
    if tier == "ref":  # the same weights in a model built on the golden tier
        monkeypatch.setenv("MOJO_BACKEND", "ref")
        ref_port = Qwen3ForCausalLM(Qwen3Config(**TINY, dtype=torch.float32, kv_layout=layout), device="cpu")
        ref_port.load_state_dict(port.state_dict())
        assert type(ref_port.model.layers[0].self_attn.attn_prefill).__name__ == "RefPagedPrefillGQA"
        port = ref_port
    else:
        assert type(port.model.layers[0].self_attn.attn_prefill).__name__ == "CudaPagedPrefillGQA"
    ids = _prompt()
    logits_j, session_j = JaxPaged(jax_model, block_size=BLOCK, jit=False)(ids, context_input_len=LENS)
    logits_t, session_t = PagedAttentionGenerationModel(port, block_size=BLOCK)(ids, context_input_len=LENS)
    assert logits_t.shape == (len(LENS), TINY["vocab_size"]) and logits_t.dtype == torch.float32
    check_tol_diff(logits_t, np.asarray(logits_j), atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(session_t.block_tables, session_j.block_tables)
    np.testing.assert_array_equal(session_t.total_seq_lens, session_j.total_seq_lens)
    for layer in range(TINY["num_hidden_layers"]):
        check_tol_diff(session_t.caches.key(layer), np.asarray(session_j.caches.key(layer)), atol=1e-5, rtol=1e-5)
        check_tol_diff(session_t.caches.value(layer), np.asarray(session_j.caches.value(layer)), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("fused", [False, True], ids=["stepwise", "fused"])
def test_greedy_tokens_match(pair, fused):
    """Both of the port's streams are held to JAX's stepwise stream: JAX's
    jitted FusedDecode window, run from the persistent XLA:CPU cache under
    several workers, is not a stable reference (ROADMAP.md, queue 3). The
    fused case also holds the port's window to the port's stepwise loop."""
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


def test_eos_clamps_like_jax(pair):
    """With EOS handling on, tokens after a sequence's first EOS repeat EOS."""
    jax_model, port, _ = pair
    ids = _prompt()
    free = MojoGenerator(PagedAttentionGenerationModel(port, block_size=BLOCK), Tok(), GreedySampler(),
                         max_new_tokens=STEPS).generate_from_ids(ids, LENS, ignore_eos=True)

    class EosTok:
        eos_token_id = int(free[1, 2])  # sequence 1 emits it at step 2

    want = JaxGenerator(JaxPaged(jax_model, block_size=BLOCK, jit=False), EosTok(), JaxGreedy(),
                        max_new_tokens=STEPS).generate_from_ids(ids, LENS, silent=True)
    got = MojoGenerator(PagedAttentionGenerationModel(port, block_size=BLOCK), EosTok(), GreedySampler(),
                        max_new_tokens=STEPS).generate_from_ids(ids, LENS)
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("mode", ["fp32", "w8a8", "w8a8_c8"])
def test_second_prefill_on_live_session_matches_jax(mode):
    """Chunked prefill, the path of the speculative verify and of prefix-cache
    and chunked admission: a second prefill on a session that holds context,
    with logits at every position (no lm_head_indices)."""
    from mojo_opset_tpu.modeling.qwen3 import quantize_qwen3 as jax_quantize_qwen3
    from mojo_opset_tpu_torch.modeling.qwen3 import quantize_qwen3

    quant_kv = mode == "w8a8_c8"
    jax_model = JaxQwen3(JaxQwen3Config(**TINY, dtype=jnp.float32, quant_kv=quant_kv), key=jax.random.PRNGKey(7))
    port = Qwen3ForCausalLM(Qwen3Config(**TINY, dtype=torch.float32, quant_kv=quant_kv), device="cpu")
    load_numpy_state(port, state_dict_of(jax_model))
    if mode != "fp32":
        jax_model, port = jax_quantize_qwen3(jax_model), quantize_qwen3(port)
    rng = np.random.default_rng(3)
    first, lens1 = rng.integers(1, TINY["vocab_size"], 10).astype(np.int32), np.array([6, 4], np.int32)
    more, lens2 = rng.integers(1, TINY["vocab_size"], 10).astype(np.int32), np.array([5, 5], np.int32)
    _, session_j = JaxPaged(jax_model, block_size=BLOCK, jit=False)(first, context_input_len=lens1)
    _, session_t = PagedAttentionGenerationModel(port, block_size=BLOCK)(first, context_input_len=lens1)
    ids, pos, meta = session_j.prepare_prefill_inputs(more, lens2)
    logits_j, _ = jax_model(ids, pos, meta, session_j.caches, lm_head_indices=None)
    ids, pos, meta = session_t.prepare_prefill_inputs(more, lens2)
    with torch.inference_mode():
        logits_t = port(ids, pos, meta, session_t.caches, lm_head_indices=None)
    assert logits_t.shape == (10, TINY["vocab_size"])
    check_tol_diff(logits_t, np.asarray(logits_j), atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(logits_t.argmax(-1).numpy(), np.asarray(logits_j).argmax(-1))
