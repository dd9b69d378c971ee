"""Port parity for DeepSeek-V3 (MLA + MoE) serving: the model of
mojo_opset_tpu_torch against mojo_opset_tpu, on the CPU.

The JAX test's ``TINY`` configuration (tests/models/test_deepseek_v3.py:
hidden 64, 4 heads, q LoRA 32, kv LoRA 16, rope 8, 3 layers, 4 experts top-2,
the first layer dense) in fp32, block 16, is built in JAX on its golden
tier (``MOJO_BACKEND=ref``); its weights go across through
``state_dict_of`` -> ``load_numpy_state``. The port runs its ``cuda`` tier
(kernel I's plain absorbed version on CPU tensors) and its golden tier.

Tolerances, and why: logits to atol = rtol = 1e-4 (one fp32 algorithm over
three layers, with the decompression weight absorbed into the queries on
the cuda tier, sums in another order), the latent caches to 1e-5; greedy
tokens and the allocator's block tables exactly. The port's streams, the
stepwise loop and the FusedDecode window, are both held to JAX's stepwise
stream (its jitted window is not a stable reference: ROADMAP.md, queue 3).
"""

import os

import jax
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from mojo_opset_tpu.modeling.deepseekv3 import DeepseekV3Config as JaxDeepseekV3Config
from mojo_opset_tpu.modeling.deepseekv3 import DeepseekV3ForCausalLM as JaxDeepseekV3
from mojo_opset_tpu.modeling.deepseekv3 import MLARuntimeState as JaxMLARuntimeState
from mojo_opset_tpu.runtime import GreedySampler as JaxGreedy
from mojo_opset_tpu.runtime import MojoGenerator as JaxGenerator
from mojo_opset_tpu.runtime import PagedAttentionGenerationModel as JaxPaged
from mojo_opset_tpu.utils.hf import state_dict_of
from mojo_opset_tpu_torch.backends.cuda import kernels
from mojo_opset_tpu_torch.modeling.deepseekv3 import DeepseekV3Config, DeepseekV3ForCausalLM, MLARuntimeState
from mojo_opset_tpu_torch.runtime import GreedySampler, MojoGenerator, PagedAttentionGenerationModel
from mojo_opset_tpu_torch.utils.acc import check_tol_diff
from mojo_opset_tpu_torch.utils.weights import load_numpy_state

TINY = dict(
    hidden_size=64, intermediate_size=128, moe_intermediate_size=32, num_attention_heads=4, num_hidden_layers=3,
    vocab_size=128, max_position_embeddings=128, q_lora_rank=32, kv_lora_rank=16, qk_rope_head_dim=8,
    qk_nope_head_dim=16, v_head_dim=16, n_routed_experts=4, n_shared_experts=1, num_experts_per_tok=2,
    first_k_dense_replace=1,
)
LENS = np.array([5, 17, 1], np.int32)
BLOCK = 16
STEPS = 6


def _jax_model(**over):
    """The JAX model on its golden tier."""
    os.environ["MOJO_BACKEND"] = "ref"
    try:
        return JaxDeepseekV3(JaxDeepseekV3Config(**{**TINY, **over}, dtype=jnp.float32), key=jax.random.PRNGKey(11))
    finally:
        del os.environ["MOJO_BACKEND"]


def _port(jax_model, **over):
    port = DeepseekV3ForCausalLM(DeepseekV3Config(**{**TINY, **over}, dtype=torch.float32), device="cpu")
    return load_numpy_state(port, state_dict_of(jax_model))


@pytest.fixture(scope="module")
def pair():
    jax_model = _jax_model()
    return jax_model, _port(jax_model)


def _prompt():
    return np.random.default_rng(0).integers(1, TINY["vocab_size"], int(LENS.sum())).astype(np.int32)


def _jax_paged(jax_model):
    return JaxPaged(jax_model, block_size=BLOCK, session_cls=JaxMLARuntimeState, jit=False)


def _port_paged(port):
    return PagedAttentionGenerationModel(port, block_size=BLOCK, session_cls=MLARuntimeState)


def test_state_dict_keys_match_jax(pair):
    jax_model, port = pair
    assert set(port.state_dict()) == {k for k in state_dict_of(jax_model) if not k.endswith("inv_freq")}
    attn = port.model.layers[0].self_attn
    assert attn.attn_prefill.kv_b_proj is attn.attn_decode.kv_b_proj  # one decompression weight
    assert attn.attn_decode.kv_b_proj.dtype == torch.float32
    assert type(port.model.layers[1].mlp.routed_experts.experts).__name__ == "CudaExperts"
    mc = port.config.model_config
    assert (mc.moe_expert_num, mc.moe_topk, mc.num_kv_heads) == (4, 2, 1)
    assert port.model.layers[1].mlp.shared_experts.up_proj.weight.shape == (32, 64)  # 1 shared expert of width 32
    assert mc.extra == {"kv_lora_rank": 16, "qk_rope_head_dim": 8}


def test_load_numpy_state_is_strict(pair):
    jax_model, port = pair
    state = dict(state_dict_of(jax_model))
    state.pop("model.layers.2.mlp.shared_experts.up_proj.weight")
    with pytest.raises(KeyError, match="shared_experts"):
        load_numpy_state(port, state)
    state = dict(state_dict_of(jax_model))
    key = "model.layers.1.self_attn.attn_decode.kv_b_proj"
    state[key] = state[key] + 1.0
    with pytest.raises(ValueError, match="shared tensor"):
        load_numpy_state(port, state)
    load_numpy_state(port, state_dict_of(jax_model))


@pytest.mark.parametrize("tier", ["ref", "cuda"])
def test_prefill_and_decode_match_jax(pair, tier, monkeypatch):
    """Prefill logits and latent caches, then three decode steps, against
    JAX's golden tier."""
    jax_model, port = pair
    if tier == "ref":  # the same weights in a model built on the golden tier
        monkeypatch.setenv("MOJO_BACKEND", "ref")
        port = _port(jax_model)
    attn = port.model.layers[0].self_attn
    assert type(attn.attn_decode).__name__ == ("RefPagedDecodeMLA" if tier == "ref" else "CudaPagedDecodeMLA")
    assert type(attn.attn_prefill).__name__ == ("RefPagedPrefillMLA" if tier == "ref" else "CudaPagedPrefillMLA")
    ids = _prompt()
    kernels.reset_launch_counts()
    logits_j, session_j = _jax_paged(jax_model)(ids, context_input_len=LENS)
    gm = _port_paged(port)
    logits_t, session_t = gm(ids, context_input_len=LENS)
    assert isinstance(session_t, MLARuntimeState)
    assert logits_t.shape == (len(LENS), TINY["vocab_size"]) and logits_t.dtype == torch.float32
    check_tol_diff(logits_t, np.asarray(logits_j), atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(session_t.block_tables, session_j.block_tables)
    dr = TINY["qk_rope_head_dim"]
    for layer in range(TINY["num_hidden_layers"]):
        check_tol_diff(session_t.caches.key(layer), np.asarray(session_j.caches.key(layer)), atol=1e-5, rtol=1e-5)
        check_tol_diff(session_t.caches.value(layer), np.asarray(session_j.caches.value(layer))[..., :dr],
                       atol=1e-5, rtol=1e-5)
    for _ in range(3):
        token = np.asarray(jnp.argmax(logits_j, -1)).astype(np.int32)
        np.testing.assert_array_equal(torch.argmax(logits_t, -1).numpy(), token)
        logits_j, session_j = _jax_paged(jax_model)(jnp.asarray(token), session=session_j)
        logits_t, session_t = gm(torch.from_numpy(token), session=session_t)
        check_tol_diff(logits_t, np.asarray(logits_j), atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(session_t.total_seq_lens, LENS + 3)
    assert kernels.launch_counts()["mla_decode"] == 0  # CPU tensors: the plain version


@pytest.fixture(scope="module")
def jax_stepwise(pair):
    """JAX's stepwise greedy stream: the reference for both of the port's."""
    return np.asarray(JaxGenerator(_jax_paged(pair[0]), None, JaxGreedy(), max_new_tokens=STEPS).generate_from_ids(
        _prompt(), LENS, ignore_eos=True, silent=True))


@pytest.mark.parametrize("fused", [False, True], ids=["stepwise", "fused"])
def test_greedy_tokens_match_jax(pair, jax_stepwise, fused):
    got = MojoGenerator(_port_paged(pair[1]), None, GreedySampler(), max_new_tokens=STEPS).generate_from_ids(
        _prompt(), LENS, ignore_eos=True, fused_decode=fused)
    assert got.shape == (len(LENS), STEPS)
    np.testing.assert_array_equal(got, jax_stepwise)


def test_q_lora_rank_none_matches_jax():
    jax_model = _jax_model(q_lora_rank=None)
    port = _port(jax_model, q_lora_rank=None)
    assert not hasattr(port.model.layers[0].self_attn, "q_a_proj")
    ids, lens = np.array([1, 2, 3, 9], np.int32), np.array([3, 1], np.int32)
    logits_j, _ = _jax_paged(jax_model)(ids, context_input_len=lens)
    logits_t, _ = _port_paged(port)(ids, context_input_len=lens)
    check_tol_diff(logits_t, np.asarray(logits_j), atol=1e-4, rtol=1e-4)


def test_mla_session_holds_only_latent_caches():
    cfg = DeepseekV3Config(**TINY, dtype=torch.float32)
    sess = MLARuntimeState(cfg.to_mojo(), batch_size=2, block_size=16, device="cpu")
    n_blocks = 2 * (TINY["max_position_embeddings"] // 16)
    assert sess.caches.key(0).shape == (n_blocks, 1, 16, TINY["kv_lora_rank"])
    assert sess.caches.value(0).shape == (n_blocks, 1, 16, TINY["qk_rope_head_dim"])  # dr, unpadded
    assert len(sess.caches.keys) == len(sess.caches.values) == TINY["num_hidden_layers"]
    assert sess.kv_layout == "HND" and sess.caches.key(2).dtype == torch.float32


def test_quantized_deepseek_is_refused():
    with pytest.raises(NotImplementedError, match="Quantized MoE and DeepSeek w8a8"):
        DeepseekV3ForCausalLM(DeepseekV3Config(**TINY, dtype=torch.float32, quant="w8a8"), device="cpu")


def test_random_init_is_seeded():
    cfg = DeepseekV3Config(**TINY, dtype=torch.float32)
    a = DeepseekV3ForCausalLM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    b = DeepseekV3ForCausalLM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    for (name, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), name
    attn = a.model.layers[0].self_attn
    assert attn.attn_decode.kv_b_proj.abs().max() <= 1 / np.sqrt(TINY["kv_lora_rank"])
    assert attn.attn_prefill.kv_b_proj is attn.attn_decode.kv_b_proj
