"""Port parity for DeepSeek-V3 w8a8 serving: ``quantize_deepseek_v3`` and
the ``quant="w8a8"`` model of mojo_opset_tpu_torch against mojo_opset_tpu,
on the CPU.

A tiny fp32 DeepSeek-V3 (hidden 64, 4 heads, q LoRA 32, kv LoRA 16, rope 8,
one dense and one MoE layer of 4 experts, top-2) is built and quantized in
JAX on its golden tier (``MOJO_BACKEND=ref``); the quantized weights go
across through ``state_dict_of`` -> ``load_numpy_state``. The port runs
its ``cuda`` tier (the kernels' plain versions on CPU tensors) and its
golden tier.

Tolerances, and why (as tests/test_torch_quant.py): int8 weights bit for
bit and scales to rtol 1e-6; prefill logits to atol = rtol = 2e-3, since a
tie at a quant point moves one int8 value by one step; greedy tokens equal
JAX's stepwise stream, except where JAX's two best logits lie within 0.05
(a near-tie).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mojo_opset_tpu.modeling.deepseekv3 import DeepseekV3Config as JaxDeepseekV3Config
from mojo_opset_tpu.modeling.deepseekv3 import DeepseekV3ForCausalLM as JaxDeepseekV3
from mojo_opset_tpu.modeling.deepseekv3 import MLARuntimeState as JaxMLARuntimeState
from mojo_opset_tpu.modeling.deepseekv3.quantize import quantize_deepseek_v3 as jax_quantize_deepseek_v3
from mojo_opset_tpu.runtime import GreedySampler as JaxGreedy
from mojo_opset_tpu.runtime import MojoGenerator as JaxGenerator
from mojo_opset_tpu.runtime import PagedAttentionGenerationModel as JaxPaged
from mojo_opset_tpu.utils.hf import state_dict_of
from mojo_opset_tpu_torch.backends.cuda import kernels
from mojo_opset_tpu_torch.modeling.deepseekv3 import (
    DeepseekV3Config,
    DeepseekV3ForCausalLM,
    MLARuntimeState,
    quantize_deepseek_v3,
)
from mojo_opset_tpu_torch.runtime import GeneratorHook, GreedySampler, MojoGenerator, PagedAttentionGenerationModel
from mojo_opset_tpu_torch.utils.acc import check_tol_diff
from mojo_opset_tpu_torch.utils.weights import load_numpy_state

TINY = dict(
    hidden_size=64, intermediate_size=128, moe_intermediate_size=32, num_attention_heads=4, num_hidden_layers=2,
    vocab_size=128, max_position_embeddings=128, q_lora_rank=32, kv_lora_rank=16, qk_rope_head_dim=8,
    qk_nope_head_dim=16, v_head_dim=16, n_routed_experts=4, n_shared_experts=1, num_experts_per_tok=2,
    first_k_dense_replace=1,
)
LENS = np.array([5, 17, 1], np.int32)
BLOCK = 16
STEPS = 6
TIE_GAP = 0.05


@pytest.fixture(scope="module")
def quad():
    """(JAX w8a8 model, port fp32 base with the JAX weights, port w8a8 model with the JAX int8 weights)."""
    os.environ["MOJO_BACKEND"] = "ref"
    try:
        base_j = JaxDeepseekV3(JaxDeepseekV3Config(**TINY, dtype=jnp.float32), key=jax.random.PRNGKey(11))
        qm_j = jax_quantize_deepseek_v3(base_j)
    finally:
        del os.environ["MOJO_BACKEND"]
    base_t = load_numpy_state(DeepseekV3ForCausalLM(DeepseekV3Config(**TINY, dtype=torch.float32), device="cpu"),
                              state_dict_of(base_j))
    return qm_j, base_t, _port_w8a8(qm_j)


def _port_w8a8(qm_j):
    port = DeepseekV3ForCausalLM(DeepseekV3Config(**TINY, dtype=torch.float32, quant="w8a8"), device="cpu")
    return load_numpy_state(port, state_dict_of(qm_j))


def _prompt():
    return np.random.default_rng(0).integers(1, TINY["vocab_size"], int(LENS.sum())).astype(np.int32)


def _jax_paged(model):
    return JaxPaged(model, block_size=BLOCK, session_cls=JaxMLARuntimeState, jit=False)


def _port_paged(model):
    return PagedAttentionGenerationModel(model, block_size=BLOCK, session_cls=MLARuntimeState)


def test_quantize_deepseek_v3_matches_jax(quad):
    qm_j, base_t, qm_t = quad
    twin = quantize_deepseek_v3(base_t)
    mine, want = twin.state_dict(), state_dict_of(qm_j)
    assert set(mine) == {k for k in want if not k.endswith("inv_freq")} == set(qm_t.state_dict())
    for name, tensor in mine.items():
        if tensor.dtype == torch.int8:
            np.testing.assert_array_equal(tensor.numpy(), np.asarray(want[name]), err_msg=name)
        else:
            check_tol_diff(tensor, np.asarray(want[name]), atol=0.0, rtol=1e-6)
    attn, moe = twin.model.layers[1].self_attn, twin.model.layers[1].mlp
    kv_b_proj = base_t.model.layers[1].self_attn.attn_decode.kv_b_proj
    assert attn.attn_prefill.kv_b_proj is attn.attn_decode.kv_b_proj is kv_b_proj
    assert attn.attn_decode.kv_b_proj.dtype == torch.float32  # the decompression weight stays fp32
    assert type(attn.q_a_layernorm).__name__ == "CudaRMSNormQuant" and type(attn.o_proj).__name__ == "CudaQuantGemm"
    assert type(moe.routed_experts.experts).__name__ == "CudaQuantExperts"
    assert type(twin.model.layers[0].mlp.down_proj).__name__ == "CudaQuantGemm"


def test_w8a8_load_numpy_state_is_strict(quad):
    qm_j, _, qm_t = quad
    state = dict(state_dict_of(qm_j))
    state.pop("model.layers.1.mlp.routed_experts.experts.up_proj_weight_scale")
    with pytest.raises(KeyError, match="up_proj_weight_scale"):
        load_numpy_state(qm_t, state)
    state = dict(state_dict_of(qm_j))
    key = "model.layers.0.self_attn.attn_decode.kv_b_proj"
    state[key] = state[key] + 1.0
    with pytest.raises(ValueError, match="shared tensor"):
        load_numpy_state(qm_t, state)
    load_numpy_state(qm_t, state_dict_of(qm_j))


def test_w8a8_builds_and_unknown_quant_raises():
    model = DeepseekV3ForCausalLM(DeepseekV3Config(**TINY, dtype=torch.float32, quant="w8a8"), device="cpu")
    assert model.model.layers[1].mlp.routed_experts.experts.up_proj_weight.dtype == torch.int8
    assert type(model.model.layers[0].input_layernorm).__name__ == "CudaRMSNormQuant"
    with pytest.raises(ValueError, match="quant must be one of"):
        DeepseekV3Config(**TINY, quant="w4a8")


@pytest.mark.parametrize("tier", ["ref", "cuda"])
def test_w8a8_prefill_and_decode_match_jax(quad, tier, monkeypatch):
    """Prefill logits, then two decode steps fed JAX's argmax, against JAX's w8a8 model."""
    qm_j, _, qm_t = quad
    if tier == "ref":
        monkeypatch.setenv("MOJO_BACKEND", "ref")
        qm_t = _port_w8a8(qm_j)
    experts = qm_t.model.layers[1].mlp.routed_experts.experts
    assert type(experts).__name__ == ("RefQuantExperts" if tier == "ref" else "CudaQuantExperts")
    ids = _prompt()
    kernels.reset_launch_counts()
    logits_j, session_j = _jax_paged(qm_j)(ids, context_input_len=LENS)
    gm = _port_paged(qm_t)
    logits_t, session_t = gm(ids, context_input_len=LENS)
    check_tol_diff(logits_t, np.asarray(logits_j), atol=2e-3, rtol=2e-3)
    for _ in range(2):
        token = np.asarray(jnp.argmax(logits_j, -1)).astype(np.int32)
        logits_j, session_j = _jax_paged(qm_j)(jnp.asarray(token), session=session_j)
        logits_t, session_t = gm(torch.from_numpy(token), session=session_t)
        check_tol_diff(logits_t, np.asarray(logits_j), atol=2e-3, rtol=2e-3)
    assert kernels.launch_counts()["group_quant_gemm"] == 0  # CPU tensors: the plain version


class KeepLogits(GeneratorHook):
    def __init__(self):
        self.steps = []

    def after_prefill(self, *, logits, session):
        self.steps.append(np.asarray(logits))

    def after_decode_step(self, *, step, logits, next_token_id):
        self.steps.append(np.asarray(logits))


@pytest.fixture(scope="module")
def jax_stream(quad):
    hook = KeepLogits()
    stream = JaxGenerator(_jax_paged(quad[0]), None, JaxGreedy(), max_new_tokens=STEPS, hooks=[hook]).generate_from_ids(
        _prompt(), LENS, ignore_eos=True, silent=True)
    return np.asarray(stream), hook.steps


@pytest.mark.parametrize("fused", [False, True], ids=["stepwise", "fused"])
def test_w8a8_greedy_tokens_match_jax(quad, jax_stream, fused):
    """The port's stream equals JAX's stepwise stream, or first parts from it where JAX's two best logits lie
    within TIE_GAP; the fused window equals the port's stepwise loop."""
    qm_t = quad[2]

    def stream(fused_decode):
        return MojoGenerator(_port_paged(qm_t), None, GreedySampler(), max_new_tokens=STEPS).generate_from_ids(
            _prompt(), LENS, ignore_eos=True, fused_decode=fused_decode)

    got, (want, jax_logits) = stream(fused), jax_stream
    assert got.shape == want.shape
    for row in range(got.shape[0]):
        parted = np.flatnonzero(got[row] != want[row])
        if parted.size:
            top2 = np.sort(jax_logits[parted[0]][row])[-2:]
            assert top2[1] - top2[0] < TIE_GAP, (row, parted[0], top2)
    if fused:
        np.testing.assert_array_equal(got, stream(False))
