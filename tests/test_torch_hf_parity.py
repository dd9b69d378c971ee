"""HF parity of the port's loaders: tiny transformers models go through
``save_pretrained`` and then through the JAX package's and the port's
``apply_mojo_to_*`` (``device="cpu"``), on the CPU. Nothing is downloaded:
each model is built from a config, as JAX's
tests/models/test_*_hf_parity.py build theirs.

Models: Qwen3 tied and untied, Qwen3-MoE, Seed-OSS, and DeepSeek-V3 with
``rope_interleave`` false and true in JAX's all-dense configuration
(test_deepseek_hf_parity.py:25-49). Each is one module-scoped fixture that
also computes transformers' references and JAX's.

Tolerances, and why: the port's prefill logits against JAX's at atol =
rtol = 1e-4 (one fp32 algorithm, sums in another order; BASELINE.md's fp32
limit is 6e-3); against transformers' own forward at atol = rtol = 2e-3, as
JAX's parity tests hold JAX's. Greedy tokens must equal both exactly.
"""

import os

import jax
import numpy as np
import pytest
import torch

from mojo_opset_tpu.modeling.deepseekv3 import MLARuntimeState as JaxMLARuntimeState
from mojo_opset_tpu.runtime import PagedAttentionGenerationModel as JaxPaged
from mojo_opset_tpu.utils import patching as jax_patching
from mojo_opset_tpu_torch.modeling.deepseekv3 import MLARuntimeState
from mojo_opset_tpu_torch.runtime import GreedySampler, MojoGenerator, PagedAttentionGenerationModel
from mojo_opset_tpu_torch.utils import patching
from mojo_opset_tpu_torch.utils.acc import check_tol_diff

os.environ.setdefault("USE_TF", "0")  # transformers skips importing TensorFlow (seconds)
transformers = pytest.importorskip("transformers")

JAX_TOL = dict(atol=1e-4, rtol=1e-4)
HF_TOL = dict(atol=2e-3, rtol=2e-3)
PROMPTS = [np.array([3, 17, 42, 5, 99, 1, 64, 23], np.int32), np.array([7, 3, 120, 11, 56], np.int32)]
STEPS = 6

QWEN3 = dict(hidden_size=64, intermediate_size=128, num_attention_heads=4, num_key_value_heads=2,
             num_hidden_layers=2, head_dim=16, vocab_size=128, max_position_embeddings=256, rms_norm_eps=1e-6,
             rope_theta=10000.0)
QWEN3_MOE = dict(QWEN3, max_position_embeddings=128, num_experts=8, num_experts_per_tok=2, moe_intermediate_size=32,
                 norm_topk_prob=True, decoder_sparse_step=1, mlp_only_layers=[], tie_word_embeddings=False,
                 attn_implementation="eager")
SEED_OSS = dict(QWEN3, max_position_embeddings=128, attention_bias=True, attention_out_bias=False, mlp_bias=False,
                tie_word_embeddings=False, attn_implementation="eager")
DEEPSEEK = dict(hidden_size=64, intermediate_size=96, moe_intermediate_size=32, num_attention_heads=4,
                num_key_value_heads=4, num_hidden_layers=2, vocab_size=128, max_position_embeddings=128,
                rms_norm_eps=1e-6, rope_theta=10000.0, q_lora_rank=32, kv_lora_rank=16, qk_rope_head_dim=8,
                qk_nope_head_dim=16, v_head_dim=16, n_routed_experts=4, n_shared_experts=1, num_experts_per_tok=2,
                first_k_dense_replace=8, n_group=2, topk_group=1, tie_word_embeddings=False,
                attn_implementation="eager")

# name: (transformers config and model class, HF config, loader name, session class of JAX, of the port)
MODELS = {
    "qwen3-untied": ("Qwen3Config", "Qwen3ForCausalLM", dict(QWEN3, tie_word_embeddings=False), "apply_mojo_to_qwen3",
                     None, None),
    "qwen3-tied": ("Qwen3Config", "Qwen3ForCausalLM", dict(QWEN3, tie_word_embeddings=True), "apply_mojo_to_qwen3",
                   None, None),
    "qwen3-moe": ("Qwen3MoeConfig", "Qwen3MoeForCausalLM", QWEN3_MOE, "apply_mojo_to_qwen3_moe", None, None),
    "seed-oss": ("SeedOssConfig", "SeedOssForCausalLM", SEED_OSS, "apply_mojo_to_seed_oss", None, None),
    "deepseek-v3-interleave0": ("DeepseekV3Config", "DeepseekV3ForCausalLM", dict(DEEPSEEK, rope_interleave=False),
                                "apply_mojo_to_deepseek_v3", JaxMLARuntimeState, MLARuntimeState),
    "deepseek-v3-interleave1": ("DeepseekV3Config", "DeepseekV3ForCausalLM", dict(DEEPSEEK, rope_interleave=True),
                                "apply_mojo_to_deepseek_v3", JaxMLARuntimeState, MLARuntimeState),
}


def _hf_logits(hf_model, ids):
    with torch.no_grad():
        return hf_model(input_ids=torch.tensor(np.asarray(ids)[None], dtype=torch.long)).logits[0].float().numpy()


def _hf_greedy(hf_model, prompt):
    ids = list(prompt)
    for _ in range(STEPS):
        ids.append(int(_hf_logits(hf_model, ids)[-1].argmax()))
    return ids[len(prompt):]


def _jax_greedy(gm, prompt):
    logits, session = gm(prompt, context_input_len=np.array([prompt.size], np.int32))
    tokens = [int(np.argmax(np.asarray(logits)[0]))]
    for _ in range(STEPS - 1):
        logits, session = gm(np.array(tokens[-1:], np.int32), session=session)
        tokens.append(int(np.argmax(np.asarray(logits)[0])))
    return tokens


@pytest.fixture(scope="module", params=list(MODELS))
def case(request, tmp_path_factory):
    """The checkpoint, the port's model loaded from it, and the references:
    transformers' last-token logits and greedy tokens a prompt, JAX's
    prefill logits (the prompts packed varlen) and greedy tokens."""
    cfg_cls, model_cls, hf_cfg, loader, jax_session, session = MODELS[request.param]
    torch.manual_seed(0)
    hf_model = getattr(transformers, model_cls)(getattr(transformers, cfg_cls)(**hf_cfg)).eval().to(torch.float32)
    path = str(tmp_path_factory.mktemp(request.param))
    hf_model.save_pretrained(path, safe_serialization=True)

    jax_model = getattr(jax_patching, loader)(path, key=jax.random.PRNGKey(0))
    jax_gm = JaxPaged(jax_model, block_size=16, jit=False, **({"session_cls": jax_session} if jax_session else {}))
    lens = np.array([p.size for p in PROMPTS], np.int32)
    jax_logits, _ = jax_gm(np.concatenate(PROMPTS), context_input_len=lens)
    port = getattr(patching, loader)(path, device="cpu", strict=True)
    return dict(
        name=request.param, path=path, port=port, session=session, lens=lens,
        hf_logits=[_hf_logits(hf_model, p)[-1] for p in PROMPTS],
        hf_tokens=_hf_greedy(hf_model, PROMPTS[1]),
        jax_logits=np.asarray(jax_logits, np.float32),
        jax_tokens=_jax_greedy(jax_gm, PROMPTS[1]),
    )


def _port_gm(case):
    return PagedAttentionGenerationModel(case["port"], block_size=16,
                                         **({"session_cls": case["session"]} if case["session"] else {}))


def test_prefill_logits_match_jax_and_transformers(case):
    logits, _ = _port_gm(case)(np.concatenate(PROMPTS), context_input_len=case["lens"])
    check_tol_diff(logits, case["jax_logits"], **JAX_TOL)
    for row, want in zip(logits, case["hf_logits"]):
        check_tol_diff(row, want, **HF_TOL)


@pytest.mark.parametrize("fused", [False, True], ids=["stepwise", "fused"])
def test_greedy_tokens_match_jax_and_transformers(case, fused):
    gen = MojoGenerator(_port_gm(case), None, GreedySampler(), max_new_tokens=STEPS)
    prompt = PROMPTS[1]
    got = gen.generate_from_ids(prompt, np.array([prompt.size], np.int32), ignore_eos=True, fused_decode=fused)
    assert got[0].tolist() == case["hf_tokens"] == case["jax_tokens"]


def test_every_parameter_came_from_the_checkpoint(case):
    """strict=True loaded every state entry; the tied lm_head is the
    embedding itself, DeepSeek-V3's two kv_b_proj names one tensor."""
    port = case["port"]
    if case["name"] == "qwen3-tied":
        assert port.lm_head is None and not any(k.startswith("lm_head") for k in port.state_dict())
    if case["name"].startswith("deepseek"):
        attn = port.model.layers[0].self_attn
        assert attn.attn_decode.kv_b_proj is attn.attn_prefill.kv_b_proj
    if case["name"] == "qwen3-moe":
        experts = port.layers[0].mlp.experts
        assert experts.up_proj_weight.shape == (8, 64, 64) and experts.down_proj_weight.shape == (8, 64, 32)
        assert port.layers[0].mlp.gating.gate_weight.shape == (64, 8)
    assert all(torch.isfinite(t).all() for t in port.state_dict().values() if t.is_floating_point())
