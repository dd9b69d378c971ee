"""Port parity for the distributed layer, MoE: expert parallelism on
torch.distributed against the unsharded JAX model and ops, on the CPU.

One spawn of four gloo rank processes (``tests/torch_parallel_workers.py``)
runs: Qwen3-MoE at tp 2 x ep 2 through ``qwen3_tp_rules + moe_ep_rules``
(JAX tests/distributed/test_moe_ep_decode_parity.py's config, its 2 x 4
mesh cut to the four ranks); ``MojoQuantMoE`` at ep 2 (JAX
test_moe_ep.py:16, fp32 scales); a ``dp_input`` MoE at ep 4 (JAX :62),
each rank bringing its quarter of the tokens; and an uneven split, six
experts over four ranks (2, 2, 1, 1), in both tiers. The references are
JAX's unsharded model (stepwise, unjitted) and JAX's ``ref``-tier ops in
this process. Tokens must be equal on every rank and to JAX's; outputs
hold to atol = rtol = 1e-4 (BASELINE.md's fp32 ladder), since the ranks'
partial outputs are summed in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import mojo_opset_tpu as jm
from mojo_opset_tpu.modeling.qwen3 import Qwen3MoeConfig as JaxQwen3MoeConfig
from mojo_opset_tpu.modeling.qwen3 import Qwen3MoeForCausalLM as JaxQwen3Moe
from mojo_opset_tpu.runtime import PagedAttentionGenerationModel as JaxPaged
from mojo_opset_tpu.utils.hf import state_dict_of
from mojo_opset_tpu_torch.utils.acc import check_tol_diff
from tests.test_torch_parallel import F32, _jax_stream, ranks
from tests.torch_parallel_workers import BLOCK, spawn

MOE_CFG = dict(hidden_size=64, intermediate_size=128, num_attention_heads=8, num_key_value_heads=4,
               num_hidden_layers=2, head_dim=16, vocab_size=256, max_position_embeddings=128, num_experts=8,
               num_experts_per_tok=2, moe_intermediate_size=32)
SCENARIOS = ("moe_tp2_ep2", "quant_moe_ep2", "moe_dp_input_ep4", "moe_uneven_ep4")


def _float_arrays(seed, E, H, I):
    rng = np.random.default_rng(seed)
    return dict(up_proj_weight=(rng.standard_normal((E, 2 * I, H)) * H ** -0.5).astype(np.float32),
                down_proj_weight=(rng.standard_normal((E, H, I)) * I ** -0.5).astype(np.float32))


def _quant_arrays(seed, E, H, I):
    rng = np.random.default_rng(seed)
    return dict(up_proj_weight=rng.integers(-20, 20, (E, 2 * I, H)).astype(np.int8),
                down_proj_weight=rng.integers(-20, 20, (E, H, I)).astype(np.int8),
                up_proj_weight_scale=rng.uniform(0.01, 0.02, (E, 2 * I)).astype(np.float32),
                down_proj_weight_scale=rng.uniform(0.01, 0.02, (E, H)).astype(np.float32),
                up_smooth=rng.uniform(0.8, 1.2, (E, H)).astype(np.float32),
                down_smooth=rng.uniform(0.8, 1.2, (E, I)).astype(np.float32))


def _jax_moe(op, dims, arrays, gate, x):
    """JAX's ``ref``-tier MoE on these weights: the unsharded output."""
    E, K, H, I = dims
    moe = op.get_backend_impl("ref", strict=True)(E, K, H, I)
    moe.gating = moe.gating.replace(gate_weight=jnp.asarray(gate))
    experts = moe.experts.replace(**{k: jnp.asarray(v) for k, v in arrays.items() if not k.endswith("smooth")})
    if "up_smooth" in arrays:
        experts.up_proj_quantize = experts.up_proj_quantize.replace(inv_smooth_scale=jnp.asarray(arrays["up_smooth"]))
        experts.down_proj_quantize = experts.down_proj_quantize.replace(
            inv_smooth_scale=jnp.asarray(arrays["down_smooth"]))
    moe.experts = experts
    return np.asarray(moe(jnp.asarray(x)))


def _op_case(op, dims, T, seed, quant=False):
    E, K, H, I = dims
    arrays = (_quant_arrays if quant else _float_arrays)(seed, E, H, I)
    gate = (np.random.default_rng(seed + 1).standard_normal((H, E)) * 0.3).astype(np.float32)
    x = np.random.default_rng(seed + 2).standard_normal((T, H)).astype(np.float32)
    return dict(dims=dims, arrays=arrays, gate=gate, x=x), _jax_moe(op, dims, arrays, gate, x)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    model = JaxQwen3Moe(JaxQwen3MoeConfig(**MOE_CFG, dtype=jnp.float32), key=jax.random.PRNGKey(5))
    lens = np.array([9, 6], np.int32)
    ids = np.random.default_rng(17).integers(1, 256, int(lens.sum())).astype(np.int32)
    logits, _ = JaxPaged(model, block_size=BLOCK, jit=False)(ids, context_input_len=lens)
    quant_moe, quant_ref = _op_case(jm.MojoQuantMoE, (8, 2, 16, 32), 8, 0, quant=True)
    moe_op, moe_ref = _op_case(jm.MojoMoE, (8, 2, 16, 32), 16, 10)
    uneven, uneven_ref = _op_case(jm.MojoMoE, (6, 2, 16, 32), 8, 20)
    inputs = dict(moe=dict(cfg=MOE_CFG, state=dict(state_dict_of(model)), ids=ids, lens=lens),
                  quant_moe=quant_moe, moe_op=moe_op, moe_uneven=uneven)
    refs = dict(moe=dict(stream=_jax_stream(model, ids, lens), logits=np.asarray(logits)), quant_moe=quant_ref,
                moe_op=moe_ref, moe_uneven=uneven_ref)
    return spawn(tmp_path_factory.mktemp("ep"), 4, SCENARIOS, inputs), refs, inputs


@pytest.mark.parametrize("stream", ["stepwise", "fused"])
def test_moe_tp2_ep2_greedy_tokens_match_jax(runs, stream):
    for out in ranks(runs, "moe_tp2_ep2"):
        np.testing.assert_array_equal(out[stream], runs[1]["moe"]["stream"])


def test_moe_tp2_ep2_prefill_logits_match_jax(runs):
    outs = ranks(runs, "moe_tp2_ep2")
    for out in outs:
        check_tol_diff(out["logits"], runs[1]["moe"]["logits"], **F32)
        np.testing.assert_array_equal(out["logits"], outs[0]["logits"])


def test_moe_tp2_ep2_shards_heads_and_experts(runs):
    # the (tp, ep) mesh puts rank r at tp r // 2, ep r % 2
    for rank, out in enumerate(ranks(runs, "moe_tp2_ep2")):
        assert out["tp"] == 2 and out["local_num_kv_heads"] == 2 == out["kv_heads"]
        ep = rank % 2
        assert out["experts"] == (4 * ep, 4 * ep + 4, 4)


def test_quant_moe_ep2_matches_jax(runs):
    outs = ranks(runs, "quant_moe_ep2")
    for rank, out in enumerate(outs):
        assert out["kernel"] == "CudaQuantExperts" and out["experts"] == (4 * (rank % 2), 4 * (rank % 2) + 4)
        check_tol_diff(out["out"], runs[1]["quant_moe"], **F32)


def test_moe_dp_input_ep4_matches_jax(runs):
    """Each rank brings a quarter of the tokens and gets its quarter of the output."""
    outs = [o["out"] for o in ranks(runs, "moe_dp_input_ep4")]
    assert all(o.shape == (4, 16) for o in outs)
    check_tol_diff(np.concatenate(outs), runs[1]["moe_op"], **F32)


@pytest.mark.parametrize("tier", ["ref", "cuda"])
def test_moe_uneven_expert_split_matches_jax(runs, tier):
    outs = ranks(runs, "moe_uneven_ep4")
    assert [o["experts"] for o in outs] == [(0, 2), (2, 4), (4, 5), (5, 6)]
    for out in outs:
        check_tol_diff(out[tier], runs[1]["moe_uneven"], **F32)
