"""Port parity for Qwen3-MoE serving: the MoE op chain, the grouped GEMM and
the Qwen3-MoE model of mojo_opset_tpu_torch against mojo_opset_tpu, on
the CPU.

The same numpy inputs (``np.random.default_rng``) go through the JAX op
(its ``ref`` tier; for the grouped GEMM also its ``pallas`` kernel in
interpret mode, at a geometry that kernel takes) and through every tier of
the port, where the ``cuda`` tier runs kernel H's plain version. Weights
go across as numpy arrays.

Tolerances, and why:
  * gating: indices equal, gates to 1e-6 (one fp32 softmax, sums in
    another order); under bf16 input the gate math stays fp32, so the
    indices equal the fp32 input's and the gates agree to 2e-2, as the JAX
    package's own test holds them.
  * dispatch: counts and buckets exact (buckets as sets; the port sorts
    stably, as ``jnp.argsort`` does, so rows are in the same order too).
  * grouped GEMM, experts, MoE: fp32 to atol = rtol = 1e-5 (fp32 sums in
    another order); bf16 to one bf16 step of the output (rtol 2^-7, atol
    2^-8 near zero).
  * the model: prefill logits to atol = rtol = 1e-4 over two layers;
    greedy tokens equal, stepwise and in the FusedDecode window.

The gate matmul runs in full fp32 on a card as here: torch's default
``allow_tf32`` is False, and the port sets nothing.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mojo_opset_tpu as jm
from mojo_opset_tpu.modeling.qwen3.modeling_qwen3_moe import Qwen3MoeConfig as JaxQwen3MoeConfig
from mojo_opset_tpu.modeling.qwen3.modeling_qwen3_moe import Qwen3MoeForCausalLM as JaxQwen3Moe
from mojo_opset_tpu.runtime import GreedySampler as JaxGreedy
from mojo_opset_tpu.runtime import MojoGenerator as JaxGenerator
from mojo_opset_tpu.runtime import PagedAttentionGenerationModel as JaxPaged
from mojo_opset_tpu.utils.hf import state_dict_of
import mojo_opset_tpu_torch as tm
from mojo_opset_tpu_torch.backends.cuda import kernels
from mojo_opset_tpu_torch.modeling.qwen3 import Qwen3MoeConfig, Qwen3MoeForCausalLM
from mojo_opset_tpu_torch.runtime import (
    ContinuousBatchingGenerator,
    GreedySampler,
    MojoGenerator,
    PagedAttentionGenerationModel,
)
from mojo_opset_tpu_torch.utils.acc import check_tol_diff
from mojo_opset_tpu_torch.utils.weights import load_numpy_state

F32 = dict(atol=1e-5, rtol=1e-5)


def randn(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def port_ops(core, *args, **kwargs):
    return {t: core.get_backend_impl(t, strict=True)(*args, **kwargs) for t in core.get_registered_backends()}


def t32(a):
    return torch.from_numpy(np.array(a, np.float32))


# ---------------------------------------------------------------- gating and dispatch


def _gating_pair(H, E, K, seed):
    jax_op = jm.MojoMoEGating.get_backend_impl("ref")(hidden_size=H, num_experts=E, top_k=K,
                                                      key=jax.random.PRNGKey(seed))
    ops = port_ops(tm.MojoMoEGating, H, E, K, device="cpu")
    for op in ops.values():
        op.gate_weight.data.copy_(t32(jax_op.gate_weight))
    return jax_op, ops


@pytest.mark.parametrize("H,E,K", [(8, 6, 3), (64, 16, 4), (32, 8, 8)])
def test_gating_matches_jax(H, E, K):
    jax_op, ops = _gating_pair(H, E, K, seed=H)
    x = randn(0, (9, H))
    idx_j, gates_j = jax_op(jnp.asarray(x))
    for tier, op in ops.items():
        idx, gates = op(torch.from_numpy(x))
        assert idx.dtype == torch.int32 and gates.dtype == torch.float32, tier
        np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))
        check_tol_diff(gates, np.asarray(gates_j), atol=1e-6, rtol=1e-6)
        check_tol_diff(gates.sum(-1), np.ones(9, np.float32), atol=1e-6, rtol=1e-6)


def test_gating_fp32_math_under_bf16_input():
    jax_op, ops = _gating_pair(64, 4, 2, seed=1)
    x = randn(0, (6, 64))
    idx_j16, gates_j16 = jax_op(jnp.asarray(x).astype(jnp.bfloat16))
    for op in ops.values():
        i32, g32 = op(torch.from_numpy(x))
        i16, g16 = op(torch.from_numpy(x).bfloat16())
        assert g16.dtype == torch.float32
        np.testing.assert_array_equal(i32.numpy(), i16.numpy())
        check_tol_diff(g16, g32, atol=2e-2, rtol=0.0)
        np.testing.assert_array_equal(i16.numpy(), np.asarray(idx_j16))
        check_tol_diff(g16, np.asarray(gates_j16), atol=1e-6, rtol=1e-6)


def _routed(T, H, E, K, seed):
    jax_gate, ops = _gating_pair(H, E, K, seed)
    x = randn(seed + 1, (T, H))
    idx, gates = jax_gate(jnp.asarray(x))
    return x, np.array(idx), np.array(gates)


@pytest.mark.parametrize("T,E,K", [(5, 3, 2), (12, 8, 3), (1, 4, 4)])
def test_dispatch_matches_jax(T, E, K):
    x, idx, gates = _routed(T, 8, E, K, seed=T)
    want = jm.MojoMoEDispatch.get_backend_impl("ref")(num_experts=E)(
        jnp.asarray(x), jnp.asarray(gates), jnp.asarray(idx))
    for tier, op in port_ops(tm.MojoMoEDispatch, E).items():
        sorted_h, per_expert, sorted_g, tok_idx = op(
            torch.from_numpy(x), torch.from_numpy(gates), torch.from_numpy(idx))
        assert per_expert.dtype == torch.int32 and tok_idx.dtype == torch.int32, tier
        np.testing.assert_array_equal(per_expert.numpy(), np.asarray(want[1]))
        starts = np.concatenate([[0], np.cumsum(per_expert.numpy())])
        for e in range(E):  # buckets as sets: the within-bucket order is not part of the contract
            got_tokens = set(tok_idx.numpy()[starts[e]:starts[e + 1]].tolist())
            assert got_tokens == {t for t in range(T) if e in idx[t]}, (tier, e)
        np.testing.assert_array_equal(sorted_h.numpy(), x[tok_idx.numpy()])
        np.testing.assert_array_equal(tok_idx.numpy(), np.asarray(want[3]))  # stable sorts agree
        check_tol_diff(sorted_g, np.asarray(want[2]), atol=0.0, rtol=0.0)


@pytest.mark.parametrize("T,E,K", [(6, 5, 2), (9, 16, 4)])
def test_dispatch_combine_roundtrip_is_identity(T, E, K):
    """Identity experts: combine(dispatch(x)) == x, since the gates sum to 1."""
    x, idx, gates = _routed(T, 8, E, K, seed=2 * T)
    for dispatch, combine in zip(port_ops(tm.MojoMoEDispatch, E).values(), port_ops(tm.MojoMoECombine).values()):
        sorted_h, _, sorted_g, tok_idx = dispatch(torch.from_numpy(x), torch.from_numpy(gates),
                                                  torch.from_numpy(idx))
        out = combine(torch.zeros(T, 8), sorted_h, sorted_g, tok_idx)
        check_tol_diff(out, x, **F32)


def test_combine_matches_jax_scatter_add():
    T, E, K, H = 7, 6, 3, 16
    x, idx, gates = _routed(T, H, E, K, seed=11)
    _, _, sorted_g, tok_idx = jm.MojoMoEDispatch.get_backend_impl("ref")(num_experts=E)(
        jnp.asarray(x), jnp.asarray(gates), jnp.asarray(idx))
    expert_out = randn(12, (T * K, H))
    want = jm.MojoMoECombine.get_backend_impl("ref")()(jnp.zeros((T, H)), jnp.asarray(expert_out), sorted_g, tok_idx)
    for op in port_ops(tm.MojoMoECombine).values():
        got = op(torch.zeros(T, H), torch.from_numpy(expert_out), t32(sorted_g),
                 torch.from_numpy(np.array(tok_idx)))
        check_tol_diff(got, np.asarray(want), **F32)
    with pytest.raises(ValueError, match="whole number per token"):
        op(torch.zeros(T + 1, H), torch.from_numpy(expert_out), t32(sorted_g), torch.from_numpy(np.array(tok_idx)))


# ---------------------------------------------------------------- grouped GEMM


GMM_CASES = {
    "4_groups_one_empty": ((100, 0, 412, 512), 128, 256),
    "M8_under_24": ((3, 0, 5), 64, 48),
    "M7_ragged": ((5, 0, 2), 40, 24),
    "one_row_groups": ((1, 1, 0, 1), 16, 32),
}


@pytest.mark.parametrize("trans_weight", [False, True], ids=["GKN", "GNK"])
@pytest.mark.parametrize("case", sorted(GMM_CASES))
def test_group_gemm_matches_jax(case, trans_weight):
    counts, K, N = GMM_CASES[case]
    G, M = len(counts), sum(counts)
    w = randn(0, (G, N, K) if trans_weight else (G, K, N), scale=0.1)
    x = randn(1, (M, K))
    gl = np.asarray(counts, np.int32)
    want = jm.MojoGroupGemm.get_backend_impl("ref")(jnp.asarray(w), trans_weight=trans_weight)(
        jnp.asarray(x), jnp.asarray(gl))
    kernels.reset_launch_counts()
    for tier, op in port_ops(tm.MojoGroupGemm, torch.from_numpy(w), trans_weight=trans_weight).items():
        got = op(torch.from_numpy(x), torch.from_numpy(gl))
        assert got.shape == (M, N) and got.dtype == torch.float32, tier
        check_tol_diff(got, np.asarray(want), **F32)
    assert kernels.launch_counts()["group_gemm"] == 0  # CPU tensors: the plain version


def test_group_gemm_bf16_matches_jax():
    counts, K, N = (100, 0, 412, 512), 128, 256
    w = randn(2, (4, N, K), scale=0.1)
    x = randn(3, (sum(counts), K))
    gl = np.asarray(counts, np.int32)
    want = jm.MojoGroupGemm.get_backend_impl("ref")(jnp.asarray(w, jnp.bfloat16), trans_weight=True)(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(gl))
    want = np.asarray(want.astype(jnp.float32))
    for op in port_ops(tm.MojoGroupGemm, torch.from_numpy(w).bfloat16(), trans_weight=True).values():
        got = op(torch.from_numpy(x).bfloat16(), torch.from_numpy(gl))
        assert got.dtype == torch.bfloat16
        # one bf16 step of the output; near zero, fp32 sums in another order round to other bf16 values
        check_tol_diff(got, want, atol=2**-8, rtol=2**-7)


@pytest.fixture()
def _interpret(monkeypatch):
    monkeypatch.setenv("MOJO_PALLAS_INTERPRET", "1")


@pytest.mark.usefixtures("_interpret")
def test_group_gemm_against_pallas_kernel():
    """JAX's Pallas kernel in interpret mode, at a geometry it tiles (K %
    128, N % 128, M % 8, M >= 24), on the experts' (G, N, K) layout."""
    counts, K, N = (256, 0, 384), 128, 256
    w = randn(4, (3, N, K), scale=0.1)
    x = randn(5, (sum(counts), K))
    gl = np.asarray(counts, np.int32)
    want = jm.MojoGroupGemm.get_backend_impl("pallas")(jnp.asarray(w), trans_weight=True)(
        jnp.asarray(x), jnp.asarray(gl))
    for op in port_ops(tm.MojoGroupGemm, torch.from_numpy(w), trans_weight=True).values():
        check_tol_diff(op(torch.from_numpy(x), torch.from_numpy(gl)), np.asarray(want), atol=2e-4, rtol=2e-4)


def test_group_gemm_rows_past_the_groups_are_zero():
    w, x = torch.from_numpy(randn(6, (2, 8, 16))), torch.from_numpy(randn(7, (6, 8)))
    for op in port_ops(tm.MojoGroupGemm, w).values():
        out = op(x, torch.tensor([1, 3], dtype=torch.int32))
        assert torch.equal(out[4:], torch.zeros(2, 16))
        check_tol_diff(out[1:4], x[1:4] @ w[1], **F32)
        with pytest.raises(ValueError, match="one count per group"):
            op(x, torch.tensor([6], dtype=torch.int32))


# ---------------------------------------------------------------- experts and the MoE block


def _jax_moe(E, K, H, I, seed):
    return jm.MojoMoE.get_backend_impl("ref")(E, K, H, I, key=jax.random.PRNGKey(seed))


def _carry_moe(port, jax_moe):
    port.gating.gate_weight.data.copy_(t32(jax_moe.gating.gate_weight))
    port.experts.up_proj_weight.data.copy_(t32(jax_moe.experts.up_proj_weight))
    port.experts.down_proj_weight.data.copy_(t32(jax_moe.experts.down_proj_weight))
    return port


@pytest.mark.parametrize("counts", [(4, 0, 7, 1), (0, 0, 5, 0), (2, 2, 2, 2)])
def test_experts_match_jax(counts):
    E, H, I = 4, 16, 24
    jax_experts = jm.MojoExperts.get_backend_impl("ref")(E, H, I, key=jax.random.PRNGKey(3))
    x = randn(8, (sum(counts), H))
    gl = np.asarray(counts, np.int32)
    want = jax_experts(jnp.asarray(x), jnp.asarray(gl))
    for tier, op in port_ops(tm.MojoExperts, E, H, I, device="cpu").items():
        op.up_proj_weight.data.copy_(t32(jax_experts.up_proj_weight))
        op.down_proj_weight.data.copy_(t32(jax_experts.down_proj_weight))
        got = op(torch.from_numpy(x), torch.from_numpy(gl))
        check_tol_diff(got, np.asarray(want), **F32)


@pytest.mark.parametrize("E,K,T", [(4, 2, 7), (8, 3, 12), (2, 1, 5), (6, 6, 3)])
def test_moe_matches_jax(E, K, T):
    H, I = 16, 32
    jax_moe = _jax_moe(E, K, H, I, seed=E)
    x = randn(9, (T, H))
    want = np.asarray(jax_moe(jnp.asarray(x)))
    for tier, port in port_ops(tm.MojoMoE, E, K, H, I, device="cpu").items():
        assert type(port.experts).__name__ == ("CudaExperts" if tier == "cuda" else "RefExperts")
        got = _carry_moe(port, jax_moe)(torch.from_numpy(x))
        check_tol_diff(got, want, **F32)


def test_moe_refuses_expert_parallelism():
    """Expert parallelism is ported (tests/test_torch_parallel_moe.py): a rank
    of two holds half the experts; what cannot be laid out (more ranks than
    experts, a rank outside the group) is refused."""
    moe = tm.MojoMoE(4, 2, 8, 16, ep_size=2, ep_rank=1, device="cpu")
    assert (moe.ep_start, moe.ep_end, moe.experts.up_proj_weight.shape[0]) == (2, 4, 2)
    with pytest.raises(ValueError, match="expert parallelism"):
        tm.MojoMoE(4, 2, 8, 16, ep_size=8, device="cpu")
    with pytest.raises(ValueError, match="expert parallelism"):
        tm.MojoMoE(4, 2, 8, 16, ep_size=2, ep_rank=2, device="cpu")


# ---------------------------------------------------------------- the Qwen3-MoE model


TINY = dict(
    hidden_size=64, intermediate_size=128, num_attention_heads=4, num_key_value_heads=2,
    num_hidden_layers=2, head_dim=16, vocab_size=128, max_position_embeddings=128,
    num_experts=8, num_experts_per_tok=2, moe_intermediate_size=32,
)
LENS = np.array([5, 17, 1], np.int32)
BLOCK = 16
STEPS = 8


@pytest.fixture(scope="module", params=["NHD", "HND"])
def pair(request):
    """(JAX model, port model with the JAX weights, layout)."""
    layout = request.param
    jax_model = JaxQwen3Moe(JaxQwen3MoeConfig(**TINY, dtype=jnp.float32, kv_layout=layout),
                            key=jax.random.PRNGKey(7))
    port = Qwen3MoeForCausalLM(Qwen3MoeConfig(**TINY, dtype=torch.float32, kv_layout=layout), device="cpu")
    load_numpy_state(port, state_dict_of(jax_model))
    return jax_model, port, layout


def _prompt():
    return np.random.default_rng(0).integers(1, TINY["vocab_size"], int(LENS.sum())).astype(np.int32)


def test_state_dict_keys_match_jax(pair):
    jax_model, port, _ = pair
    state = state_dict_of(jax_model)
    assert set(port.state_dict()) == {k for k in state if not k.endswith("inv_freq")}
    assert port.state_dict()["layers.0.mlp.gating.gate_weight"].dtype == torch.float32
    mc = port.config.model_config
    assert (mc.moe_expert_num, mc.moe_topk, mc.moe_ffn_internal_dim) == (8, 2, 32)


def test_load_numpy_state_is_strict(pair):
    jax_model, port, _ = pair
    state = dict(state_dict_of(jax_model))
    state.pop("layers.1.mlp.experts.down_proj_weight")
    with pytest.raises(KeyError, match="down_proj_weight"):
        load_numpy_state(port, state)


@pytest.mark.parametrize("tier", ["ref", "cuda"])
def test_prefill_logits_match_jax(pair, tier, monkeypatch):
    jax_model, port, layout = pair
    if tier == "ref":  # the same weights in a model built on the golden tier
        monkeypatch.setenv("MOJO_BACKEND", "ref")
        ref_port = Qwen3MoeForCausalLM(Qwen3MoeConfig(**TINY, dtype=torch.float32, kv_layout=layout), device="cpu")
        ref_port.load_state_dict(port.state_dict())
        port = ref_port
    assert type(port.layers[0].mlp.experts).__name__ == ("RefExperts" if tier == "ref" else "CudaExperts")
    ids = _prompt()
    logits_j, session_j = JaxPaged(jax_model, block_size=BLOCK, jit=False)(ids, context_input_len=LENS)
    logits_t, session_t = PagedAttentionGenerationModel(port, block_size=BLOCK)(ids, context_input_len=LENS)
    assert logits_t.shape == (len(LENS), TINY["vocab_size"]) and logits_t.dtype == torch.float32
    check_tol_diff(logits_t, np.asarray(logits_j), atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(session_t.block_tables, session_j.block_tables)


@pytest.fixture(scope="module")
def jax_stepwise(pair):
    """JAX's stepwise greedy stream: the reference for the port's stepwise
    and fused streams alike (JAX's own jitted window is not)."""
    jax_model = pair[0]
    return np.asarray(JaxGenerator(JaxPaged(jax_model, block_size=BLOCK, jit=False), None, JaxGreedy(),
                                   max_new_tokens=STEPS).generate_from_ids(_prompt(), LENS, ignore_eos=True,
                                                                           silent=True))


@pytest.mark.parametrize("fused", [False, True], ids=["stepwise", "fused"])
def test_greedy_tokens_match_jax(pair, jax_stepwise, fused):
    _, port, _ = pair
    kernels.reset_launch_counts()
    got = MojoGenerator(PagedAttentionGenerationModel(port, block_size=BLOCK), None, GreedySampler(),
                        max_new_tokens=STEPS).generate_from_ids(_prompt(), LENS, ignore_eos=True, fused_decode=fused)
    assert got.shape == (len(LENS), STEPS)
    np.testing.assert_array_equal(got, jax_stepwise)
    assert kernels.launch_counts()["group_gemm"] == 0


def test_continuous_batching_equals_standalone_greedy(pair):
    _, port, _ = pair
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, TINY["vocab_size"], n).astype(np.int32) for n in (5, 19, 2, 11)]
    want = [MojoGenerator(PagedAttentionGenerationModel(port, block_size=BLOCK), None, GreedySampler(),
                          max_new_tokens=6).generate_from_ids(p, [p.size], ignore_eos=True)[0] for p in prompts]
    server = ContinuousBatchingGenerator(port, batch_slots=2, block_size=BLOCK, max_new_tokens=6)
    rids = [server.submit(p) for p in prompts]
    results = server.run()
    for rid, w in zip(rids, want):
        np.testing.assert_array_equal(results[rid], w)


def test_quantized_moe_is_refused_and_device_is_explicit():
    """Once refused, the quantized modes now build (tests/test_torch_quant_moe.py holds them to JAX): on the CPU
    when asked, on the card otherwise, which a machine without one refuses."""
    for quant in ("w8a8", "w4a8"):
        model = Qwen3MoeForCausalLM(Qwen3MoeConfig(**TINY, dtype=torch.float32, quant=quant), device="cpu")
        experts = model.layers[0].mlp.experts
        assert type(experts).__name__ == "CudaQuantExperts" and experts.up_proj_weight.device.type == "cpu"
        assert experts.up_weight_dtype == ("int4" if quant == "w4a8" else torch.int8)
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="device='cpu'"):
                Qwen3MoeForCausalLM(Qwen3MoeConfig(**TINY, dtype=torch.float32, quant=quant))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Qwen3MoeForCausalLM(Qwen3MoeConfig(**TINY, dtype=torch.float32))


def test_random_init_follows_jax_distributions():
    cfg = Qwen3MoeConfig(**TINY, dtype=torch.float32)
    model = Qwen3MoeForCausalLM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    twin = Qwen3MoeForCausalLM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    for (name, a), b in zip(model.state_dict().items(), twin.state_dict().values()):
        assert torch.equal(a, b), name
    mlp = model.layers[0].mlp
    assert mlp.experts.up_proj_weight.abs().max() <= 1 / np.sqrt(TINY["hidden_size"])
    assert mlp.experts.down_proj_weight.abs().max() <= 1 / np.sqrt(TINY["moe_intermediate_size"])
    assert 0.015 < mlp.gating.gate_weight.std().item() < 0.025
