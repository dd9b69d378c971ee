"""Port parity for w4a8 serving: packed-int4 weights, kernel G's plain
version, and the w4a8 Qwen3 model.

The same numpy inputs go through the JAX package (its ``ref`` tier, and
``pallas`` in interpret mode where it reaches ``int4_matmul.py``) and
through both tiers of the port on the CPU, where the ``cuda`` tier runs
kernel G's plain version.

Tolerances, and why:
  * packing, unpacking and the quantized int4 bytes: bit-equal;
  * weight scales: rtol 1e-6 (one fp32 absmax and division);
  * the int4 GEMM: exactly equal with unit scales and fp32 output (exact
    int32 sums), rtol 1e-6 with real scales (one fp32 epilogue in the same
    order);
  * the model: prefill logits to atol = rtol = 2e-3, as for w8a8 (a tie at
    a quant point moves one int8 activation by one step); greedy tokens
    equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mojo_opset_tpu as jm
import mojo_opset_tpu_torch as tm
from mojo_opset_tpu.core.operators.gemm import pack_int4_rows as jax_pack
from mojo_opset_tpu.core.operators.gemm import unpack_int4_rows as jax_unpack
from mojo_opset_tpu.modeling.qwen3 import Qwen3Config as JaxQwen3Config
from mojo_opset_tpu.modeling.qwen3 import Qwen3ForCausalLM as JaxQwen3
from mojo_opset_tpu.modeling.qwen3 import quantize_qwen3 as jax_quantize_qwen3
from mojo_opset_tpu.modeling.qwen3.quantize import quantize_linear_weight as jax_quantize_linear_weight
from mojo_opset_tpu.runtime import GreedySampler as JaxGreedy
from mojo_opset_tpu.runtime import MojoGenerator as JaxGenerator
from mojo_opset_tpu.runtime import PagedAttentionGenerationModel as JaxPaged
from mojo_opset_tpu.utils.hf import state_dict_of
from mojo_opset_tpu_torch.backends.cuda import kernels
from mojo_opset_tpu_torch.backends.cuda.kernels import int4_matmul
from mojo_opset_tpu_torch.core.operators.gemm import pack_int4_rows, unpack_int4_rows
from mojo_opset_tpu_torch.modeling.qwen3 import Qwen3Config, Qwen3ForCausalLM, quantize_linear_weight, quantize_qwen3
from mojo_opset_tpu_torch.runtime import GreedySampler, MojoGenerator, PagedAttentionGenerationModel
from mojo_opset_tpu_torch.utils.acc import check_tol_diff
from mojo_opset_tpu_torch.utils.weights import load_numpy_state


def port_ops(core, *args, **kwargs):
    return [core.get_backend_impl(t, strict=True)(*args, **kwargs) for t in core.get_registered_backends()]


# ---------------------------------------------------------------- packing


@pytest.mark.parametrize("NK", [(128, 16), (256, 48), (384, 40)])
def test_pack_unpack_bit_equal_to_jax(NK):
    rng = np.random.default_rng(40)
    w = rng.integers(-8, 8, NK).astype(np.int8)
    w[0, :2] = (-8, 7)  # the range's ends, in a low nibble ...
    w[64, :2] = (7, -8)  # ... and in the high nibble of the same packed row
    want = np.asarray(jax_pack(jnp.asarray(w)))
    got = pack_int4_rows(torch.from_numpy(w))
    assert got.dtype == torch.int8 and got.shape == (NK[0] // 2, NK[1])
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(unpack_int4_rows(got).numpy(), w)
    np.testing.assert_array_equal(np.asarray(jax_unpack(jnp.asarray(want))), w)
    # nibble order: packed row r holds channel r low and channel 64 + r high
    p = int(got[0, 0]) & 0xFF
    assert (p & 15, p >> 4) == (8, 7)


def test_pack_needs_whole_groups():
    with pytest.raises(ValueError, match="N % 128"):
        pack_int4_rows(torch.zeros(64, 16, dtype=torch.int8))


@pytest.mark.parametrize("weight_dtype", ["int4", "int8"])
def test_quantize_linear_weight_matches_jax(weight_dtype):
    rng = np.random.default_rng(41)
    w = (rng.standard_normal((256, 96)) * 0.05).astype(np.float32)
    w[3] = 0.0  # a zero row takes the 1e-8 floor
    q_j, s_j = jax_quantize_linear_weight(jnp.asarray(w), weight_dtype)
    q_t, s_t = quantize_linear_weight(torch.from_numpy(w), weight_dtype)
    assert q_t.dtype == torch.int8 and q_t.shape == tuple(q_j.shape)
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    check_tol_diff(s_t, np.asarray(s_j), atol=0.0, rtol=1e-6)


# ---------------------------------------------------------------- the int4 GEMM


def _int4_case(seed, M, K, N, unit):
    rng = np.random.default_rng(seed)
    packed = rng.integers(-128, 128, (N // 2, K)).astype(np.int8)
    x = rng.integers(-128, 128, (M, K)).astype(np.int8)
    ws = np.ones(N, np.float32) if unit else rng.uniform(0.5, 2, N).astype(np.float32)
    xs = np.ones(M, np.float32) if unit else rng.uniform(0.01, 0.1, M).astype(np.float32)
    return packed, ws, x, xs


def _check_int4_gemm(jax_tier, M, K, N, unit):
    packed, ws, x, xs = _int4_case(42, M, K, N, unit)
    op_j = jm.MojoQuantGemm.get_backend_impl(jax_tier, strict=True)(
        K, N, output_dtype=jnp.float32, trans_weight=True, weight_dtype="int4")
    want = op_j.replace(weight=jnp.asarray(packed), weight_scale=jnp.asarray(ws))(jnp.asarray(x), jnp.asarray(xs))
    ops = port_ops(tm.MojoQuantGemm, K, N, output_dtype=torch.float32, trans_weight=True, weight_dtype="int4",
                   device="cpu")
    assert [type(op).__name__ for op in ops] == ["CudaQuantGemm", "RefQuantGemm"]
    kernels.reset_launch_counts()
    for op in ops:
        assert op.weight.shape == (N // 2, K) and op.weight.dtype == torch.int8
        op.weight.copy_(torch.from_numpy(packed))
        op.weight_scale.copy_(torch.from_numpy(ws))
        got = op(torch.from_numpy(x), torch.from_numpy(xs))
        check_tol_diff(got, np.asarray(want), atol=0.0, rtol=0.0 if unit else 1e-6)
    assert set(kernels.launch_counts().values()) == {0}  # CPU tensors: the plain versions


@pytest.mark.parametrize("unit", [True, False], ids=["unit_scales", "scales"])
@pytest.mark.parametrize("M", [1, 5, 8, 64])
def test_int4_quant_gemm(M, unit):
    _check_int4_gemm("ref", M, 96, 256, unit)


@pytest.fixture()
def _interpret(monkeypatch):
    monkeypatch.setenv("MOJO_PALLAS_INTERPRET", "1")


@pytest.mark.usefixtures("_interpret")
def test_int4_quant_gemm_against_pallas_kernel():
    # K % 128 == 0: the JAX tier reaches int4_matmul.py (M padded to 8 there)
    _check_int4_gemm("pallas", 5, 128, 256, False)


def test_int4_plain_version_is_unpack_then_int8_golden():
    packed, ws, x, xs = _int4_case(43, 7, 64, 128, False)
    args = [torch.from_numpy(a) for a in (x, packed, xs, ws)]
    got = int4_matmul.int4_scaled_matmul(*args, torch.bfloat16)
    want = tm.MojoQuantGemm.get_backend_impl("ref")(64, 128, trans_weight=True, device="cpu")
    want.weight.copy_(unpack_int4_rows(args[1]))
    want.weight_scale.copy_(args[3])
    assert got.dtype == torch.bfloat16
    check_tol_diff(got, want(args[0], args[2]), atol=0.0, rtol=0.0)


def test_int4_kernel_wrapper_rejects_what_the_kernel_does_not_take():
    meta = lambda *shape, dtype=torch.int8: torch.empty(shape, device="meta", dtype=dtype)  # noqa: E731
    f32 = torch.float32
    with pytest.raises(ValueError, match="N % 128"):
        int4_matmul.int4_scaled_matmul(meta(4, 64), meta(32, 64), meta(4, dtype=f32), meta(64, dtype=f32), f32)
    with pytest.raises(ValueError, match="K % 16"):
        int4_matmul.int4_scaled_matmul(meta(4, 40), meta(64, 40), meta(4, dtype=f32), meta(128, dtype=f32), f32)
    with pytest.raises(ValueError, match="weight_scale"):
        int4_matmul.int4_scaled_matmul(meta(4, 64), meta(64, 64), meta(4, dtype=f32),
                                       meta(128, dtype=torch.bfloat16), f32)
    with pytest.raises(ValueError, match="out_features % 128"):
        tm.MojoQuantGemm(64, 192, trans_weight=True, weight_dtype="int4")
    with pytest.raises(ValueError, match="trans_weight"):
        tm.MojoQuantGemm(64, 128, weight_dtype="int4")
    assert int4_matmul.launches == 0


# ---------------------------------------------------------------- the model


TINY = dict(
    hidden_size=128, intermediate_size=256, num_attention_heads=4, num_key_value_heads=2,
    num_hidden_layers=2, head_dim=32, vocab_size=256, max_position_embeddings=128,
)
LENS = np.array([5, 17, 1], np.int32)
BLOCK = 16
STEPS = 8


class Tok:
    eos_token_id = 0


@pytest.fixture(scope="module")
def w4a8_pair():
    """(JAX w4a8 model, port fp32 base with the JAX weights, port w4a8
    model with the JAX packed weights)."""
    base_j = JaxQwen3(JaxQwen3Config(**TINY, dtype=jnp.float32), key=jax.random.PRNGKey(9))
    qm_j = jax_quantize_qwen3(base_j, weight_dtype="int4")
    base_t = Qwen3ForCausalLM(Qwen3Config(**TINY, dtype=torch.float32), device="cpu")
    load_numpy_state(base_t, state_dict_of(base_j))
    qm_t = Qwen3ForCausalLM(Qwen3Config(**TINY, dtype=torch.float32, quant="w4a8"), device="cpu")
    load_numpy_state(qm_t, state_dict_of(qm_j))
    return qm_j, base_t, qm_t


def _prompt():
    return np.random.default_rng(0).integers(1, TINY["vocab_size"], int(LENS.sum())).astype(np.int32)


def test_w4a8_layout_and_quantize_match_jax(w4a8_pair):
    qm_j, base_t, qm_t = w4a8_pair
    attn, mlp = qm_t.model.layers[0].self_attn, qm_t.model.layers[0].mlp
    # widths of whole 128-channel groups pack int4; k/v (2 x 32 = 64) stay int8, as in JAX
    assert [p.weight_dtype for p in (attn.q_proj, attn.o_proj, mlp.gate_proj, mlp.up_proj, mlp.down_proj)] == ["int4"] * 5
    assert attn.k_proj.weight_dtype == attn.v_proj.weight_dtype == torch.int8 == qm_t.lm_head.weight_dtype
    assert attn.q_proj.weight.shape == (64, 128) and attn.k_proj.weight.shape == (64, 128)
    assert type(qm_t.model.layers[0].input_layernorm).__name__ == "CudaRMSNormQuant"
    mine = quantize_qwen3(base_t, weight_dtype="int4").state_dict()
    want = state_dict_of(qm_j)
    assert set(mine) == {k for k in want if not k.endswith("inv_freq")} == set(qm_t.state_dict())
    for name, t in mine.items():
        if t.dtype == torch.int8:
            np.testing.assert_array_equal(t.numpy(), np.asarray(want[name]), err_msg=name)
        else:
            check_tol_diff(t, np.asarray(want[name]), atol=0.0, rtol=1e-6)


def test_w4a8_prefill_logits_match_jax(w4a8_pair):
    qm_j, _, qm_t = w4a8_pair
    ids = _prompt()
    logits_j, _ = JaxPaged(qm_j, block_size=BLOCK, jit=False)(ids, context_input_len=LENS)
    logits_t, _ = PagedAttentionGenerationModel(qm_t, block_size=BLOCK)(ids, context_input_len=LENS)
    check_tol_diff(logits_t, np.asarray(logits_j), atol=2e-3, rtol=2e-3)


@pytest.mark.parametrize("fused", [False, True], ids=["stepwise", "fused"])
def test_w4a8_greedy_tokens_match_jax(w4a8_pair, fused):
    """Both of the port's streams are held to JAX's stepwise stream: JAX's
    jitted FusedDecode window, run from the persistent XLA:CPU cache under
    several workers, is not a stable reference (ROADMAP.md, queue 3). The
    fused case also holds the port's window to the port's stepwise loop."""
    qm_j, _, qm_t = w4a8_pair
    ids = _prompt()
    want = JaxGenerator(JaxPaged(qm_j, block_size=BLOCK, jit=False), Tok(), JaxGreedy(),
                        max_new_tokens=STEPS).generate_from_ids(ids, LENS, ignore_eos=True, silent=True)

    def port_stream(fused_decode):
        return MojoGenerator(PagedAttentionGenerationModel(qm_t, block_size=BLOCK), Tok(), GreedySampler(),
                             max_new_tokens=STEPS).generate_from_ids(ids, LENS, ignore_eos=True,
                                                                     fused_decode=fused_decode)

    got = port_stream(fused)
    assert got.shape == (len(LENS), STEPS)
    np.testing.assert_array_equal(got, np.asarray(want))
    if fused:
        np.testing.assert_array_equal(got, port_stream(False))
