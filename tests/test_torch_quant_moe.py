"""Port parity for the quantized MoE path: the MoE quant ops, the experts'
int4 layout, kernel R's plain version, ``MojoQuantExperts`` and
``MojoQuantMoE``, and the w8a8 / w4a8 Qwen3-MoE model of
mojo_opset_tpu_torch against mojo_opset_tpu, on the CPU; and kernel R's
launch plan on ``meta`` tensors.

The same numpy inputs (``np.random.default_rng``) go through the JAX op
(its ``ref`` tier, and its ``xla`` tier where one exists) and through both
tiers of the port, where the ``cuda`` tier runs kernel R's plain version.

Tolerances, and why (as tests/test_torch_quant.py):
  * the quant ops: scales to rtol 1e-6 (one fp32 algorithm); int8 values
    off by at most 1 on at most 0.1% of the elements, since a product in
    another order can move a value across a rounding tie;
  * kernel R's plain version against JAX's ``_ragged_quant_linear``: fp32
    output to rtol 1e-6 (exact int32 sums; the epilogue's two products in
    another order); against the port's golden product bit for bit;
  * the experts and the MoE block: fp32 to atol = rtol = 1e-5 against
    JAX's golden (the same algorithm), bf16 on the bf16 ladder
    (``utils/acc.py``). JAX's xla tier formulates the stages otherwise: it
    multiplies the scales in another order and keeps fc1 in fp32, and it
    rounds the activation to the input dtype before the down quant. So
    against it the outputs are held relative to their size,
    ||got - want|| / ||want||: in fp32 to 5e-3 (an fc1 value one ulp apart
    can move an activation across an int8 rounding tie, one step of one
    term of a sum; seen <= 1.2e-7), in bf16 to 2e-2 (the bf16 rounding moves
    a share of the activations by an int8 step; seen 5.6e-3 to 6.9e-3).
  * the model: prefill logits to atol = rtol = 2e-3 (a tie at a quant point
    moves one int8 value by one step); greedy tokens equal JAX's stepwise
    stream, except where JAX's two best logits lie within 0.05 (a near-tie,
    ROADMAP.md queue 3's remembered property).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mojo_opset_tpu as jm
import mojo_opset_tpu.experimental.operators as jx
from mojo_opset_tpu.backends.xla.operators.moe import XlaQuantExperts
from mojo_opset_tpu.core.operators.moe import unpack_int4 as jax_unpack_int4
from mojo_opset_tpu.core.operators.quantize import _repeat_by_counts as jax_repeat_by_counts
from mojo_opset_tpu.modeling.qwen3 import Qwen3MoeConfig as JaxQwen3MoeConfig
from mojo_opset_tpu.modeling.qwen3 import Qwen3MoeForCausalLM as JaxQwen3Moe
from mojo_opset_tpu.modeling.qwen3 import quantize_qwen3_moe as jax_quantize_qwen3_moe
from mojo_opset_tpu.modeling.qwen3.quantize import pack_int4 as jax_pack_int4
from mojo_opset_tpu.modeling.qwen3.quantize import quantize_expert_weight as jax_quantize_expert_weight
from mojo_opset_tpu.runtime import GreedySampler as JaxGreedy
from mojo_opset_tpu.runtime import MojoGenerator as JaxGenerator
from mojo_opset_tpu.runtime import PagedAttentionGenerationModel as JaxPaged
from mojo_opset_tpu.utils.hf import state_dict_of
import mojo_opset_tpu_torch as tm
from mojo_opset_tpu_torch.backends.cuda import build, kernels
from mojo_opset_tpu_torch.backends.cuda.kernels import group_quant_gemm
from mojo_opset_tpu_torch.backends.cuda.operators import CudaQuantExperts
from mojo_opset_tpu_torch.core.operators.gemm import pack_int4_rows
from mojo_opset_tpu_torch.core.operators.moe import grouped_quant_matmul_reference
from mojo_opset_tpu_torch.core.operators.quantize import repeat_by_counts
from mojo_opset_tpu_torch.modeling.qwen3 import (
    Qwen3MoeConfig,
    Qwen3MoeForCausalLM,
    pack_int4,
    quantize_expert_weight,
    quantize_qwen3_moe,
)
from mojo_opset_tpu_torch.runtime import (
    ContinuousBatchingGenerator,
    GeneratorHook,
    GreedySampler,
    MojoGenerator,
    PagedAttentionGenerationModel,
)
from mojo_opset_tpu_torch.utils.acc import check_tol_diff, tols_for
from mojo_opset_tpu_torch.utils.weights import load_numpy_state

F32 = dict(atol=1e-5, rtol=1e-5)
XLA_TIER_REL = {"float32": 5e-3, "bfloat16": 2e-2}
TIE_GAP = 0.05
COUNT_CASES = [(4, 0, 7, 1), (0, 0, 5, 0), (1, 1, 1, 1), (3, 129, 0, 7)]


def port_ops(core, *args, **kwargs):
    return {t: core.get_backend_impl(t, strict=True)(*args, **kwargs) for t in core.get_registered_backends()}


def assert_int8_close(got, want, frac=1e-3):
    """Off by at most one step, on at most ``frac`` of the elements."""
    diff = np.abs(np.asarray(got, np.int32) - np.asarray(want, np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() <= frac, (diff.max(), (diff > 0).mean())


def t(a):
    return torch.from_numpy(np.array(a))


def assert_rel(got, want, bound):
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel <= bound, (rel, bound)


# ---------------------------------------------------------------- the quant ops


@pytest.mark.parametrize("rows", [16, 19], ids=["covered", "rows-past-the-end"])
def test_repeat_by_counts_matches_jax(rows):
    values = np.random.default_rng(0).standard_normal((4, 6)).astype(np.float32)
    counts = np.array([3, 0, 9, 4], np.int32)
    want = np.asarray(jax_repeat_by_counts(jnp.asarray(values), jnp.asarray(counts), rows))
    np.testing.assert_array_equal(repeat_by_counts(t(values), t(counts), rows).numpy(), want)


@pytest.mark.parametrize("counts", [(4, 0, 7, 1), (0, 0, 5, 0), (0, 6, 0, 0)])
def test_moe_dynamic_quant_matches_jax(counts):
    rng = np.random.default_rng(sum(counts))
    E, H = 4, 40
    x = rng.standard_normal((sum(counts), H)).astype(np.float32) * 3
    x[0] = 0.0  # a zero row takes scale 1
    smooth = (rng.random((E, H)) + 0.5).astype(np.float32)
    op_j = jm.MojoMoEDynamicQuant.get_backend_impl("ref")(E, H).replace(inv_smooth_scale=jnp.asarray(smooth))
    q_j, s_j = op_j(jnp.asarray(x), jnp.asarray(np.asarray(counts, np.int32)))
    for tier, op in port_ops(tm.MojoMoEDynamicQuant, E, H, device="cpu").items():
        op.inv_smooth_scale.data.copy_(t(smooth))
        q, s = op(t(x), t(np.asarray(counts, np.int32)))
        assert q.dtype == torch.int8 and s.shape == (sum(counts), 1), tier
        assert_int8_close(q.numpy(), np.asarray(q_j))
        check_tol_diff(s, np.asarray(s_j), atol=0.0, rtol=1e-6)


DSQ_CASES = {
    "plain": dict(),
    "bias-activation-scale": dict(bias=True, activation_scale=True),
    "token-count": dict(token_count=True),
    "all": dict(bias=True, activation_scale=True, token_count=True),
}


@pytest.mark.parametrize("activate_left", [False, True])
@pytest.mark.parametrize("case", list(DSQ_CASES))
def test_dequant_swiglu_quant_matches_jax(activate_left, case):
    opts = DSQ_CASES[case]
    rng = np.random.default_rng(len(case))
    E, H = 3, 24
    counts = np.array([2, 0, 5], np.int32)
    tokens = int(counts.sum()) if opts.get("token_count") else E  # without counts row r takes expert r's scales
    x = rng.integers(-2000, 2000, (tokens, 2 * H)).astype(np.float32)
    w_scale = (rng.random((E, 2 * H)) * 0.01 + 1e-3).astype(np.float32)
    q_scale = (rng.random((E, H)) + 0.5).astype(np.float32)
    args = dict(
        activation_scale=(rng.random(tokens) + 0.5).astype(np.float32) if opts.get("activation_scale") else None,
        bias=rng.standard_normal((E, 2 * H)).astype(np.float32) if opts.get("bias") else None,
        token_count=counts if opts.get("token_count") else None,
    )
    op_j = jm.MojoDequantSwiGLUQuant.get_backend_impl("ref")(E, H, activate_left=activate_left).replace(
        weight_scale=jnp.asarray(w_scale), quant_scale=jnp.asarray(q_scale))
    q_j, s_j = op_j(jnp.asarray(x), **{k: None if v is None else jnp.asarray(v) for k, v in args.items()})
    for tier, op in port_ops(tm.MojoDequantSwiGLUQuant, E, H, activate_left=activate_left, device="cpu").items():
        op.weight_scale.data.copy_(t(w_scale))
        op.quant_scale.data.copy_(t(q_scale))
        q, s = op(t(x), **{k: None if v is None else t(v) for k, v in args.items()})
        assert q.shape == (tokens, H) and q.dtype == torch.int8, tier
        assert_int8_close(q.numpy(), np.asarray(q_j))
        check_tol_diff(s, np.asarray(s_j), atol=0.0, rtol=1e-6)


@pytest.mark.parametrize("smooth", [None, "shared", "per-expert"])
def test_init_routing_dynamic_quant_matches_jax(smooth):
    rng = np.random.default_rng(3)
    T, K, E, H = 6, 2, 4, 32
    x = rng.standard_normal((T, H)).astype(np.float32)
    idx = np.argsort(rng.random((T, E)), axis=1)[:, :K].astype(np.int32)
    gates = rng.random((T, K)).astype(np.float32)
    scale = None if smooth is None else (rng.random((E, H)) + 0.5).astype(np.float32)
    if smooth == "shared":
        scale[:] = scale[0]
    want = jx.MojoMoEInitRoutingDynamicQuant.get_backend_impl("ref")(E, K)(
        jnp.asarray(x), jnp.asarray(gates), jnp.asarray(idx), None if scale is None else jnp.asarray(scale))
    for tier, op in port_ops(tm.MojoMoEInitRoutingDynamicQuant, E, K).items():
        got = op(t(x), t(gates), t(idx), None if scale is None else t(scale))
        assert_int8_close(got[0].numpy(), np.asarray(want[0]))
        for g, w in zip(got[1:4], want[1:4]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert got[2].dtype == torch.int32
        check_tol_diff(got[4], np.asarray(want[4]), atol=0.0, rtol=1e-6)


@pytest.mark.parametrize("smooth", [None, "channel", "per-expert"])
@pytest.mark.parametrize("beta", [1.0, 1.7])
def test_fused_swiglu_scale_dynamic_quantize_matches_jax(smooth, beta):
    rng = np.random.default_rng(4)
    T, K, H, E = 5, 2, 16, 3
    x = rng.standard_normal((T, K, 2 * H)).astype(np.float32) * 2
    counts = np.array([4, 0, 6], np.int32)
    scale = {None: None, "channel": rng.random(H) + 0.5, "per-expert": rng.random((E, H)) + 0.5}[smooth]
    scale = None if scale is None else scale.astype(np.float32)
    want = jx.MojoFusedSwiGLUMoEScaleDynamicQuantize.get_backend_impl("ref")()(
        jnp.asarray(x), None if scale is None else jnp.asarray(scale), jnp.asarray(counts), beta=beta)
    for tier, op in port_ops(tm.MojoFusedSwiGLUMoEScaleDynamicQuantize).items():
        q, s = op(t(x), None if scale is None else t(scale), t(counts), beta=beta)
        assert_int8_close(q.numpy(), np.asarray(want[0]))
        check_tol_diff(s, np.asarray(want[1]), atol=0.0, rtol=1e-6)
    with pytest.raises(ValueError, match="sums to"):
        tm.MojoFusedSwiGLUMoEScaleDynamicQuantize()(t(x), t(np.ones((E, H), np.float32)), t(counts - 1))


# ---------------------------------------------------------------- the experts' int4 layout


def test_int4_pack_and_unpack_equal_jax():
    q = np.random.default_rng(5).integers(-8, 8, (3, 256, 32)).astype(np.int8)
    packed = pack_int4(t(q))
    assert packed.shape == (3, 128, 32) and packed.dtype == torch.int8
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jax.vmap(jax_pack_int4)(jnp.asarray(q))))
    np.testing.assert_array_equal(tm.unpack_int4(packed).numpy(), q)  # round trip
    np.testing.assert_array_equal(tm.unpack_int4(packed[1]).numpy(),
                                  np.asarray(jax_unpack_int4(jnp.asarray(packed[1].numpy()))))
    # not the dense projections' 128-row blocked layout
    assert not torch.equal(packed[0], pack_int4_rows(t(q[0])))
    with pytest.raises(ValueError, match="even"):
        pack_int4(t(q[:, :3]))


@pytest.mark.parametrize("weight_dtype", ["int8", "int4"])
def test_quantize_expert_weight_matches_jax(weight_dtype, monkeypatch):
    from mojo_opset_tpu_torch.modeling.qwen3 import quantize as port_quantize

    monkeypatch.setattr(port_quantize, "EXPERT_CHUNK", 3)  # several chunks, one ragged
    w = (np.random.default_rng(6).standard_normal((8, 64, 48)) * 0.05).astype(np.float32)
    q_j, s_j = jax_quantize_expert_weight(jnp.asarray(w), weight_dtype)
    q, s = quantize_expert_weight(t(w), weight_dtype)
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_j))
    check_tol_diff(s, np.asarray(s_j), atol=0.0, rtol=1e-6)


# ---------------------------------------------------------------- kernel R's plain version


def _r_case(seed, counts, K, N, int4):
    rng = np.random.default_rng(seed)
    G, M = len(counts), int(sum(counts))
    x = rng.integers(-128, 128, (M, K)).astype(np.int8)
    w = rng.integers(-8, 8, (G, N, K)) if int4 else rng.integers(-127, 128, (G, N, K))
    w = w.astype(np.int8)
    ws = (rng.random((G, N)) * 0.01 + 1e-3).astype(np.float32)
    xs = (rng.random((M, 1)) * 0.05 + 1e-3).astype(np.float32)
    packed = pack_int4(t(w)).numpy() if int4 else w
    return x, w, packed, ws, xs, np.asarray(counts, np.int32)


@pytest.mark.parametrize("int4", [False, True], ids=["int8", "int4"])
@pytest.mark.parametrize("counts", COUNT_CASES)
def test_group_quant_gemm_plain_matches_jax_ragged(counts, int4):
    x, w, packed, ws, xs, gs = _r_case(len(counts) + sum(counts), counts, 64, 40, int4)
    gid = np.clip(np.searchsorted(np.cumsum(gs), np.arange(x.shape[0]), side="right"), 0, len(gs) - 1)
    want = XlaQuantExperts._ragged_quant_linear(jnp.asarray(x), jnp.asarray(xs), jnp.asarray(w), jnp.asarray(ws),
                                                jnp.asarray(gs), jnp.asarray(gid), -1)
    got = group_quant_gemm.grouped_quant_matmul(t(x), t(packed), t(gs), t(ws), t(xs), torch.float32, int4=int4)
    check_tol_diff(got, np.asarray(want), atol=0.0, rtol=1e-6)
    # the port's golden product, expert by expert, bit for bit
    starts = np.concatenate([[0], np.cumsum(gs)])
    for g in range(len(gs)):
        sl = slice(starts[g], starts[g + 1])
        one = tm.MojoQuantExperts._quant_linear(t(x[sl]), t(xs[sl]), t(packed[g]), t(ws[g]), torch.float32,
                                                "int4" if int4 else torch.int8)
        assert torch.equal(got[sl], one)


def test_group_quant_gemm_plain_rows_past_the_groups_are_zero():
    x, _, packed, ws, _, _ = _r_case(7, (3, 0, 9), 32, 24, False)
    xs = np.ones((15, 1), np.float32)
    x = np.concatenate([x, np.ones((3, 32), np.int8)])
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        out = grouped_quant_matmul_reference(t(x), t(packed), t(np.array([3, 0, 9], np.int32)), t(ws), t(xs), dtype)
        assert out.dtype == dtype and out.shape == (15, 24)
        assert (out[12:] == 0).all() and (out[:12] != 0).any()


# ---------------------------------------------------------------- the experts and the MoE block


def _expert_arrays(seed, E, H, I, int4, group_size=-1):
    rng = np.random.default_rng(seed)
    lo, hi = (-8, 8) if int4 else (-127, 128)
    up = rng.integers(lo, hi, (E, 2 * I, H)).astype(np.int8)
    dn = rng.integers(lo, hi, (E, H, I)).astype(np.int8)
    gdim = lambda k: () if group_size <= 0 else (-(-k // group_size),)  # noqa: E731
    return dict(
        up_proj_weight=pack_int4(t(up)).numpy() if int4 else up,
        down_proj_weight=pack_int4(t(dn)).numpy() if int4 else dn,
        up_proj_weight_scale=(rng.random((E, 2 * I, *gdim(H))) * 0.01 + 1e-3).astype(np.float32),
        down_proj_weight_scale=(rng.random((E, H, *gdim(I))) * 0.01 + 1e-3).astype(np.float32),
        up_smooth=(rng.random((E, H)) + 0.5).astype(np.float32),
        down_smooth=(rng.random((E, I)) + 0.5).astype(np.float32),
    )


def _jax_experts(jax_op, arrays):
    weights = {k: jnp.asarray(v) for k, v in arrays.items() if not k.endswith("smooth")}
    op = jax_op.replace(**weights)
    op.up_proj_quantize = op.up_proj_quantize.replace(inv_smooth_scale=jnp.asarray(arrays["up_smooth"]))
    op.down_proj_quantize = op.down_proj_quantize.replace(inv_smooth_scale=jnp.asarray(arrays["down_smooth"]))
    return op


def _carry_experts(port, arrays):
    for k, v in arrays.items():
        if k.endswith("smooth"):
            getattr(port, k.replace("smooth", "proj_quantize")).inv_smooth_scale.data.copy_(t(v))
        else:
            getattr(port, k).data.copy_(t(v))
    return port


def _wdtypes(int4):
    return dict(up_weight_dtype="int4", down_weight_dtype="int4") if int4 else {}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("int4", [False, True], ids=["w8a8", "w4a8"])
@pytest.mark.parametrize("counts", [(4, 0, 7, 1), (0, 0, 5, 0)])
def test_quant_experts_match_jax(counts, int4, dtype):
    E, H, I = 4, 32, 48
    arrays = _expert_arrays(sum(counts), E, H, I, int4)
    x = np.random.default_rng(9).standard_normal((sum(counts), H)).astype(np.float32)
    gs = np.asarray(counts, np.int32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = {tier: np.asarray(_jax_experts(jm.MojoQuantExperts.get_backend_impl(tier, strict=True)(
        E, H, I, **_wdtypes(int4)), arrays)(jnp.asarray(x).astype(jdt), jnp.asarray(gs)).astype(jnp.float32))
        for tier in ("ref", "xla")}
    for tier, op in port_ops(tm.MojoQuantExperts, E, H, I, **_wdtypes(int4), device="cpu").items():
        got = _carry_experts(op, arrays)(t(x).to(tdt), t(gs))
        assert got.dtype == tdt and got.shape == (sum(counts), H), tier
        check_tol_diff(got, want["ref"], **(F32 if dtype == "float32" else tols_for(torch.bfloat16)))
        assert_rel(got, want["xla"], XLA_TIER_REL[dtype])


def test_group_wise_scales_take_the_golden_counted():
    E, H, I, gsz = 3, 32, 48, 16
    arrays = _expert_arrays(1, E, H, I, False, group_size=gsz)
    x = np.random.default_rng(2).standard_normal((9, H)).astype(np.float32)
    gs = np.array([2, 3, 4], np.int32)
    kw = dict(up_quant_group_size=gsz, down_quant_group_size=gsz)
    want = _jax_experts(jm.MojoQuantExperts.get_backend_impl("ref")(E, H, I, **kw), arrays)(jnp.asarray(x),
                                                                                           jnp.asarray(gs))
    op = _carry_experts(tm.MojoQuantExperts(E, H, I, **kw, device="cpu"), arrays)
    assert isinstance(op, CudaQuantExperts)
    kernels.reset_launch_counts()
    before = CudaQuantExperts.golden_calls
    check_tol_diff(op(t(x), t(gs)), np.asarray(want), **F32)
    assert CudaQuantExperts.golden_calls == before + 1
    assert kernels.launch_counts()["group_quant_gemm"] == 0


@pytest.mark.parametrize("int4", [False, True], ids=["w8a8", "w4a8"])
@pytest.mark.parametrize("E,K,T", [(4, 2, 7), (8, 3, 12)])
def test_quant_moe_matches_jax(E, K, T, int4):
    H, I = 32, 64
    arrays = _expert_arrays(E + T, E, H, I, int4)
    gate = (np.random.default_rng(E).standard_normal((H, E)) * 0.3).astype(np.float32)
    x = np.random.default_rng(T).standard_normal((T, H)).astype(np.float32)
    want = {}
    for tier in ("ref", "xla"):
        moe = jm.MojoQuantMoE.get_backend_impl(tier, strict=True)(E, K, H, I, **_wdtypes(int4))
        moe.gating = moe.gating.replace(gate_weight=jnp.asarray(gate))
        moe.experts = _jax_experts(moe.experts, arrays)
        want[tier] = np.asarray(moe(jnp.asarray(x)))
    for tier, port in port_ops(tm.MojoQuantMoE, E, K, H, I, **_wdtypes(int4), device="cpu").items():
        assert type(port.experts).__name__ == ("CudaQuantExperts" if tier == "cuda" else "RefQuantExperts")
        port.gating.gate_weight.data.copy_(t(gate))
        got = _carry_experts(port.experts, arrays) and port(t(x))
        check_tol_diff(got, want["ref"], **F32)
        assert_rel(got, want["xla"], XLA_TIER_REL["float32"])


def test_quant_moe_refuses_expert_parallelism():
    """Expert parallelism is ported (tests/test_torch_parallel_moe.py): an
    uneven split gives the first rank the extra expert, scales and smooth
    scales included; more ranks than experts are refused."""
    moe = tm.MojoQuantMoE(5, 2, 32, 16, ep_size=2, ep_rank=0, device="cpu")
    assert (moe.ep_start, moe.ep_end) == (0, 3)
    assert moe.experts.up_proj_weight_scale.shape[0] == moe.experts.up_proj_quantize.inv_smooth_scale.shape[0] == 3
    with pytest.raises(ValueError, match="expert parallelism"):
        tm.MojoQuantMoE(4, 2, 32, 16, ep_size=8, device="cpu")


# ---------------------------------------------------------------- kernel R's launch plan


def meta(*shape, dtype=torch.int8):
    return torch.empty(shape, device="meta", dtype=dtype)


def test_route_and_grid_come_from_shapes():
    R = group_quant_gemm
    assert R.route(13200, 128) == R.WGMMA  # Qwen3-30B-A3B's prefill batch: 103 rows an expert
    assert R.route(13200, 128, int4=True) == R.WGMMA_WIDE  # packed int4 on 256-wide tiles
    assert R.route(13200, 256) == R.WGMMA  # DeepSeek-V3's: 52 rows an expert
    assert R.route(8192, 256) == R.WGMMA and R.route(8191, 256) == R.DECODE
    assert R.route(32, 128) == R.DECODE == R.route(32, 128, int4=True)
    # the decode tile's grid: (n tiles, the static bound min(ceil(M / 16) + G, M)) blocks
    assert R.grid(32, 1536, 128, R.DECODE) == (48, 32)
    # the prefill route's units: (n tiles, the bound on 128-row tiles), walked by a persistent grid from a table
    # of 4 ints a row tile and 2 of meta
    assert R.grid(13200, 1536, 128, R.WGMMA) == (12, 104 + 128)
    assert R.grid(13200, 7168, 256, R.WGMMA) == (56, 104 + 256)
    assert R.grid(13200, 7168, 256, R.WGMMA_WIDE) == (28, 104 + 256)
    assert R.scratch_ints(13200, 128, R.WGMMA) == 4 * (104 + 128) + 2
    assert R.scratch_ints(32, 128, R.DECODE) == 0


@pytest.mark.parametrize("M, G, int4", [(13200, 128, False), (32, 128, True), (13200, 256, True)],
                         ids=["prefill-int8", "decode-int4", "prefill-int4"])
def test_launch_reads_no_count_on_the_host(monkeypatch, M, G, int4):
    """Off the CPU the wrapper sizes the grid and the scratch from shapes
    alone: with meta tensors (no values to read) it reaches the launch, and
    hands the kernel the route that ``route`` chose, with the prefill
    route's row-tile scratch."""
    seen = []
    monkeypatch.setattr(build, "launch", lambda name, device, *args: seen.append((name, args)))
    K, N = 2048, 1536
    before = group_quant_gemm.launches
    out = group_quant_gemm.grouped_quant_matmul(
        meta(M, K), meta(G, N // 2 if int4 else N, K), meta(G, dtype=torch.int32), meta(G, N, dtype=torch.float32),
        meta(M, 1, dtype=torch.float32), torch.bfloat16, int4=int4)
    assert out.shape == (M, N) and out.dtype == torch.bfloat16
    (name, args), = seen
    plan = group_quant_gemm.route(M, G, int4)
    assert name == "mojo_group_quant_gemm" and args[8:12] == (M, N, K, G)
    assert args[12:14] == (int(int4), plan)
    assert args[7] == group_quant_gemm.scratch_ints(M, G, plan)
    assert (args[6] is None) == (plan not in group_quant_gemm.PERSISTENT)
    assert group_quant_gemm.launches == before + 1


def test_wrapper_refuses_what_the_kernel_does_not_take(monkeypatch):
    monkeypatch.setattr(build, "launch", lambda *a: None)
    ok = dict(x=meta(64, 128), weight=meta(4, 32, 128), group_sizes=meta(4, dtype=torch.int32),
              weight_scale=meta(4, 32, dtype=torch.float32), x_scale=meta(64, 1, dtype=torch.float32),
              output_dtype=torch.bfloat16)
    group_quant_gemm.grouped_quant_matmul(**ok)
    cases = {
        "K % 16": dict(x=meta(64, 120), weight=meta(4, 32, 120)),
        "16-byte aligned": dict(x=torch.empty(64 * 128 + 8, dtype=torch.int8, device="meta")[8:].view(64, 128)),
        "weight_scale": dict(weight_scale=meta(4, 16, dtype=torch.float32)),
        "all inputs must be on": dict(group_sizes=torch.zeros(4, dtype=torch.int32)),
        "output dtype": dict(output_dtype=torch.int8),
        "int32": dict(group_sizes=meta(4, dtype=torch.int64)),
    }
    for match, change in cases.items():
        if match == "16-byte aligned":
            # a meta tensor's data_ptr is 0 wherever it starts: a CPU view's pointer is off by 8 bytes
            base = torch.zeros(64 * 128 + 8, dtype=torch.int8)
            args = dict(ok, x=base[8:].view(64, 128), weight=torch.zeros(4, 32, 128, dtype=torch.int8),
                        group_sizes=torch.zeros(4, dtype=torch.int32), weight_scale=torch.ones(4, 32),
                        x_scale=torch.ones(64, 1))
            with pytest.raises(ValueError, match=match):
                group_quant_gemm._group_quant_gemm_kernel(
                    args["x"], args["weight"], args["group_sizes"], args["weight_scale"], args["x_scale"],
                    torch.bfloat16, False)
            continue
        with pytest.raises(ValueError, match=match):
            group_quant_gemm.grouped_quant_matmul(**dict(ok, **change))


def tile_map(counts, M, bm):
    """The groups' row tiles of ``bm`` rows in order, (group, first row, end row), and the rows the groups cover:
    the decode tile's blocks find theirs in this order (locate_tile), the table launch writes them (group_tile_table,
    meta = (len(tiles), filled))."""
    tiles, start = [], 0
    for g, c in enumerate(counts):
        rows = max(0, min(max(c, 0), M - start))
        tiles += [(g, lo, min(lo + bm, start + rows)) for lo in range(start, start + rows, bm)]
        start = min(start + max(c, 0), M)
    return tiles, start


@pytest.mark.parametrize("routed, extra", [(32, 0), (13200, 0), (4200, 0), (200, 37), (5, 0)])
def test_tile_map_writes_every_row_once(routed, extra):
    """A model of both launch forms at every route's row tile: every routed row is written by exactly one row tile
    of its own group for each n tile, the rows past the groups' end once. The decode tile: blocks (n tile, row
    tile), blockIdx.x the n tile, so a row tile's n tiles are consecutive blocks; the surplus blocks zero the tail.
    The persistent routes: the BM-templated table (shared with kernel H) fits the scratch, units (row tile, n tile)
    with the n tile fastest dealt round robin, a tile's TMA box of 128 rows stored only within its group, and the
    tail zeroed from meta[1]."""
    R = group_quant_gemm
    rng = np.random.default_rng(routed)
    G, N = 128, 1536
    counts = np.bincount(rng.integers(0, G, routed), minlength=G)
    counts[3] += counts[9]  # an empty group among them
    counts[9] = 0
    M = routed + extra
    starts = np.concatenate([[0], np.cumsum(counts)])
    for code in R.TILES:
        n_tiles, bound = R.grid(M, N, G, code)
        bm, bn = R.TILES[code]
        tiles, filled = tile_map(counts.tolist(), M, bm)
        assert filled == M - extra and len(tiles) <= bound
        written = np.zeros(M, np.int64)
        for g, lo, hi in tiles:
            assert starts[g] <= lo < hi <= starts[g + 1] and hi - lo <= bm
            if code in R.PERSISTENT:
                box = np.arange(lo, lo + bm)  # the rows the TMA box brings: the next group's are not stored
                written[box[(box < hi)]] += 1
            else:
                written[lo:hi] += 1
        if code in R.PERSISTENT:
            assert 4 * len(tiles) + 2 <= R.scratch_ints(M, G, code)
            written[filled:] += 1  # the consumers' tail loop from meta[1]
            units = [(tiles[u // n_tiles], (u % n_tiles) * bn) for u in range(len(tiles) * n_tiles)]
            # n fastest: a wave of 132 blocks spans ceil(132 / n_tiles) + 1 row tiles at most, so x's rows stay in L2
            for w0 in range(0, len(units), 132):
                assert len({t for t, _ in units[w0:w0 + 132]}) <= -(-132 // n_tiles) + 1
            assert sorted(n0 for t, n0 in units if t == tiles[0]) == list(range(0, n_tiles * bn, bn))
        else:
            surplus = bound - len(tiles)
            assert surplus >= 1 or extra == 0
            for u in range(surplus):  # the surplus blocks' zeroing loop
                for r0 in range(filled + u * bm, M, surplus * bm):
                    written[r0:min(r0 + bm, M)] += 1
            # launch order: blockIdx.x (the n tile) fastest, so a row tile's n tiles are consecutive blocks
            order = [(y, x) for y in range(bound) for x in range(n_tiles)]
            for y in range(len(tiles)):
                assert [i for i, (yy, _) in enumerate(order) if yy == y] == list(range(y * n_tiles, (y + 1) * n_tiles))
        assert (written == 1).all(), R.ROUTE_NAMES[code]


def int4_channel(col):
    """The prefill route's epilogue map for packed int4: the n tile's channel of accumulator column ``col``
    (columns c and c + 64 of each 128-column group are the channels 2 c and 2 c + 1 of the group)."""
    group, c = divmod(col, 128)
    return 128 * group + 2 * (c % 64) + c // 64


@pytest.mark.parametrize("BN", [128, 256])
def test_int4_stage_unpack_and_column_map_equal_unpack_int4(BN):
    """A numpy model of a packed int4 stage on the prefill route, against ``unpack_int4``: TMA brings BN / 2 packed
    rows of one 128-byte k slice in the 128-byte swizzle (16-byte chunk j of row r at j ^ (r % 8)); the consumers
    unpack chunk c of it to the same offset in B rows 128 (r / 64) + r % 64 (16 x the low nibbles) and + 64 (the
    high), G's unpack_stage; wgmma reads B's rows through the same swizzle; the epilogue takes column c as channel
    ``int4_channel(c)``, and each lane's four adjacent channels from its accumulators; the 16-bit stores of a lane
    pair cover the n tile once."""
    rng = np.random.default_rng(BN)
    N, K, n0, k0 = 3 * BN, 384, BN, 128
    slab = torch.from_numpy(rng.integers(-128, 128, (N // 2, K)).astype(np.int8))
    want = tm.core.operators.moe.unpack_int4(slab).numpy()[n0:n0 + BN, k0:k0 + 128].astype(np.int32)
    box = slab.numpy()[n0 // 2:n0 // 2 + BN // 2, k0:k0 + 128].view(np.uint8)
    packed = np.zeros(BN // 2 * 128, np.uint8)  # the stage's packed tile as TMA writes it
    for r in range(BN // 2):
        for j in range(8):
            packed[r * 128 + 16 * (j ^ (r % 8)):][:16] = box[r, 16 * j:16 * j + 16]
    b = np.zeros(BN * 128, np.uint8)
    for c in range(BN // 2 * 8):  # unpack_stage: 16 bytes a chunk, low then high nibbles as 16 x the int4
        p = packed[16 * c:16 * c + 16]
        lo = (c // 512) * 16384 + (c % 512) * 16
        b[lo:lo + 16] = (p << 4) & 0xF0
        b[lo + 8192:lo + 8192 + 16] = p & 0xF0
    tile = np.zeros((BN, 128), np.int32)  # B as wgmma reads it: row c is the tile's column c
    for row in range(BN):
        for j in range(8):
            tile[row, 16 * j:16 * j + 16] = b[row * 128 + 16 * (j ^ (row % 8)):][:16].view(np.int8)
    assert (tile % 16 == 0).all()
    got = np.zeros_like(want)
    got[[int4_channel(c) for c in range(BN)]] = tile >> 4  # the sums' shift by 4, per weight
    np.testing.assert_array_equal(got, want)
    # lane q's accumulators acc[4 j + 2 h + e] are columns 8 j + 2 q + e: for column group jj of 128-column group
    # i, columns j = 16 i + jj (low) and j + 8 (high) give channels 128 i + 16 jj + 4 q + (2 e, 2 e + 1)
    owned = []
    for q in range(4):
        for i in range(BN // 128):
            for jj in range(8):
                jl, jh = 16 * i + jj, 16 * i + jj + 8
                four = [int4_channel(8 * jl + 2 * q), int4_channel(8 * jh + 2 * q),
                        int4_channel(8 * jl + 2 * q + 1), int4_channel(8 * jh + 2 * q + 1)]
                assert four == list(range(128 * i + 16 * jj + 4 * q, 128 * i + 16 * jj + 4 * q + 4))
                owned += four
    assert sorted(owned) == list(range(BN))
    # the 16-bit stores: even lanes group 2 p's 8 channels from 4 q, odd lanes group 2 p + 1's from 4 q - 4
    stored = [128 * i + 32 * p + (16 + 4 * q - 4 if q % 2 else 4 * q) + e
              for q in range(4) for i in range(BN // 128) for p in range(4) for e in range(8)]
    assert sorted(stored) == list(range(BN))


# ---------------------------------------------------------------- the Qwen3-MoE model, w8a8 and w4a8


TINY = dict(
    hidden_size=128, intermediate_size=256, num_attention_heads=4, num_key_value_heads=2,
    num_hidden_layers=2, head_dim=32, vocab_size=256, max_position_embeddings=128,
    num_experts=8, num_experts_per_tok=2, moe_intermediate_size=64,
)
LENS = np.array([5, 17, 1], np.int32)
BLOCK = 16
STEPS = 8


class Tok:
    eos_token_id = 0


@pytest.fixture(scope="module", params=["int8", "int4"], ids=["w8a8", "w4a8"])
def moe_pair(request):
    """(JAX quantized model, port fp32 base with the JAX weights, port quantized model with the JAX quantized
    weights, weight dtype)."""
    weight_dtype = request.param
    base_j = JaxQwen3Moe(JaxQwen3MoeConfig(**TINY, dtype=jnp.float32), key=jax.random.PRNGKey(7))
    qm_j = jax_quantize_qwen3_moe(base_j, weight_dtype)
    base_t = load_numpy_state(Qwen3MoeForCausalLM(Qwen3MoeConfig(**TINY, dtype=torch.float32), device="cpu"),
                              state_dict_of(base_j))
    mode = "w4a8" if weight_dtype == "int4" else "w8a8"
    qm_t = Qwen3MoeForCausalLM(Qwen3MoeConfig(**TINY, dtype=torch.float32, quant=mode), device="cpu")
    load_numpy_state(qm_t, state_dict_of(qm_j))
    return qm_j, base_t, qm_t, weight_dtype


def _prompt():
    return np.random.default_rng(0).integers(1, TINY["vocab_size"], int(LENS.sum())).astype(np.int32)


def test_quantize_qwen3_moe_matches_jax(moe_pair):
    qm_j, base_t, qm_t, weight_dtype = moe_pair
    mine = quantize_qwen3_moe(base_t, weight_dtype).state_dict()
    want = state_dict_of(qm_j)
    assert set(mine) == {k for k in want if not k.endswith("inv_freq")} == set(qm_t.state_dict())
    for name, tensor in mine.items():
        if tensor.dtype == torch.int8:
            np.testing.assert_array_equal(tensor.numpy(), np.asarray(want[name]), err_msg=name)
        else:
            check_tol_diff(tensor, np.asarray(want[name]), atol=0.0, rtol=1e-6)
    layer = qm_t.layers[0]
    assert type(layer.input_layernorm).__name__ == "CudaRMSNormQuant"
    assert type(layer.mlp.experts).__name__ == "CudaQuantExperts"
    assert layer.mlp.experts.up_proj_weight_scale.dtype == torch.float32
    # w4a8 packs the attention projections whose width is a multiple of 128 (q, o), the experts always
    assert (layer.self_attn.q_proj.weight_dtype == "int4") == (weight_dtype == "int4")
    assert layer.self_attn.k_proj.weight_dtype == torch.int8 and qm_t.lm_head.weight_dtype == torch.int8
    expect = (TINY["num_experts"], TINY["moe_intermediate_size"] * (1 if weight_dtype == "int4" else 2), 128)
    assert tuple(layer.mlp.experts.up_proj_weight.shape) == expect


def test_quant_moe_load_numpy_state_is_strict(moe_pair):
    qm_j, _, qm_t, _ = moe_pair
    state = dict(state_dict_of(qm_j))
    state.pop("layers.1.mlp.experts.down_proj_quantize.inv_smooth_scale")
    with pytest.raises(KeyError, match="inv_smooth_scale"):
        load_numpy_state(qm_t, state)
    state = dict(state_dict_of(qm_j))
    state["layers.0.mlp.experts.up_proj_weight"] = state["layers.0.mlp.experts.up_proj_weight"].astype(np.float32)
    with pytest.raises(ValueError, match="int8"):
        load_numpy_state(qm_t, state)
    load_numpy_state(qm_t, state_dict_of(qm_j))


@pytest.mark.parametrize("tier", ["ref", "cuda"])
def test_quant_moe_prefill_logits_match_jax(moe_pair, tier, monkeypatch):
    qm_j, _, qm_t, weight_dtype = moe_pair
    if tier == "ref":
        monkeypatch.setenv("MOJO_BACKEND", "ref")
        mode = "w4a8" if weight_dtype == "int4" else "w8a8"
        ref = Qwen3MoeForCausalLM(Qwen3MoeConfig(**TINY, dtype=torch.float32, quant=mode), device="cpu")
        ref.load_state_dict(qm_t.state_dict())
        qm_t = ref
    assert type(qm_t.layers[0].mlp.experts).__name__ == ("RefQuantExperts" if tier == "ref" else "CudaQuantExperts")
    ids = _prompt()
    logits_j, _ = JaxPaged(qm_j, block_size=BLOCK, jit=False)(ids, context_input_len=LENS)
    kernels.reset_launch_counts()
    logits_t, _ = PagedAttentionGenerationModel(qm_t, block_size=BLOCK)(ids, context_input_len=LENS)
    check_tol_diff(logits_t, np.asarray(logits_j), atol=2e-3, rtol=2e-3)
    assert kernels.launch_counts()["group_quant_gemm"] == 0  # CPU tensors: the plain version


class KeepLogits(GeneratorHook):
    def __init__(self):
        self.steps = []

    def after_prefill(self, *, logits, session):
        self.steps.append(np.asarray(logits))

    def after_decode_step(self, *, step, logits, next_token_id):
        self.steps.append(np.asarray(logits))


def assert_greedy_match(got, want, jax_logits):
    """``got`` equals JAX's stream ``want``, or first parts from it at a step where JAX's two best logits lie
    within TIE_GAP (a near-tie: an int8 value moved across a rounding tie); a row is compared up to there."""
    assert got.shape == want.shape
    for row in range(got.shape[0]):
        parted = np.flatnonzero(got[row] != want[row])
        if parted.size:
            top2 = np.sort(jax_logits[parted[0]][row])[-2:]
            assert top2[1] - top2[0] < TIE_GAP, (row, parted[0], top2)


@pytest.fixture(scope="module")
def jax_moe_stream(moe_pair):
    hook = KeepLogits()
    stream = JaxGenerator(JaxPaged(moe_pair[0], block_size=BLOCK, jit=False), Tok(), JaxGreedy(), max_new_tokens=STEPS,
                          hooks=[hook]).generate_from_ids(_prompt(), LENS, ignore_eos=True, silent=True)
    return np.asarray(stream), hook.steps


@pytest.mark.parametrize("fused", [False, True], ids=["stepwise", "fused"])
def test_quant_moe_greedy_tokens_match_jax(moe_pair, jax_moe_stream, fused):
    qm_t = moe_pair[2]

    def stream(fused_decode):
        return MojoGenerator(PagedAttentionGenerationModel(qm_t, block_size=BLOCK), Tok(), GreedySampler(),
                             max_new_tokens=STEPS).generate_from_ids(_prompt(), LENS, ignore_eos=True,
                                                                     fused_decode=fused_decode)

    got = stream(fused)
    assert_greedy_match(got, *jax_moe_stream)
    if fused:
        np.testing.assert_array_equal(got, stream(False))


def test_quant_moe_continuous_batching_equals_standalone_greedy(moe_pair):
    qm_t = moe_pair[2]
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, TINY["vocab_size"], n).astype(np.int32) for n in (5, 19, 2)]
    want = [MojoGenerator(PagedAttentionGenerationModel(qm_t, block_size=BLOCK), None, GreedySampler(),
                          max_new_tokens=4).generate_from_ids(p, [p.size], ignore_eos=True)[0] for p in prompts]
    server = ContinuousBatchingGenerator(qm_t, batch_slots=2, block_size=BLOCK, max_new_tokens=4)
    rids = [server.submit(p) for p in prompts]
    results = server.run()
    for rid, w in zip(rids, want):
        np.testing.assert_array_equal(results[rid], w)
