"""Port parity for the diffusion attention and the Wan DiT's small ops:
kernel O's plain versions, ``MojoDiffusionAttentionFunction``'s tiers,
``CudaSdpa``'s masked route, ``MojoGelu``, ``MojoLayerNorm`` and
``MojoGridRoPE`` of mojo_opset_tpu_torch against mojo_opset_tpu, on the CPU.

The same numpy inputs go through the JAX op and the port's op. Kernel O's
plain forward and backward are held to JAX's ``flash_diffusion`` in
interpret mode (value and ``jax.vjp``) over the JAX package's five cases
(``tests/accuracy/functions/test_diffusion_vjp_pallas.py:42-48``), with the
rows the mask empties exactly 0 in o and dq. The port's Function tiers are
held to JAX's: ``ref`` to autograd of the golden, ``cuda`` (whose CPU
tensors run O's plain versions) to the Pallas tier.

Tolerances, and why: the JAX test's own (:72-74), 2e-5 in fp32 (one
algorithm, sums in another order) and 3e-2 in bf16 (rounding of o and of
the bf16 inputs' products at other places); 1e-5 for the small ops.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mojo_opset_tpu.core.operators as jo
from mojo_opset_tpu.backends.pallas.kernels.diffusion_vjp import flash_diffusion as jax_flash_diffusion
from mojo_opset_tpu.experimental.functions.diffusion_attention import (
    MojoDiffusionAttentionFunction as JaxDiffusionFunction,
)
from mojo_opset_tpu.experimental.functions.diffusion_attention import block_diffusion_mask as jax_block_mask
from mojo_opset_tpu.experimental.operators.position_embedding import MojoGridRoPE as JaxGridRoPE
from mojo_opset_tpu.modeling.wan2_2.modeling_wan import rope_params as jax_rope_params
import mojo_opset_tpu_torch as tm
from mojo_opset_tpu_torch.backends.cuda.functions import CudaDiffusionAttentionFunction
from mojo_opset_tpu_torch.backends.cuda.kernels import flash_diffusion as fd
from mojo_opset_tpu_torch.backends.cuda.operators import CudaSdpa
from mojo_opset_tpu_torch.modeling.wan2_2 import WanModel, WanConfig
from mojo_opset_tpu_torch.utils.acc import check_tol_diff

F32 = dict(atol=1e-5, rtol=1e-5)

# (B, Hq, Hkv, S, D, mask kind, dtype): the JAX package's cases
CASES = {
    "block-mha": (1, 4, 4, 128, 128, "block", "float32"),
    "gqa-random-oddS": (2, 4, 2, 96, 128, "random", "float32"),
    "empty-rows": (1, 2, 1, 64, 128, "empty-rows", "float32"),
    "bf16": (1, 4, 2, 128, 128, "block", "bfloat16"),
    "d256": (1, 2, 2, 80, 256, "random", "float32"),
}


def tol(dtype):
    return dict(atol=3e-2, rtol=3e-2) if dtype == "bfloat16" else dict(atol=2e-5, rtol=2e-5)


def _mask(kind, S, rng):
    if kind == "block":
        return np.array(jax_block_mask(S, 32))
    if kind == "random":  # no fully empty row: the diagonal is kept
        return (rng.random((S, S)) < 0.3) | np.eye(S, dtype=bool)
    # rows past S // 2 keep nothing: the lse sentinel
    return np.array(jax_block_mask(S, 16)) & (np.arange(S)[:, None] < S // 2)


@functools.lru_cache(maxsize=None)
def case_inputs(name):
    """numpy q, k, v, do (bf16-rounded where the case is bf16), the mask and the scale."""
    B, Hq, Hkv, S, D, kind, dtype = CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    arrays = [rng.standard_normal(shape).astype(np.float32)
              for shape in ((B, Hq, S, D), (B, Hkv, S, D), (B, Hkv, S, D), (B, Hq, S, D))]
    if dtype == "bfloat16":
        arrays = [np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32)) for a in arrays]
    return (*arrays, _mask(kind, S, rng), 1.0 / np.sqrt(D))


def jax_vjp(name, fn):
    """Value and (dq, dk, dv) of ``fn(q, k, v)`` at the case's inputs in its dtype, as fp32 numpy."""
    q, k, v, do, _, _ = case_inputs(name)
    dt = jnp.dtype(CASES[name][-1])
    y, pull = jax.vjp(fn, *(jnp.asarray(x, dt) for x in (q, k, v)))
    return [np.asarray(t, np.float32) for t in (y, *pull(jnp.asarray(do, dt)))]


@functools.lru_cache(maxsize=None)
def jax_kernel_results(name):
    """JAX's flash_diffusion (interpret mode) forward and backward."""
    _, _, _, _, mask, scale = case_inputs(name)
    return jax_vjp(name, lambda q, k, v: jax_flash_diffusion(q, k, v, jnp.asarray(mask), scale, interpret=True))


@functools.lru_cache(maxsize=None)
def jax_tier_results(name, tier):
    """JAX's MojoDiffusionAttentionFunction of ``tier`` (the Pallas tier runs in
    interpret mode on the CPU)."""
    _, _, _, _, mask, scale = case_inputs(name)
    Hq, Hkv = CASES[name][1:3]
    fn = JaxDiffusionFunction.get_backend_impl(tier, strict=tier != "ref")()
    return jax_vjp(name, lambda q, k, v: fn(q, k, v, jnp.asarray(mask), scale, Hq != Hkv))


def torch_inputs(name):
    q, k, v, do, mask, scale = case_inputs(name)
    dt = getattr(torch, CASES[name][-1])
    return [torch.from_numpy(x).to(dt) for x in (q, k, v, do)] + [torch.from_numpy(mask), float(scale)]


def rows_of(mask):
    keep = mask.sum(-1) > 0
    return np.where(keep)[0], np.where(~keep)[0]


@pytest.mark.parametrize("name", CASES)
def test_flash_diffusion_plain_matches_jax_kernel(name):
    """O's plain forward and backward against JAX's interpret-mode kernel, the
    rows the mask empties included: o and dq exactly 0 there, and lse the
    sentinel."""
    q, k, v, do, mask, scale = torch_inputs(name)
    o, lse = fd.flash_diffusion_fwd_plain(q, k, v, mask, scale)
    dq, dk, dv = fd.flash_diffusion_bwd_plain(q, k, v, o, lse, do, mask, scale)
    want = jax_kernel_results(name)
    for got, w in zip((o, dq, dk, dv), want):
        check_tol_diff(got, w, **tol(CASES[name][-1]))
    _, empty = rows_of(case_inputs(name)[4])
    assert torch.all(o[:, :, empty] == 0) and torch.all(dq[:, :, empty] == 0)
    assert torch.all(lse[:, :, empty] == fd.EMPTY_LSE) and torch.isfinite(lse).all()


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("tier", ["ref", "cuda"])
def test_diffusion_function_tiers_match_jax(name, tier):
    """The port's tier against JAX's (``cuda`` against the Pallas tier) on the
    rows that keep a key; the cuda tier's empty rows give o = 0 and dq = 0,
    its dk/dv are compared whole when no row is empty (the golden's empty rows
    are NaN, outside what it defines)."""
    q, k, v, do, mask, scale = torch_inputs(name)
    Hq, Hkv = CASES[name][1:3]
    fn = tm.MojoDiffusionAttentionFunction.get_backend_impl(tier)()
    assert type(fn).__name__ == ("RefDiffusionAttentionFunction" if tier == "ref" else "CudaDiffusionAttentionFunction")
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    y = fn(*leaves, mask, scale, Hq != Hkv)
    grads = torch.autograd.grad(y, leaves, do)
    want = jax_tier_results(name, "ref" if tier == "ref" else "pallas")
    rows, empty = rows_of(case_inputs(name)[4])
    t = tol(CASES[name][-1])
    check_tol_diff(y.detach()[:, :, rows], want[0][:, :, rows], **t)
    check_tol_diff(grads[0][:, :, rows], want[1][:, :, rows], **t)
    if empty.size == 0:
        for g, w in zip(grads[1:], want[2:]):
            check_tol_diff(g, w, **t)
    elif tier == "cuda":
        assert torch.all(y.detach()[:, :, empty] == 0) and torch.all(grads[0][:, :, empty] == 0)


def test_diffusion_additive_mask_takes_the_golden():
    """An additive float mask runs the golden on the cuda tier, as on JAX's
    Pallas tier (``test_diffusion_additive_mask_falls_back``), and is counted."""
    rng = np.random.default_rng(0)
    q = rng.standard_normal((1, 2, 32, 128)).astype(np.float32)
    add = np.where(rng.random((32, 32)) < 0.5, 0.0, -1e9).astype(np.float32)
    want = JaxDiffusionFunction.get_backend_impl("ref")()(*(jnp.asarray(q),) * 3, jnp.asarray(add))
    before = CudaDiffusionAttentionFunction.golden_calls
    got = CudaDiffusionAttentionFunction()(*(torch.from_numpy(q),) * 3, torch.from_numpy(add))
    assert CudaDiffusionAttentionFunction.golden_calls == before + 1
    check_tol_diff(got, np.asarray(want), **F32)


def test_block_diffusion_mask_matches_jax():
    for S, blk in ((96, 32), (100, 7)):
        assert np.array_equal(tm.block_diffusion_mask(S, blk).numpy(), np.asarray(jax_block_mask(S, blk)))


def _key_padding(lens, S):
    return (np.arange(S)[None, :] < np.asarray(lens)[:, None])[:, None, None, :]


@pytest.mark.parametrize("lens", [[20, 7], [20, 0]], ids=["ragged", "empty-batch-row"])
def test_cuda_sdpa_key_padding_mask_runs_kernel_o(lens):
    """``CudaSdpa`` with the DiT's (B, 1, 1, S) bool mask: kernel O's route
    (no golden call), equal to JAX's golden; a batch row whose mask keeps no
    key gives NaN, as the golden does."""
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((2, 4, 20, 64)).astype(np.float32) for _ in range(3))
    mask = _key_padding(lens, 20)
    want = np.asarray(jo.MojoSdpa.get_backend_impl("ref")()(*(jnp.asarray(x) for x in (q, k, v, mask))))
    before = CudaSdpa.golden_calls
    got = CudaSdpa()(*(torch.from_numpy(x) for x in (q, k, v, mask)))
    assert CudaSdpa.golden_calls == before
    assert np.array_equal(np.isnan(got.numpy()), np.isnan(want))
    check_tol_diff(got, want, **F32)
    if 0 in lens:
        assert torch.isnan(got[1]).all() and not torch.isnan(got[0]).any()


def test_cuda_sdpa_masked_route_carries_gradients():
    """The masked route is differentiable: O's plain backward under
    ``FlashDiffusion`` against ``jax.vjp`` of JAX's golden ``MojoSdpa``, GQA
    and a mask that broadcasts over the batch."""
    rng = np.random.default_rng(4)
    q, do = (rng.standard_normal((2, 4, 24, 32)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((2, 2, 24, 32)).astype(np.float32) for _ in range(2))
    mask = (rng.random((24, 24)) < 0.5) | np.eye(24, dtype=bool)
    golden = jo.MojoSdpa.get_backend_impl("ref")(enable_gqa=True)
    y, pull = jax.vjp(lambda *x: golden(*x, attn_mask=jnp.asarray(mask)), *(jnp.asarray(x) for x in (q, k, v)))
    want = [np.asarray(t) for t in (y, *pull(jnp.asarray(do)))]
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    before = CudaSdpa.golden_calls
    got = CudaSdpa(enable_gqa=True)(*leaves, attn_mask=torch.from_numpy(mask))
    grads = torch.autograd.grad(got, leaves, torch.from_numpy(do))
    assert CudaSdpa.golden_calls == before
    for g, w in zip((got.detach(), *grads), want):
        check_tol_diff(g, w, **F32)


@pytest.mark.parametrize("approximate", [True, False])
def test_gelu_matches_jax(approximate):
    x = np.random.default_rng(5).standard_normal((7, 33)).astype(np.float32) * 3
    want = jo.MojoGelu.get_backend_impl("ref")(approximate=approximate)(jnp.asarray(x))
    check_tol_diff(tm.MojoGelu(approximate=approximate)(torch.from_numpy(x)), np.asarray(want), **F32)


@pytest.mark.parametrize("affine", [True, False])
def test_layer_norm_matches_jax(affine):
    rng = np.random.default_rng(6)
    x = (rng.standard_normal((3, 5, 48)) * 2 + 0.5).astype(np.float32)
    jop = jo.MojoLayerNorm.get_backend_impl("ref")(48, 1e-6, elementwise_affine=affine)
    op = tm.MojoLayerNorm(48, 1e-6, elementwise_affine=affine, device="cpu")
    if affine:
        w, b = rng.standard_normal(48).astype(np.float32), rng.standard_normal(48).astype(np.float32)
        jop.weight, jop.bias = jnp.asarray(w), jnp.asarray(b)
        op.weight.copy_(torch.from_numpy(w))
        op.bias.copy_(torch.from_numpy(b))
    else:
        assert op.weight is None and op.bias is None and not list(op.parameters())
    check_tol_diff(op(torch.from_numpy(x)), np.asarray(jop(jnp.asarray(x))), **F32)
    bf = op(torch.from_numpy(x).to(torch.bfloat16))
    assert bf.dtype == torch.bfloat16


def test_grid_rope_matches_jax():
    """Two samples of different grids in one padded batch: the rotation of each
    sample's F*H*W tokens, its padding left as it was."""
    rng = np.random.default_rng(7)
    d, n, L = 32, 2, 30
    x = rng.standard_normal((2, L, n, d)).astype(np.float32)
    grids = [(2, 3, 4), (1, 2, 5)]
    model = WanModel(WanConfig(dim=d * n, num_heads=n, num_layers=0), device="cpu")
    freqs = model.calculate_freqs(grids, L)
    jfreqs = jnp.concatenate([jax_rope_params(1024, d - 4 * (d // 6)), jax_rope_params(1024, 2 * (d // 6)),
                              jax_rope_params(1024, 2 * (d // 6))], axis=1)
    assert np.allclose(model.freqs.numpy(), np.asarray(jfreqs), atol=1e-6)
    c = d // 2
    sizes = np.cumsum([0, c - 2 * (c // 3), c // 3, c // 3])
    jparts = [jfreqs[:, sizes[i]:sizes[i + 1]] for i in range(3)]
    jlist = [jnp.concatenate([jnp.broadcast_to(jparts[0][:f].reshape(f, 1, 1, -1), (f, h, w, sizes[1])),
                              jnp.broadcast_to(jparts[1][:h].reshape(1, h, 1, -1), (f, h, w, sizes[2] - sizes[1])),
                              jnp.broadcast_to(jparts[2][:w].reshape(1, 1, w, -1), (f, h, w, sizes[3] - sizes[2]))],
                             axis=-1).reshape(f * h * w, 1, -1) for f, h, w in grids]
    want = JaxGridRoPE()(jnp.asarray(x), np.asarray(grids), jlist)
    got = tm.MojoGridRoPE()(torch.from_numpy(x), grids, freqs)
    check_tol_diff(got, np.asarray(want), **F32)
    assert torch.equal(got[1, 10:], torch.from_numpy(x)[1, 10:])
