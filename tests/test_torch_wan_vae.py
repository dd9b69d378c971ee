"""Port parity for Wan2.2's causal video VAE: ``modeling/wan2_2/modeling_vae.py``
of mojo_opset_tpu_torch against mojo_opset_tpu's, on the CPU.

Every weight is drawn with numpy from a seed (``random_numpy_state``) and
loaded into both the JAX model (``utils.hf.load_state_dict``) and the port
(``load_numpy_state``): the norm weights around 1 and the mid attention's
output projection, which both start at a constant (1 and 0), carry random
values, so the norms and the attention count. The same numpy frames go
through both.

Tolerances, and why: every output is held relative to its own size,
``||got - want|| / ||want||`` over the whole tensor. Both sides compute the
deep fp32 conv stack in fp32 and sum in other orders, so the gap grows with
depth. The limits sit above the largest readings of this file on the CPU:
the pieces (one conv, resample or block) read at most 2.96e-7 (limit 3e-6,
10.1x left), the whole VAE's latents and videos at most 9.93e-7 (limit 6e-6,
6.0x left). patchify, unpatchify, DupUp3D and the nearest upsample only
move values and are held exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mojo_opset_tpu.modeling.wan2_2 import modeling_vae as jax_vae
from mojo_opset_tpu.utils.hf import load_state_dict, state_dict_of
from mojo_opset_tpu_torch.modeling.wan2_2 import Wan2_2_VAE, WanVAE_, modeling_vae
from mojo_opset_tpu_torch.utils.weights import load_numpy_state, random_numpy_state

PIECE_REL = 3e-6
VAE_REL = 6e-6
# a small VAE with the published stage layout (dim_mult (1, 2, 4, 4): 16x space, 2 res blocks a stage)
SMALL = dict(dim=8, dec_dim=8, z_dim=4)


def rel(got, want) -> float:
    g = got.detach().double().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float64)
    w = np.asarray(want, np.float64)
    assert g.shape == w.shape, (g.shape, w.shape)
    return float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))


def load_both(jax_model, port_model, seed: int):
    weights = random_numpy_state(port_model, seed)
    load_numpy_state(port_model, weights)
    return load_state_dict(jax_model, weights), port_model


def frames(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def t(x):
    return torch.from_numpy(np.array(x, np.float32))


@pytest.mark.parametrize("kernel, stride, padding", [(3, 1, 1), (1, 1, 0), ((3, 1, 1), (2, 1, 1), (0, 0, 0))])
def test_causal_conv3d_matches_jax(kernel, stride, padding):
    jax_conv, conv = load_both(jax_vae.CausalConv3d(4, 6, kernel, stride, padding),
                               modeling_vae.CausalConv3d(4, 6, kernel, stride, padding, device="cpu"), seed=1)
    x = frames((1, 4, 5, 6, 7), 2)
    for cache in (None, frames((1, 4, 1, 6, 7), 3), frames((1, 4, 2, 6, 7), 4)):
        want = jax_conv(jnp.asarray(x), None if cache is None else jnp.asarray(cache))
        got = conv(t(x), None if cache is None else t(cache))
        assert got.dtype == torch.float32
        assert rel(got, want) < PIECE_REL


def test_conv2d_same_and_upsample_match_jax():
    jax_conv, conv = load_both(jax_vae.Conv2dSame(4, 6, 3, stride=2), modeling_vae.Conv2dSame(4, 6, 3, stride=2,
                                                                                              device="cpu"), seed=5)
    x = frames((3, 4, 8, 10), 6)
    assert rel(conv(t(x), extra_pad=(0, 1, 0, 1)), jax_conv(jnp.asarray(x), extra_pad=(0, 1, 0, 1))) < PIECE_REL
    jax_same, same = load_both(jax_vae.Conv2dSame(4, 6, 3, padding=1),
                               modeling_vae.Conv2dSame(4, 6, 3, padding=1, device="cpu"), seed=7)
    assert rel(same(t(x)), jax_same(jnp.asarray(x))) < PIECE_REL
    np.testing.assert_array_equal(modeling_vae._upsample2x_nearest(t(x)).numpy(),
                                  np.asarray(jax_vae._upsample2x_nearest(jnp.asarray(x))))


@pytest.mark.parametrize("mode", ["none", "upsample2d", "upsample3d", "downsample2d", "downsample3d"])
def test_resample_streams_as_jax(mode):
    """Chunks of 1, 1 and 2 frames (upsampling) or 1 and 4 (downsampling) through one cache list each side: the
    "Rep" first chunk, then the carried frames."""
    jax_r, r = load_both(jax_vae.Resample(4, mode), modeling_vae.Resample(4, mode, device="cpu"), seed=8)
    lengths = (1, 4, 4) if mode.startswith("down") else (1, 1, 2)
    jax_cache, cache = [None], [None]
    for i, n in enumerate(lengths):
        x = frames((1, 4, n, 6, 8), 10 + i)
        jax_idx, idx = [0], [0]
        want = jax_r(jnp.asarray(x), jax_cache, jax_idx)
        got = r(t(x), cache, idx)
        assert idx == jax_idx
        assert rel(got, want) < PIECE_REL
    without = r(t(x))  # no cache: JAX skips the temporal conv too
    assert rel(without, jax_r(jnp.asarray(x))) < PIECE_REL


def test_patchify_and_resampling_shortcuts_match_jax():
    for shape in ((2, 3, 8, 12), (1, 3, 5, 8, 12)):
        x = frames(shape, 20)
        p = modeling_vae.patchify(t(x), 2)
        np.testing.assert_array_equal(p.numpy(), np.asarray(jax_vae.patchify(jnp.asarray(x), 2)))
        np.testing.assert_array_equal(modeling_vae.unpatchify(p, 2).numpy(), x)
    x = frames((1, 4, 5, 6, 8), 21)  # 5 frames: one padded in front for factor_t 2
    for ft, fs, out in ((2, 2, 8), (1, 2, 16), (2, 1, 4)):
        got = modeling_vae.AvgDown3D(4, out, ft, fs)(t(x))
        assert rel(got, jax_vae.AvgDown3D(4, out, ft, fs)(jnp.asarray(x))) < PIECE_REL
        for first in (False, True):
            got = modeling_vae.DupUp3D(out, 4, ft, fs)(t(x[:, :, :2].repeat(out // 4, 1)), first)
            want = jax_vae.DupUp3D(out, 4, ft, fs)(jnp.asarray(x[:, :, :2].repeat(out // 4, 1)), first)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_attention_block_matches_jax():
    """The mid attention with a random (not zero) output projection."""
    jax_a, a = load_both(jax_vae.AttentionBlock(8), modeling_vae.AttentionBlock(8, device="cpu"), seed=22)
    assert float(np.abs(np.asarray(jax_a.proj.weight)).max()) > 0
    x = frames((1, 8, 2, 6, 5), 23)
    assert rel(a(t(x)), jax_a(jnp.asarray(x))) < PIECE_REL
    assert not torch.count_nonzero(modeling_vae.AttentionBlock(8, device="cpu").proj.weight)  # JAX's zero start


def test_residual_blocks_stream_as_jax():
    for jax_b, b in ((jax_vae.Down_ResidualBlock(4, 8, 0.0, 2, temperal_downsample=True, down_flag=True),
                      modeling_vae.Down_ResidualBlock(4, 8, 0.0, 2, temperal_downsample=True, down_flag=True,
                                                      device="cpu")),
                     (jax_vae.Up_ResidualBlock(8, 4, 0.0, 2, temperal_upsample=True, up_flag=True),
                      modeling_vae.Up_ResidualBlock(8, 4, 0.0, 2, temperal_upsample=True, up_flag=True,
                                                    device="cpu"))):
        jax_b, b = load_both(jax_b, b, seed=24)
        n = modeling_vae._count_causal_convs(b)
        assert n == jax_vae._count_causal_convs(jax_b)
        jax_cache, cache = [None] * n, [None] * n
        chans = 4 if isinstance(b, modeling_vae.Down_ResidualBlock) else 8
        for i, frames_in in enumerate((1, 4, 4) if chans == 4 else (1, 1, 1)):
            x = frames((1, chans, frames_in, 8, 6), 30 + i)
            extra = () if chans == 4 else (i == 0,)
            want = jax_b(jnp.asarray(x), jax_cache, [0], *extra)
            got = b(t(x), cache, [0], *extra)
            assert rel(got, want) < PIECE_REL


def vae_pair(temperal_downsample, seed=40, **kw):
    cfg = dict(SMALL, temperal_downsample=temperal_downsample, **kw)
    return load_both(jax_vae.WanVAE_(**cfg), WanVAE_(**cfg, device="cpu"), seed)


@pytest.mark.parametrize("temperal_downsample", [(True, True, False), (True, True, True), (False, True, True)])
def test_vae_encode_decode_match_jax(temperal_downsample):
    """JAX's WanVAE_ default (True, True, False), Wan2_2_VAE's (True, True, True) and the published 4x temporal
    stride (False, True, True), with the chunk streaming at 1, 5 and 9 frames of 32 x 48."""
    jax_model, model = vae_pair(temperal_downsample)
    encode, decode = jax.jit(jax_model.encode), jax.jit(jax_model.decode)
    for n in (1, 5, 9):
        x = frames((1, 3, n, 32, 48), 50 + n)
        want_mu = np.asarray(encode(jnp.asarray(x)))
        with torch.inference_mode():
            mu = model.encode(t(x))
            want_video = np.asarray(decode(jnp.asarray(want_mu)))
            video = model.decode(t(want_mu))
        assert mu.shape == want_mu.shape and video.shape == want_video.shape
        if temperal_downsample == (False, True, True):  # 4x in time: 1, 5, 9 frames <-> 1, 2, 3 latent frames
            assert mu.shape == (1, 4, 1 + (n - 1) // 4, 2, 3) and video.shape == x.shape
        assert rel(mu, want_mu) < VAE_REL
        assert rel(video, want_video) < VAE_REL


def test_vae_decode_is_causal():
    """The decode loop's frames for latent frame i depend only on latent frames <= i: the first latent frame
    decoded alone gives the first video frame, and changing the last latent frame moves only its own frames (bit
    for bit: the same shapes run the same sums)."""
    _, model = vae_pair((False, True, True))
    z = t(frames((1, 4, 3, 2, 3), 60))
    with torch.inference_mode():
        video = model.decode(z)
        assert video.shape == (1, 3, 9, 32, 48)
        assert rel(model.decode(z[:, :, :1]), video[:, :, :1].numpy()) < VAE_REL  # other conv shapes: other sums
        z2 = z.clone()
        z2[:, :, 2] += 1.0
        moved = model.decode(z2)
    np.testing.assert_array_equal(moved[:, :, :5].numpy(), video[:, :, :5].numpy())
    assert not torch.equal(moved[:, :, 5:], video[:, :, 5:])


def test_wan2_2_vae_scaling_matches_jax():
    """After tests/models/test_wan22.py:91-113: the latents' mean and 1 / std scaling, decoded videos clipped to
    [-1, 1]; without a model the wrapper builds JAX's (True, True, True) VAE."""
    jax_model, model = vae_pair((True, True, True), seed=70)
    mean, std = np.full(4, 0.5, np.float32), np.linspace(1.0, 3.0, 4).astype(np.float32)
    jax_wrap = jax_vae.Wan2_2_VAE(vae=jax_model, z_dim=4, mean=mean, std=std)
    wrap = Wan2_2_VAE(vae=model, z_dim=4, mean=mean, std=std)
    video = frames((3, 5, 32, 32), 71) * 3
    with torch.inference_mode():
        zs = wrap.encode([t(video)])
        want_zs = jax_wrap.encode([jnp.asarray(video)])
        assert rel(zs[0], want_zs[0]) < VAE_REL
        out = wrap.decode(zs)
    want = jax_wrap.decode([jnp.asarray(zs[0].numpy())])
    assert out[0].shape == want[0].shape and float(out[0].abs().max()) <= 1.0
    assert rel(out[0], want[0]) < VAE_REL
    default = Wan2_2_VAE(z_dim=4, dim=8, dec_dim=8, device="meta")
    assert [r.mode for r in (default.model.encoder.downsamples[i].resample for i in range(3))] == ["downsample3d"] * 3


def test_reparameterize_draws_from_the_generator():
    _, model = vae_pair((False, True, True))
    mu, log_var = torch.randn(1, 4, 2, 2, 3), torch.randn(1, 4, 2, 2, 3)
    got = model.reparameterize(mu, log_var, torch.Generator().manual_seed(5))
    want = mu + torch.exp(0.5 * log_var) * torch.randn(mu.shape, generator=torch.Generator().manual_seed(5))
    assert torch.equal(got, want)


def test_state_dict_round_trip():
    """Every leaf of JAX's ``state_dict_of(WanVAE_)`` (the (C, 1, 1, 1) and (C, 1, 1) norm weights, the conv
    weights and biases) loads by name and comes back equal; a missing key raises."""
    jax_model = jax_vae.WanVAE_(**SMALL, temperal_downsample=(False, True, True))
    model = WanVAE_(**SMALL, temperal_downsample=(False, True, True), device="cpu")
    arrays = state_dict_of(load_state_dict(jax_model, random_numpy_state(model, seed=80)))
    assert any(a.shape == (8, 1, 1, 1) for a in arrays.values()) and "encoder.mid_attn.norm.weight" in arrays
    load_numpy_state(model, arrays)
    state = model.state_dict()
    assert set(state) == set(arrays)
    for name, a in arrays.items():
        np.testing.assert_array_equal(state[name].numpy(), a)
    with pytest.raises(KeyError):
        load_numpy_state(model, {k: v for k, v in arrays.items() if k != "decoder.mid_attn.proj.weight"})


def test_vae_runs_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        WanVAE_(**SMALL)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Wan2_2_VAE(z_dim=4, dim=8, dec_dim=8)
