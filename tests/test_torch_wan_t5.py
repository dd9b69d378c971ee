"""Port parity for Wan2.2's umT5 text encoder: ``MojoRelativeEmbedding``,
``MojoChannelRMSNorm`` and ``modeling/wan2_2/modeling_t5.py`` of
mojo_opset_tpu_torch against mojo_opset_tpu's, on the CPU.

Every weight is drawn with numpy from a seed (``random_numpy_state``: norm
weights around 1, never the ones they start at) and loaded into both the JAX model
(``utils.hf.load_state_dict``) and the port (``load_numpy_state``); the same
numpy ids and masks go through both.

Tolerances, and why:
  * the relative position buckets and the bias they pick: exact (int32 and
    fp32 bucket math as JAX's, then a gather);
  * ``MojoChannelRMSNorm``: atol = rtol = 1e-6 in fp32 (one norm, one
    division, sums in another order);
  * the T5 encoder, the encoder-decoder and the wrapper: atol = rtol = 1e-5
    in fp32 (the same algorithm, sums in another order; outputs O(1)).
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mojo_opset_tpu.experimental.operators import MojoChannelRMSNorm as JaxChannelRMSNorm
from mojo_opset_tpu.experimental.operators import MojoRelativeEmbedding as JaxRelativeEmbedding
from mojo_opset_tpu.modeling.wan2_2 import modeling_t5 as jax_t5
from mojo_opset_tpu.utils.hf import load_state_dict, state_dict_of
from mojo_opset_tpu_torch.backends.cuda.operators import CudaSdpa
from mojo_opset_tpu_torch.experimental.operators import MojoChannelRMSNorm, MojoRelativeEmbedding
from mojo_opset_tpu_torch.modeling.wan2_2 import (
    T5Encoder,
    T5EncoderModel,
    T5Model,
    modeling_t5,
    umt5_xxl_encoder,
)
from mojo_opset_tpu_torch.utils.acc import check_tol_diff
from mojo_opset_tpu_torch.utils.weights import load_numpy_state, random_numpy_state

F32 = dict(atol=1e-5, rtol=1e-5)
NORM_TOL = dict(atol=1e-6, rtol=1e-6)
REPO = Path(__file__).resolve().parents[1]
# a tiny umT5: 2 layers, dim 32, 4 heads of 8, 8 buckets
TINY = dict(dim=32, dim_attn=32, dim_ffn=48, num_heads=4, num_buckets=8)
VOCAB = 64


def load_both(jax_model, port_model, seed: int):
    weights = random_numpy_state(port_model, seed)
    load_numpy_state(port_model, weights)
    return load_state_dict(jax_model, weights), port_model


def ids_and_mask(batch: int, length: int, lens, seed: int):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, VOCAB, (batch, length)).astype(np.int32)
    mask = (np.arange(length)[None, :] < np.asarray(lens)[:, None]).astype(np.int32)
    return ids, mask


@pytest.mark.parametrize("bidirectional", [True, False])
@pytest.mark.parametrize("lq, lk, max_dist", [(7, 13, 128), (13, 7, 128), (40, 40, 24), (512, 512, 128)])
def test_relative_embedding_matches_jax(bidirectional, lq, lk, max_dist):
    """Lq != Lk both ways, distances past ``max_dist``, and umT5-xxl's 32 buckets over its 512-token text."""
    jax_op = JaxRelativeEmbedding(32, 4, bidirectional, max_dist=max_dist)
    op = MojoRelativeEmbedding(32, 4, bidirectional, max_dist=max_dist, device="cpu")
    jax_op, op = load_both(jax_op, op, seed=lq + lk)
    rel = np.arange(lk, dtype=np.int32)[None, :] - np.arange(lq, dtype=np.int32)[:, None]
    want_buckets = np.asarray(jax_op._relative_position_bucket(jnp.asarray(rel)))
    got_buckets = op.relative_position_bucket(torch.from_numpy(rel))
    assert got_buckets.dtype == torch.int32
    np.testing.assert_array_equal(got_buckets.numpy(), want_buckets)
    if max(lq, lk) - 1 > max_dist:  # distances past max_dist share the last bucket
        assert want_buckets.max() == 31
    got = op(lq, lk)
    assert got.shape == (1, 4, lq, lk) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_op(lq, lk)))


def test_relative_embedding_rejects_bad_arguments():
    with pytest.raises(ValueError):
        MojoRelativeEmbedding(0, 4, True, device="cpu")
    with pytest.raises(TypeError):
        MojoRelativeEmbedding(8, 4, 1, device="cpu")
    with pytest.raises(ValueError):
        MojoRelativeEmbedding(8, 4, True, max_dist=0, device="cpu")
    with pytest.raises(ValueError):
        MojoRelativeEmbedding(8, 4, True, device="cpu")(0, 3)


@pytest.mark.parametrize("channel_first, images, bias, shape", [
    (True, True, False, (2, 8, 5, 6)),
    (True, False, False, (2, 8, 3, 5, 6)),
    (True, False, True, (1, 8, 2, 3, 4)),
    (False, True, True, (2, 5, 8)),
])
def test_channel_rmsnorm_matches_jax(channel_first, images, bias, shape):
    jax_op = JaxChannelRMSNorm(8, channel_first=channel_first, images=images, bias=bias)
    op = MojoChannelRMSNorm(8, channel_first=channel_first, images=images, bias=bias, device="cpu")
    assert tuple(op.weight.shape) == tuple(jax_op.weight.shape)
    jax_op, op = load_both(jax_op, op, seed=len(shape))
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    # a zero channel vector: the 1e-12 floor, the output exactly 0 (+ bias)
    if channel_first:
        x[0, :, 0] = 0.0
    else:
        x[0, 0, :] = 0.0
    check_tol_diff(op(torch.from_numpy(x)), np.asarray(jax_op(jnp.asarray(x))), **NORM_TOL)
    assert op(torch.from_numpy(x).to(torch.bfloat16)).dtype == torch.bfloat16


def test_t5_layer_norm_and_fp16_clamp_match_jax():
    x = np.random.default_rng(2).standard_normal((3, 5, 32)).astype(np.float32) * 3
    jax_norm, norm = load_both(jax_t5.T5LayerNorm(32), modeling_t5.T5LayerNorm(32, device="cpu"), seed=3)
    check_tol_diff(norm(torch.from_numpy(x)), np.asarray(jax_norm(jnp.asarray(x))), **F32)
    assert norm(torch.from_numpy(x).to(torch.bfloat16)).dtype == torch.bfloat16
    big = np.array([65000.0, -65000.0, 1.0], np.float16)
    assert modeling_t5.fp16_clamp(torch.from_numpy(big)).tolist() == np.asarray(
        jax_t5.fp16_clamp(jnp.asarray(big))).tolist() == [64512.0, -64512.0, 1.0]  # fp16 max - 1000, in fp16
    wide = torch.tensor([1e30, -1e30])
    assert modeling_t5.fp16_clamp(wide) is wide  # other dtypes pass through


@pytest.mark.parametrize("shared_pos", [True, False])
def test_t5_encoder_matches_jax_on_a_padded_batch(shared_pos):
    """Per-layer and shared relative bias; row 1 padded after 8 tokens. The float bias takes CudaSdpa's golden
    once a layer, counted."""
    jax_enc = jax_t5.T5Encoder(VOCAB, num_layers=2, shared_pos=shared_pos, **TINY)
    enc = T5Encoder(VOCAB, num_layers=2, shared_pos=shared_pos, device="cpu", **TINY)
    jax_enc, enc = load_both(jax_enc, enc, seed=4)
    ids, mask = ids_and_mask(2, 12, [12, 8], seed=5)
    want = np.asarray(jax_enc(jnp.asarray(ids), jnp.asarray(mask)))
    before = CudaSdpa.golden_calls
    with torch.inference_mode():
        got = enc(torch.from_numpy(ids), torch.from_numpy(mask))
    assert CudaSdpa.golden_calls - before == 2
    assert got.shape == (2, 12, 32) and got.dtype == torch.float32
    check_tol_diff(got, want, **F32)
    # the padded ids do not reach the valid rows
    ids[1, 8:] = 7
    with torch.inference_mode():
        again = enc(torch.from_numpy(ids), torch.from_numpy(mask))
    check_tol_diff(again[1, :8], got[1, :8], **F32)


@pytest.mark.parametrize("decoder_mask", [False, True])
def test_t5_model_matches_jax(decoder_mask):
    """The encoder-decoder of tests/models/test_wan22.py:55-89: a shared embedding, a causal decoder with
    cross-attention and RMSNorm (kernel A's op) in its blocks; the decoder mask absent or (B, L)."""
    jax_model = jax_t5.T5Model(VOCAB, encoder_layers=1, decoder_layers=2, **TINY)
    model = T5Model(VOCAB, encoder_layers=1, decoder_layers=2, device="cpu", **TINY)
    jax_model, model = load_both(jax_model, model, seed=6)
    assert model.encoder.token_embedding is model.token_embedding is model.decoder.token_embedding
    ids, mask = ids_and_mask(2, 12, [12, 8], seed=7)
    dec, dmask = ids_and_mask(2, 6, [6, 4], seed=8)
    dmask_j, dmask_t = (jnp.asarray(dmask), torch.from_numpy(dmask)) if decoder_mask else (None, None)
    want = np.asarray(jax_model(jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(dec), dmask_j))
    with torch.inference_mode():
        got = model(torch.from_numpy(ids), torch.from_numpy(mask), torch.from_numpy(dec), dmask_t)
        assert got.shape == (2, 6, VOCAB)
        check_tol_diff(got, want, **F32)
        # causal: a later decoder token does not move earlier logits
        dec2 = dec.copy()
        dec2[0, 4] = (dec2[0, 4] + 1) % VOCAB
        moved = model(torch.from_numpy(ids), torch.from_numpy(mask), torch.from_numpy(dec2), dmask_t)
    check_tol_diff(moved[0, :4], got[0, :4], **F32)
    assert not torch.allclose(moved[0, 4:], got[0, 4:])


def test_t5_encoder_model_slices_each_row_to_its_mask():
    jax_enc = jax_t5.umt5_xxl_encoder(VOCAB, num_layers=2, **TINY)
    enc = umt5_xxl_encoder(VOCAB, num_layers=2, device="cpu", **TINY)
    assert not enc.shared_pos and enc.pos_embedding is None and enc.blocks[1].pos_embedding is not None
    jax_enc, enc = load_both(jax_enc, enc, seed=9)
    ids, mask = ids_and_mask(3, 10, [10, 3, 7], seed=10)
    want = jax_t5.T5EncoderModel(jax_enc)(jnp.asarray(ids), jnp.asarray(mask))
    with torch.inference_mode():
        got = T5EncoderModel(enc)(torch.from_numpy(ids), torch.from_numpy(mask))
    assert [tuple(g.shape) for g in got] == [(10, 32), (3, 32), (7, 32)]
    for g, w in zip(got, want):
        check_tol_diff(g, np.asarray(w), **F32)


def test_umt5_xxl_encoder_has_the_published_widths():
    """google/umt5-xxl config.json: d_model 4096, d_ff 10240, 64 heads of 64, 24 layers, 32 buckets, vocabulary
    256384; a relative bias in every layer. Built on the meta device (5.68 B parameters)."""
    enc = umt5_xxl_encoder(device="meta", dtype=torch.bfloat16)
    assert enc.token_embedding.weight.shape == (256384, 4096) and enc.token_embedding.weight.dtype == torch.bfloat16
    assert len(enc.blocks) == 24 and enc.pos_embedding is None
    block = enc.blocks[0]
    assert (block.attn.num_heads, block.attn.head_dim) == (64, 64)
    assert block.ffn.gate.weight.shape == (10240, 4096) and block.pos_embedding.embedding.shape == (32, 64)
    assert block.pos_embedding.embedding.dtype == block.norm1.weight.dtype == torch.float32
    assert sum(p.numel() for p in enc.parameters()) == 5_680_910_336


def test_state_dict_round_trip():
    """Every leaf of JAX's ``state_dict_of(T5Encoder | T5Model)`` loads by name (the relative bias ``embedding``,
    the shared embedding under three names) and comes back equal; a missing key raises."""
    for jax_model, model in ((jax_t5.T5Encoder(VOCAB, num_layers=2, shared_pos=False, **TINY),
                              T5Encoder(VOCAB, num_layers=2, shared_pos=False, device="cpu", **TINY)),
                             (jax_t5.T5Model(VOCAB, encoder_layers=1, decoder_layers=1, **TINY),
                              T5Model(VOCAB, encoder_layers=1, decoder_layers=1, device="cpu", **TINY))):
        arrays = state_dict_of(load_state_dict(jax_model, random_numpy_state(model, seed=11)))
        load_numpy_state(model, arrays)
        state = model.state_dict()
        assert set(state) == set(arrays)
        for name, a in arrays.items():
            np.testing.assert_array_equal(state[name].numpy(), a)
        with pytest.raises(KeyError):
            load_numpy_state(model, {k: v for k, v in arrays.items() if not k.endswith("norm.weight")})


def test_entry_points_run_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (lambda: T5Encoder(VOCAB, num_layers=1, **TINY), lambda: umt5_xxl_encoder(VOCAB, **TINY),
                  lambda: MojoRelativeEmbedding(8, 2, True), lambda: MojoChannelRMSNorm(8)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()


def test_the_port_imports_no_jax():
    """No module of the port names jax or the JAX package."""
    pattern = re.compile(r"^\s*(import|from)\s+(jax|mojo_opset_tpu)(\.|\s|$)", re.M)
    offenders = [str(p.relative_to(REPO)) for p in (REPO / "mojo_opset_tpu_torch").rglob("*.py")
                 if pattern.search(p.read_text())]
    assert not offenders, offenders
