"""Port parity for the plain core ops of slice E: ``MojoSwiGLU`` (with and
without ``swiglu_limit``), ``MojoSwiGLUMLP`` (its weights carried across
from JAX), ``MojoRotaryEmbedding``'s ``init_max_length`` table,
``MojoMRoPE``, ``MojoVisionRotaryEmbedding2D`` and
``MojoApplyVisionRoPE2D``, against mojo_opset_tpu on the CPU, on the same
numpy inputs. Tolerances as in ``tests/test_torch_train_functions.py``:
fp32 2e-5, bf16 2e-2.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mojo_opset_tpu.core.operators as jo
from mojo_opset_tpu.core.operators.mlp import MojoSwiGLUMLP as JaxSwiGLUMLP
from mojo_opset_tpu.utils.hf import state_dict_of
import mojo_opset_tpu_torch as tm
from mojo_opset_tpu_torch.utils.acc import check_tol_diff
from mojo_opset_tpu_torch.utils.weights import load_numpy_state

F32 = dict(atol=2e-5, rtol=2e-5)
BF16 = dict(atol=2e-2, rtol=2e-2)


def close(got: torch.Tensor, want, tol=F32) -> None:
    check_tol_diff(got.float(), np.asarray(jnp.asarray(want, jnp.float32)), **tol)


def rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("limit", [0.0, 1.5])
def test_swiglu_matches_jax(limit, dtype):
    rng = np.random.default_rng(0)
    gate, up = rand(rng, 6, 40, scale=2.0), rand(rng, 6, 40, scale=2.0)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    want = jo.MojoSwiGLU.get_backend_impl("ref")(swiglu_limit=limit)(jnp.asarray(gate, jdt), jnp.asarray(up, jdt))
    got = tm.MojoSwiGLU(swiglu_limit=limit)(torch.from_numpy(gate).to(tdt), torch.from_numpy(up).to(tdt))
    assert got.dtype == tdt
    close(got, want, F32 if dtype == "f32" else BF16)
    if limit:  # the clamp bites: the limited op differs from the plain one
        assert not torch.allclose(got.float(), tm.MojoSwiGLU()(torch.from_numpy(gate), torch.from_numpy(up)))


def test_swiglu_mlp_matches_jax_with_its_weights():
    import jax

    jmlp = JaxSwiGLUMLP(24, 20, 32, key=jax.random.PRNGKey(3))
    mlp = tm.MojoSwiGLUMLP(24, 20, 32, device="cpu", generator=torch.Generator().manual_seed(0))
    state = state_dict_of(jmlp)
    assert set(state) == {"fc1.weight", "fc2.weight"} == set(mlp.state_dict())
    load_numpy_state(mlp, state)
    x = rand(np.random.default_rng(1), 5, 24)
    close(mlp(torch.from_numpy(x)), jmlp(jnp.asarray(x)))
    assert mlp.fc1.weight.shape == (64, 24) and mlp.fc2.weight.shape == (20, 32)


def test_swiglu_mlp_is_seeded_and_defaults_to_the_card(monkeypatch):
    a = tm.MojoSwiGLUMLP(8, 8, 16, device="cpu", generator=torch.Generator().manual_seed(5))
    b = tm.MojoSwiGLUMLP(8, 8, 16, device="cpu", generator=torch.Generator().manual_seed(5))
    assert all(torch.equal(p, q) for p, q in zip(a.parameters(), b.parameters()))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tm.MojoSwiGLUMLP(8, 8, 16)


@pytest.mark.parametrize("mode", ["varlen", "padded", "decode"])
def test_rotary_embedding_table_matches_jax(mode):
    """``init_max_length``: the cos/sin rows looked up from a table built at
    construction, in each of the op's three modes."""
    kwargs = dict(rope_theta=10000.0, rope_dim=32, attention_scaling=0.7, init_max_length=64)
    jop = jo.MojoRotaryEmbedding.get_backend_impl("ref")(**kwargs)
    op = tm.MojoRotaryEmbedding(**kwargs, device="cpu")
    assert "cos" not in op.state_dict()  # recomputed, never loaded
    cu, lens = np.array([0, 3, 8], np.int32), np.array([10, 5], np.int32)
    args = {"varlen": ((8, 32), dict(cu_q_lens=cu, total_seq_lens=lens)),
            "padded": ((2, 9, 32), {}),
            "decode": ((3, 32), dict(position_ids=np.array([0, 17, 63], np.int32)))}[mode]
    x = np.zeros(args[0], np.float32)
    want = jop(jnp.asarray(x), **{k: jnp.asarray(v) for k, v in args[1].items()})
    got = op(torch.from_numpy(x), **{k: torch.from_numpy(v) for k, v in args[1].items()})
    for g, w in zip(got, want):
        close(g, w)
    untabled = tm.MojoRotaryEmbedding(10000.0, 32, 0.7, device="cpu")(
        torch.from_numpy(x), **{k: torch.from_numpy(v) for k, v in args[1].items()})
    for g, w in zip(got, untabled):
        check_tol_diff(g, w, **F32)


@pytest.mark.parametrize("table", ["3-axis", "3-axis-interleaved", "flat"])
def test_mrope_matches_jax(table):
    rng = np.random.default_rng(2)
    T, n_heads, head_dim, sections = 7, 3, 40, [4, 6, 6]
    half = sum(sections)
    q, k = rand(rng, T, n_heads * head_dim), rand(rng, T, 1 * head_dim)
    shape = (T, half) if table == "flat" else (3, T, half)
    cos_t, sin_t = rand(rng, *shape), rand(rng, *shape)
    interleaved = table == "3-axis-interleaved"
    want = jo.MojoMRoPE.get_backend_impl("ref")()(jnp.asarray(q), jnp.asarray(k), jnp.asarray(cos_t),
                                                  jnp.asarray(sin_t), sections, interleaved, head_dim)
    got = tm.MojoMRoPE()(*map(torch.from_numpy, (q, k, cos_t, sin_t)), sections, interleaved, head_dim)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        close(g, w)
    # the lanes past the rotary dims pass through
    check_tol_diff(got[0].view(T, n_heads, head_dim)[..., 2 * half:],
                   torch.from_numpy(q).view(T, n_heads, head_dim)[..., 2 * half:], atol=0.0, rtol=0.0)


@pytest.mark.parametrize("adapooling_factor", [1, 2])
def test_vision_rope_2d_matches_jax(adapooling_factor):
    grid = np.array([[2, 4], [4, 2]], np.int32)
    jemb = jo.MojoVisionRotaryEmbedding2D.get_backend_impl("ref")(rope_dim=16, adapooling_factor=adapooling_factor)
    emb = tm.MojoVisionRotaryEmbedding2D(rope_dim=16, adapooling_factor=adapooling_factor, device="cpu")
    jcos, jsin = jemb(jnp.asarray(grid))
    cos, sin = emb(torch.from_numpy(grid))
    assert cos.shape == (16, 16)
    close(cos, jcos)
    close(sin, jsin)
    rng = np.random.default_rng(4)
    q, k = rand(rng, 16, 3, 16), rand(rng, 16, 2, 16)
    japp = jo.MojoApplyVisionRoPE2D.get_backend_impl("ref")()
    jq, jk = japp(jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16), jcos, jsin)
    tq, tk = tm.MojoApplyVisionRoPE2D()(torch.from_numpy(q).bfloat16(), torch.from_numpy(k).bfloat16(), cos, sin)
    assert tq.dtype == tk.dtype == torch.bfloat16
    close(tq, jq, BF16)
    close(tk, jk, BF16)


def test_vision_rope_checks_its_inputs():
    with pytest.raises(ValueError, match="divisible by 4"):
        tm.MojoVisionRotaryEmbedding2D(rope_dim=10, device="cpu")
    with pytest.raises(ValueError, match="adapooling_factor"):
        tm.MojoVisionRotaryEmbedding2D(rope_dim=16, adapooling_factor=2, device="cpu")(np.array([[3, 4]]))
    with pytest.raises(ValueError, match="full head_dim"):
        tm.MojoApplyVisionRoPE2D()(torch.zeros(4, 2, 16), torch.zeros(4, 2, 16), torch.zeros(4, 8), torch.zeros(4, 8))
