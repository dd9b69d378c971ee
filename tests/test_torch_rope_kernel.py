"""Kernel B (token-first RoPE, ``csrc/rope.cu``): its vector route's thread
map, its route predicate, and a plain-PyTorch model of the route held to
the plain version and to the JAX package's Pallas ``rope_token_first`` in
interpret mode, on the CPU.

The vector route gives thread g of one covering grid vector g % VPH of both
halves of row g / VPH (VPH 16-byte vectors a half row), rows token by token
(a token's q heads, then its k heads). The model gathers each thread's
vectors through that map and rotates them as the kernel does: each product
rounded to fp32, the second term's first, the first term's product added to
it in one fused multiply-add (emulated in fp64: the product of two fp32
values is exact there), one rounding to the dtype at the store.
Tolerances: fp32 1e-5 (as tests/test_torch_ops.py; the fused add moves a
value by an ulp), bf16 the dtype's ladder (utils/acc.py), each side rounding
once from fp32.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mojo_opset_tpu.backends.pallas.kernels.rope import rope_token_first as jax_rope_token_first
from mojo_opset_tpu_torch.backends.cuda import build
from mojo_opset_tpu_torch.backends.cuda.kernels import rope
from mojo_opset_tpu_torch.utils.acc import check_tol_diff, tols_for

DTYPES = {"bf16": torch.bfloat16, "f16": torch.float16, "f32": torch.float32}
F32 = dict(atol=1e-5, rtol=1e-5)
# (tokens, q heads, k heads): odd T, Qwen3-4B's 32/8 at decode, Seed-OSS-36B's 80/8, DeepSeek-V3's 128 heads with
# one shared k head
SHAPES = ((5, 4, 2), (4, 32, 8), (1, 80, 8), (2, 128, 1))


def vector_map(T, hq, hk, D, dtype):
    """csrc/rope.cu's vector route: for each thread of the grid, its token, whether it reads q, and the offset of its
    low-half vector in q or k (its high-half vector is D / 2 further)."""
    vec = 16 // torch.empty((), dtype=dtype).element_size()
    vph = D // 2 // vec
    heads = hq + hk
    g = np.arange(T * heads * vph)
    row, col = g // vph, g % vph
    t = row // heads
    h = row - t * heads
    is_q = h < hq
    x_row = np.where(is_q, t * hq + h, t * hk + h - hq)
    return t, is_q, x_row * D + col * vec, col * vec, vec


@pytest.mark.parametrize("dtype_name", list(DTYPES))
@pytest.mark.parametrize("D", rope.VECTOR_WIDTHS)
@pytest.mark.parametrize("T, hq, hk", SHAPES)
def test_vector_route_covers_q_and_k_once_in_whole_vectors(T, hq, hk, D, dtype_name):
    t, is_q, off, col, vec = vector_map(T, hq, hk, D, DTYPES[dtype_name])
    assert (off % vec == 0).all() and (col % vec == 0).all()  # every vector starts on a 16-byte boundary
    elems = off[:, None] + np.concatenate([np.arange(vec), D // 2 + np.arange(vec)])[None, :]
    assert (np.bincount(elems[is_q].ravel(), minlength=T * hq * D) == 1).all()
    assert (np.bincount(elems[~is_q].ravel(), minlength=T * hk * D) == 1).all()
    assert elems[is_q].max() < T * hq * D and elems[~is_q].max() < T * hk * D
    # a token's heads sit in neighbouring threads, each reading its token's table row
    assert (np.diff(t) >= 0).all() and np.array_equal(np.bincount(t), np.full(T, (hq + hk) * D // 2 // vec))
    assert np.array_equal(np.unique(col), np.arange(0, D // 2, vec))


@pytest.mark.parametrize("dtype_name", list(DTYPES))
@pytest.mark.parametrize("D", rope.VECTOR_WIDTHS)
def test_route_takes_the_vector_kernel_at_64_and_128(D, dtype_name):
    dtype = DTYPES[dtype_name]
    q, k, tables = torch.zeros(3, 8, D, dtype=dtype), torch.zeros(3, 2, D, dtype=dtype), torch.zeros(3, D, dtype=dtype)
    assert rope.route(q, k, tables, tables) == "vector"


@pytest.mark.parametrize("D", [32, 33, 96, 256])
def test_route_takes_the_generic_kernel_at_other_widths(D):
    q, k, tables = torch.zeros(3, 8, D), torch.zeros(3, 2, D), torch.zeros(3, D)
    assert rope.route(q, k, tables, tables) == "generic"


@pytest.mark.parametrize("which", ["q", "k", "cos", "sin"])
def test_route_takes_the_generic_kernel_for_an_unaligned_view(which):
    """A contiguous view that starts one element past a 16-byte boundary."""
    shapes = {"q": (3, 8, 128), "k": (3, 2, 128), "cos": (3, 128), "sin": (3, 128)}
    args = {}
    for name, shape in shapes.items():
        n = int(np.prod(shape))
        offset = 1 if name == which else 0
        args[name] = torch.zeros(n + offset, dtype=torch.bfloat16)[offset:].view(shape)
        assert args[name].is_contiguous()
    assert rope.route(**args) == "generic"


def vector_model(q, k, cos, sin):
    """The vector route's outputs: each thread's vectors gathered through ``vector_map`` and rotated as
    csrc/rope.cu's rot_lo / rot_hi do, then stored through the same map."""
    T, hq, D = q.shape
    hk = k.shape[1]
    t, is_q, off, col, vec = vector_map(T, hq, hk, D, q.dtype)
    lanes = torch.arange(vec)
    outs = []
    for src, mask in ((q, is_q), (k, ~is_q)):
        flat = src.reshape(-1).float()
        lo_idx = torch.from_numpy(off[mask])[:, None] + lanes
        tab_idx = torch.from_numpy(t[mask] * D + col[mask])[:, None] + lanes
        x_lo, x_hi = flat[lo_idx], flat[lo_idx + D // 2]
        c, s = cos.reshape(-1).float(), sin.reshape(-1).float()
        c_lo, c_hi, s_lo, s_hi = c[tab_idx], c[tab_idx + D // 2], s[tab_idx], s[tab_idx + D // 2]
        lo = (x_lo.double() * c_lo.double() - (x_hi * s_lo).double()).float()
        hi = (x_hi.double() * c_hi.double() + (x_lo * s_hi).double()).float()
        out = torch.empty_like(flat)
        out[lo_idx], out[lo_idx + D // 2] = lo, hi
        outs.append(out.to(src.dtype).view(src.shape))
    return tuple(outs)


def rope_inputs(seed, T, hq, hk, D):
    """test_apply_rope_token_first's inputs (tests/test_torch_ops.py): normal q and k, tables of angles in [0, 6)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((T, hq, D)).astype(np.float32)
    k = rng.standard_normal((T, hk, D)).astype(np.float32)
    ang = rng.random((T, D)).astype(np.float32) * 6.0
    return q, k, np.cos(ang), np.sin(ang)


@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
@pytest.mark.parametrize("T, hq, hk, D", [(5, 4, 2, 128), (16, 4, 2, 128), (4, 32, 8, 128), (3, 16, 1, 64)])
def test_vector_model_matches_the_plain_version_and_pallas_interpret(T, hq, hk, D, dtype_name):
    dtype = DTYPES[dtype_name]
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    arrays = [jnp.asarray(a, jdt) for a in rope_inputs(6, T, hq, hk, D)]
    q, k, cos, sin = (torch.from_numpy(np.array(a, np.float32)).to(dtype) for a in arrays)
    got = vector_model(q, k, cos, sin)
    tol = F32 if dtype == torch.float32 else tols_for(dtype)
    for g, want in zip(got, rope.rope_token_first_plain(q, k, cos, sin)):
        assert g.dtype == want.dtype == dtype
        check_tol_diff(g.float(), want.float(), **tol)
    for g, x in zip(got, arrays[:2]):
        want = jax_rope_token_first(x, arrays[2], arrays[3], interpret=True)
        check_tol_diff(g.float(), np.asarray(want.astype(jnp.float32)), **tol)


def test_vector_model_equals_the_plain_version_bit_for_bit_in_most_places():
    """The fused add differs from the plain version's two roundings by at most an fp32 ulp before the store: in
    bf16 almost every element lands on the same value."""
    q, k, cos, sin = (torch.from_numpy(a).bfloat16() for a in rope_inputs(7, 16, 32, 8, 128))
    got, want = vector_model(q, k, cos, sin), rope.rope_token_first_plain(q, k, cos, sin)
    for g, w in zip(got, want):
        moved = int((g != w).sum())
        assert moved <= g.numel() // 1000, moved
        ulps = (g.view(torch.int16).int() - w.view(torch.int16).int()).abs()
        assert ulps.max().item() <= 1


@pytest.fixture()
def launches(monkeypatch):
    """The wrapper's launch calls, recorded instead of made (meta tensors carry no values); the counter is restored
    after the test."""
    calls = []
    monkeypatch.setattr(build, "launch", lambda name, device, *args: calls.append((name, args)))
    monkeypatch.setattr(rope, "launches", rope.launches)
    return calls


def meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, device="meta", dtype=dtype)


@pytest.mark.parametrize("T, hq, hk, D, dtype, vector", [
    (1650, 32, 8, 128, torch.bfloat16, True), (4, 80, 8, 128, torch.bfloat16, True),
    (4, 128, 1, 64, torch.bfloat16, True), (7, 32, 8, 128, torch.float32, True), (1, 32, 8, 64, torch.float16, True),
    (5, 4, 2, 96, torch.bfloat16, False), (3, 4, 2, 32, torch.float32, False),
])
def test_each_route_reaches_its_launch(launches, T, hq, hk, D, dtype, vector):
    """Off the CPU the wrapper picks the route from shapes and pointers alone and launches once, with the route's
    flag and the vector route's block size."""
    before = rope.launches
    q_out, k_out = rope.rope_token_first(meta(T, hq, D, dtype=dtype), meta(T, hk, D, dtype=dtype),
                                         meta(T, D, dtype=dtype), meta(T, D, dtype=dtype))
    assert q_out.shape == (T, hq, D) and k_out.shape == (T, hk, D)
    ((name, args),) = launches
    assert name == "mojo_rope_token_first"
    assert args[6:12] == (T, hq, hk, D, int(vector), rope.THREADS)
    assert rope.launches == before + 1


def test_source_instantiates_the_vector_widths_and_block_sizes():
    src = (build.CSRC_DIR / "rope.cu").read_text()
    cases = sorted((int(a), int(b)) for a, b in re.findall(r"MOJO_ROPE_CASE\((\d+), (\d+)\)\n", src))
    assert cases == sorted((D, t) for D in rope.VECTOR_WIDTHS for t in (128, 256))
    assert rope.THREADS in (128, 256)
