"""Kernel F's schedule on the CPU.

``csrc/int8_matmul.cu`` has three routes, which ``int8_matmul.route``
picks from M, N, K and the layout alone:

- prefill (M > 16, an (N, K) weight): wgmma on 128 x BN tiles (BN 256, or
  128 where fewer rounds of 128-wide units take less of the card), units
  (m tile, n tile) with the m tile fastest, dealt round robin to a
  persistent grid; 128-byte k slices loaded by TMA, zero past M, N and K;
  int32 sums; the epilogue ``(float(acc) * xs[m]) * ws[n]``, rounded once,
  stored 16 bytes a lane after the values of a quad of lanes (16-bit
  output) or a pair (fp32) are swapped by shuffles.
- decode (M <= 16): 16 x 32 mma.sync tiles over 128-deep k-tiles, K split
  over gridDim.z into ranges of whole k-tiles where the output tiles leave
  SMs idle; each split writes its int32 tile to scratch and the last to
  arrive sums the splits in order, runs the epilogue and returns its
  counter to 0.
- a (K, N) weight at M > 16: 128 x 128 mma.sync tiles.

``schedule_model`` repeats the two new routes in plain PyTorch (int64
sums of each unit's or split's k slices, the fp32 epilogue in the
kernel's order) and is held exactly to the plain version
(``int8_scaled_matmul_plain``, which ``tests/test_torch_quant.py`` holds to
JAX), and at one shape to JAX's Pallas kernel in interpret mode. The
tests also check what the schedule promises: every output element in
exactly one unit, split ranges covering K once with none empty, the
lanes' 16-byte stores covering each row of a unit once, the scratch the
wrapper sizes from shapes, and that a call with ``meta`` tensors (no
values to read) reaches the launch.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mojo_opset_tpu.backends.pallas.kernels.int8_matmul import int8_scaled_matmul as jax_int8_scaled_matmul
from mojo_opset_tpu_torch.backends.cuda import build
from mojo_opset_tpu_torch.backends.cuda.kernels import int8_matmul

SMS = 132
BM, BK = int8_matmul.PREFILL_BM, int8_matmul.PREFILL_BK
DM, DN, DK = int8_matmul.DECODE_M, int8_matmul.DECODE_BN, int8_matmul.DECODE_BK
OUT_DTYPES = {"bf16": torch.bfloat16, "fp16": torch.float16, "fp32": torch.float32}
# (M, K, N): Qwen3-4B's gate/up and k/v at a small prefill, ragged M, N and K, an N that fills no 16-byte vector;
# decode shapes that split K and one that does not
PREFILL_CASES = {"gate-up": (200, 256, 1024), "kv-narrow": (150, 128, 256), "ragged": (130, 272, 400),
                 "odd-n": (70, 144, 37)}
DECODE_CASES = {"kv-split": (8, 2560, 1024), "o-split": (1, 4096, 2560), "ragged-split": (5, 272, 400),
                "wide-no-split": (4, 256, 17000)}


def _cdiv(a, b):
    return -(-a // b)


def inputs(M, K, N, seed, unit=False):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.integers(-128, 128, (M, K)).astype(np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, (N, K)).astype(np.int8))
    xs = torch.ones(M, 1) if unit else torch.from_numpy(rng.uniform(0.01, 0.1, (M, 1)).astype(np.float32))
    ws = torch.ones(N) if unit else torch.from_numpy(rng.uniform(1e-4, 1e-3, N).astype(np.float32))
    return x, w, xs, ws


def epilogue(acc, xs, ws, dtype):
    """(float(acc) * xs[m]) * ws[n] in fp32, rounded once."""
    return ((acc.float() * xs.reshape(-1, 1).float()) * ws.reshape(1, -1).float()).to(dtype)


def prefill_units(M, N, bn, sms=SMS):
    """The persistent grid's units in order, (m tile, n tile) with the m tile fastest, and each block's units."""
    m_tiles, n_tiles = _cdiv(M, BM), _cdiv(N, bn)
    order = [(u % m_tiles, u // m_tiles) for u in range(m_tiles * n_tiles)]
    grid = min(len(order), sms)
    return order, [order[b::grid] for b in range(grid)]


def split_ranges(K, splits):
    """The decode route's k-tile ranges: split z takes [z per, min((z + 1) per, k_tiles))."""
    k_tiles = _cdiv(K, DK)
    per = _cdiv(k_tiles, splits)
    return [(z * per, min((z + 1) * per, k_tiles)) for z in range(splits)]


def schedule_model(x, w, xs, ws, dtype, sms=SMS):
    """F's output, unit by unit (prefill) or split by split (decode), as the kernel's loads see the operands:
    zero past M, N and K (TMA's fill, or cp.async's zero fill)."""
    M, K = x.shape
    N = w.shape[0]
    plan = int8_matmul.route(M, N, K, True, sms)
    out = torch.full((M, N), float("nan"), dtype=torch.float32).to(dtype)
    if plan.code in (int8_matmul.WGMMA_128, int8_matmul.WGMMA_256):
        bn = 256 if plan.code == int8_matmul.WGMMA_256 else 128
        k_pad = _cdiv(K, BK) * BK
        xb = torch.zeros(_cdiv(M, BM) * BM, k_pad, dtype=torch.int64)
        xb[:M, :K] = x.long()
        wb = torch.zeros(_cdiv(N, bn) * bn, k_pad, dtype=torch.int64)
        wb[:N, :K] = w.long()
        order, _ = prefill_units(M, N, bn, sms)
        for mt, nt in order:
            acc = torch.zeros(BM, bn, dtype=torch.int64)
            for k0 in range(0, k_pad, BK):  # a stage's 128-byte k slice
                acc += xb[mt * BM:(mt + 1) * BM, k0:k0 + BK] @ wb[nt * bn:(nt + 1) * bn, k0:k0 + BK].T
            rows, cols = min(BM, M - mt * BM), min(bn, N - nt * bn)
            m0, n0 = mt * BM, nt * bn
            out[m0:m0 + rows, n0:n0 + cols] = epilogue(acc[:rows, :cols], xs[m0:m0 + rows], ws[n0:n0 + cols], dtype)
        return out
    assert plan.code == int8_matmul.DECODE_MMA
    k_tiles = _cdiv(K, DK)
    xb = torch.zeros(_cdiv(M, DM) * DM, k_tiles * DK, dtype=torch.int64)
    xb[:M, :K] = x.long()
    wb = torch.zeros(_cdiv(N, DN) * DN, k_tiles * DK, dtype=torch.int64)
    wb[:N, :K] = w.long()
    for mt in range(_cdiv(M, DM)):
        for nt in range(_cdiv(N, DN)):
            parts = [xb[mt * DM:(mt + 1) * DM, lo * DK:hi * DK] @ wb[nt * DN:(nt + 1) * DN, lo * DK:hi * DK].T
                     for lo, hi in split_ranges(K, plan.splits)]
            acc = torch.zeros(DM, DN, dtype=torch.int64)
            for p in parts:  # the last block to arrive sums the splits in order
                acc += p
            assert acc.abs().max() < 2 ** 31  # the kernel's int32 partials hold every sum exactly
            rows, cols = min(DM, M - mt * DM), min(DN, N - nt * DN)
            m0, n0 = mt * DM, nt * DN
            out[m0:m0 + rows, n0:n0 + cols] = epilogue(acc[:rows, :cols], xs[m0:m0 + rows], ws[n0:n0 + cols], dtype)
    return out


@pytest.mark.parametrize("unit", [False, True], ids=["scales", "unit-scales"])
@pytest.mark.parametrize("out", list(OUT_DTYPES))
@pytest.mark.parametrize("name", list(PREFILL_CASES) + list(DECODE_CASES))
def test_schedule_model_equals_the_plain_version(name, out, unit):
    M, K, N = {**PREFILL_CASES, **DECODE_CASES}[name]
    x, w, xs, ws = inputs(M, K, N, seed=len(name), unit=unit)
    dtype = OUT_DTYPES[out]
    got = schedule_model(x, w, xs, ws, dtype)
    want = int8_matmul.int8_scaled_matmul_plain(x, w, xs, ws, True, dtype)
    assert not got.float().isnan().any(), "an output element no unit stored"
    assert torch.equal(got, want)


def test_schedule_model_matches_the_pallas_kernel_in_interpret_mode():
    """At a shape the Pallas kernel takes (M % 8, K % 128, N % 128 == 0), fp32 output: the exact int32 sums give
    the same values up to the epilogue's order (JAX multiplies the two scales first), as tests/test_torch_quant.py
    holds the plain version to it."""
    M, K, N = 64, 256, 256
    x, w, xs, ws = inputs(M, K, N, seed=3)
    assert int8_matmul.route(M, N, K, True, SMS).code in (int8_matmul.WGMMA_128, int8_matmul.WGMMA_256)
    want = jax_int8_scaled_matmul(jnp.asarray(x.numpy()), jnp.asarray(w.numpy()), jnp.asarray(xs.numpy()[:, 0]),
                                  jnp.asarray(ws.numpy()), out_dtype=jnp.float32, trans_weight=True, interpret=True)
    got = schedule_model(x, w, xs, ws, torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=0)


@pytest.mark.parametrize("M, N", [(1650, 9728), (1650, 1024), (130, 400), (70, 37), (2000, 5120)])
def test_prefill_units_cover_each_output_element_once(M, N):
    bn = int8_matmul.prefill_tile_n(M, N, SMS)
    order, blocks = prefill_units(M, N, bn)
    covered = torch.zeros(_cdiv(M, BM) * BM, _cdiv(N, bn) * bn, dtype=torch.int8)
    for mt, nt in order:
        covered[mt * BM:(mt + 1) * BM, nt * bn:(nt + 1) * bn] += 1
    assert (covered == 1).all()
    assert sorted(u for b in blocks for u in b) == sorted(order)  # the round robin deals every unit once
    assert max(map(len, blocks)) - min(map(len, blocks)) <= 1
    if len(order) >= 2 * _cdiv(M, BM):  # consecutive units share an n tile: blocks in flight share a weight slab
        assert order[0][1] == order[1][1]


@pytest.mark.parametrize("M, N, K", [(8, 1024, 2560), (8, 9728, 2560), (1, 2560, 4096), (5, 400, 272),
                                     (8, 1024, 5120), (16, 5120, 27648), (4, 151936, 2560), (8, 64, 128)])
def test_decode_splits_cover_k_once_and_none_is_empty(M, N, K):
    splits = int8_matmul.decode_splits(M, N, K, SMS)
    ranges = split_ranges(K, splits)
    k_tiles = _cdiv(K, DK)
    assert ranges[0][0] == 0 and ranges[-1][1] == k_tiles
    assert all(lo < hi for lo, hi in ranges) and all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    tiles, target = _cdiv(M, DM) * _cdiv(N, DN), int8_matmul.DECODE_BLOCKS_PER_SM * SMS
    if splits > 1:  # split only below the target, and no further than it needs
        assert tiles < target and splits <= min(_cdiv(target, tiles), k_tiles)
        assert int8_matmul.split_scratch_ints(M, N, splits) == splits * tiles * DM * DN
    else:
        assert tiles * 2 > target or k_tiles < 2


def test_arrival_counters_return_to_zero():
    """The split launch's protocol: each of a tile's blocks adds one to its counter after writing its partial;
    the block that reads splits - 1 sums every split and sets the counter back to 0, so a second launch (or a
    CUDA graph's replay) finds zeros."""
    splits, tiles = 5, 7
    counters = [0] * tiles
    rng = np.random.default_rng(0)
    for _launch in range(2):
        arrivals = [(t, z) for t in range(tiles) for z in range(splits)]
        rng.shuffle(arrivals)  # blocks run in no order
        summed = []
        for t, _z in arrivals:
            prev, counters[t] = counters[t], counters[t] + 1
            if prev == splits - 1:
                summed.append(t)
                counters[t] = 0
        assert sorted(summed) == list(range(tiles)) and counters == [0] * tiles


def quad_transpose(words):
    """csrc/int8_matmul.cu quad_transpose over the 4 lanes of a quad: words[q][i] is lane q's word of column
    group i; two exchanges, with lanes q ^ 2 then q ^ 1."""
    u = [list(w) for w in words]
    for mask, pick, keep in ((2, lambda q: (0, 1) if q & 2 else (2, 3), lambda q: (0, 1) if q & 2 else (2, 3)),
                             (1, lambda q: (0, 2) if q & 1 else (1, 3), lambda q: (0, 2) if q & 1 else (1, 3))):
        sent = [[u[q][i] for i in pick(q)] for q in range(4)]
        for q in range(4):
            for slot, value in zip(keep(q), sent[q ^ mask]):
                u[q][slot] = value
    return u


@pytest.mark.parametrize("bn", [128, 256])
def test_epilogue_lanes_store_each_column_of_a_row_once(bn):
    """The wgmma accumulator gives lane q of a quad columns 8j + 2q and + 1 of its row. After the exchanges
    each lane stores 16 contiguous bytes: 16-bit output, 8 columns from 32 t + 8 q; fp32, 4 columns from
    16 t + 2 q (even lanes) or 16 t + 8 + 2 q - 2 (odd lanes). Every column of the tile's row is stored once."""
    held = {q: {j: (8 * j + 2 * q, 8 * j + 2 * q + 1) for j in range(bn // 8)} for q in range(4)}
    stores16 = []
    for t in range(bn // 32):
        after = quad_transpose([[held[q][4 * t + i] for i in range(4)] for q in range(4)])
        for q in range(4):
            cols = [c for pair in after[q] for c in pair]
            assert cols == list(range(32 * t + 8 * q, 32 * t + 8 * q + 8))  # the address the lane stores to
            stores16 += cols
    assert sorted(stores16) == list(range(bn))
    stores32 = []
    for t in range(bn // 16):
        for q in range(4):
            lo = q & 1
            mine, partner = held[q], held[q ^ 1]
            cols = list(partner[2 * t + 1]) + list(mine[2 * t + 1]) if lo else list(mine[2 * t]) + list(partner[2 * t])
            start = 16 * t + 8 + 2 * q - 2 if lo else 16 * t + 2 * q
            assert cols == list(range(start, start + 4))
            stores32 += cols
    assert sorted(stores32) == list(range(bn))


def test_route_is_chosen_from_shapes():
    r = int8_matmul.route
    assert r(1650, 9728, 2560, True, SMS) == (int8_matmul.WGMMA_256, 1)
    assert r(1650, 1024, 2560, True, SMS) == (int8_matmul.WGMMA_128, 1)  # 52 units of 256 would idle 80 SMs
    assert r(1650, 1024, 5120, True, SMS) == (int8_matmul.WGMMA_128, 1)  # Seed-OSS-36B's k/v
    assert r(1650, 27648, 5120, True, SMS) == (int8_matmul.WGMMA_256, 1)
    assert r(17, 4096, 2560, True, SMS) == (int8_matmul.WGMMA_128, 1)  # one m tile: 32 units of 128, not 16 of 256
    assert r(8, 1024, 2560, True, SMS) == (int8_matmul.DECODE_MMA, 10)  # 32 tiles: K split
    assert r(4, 151936, 2560, True, SMS) == (int8_matmul.DECODE_MMA, 1)  # the lm_head fills the card
    assert r(16, 400, 272, False, SMS).code == int8_matmul.DECODE_MMA  # both layouts split at decode
    assert r(130, 400, 272, False, SMS) == (int8_matmul.LARGE_MMA, 1)  # a (K, N) weight keeps mma.sync


def test_route_codes_match_the_kernel_source():
    src = (build.CSRC_DIR / "int8_matmul.cu").read_text()
    enum = dict((name, int(v)) for name, v in re.findall(r"kRoute(\w+) = (\d)", src))
    assert enum == {"LargeMma": int8_matmul.LARGE_MMA, "DecodeMma": int8_matmul.DECODE_MMA,
                    "Wgmma128": int8_matmul.WGMMA_128, "Wgmma256": int8_matmul.WGMMA_256}
    assert Path(build.CSRC_DIR / "hopper.cuh").read_text().count("s32.s8.s8") == 2  # m64n128k32 and m64n256k32


@pytest.mark.parametrize("M, N, K", [(1650, 1024, 2560), (8, 1024, 2560), (8, 9728, 2560), (130, 400, 272)],
                         ids=["prefill", "decode-split", "decode", "ragged"])
def test_launch_reads_no_value_on_the_host(monkeypatch, M, N, K):
    """Off the CPU the wrapper picks the route and sizes the scratch from shapes alone: with meta tensors (no
    values to read) it reaches the launch, which raises here without a build, and counts no launch."""
    monkeypatch.setattr(build, "load_library", lambda: (_ for _ in ()).throw(RuntimeError("no kernels built")))
    meta = lambda *shape, dtype=torch.int8: torch.empty(shape, device="meta", dtype=dtype)  # noqa: E731
    before = int8_matmul.launches
    with pytest.raises(RuntimeError, match="no kernels built"):
        int8_matmul.int8_scaled_matmul(meta(M, K), meta(N, K), meta(M, 1, dtype=torch.float32),
                                       meta(N, dtype=torch.float32), True, torch.bfloat16)
    assert int8_matmul.launches == before
