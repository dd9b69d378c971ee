"""Kernel G's schedule on the CPU.

``csrc/int4_matmul.cu`` has three routes, which ``int4_matmul.route`` picks
from M, N and K alone:

- prefill (M > 16): the wgmma kernel of ``csrc/int_wgmma.cuh`` in its
  PACKED form. TMA brings BN / 2 packed rows (128-byte k slices, in the
  128-byte swizzle) a stage; the consumer threads unpack each 16-byte chunk
  into the low and the high half of its group's rows of the int8 B tile, at
  the same offset, as 16 x the weights; units (m tile, k split, n tile)
  with the m tile fastest; K split where the output tiles fill at most half
  the SMs, the last split to arrive summing in split order; the sums
  shifted right by 4.
- decode (M <= 16): a block owns 8 packed rows and a range of 64-byte warp
  steps; lane (g, q) loads 16 bytes of packed row g at 16 q of each step
  and feeds them to mma.sync as two k32 steps' B fragments beside x's rows
  g and g + 8 at the same bytes. Splits of K end in the last block to
  arrive, which sums them in order and shifts the sum right by 4.

``decode_model`` and ``prefill_model`` repeat those schedules in plain
PyTorch and numpy: the nibble unpack (16 x each weight) as the kernel's
32-bit integer ops,
the mma.sync fragment layout of PTX's m16n8k32, the TMA swizzle and the
converter's offsets, int64 sums of each split and the fp32 epilogue in the
kernel's order. They are held exactly to the plain version
(``int4_scaled_matmul_plain``, which ``tests/test_torch_w4a8.py`` holds to
JAX), and at one shape to JAX's Pallas kernel in interpret mode. The tests
also check what the schedule promises: every output element in exactly one
unit, split ranges covering K once with none empty, the scratch the wrapper
sizes from shapes, the route codes of the source, and that a call with
``meta`` tensors (no values to read) reaches the launch.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mojo_opset_tpu.backends.pallas.kernels.int4_matmul import int4_scaled_matmul as jax_int4_scaled_matmul
from mojo_opset_tpu_torch.backends.cuda import build
from mojo_opset_tpu_torch.backends.cuda.kernels import int4_matmul
from mojo_opset_tpu_torch.core.operators.gemm import pack_int4_rows, unpack_int4_rows

SMS = 132
BM, BK = int4_matmul.PREFILL_BM, int4_matmul.PREFILL_BK
STEP, ROWS = int4_matmul.DECODE_STEP, int4_matmul.DECODE_CHANNELS // 2
OUT_DTYPES = {"bf16": torch.bfloat16, "fp16": torch.float16, "fp32": torch.float32}
# (M, K, N): the draft's decode rows (1, 5), the route's largest M, a ragged K, K splits
DECODE_CASES = {"m1-split": (1, 512, 256), "m4-ragged-k": (4, 272, 384), "m5-split": (5, 640, 128),
                "m16": (16, 272, 256), "m8-wide": (8, 128, 2048)}
# (M, K, N, SMs): a grid of 2 SMs makes 256-wide tiles the cheaper
PREFILL_CASES = {"split": (40, 1024, 256, SMS), "ragged": (130, 272, 384, SMS), "wide-tile": (200, 256, 512, 2)}
# the draft's projections (Qwen3-4B, K x N): q, k/v, o, gate/up, down
DRAFT_SHAPES = ((2560, 4096), (2560, 1024), (4096, 2560), (2560, 9728), (9728, 2560))


def _cdiv(a, b):
    return -(-a // b)


def inputs(M, K, N, seed, unit=False):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.integers(-128, 128, (M, K)).astype(np.int8))
    wp = torch.from_numpy(rng.integers(-128, 128, (N // 2, K)).astype(np.int8))
    xs = torch.ones(M, 1) if unit else torch.from_numpy(rng.uniform(0.01, 0.1, (M, 1)).astype(np.float32))
    ws = torch.ones(N) if unit else torch.from_numpy(rng.uniform(1e-3, 1e-2, N).astype(np.float32))
    return x, wp, xs, ws


def epilogue(acc, xs, ws, dtype):
    """(float(acc) * xs[m]) * ws[n] in fp32, rounded once."""
    return ((acc.float() * xs.reshape(-1, 1).float()) * ws.reshape(1, -1).float()).to(dtype)


def unpack_words(p, high):
    """int_wgmma.cuh nib16_lo / nib16_hi on uint32 words: (p << 4) & 0xF0F0F0F0 (low), p & 0xF0F0F0F0 (high)."""
    p = p.astype(np.uint32)
    return ((p if high else p << np.uint32(4)) & np.uint32(0xF0F0F0F0)).astype(np.uint32)


def shift4(acc):
    """The kernels' arithmetic shift right by 4 of the 16 x int4 sums: exact."""
    assert (acc % 16 == 0).all()
    return acc >> 4


def word_bytes(words):
    """uint32 words -> their four bytes as int8, low byte first (the kernel's little-endian registers)."""
    return np.ascontiguousarray(words.astype("<u4")).view(np.int8).reshape(*words.shape, 4)


def channel_of(p, high):
    """The channel of packed row p's low or high nibble (pack_int4_rows)."""
    return (p // 64) * 128 + (64 if high else 0) + p % 64


def test_unpack_ops_give_the_nibbles_of_every_byte():
    """Every byte value in every byte position of a word: the integer ops give 16 x ((v ^ 8) - 8) of each nibble v,
    16 x unpack_int4_rows's values, and no bit crosses into the next byte."""
    values = np.arange(256, dtype=np.uint32)
    for pos in range(4):
        words = (values << np.uint32(8 * pos)) | np.uint32(0x5A00005A & ~(0xFF << (8 * pos)))
        for high in (False, True):
            got = word_bytes(unpack_words(words, high))
            raw = word_bytes(words).astype(np.int64) & 0xFF
            nib = (raw >> 4) & 15 if high else raw & 15
            np.testing.assert_array_equal(got.astype(np.int64), 16 * ((nib ^ 8) - 8))
    packed = torch.from_numpy(np.arange(-128, 128, dtype=np.int8).reshape(1, 256).repeat(64, 0))
    want = unpack_int4_rows(packed)  # (128, 256): rows 0-63 low nibbles, 64-127 high
    words = packed.numpy().view(np.uint32)
    for high in (False, True):
        got = word_bytes(unpack_words(words, high)).reshape(64, 256)
        np.testing.assert_array_equal(got.astype(np.int64), 16 * want[64 * high:64 * high + 64].numpy().astype(int))


# ---------------------------------------------------------------- decode


def split_steps(K, splits):
    """Split z's warp steps: [z per, min((z + 1) per, k_steps))."""
    k_steps = _cdiv(K, STEP)
    per = _cdiv(k_steps, splits)
    return [(z * per, min((z + 1) * per, k_steps)) for z in range(splits)]


def mma_m16n8k32(a, b):
    """PTX's mma.m16n8k32 s8 fragments: a[lane] 4 words, b[lane] 2 words, lane = 4 g + q. A[g + 8 (i % 2)][4 q +
    j + 16 (i // 2)] = byte j of a[lane][i]; B[4 q + j + 16 i][g] = byte j of b[lane][i]. Returns D (16, 8) int64
    and the lanes' c[i] = D[g + 8 (i // 2)][2 q + i % 2]."""
    A = np.zeros((16, 32), np.int64)
    B = np.zeros((32, 8), np.int64)
    for lane in range(32):
        g, q = divmod(lane, 4)
        ab, bb = word_bytes(a[lane]), word_bytes(b[lane])
        for i in range(4):
            A[g + 8 * (i % 2), 4 * q + 16 * (i // 2):4 * q + 16 * (i // 2) + 4] = ab[i]
        for i in range(2):
            B[4 * q + 16 * i:4 * q + 16 * i + 4, g] = bb[i]
    D = A @ B
    return D, [[D[lane // 4 + 8 * (i // 2), 2 * (lane % 4) + i % 2] for i in range(4)] for lane in range(32)]


def decode_model(x, wp, xs, ws, dtype, sms=SMS):
    """Kernel G's decode output, lane by lane: 16-byte loads of packed rows and x (zero past K), the mma.sync
    fragments, the warps' sums and the splits' sums in order."""
    M, K = x.shape
    N = wp.shape[0] * 2
    plan = int4_matmul.route(M, N, K, sms)
    assert plan.code == int4_matmul.DECODE
    k_pad = _cdiv(K, STEP) * STEP
    xb = np.zeros((16, k_pad), np.int8)
    xb[:M, :K] = x.numpy()
    wb = np.zeros((N // 2, k_pad), np.int8)
    wb[:, :K] = wp.numpy()
    out = torch.full((M, N), float("nan")).to(dtype)
    for tile in range(N // 16):
        p0 = tile * ROWS
        acc = np.zeros((16, 16), np.int64)  # the block tile [m][c], c < 8 low channels
        for lo_step, hi_step in split_steps(K, plan.splits):
            for step in range(lo_step, hi_step):  # which warp takes a step does not change the int sums
                k = step * STEP
                # lane (g, q): 16 bytes of packed row p0 + g and of x's rows at k + 16 q, as four words
                wv = [wb[p0 + lane // 4, k + 16 * (lane % 4):k + 16 * (lane % 4) + 16].view(np.uint32)
                      for lane in range(32)]
                xa = [xb[lane // 4, k + 16 * (lane % 4):][:16].view(np.uint32) for lane in range(32)]
                xc = [xb[lane // 4 + 8, k + 16 * (lane % 4):][:16].view(np.uint32) for lane in range(32)]
                for half in range(2):  # words 0-1, then 2-3: two k32 steps
                    a = [np.array([xa[ln][2 * half], xc[ln][2 * half], xa[ln][2 * half + 1],
                                   xc[ln][2 * half + 1]], np.uint32) for ln in range(32)]
                    for high in (False, True):
                        b = [unpack_words(wv[ln][2 * half:2 * half + 2], high) for ln in range(32)]
                        D, frags = mma_m16n8k32(a, b)
                        for lane in range(32):  # the accumulator fragment as the kernel writes it out
                            g, q = divmod(lane, 4)
                            for i in range(4):
                                acc[g + 8 * (i // 2), 8 * high + 2 * q + i % 2] += frags[lane][i]
        assert np.abs(acc).max() < 2 ** 31  # the int32 partials hold every sum exactly
        acc = shift4(acc)
        for c in range(16):
            n = channel_of(p0 + c % 8, c >= 8)
            out[:, n] = epilogue(torch.from_numpy(acc[:M, c]).reshape(M, 1), xs, ws[n:n + 1], dtype)[:, 0]
    return out


@pytest.mark.parametrize("unit", [False, True], ids=["scales", "unit-scales"])
@pytest.mark.parametrize("out", list(OUT_DTYPES))
@pytest.mark.parametrize("name", list(DECODE_CASES))
def test_decode_model_equals_the_plain_version(name, out, unit):
    M, K, N = DECODE_CASES[name]
    x, wp, xs, ws = inputs(M, K, N, seed=len(name), unit=unit)
    dtype = OUT_DTYPES[out]
    got = decode_model(x, wp, xs, ws, dtype)
    assert not got.float().isnan().any(), "an output element no block stored"
    assert torch.equal(got, int4_matmul.int4_scaled_matmul_plain(x, wp, xs, ws, dtype))


def test_decode_lane_map_gives_unpack_int4_rows_channels():
    """One k32 step through the fragment layout, with x one-hot: D[m][n] is 16 x the unpacked weight of channel
    channel_of(p0 + n) at the k that the one-hot row m selects, for both nibbles."""
    rng = np.random.default_rng(5)
    wp = rng.integers(-128, 128, (8, 64)).astype(np.int8)  # 8 packed rows, one 64-byte warp step
    w = unpack_int4_rows(torch.from_numpy(np.concatenate([wp, np.zeros((56, 64), np.int8)]))).numpy()
    for k in (0, 5, 17, 23, 40, 63):  # a byte of lane q = k // 16, word (k % 16) // 4
        x = np.zeros((16, 64), np.int8)
        x[3, k] = 1
        half = (k % 16) // 8
        a = [np.array([x[ln // 4, 16 * (ln % 4):][:16].view(np.uint32)[2 * half + i // 2] if i % 2 == 0 else
                       x[ln // 4 + 8, 16 * (ln % 4):][:16].view(np.uint32)[2 * half + i // 2]
                       for i in range(4)], np.uint32) for ln in range(32)]
        for high in (False, True):
            b = [unpack_words(wp[ln // 4, 16 * (ln % 4):][:16].view(np.uint32)[2 * half:2 * half + 2], high)
                 for ln in range(32)]
            D, _ = mma_m16n8k32(a, b)
            want = [16 * w[channel_of(p, high), k] for p in range(8)]
            np.testing.assert_array_equal(D[3], want)
            assert not D[np.arange(16) != 3].any()


@pytest.mark.parametrize("M, N, K", [(1, 4096, 2560), (1, 1024, 2560), (1, 2560, 4096), (1, 9728, 2560),
                                     (1, 2560, 9728), (5, 1024, 2560), (3, 384, 272), (16, 128, 16), (1, 256, 512)])
def test_decode_splits_cover_k_once_and_none_is_empty(M, N, K):
    splits = int4_matmul.decode_splits(M, N, K, SMS)
    ranges = split_steps(K, splits)
    assert ranges[0][0] == 0 and ranges[-1][1] == _cdiv(K, STEP)
    assert all(lo < hi for lo, hi in ranges) and all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    tiles, target = N // 16, SMS // int4_matmul.DECODE_SPLIT_SM_SHARE
    if splits > 1:  # split only below the target, and no further than it needs
        assert tiles < target and splits <= _cdiv(target, tiles)
        assert int4_matmul.split_scratch_ints(M, N, int4_matmul.route(M, N, K, SMS)) == splits * tiles * M * 16
    else:
        assert tiles >= target or _cdiv(K, STEP) < 2
    # one run of DECODE_UNROLL steps a warp, where 16 warps suffice and the grid stays one wave of 32 warps an SM
    warps = int4_matmul.decode_warps(N, K, splits, SMS)
    steps = ranges[0][1] - ranges[0][0]
    assert 1 <= warps <= min(int4_matmul.DECODE_MAX_WARPS, _cdiv(steps, int4_matmul.DECODE_UNROLL))
    assert warps == 1 or tiles * splits * warps <= int4_matmul.DECODE_WARPS_PER_SM * SMS
    assert warps == min(int4_matmul.DECODE_MAX_WARPS, _cdiv(steps, int4_matmul.DECODE_UNROLL)) or (
        tiles * splits * (warps + 1) > int4_matmul.DECODE_WARPS_PER_SM * SMS)


# ---------------------------------------------------------------- prefill


def swizzle(rows):
    """The 128-byte swizzle of a tile of `rows` 128-byte rows: byte offset of logical (row, k)."""
    r, k = np.meshgrid(np.arange(rows), np.arange(128), indexing="ij")
    return r * 128 + ((k // 16) ^ (r % 8)) * 16 + k % 16


def converted_tile(packed_tile):
    """TMA lands the (BN / 2, 128) packed tile swizzled; the converters unpack each 16-byte chunk c to offset
    16384 (c // 512) + 16 (c % 512) of the B tile (low nibbles) and 8192 further (high); wgmma reads B (BN, 128)
    through the same swizzle. Returns B as wgmma sees it."""
    rows = packed_tile.shape[0]
    smem = np.zeros(rows * 128, np.uint8)
    smem[swizzle(rows)] = packed_tile.view(np.uint8)
    chunks = smem.view(np.uint32).reshape(rows * 8, 4)
    c = np.arange(rows * 8)
    dst = (16384 * (c // 512) + 16 * (c % 512))[:, None] + np.arange(16)
    b = np.zeros(2 * rows * 128, np.uint8)
    b[dst] = unpack_words(chunks, False).view(np.uint8).reshape(-1, 16)
    b[dst + 8192] = unpack_words(chunks, True).view(np.uint8).reshape(-1, 16)
    return b[swizzle(2 * rows)].view(np.int8)


@pytest.mark.parametrize("bn", [128, 256])
def test_converter_gives_the_tile_channels_in_order(bn):
    """The B tile of n tile t holds 16 x channels t bn .. t bn + bn - 1 in its rows, as unpack_int4_rows gives
    them."""
    rng = np.random.default_rng(bn)
    wp = rng.integers(-128, 128, (bn, 128)).astype(np.int8)  # two n tiles of packed rows, one 128-byte k slice
    w = unpack_int4_rows(torch.from_numpy(wp)).numpy()
    for t in range(2):
        got = converted_tile(wp[t * bn // 2:(t + 1) * bn // 2])
        np.testing.assert_array_equal(got.astype(np.int64), 16 * w[t * bn:(t + 1) * bn].astype(np.int64))


def prefill_units(M, N, K, plan, sms=SMS):
    """The persistent grid's units in order, (m tile, split, n tile) with the m tile fastest, and each block's."""
    bn = 256 if plan.code == int4_matmul.WGMMA_256 else 128
    m_tiles, n_tiles = _cdiv(M, BM), _cdiv(N, bn)
    order = [(u % m_tiles, (u // m_tiles) % plan.splits, u // m_tiles // plan.splits)
             for u in range(m_tiles * n_tiles * plan.splits)]
    grid = min(len(order), sms)
    return bn, order, [order[b::grid] for b in range(grid)]


def split_tiles(K, splits):
    k_tiles = _cdiv(K, BK)
    per = _cdiv(k_tiles, splits)
    return [(z * per, min((z + 1) * per, k_tiles)) for z in range(splits)]


def prefill_model(x, wp, xs, ws, dtype, sms=SMS):
    """Kernel G's prefill output unit by unit: zero past M, N and K (TMA's fill), each stage's B tile as the
    converters leave it, int64 sums of each split's k-tiles, the splits added in order."""
    M, K = x.shape
    N = wp.shape[0] * 2
    plan = int4_matmul.route(M, N, K, sms)
    assert plan.code in (int4_matmul.WGMMA_128, int4_matmul.WGMMA_256)
    bn, order, _ = prefill_units(M, N, K, plan, sms)
    k_pad = _cdiv(K, BK) * BK
    xb = np.zeros((_cdiv(M, BM) * BM, k_pad), np.int64)
    xb[:M, :K] = x.numpy()
    pb = np.zeros((_cdiv(N, bn) * bn // 2, k_pad), np.int8)
    pb[:N // 2, :K] = wp.numpy()
    parts = {}
    for mt, z, nt in order:
        lo, hi = split_tiles(K, plan.splits)[z]
        acc = np.zeros((BM, bn), np.int64)
        for kt in range(lo, hi):
            b = converted_tile(pb[nt * bn // 2:(nt + 1) * bn // 2, kt * BK:(kt + 1) * BK]).astype(np.int64)
            acc += xb[mt * BM:(mt + 1) * BM, kt * BK:(kt + 1) * BK] @ b.T
        parts[mt, nt, z] = acc
    out = torch.full((M, N), float("nan")).to(dtype)
    for (mt, nt, z), _ in sorted(parts.items()):
        if z:
            continue
        acc = sum(parts[mt, nt, s] for s in range(plan.splits))  # the last to arrive: split order
        assert np.abs(acc).max() < 2 ** 31
        acc = shift4(acc)
        rows, cols = min(BM, M - mt * BM), min(bn, N - nt * bn)
        m0, n0 = mt * BM, nt * bn
        out[m0:m0 + rows, n0:n0 + cols] = epilogue(torch.from_numpy(acc[:rows, :cols]), xs[m0:m0 + rows],
                                                   ws[n0:n0 + cols], dtype)
    return out


@pytest.mark.parametrize("unit", [False, True], ids=["scales", "unit-scales"])
@pytest.mark.parametrize("out", list(OUT_DTYPES))
@pytest.mark.parametrize("name", list(PREFILL_CASES))
def test_prefill_model_equals_the_plain_version(name, out, unit):
    M, K, N, sms = PREFILL_CASES[name]
    x, wp, xs, ws = inputs(M, K, N, seed=len(name) + 7, unit=unit)
    dtype = OUT_DTYPES[out]
    plan = int4_matmul.route(M, N, K, sms)
    assert plan.splits > 1 if name == "split" else plan.code == int4_matmul.WGMMA_256 if name == "wide-tile" else 1
    got = prefill_model(x, wp, xs, ws, dtype, sms)
    assert not got.float().isnan().any(), "an output element no unit stored"
    assert torch.equal(got, int4_matmul.int4_scaled_matmul_plain(x, wp, xs, ws, dtype))


def test_prefill_model_matches_the_pallas_kernel_in_interpret_mode():
    """At a shape the Pallas kernel takes (M % 8, K % 128, N % 128 == 0), fp32 output: the exact int32 sums give
    the same values up to the epilogue's order, as tests/test_torch_w4a8.py holds the plain version to it."""
    M, K, N = 64, 256, 256
    x, wp, xs, ws = inputs(M, K, N, seed=3)
    want = jax_int4_scaled_matmul(jnp.asarray(x.numpy()), jnp.asarray(wp.numpy()), jnp.asarray(xs.numpy()[:, 0]),
                                  jnp.asarray(ws.numpy()), out_dtype=jnp.float32, interpret=True)
    got = prefill_model(x, wp, xs, ws, torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=0)


@pytest.mark.parametrize("M", [512, 130, 17, 64])
@pytest.mark.parametrize("K, N", DRAFT_SHAPES)
def test_prefill_units_cover_each_output_element_once(M, K, N):
    plan = int4_matmul.route(M, N, K, SMS)
    bn, order, blocks = prefill_units(M, N, K, plan)
    covered = np.zeros((_cdiv(M, BM) * BM, _cdiv(N, bn) * bn, _cdiv(K, BK)), np.int8)
    for mt, z, nt in order:
        lo, hi = split_tiles(K, plan.splits)[z]
        assert lo < hi  # no split is empty
        covered[mt * BM:(mt + 1) * BM, nt * bn:(nt + 1) * bn, lo:hi] += 1
    assert (covered == 1).all()  # every (output element, k-tile) in exactly one unit
    assert sorted(u for b in blocks for u in b) == sorted(order)
    assert max(map(len, blocks)) - min(map(len, blocks)) <= 1
    if _cdiv(M, BM) > 1:  # consecutive units share a weight slab
        assert order[0][1:] == order[1][1:]
    if plan.splits > 1:
        # split only one m tile whose units leave most SMs idle, into no more units than SMs, each at least 4 k-tiles
        assert M <= BM and 2 * len(order) // plan.splits <= SMS and len(order) <= SMS
        assert plan.splits <= int4_matmul.PREFILL_MAX_SPLITS
        assert all(hi - lo >= int4_matmul.PREFILL_MIN_SPLIT_TILES for lo, hi in split_tiles(K, plan.splits)[:-1])
        assert int4_matmul.split_scratch_ints(M, N, plan) == plan.splits * _cdiv(M, BM) * BM * _cdiv(N, bn) * bn


def test_route_is_chosen_from_shapes():
    r = int4_matmul.route
    DE, W1, W2 = int4_matmul.DECODE, int4_matmul.WGMMA_128, int4_matmul.WGMMA_256
    assert r(1, 9728, 2560, SMS) == (DE, 1, 6)  # gate/up: 608 blocks of 6 warps, one wave of 32 warps an SM
    assert r(1, 1024, 2560, SMS) == (DE, 1, 10)  # k/v: 64 blocks fill half the SMs, unsplit
    assert r(1, 2560, 9728, SMS) == (DE, 1, 16)  # down: 152 steps, 16 warps
    assert r(1, 4096, 2560, SMS) == r(5, 4096, 2560, SMS) == (DE, 1, 10)  # q: the plan does not depend on M
    assert r(16, 2560, 4096, SMS) == (DE, 1, 16)
    assert r(1, 384, 272, SMS) == (DE, 2, 1)  # 24 blocks fill under a quarter of the SMs: K split
    assert r(17, 4096, 2560, SMS) == (W1, 4, 0)  # one m tile: 32 units, K split
    assert r(512, 4096, 2560, SMS) == (W1, 1, 0)  # 128 units of 128 against 64 of 256
    assert r(512, 1024, 2560, SMS) == (W1, 1, 0)  # k/v: 32 units, but 4 m tiles: unsplit
    assert r(64, 1024, 2560, SMS) == (W1, 4, 0)  # one m tile: K split in 4
    assert r(512, 9728, 2560, SMS) == (W1, 1, 0)  # 304 units of 128: 3 rounds of 128 against 2 of 256
    assert r(130, 9728, 2560, SMS) == (W2, 1, 0)
    assert r(130, 384, 272, SMS) == (W1, 1, 0)  # 3 k-tiles: too few to split


def test_route_codes_match_the_kernel_source():
    src = (build.CSRC_DIR / "int4_matmul.cu").read_text()
    enum = dict((name, int(v)) for name, v in re.findall(r"kRoute(\w+) = (\d)", src))
    assert enum == {"Decode": int4_matmul.DECODE, "Wgmma128": int4_matmul.WGMMA_128, "Wgmma256": int4_matmul.WGMMA_256}
    assert int4_matmul.DECODE_M == int(re.search(r"kMaxM = (\d+)", src).group(1))
    assert int4_matmul.DECODE_MAX_WARPS == int(re.search(r"kMaxWarps = (\d+)", src).group(1))
    assert int4_matmul.DECODE_UNROLL == int(re.search(r"kUnroll = (\d+)", src).group(1))
    assert re.search(r"kStep = (\d+)", src).group(1) == str(STEP)
    assert "MOJO_INT_WGMMA_KERNEL(int4_wgmma_kernel, true)" in src  # the PACKED wgmma kernel, under G's own name
    assert "launch_wgmma<TO, 128, true>(int4_wgmma_kernel" in src and "launch_wgmma<TO, 256, true>(int4_wgmma" in src


@pytest.mark.parametrize("M, N, K", [(1, 1024, 2560), (1, 9728, 2560), (5, 2560, 9728), (64, 1024, 2560),
                                     (512, 9728, 2560), (130, 384, 272)],
                         ids=["decode-m1", "decode-wide", "decode-m5", "wgmma-split", "wgmma", "ragged"])
def test_launch_reads_no_value_on_the_host(monkeypatch, M, N, K):
    """Off the CPU the wrapper picks the route and sizes the scratch from shapes alone: with meta tensors (no
    values to read) it reaches the launch, which raises here without a build, and counts no launch."""
    monkeypatch.setattr(build, "load_library", lambda: (_ for _ in ()).throw(RuntimeError("no kernels built")))
    meta = lambda *shape, dtype=torch.int8: torch.empty(shape, device="meta", dtype=dtype)  # noqa: E731
    before, by_route = int4_matmul.launches, dict(int4_matmul.launches_by_route)
    with pytest.raises(RuntimeError, match="no kernels built"):
        int4_matmul.int4_scaled_matmul(meta(M, K), meta(N // 2, K), meta(M, 1, dtype=torch.float32),
                                       meta(N, dtype=torch.float32), torch.bfloat16)
    assert int4_matmul.launches == before and dict(int4_matmul.launches_by_route) == by_route


def test_wrapper_refuses_a_k_past_the_exact_int32_range():
    """The kernels sum 16 x each product in int32: K from 2^17 on could overflow, and the wrapper refuses it, as
    the source does."""
    meta = lambda *shape, dtype=torch.int8: torch.empty(shape, device="meta", dtype=dtype)  # noqa: E731
    K = int4_matmul.MAX_K + 16
    with pytest.raises(ValueError, match=f"K <= {int4_matmul.MAX_K}"):
        int4_matmul.int4_scaled_matmul(meta(1, K), meta(64, K), meta(1, 1, dtype=torch.float32),
                                       meta(128, dtype=torch.float32), torch.bfloat16)
    assert "kMaxPackedK = (1 << 17) - 16" in (build.CSRC_DIR / "int_wgmma.cuh").read_text()
    assert 128 * 128 * int4_matmul.MAX_K < 2 ** 31 <= 128 * 128 * (int4_matmul.MAX_K + 16)  # |16 w x| <= 2^14


def test_pack_layout_round_trip_through_the_models():
    """pack_int4_rows of known channels, through both models with one-hot x and unit scales, gives those
    channels' weights back at every column."""
    rng = np.random.default_rng(11)
    w = torch.from_numpy(rng.integers(-8, 8, (256, 128)).astype(np.int8))
    wp = pack_int4_rows(w)
    for M, model in ((4, decode_model), (40, prefill_model)):
        x = torch.zeros(M, 128, dtype=torch.int8)
        for m in range(M):
            x[m, (7 * m) % 128] = 1
        got = model(x, wp, torch.ones(M, 1), torch.ones(256), torch.float32)
        want = w[:, [(7 * m) % 128 for m in range(M)]].T.float()
        assert torch.equal(got, want)
