"""Kernel H's prefill-tile schedule on the CPU.

``csrc/group_gemm.cu`` runs 16-bit inputs with at least 32 rows a group
(M >= 32 G) on a wgmma tile fed by TMA. A first launch writes the row-tile
table from ``group_sizes`` alone: each group's rows cut into 128-row tiles
from the group's first row, (group, first row, end row) in group order.
The work units are (row tile, n tile of 256 columns), the n tile fastest,
dealt round robin to a persistent grid of one block an SM. A unit reads
x's 128 rows from its tile's first row (rows of the next group, or past M
as zeros, come along) and W's 256 rows or columns of its group in 64-deep
k slices, zero past K for x (TMA's fill); a (G, K, N) weight's k slice
may run into the next group's rows, which meet x's zero columns. It stores
its group's rows and columns < N only; the rows past the groups' end are
zeroed.

``schedule_model`` repeats that schedule in plain PyTorch (fp32 products of
the 16-bit inputs, one rounding) and is held to the plain version
(``grouped_matmul_plain``, which ``tests/test_torch_moe.py`` holds to JAX)
under chip_smoke.py's ``GROUP_GEMM_REL_LIMITS``, at G = 128 and 256 with
empty and one-row groups, both weight layouts, ragged K and N and rows
past the groups. It also checks what the schedule promises: every routed
row in exactly one tile of its own group, each row tile's n tiles adjacent
units, and the scratch the wrapper sizes from shapes holding the table. A
call with ``meta`` tensors (no counts to read) reaches the launch.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from mojo_opset_tpu_torch.backends.cuda import build
from mojo_opset_tpu_torch.backends.cuda.kernels import group_gemm

BM, BN, BK, SMS = 128, 256, 64, 132
# (G, counts seed, K, N, trans_weight, rows past the groups)
CASES = {
    "g128-fc1-layout": (128, 0, 64, 320, True, 0),
    "g128-kn-layout": (128, 1, 136, 264, False, 0),
    "g256-straddle": (256, 2, 72, 264, True, 0),
    "g256-kn-rows-past": (256, 3, 64, 136, False, 37),
}


def routed_counts(G, seed):
    """~36 rows an expert from a random top-4 routing, with empty and one-row groups among them."""
    rng = np.random.default_rng(seed)
    choice = np.argsort(rng.random((9 * G, G)), axis=1)[:, :4]
    counts = np.bincount(choice.reshape(-1), minlength=G)
    counts[[3, G // 2]] = 0
    counts[[7, G - 1]] = 1
    return torch.from_numpy(counts.astype(np.int32))


def tile_table(group_sizes, M):
    """group_tile_table: [(group, first row, end row)] in group order, and the rows the groups cover (<= M)."""
    table, start = [], 0
    for g, c in enumerate(group_sizes.tolist()):
        c = max(c, 0)
        rows = max(0, min(c, M - start))
        table += [(g, lo, min(lo + BM, start + rows)) for lo in range(start, start + rows, BM)]
        start += c
    return table, min(start, M)


def units(table, N):
    """The persistent grid's units in order: (row tile, n tile), the n tile fastest; block b takes b, b + grid, ..."""
    n_tiles = -(-N // BN)
    return [(t, n) for t in range(len(table)) for n in range(n_tiles)], n_tiles


def schedule_model(x, w, group_sizes, trans_weight):
    """The prefill tile's output, unit by unit, as the kernel's TMA boxes and masked stores see the operands."""
    M, K = x.shape
    G = w.shape[0]
    N = w.shape[1] if trans_weight else w.shape[2]
    table, filled = tile_table(group_sizes, M)
    k_pad = -(-K // BK) * BK
    xb = torch.zeros(M + BM, k_pad)  # rows past M and columns past K: TMA's zero fill
    xb[:M, :K] = x.float()
    if trans_weight:  # (G N, K) rows, K-major: rows past a group's N belong to the next group (masked at the store)
        wb = torch.zeros(G * N + BN, k_pad)
        wb[:G * N, :K] = w.float().reshape(G * N, K)
    else:  # (G K, N) rows, MN-major: k rows past K belong to the next group and meet x's zero columns
        wb = torch.zeros(G * K + k_pad, N + BN)
        wb[:G * K, :N] = w.float().reshape(G * K, N)
    out = torch.full((M, N), float("nan"))
    order, _ = units(table, N)
    for t, n in order:
        g, lo, hi = table[t]
        n0 = n * BN
        a = xb[lo:lo + BM]
        b = wb[g * N + n0:g * N + n0 + BN] if trans_weight else wb[g * K:g * K + k_pad, n0:n0 + BN].T
        acc = a @ b.T  # (BM, BN) fp32
        cols = min(BN, N - n0)
        out[lo:hi, n0:n0 + cols] = acc[:hi - lo, :cols]
    out[filled:] = 0.0
    return out.to(x.dtype)


def gmm_inputs(name, dtype):
    G, seed, K, N, trans, past = CASES[name]
    counts = routed_counts(G, seed)
    M = int(counts.sum()) + past
    rng = np.random.default_rng(seed + 10)
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)).to(dtype)
    w = torch.from_numpy((rng.standard_normal((G, N, K) if trans else (G, K, N)) * 0.05).astype(np.float32))
    return x, w.to(dtype), counts, trans


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=["bf16", "fp16"])
@pytest.mark.parametrize("name", list(CASES))
def test_schedule_model_holds_the_plain_version_within_limits(name, dtype):
    x, w, counts, trans = gmm_inputs(name, dtype)
    assert group_gemm.uses_prefill_tile(x.shape[0], w.shape[0], dtype)
    got = schedule_model(x, w, counts, trans)
    want = group_gemm.grouped_matmul_plain(x, w, counts, trans)
    assert not got.isnan().any(), "an output element no unit stored"
    whole, row, _ = chip_smoke.rel_errors(got, want)
    limit = chip_smoke.GROUP_GEMM_REL_LIMITS["bf16" if dtype == torch.bfloat16 else "fp16"]
    assert whole <= limit[0] and row <= limit[1], f"{whole:.3g} / {row:.3g} over {limit}"


@pytest.mark.parametrize("name", list(CASES))
def test_tiles_cover_each_routed_row_once_and_keep_an_experts_n_tiles_together(name):
    G, seed, K, N, trans, past = CASES[name]
    counts = routed_counts(G, seed)
    M = int(counts.sum()) + past
    table, filled = tile_table(counts, M)
    starts = np.concatenate([[0], np.cumsum(counts.numpy())])
    covered = np.zeros(M, np.int64)
    for g, lo, hi in table:
        assert starts[g] <= lo < hi <= starts[g + 1] and hi - lo <= BM  # one group's rows
        covered[lo:hi] += 1
    assert (covered[:filled] == 1).all() and (covered[filled:] == 0).all() and filled == int(counts.sum())
    assert [g for g, _, _ in table] == sorted(g for g, _, _ in table)  # group order: an expert's tiles adjacent
    order, n_tiles = units(table, N)
    for t in range(len(table)):  # a row tile's n tiles are consecutive units
        assert [u for u, (tt, _) in enumerate(order) if tt == t] == list(range(t * n_tiles, (t + 1) * n_tiles))
    # the wrapper's scratch, sized from shapes alone, holds the table and the two counts
    bound = min(-(-M // BM) + G, M)
    assert len(table) <= bound and group_gemm.prefill_scratch_ints(M, G) >= 4 * bound + 2


def test_route_is_chosen_from_shapes():
    assert group_gemm.uses_prefill_tile(13200, 128, torch.bfloat16)
    assert group_gemm.uses_prefill_tile(8192, 256, torch.float16)
    assert not group_gemm.uses_prefill_tile(8191, 256, torch.bfloat16)  # the decode tile
    assert not group_gemm.uses_prefill_tile(32, 128, torch.bfloat16)
    assert not group_gemm.uses_prefill_tile(13200, 128, torch.float32)  # the FMA kernel


@pytest.mark.parametrize("M, G", [(4096, 128), (32, 128)], ids=["prefill-tile", "decode-tile"])
def test_launch_reads_no_count_on_the_host(monkeypatch, M, G):
    """Off the CPU the wrapper sizes the grid and the scratch from shapes alone: with meta counts (no values to
    read) it reaches the launch, which raises here without a build, and counts no launch."""
    monkeypatch.setattr(build, "load_library", lambda: (_ for _ in ()).throw(RuntimeError("no kernels built")))
    meta = lambda *shape, dtype=torch.bfloat16: torch.empty(shape, device="meta", dtype=dtype)  # noqa: E731
    before = group_gemm.launches
    with pytest.raises(RuntimeError, match="no kernels built"):
        group_gemm.grouped_matmul(meta(M, 2048), meta(G, 1536, 2048), meta(G, dtype=torch.int32), True)
    assert group_gemm.launches == before
