"""Kernel I's tensor-core arithmetic on the CPU.

``csrc/mla_decode.cu`` (bf16 / fp16) splits each row's positions into
``splits`` contiguous ranges of whole 32-position stages, computes for a
tile of 64 heads S = [q_lat | q_pe] [c | pe]^T exactly (16-bit inputs,
fp32 sums), keeps an online softmax by row, splits P into hi + lo of the
working type (``flash_tiles.cuh`` ``split_pair``: P rounded half away
from zero to 16 significant bits, hi = bf16(P), lo = bf16(P - hi)) and
adds both products with the latent into one fp32 accumulator; several
splits leave (acc, m, l) partials that a second launch merges in split
order, folding in the sink. ``tile_model`` repeats that arithmetic in
numpy (fp32) and is held to the plain version
(``mla_decode_absorbed_plain``) within the fp32 ladder chip_smoke.py holds
the kernel to (atol 6e-3, rtol 1e-4), at 1, 2, 3 and 9 splits, a
zero-length row, a row past its table, H off the 64-row tile, and a sink;
a single bf16 rounding of P is shown to miss a tighter bound the split
keeps. The split count and the tile's sizes come from shapes only.
"""

import pathlib

import numpy as np
import pytest
import torch

from mojo_opset_tpu_torch.backends.cuda import build
from mojo_opset_tpu_torch.backends.cuda.kernels import mla_decode
from mojo_opset_tpu_torch.backends.cuda.kernels.mla_decode import mla_decode_absorbed_plain
from mojo_opset_tpu_torch.utils.acc import check_tol_diff, tols_for

BS, R, DR = 16, 64, 16
FP32 = tols_for(torch.float32)


def to_bf16(x):
    """float32 -> the nearest bf16 (ties to even), as float32."""
    b = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    b = (b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000
    return b.astype(np.uint32).view(np.float32)


def round_split(x):
    """flash_tiles.cuh round_split for bf16: half away from zero at 16 significant bits."""
    b = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    return ((b + (1 << 7)) & ~np.uint64(0xFF)).astype(np.uint32).view(np.float32)


def split_hi_lo(p):
    p = round_split(p)
    hi = to_bf16(p)
    return hi, to_bf16(p - hi)


def split_range(limit, splits, split, keys=mla_decode.KEYS):
    span = -(-(-(-limit // splits)) // keys) * keys
    lo = min(limit, split * span)
    return lo, min(limit, lo + span)


def tile_model(q_lat, q_pe, c, pe, lens, table, seqs, sink, splits, split_p=True):
    """The kernel's arithmetic (bf16 inputs), one row and split at a time, merged in split order."""
    Rr, H, r = q_lat.shape
    out = np.zeros((Rr, H, r), np.float32)
    q = np.concatenate([q_lat, q_pe], -1).astype(np.float32)
    for row in range(Rr):
        seq = row if seqs is None else seqs[row]
        parts = []
        for sp in range(splits):
            lo, hi = split_range(int(lens[row]), splits, sp)
            m = np.full(H, -np.inf, np.float32)
            l = np.zeros(H, np.float32)
            acc = np.zeros((H, r), np.float32)
            for j0 in range(lo, hi, mla_decode.KEYS):
                pos = np.arange(j0, j0 + mla_decode.KEYS)
                lb = pos // BS
                page = np.where((pos < hi) & (lb < table.shape[1]), table[seq, np.minimum(lb, table.shape[1] - 1)], -1)
                ok = page >= 0
                kv = np.zeros((len(pos), r + q_pe.shape[-1]), np.float32)
                kv[ok] = np.concatenate([c[page[ok], 0, pos[ok] % BS], pe[page[ok], 0, pos[ok] % BS]], -1)
                s = np.where(ok[None], (q[row] @ kv.T).astype(np.float32), -np.inf)
                m_new = np.maximum(m, s.max(-1))
                base = np.where(np.isneginf(m_new), 0, m_new).astype(np.float32)
                alpha = np.exp(m - base).astype(np.float32)
                p = np.exp(s - base[:, None]).astype(np.float32)
                l = l * alpha + p.sum(-1, dtype=np.float32)
                m = m_new
                if split_p:
                    hi_p, lo_p = split_hi_lo(p)
                    pv = hi_p @ kv[:, :r] + lo_p @ kv[:, :r]
                else:
                    pv = to_bf16(p) @ kv[:, :r]
                acc = acc * alpha[:, None] + pv.astype(np.float32)
            parts.append((acc, m, l))
        ms = np.stack([pm for _, pm, _ in parts])
        mx = ms.max(0)
        w = np.where(np.isneginf(ms), 0, np.exp(ms - np.where(np.isneginf(mx), 0, mx)))
        total = sum(np.where(wi == 0, 0, li * wi) for (_, _, li), wi in zip(parts, w))
        acc = sum(np.where(wi[:, None] == 0, 0, ai * wi[:, None]) for (ai, _, _), wi in zip(parts, w))
        if sink is not None:
            total = np.where(total > 0, total + np.exp(sink - mx), total)
        out[row] = np.where(total[:, None] > 0, acc / np.where(total > 0, total, 1)[:, None], 0)
    return out


def inputs(lens, H, n_cols, seed, rows=None):
    rng = np.random.default_rng(seed)
    n_blocks = sum(-(-n // BS) for n in lens) + 2
    c = to_bf16(rng.standard_normal((n_blocks, 1, BS, R)))
    pe = to_bf16(rng.standard_normal((n_blocks, 1, BS, DR)))
    perm, table, used = rng.permutation(n_blocks), [], 0
    for n in lens:
        need = -(-n // BS)
        table.append(list(perm[used:used + need][:n_cols]) + [-1] * max(0, n_cols - need))
        used += need
    pairs = list(enumerate(lens)) if rows is None else rows
    q_lat = to_bf16(rng.standard_normal((len(pairs), H, R)) * 0.3)
    q_pe = to_bf16(rng.standard_normal((len(pairs), H, DR)) * 0.3)
    seqs = None if rows is None else np.array([s for s, _ in rows], np.int32)
    limits = np.array([n for _, n in pairs], np.int32)
    return q_lat, q_pe, c, pe, limits, np.array(table, np.int32), seqs


def plain(q_lat, q_pe, c, pe, limits, table, seqs, sink):
    t = lambda a: None if a is None else torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    return mla_decode_absorbed_plain(t(q_lat), t(q_pe), t(c), t(pe), t(limits), t(table), t(seqs), t(sink))


CASES = {  # lens, heads, table columns, prefill rows, sink
    "decode": ([100, 37, 0, 1], 8, 7, None, False),
    "table_short": ([90, 20], 70, 3, None, False),  # positions past the table's 3 pages; H off the tile
    "prefill_rows_sink": ([40, 75], 4, 5, [(1, 75), (1, 74), (0, 3), (0, 0), (1, 33)], True),
}


@pytest.mark.parametrize("splits", [1, 2, 3, 9])
@pytest.mark.parametrize("case", sorted(CASES))
def test_tile_model_matches_the_plain_version(case, splits):
    lens, H, n_cols, rows, sink = CASES[case]
    q_lat, q_pe, c, pe, limits, table, seqs = inputs(lens, H, n_cols, seed=len(case) + splits, rows=rows)
    sk = np.random.default_rng(5).standard_normal(H).astype(np.float32) if sink else None
    got = tile_model(q_lat, q_pe, c, pe, limits, table, seqs, sk, splits)
    check_tol_diff(got, plain(q_lat, q_pe, c, pe, limits, table, seqs, sk), **FP32)
    if not (limits > 0).all():
        assert not got[limits == 0].any()


def test_split_p_is_what_keeps_the_fp32_ladder():
    """hi + lo holds P to 16 significant bits: within 1e-4 of the plain
    version where one bf16 rounding of P is not (its error is ~2^-9 of the
    output's size)."""
    q_lat, q_pe, c, pe, limits, table, seqs = inputs([300, 257], 8, 19, seed=3)
    want = plain(q_lat, q_pe, c, pe, limits, table, seqs, None).numpy()
    tight = dict(atol=1e-4, rtol=1e-4)
    check_tol_diff(tile_model(q_lat, q_pe, c, pe, limits, table, seqs, None, 2), want, **tight)
    with pytest.raises(AssertionError):
        check_tol_diff(tile_model(q_lat, q_pe, c, pe, limits, table, seqs, None, 2, split_p=False), want, **tight)


def test_split_ranges_cover_each_position_once():
    for limit in (0, 1, 31, 32, 33, 1001, 4096):
        for splits in (1, 2, 9, 66):
            got = [p for s in range(splits) for p in range(*split_range(limit, splits, s))]
            assert got == list(range(limit))
            starts = [split_range(limit, splits, s)[0] for s in range(splits)]
            assert all(lo % mla_decode.KEYS == 0 for lo in starts if lo < limit)  # whole stages


def test_split_count_reads_shapes_only():
    """One wave of (row, head tile, column block) units; at least MIN_SPLIT_KEYS of the table a split; one split
    once the units fill the SMs (prefill's 1650 rows)."""
    sc = mla_decode.split_count
    assert sc(4, 128, 512, 17 * 64) == 16 and sc(1, 128, 512, 4096) == 64 and sc(1, 128, 512, 32768) == 66
    assert sc(1, 128, 512, 17 * 64) == 17
    assert sc(24, 128, 512, 4096) == 2 and sc(1650, 128, 512, 1024) == 1 and sc(66, 128, 512, 10**6) == 1
    assert sc(1, 128, 1024, 32768) == 33  # two column blocks a tile
    assert sc(1, 16, 512, 64) == 1


@pytest.mark.parametrize("r, dr, tile, row", [(512, 64, 512, 576), (256, 64, 256, 320), (1024, 64, 512, 1088),
                                               (16, 8, 128, 128), (640, 64, 128, 704), (1024, 128, 512, 1152),
                                               (1000, 64, 128, 1072), (1032, 8, 128, 1152)])
def test_tile_sizes_come_from_the_widths(r, dr, tile, row):
    """The column tile, and the staged row (r + dr to 16, at least the column blocks' span) against MAX_ROW."""
    assert mla_decode.column_tile(r) == tile
    assert max(-(-(r + dr) // 16) * 16, -(-r // tile) * tile) == row
    assert mla_decode.takes(torch.bfloat16, r, dr) == (row <= mla_decode.MAX_ROW)
    assert mla_decode.takes(torch.float16, r, dr) == mla_decode.takes(torch.bfloat16, r, dr)


def test_max_row_is_the_widest_that_one_stage_fits():
    """MAX_ROW mirrors the kernel's kMaxRowI: the query tile and one 32-position stage at a pitch of row + 8, with
    the scores, P's hi and lo and the row stats, within 227 KB less 1 KB; 16 more elements do not fit."""
    def smem(row):
        rows, keys, pitch = mla_decode.ROWS, mla_decode.KEYS, row + 8
        return (rows + keys) * pitch * 2 + rows * (keys + 4) * 4 + 2 * rows * (keys + 8) * 2 + 3 * rows * 4
    limit = 227 * 1024 - 1024
    assert smem(mla_decode.MAX_ROW) <= limit < smem(mla_decode.MAX_ROW + 16)
    src = (pathlib.Path(mla_decode.__file__).parents[3] / "csrc" / "mla_decode.cu").read_text()
    assert f"constexpr int kMaxRowI = {mla_decode.MAX_ROW};" in src


@pytest.mark.parametrize("r", [256, 512, 1024])
def test_wide_and_narrow_latents_reach_the_launch(monkeypatch, r):
    """r 256 and 1024 (one ring stage) go to the kernel, with the split scratch sized from shapes."""
    monkeypatch.setattr(build, "load_library", lambda: (_ for _ in ()).throw(RuntimeError("no kernels built")))
    meta = lambda *shape, dtype=torch.bfloat16: torch.empty(shape, device="meta", dtype=dtype)  # noqa: E731
    with pytest.raises(RuntimeError, match="no kernels built"):
        mla_decode.mla_decode_absorbed(meta(2, 128, r), meta(2, 128, 64), meta(9, 1, 64, r), meta(9, 1, 64, 64),
                                       meta(2, dtype=torch.int32), meta(2, 4, dtype=torch.int32))
