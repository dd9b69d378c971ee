"""Kernel C's split-KV arithmetic on the CPU.

``csrc/paged_decode.cu`` divides each row's kept keys into ``splits``
contiguous ranges of ``ceil(n_keys / splits)`` keys rounded up to the
block's 64-key step, reduces each range to an fp32 partial ``(m, l, acc)``
per query head (a range with no keys gives ``m = -inf``, ``l = 0``) and
merges the partials in split order, then applies the int8 value scale.
``split_model`` repeats that arithmetic in plain PyTorch (fp32, the key
scale folded into the query as the kernel folds it) and is held to the
plain version of the kernel (the golden decode) at fp32 tolerance, atol =
rtol = 1e-5 (one fp32 softmax, sums in another order), at 1, 2, 3 and 9
splits, with splits that hold no keys, a row of length 0, local/global
windows and int8 pages with their scales. The split count itself is
computed from shapes only: a call with ``meta`` tensors for the lengths
reaches the launch.
"""

import math

import numpy as np
import pytest
import torch

from mojo_opset_tpu_torch.backends.cuda import build
from mojo_opset_tpu_torch.backends.cuda.kernels import paged_decode
from mojo_opset_tpu_torch.utils.acc import check_tol_diff

F32 = dict(atol=1e-5, rtol=1e-5)
LENS = [300, 0, 1, 77, 130]  # a long row spread over splits, an empty row, one key, rows across pages
BLOCK = 16
# (local, global): none, both, local only, global only
WINDOWS = {"none": (None, None), "both": (100, 16), "local": (40, None), "global": (None, 20)}


def kept_positions(seq_len, local, glob):
    """The kernel's virtual order of the kept keys: [0, g_hi), then [b_lo, seq_len)."""
    if local is None and glob is None:
        return list(range(seq_len))
    g_hi = min(glob, seq_len) if glob is not None else 0
    lo = max(seq_len - 1 - local, 0) if local is not None else seq_len
    return list(range(g_hi)) + list(range(max(lo, g_hi), seq_len))


def split_range(n_keys, splits, split, step=paged_decode.KEYS_PER_STEP):
    span = -(-(-(-n_keys // splits)) // step) * step
    lo = split * span
    return lo, min(n_keys, lo + span)


def split_model(q, kc, vc, lens, table, splits, gqa, k_scale=None, v_scale=None, local=None, glob=None):
    """Per-split fp32 partials merged in split order, HND pages."""
    B, hq, D = q.shape
    hkv, bs = kc.shape[1], kc.shape[2]
    group = hq // hkv
    out = torch.zeros(B, hq, D)
    for b in range(B):
        pos = kept_positions(int(lens[b]), local, glob)
        for h in range(hq):
            kvh = h % hkv if gqa == "ABAB" else h // group
            qs = q[b, h].float() / math.sqrt(D)
            if k_scale is not None:
                qs = qs * k_scale[kvh]
            parts = []
            for s in range(splits):
                lo, hi = split_range(len(pos), splits, s)
                if lo >= hi:
                    parts.append((-math.inf, 0.0, None))
                    continue
                rows = [(int(table[b, p // bs]), p % bs) for p in pos[lo:hi]]
                k = torch.stack([kc[page, kvh, t].float() for page, t in rows])
                v = torch.stack([vc[page, kvh, t].float() for page, t in rows])
                sc = k @ qs
                m = sc.max()
                p = torch.exp(sc - m)
                parts.append((m.item(), p.sum(), p @ v))
            mx = max(m for m, _, _ in parts)
            total, acc = torch.zeros(()), torch.zeros(D)
            for m, l, a in parts:  # split order; a split without keys adds nothing
                if m == -math.inf:
                    continue
                w = torch.exp(torch.tensor(m - mx))
                total, acc = total + l * w, acc + a * w
            o = acc / total if total > 0 else torch.zeros(D)
            out[b, h] = o * v_scale[kvh] if v_scale is not None else o
    return out


def _case(seed, hq, hkv, int8=False):
    rng = np.random.default_rng(seed)
    n_blocks = sum(-(-n // BLOCK) for n in LENS) + 3
    shape = (n_blocks, hkv, BLOCK, 16)
    if int8:
        kc, vc = (torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8)) for _ in range(2))
    else:
        kc, vc = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)) for _ in range(2))
    cols = -(-max(LENS) // BLOCK)
    table, perm, used = np.full((len(LENS), cols), -1, np.int32), rng.permutation(n_blocks), 0
    for i, n in enumerate(LENS):
        need = -(-n // BLOCK)
        table[i, :need] = perm[used:used + need]
        used += need
    q = torch.from_numpy(rng.standard_normal((len(LENS), hq, 16)).astype(np.float32))
    scales = [torch.from_numpy(rng.uniform(0.005, 0.02, (hkv, 16)).astype(np.float32)) for _ in range(2)]
    return q, kc, vc, torch.tensor(LENS, dtype=torch.int32), torch.from_numpy(table), scales


@pytest.mark.parametrize("splits", [1, 2, 3, 9])
@pytest.mark.parametrize("window", sorted(WINDOWS))
@pytest.mark.parametrize("gqa", ["AABB", "ABAB"])
def test_split_merge_matches_the_plain_decode(splits, window, gqa):
    local, glob = WINDOWS[window]
    q, kc, vc, lens, table, _ = _case(41, 8, 2)
    want = paged_decode.paged_decode_gqa_plain(q, kc, vc, lens, table, None, gqa, "HND", local_window=local,
                                               global_window=glob)
    got = split_model(q, kc, vc, lens, table, splits, gqa, local=local, glob=glob)
    check_tol_diff(got, want, **F32)
    assert not got[1].any()  # seq_len 0 writes zeros


@pytest.mark.parametrize("splits", [1, 2, 3, 9])
@pytest.mark.parametrize("window", ["none", "both"])
def test_split_merge_int8_pages_match_the_plain_decode(splits, window):
    local, glob = WINDOWS[window]
    q, kc, vc, lens, table, (ks, vs) = _case(42, 8, 2, int8=True)
    want = paged_decode.paged_decode_gqa_plain(q, kc, vc, lens, table, None, "AABB", "HND", ks, vs, local, glob)
    got = split_model(q, kc, vc, lens, table, splits, "AABB", ks, vs, local, glob)
    check_tol_diff(got, want, **F32)


def test_split_ranges_cover_the_kept_keys_once():
    """Contiguous, in whole 64-key steps, in split order; the splits past
    the last key hold none."""
    for n_keys in (0, 1, 63, 64, 65, 300, 1032):
        for splits in (1, 2, 3, 9, 69):
            ranges = [split_range(n_keys, splits, s) for s in range(splits)]
            covered = [j for lo, hi in ranges for j in range(lo, hi)]
            assert covered == list(range(n_keys))
            assert all(lo % paged_decode.KEYS_PER_STEP == 0 for lo, _ in ranges)
    assert [max(hi - lo, 0) for lo, hi in (split_range(300, 9, s) for s in range(9))] == [64] * 4 + [44] + [0] * 4


def test_split_count_reads_shapes_only():
    # the main path's batch: B 4, Qwen3-4B's 8 kv heads of group 4, 69 pages of 64
    assert paged_decode.split_count(4, 8, 4, 69 * 64) == 8
    # a batch that fills the card's two blocks an SM takes one split: o is written directly; one just short, two
    assert paged_decode.split_count(33, 8, 4, 69 * 64) == 1
    assert paged_decode.split_count(24, 8, 4, 69 * 64) == 2
    # never more splits than 64-key steps the table or the windows allow
    assert paged_decode.split_count(1, 1, 1, 100) == 2
    assert paged_decode.split_count(4, 8, 4, 32768, local_window=1024, global_window=64) == 8
    assert paged_decode.split_count(1, 8, 4, 32768, local_window=100) == 2
    assert paged_decode.split_count(4, 8, 4, 32768, global_window=0) == 1
    # groups above 4 take chunks of 16 query heads
    assert [paged_decode.group_chunks(g) for g in (1, 4, 5, 16, 20, 32, 71)] == [1, 1, 1, 1, 2, 2, 5]
    assert paged_decode.split_count(4, 2, 20, 4096) == 264 // 16


@pytest.mark.parametrize("hq, hkv", [(8, 2), (32, 1), (40, 2)], ids=["group4", "group32", "group20"])
def test_decode_kernel_takes_any_group_without_reading_lengths(monkeypatch, hq, hkv):
    """Off the CPU the wrapper sizes the splits from shapes alone and
    launches for any group: with meta lengths (no values to read) it
    reaches the launch, which raises here without a build."""
    monkeypatch.setattr(build, "load_library", lambda: (_ for _ in ()).throw(RuntimeError("no kernels built")))
    meta = lambda *shape, dtype=torch.bfloat16: torch.empty(shape, device="meta", dtype=dtype)  # noqa: E731
    before = paged_decode.launches
    with pytest.raises(RuntimeError, match="no kernels built"):
        paged_decode.paged_decode_gqa(meta(4, hq, 128), meta(9, hkv, 64, 128), meta(9, hkv, 64, 128),
                                      meta(4, dtype=torch.int32), meta(4, 3, dtype=torch.int32))
    assert paged_decode.launches == before
