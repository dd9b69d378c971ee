"""The work counts against sums by hand at one small shape, the per-layer readers on them, and the trace's
reduction of events to aggregates."""

import pytest

from perfbench import harness, trace
from perfbench.work import kernels, model

DENSE = dict(hidden_size=8, head_dim=2, num_attention_heads=4, num_key_value_heads=2, num_hidden_layers=3,
             intermediate_size=5, vocab_size=11, torch_dtype="bfloat16")
MOE = dict(DENSE, num_experts=6, num_experts_per_tok=2, moe_intermediate_size=3)
PEAKS = {"bfloat16_ops_per_s": 1000.0, "hbm_bytes_per_s": 100.0}


def test_layer_params_by_hand():
    # q 8x8, o 8x8, k and v 8x4 each, MLP 3 x 8 x 5
    assert model.layer_params(DENSE) == 64 + 64 + 32 + 32 + 120
    # the router 8 x 6 and 2 experts of 3 x 8 x 3, whichever they are
    assert model.layer_params(MOE) == 64 + 64 + 32 + 32 + 48 + 2 * 72


def test_decode_and_prefill_ops_by_hand():
    per_token = 2 * (312 * 3 + 88)
    per_key = 4 * 4 * 2 * 3  # QK and PV, 4 heads of 2, 3 layers
    assert model.decode_step_ops(DENSE, [5, 7]) == 2 * per_token + per_key * 12
    # prompts of 2 and 3 tokens: 5 tokens through the layers, 1+2 and 1+2+3 keys, the head on 2 rows
    assert model.prefill_ops(DENSE, [2, 3]) == 2 * 312 * 3 * 5 + per_key * 9 + 2 * 88 * 2


def test_paged_decode_bytes_by_hand():
    # K and V: 2 x 2 heads x 2 x (5 + 7) keys; q and out: 2 x 4 x 2 a row; 2 bytes; 3 layers
    assert kernels.paged_decode_bytes(DENSE, [5, 7]) == (2 * 2 * 2 * 12 + 2 * 4 * 2 * 2) * 2 * 3


def test_paged_prefill_least_time_by_hand():
    # S 3: 2 x 4 x 2 x 3 x 4 = 192 operations (0.192 s at 1000/s); bytes 3 x (8 + 4) x 2 x 2 = 144 (1.44 s)
    assert kernels.paged_prefill_least_s(DENSE, [3], 1000.0, 100.0) == pytest.approx(1.44 * 3)
    assert kernels.paged_prefill_least_s(DENSE, [3], 1000.0, 1e9) == pytest.approx(0.192 * 3)


def _agg():
    return {"config": DENSE, "peaks": PEAKS,
            "decode": {"wall_s": 2.0, "busy_s": 1.5, "kernels": 30,
                       "windows": [{"lens": [4, 6], "outs": [10, 10], "from": 1, "to": 3}],
                       "ops": {"paged_decode_kernel": 0.4, "paged_decode_merge_kernel": 0.1, "gmm_mma_kernel": 0.3,
                               "group_tile_table": 0.1, "other": 0.6}},
            "prefill": {"wall_s": 4.0, "busy_s": 3.0, "kernels": 9,
                        "windows": [{"lens": [2, 3], "outs": [1, 1], "from": 0, "to": 1},
                                    {"lens": [4], "outs": [1], "from": 0, "to": 1}],
                        "ops": {"paged_prefill_mma": 2.0, "x": 1.0}}}


@pytest.mark.parametrize("name, expected", [
    ("device_idle.decode", 25.0),
    ("device_idle.prefill", 25.0),
    ("decode_mfu", 100 * (model.decode_step_ops(DENSE, [5, 7]) + model.decode_step_ops(DENSE, [6, 8])) / 2000),
    ("prefill_mfu", 100 * (model.prefill_ops(DENSE, [2, 3]) + model.prefill_ops(DENSE, [4])) / 4000),
    ("paged_decode_roofline",
     100 * (kernels.paged_decode_bytes(DENSE, [5, 7]) + kernels.paged_decode_bytes(DENSE, [6, 8])) / 100 / 0.5),
    ("paged_prefill_roofline", 100 * (kernels.paged_prefill_least_s(DENSE, [2, 3], 1000, 100)
                                      + kernels.paged_prefill_least_s(DENSE, [4], 1000, 100)) / 2.0),
    ("kernel_ms.group_gemm", 200.0),
    ("launches.decode_step", 15.0),
])
def test_readers(name, expected):
    assert harness.load_module("metrics", name).read(_agg()) == pytest.approx(expected)


@pytest.mark.parametrize("name", ["decode_mfu", "prefill_mfu", "paged_decode_roofline", "paged_prefill_roofline",
                                  "kernel_ms.group_gemm", "launches.decode_step", "device_idle.decode"])
def test_readers_find_nothing_and_return_none(name):
    """No kernel of theirs in the trace, no part, or no peak for the device: the metric is left out."""
    empty = {"config": DENSE, "peaks": None, "decode": {"wall_s": 0.0, "busy_s": 0.0, "kernels": 0,
                                                       "windows": [], "ops": {}}}
    assert harness.load_module("metrics", name).read(empty) is None


def test_trace_reduce_busy_idle_and_gaps():
    device = [("void (anonymous namespace)::paged_decode_kernel<float>(int)", 10, 30),
              ("nvjet_gemm", 25, 40), ("Memcpy HtoD (Pageable -> Device)", 60, 70), ("late", 95, 120),
              ("before", 0, 5)]
    host = [("cudaGraphLaunch", 40, 58), ("aten::copy_", 70, 100), ("aten::outer", 0, 200)]
    spans = [("decode.0", 8, 100), ("decode.7", 0, 1)]  # a span of no window of the slicer is not read
    window = {"span": "decode", "call": 0, "from": 1, "to": 5, "lens": [3], "outs": [9]}
    agg = trace.reduce(device, host, spans, [dict(window, id=0)])
    d = agg["decode"]
    assert d["wall_s"] == pytest.approx(92e-6)
    assert d["busy_s"] == pytest.approx((40 - 10 + 10 + 5) * 1e-6)  # [10, 40], [60, 70], [95, 100]
    assert d["kernels"] == 3 and d["windows"] == [window] and model.decode_steps(d) == 4
    assert d["ops"]["paged_decode_kernel"] == pytest.approx(20e-6)
    gaps = dict(agg["breakdown"]["idle_gaps"])
    assert gaps["cudaGraphLaunch"] == pytest.approx(20e-6)  # 40-60
    assert gaps["aten::copy_"] == pytest.approx(25e-6)  # 70-95
    assert gaps["aten::outer"] == pytest.approx(2e-6)  # 8-10: only the outer op covers it
    assert agg["busy_s"] == d["busy_s"] and agg["window_s"] == d["wall_s"]


def test_decode_mfu_counts_only_rows_still_served():
    """A request done at its own length is work the static batch does and nobody needs; the kernel's roofline
    still counts every row it is given."""
    agg = _agg()
    agg["decode"]["windows"][0]["outs"] = [2, 10]  # row 0 is done after its second token
    mfu = harness.load_module("metrics", "decode_mfu").read(agg)
    assert mfu == pytest.approx(100 * (model.decode_step_ops(DENSE, [5, 7]) + model.decode_step_ops(DENSE, [8])) / 2000)
    roofline = harness.load_module("metrics", "paged_decode_roofline").read(agg)
    assert roofline == pytest.approx(harness.load_module("metrics", "paged_decode_roofline").read(_agg()))


def test_slicer_parts_are_data():
    """Parts of any span kind, in any calls and positions: opened and closed as the positions come, the profiler
    stopped when the last closes; a part cut by its call's end closes there."""
    slicer = trace.Slicer([{"span": "prefill", "calls": [0, 2], "from": 0, "to": 1},
                           {"span": "decode", "calls": [1, 2], "from": 2, "to": 50}], "cpu")
    for call, last in ((0, 3), (1, 6)):
        for position in range(last + 1):
            slicer.mark(call, position, [4, 5], [last, last])
        slicer.call_end(call, last)
    assert slicer.profile is not None and slicer._prof is None
    assert [(w["span"], w["call"], w["from"], w["to"]) for w in slicer.windows] == [
        ("prefill", 0, 0, 1), ("prefill", 1, 0, 1), ("decode", 1, 2, 6)]
    agg = trace.aggregates(slicer)
    assert {"prefill", "decode"} <= set(agg) and len(agg["prefill"]["windows"]) == 2
    with pytest.raises(ValueError):
        trace.Slicer([{"span": "decode", "calls": [0, 1], "from": 3, "to": 3}], "cpu")
