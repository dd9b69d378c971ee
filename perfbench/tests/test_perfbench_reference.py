"""The plain reference against the program's plain CPU path, at a tiny Qwen3 and a tiny Qwen3-MoE, through a
whole run of the harness whose configuration and mix exist only in a temporary directory."""

import time

import numpy as np
import pytest
import torch

from perfbench import harness
from perfbench.reference import qwen3 as reference
from perfbench.tests.helpers import TINY, write_tiny_root


@pytest.mark.parametrize("moe", [False, True], ids=["qwen3", "qwen3-moe"])
def test_a_run_of_a_cell_that_exists_only_in_a_temporary_directory(tmp_path, moe):
    root = write_tiny_root(tmp_path, moe=moe)
    result = harness.run_cell(root, "tiny.cell", 2**31 + 9, 1.0, False, "cpu", time.perf_counter(),
                              control=True, log=lambda s: None)
    assert result["correct"] and result["failed"] == 0 and result["attempted"] > 0
    # float32 on both sides: the program's logits equal the reference's to rounding, every greedy token its best
    assert result["checks"]["logit_err"]["value"] < 1e-5
    assert result["checks"]["gap"]["value"] == 0.0
    # and the float8 control is far off
    assert result["control"]["control_logit_err"] > 1e-2
    assert list(result)[-1] == "checks"
    assert {"output_tok_s", "setup_s"} <= set(result["metrics"])


def test_traced_run_reports_the_cells_per_layer_metrics(tmp_path):
    root = write_tiny_root(tmp_path)
    result = harness.run_cell(root, "tiny.cell", 5, 1.0, True, "cpu", time.perf_counter(), log=lambda s: None)
    # the CPU runs no device operation: only the idle shares have something to read
    assert set(result["metrics"]) == {"device_idle.decode", "device_idle.prefill"}
    assert result["device"]["window_s"] > 0 and set(result["breakdown"]) == {"device_ops", "idle_gaps"}


def test_weights_are_the_same_drawn_twice_and_differ_by_seed():
    cfg = dict(TINY, num_hidden_layers=1, tie_word_embeddings=True, rms_norm_eps=1e-6, rope_theta=1e6)
    a, b = reference.draw_layer(cfg, 3, 0, "cpu"), reference.draw_layer(cfg, 3, 0, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    c = reference.draw_layer(cfg, 4, 0, "cpu")
    assert not torch.equal(a["q_proj"], c["q_proj"])
    assert float(a["q_proj"].std()) == pytest.approx(cfg["initializer_range"], rel=0.2)
    assert float((a["q_norm"] - 1).abs().max()) > 0


def test_reference_rope_is_rotate_half():
    x = torch.randn(3, 2, 4)
    out = reference.rope(x, torch.arange(3), 10000.0)
    assert torch.allclose(out[0], x[0])  # position 0 is the identity
    angle = 1.0  # position 1, the first frequency (theta^0)
    expected = x[1, :, 0] * np.cos(angle) - x[1, :, 2] * np.sin(angle)
    assert torch.allclose(out[1, :, 0], expected, atol=1e-6)


def test_unsupported_architecture_is_refused():
    with pytest.raises(ValueError):
        reference.check_supported({"hidden_act": "gelu"})
