"""The port's multi-device benchmark launcher on the CPU: the per-device
fan-out (one ``run_perf`` subprocess, ``--serial``) on one small op, and the
mesh sweep of the four compute+comm ops over a two-rank gloo group, run as
the CLI in one spawn with a time limit of its own. Times are the host
clock's here; the records are checked for their fields, not their speed.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from mojo_opset_tpu_torch.benchmark import launch

REPO = Path(__file__).resolve().parents[1]


def test_per_device_fan_out_on_cpu():
    records = launch.main(["--mode", "device", "--num-devices", "1", "--serial", "--device", "cpu",
                           "--ops", "QuantBatchGemmReduceSum", "--iters", "2"])
    assert [(r["op"], r["case"], r["provider"], r["device"]) for r in records] == \
        [("QuantBatchGemmReduceSum", "b8_m512_k128_n128", "ref", 0)]  # no cuda tier; the smoke case only
    assert records[0]["us"] > 0 and records[0]["timing"] == "host"


def test_mesh_sweep_over_gloo(tmp_path):
    out = tmp_path / "mesh.json"
    subprocess.run([sys.executable, "-m", "mojo_opset_tpu_torch.benchmark.launch", "--mode", "mesh",
                    "--num-devices", "2", "--device", "cpu", "--iters", "2",
                    "--json", str(out)],
                   check=True, cwd=REPO, env=dict(os.environ, PYTHONPATH=str(REPO)), timeout=180,
                   stdout=subprocess.DEVNULL)
    records = json.loads(out.read_text())
    assert [r["op"] for r in records] == ["GemmAllReduce", "AllGatherGemm", "GemmReduceScatter", "GemmAll2All"]
    assert [r["case"] for r in records] == ["mesh2_m256_k512_n512", "mesh2_m64_k512_n512", "mesh2_m256_k512_n512",
                                            "mesh2_m64_k512_n512"]
    for r in records:
        assert r["provider"] == "gloo" and r["devices"] == 2 and r["timing"] == "host"
        assert r["us"] > 0 and r["tflops"] > 0


def test_launcher_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this checks the launcher on a machine without a card")
    for mode in ("device", "mesh"):
        with pytest.raises(SystemExit, match="--device cpu"):
            launch.main(["--mode", mode])
