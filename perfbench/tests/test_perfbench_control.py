"""On the card, at each cell's own size: the control (the reference in float8 in the program's place) fails the
cell's limits on three seeds, and the program passes them on the same prompts. Run on the chip:

    python3 -m pytest perfbench/tests/test_perfbench_control.py -q -m card -p no:cacheprovider
"""

import json

import pytest

from perfbench import calibrate, harness
from perfbench.tests.helpers import ROOT

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
# a window long enough to complete one call of each mix
SECONDS = {"conversation-b48": 26, "conversation-b16": 28}
SEEDS = (2**31 + 101, 2**31 + 102, 2**31 + 103)


@pytest.mark.card
@pytest.mark.parametrize("cell", [w["name"] for w in MANIFEST["workloads"]])
def test_control_fails_where_the_program_passes(card, cell):
    traffic = {w["name"]: w["traffic"] for w in MANIFEST["workloads"]}[cell]
    limits = json.loads((ROOT / "perfbench" / "limits" / f"{cell}.json").read_text())
    compared = [name for name in harness.COMPARED if name in limits]
    for line in calibrate.readings(cell, SEEDS, SECONDS[traffic]):
        assert all(line[name] <= limits[name] for name in compared), line
        assert any(line[f"control_{name}"] > limits[name] for name in compared), line
