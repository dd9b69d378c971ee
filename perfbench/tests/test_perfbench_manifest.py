"""BENCHMARK.json against the benchmark's rules, and every piece it names found by name."""

import copy
import json

import pytest

from perfbench import harness
from perfbench.tests.helpers import ROOT

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_manifest_keeps_the_rules():
    assert harness.check_manifest(MANIFEST) == []


def test_names_and_units_use_only_the_allowed_characters():
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in MANIFEST[section]:
            assert harness.NAME.match(entry["name"]), entry["name"]
    for metric in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert harness.UNIT.match(metric["unit"]), metric["unit"]


def test_every_per_layer_metric_is_in_cells_that_report_what_it_moves():
    cells = [w["name"] for w in MANIFEST["workloads"]]
    for metric in MANIFEST["per_layer"]:
        for cell in metric.get("workloads", cells):
            reported = [m["name"] for m in harness.cell_metrics(MANIFEST, cell, "end_to_end")]
            assert metric["moves"] in reported, (metric["name"], cell)


def test_every_piece_is_found_by_name():
    for config in MANIFEST["configs"]:
        cfg = json.loads((ROOT / config["file"]).read_text())
        assert cfg["name"] == config["name"] and cfg["source"] == config["source"]
        assert set(config["reduced"]) == set(cfg["reduced"])
        harness.load_module("models", cfg["family"])
        harness.load_module("reference", cfg["family"])
    for cell in MANIFEST["workloads"]:
        mix = json.loads((ROOT / "perfbench" / "traffic" / f"{cell['traffic']}.json").read_text())
        harness.load_module("drivers", mix["driver"])
        limits = json.loads((ROOT / "perfbench" / "limits" / f"{cell['name']}.json").read_text())
        assert set(harness.COMPARED) & set(limits)
    for metric in MANIFEST["per_layer"]:
        assert callable(harness.load_module("metrics", metric["name"]).read)


def _broken(edit):
    m = copy.deepcopy(MANIFEST)
    edit(m)
    return m


@pytest.mark.parametrize("edit", [
    lambda m: m["end_to_end"][0].update(name="tok per s"),
    lambda m: m["end_to_end"][0].update(unit="tokens per second"),
    lambda m: m["end_to_end"][0].update(workloads=[m["workloads"][0]["name"]]),
    lambda m: m["per_layer"][0].update(why="a key the rules do not allow"),
    lambda m: m["end_to_end"][0].update(bound=0.3),
    lambda m: m["workloads"][0].update(chips=2),
    lambda m: m["workloads"].append(dict(m["workloads"][0], name="again")),
    lambda m: m["end_to_end"].pop(),
    lambda m: m.update(run_seconds=52),
], ids=["space-in-name", "space-in-unit", "moves-unreported", "extra-key", "loose-bound", "chips", "pair-twice",
        "no-setup_s", "run-seconds"])
def test_manifest_check_refuses(edit):
    assert harness.check_manifest(_broken(edit))
