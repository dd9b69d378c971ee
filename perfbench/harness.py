"""The harness: finds a cell's pieces by name, runs it once, and assembles
the result line.

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file of its own, found by the name that ``BENCHMARK.json``
gives it:

* ``<config file>`` (the manifest's ``file``): the model's sizes, its
  ``family`` and its ``deployment``; ``perfbench/models/<family>.py`` builds
  the program's model from it and ``perfbench/reference/<family>.py`` is
  its plain reference;
* ``perfbench/traffic/<traffic>.json``: the mix, whose ``driver`` names
  ``perfbench/drivers/<driver>.py`` and whose length distributions name
  ``perfbench/dists/<dist>.py``;
* ``perfbench/limits/<cell>.json``: the limit of each number compared
  (``gap``, ``logit_err``; a number without a limit there is not compared);
* ``perfbench/metrics/<metric>.py``: a per-layer metric's reader,
  ``read(aggregates) -> value or None``.

Data files are looked up under ``root`` (the checkout), code files under
``root`` and then beside this one (``perfbench.find``).
"""

from __future__ import annotations

import gc
import re
import sys
import time
import traceback
from pathlib import Path
from typing import Callable

import torch

from perfbench import check, e2e, trace
from perfbench.find import NAME, PACKAGE, load_json, load_module
from perfbench.traffic import Traffic, longest_sequence

FORBIDDEN = ("jax", "jaxlib", "flax", "mojo_opset_tpu")
COMPARED = ("gap", "logit_err")

UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
CELL_KEYS = {"name", "config", "traffic", "chips", "why"}
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}


def forbidden_modules() -> list:
    """Top-level names of loaded modules that a run may not hold, compared whole."""
    return sorted({name.split(".", 1)[0] for name in list(sys.modules)} & set(FORBIDDEN))


def _line(text) -> bool:
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def check_manifest(m: dict) -> list:
    """What in the manifest breaks the benchmark's rules: an empty list when nothing does."""
    bad = []
    if set(m) != TOP_KEYS:
        bad.append(f"top-level keys {sorted(m)} != {sorted(TOP_KEYS)}")
        return bad
    if not (isinstance(m["run_seconds"], int) and 1 <= m["run_seconds"] <= 51):
        bad.append("run_seconds is a whole number from 1 to 51")
    if not (1 <= len(m["paths"]) <= 16 and all(PATH.match(p) and ".." not in p for p in m["paths"])):
        bad.append("paths: 1 to 16 relative paths")
    if not (1 <= len(m["command"]) <= 32 and all(_line(w) for w in m["command"])):
        bad.append("command: 1 to 32 words")
    names = {}
    for section, keys, extra in (("configs", CONFIG_KEYS, set()), ("workloads", CELL_KEYS, set()),
                                 ("end_to_end", E2E_KEYS, {"workloads"}), ("per_layer", LAYER_KEYS, {"workloads"})):
        for entry in m[section]:
            if not (keys <= set(entry) <= keys | extra):
                bad.append(f"{section} entry {entry.get('name')!r}: keys {sorted(entry)}")
                continue
            if not NAME.match(str(entry["name"])):
                bad.append(f"{section}: bad name {entry['name']!r}")
            if entry["name"] in names.setdefault(section, set()):
                bad.append(f"{section}: {entry['name']!r} twice")
            names[section].add(entry["name"])
    if bad:
        return bad
    metrics = names["end_to_end"] | names["per_layer"]
    if len(metrics) != len(names["end_to_end"]) + len(names["per_layer"]):
        bad.append("a metric name is both end-to-end and per-layer")
    for c in m["configs"]:
        if not (_line(c["why"]) and _line(c["source"]) and len(c["reduced"]) <= 16
                and all(NAME.match(k) for k in c["reduced"])):
            bad.append(f"config {c['name']}: why, source or reduced")
    cells = {w["name"]: w for w in m["workloads"]}
    pairs = {(w["config"], w["traffic"]) for w in m["workloads"]}
    if len(pairs) != len(cells):
        bad.append("a pair of configuration and traffic appears twice")
    for w in m["workloads"]:
        if w["config"] not in names["configs"] or not NAME.match(w["traffic"]) or w["chips"] not in (1, 4) \
                or not _line(w["why"]):
            bad.append(f"cell {w['name']}: config, traffic, chips or why")
    for metric in m["end_to_end"] + m["per_layer"]:
        if not UNIT.match(str(metric["unit"])) or metric["better"] not in ("lower", "higher") \
                or metric["source"] not in SOURCES:
            bad.append(f"metric {metric['name']}: unit, better or source")
        if not set(metric.get("workloads", [])) <= set(cells):
            bad.append(f"metric {metric['name']}: unknown cells in workloads")
    for metric in m["end_to_end"]:
        if metric["source"] not in ("host_clock", "device_trace") or not 0 < metric["bound"] <= 0.25:
            bad.append(f"end-to-end {metric['name']}: source or bound")
    if "setup_s" not in names["end_to_end"]:
        bad.append("no setup_s")
    for metric in m["per_layer"]:
        if metric["moves"] not in names["end_to_end"] or not _line(metric["layer"]):
            bad.append(f"per-layer {metric['name']}: moves or layer")
            continue
        for cell in metric.get("workloads", cells):
            if metric["moves"] not in [x["name"] for x in cell_metrics(m, cell, "end_to_end")]:
                bad.append(f"per-layer {metric['name']} in {cell}, which does not report {metric['moves']}")
    for cell in cells:
        reported = [x["name"] for x in cell_metrics(m, cell, "end_to_end")]
        if "setup_s" not in reported or len(reported) < 2 or not cell_metrics(m, cell, "per_layer"):
            bad.append(f"cell {cell}: needs setup_s, another end-to-end metric and a per-layer metric")
    return bad


def cell_metrics(m: dict, cell: str, section: str) -> list:
    """The metrics of ``section`` that ``cell`` reports: those that list it,
    those without a list; a per-layer metric without a list wherever the
    metric it moves is reported."""
    out = []
    for metric in m[section]:
        if "workloads" in metric:
            if cell in metric["workloads"]:
                out.append(metric)
        elif section == "end_to_end" or metric["moves"] in [x["name"] for x in cell_metrics(m, cell, "end_to_end")]:
            out.append(metric)
    return out


def _device_info(device, chips: int, peak: int) -> dict:
    if torch.device(device).type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": chips,
                "memory_peak_bytes": int(peak)}
    return {"platform": "cpu", "kind": "cpu", "count": chips, "memory_peak_bytes": int(peak)}


def kernel_build(device) -> dict:
    """Load the program's kernels, building them where this checkout has not
    yet: ``{"built": whether it built, "seconds": the time it took}``. A
    run that builds is the checkout's first, whose set-up is set apart."""
    t = time.perf_counter()
    if torch.device(device).type != "cuda":
        return {"built": False, "seconds": 0.0}
    from mojo_opset_tpu_torch.backends.cuda import build

    built = not build.library_path().is_file()
    build.load_library()
    return {"built": built, "seconds": time.perf_counter() - t}


def run_cell(root: Path, cell_name: str, seed: int, seconds: float, traced: bool, device, t0: float,
             control: bool = False, log: Callable[[str], None] = lambda s: print(s, file=sys.stderr)) -> dict:
    """Run one cell once and return its result line (a dict; ``checks`` last)."""
    root = Path(root)
    manifest = load_json(root / "BENCHMARK.json")
    problems = check_manifest(manifest)
    if problems:
        raise ValueError("BENCHMARK.json: " + "; ".join(problems))
    cell = {w["name"]: w for w in manifest["workloads"]}[cell_name]
    entry = {c["name"]: c for c in manifest["configs"]}[cell["config"]]
    cfg = load_json(root / entry["file"])
    mix = load_json(root / "perfbench" / "traffic" / f"{cell['traffic']}.json")
    limits_path = root / "perfbench" / "limits" / f"{cell_name}.json"
    limits = load_json(limits_path) if limits_path.is_file() else {}
    models, reference = load_module("models", cfg["family"], root), load_module("reference", cfg["family"], root)
    driver = load_module("drivers", mix["driver"], root)

    build = kernel_build(device)
    block = int(cfg["deployment"]["block_size"])
    capacity = -(-longest_sequence(mix, root) // block) * block
    model = models.serving_model(cfg, capacity, device)
    models.load_weights(model, cfg, seed)
    traffic = Traffic(mix, cfg["vocab_size"], seed, root)
    watch = check.Watch(mix, seed, device)
    slicer = trace.Slicer(mix["trace"], device) if traced else None
    window = driver.drive(model, cfg, mix, traffic, seconds, watch, slicer)
    cuda = torch.device(device).type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    t_open, t_close, calls = window["t_open"], window["t_close"], window["calls"]
    setup_s = t_open - t0
    if window["error"] is not None:
        log("a call of the window raised:\n" + "".join(traceback.format_exception(window["error"])))
    log(f"set-up {setup_s:.3f} s (kernels {'built' if build['built'] else 'loaded'} in {build['seconds']:.3f} s); "
        f"window {seconds} s: {sum(c['complete'] for c in calls)} calls complete of {len(calls)}, "
        f"capacity {capacity} positions, peak {peak / 2**30:.2f} GiB")

    metrics = {}
    breakdown = device_extra = None
    if traced:
        agg = trace.aggregates(slicer)
        if agg is not None:
            peaks = load_json(PACKAGE / "work" / "peaks.json")
            agg.update(config=cfg, peaks=peaks.get(torch.cuda.get_device_name(device)) if cuda else None)
            for metric in cell_metrics(manifest, cell_name, "per_layer"):
                value = load_module("metrics", metric["name"], root).read(agg)
                if value is not None:
                    metrics[metric["name"]] = {"value": value, "unit": metric["unit"]}
            breakdown = agg["breakdown"]
            device_extra = {"busy_s": agg["busy_s"], "window_s": agg["window_s"]}
    else:
        units = {x["name"]: x["unit"] for x in cell_metrics(manifest, cell_name, "end_to_end")}
        values = e2e.end_to_end(units, calls, t_open, t_close, setup_s)
        metrics = {name: {"value": v, "unit": units[name]} for name, v in values.items()}

    # the program's state goes before the reference runs: the peak above is the program's
    if slicer is not None:
        slicer.profile = None
    del model, window
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    failed = sum(c["batch"] for c in calls if c["failed"])
    attempted = int(sum(e2e.done(c).sum() for c in calls if not c["failed"])) + failed
    requests = check.sample(calls, watch, int(mix["check"]["requests"]), seed)
    readings, correct = {}, failed == 0 and bool(requests)
    if requests:
        t = time.perf_counter()
        readings = check.compare(reference, cfg, seed, requests, device, control=control)
        log("readings " + ", ".join(f"{k} {v}" for k, v in readings.items()))
        log(f"reference over {len(requests)} requests ({sum(r['tokens'].size for r in requests)} served tokens) "
            f"in {time.perf_counter() - t:.3f} s")
    compared = [name for name in COMPARED if name in limits]
    if not compared:
        correct = False
    for name in compared:
        if name not in readings or not readings[name] <= limits[name]:
            correct = False
    result = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics,
              "device": _device_info(device, cell["chips"], peak), "kernel_build": build}
    if device_extra:
        result["device"].update(device_extra)
    if breakdown is not None:
        result["breakdown"] = breakdown
    if control:  # every reading, the program's and the control's, for the limits' calibration
        result["control"] = dict(readings)
    result["checks"] = {name: {"value": readings.get(name), "limit": limits[name]} for name in compared}
    return result
