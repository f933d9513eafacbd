"""Finds everything a cell needs by the names in BENCHMARK.json: the
configuration's file, the traffic mix ``traffic/<traffic>.json`` (whose
"driver" names the module under ``pb/drivers`` that replays it), the limits
of the comparison ``limits/<cell>.json``, and a reader
``metrics/<metric>.py`` for each metric the cell reports. A cell or a metric
is added by adding files and entries; no file here names one."""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def _named(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def spec(bench: dict, workload: str, root: Path = ROOT) -> dict:
    """The cell ``workload``: its entry, its configuration's file, its
    traffic mix, its limits and the metrics it reports."""
    cell = _named(bench["workloads"], workload, "workload")
    conf = _named(bench["configs"], cell["config"], "config")
    here = root / BENCH_DIR.name
    return {
        "cell": cell,
        "root": root,
        "config": load_json(root / conf["file"]),
        "traffic": load_json(here / "traffic" / f"{cell['traffic']}.json"),
        "limits": load_json(here / "limits" / f"{workload}.json"),
        "end_to_end": reported(bench["end_to_end"], workload),
        "per_layer": reported(bench["per_layer"], workload),
    }


def reported(metrics: list, workload: str) -> list:
    """The metrics of a list that this cell reports (all, where a metric
    names no workloads)."""
    return [m for m in metrics if "workloads" not in m or workload in m["workloads"]]


def driver(name: str):
    return importlib.import_module(f"pb.drivers.{name}")


def reader(name: str, root: Path = ROOT):
    """The module ``metrics/<name>.py``; its ``read(record)`` gives the
    metric's value, or None where the run has nothing to read."""
    path = root / BENCH_DIR.name / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(f"pb_metric_{name.replace('.', '_')}",
                                                      path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def system_config(settings: dict):
    """The port's SystemConfig holding exactly the file's settings (dotted
    keys, every field given)."""
    from cmax_slam_tpu_torch import config

    return config.replace(config.SystemConfig(), **settings)
