"""Tests of the port's benchmark harness. They run on the CPU at tiny sizes;
a test that needs a CUDA card takes the ``card`` fixture and carries the
``card`` marker, and skips without one. Run from the checkout's root:

    python -m pytest portbench -q
"""

import shutil
import sys
from pathlib import Path

import pytest

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
for p in (str(ROOT), str(BENCH_DIR)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    """A copy of the benchmark whose BENCHMARK.json gains two tiny cells,
    added as files only: a configuration (the ijrr preset on a 120x90 sensor
    with 2 000-event packets and a 256x512 panorama), two traffic mixes
    (100 000 ev/s), their limits, and a metric read by a file of its own."""
    import json

    dst = tmp_path_factory.mktemp("bench")
    shutil.copytree(BENCH_DIR, dst / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "test_*.py", "conftest.py"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    conf = json.loads((BENCH_DIR / "configs" / "ijrr-davis240c.json").read_text())
    conf["sensor"] = {"width": 120, "height": 90, "fx": 90.0, "fy": 90.0, "cx": 60.0, "cy": 45.0}
    conf["settings"].update({"frontend.num_events_per_packet": 2000,
                             "backend.pano_map.pano_height": 256,
                             "backend.pano_map.pano_width": 512})
    (dst / "portbench/configs/tiny.json").write_text(json.dumps(conf))
    bench["configs"].append({"name": "tiny", "source": "https://example.org/tiny",
                             "file": "portbench/configs/tiny.json", "reduced": [],
                             "why": "a CPU test's size"})
    limits = {"replay": {"omega_err": 0.5, "cost_rel_err": 1e-4, "rms_deg": 0.2,
                         "map_far_share": 2e-3},
              "batched": {"omega_err": 0.5, "cost_rel_err": 1e-4}}
    for kind, lim in limits.items():
        traffic = json.loads((BENCH_DIR / "traffic" / f"ijrr_{kind}.json").read_text())
        traffic.update(rate=100000, landmarks=300)
        traffic.update({k: v for k, v in (("warmup_periods", 1), ("warmup_periods_max", 1),
                                          ("warmup_calls", 1), ("warmup_calls_max", 1))
                        if k in traffic})
        (dst / f"portbench/traffic/tiny_{kind}.json").write_text(json.dumps(traffic))
        (dst / f"portbench/limits/tiny.{kind}.json").write_text(json.dumps(lim))
        bench["workloads"].append({"name": f"tiny.{kind}", "config": "tiny",
                                   "traffic": f"tiny_{kind}", "chips": 1, "why": "a test"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if "workloads" in m and f"ijrr.{kind}" in m["workloads"]:
                m["workloads"].append(f"tiny.{kind}")
    (dst / "portbench/metrics/tiny.attempted.py").write_text(
        '"""The runs\' attempted count."""\n\n\ndef read(rec):\n    return rec["attempted"]\n')
    bench["end_to_end"].append({"name": "tiny.attempted", "unit": "pushes", "better": "higher",
                                "bound": 0.25, "source": "host_clock",
                                "workloads": ["tiny.replay", "tiny.batched"]})
    (dst / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return dst
