"""The benchmark harness's own tests (``portbench/``: tiny cells on the CPU,
the readers, the planted faults) as one tier-1 test. They cannot share
this process: tests/conftest.py imports jax, and the harness holds that a
process running a cell has not loaded it. So they run in a subprocess of
their own, under a time limit of their own, and must pass.

    python -m pytest portbench -q
"""

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
LIMIT_S = 900
THREADS = "2"  # a neighbour of the suite's other workers, not all the host's cores


def test_the_benchmark_harness_tests_pass_in_a_process_of_their_own():
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTEST_")}
    env.update(OMP_NUM_THREADS=THREADS, MKL_NUM_THREADS=THREADS, OPENBLAS_NUM_THREADS=THREADS)
    proc = subprocess.run([sys.executable, "-m", "pytest", "portbench", "-q",
                           "-p", "no:cacheprovider"],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=LIMIT_S)
    assert proc.returncode == 0, proc.stdout[-6000:] + proc.stderr[-3000:]
