"""The options phase's grid ladders, coarse-to-fine front-end, trust cap and
refine prior (chip_smoke.OPTION_RUNS), each in the port against the JAX
package on tests/test_torch_options.py's stream, with that file's systems,
checks and tolerances (its docstring). ``trust`` takes its cap C by the
options phase's rule from the port's stock run on the stream and must
reject the same windows as JAX; ``refine_prior`` runs one refine pass with
the prior after the online pass."""

import pytest
import torch

from test_torch_options import (XFAIL_DECISIONS, XFAIL_POSES, cases, check_decisions,
                                check_poses_and_map)
from test_torch_options import cap_deg, runs  # noqa: F401 (the fixtures)

torch.set_num_threads(1)

NAMES = ["coarse_to_fine", "grid", "refine_prior", "trust"]


@pytest.mark.parametrize("name", cases(NAMES, XFAIL_DECISIONS))
def test_option_decisions_match_jax(runs, name):
    check_decisions(runs(name), name)


@pytest.mark.parametrize("name", cases(NAMES, XFAIL_POSES))
def test_option_poses_and_map_match_jax(runs, name):
    check_poses_and_map(runs(name))
