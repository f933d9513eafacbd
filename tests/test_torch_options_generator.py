"""The options phase's cases on chip_smoke.make_stream's generator, the
one tests/test_torch_cli_presets.py takes (1200 landmarks on the whole
sphere, seed 11, a constant rotation): omega 0.4 x phase 4's [0.9, -1.3,
1.9] (0.99 rad/s), 100 000 events/s for 0.5 s on a 120x90 camera (fx = fy
= 90), with tests/test_torch_options.py's scale (4 000-event packets every
0.02 s, a 256x512 panorama, the bootstrap re-solve at window 2), systems,
checks and tolerances.

On this stream the stock preset itself parts from JAX in window 0, at
ROADMAP Queue 3's keep-test tie: the first line search's first secant
step, where JAX's two programs give the bracket's winning point values 1
ulp apart (-2.8162498 against -2.8162501), so JAX does not keep the point
and the port does. The port then takes 7 line searches to JAX's 6; the
knots stay within 0.1 deg, the map parts by 6.7% of its largest pixel
(the stock case's map test is marked ``xfail(strict=True)``). Two options
agree with JAX there at every tolerance: ``gradient_magnitude`` and
``coarse_to_fine``. The slow tier traces the stock parting here and at
200 000 events/s, the presets test's rate, where the first window parts
by degrees after 17 and 50 line searches."""

import types

import numpy as np
import pytest
import torch

import chip_smoke
from cmax_slam_tpu_torch import config as tconfig

from test_torch_options import (SCALE, _jax, _port, cases, check_decisions,
                                check_poses_and_map)
from test_torch_options import runs  # noqa: F401 (the fixture)

torch.set_num_threads(1)

OMEGA = tuple(0.4 * np.array(chip_smoke.STREAM_OMEGA))  # 0.99 rad/s
RATE, DURATION = 100_000, 0.5
NAMES = ["coarse_to_fine", "gradient_magnitude", "stock"]
XFAIL_POSES = {
    "stock": "known miss (ROADMAP Queue 3): window 0 parts at the keep-test tie, the first "
             "secant step's keep test (test_generator_window_parts_at_the_keep_test_tie"
             "[100000]); the map parts by 6.7% of its largest pixel",
}


def _events(rate):
    """The stream at ``rate`` events/s: a copy of make_stream's cached arrays."""
    ev = chip_smoke.make_stream(DURATION, OMEGA, rate, (120, 90, 90.0))[0]
    return types.SimpleNamespace(xs=ev.xs.copy(), ys=ev.ys.copy(), ts=ev.ts.copy(),
                                 pols=ev.pols.copy())


def STREAM():
    """The events of this module's cases."""
    return _events(RATE)


@pytest.mark.parametrize("name", NAMES)
def test_generator_decisions_match_jax(runs, name):
    check_decisions(runs(name), name)


@pytest.mark.parametrize("name", cases(NAMES, XFAIL_POSES))
def test_generator_poses_and_map_match_jax(runs, name):
    check_poses_and_map(runs(name))


@pytest.mark.slow
@pytest.mark.parametrize("rate", [100_000, 200_000])
def test_generator_window_parts_at_the_keep_test_tie(rate, monkeypatch, tmp_path):
    """The stock preset's window 0 on this generator, from a fresh system
    on JAX's front-end estimates, solved by both packages decision by
    decision (tests/test_torch_oracle_parity.py's tracer): equal decisions
    on costs equal to float32 rounding up to the first line search's first
    secant step, the keep-test tie. At 100 000 events/s the port then takes
    7 line searches to JAX's 6, at 200 000 (the presets test's rate) 50 to
    17."""
    from cmax_slam_tpu import backend as jbackend
    from test_torch_oracle_parity import (assert_parts_at_the_keep_test_tie,
                                          trace_window_from_jax_state)

    jbackend._build_window_solver.cache_clear()  # the tracer wraps what a new build traces
    try:
        traced = trace_window_from_jax_state(
            monkeypatch, lambda: _jax({}), lambda: _port({}), _events(rate), 0,
            tconfig.replace(tconfig.ijrr_config(), **SCALE).backend.optim, tmp_path)
    finally:
        jbackend._build_window_solver.cache_clear()
    dj, dp, first, js, ps = traced
    assert first[0] == 0
    assert (len(js), len(ps)) == {100_000: (6, 7), 200_000: (17, 50)}[rate]
    assert_parts_at_the_keep_test_tie(*traced)
