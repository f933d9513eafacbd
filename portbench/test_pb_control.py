"""The comparison that decides ``correct`` fails what it must: the control
(the plain reference in bfloat16), the program whose solves take no step
(through its own options, so that each answer and the cost it reports
stay consistent), and the program with its answers broken where they are
produced. On the CPU at the tiny cells' size; the control and the frozen
solves at a cell's own size run on the card."""

import numpy as np
import pytest

from pb import control, harness

SEED = 2 ** 31 + 4242


def _zero(e):
    e.omega = np.zeros(3)


def _replay_fault(kind):
    """A plant for the replay driver: every other one of the front-end's
    answers, as they are finalized, left out (zero), or each altered by
    2%."""
    def plant(slam):
        fe = slam.frontend
        finalize = fe.finalize_batch
        seen = {}

        def broken(ests, *args, **kwargs):
            pend = [e for e in ests if e.packed is not None]
            out = finalize(ests, *args, **kwargs)
            for e in pend:
                i = seen.setdefault(id(e), len(seen))
                if kind == "half" and i % 2:
                    _zero(e)
                elif kind == "altered":
                    e.omega = e.omega * 1.02
            return out

        fe.finalize_batch = broken
        if getattr(slam.backend, "finalize_fn", None) is not None:
            slam.backend.finalize_fn = broken  # the back-end's own handle on it
    return plant


def _batched_fault(kind):
    """A plant for the batched driver: every other lane left out, or each
    answer altered by 2%."""
    def plant(track):
        def broken(*args, **kwargs):
            times, omegas, costs, iters = track(*args, **kwargs)
            if kind == "half":
                times, omegas, costs, iters = (a[::2] for a in (times, omegas, costs, iters))
            else:
                omegas = omegas * 1.02
            return times, omegas, costs, iters
        return broken
    return plant


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("workload", ["tiny.replay", "tiny.batched"])
def test_a_broken_answer_is_not_correct(tiny_root, workload, kind):
    """"unchanged": the front-end's solve takes no line search, so every
    answer stays at the state it starts from (zero) with its cost taken
    there; "half" and "altered" break the answers after the solve."""
    if kind == "unchanged":
        plant, overrides = None, control.FAULTS["frontend_frozen"]
    else:
        plant = (_replay_fault if workload == "tiny.replay" else _batched_fault)(kind)
        overrides = None
    line = harness.run(workload, SEED, 1.0, False, "cpu", root=tiny_root, plant=plant,
                       overrides=overrides)
    assert line["correct"] is False, line["checks"]


def test_a_frozen_back_end_is_not_correct(tiny_root):
    """The back-end's bundle adjustment takes no line search: every window
    keeps the knots the front-end's angular velocities gave it, and the map
    is built on them."""
    line = harness.run("tiny.replay", SEED, 1.0, False, "cpu", root=tiny_root,
                       overrides=control.FAULTS["backend_frozen"])
    assert line["correct"] is False, line["checks"]
    assert line["checks"]["omega_err"]["value"] <= line["checks"]["omega_err"]["limit"]


def test_the_control_is_not_correct(tiny_root):
    """The program's run on the tiny replay cell is correct, and the plain
    reference in bfloat16 put in its place is not, on the same packets."""
    keep = {}
    line = harness.run("tiny.replay", SEED, 1.0, False, "cpu", root=tiny_root, keep=keep)
    assert line["correct"] is True, line["checks"]
    low = control.readings(keep["spec"], keep["rec"], "cpu")
    checks = harness.judged(keep["spec"]["limits"], low)
    assert not harness.correct(checks), checks


@pytest.mark.card
@pytest.mark.parametrize("workload", ["ijrr.replay", "ecrot.replay", "ijrr.batched"])
def test_the_control_is_not_correct_at_the_cells_size(card, workload):
    keep = {}
    line = harness.run(workload, SEED, 3.0, False, card, keep=keep)
    assert line["correct"] is True, line["checks"]
    low = control.readings(keep["spec"], keep["rec"], card)
    assert not harness.correct(harness.judged(keep["spec"]["limits"], low))


@pytest.mark.card
@pytest.mark.parametrize("workload, fault", [
    ("ijrr.replay", "frontend_frozen"), ("ecrot.replay", "frontend_frozen"),
    ("ijrr.batched", "frontend_frozen"), ("ijrr.replay", "backend_frozen"),
    ("ecrot.replay", "backend_frozen")])
def test_a_frozen_solve_is_not_correct_at_the_cells_size(card, workload, fault):
    line = harness.run(workload, SEED + 1, 3.0, False, card, overrides=control.FAULTS[fault])
    assert line["correct"] is False, line["checks"]
