"""Run-to-run spread of batched tracking (chip_smoke.py phase 6) on a CUDA
card, and the repro of its lost lanes.

    python3 tools/batched_spread.py [--runs 20] [--max-bands 4 10]
    python3 tools/batched_spread.py --repro [--runs 4] [--out DIR]

The first form runs ``chip_smoke.run_batched`` ``--runs`` times in one
process, taking the ``--max-bands`` values in turn, and prints per run the
value, the rate, the median and worst lane error against the ground truth
and the K1 launches per variant (the lines phase 6 prints).

``--repro`` runs phase 6's packets ``--runs`` times with every K1 launch
forced to G, then as often forced to P, logging every lane's omega. A lane
is lost when it ends more than 0.2 rad/s from the ground truth. Each lost
packet is then solved again from the warm start its lane had (its left
neighbour's cold-sweep solution): alone through the lane-batched CG on the
card and on the CPU (plain votes), and through the sequential chain's
solver (``optim.minimize_fr_cg``, as ``Frontend`` calls it) on the card and
on the CPU; beside them stands phase 4's sequential estimate of the same
packet. Per lost lane it prints the errors and costs of each, and writes
every lane's omega to ``--out`` as JSON (default ``_work/``).
"""

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from cmax_slam_tpu_torch.ops import cuda_iwe  # noqa: E402

LOST = 0.2  # rad/s from the ground truth: phase 6's median gate


def _forced(variant):
    """A stand-in for cuda_iwe.plan_vote_fwd that forces ``variant``."""
    plan = cuda_iwe.plan_vote_fwd

    def forced(*args, **kw):
        kw["variant"] = variant
        return plan(*args, **kw)

    return forced


def track(pb, cam, cfg):
    """Phase 6's tracking of ``pb``, returning (times, omegas, costs, iters,
    warm) where ``warm`` is each lane's warm start in the second sweep."""
    from cmax_slam_tpu_torch.parallel import batched

    starts, init = [], batched._init_states

    def spy(bearings, dts, weights, omega0s, *rest):
        starts.append(omega0s.cpu().numpy())
        return init(bearings, dts, weights, omega0s, *rest)

    batched._init_states = spy
    try:
        out = batched.track_batched_compacted(pb, cam, cfg, sweeps=2)
    finally:
        batched._init_states = init
    return (*out, starts[-1])


def solve_alone(pb, k, x0, cam, cfg, device):
    """Packet k from warm start x0 on ``device``: through the lane-batched CG
    program as a bucket of one lane (sharding.batched_packet_solve, the
    tracker's LaneSolver run whole), and through the sequential chain's
    solver. Returns {route: (omega, cost, iters)}."""
    from cmax_slam_tpu_torch.ops import optim, warp_local
    from cmax_slam_tpu_torch.parallel import sharding

    o = cfg.optim
    data = [t[k:k + 1].to(device) for t in (pb.bearings, pb.dts, pb.weights)]
    x = torch.as_tensor(x0[None], dtype=torch.float32, device=device)
    solve = sharding.batched_packet_solve(cam, cfg.warp.blur_sigma, cfg.contrast_measure, o)
    xs, fs, its = solve(*data, x)
    out = {"lanes": (xs[0].cpu().numpy(), float(fs[0]), int(its[0]))}
    packet = warp_local.EventPacket(*(t[0] for t in data))
    f, vg = warp_local.make_local_objective(packet, cam, cfg.warp.blur_sigma,
                                            cfg.contrast_measure)
    with torch.no_grad():
        res = optim.minimize_fr_cg(
            vg, x[0], f_fn=f, max_line_searches=o.max_line_searches,
            initial_step=o.initial_step, line_search_tol=o.line_search_tol,
            grad_tol=o.grad_tol, fun_tol=o.fun_tol,
            max_fevals_per_linesearch=o.max_fevals_per_linesearch,
            stagnation_patience=o.stagnation_patience,
            secant_refine_evals=o.secant_refine_evals, ladder=o.ladder,
            cg_variant=o.cg_variant)
    out["chain"] = (res.x.cpu().numpy(), float(res.fun), int(res.iters))
    return out


def repro(runs: int, out_dir: str, device: str = "cuda", duration: float = 2.0,
          lost_at: float = LOST) -> int:
    """The repro above on ``device`` over ``duration`` s of phase 6's stream
    (a CPU rehearsal passes "cpu", a short stream and a low ``lost_at``)."""
    from cmax_slam_tpu_torch.calib import bearing_lut
    from cmax_slam_tpu_torch.config import ijrr_config
    from cmax_slam_tpu_torch.parallel import batched

    ev, omega, calib = chip_smoke.make_stream(duration)
    cfg = ijrr_config().frontend
    cam = chip_smoke._cam(calib)
    seq_log = chip_smoke.run_system(device, duration=duration)[2]
    pb = batched.cut_packets(ev.xs, ev.ys, ev.ts, bearing_lut(calib), cam, cfg, device=device)
    seq = dict(zip(np.round(seq_log[:, 0], 9), seq_log[:, 1:]))
    record = {"card": chip_smoke.card_line() if device == "cuda" else device,
              "omega_true": omega.tolist(),
              "times": pb.times.tolist(), "runs": []}
    plan = cuda_iwe.plan_vote_fwd
    for variant in ("G", "P"):
        for r in range(runs):
            cuda_iwe.plan_vote_fwd = _forced(variant)
            try:
                times, om, costs, iters, warm = track(pb, cam, cfg)
            finally:
                cuda_iwe.plan_vote_fwd = plan
            err = np.linalg.norm(om - omega, axis=1)
            lost = np.flatnonzero(err > lost_at)
            print(f"K1 forced {variant} run {r}: median {np.median(err):.4f} rad/s, worst "
                  f"{err.max():.4f} (packet {int(err.argmax())}), lost lanes {lost.tolist()}",
                  flush=True)
            rec = {"variant": variant, "run": r, "omega": om.tolist(), "cost": costs.tolist(),
                   "iters": iters.tolist(), "lost": []}
            for k in lost:
                s = seq.get(round(float(times[k]), 9))
                line = {"packet": int(k), "t": float(times[k]), "omega": om[k].tolist(),
                        "err": float(err[k]), "cost": float(costs[k]), "iters": int(iters[k]),
                        "warm": warm[k].tolist(),
                        "warm_err": float(np.linalg.norm(warm[k] - omega)),
                        "sequential_err": None if s is None
                        else float(np.linalg.norm(s - omega))}
                for where in dict.fromkeys((device, "cpu")):
                    for route, (x, f, it) in solve_alone(pb, k, warm[k], cam, cfg,
                                                         where).items():
                        line[f"{route}_{where}"] = {
                            "omega": x.tolist(), "err": float(np.linalg.norm(x - omega)),
                            "cost": f, "iters": it}
                print("  lost " + json.dumps(line), flush=True)
                rec["lost"].append(line)
            record["runs"].append(rec)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "batched_repro.json")
    with open(path, "w") as fh:
        json.dump(record, fh)
    print(f"wrote {path}", flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=20)
    ap.add_argument("--max-bands", type=int, nargs="+", default=[cuda_iwe.P_MAX_BANDS])
    ap.add_argument("--repro", action="store_true")
    ap.add_argument("--out", default="_work")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    print(f"card: {chip_smoke.card_line()}", flush=True)
    if args.repro:
        cuda_iwe.build()
        return repro(args.runs, args.out)
    for i in range(args.runs):
        cuda_iwe.P_MAX_BANDS = args.max_bands[i % len(args.max_bands)]
        print(f"run {i} P_MAX_BANDS={cuda_iwe.P_MAX_BANDS}", flush=True)
        _, checks, _ = chip_smoke.run_batched()
        if not all(checks.values()):
            print(f"run {i}: phase 6 checks failed: {checks}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
