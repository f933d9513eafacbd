"""The control: the plain reference put in the program's place and computed
in bfloat16, the precision below the configurations' float32 (the votes,
warps and images the program computes are float32 work outside matrix
products), judged by the same comparison as the program.

- omega_err, cost_rel_err: each checked packet solved by the reference's
  maximizer in bfloat16 from the program's own warm start (the previous
  packet's answer); its answer held against the truth, and the bfloat16
  contrast it reports at its answer against the float64 contrast there;
- rms_deg: the truth's quaternions rounded to bfloat16 (knots kept in
  bfloat16);
- map_offset_px, map_far_share: the panorama of the last period's events
  rotated by the truth, built in bfloat16 (``reference.truth_map``).

``readings`` also gives the float64 reference's own map's numbers (suffix
``_f64``), the least any map on this pixel grid reads.

``FAULTS`` are the program's own options that break its timed path
underneath while its answers stay self-consistent: a front-end or a
back-end whose solve takes no step (each answer left at the state it
starts from, its cost taken there)."""

from __future__ import annotations

import numpy as np
import torch

from pb import reference

CONTROL_DTYPE = torch.bfloat16

FAULTS = {
    "frontend_frozen": {"frontend.optim.max_line_searches": 0},
    "backend_frozen": {"backend.optim.max_line_searches": 0},
}


def readings(spec: dict, rec: dict, device: str) -> dict:
    st, sensor, out = rec["stream"], rec["sensor"], rec["outputs"]
    s = spec["config"]["settings"]
    ref64 = reference.packets(s, st, sensor, out["packets"], device)
    low = reference.packets(s, st, sensor, out["packets"], device, CONTROL_DTYPE)
    errs, werrs = [], []
    for p64, plow, pk in zip(ref64, low, out["packets"]):
        w = plow.maximize(pk["warm"])
        errs.append(reference.cost_rel_err(p64, w, plow.contrast(w)))
        werrs.append(reference.omega_err(w, st.omega))
    res = {"omega_err": max(werrs), "cost_rel_err": max(errs)}
    if "times" in out:
        q = reference.truth_quats(st.omega, out["times"])
        res["rms_deg"] = reference.rms_deg(q, reference.to_dtype(q, CONTROL_DTYPE))[0]
        H, W = s["backend.pano_map.pano_height"], s["backend.pano_map.pano_width"]
        g1 = st.index(float(out["times"][-1]))
        xs, ys, ts, _ = st.slice(max(g1 - st.n, 0), g1)
        for suffix, dtype in (("", CONTROL_DTYPE), ("_f64", torch.float64)):
            img = reference.truth_map(xs, ys, ts, st.omega, sensor, H, W, dtype, device)
            nums = reference.map_numbers(img.float().cpu().numpy(), st.landmarks, device)
            res.update({k + suffix: v for k, v in nums.items()})
    return res


def omega_errs(rec: dict) -> list:
    """Each checked packet's answer against the truth, as omega_err reads it."""
    return [reference.omega_err(pk["omega"], rec["stream"].omega)
            for pk in rec["outputs"]["packets"]]


def summary_of(rows: list) -> dict:
    """Per number: the smallest reading of a fault's runs."""
    return {key: float(np.min([r["program"][key] for r in rows])) for key in rows[0]["program"]}


def summary(rows: list) -> dict:
    """Per number: the program's largest reading (the lower) and the
    control's smallest (the upper) over the seeds."""
    out = {}
    for key in rows[0]["program"]:
        prog = [r["program"][key] for r in rows]
        ctrl = [r["control"][key] for r in rows if key in r.get("control", {})]
        out[key] = {"lower": float(np.max(prog)), "upper": float(np.min(ctrl)) if ctrl else None}
    return out
