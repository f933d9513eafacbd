"""Device milliseconds of the back-end's window programs ("backend.*", CUDA
events around each launch) per window completed in the window; traced runs
only."""


def read(rec):
    ms = [v for k, v in rec.get("program_s", {}).items() if k.startswith("backend.")]
    if not ms or not rec.get("windows"):
        return None
    return 1e3 * sum(ms) / rec["windows"]
