"""Device milliseconds of the batched tracker's round programs
("batched.round", CUDA events around each launch) per stream second tracked;
traced runs only."""


def read(rec):
    ms = rec.get("program_s", {}).get("batched.round")
    return None if ms is None else 1e3 * ms / rec["stream_s"]
