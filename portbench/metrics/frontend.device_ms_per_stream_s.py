"""Device milliseconds of the front-end's programs ("frontend", CUDA events
around each launch) per stream second; traced runs only."""


def read(rec):
    ms = rec.get("program_s", {}).get("frontend")
    return None if ms is None else 1e3 * ms / rec["stream_s"]
