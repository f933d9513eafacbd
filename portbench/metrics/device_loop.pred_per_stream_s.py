"""Loop-predicate executions (device_loop.LAUNCHES["pred"], counted at each
launch's fetch) per stream second: the traffic of the programs' loop nodes."""


def read(rec):
    return rec["pred"] / rec["stream_s"] if rec["stream_s"] > 0 else None
