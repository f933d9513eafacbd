"""Host milliseconds inside CMaxSLAM.push_events (the harness's span around
each push, summed) per stream second."""


def read(rec):
    if "push_host_s" not in rec or rec["stream_s"] <= 0:
        return None
    return 1e3 * rec["push_host_s"] / rec["stream_s"]
