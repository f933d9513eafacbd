"""Stream seconds pushed (replay) or tracked (batched) in the window over
the wall from its first push or call to the end of the flush that joins the
work in flight: one ratio over the whole window."""


def read(rec):
    return rec["stream_s"] / rec["window_s"] if rec["window_s"] > 0 else None
