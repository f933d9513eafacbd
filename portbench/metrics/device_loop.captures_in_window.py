"""Graphs captured inside the window (device_loop.CAPTURES["graphs"]): each
is a stall the warm-up missed."""


def read(rec):
    return rec["captures"]
