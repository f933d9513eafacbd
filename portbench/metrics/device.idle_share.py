"""The share of the window in which the device ran nothing: 1 - (the union
of the device programs' CUDA-event intervals and the kernels torch.profiler
saw outside them) / the window's wall, in percent; traced runs only."""


def read(rec):
    if "busy_s" not in rec or rec["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"])
