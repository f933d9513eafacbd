"""From the process's start to the window's first push or call: imports,
the libraries' builds (from the checkout's cache after the first run), the
stream's generation and the warm-up."""


def read(rec):
    return rec["setup_s"]
