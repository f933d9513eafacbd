"""Host milliseconds of the back-end's dispatch and completion (the
program's timers backend.fetch and backend.solve over the window) per
window completed in the window."""


def read(rec):
    t = rec["timers"]
    if not rec.get("windows") or ("backend.fetch" not in t and "backend.solve" not in t):
        return None
    return 1e3 * (t.get("backend.fetch", 0.0) + t.get("backend.solve", 0.0)) / rec["windows"]
