"""The port's host data plane (cmax_slam_tpu_torch/io/native.py: the library
built from native/evstream.cpp) against its plain numpy versions and the JAX
package's cmax_slam_tpu.io.native, on the same numpy inputs from a seed.

Every comparison is exact: the library and the JAX package's run the same
C++ source, and the plain versions the same comparisons in float64 (the
trigger scan, the window search) and the same float32 casts (the gather).
The one documented difference: the library's scan stops after ``max_out``
triggers and returns the index to resume from, where the plain scan runs
to the end of the stream.
"""

import hashlib
import os

import numpy as np
import pytest
import torch

from cmax_slam_tpu.io import native as jnative
from cmax_slam_tpu_torch.config import FrontendConfig, WarpOptions
from cmax_slam_tpu_torch.frontend import Frontend
from cmax_slam_tpu_torch.io import native
from cmax_slam_tpu_torch.ops import nvcc
from cmax_slam_tpu_torch.ops.warp_local import CameraParams
from cmax_slam_tpu_torch.parallel import batched

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H = 32, 24


def _stream(rng, n, repeats=True):
    """Sorted times on [0, 1) with runs of equal timestamps."""
    ts = np.sort(rng.uniform(0, 1, n))
    if repeats:
        ts = np.repeat(ts[: n // 3], 3)[:n]
        ts = np.concatenate([ts, np.full(n - len(ts), ts[-1])]) if len(ts) < n else ts
    return ts


def _equal_triple(a, b):
    np.testing.assert_array_equal(a[0], b[0])
    assert a[0].dtype == b[0].dtype == np.int64
    assert (a[1], a[2]) == (b[1], b[2])


def _scans(ts, cursor, nxt, dt, max_out=65536):
    ours = native.scan_triggers(ts, cursor, nxt, dt, max_out)
    return ours, jnative.scan_triggers(ts, cursor, nxt, dt, max_out)


@pytest.mark.parametrize("repeats", [False, True])
@pytest.mark.parametrize("cursor", [-0.5, 0.004, 0.5, 1.5])
def test_scan_triggers_matches_jax_and_plain(repeats, cursor):
    """Cursor before, inside and after the stream; with runs of equal
    times, each event triggers at most once and the cursor steps by dt."""
    ts = _stream(np.random.default_rng(1), 3000, repeats)
    ours, theirs = _scans(ts, cursor, 0, 0.01)
    _equal_triple(ours, theirs)
    _equal_triple(ours, native.scan_triggers_plain(ts, cursor, 0, 0.01))
    if cursor > ts[-1]:
        assert len(ours[0]) == 0 and ours[2] == len(ts)


def test_scan_triggers_resumes_across_calls_and_takes_an_empty_stream():
    """A scan over a store that grows between calls (the front-end's
    pushes) resumes where the last call stopped, as one scan over the
    whole stream does; an empty stream triggers nothing."""
    ts = _stream(np.random.default_rng(2), 4000)
    whole = native.scan_triggers(ts, 0.003, 0, 0.007)
    first = native.scan_triggers(ts[:1700], 0.003, 0, 0.007)
    second = native.scan_triggers(ts, first[1], first[2], 0.007)
    _equal_triple(first, jnative.scan_triggers(ts[:1700], 0.003, 0, 0.007))
    _equal_triple(second, jnative.scan_triggers(ts, first[1], first[2], 0.007))
    np.testing.assert_array_equal(np.concatenate([first[0], second[0]]), whole[0])
    assert second[1:] == whole[1:]
    empty = np.empty(0, np.float64)
    for res in (*_scans(empty, 0.1, 0, 0.01), native.scan_triggers_plain(empty, 0.1, 0, 0.01)):
        _equal_triple(res, (np.empty(0, np.int64), 0.1, 0))


def test_scan_triggers_max_out_boundary():
    """``max_out`` hit exactly: the library returns that many triggers, the
    cursor past them and the index after the last one, as the JAX package's
    C++ scan does; resumed from there it finds the rest. The plain scan
    ignores ``max_out`` and runs to the end (the JAX package's numpy
    fallback)."""
    ts = _stream(np.random.default_rng(3), 2000, repeats=False)
    full = native.scan_triggers_plain(ts, 0.002, 0, 0.01)
    k = len(full[0])
    assert k > 40
    ours, theirs = _scans(ts, 0.002, 0, 0.01, max_out=40)
    assert len(ours[0]) == 40 and ours[2] == ours[0][-1] + 1 < len(ts)
    np.testing.assert_array_equal(ours[0], full[0][:40])
    assert ours[1] == pytest.approx(0.002 + 40 * 0.01, abs=1e-12)
    if jnative.available():  # the JAX package's C++ (its fallback ignores max_out)
        _equal_triple(ours, theirs)
    plain = native.scan_triggers_plain(ts, 0.002, 0, 0.01, max_out=40)
    _equal_triple(plain, full)
    rest = native.scan_triggers(ts, ours[1], ours[2], 0.01, max_out=40)
    np.testing.assert_array_equal(np.concatenate([ours[0], rest[0]])[:k], full[0][:80])
    # exactly max_out triggers in the stream: the counts and cursors agree,
    # the resume index does not (the library stops at the last trigger)
    exact = native.scan_triggers(ts, 0.002, 0, 0.01, max_out=k)
    np.testing.assert_array_equal(exact[0], full[0])
    assert exact[1] == full[1] and exact[2] == full[0][-1] + 1 <= full[2] == len(ts)
    if jnative.available():
        _equal_triple(exact, jnative.scan_triggers(ts, 0.002, 0, 0.01, max_out=k))


@pytest.mark.parametrize("n", [37, 64, 90])  # n < cap, n = cap, end - beg > cap
def test_gather_packet_matches_jax_and_plain(n):
    rng = np.random.default_rng(4)
    N = 200
    xs = rng.integers(0, W, N).astype(np.int32)
    ys = rng.integers(0, H, N).astype(np.int32)
    ts = np.sort(rng.uniform(10.0, 10.5, N))
    lut = rng.normal(size=(W * H, 3)).astype(np.float32)
    beg, cap, t0 = 50, 64, 10.2
    args = (xs, ys, ts, beg, beg + n, cap, lut, W, t0)
    ours = native.gather_packet(*args)
    for ref in (jnative.gather_packet(*args), native.gather_packet_plain(*args)):
        for a, b in zip(ours, ref):
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b)
    m = min(n, cap)
    assert np.all(ours[0][m:] == [0, 0, 1]) and np.all(ours[1][m:] == 0)
    assert np.all(ours[2][:m] == 1) and np.all(ours[2][m:] == 0)
    with pytest.raises(ValueError):
        native.gather_packet(xs, ys, ts, beg, N + 1, cap, lut, W, t0)
    with pytest.raises(ValueError):
        native.gather_packet(xs, ys, ts, beg, beg + n, cap, lut[: W * (H - 1)], W, t0)


def test_window_matches_jax_and_plain():
    ts = _stream(np.random.default_rng(5), 500)
    cases = [(-1.0, -0.5), (-1.0, float(ts[0])), (float(ts[0]), float(ts[-1])),
             (float(ts[-1]), 2.0), (2.0, 3.0), (float(ts[30]), float(ts[30])),
             (float(ts[99]), float(ts[300]))]
    for lo, hi in cases:
        got = native.window(ts, lo, hi)
        assert got == jnative.window(ts, lo, hi) == native.window_plain(ts, lo, hi)
    assert native.window(ts, -1.0, 2.0) == (0, len(ts))
    assert native.window(np.empty(0), 0.0, 1.0) == (0, 0)


def test_parse_events_txt_matches_jax_and_plain(tmp_path):
    """Comment lines, blank lines, CRLF line ends and ``max_events``."""
    rng = np.random.default_rng(6)
    ts = np.sort(rng.uniform(0, 1, 40))
    lines = ["# t x y p", ""]
    for i, t in enumerate(ts):
        lines.append(f"{t:.9f} {rng.integers(0, W)} {rng.integers(0, H)} {i % 2}")
        if i == 10:
            lines += ["", "# a comment"]
    path = tmp_path / "events.txt"
    path.write_bytes(("\r\n".join(lines) + "\r\n").encode())
    for max_events in (-1, 25, 40, 60):
        ours = native.parse_events_txt(str(path), max_events)
        assert len(ours[2]) == min(40, max_events if max_events >= 0 else 40)
        for ref in (jnative.parse_events_txt(str(path), max_events),
                    native.parse_events_txt_plain(str(path), max_events)):
            for a, b in zip(ours, ref):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
    with pytest.raises(IOError):
        native.parse_events_txt(str(tmp_path / "missing.txt"))


def test_library_builds_into_build_dir_under_its_hash():
    """The library is built from native/evstream.cpp into _build/, named by a
    hash of the source, the compiler and the flags; the committed
    native/libevstream.so is never loaded."""
    assert native.available()
    assert native.SOURCE == nvcc.BUILD_DIR.parent.parent / "native" / "evstream.cpp"
    assert native.SOURCE.exists()
    flags = (native.compiler(), *native.CXX_FLAGS)
    assert not {"-march=native", "-ffast-math"} & set(flags)
    digest = hashlib.sha256(native.SOURCE.read_bytes() + " ".join(flags).encode())
    so = nvcc.BUILD_DIR / f"libevstream_{digest.hexdigest()[:16]}.so"
    assert native.library_path() == so and so.exists()
    assert native.build()._name == str(so)


_PROBE = """
import json, sys
sys.modules["cmax_slam_tpu"] = None  # the JAX package, which loads native/libevstream.so
import numpy as np
from cmax_slam_tpu_torch.io import native
trig = native.scan_triggers(np.linspace(0, 1, 101), 0.05, 0, 0.1)[0]
with open("/proc/self/maps") as fh:
    mapped = {line.split()[-1] for line in fh if "evstream" in line}
print(json.dumps({"mapped": sorted(mapped), "triggers": len(trig),
                  "lib": str(native.library_path())}))
"""


def test_the_committed_library_is_never_loaded(tmp_path):
    """In a process of the port alone, the only evstream library mapped is
    the one built into _build/, never native/libevstream.so."""
    import json
    import subprocess
    import sys

    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300, env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["triggers"] == 10 and res["mapped"] == [res["lib"]]


def test_failed_build_raises_and_is_not_available(monkeypatch, tmp_path):
    """A compiler that does not exist: the build raises with its error,
    available() is False, and the public functions raise (no numpy
    fallback)."""
    monkeypatch.setattr(native, "_loaded", {})
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-c++"))
    assert not native.library_path().exists()
    with pytest.raises(RuntimeError, match="no-such-c"):
        native.build()
    assert not native.available()
    with pytest.raises(RuntimeError):
        native.scan_triggers(np.linspace(0, 1, 10), 0.0, 0, 0.1)
    with pytest.raises(RuntimeError):
        native.gather_packet(np.zeros(4, np.int32), np.zeros(4, np.int32),
                             np.linspace(0, 1, 4), 0, 4, 8, np.zeros((W * H, 3), np.float32),
                             W, 0.0)


def test_frontend_scans_through_the_library_in_place():
    """Every push runs one library scan over the store's times, read in
    place (no copy per push), and finds the JAX package's triggers."""
    from cmax_slam_tpu.io import native as jn

    rng = np.random.default_rng(7)
    cam = CameraParams(fx=30.0, fy=30.0, cx=W / 2, cy=H / 2, width=W, height=H)
    lut = np.tile(np.array([[0.0, 0.0, 1.0]], np.float32), (W * H, 1))
    cfg = FrontendConfig(warp=WarpOptions(blur_sigma=1.0, event_batch_size=64),
                         num_events_per_packet=4096, dt_ang_vel=0.01, device_store=False)
    fe = Frontend(cam, lut, cfg, device="cpu")
    ts = np.sort(rng.uniform(0, 0.05, 600))
    xs, ys = rng.integers(0, W, 600), rng.integers(0, H, 600)
    calls = native.CALLS["scan_triggers"]
    cursor, nxt, trig = ts[0] + 0.005, 0, []
    for lo in range(0, 600, 200):  # three pushes, too few events for a packet
        sl = slice(lo, lo + 200)
        assert fe.push_events(xs[sl], ys[sl], ts[sl], np.ones(200, np.int8)) == []
        store_ts = fe.store._ts
        assert np.ascontiguousarray(store_ts, np.float64) is store_ts
        t, cursor, nxt = jn.scan_triggers(ts[: lo + 200], cursor, nxt, 0.01)
        trig += list(t)
    assert native.CALLS["scan_triggers"] == calls + 3
    assert [end - fe.half - 1 for _, end in fe._pending] == trig
    assert fe._cursor == cursor and fe._next_check_abs == nxt


def test_cut_packets_goes_through_the_library(monkeypatch):
    """The batched cut scans once with max_out = 1 << 22 (the JAX package's
    value) and gathers each packet through the library; the arrays it
    passes are converted once, not per packet."""
    rng = np.random.default_rng(8)
    n = 6000
    ts = np.sort(rng.uniform(0, 0.2, n))
    xs, ys = rng.integers(0, W, n), rng.integers(0, H, n)  # int64: converted once
    lut = rng.normal(size=(W * H, 3)).astype(np.float32)
    cam = CameraParams(fx=30.0, fy=30.0, cx=W / 2, cy=H / 2, width=W, height=H)
    cfg = FrontendConfig(warp=WarpOptions(blur_sigma=1.0, event_batch_size=64),
                         num_events_per_packet=1024, dt_ang_vel=0.01)
    seen = {"max_out": [], "xs": set()}
    scan, gather = native.scan_triggers, native.gather_packet

    def spy_scan(*a, max_out=65536):
        seen["max_out"].append(max_out)
        return scan(*a, max_out=max_out)

    def spy_gather(xs_, *a):
        seen["xs"].add(id(xs_))
        assert xs_.dtype == np.int32 and xs_.flags.c_contiguous
        return gather(xs_, *a)

    monkeypatch.setattr(native, "scan_triggers", spy_scan)
    monkeypatch.setattr(native, "gather_packet", spy_gather)
    calls = dict(native.CALLS)
    pb = batched.cut_packets(xs, ys, ts, lut, cam, cfg, device="cpu")
    P = pb.bearings.shape[0]
    assert P > 10 and seen["max_out"] == [1 << 22] and len(seen["xs"]) == 1
    assert native.CALLS["scan_triggers"] == calls["scan_triggers"] + 1
    assert native.CALLS["gather_packet"] == calls["gather_packet"] + P
