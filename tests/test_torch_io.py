"""The port's ingestion and output helpers against the JAX package's on the
same files: the whole-file loaders and the streaming iterators for every
format (txt, zip, npz, h5, bag with none and bz2 compression), the
CameraInfo and calibration loaders, the text stream a live feed pipes in,
--max-events, and the TUM and PNG/PGM writers.

Every reader is host numpy on both sides, so the arrays must be identical:
the comparisons are exact."""

import io
import struct
import zipfile
import zlib

import numpy as np
import pytest

from cmax_slam_tpu import spline as jspline
from cmax_slam_tpu.calib import CameraCalibration as JCalibration
from cmax_slam_tpu.io import events as jevents, rosbag as jrosbag, streams as jstreams
from cmax_slam_tpu.utils import evaluate as jevaluate, image as jimage
from cmax_slam_tpu_torch import spline
from cmax_slam_tpu_torch.calib import CameraCalibration
from cmax_slam_tpu_torch.io import events, rosbag, streams
from cmax_slam_tpu_torch.utils import evaluate, image

from test_io import _camera_info_msg, _event_array_msg, _write_test_bag

FORMATS = ["txt", "zip", "npz", "h5", "bag-none", "bag-bz2"]


def _stream(n=1500, seed=3):
    rng = np.random.default_rng(seed)
    ts = np.sort(rng.uniform(0, 1, n))
    xs = rng.integers(0, 240, n)
    ys = rng.integers(0, 180, n)
    ps = rng.choice([0, 1], n)
    return xs, ys, ts, ps


def _write(tmp_path, fmt):
    """The same events in one format; returns the path."""
    xs, ys, ts, ps = _stream()
    if fmt in ("txt", "zip"):
        txt = tmp_path / "events.txt"
        with open(txt, "w") as f:
            for t, x, y, p in zip(ts, xs, ys, ps):
                f.write(f"{t:.9f} {x} {y} {p}\n")
        if fmt == "txt":
            return str(txt)
        path = str(tmp_path / "events.zip")
        with zipfile.ZipFile(path, "w") as z:
            z.write(txt, "events.txt")
        return path
    if fmt == "npz":
        path = str(tmp_path / "events.npz")
        np.savez(path, x=xs, y=ys, t=ts, p=ps)
        return path
    if fmt == "h5":
        h5py = pytest.importorskip("h5py")
        path = str(tmp_path / "events.h5")
        with h5py.File(path, "w") as f:
            for k, a in zip("xytp", (xs, ys, ts, ps)):
                f.create_dataset(f"events/{k}", data=a)
        return path
    # bag: messages of 20-60 events whose stamps wobble across message edges
    comp = fmt.split("-")[1]
    rng = np.random.default_rng(7)
    msgs, i = [], 0
    while i < len(ts):
        j = min(i + int(rng.integers(20, 60)), len(ts))
        t = ts[i:j] + rng.uniform(0, 0.002, j - i)
        msgs.append(_event_array_msg(xs[i:j], ys[i:j], np.sort(t), 2 * ps[i:j] - 1))
        i = j
    path = str(tmp_path / f"events_{comp}.bag")
    _write_test_bag(path, msgs, compression=comp)
    return path


def _assert_same(a, b):
    assert len(a) == len(b) == 4
    for u, v, name in zip(a, b, "xytp"):
        assert u.dtype == v.dtype, name
        np.testing.assert_array_equal(u, v, err_msg=name)


@pytest.mark.parametrize("fmt", FORMATS)
def test_whole_file_loader_matches_jax(tmp_path, fmt):
    path = _write(tmp_path, fmt)
    _assert_same(events.load_events(path), jevents.load_events(path))
    _assert_same(events.load_events(path, max_events=700),
                 jevents.load_events(path, max_events=700))


@pytest.mark.parametrize("max_events", [None, 1000])
@pytest.mark.parametrize("fmt", FORMATS)
def test_streaming_iterator_matches_jax(tmp_path, fmt, max_events):
    """Chunk for chunk: the same boundaries and the same events, in order.
    A text file is parsed by repeated bounded loadtxt calls on one file
    object; the count check shows that none skips or repeats a line."""
    path = _write(tmp_path, fmt)
    got = list(streams.iter_events(path, chunk_events=128, max_events=max_events))
    ref = list(jstreams.iter_events(path, chunk_events=128, max_events=max_events))
    assert len(got) == len(ref) >= 7
    for a, b in zip(got, ref):
        _assert_same(a, b)
    n = sum(len(c[2]) for c in got)
    assert n == (1500 if max_events is None else max_events)
    ts = np.concatenate([c[2] for c in got])
    assert np.all(np.diff(ts) >= 0)


def test_stdin_text_stream_matches_jax():
    """iter_events_text over a pipe-like text object, bounded by _limit the
    way the CLI bounds --events - with --max-events."""
    lines = "".join(f"{i * 0.001:.6f} {i % 30} {i % 20} {i % 2}\n" for i in range(500))
    for limit in (None, 333):
        got = list(streams._limit(streams.iter_events_text(io.StringIO(lines), 64), limit))
        ref = list(jstreams._limit(jstreams.iter_events_text(io.StringIO(lines), 64), limit))
        assert len(got) == len(ref)
        for a, b in zip(got, ref):
            _assert_same(a, b)
        assert sum(len(c[2]) for c in got) == (limit or 500)


def test_bag_without_events_raises_like_jax(tmp_path):
    p = str(tmp_path / "none.bag")
    _write_test_bag(p, [_event_array_msg([1], [2], [0.1], [1])],
                    conns=[("/other", "std_msgs/String")])
    for mod in (streams, jstreams):
        with pytest.raises(ValueError, match="no dvs_msgs/EventArray"):
            list(mod.iter_events(p))
    with pytest.raises(ValueError, match="no dvs_msgs/EventArray"):
        rosbag.read_rosbag_events(p)


def _same_calib(a, b):
    assert (a.width, a.height) == (b.width, b.height)
    for name in ("K", "D", "R", "P"):
        u, v = getattr(a, name), getattr(b, name)
        assert (u is None) == (v is None), name
        if u is not None:
            np.testing.assert_array_equal(u, v, err_msg=name)


@pytest.mark.parametrize("compression", ["none", "bz2"])
def test_camera_info_roundtrip_matches_jax(tmp_path, compression):
    p = str(tmp_path / "cam.bag")
    msgs = [(0, _camera_info_msg(240, 180, 190.0, 191.0, 120.5, 90.5,
                                 d=[-0.3, 0.1, 0, 0, 0]))]
    msgs += [(1, _event_array_msg([1, 2], [3, 4], [0.5, 0.6], [1, -1]))]
    _write_test_bag(p, msgs, compression=compression,
                    conns=[("/dvs/camera_info", "sensor_msgs/CameraInfo"),
                           ("/dvs/events", "dvs_msgs/EventArray")])
    calib = rosbag.read_rosbag_camera_info(p)
    assert isinstance(calib, CameraCalibration)
    _same_calib(calib, jrosbag.read_rosbag_camera_info(p))
    np.testing.assert_allclose(calib.K[1, 2], 90.5)
    np.testing.assert_allclose(calib.D[0], -0.3)
    assert rosbag.BagReader(p).topics() == jrosbag.BagReader(p).topics()


def test_calibration_files_match_jax(tmp_path):
    txt = tmp_path / "calib.txt"
    txt.write_text("199.1 198.7 120.3 90.2 -0.35 0.12 0.001 -0.002 0.01\n")
    _same_calib(CameraCalibration.from_txt(str(txt), 240, 180),
                JCalibration.from_txt(str(txt), 240, 180))
    short = tmp_path / "short.txt"
    short.write_text("199.1 198.7 120.3 90.2 -0.35 0.12\n")
    _same_calib(CameraCalibration.from_txt(str(short), 240, 180),
                JCalibration.from_txt(str(short), 240, 180))
    pytest.importorskip("yaml")
    yml = tmp_path / "calib.yaml"
    yml.write_text(
        "image_width: 240\nimage_height: 180\ncamera_name: DAVIS-test\n"
        "camera_matrix:\n  rows: 3\n  cols: 3\n"
        "  data: [199.1, 0, 120.3, 0, 198.7, 90.2, 0, 0, 1]\n"
        "distortion_model: plumb_bob\n"
        "distortion_coefficients:\n  rows: 1\n  cols: 5\n"
        "  data: [-0.35, 0.12, 0.001, -0.002, 0.01]\n"
        "rectification_matrix:\n  rows: 3\n  cols: 3\n  data: [1, 0, 0, 0, 1, 0, 0, 0, 1]\n"
        "projection_matrix:\n  rows: 3\n  cols: 4\n"
        "  data: [180, 0, 121, 0, 0, 180, 91, 0, 0, 0, 1, 0]\n")
    _same_calib(CameraCalibration.from_yaml(str(yml)), JCalibration.from_yaml(str(yml)))


def test_tum_roundtrip_matches_jax(tmp_path):
    qs = np.stack([jspline._np_quat_exp(np.array([0.1, -0.05, 0.2]) * i) for i in range(6)])
    traj = spline.Trajectory(0.3, 0.1, order=2)
    traj.push_ctrl_poses(qs)
    jtraj = jspline.Trajectory(0.3, 0.1, order=2)
    jtraj.push_ctrl_poses(qs)
    p, pj = str(tmp_path / "port.txt"), str(tmp_path / "jax.txt")
    evaluate.write_tum_trajectory(p, traj, dt_sample=0.02)
    jevaluate.write_tum_trajectory(pj, jtraj, dt_sample=0.02)
    assert open(p).read() == open(pj).read()
    times, quats = evaluate.read_tum_trajectory(p)
    np.testing.assert_allclose(quats, traj.evaluate(times), atol=2e-9)
    for a, b in zip((times, quats), jevaluate.read_tum_trajectory(p)):
        np.testing.assert_array_equal(a, b)
    # a trajectory with no evaluable span writes the same placeholder
    empty = spline.Trajectory(0.0, 0.1, order=2)
    empty.push_ctrl_poses(qs[:1])
    evaluate.write_tum_trajectory(p, empty)
    assert open(p).read() == "# empty trajectory\n"


def _decode_png(data: bytes) -> np.ndarray:
    """Inverse of write_png for its own output (filter 0 on every row)."""
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    off, chunks = 8, {}
    while off < len(data):
        (n,) = struct.unpack(">I", data[off:off + 4])
        tag = data[off + 4:off + 8]
        payload = data[off + 8:off + 8 + n]
        (crc,) = struct.unpack(">I", data[off + 8 + n:off + 12 + n])
        assert crc == zlib.crc32(tag + payload) & 0xFFFFFFFF, tag
        chunks[tag] = payload
        off += 12 + n
    w, h, depth, color = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    ch = 3 if color == 2 else 1
    raw = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8).reshape(h, 1 + w * ch)
    assert depth == 8 and not raw[:, 0].any()
    img = raw[:, 1:].reshape(h, w, ch)
    return img[..., 0] if ch == 1 else img


@pytest.mark.parametrize("kind", ["gray", "rgb", "float"])
def test_png_and_pgm_roundtrip_match_jax(tmp_path, kind):
    rng = np.random.default_rng(1)
    if kind == "gray":
        img = rng.integers(0, 256, (32, 48)).astype(np.uint8)
    elif kind == "rgb":
        img = rng.integers(0, 256, (20, 30, 3)).astype(np.uint8)
    else:
        img = rng.normal(size=(16, 24)) * 3.0  # normalized to [0, 255] by the writer
    p, pj = str(tmp_path / "port.png"), str(tmp_path / "jax.png")
    image.write_png(p, img)
    jimage.write_png(pj, img)
    data = open(p, "rb").read()
    assert data == open(pj, "rb").read()
    expect = img if kind != "float" else (image.normalize_minmax(img) * 255).astype(np.uint8)
    np.testing.assert_array_equal(_decode_png(data), expect)
    if kind != "rgb":
        image.write_pgm(p, img)
        jimage.write_pgm(pj, img)
        assert open(p, "rb").read() == open(pj, "rb").read()


def test_display_transforms_match_jax():
    rng = np.random.default_rng(2)
    img = rng.uniform(0, 7, (16, 32)) ** 2
    np.testing.assert_array_equal(image.render_pano(img, gamma=0.75),
                                  jimage.render_pano(img, gamma=0.75))
    np.testing.assert_array_equal(image.render_pano(img, gamma=0.5, invert=False),
                                  jimage.render_pano(img, gamma=0.5, invert=False))
    np.testing.assert_array_equal(image.normalize_robust(img, 1.0),
                                  jimage.normalize_robust(img, 1.0))
    assert image.minmax_robust(img) == jimage.minmax_robust(img)
