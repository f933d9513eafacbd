"""Minimal ROS1 bag (format 2.0) reader for event-camera datasets; host-only
copy of cmax_slam_tpu/io/rosbag.py (CameraInfo decodes into the port's
CameraCalibration).

Replaces the reference's rosbag playback path (launch/*.launch `rosbag play`,
docs/test_datasets.md) without any ROS dependency: parses the bag container
(records, chunks with none/bz2 compression, connections) and deserializes
`dvs_msgs/EventArray` messages into bulk numpy arrays plus
`sensor_msgs/CameraInfo` into a CameraCalibration.

Bag format reference: http://wiki.ros.org/Bags/Format/2.0 (public spec).
"""

from __future__ import annotations

import bz2
import struct
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

OP_MESSAGE_DATA = 0x02
OP_BAG_HEADER = 0x03
OP_INDEX_DATA = 0x04
OP_CHUNK = 0x05
OP_CHUNK_INFO = 0x06
OP_CONNECTION = 0x07

# dvs_msgs/Event wire layout: x:uint16 y:uint16 ts:{sec,nsec}:2xuint32 pol:uint8
_EVENT_DTYPE = np.dtype(
    [("x", "<u2"), ("y", "<u2"), ("sec", "<u4"), ("nsec", "<u4"), ("pol", "u1")]
)


def _parse_header(buf: bytes) -> Dict[bytes, bytes]:
    fields = {}
    off = 0
    while off < len(buf):
        (flen,) = struct.unpack_from("<I", buf, off)
        off += 4
        field = buf[off : off + flen]
        off += flen
        key, _, val = field.partition(b"=")
        fields[key] = val
    return fields


def _iter_records(data: bytes, offset: int = 0) -> Iterator[Tuple[dict, bytes]]:
    n = len(data)
    while offset < n:
        (hlen,) = struct.unpack_from("<I", data, offset)
        offset += 4
        header = _parse_header(data[offset : offset + hlen])
        offset += hlen
        (dlen,) = struct.unpack_from("<I", data, offset)
        offset += 4
        payload = data[offset : offset + dlen]
        offset += dlen
        yield header, payload


def _read_string(buf: bytes, off: int) -> Tuple[str, int]:
    (n,) = struct.unpack_from("<I", buf, off)
    off += 4
    return buf[off : off + n].decode("utf-8", "replace"), off + n


def _skip_ros_header(buf: bytes, off: int = 0) -> int:
    """Skip std_msgs/Header: seq(u4) stamp(2xu4) frame_id(string)."""
    off += 12
    (n,) = struct.unpack_from("<I", buf, off)
    return off + 4 + n


class BagReader:
    def __init__(self, path: str):
        with open(path, "rb") as f:
            magic = f.readline()
            if not magic.startswith(b"#ROSBAG V2.0"):
                raise ValueError(f"not a ROS bag v2.0 file: {path} ({magic!r})")
            self._data = f.read()
        self.connections: Dict[int, dict] = {}
        self._messages: List[Tuple[int, bytes]] = []  # (conn_id, raw message)
        self._parse()

    def _parse(self) -> None:
        for header, payload in _iter_records(self._data):
            op = header.get(b"op", b"\x00")[0]
            if op == OP_CONNECTION:
                conn = struct.unpack("<I", header[b"conn"])[0]
                conn_hdr = _parse_header(payload)
                self.connections[conn] = {
                    "topic": header.get(b"topic", b"").decode(),
                    "type": conn_hdr.get(b"type", b"").decode(),
                    "md5sum": conn_hdr.get(b"md5sum", b"").decode(),
                }
            elif op == OP_CHUNK:
                compression = header.get(b"compression", b"none").decode()
                if compression == "none":
                    chunk = payload
                elif compression == "bz2":
                    chunk = bz2.decompress(payload)
                elif compression == "lz4":
                    try:
                        import lz4.frame  # pragma: no cover
                    except ImportError as e:
                        raise NotImplementedError(
                            "lz4-compressed bag and no lz4 module available"
                        ) from e
                    chunk = lz4.frame.decompress(payload)
                else:
                    raise NotImplementedError(f"bag compression {compression}")
                for h2, p2 in _iter_records(chunk):
                    op2 = h2.get(b"op", b"\x00")[0]
                    if op2 == OP_CONNECTION:
                        conn = struct.unpack("<I", h2[b"conn"])[0]
                        conn_hdr = _parse_header(p2)
                        self.connections.setdefault(
                            conn,
                            {
                                "topic": h2.get(b"topic", b"").decode(),
                                "type": conn_hdr.get(b"type", b"").decode(),
                                "md5sum": conn_hdr.get(b"md5sum", b"").decode(),
                            },
                        )
                    elif op2 == OP_MESSAGE_DATA:
                        conn = struct.unpack("<I", h2[b"conn"])[0]
                        self._messages.append((conn, p2))
            # OP_MESSAGE_DATA at top level (unchunked bags)
            elif op == OP_MESSAGE_DATA:
                conn = struct.unpack("<I", header[b"conn"])[0]
                self._messages.append((conn, payload))

    def topics(self) -> Dict[str, str]:
        return {c["topic"]: c["type"] for c in self.connections.values()}

    def messages(self, topic: Optional[str] = None, msg_type: Optional[str] = None):
        for conn, raw in self._messages:
            info = self.connections.get(conn, {})
            if topic is not None and info.get("topic") != topic:
                continue
            if msg_type is not None and info.get("type") != msg_type:
                continue
            yield info, raw


def decode_event_array(raw: bytes):
    """Deserialize one dvs_msgs/EventArray message into numpy arrays."""
    off = _skip_ros_header(raw)
    height, width = struct.unpack_from("<II", raw, off)
    off += 8
    (count,) = struct.unpack_from("<I", raw, off)
    off += 4
    ev = np.frombuffer(raw, dtype=_EVENT_DTYPE, count=count, offset=off)
    ts = ev["sec"].astype(np.float64) + ev["nsec"].astype(np.float64) * 1e-9
    pols = np.where(ev["pol"] > 0, 1, -1).astype(np.int8)
    return (
        ev["x"].astype(np.int32),
        ev["y"].astype(np.int32),
        ts,
        pols,
        (int(width), int(height)),
    )


def read_rosbag_events(path: str, topic: Optional[str] = None):
    """All events from a bag, concatenated in message order.

    Returns (xs, ys, ts, ps). Auto-picks the first dvs_msgs/EventArray topic
    when none is given (the reference subscribes to /dvs/events,
    src/cmax_slam.cpp:21)."""
    bag = BagReader(path)
    xs, ys, ts, ps = [], [], [], []
    for info, raw in bag.messages(topic=topic, msg_type="dvs_msgs/EventArray"):
        x, y, t, p, _ = decode_event_array(raw)
        xs.append(x)
        ys.append(y)
        ts.append(t)
        ps.append(p)
    if not xs:
        raise ValueError(f"no dvs_msgs/EventArray messages in {path}")
    xs = np.concatenate(xs)
    ys = np.concatenate(ys)
    ts = np.concatenate(ts)
    ps = np.concatenate(ps)
    order = np.argsort(ts, kind="stable")
    return xs[order], ys[order], ts[order], ps[order]


def decode_camera_info(raw: bytes):
    """Deserialize sensor_msgs/CameraInfo."""
    off = _skip_ros_header(raw)
    height, width = struct.unpack_from("<II", raw, off)
    off += 8
    model, off = _read_string(raw, off)
    (nd,) = struct.unpack_from("<I", raw, off)
    off += 4
    D = np.frombuffer(raw, "<f8", nd, off).copy()
    off += 8 * nd
    K = np.frombuffer(raw, "<f8", 9, off).reshape(3, 3).copy()
    off += 72
    R = np.frombuffer(raw, "<f8", 9, off).reshape(3, 3).copy()
    off += 72
    P = np.frombuffer(raw, "<f8", 12, off).reshape(3, 4).copy()
    return {"width": width, "height": height, "model": model,
            "D": D, "K": K, "R": R, "P": P}


def read_rosbag_camera_info(path: str, topic: Optional[str] = None):
    """First CameraInfo in the bag -> CameraCalibration (the reference reads
    exactly one and unsubscribes, src/cmax_slam.cpp:122-145)."""
    from ..calib import CameraCalibration

    bag = BagReader(path)
    for info, raw in bag.messages(topic=topic, msg_type="sensor_msgs/CameraInfo"):
        d = decode_camera_info(raw)
        return CameraCalibration(
            width=int(d["width"]), height=int(d["height"]),
            K=d["K"], D=d["D"], R=d["R"], P=d["P"],
        )
    raise ValueError(f"no sensor_msgs/CameraInfo messages in {path}")
