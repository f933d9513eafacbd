"""Bounded-memory streaming event ingestion; host-only copy of
cmax_slam_tpu/io/streams.py.

The reference consumes an unbounded live ROS topic (src/cmax_slam.cpp:147-161)
and rosbags replayed at rate 1.0 — it never holds a whole recording in RAM.
This module gives the rebuild the same property: generators that yield
(xs, ys, ts, ps) chunks straight off the file/pipe, so multi-GB recordings
(ECRot bags, poster_rotation) and live feeds stream through CMaxSLAM.run with
memory bounded by a few chunks (the in-system EventStore already retires its
prefix as the back-end consumes windows).

Formats:
- .txt/.csv  line-batched reads ('t x y p', the IJRR/ECD format)
- .zip       the first .txt member, line-batched without extracting
- .h5/.hdf5  dataset slice reads (h5py keeps them on disk)
- .bag       incremental ROS1 record parsing (record-at-a-time off the file,
             reusing io/rosbag.py's header/message decoders)
- .npz/.npy  loaded whole (the format is not incrementally readable) and
             sliced — memory equals the file, unavoidable for npz
- any text file object (e.g. sys.stdin) via iter_events_text — the live-feed
  analog of the reference's event subscriber.

Chunks are yielded in timestamp order. Bag messages can interleave topics and
wobble slightly at message granularity, so the bag iterator keeps a one-chunk
reorder cushion: events are sorted within the buffered tail before release
(the offline reader sorts globally; io/rosbag.py read_rosbag_events).
"""

from __future__ import annotations

import os
import struct
from typing import Iterator, Optional, Tuple

import numpy as np

Chunk = Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]


def iter_events(
    path: str,
    chunk_events: int = 1 << 16,
    max_events: Optional[int] = None,
    topic: Optional[str] = None,
) -> Iterator[Chunk]:
    """Yield (xs, ys, ts, ps) chunks from an event file, bounded-memory for
    every incrementally-readable format (dispatch mirrors
    io/events.py:load_events)."""
    ext = os.path.splitext(path)[1].lower()
    if ext in (".txt", ".csv"):
        with open(path, "r") as f:
            yield from _limit(iter_events_text(f, chunk_events), max_events)
    elif ext == ".zip":
        import zipfile
        import io as _io

        with zipfile.ZipFile(path) as z:
            names = [n for n in z.namelist() if n.lower().endswith(".txt")]
            if not names:
                raise ValueError(f"no .txt member inside {path}")
            with z.open(names[0]) as f:
                yield from _limit(
                    iter_events_text(_io.TextIOWrapper(f), chunk_events),
                    max_events,
                )
    elif ext in (".h5", ".hdf5"):
        yield from _limit(_iter_hdf5(path, chunk_events), max_events)
    elif ext == ".bag":
        yield from _limit(_iter_bag(path, chunk_events, topic), max_events)
    elif ext in (".npz", ".npy"):
        from .events import read_events_npy, stream_chunks

        xs, ys, ts, ps = read_events_npy(path)
        if max_events is not None:
            xs, ys, ts, ps = (a[:max_events] for a in (xs, ys, ts, ps))
        yield from stream_chunks(xs, ys, ts, ps, chunk_events)
    else:
        raise ValueError(f"unknown event file format: {path}")


def _limit(it: Iterator[Chunk], max_events: Optional[int]) -> Iterator[Chunk]:
    if max_events is None:
        yield from it
        return
    left = max_events
    for xs, ys, ts, ps in it:
        if left <= 0:
            return
        n = min(len(ts), left)
        yield xs[:n], ys[:n], ts[:n], ps[:n]
        left -= n


def iter_events_text(fobj, chunk_events: int = 1 << 16) -> Iterator[Chunk]:
    """Line-batched 't x y p' reader over any text file object — a file on
    disk, a zip member, or a live pipe (sys.stdin). Reads chunk_events lines
    at a time; never materializes the whole stream."""
    while True:
        data = np.loadtxt(fobj, max_rows=chunk_events, ndmin=2)
        if data.size == 0:
            return
        ts = data[:, 0].astype(np.float64)
        xs = data[:, 1].astype(np.int32)
        ys = data[:, 2].astype(np.int32)
        ps = np.where(data[:, 3] > 0, 1, -1).astype(np.int8)
        yield xs, ys, ts, ps
        if len(ts) < chunk_events:
            return


def _iter_hdf5(path: str, chunk_events: int, group: str = "events"
               ) -> Iterator[Chunk]:
    import h5py

    with h5py.File(path, "r") as f:
        g = f[group]
        n = g["t"].shape[0]
        for i in range(0, n, chunk_events):
            j = min(i + chunk_events, n)
            yield (
                np.asarray(g["x"][i:j], np.int32),
                np.asarray(g["y"][i:j], np.int32),
                np.asarray(g["t"][i:j], np.float64),
                np.where(np.asarray(g["p"][i:j]) > 0, 1, -1).astype(np.int8),
            )


# ---------------------------------------------------------------------------
# Incremental ROS1 bag streaming
# ---------------------------------------------------------------------------

def _iter_bag_file_records(f) -> Iterator[Tuple[dict, bytes]]:
    """Top-level bag records, one at a time off the file handle."""
    from .rosbag import _parse_header

    while True:
        b = f.read(4)
        if len(b) < 4:
            return
        (hlen,) = struct.unpack("<I", b)
        header = _parse_header(f.read(hlen))
        (dlen,) = struct.unpack("<I", f.read(4))
        payload = f.read(dlen)
        yield header, payload


def _iter_bag_messages(path: str) -> Iterator[Tuple[dict, bytes]]:
    """(connection info, raw message) pairs, streamed record-at-a-time;
    memory is bounded by one (decompressed) bag chunk."""
    import bz2

    from .rosbag import (
        OP_CHUNK, OP_CONNECTION, OP_MESSAGE_DATA, _iter_records, _parse_header,
    )

    connections: dict = {}

    def conn_of(header) -> int:
        return struct.unpack("<I", header[b"conn"])[0]

    with open(path, "rb") as f:
        magic = f.readline()
        if not magic.startswith(b"#ROSBAG V2.0"):
            raise ValueError(f"not a ROS bag v2.0 file: {path} ({magic!r})")
        for header, payload in _iter_bag_file_records(f):
            op = header.get(b"op", b"\x00")[0]
            if op == OP_CONNECTION:
                connections[conn_of(header)] = {
                    "topic": header.get(b"topic", b"").decode(),
                    "type": _parse_header(payload).get(b"type", b"").decode(),
                }
            elif op == OP_CHUNK:
                comp = header.get(b"compression", b"none").decode()
                if comp == "none":
                    chunk = payload
                elif comp == "bz2":
                    chunk = bz2.decompress(payload)
                else:
                    raise NotImplementedError(f"bag compression {comp}")
                for h2, p2 in _iter_records(chunk):
                    op2 = h2.get(b"op", b"\x00")[0]
                    if op2 == OP_CONNECTION:
                        connections.setdefault(conn_of(h2), {
                            "topic": h2.get(b"topic", b"").decode(),
                            "type": _parse_header(p2).get(b"type", b"").decode(),
                        })
                    elif op2 == OP_MESSAGE_DATA:
                        yield connections.get(conn_of(h2), {}), p2
            elif op == OP_MESSAGE_DATA:
                yield connections.get(conn_of(header), {}), payload


def _iter_bag(path: str, chunk_events: int, topic: Optional[str] = None
              ) -> Iterator[Chunk]:
    """Stream dvs_msgs/EventArray events out of a bag in timestamp order.

    Keeps a reorder cushion of one chunk: release the sorted head of the
    buffer only while at least chunk_events remain buffered behind it, so
    message-granularity wobble never emits out-of-order chunks."""
    from .rosbag import decode_event_array

    buf: list = []
    buffered = 0

    def drain(final: bool) -> Iterator[Chunk]:
        nonlocal buf, buffered
        keep = 0 if final else chunk_events
        if buffered <= keep:
            return
        xs, ys, ts, ps = (np.concatenate(a) for a in zip(*buf))
        order = np.argsort(ts, kind="stable")
        xs, ys, ts, ps = xs[order], ys[order], ts[order], ps[order]
        n_out = len(ts) - keep
        for i in range(0, n_out, chunk_events):
            j = min(i + chunk_events, n_out)
            yield xs[i:j], ys[i:j], ts[i:j], ps[i:j]
        buf = [(xs[n_out:], ys[n_out:], ts[n_out:], ps[n_out:])]
        buffered = keep

    seen_any = False
    for info, raw in _iter_bag_messages(path):
        if info.get("type") != "dvs_msgs/EventArray":
            continue
        if topic is not None and info.get("topic") != topic:
            continue
        x, y, t, p, _ = decode_event_array(raw)
        seen_any = True
        if len(t) == 0:
            continue
        buf.append((x, y, t, p))
        buffered += len(t)
        if buffered >= 2 * chunk_events:
            yield from drain(final=False)
    if not seen_any:
        raise ValueError(f"no dvs_msgs/EventArray messages in {path}")
    yield from drain(final=True)
