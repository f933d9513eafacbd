"""Image post-processing and writers; host-only numpy and zlib copy of
cmax_slam_tpu/utils/image.py.

Replaces the reference's OpenCV display path (src/utils/image_utils.cpp:8-93,
pose_graph_optimizer.cpp:378-413): min-max normalization, robust percentile
normalization, gamma correction, color inversion, and PNG/PGM output without
OpenCV.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def normalize_minmax(img: np.ndarray, eps: float = 1e-12) -> np.ndarray:
    """Scale to [0, 1] (cv::normalize NORM_MINMAX semantics)."""
    img = np.asarray(img, np.float64)
    lo, hi = float(img.min()), float(img.max())
    return (img - lo) / max(hi - lo, eps)


def minmax_robust(img: np.ndarray, percent: float = 0.1):
    """Robust min/max discarding `percent`% outliers on each tail
    (minMaxLocRobust, src/utils/image_utils.cpp:68-79)."""
    flat = np.sort(np.asarray(img, np.float64).ravel())
    n = len(flat)
    k = int(round(n * percent / 100.0))
    return flat[min(k, n - 1)], flat[max(n - 1 - k, 0)]


def normalize_robust(img: np.ndarray, percent: float = 0.1) -> np.ndarray:
    """Normalize to [0,1] using robust extrema (normalize,
    src/utils/image_utils.cpp:85-93)."""
    lo, hi = minmax_robust(img, percent)
    return np.clip((np.asarray(img, np.float64) - lo) / max(hi - lo, 1e-12), 0, 1)


def render_pano(img: np.ndarray, gamma: float = 0.75, invert: bool = True) -> np.ndarray:
    """Pano display transform: minmax -> gamma -> [0,255] -> invert
    (publishEventImage, pose_graph_optimizer.cpp:384-391). Returns uint8."""
    out = normalize_minmax(img) ** gamma
    out = normalize_minmax(out) * 255.0
    if invert:
        out = 255.0 - out
    return out.astype(np.uint8)


def save_image_maxabs(path: str, img: np.ndarray) -> None:
    """Save with symmetric max-abs scaling: 0 -> mid-gray
    (save_image_maxabs, src/utils/image_utils.cpp:8-28)."""
    img = np.asarray(img, np.float64)
    m = max(float(np.abs(img).max()), 1e-12)
    out = ((img / m) * 127.5 + 127.5).clip(0, 255).astype(np.uint8)
    write_png(path, out)


def save_derivative_images(path: str, deriv: np.ndarray, cols: int = 3) -> None:
    """Tile (K, 3, H, W) derivative images into one max-abs-scaled grid image
    (saveDerivativeImages, src/utils/image_utils.cpp:41-62)."""
    deriv = np.asarray(deriv)
    flat = deriv.reshape(-1, *deriv.shape[-2:])
    n = len(flat)
    rows = (n + cols - 1) // cols
    H, W = flat.shape[-2:]
    canvas = np.zeros((rows * H, cols * W))
    for i, img in enumerate(flat):
        r, c = divmod(i, cols)
        canvas[r * H : (r + 1) * H, c * W : (c + 1) * W] = img
    save_image_maxabs(path, canvas)


def write_pgm(path: str, img: np.ndarray) -> None:
    """Write a binary PGM (grayscale)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = (normalize_minmax(img) * 255).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(f"P5\n{img.shape[1]} {img.shape[0]}\n255\n".encode())
        f.write(img.tobytes())


def write_png(path: str, img: np.ndarray) -> None:
    """Minimal PNG writer (grayscale or RGB uint8), no external deps."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = (normalize_minmax(img) * 255).astype(np.uint8)
    if img.ndim == 2:
        color_type = 0
        raw = img[:, :, None]
    elif img.ndim == 3 and img.shape[2] == 3:
        color_type = 2
        raw = img
    else:
        raise ValueError(f"unsupported image shape {img.shape}")
    h, w = raw.shape[:2]

    def chunk(tag: bytes, payload: bytes) -> bytes:
        out = struct.pack(">I", len(payload)) + tag + payload
        return out + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)

    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    scanlines = b"".join(b"\x00" + raw[i].tobytes() for i in range(h))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", ihdr))
        f.write(chunk(b"IDAT", zlib.compress(scanlines, 6)))
        f.write(chunk(b"IEND", b""))
