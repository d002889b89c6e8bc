"""Minimal image output: a PNG writer on the standard library and numpy,
and the colouring of a top-down map.

Backs the `Viz-v1` trajectory renderer (`envs/registry.VizTrajectoryEnv`),
which writes one top-down frame per replayed step. The counterpart of the
JAX package's `utils/image_io.py`: the same bytes for the same frame.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def write_png(path: str, rgb: np.ndarray) -> None:
    """Write [H, W, 3] uint8 (or [H, W] grayscale) as an 8-bit PNG."""
    rgb = np.asarray(rgb)
    if rgb.ndim == 2:
        rgb = np.stack([rgb] * 3, axis=-1)
    rgb = np.ascontiguousarray(rgb.astype(np.uint8))
    h, w, c = rgb.shape
    assert c == 3, f"expected RGB, got {rgb.shape}"
    raw = b"".join(b"\x00" + rgb[i].tobytes() for i in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
                + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


# 7 distinct colors: free/unknown gray handled separately; classes 0..5
CLASS_COLORS = np.asarray([
    [230, 25, 75], [60, 180, 75], [255, 225, 25],
    [0, 130, 200], [245, 130, 48], [145, 30, 180],
], np.uint8)


def render_topdown(maps: np.ndarray, path_cells=None,
                   agent_cell=None) -> np.ndarray:
    """Colorize a 4-channel top-down map (obstacle, explored, semantic,
    disagreement — mapping/voxel_map.topdown_maps) into an RGB frame, with
    an optional trajectory polyline and agent marker (the reference's
    colorize_draw_agent_and_fit_to_height + _draw_shortest_path,
    ref: env_viz.py:152-160,292-330)."""
    obstacle, explored, sem = maps[..., 0], maps[..., 1], maps[..., 2]
    h, w = obstacle.shape
    img = np.full((h, w, 3), 40, np.uint8)             # unknown: dark
    img[explored > 0] = (200, 200, 200)                # explored free
    img[obstacle > 0] = (110, 110, 110)                # walls/furniture
    cls = (sem.astype(np.int32) - 1) % len(CLASS_COLORS)
    img[sem > 0] = CLASS_COLORS[cls[sem > 0]]
    if path_cells:
        for (r, c) in path_cells:
            if 0 <= r < h and 0 <= c < w:
                img[r, c] = (255, 0, 0)
    if agent_cell is not None:
        r, c = agent_cell
        if 0 <= r < h and 0 <= c < w:  # recorded pose may be off-map when
            # replaying against a differently-seeded sim's bounds
            img[max(r - 1, 0):min(r + 2, h),
                max(c - 1, 0):min(c + 2, w)] = (0, 255, 0)
    return img
