"""Grid planners: A* (the port's native C++ with a Python fallback) and
waypoint subsampling. The A* inner loop runs in the native library
(`native/ccl3d.cpp::astar_2d`, built by `mapping.components`) since it is
sequential host work.
"""

from __future__ import annotations

import ctypes
import heapq
import math
from typing import List, Optional, Tuple

import numpy as np

from ..mapping.components import _load_native


def astar(grid: np.ndarray, start: Tuple[int, int], goal: Tuple[int, int],
          max_len: int = 4096) -> List[Tuple[int, int]]:
    """8-connected A* on a [H, W] traversability grid (nonzero = free).
    Returns the path as [(row, col), ...] from start to goal, [] if
    unreachable. Start/goal are snapped to the nearest free cell."""
    grid = np.ascontiguousarray(grid.astype(np.uint8))
    h, w = grid.shape
    start = _snap_free(grid, start)
    goal = _snap_free(grid, goal)
    if start is None or goal is None:
        return []
    lib = _load_native()
    if lib is not None:
        out = np.zeros((max_len * 2,), np.int32)
        n = lib.astar_2d(
            grid.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.c_int32(h), ctypes.c_int32(w),
            ctypes.c_int32(start[0]), ctypes.c_int32(start[1]),
            ctypes.c_int32(goal[0]), ctypes.c_int32(goal[1]),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            ctypes.c_int32(max_len))
        return [(int(out[2 * i]), int(out[2 * i + 1])) for i in range(n)]
    return _astar_py(grid, start, goal)


def _snap_free(grid: np.ndarray, cell: Tuple[int, int], radius: int = 8
               ) -> Optional[Tuple[int, int]]:
    r0, c0 = int(cell[0]), int(cell[1])
    h, w = grid.shape
    r0 = min(max(r0, 0), h - 1)
    c0 = min(max(c0, 0), w - 1)
    if grid[r0, c0]:
        return (r0, c0)
    best = None
    best_d = 1e9
    for dr in range(-radius, radius + 1):
        for dc in range(-radius, radius + 1):
            r, c = r0 + dr, c0 + dc
            if 0 <= r < h and 0 <= c < w and grid[r, c]:
                d = dr * dr + dc * dc
                if d < best_d:
                    best, best_d = (r, c), d
    return best


def _astar_py(grid, start, goal):
    h, w = grid.shape
    dist = {start: 0.0}
    came = {}
    pq = [(0.0, start)]
    moves = [(-1, -1, 1.414), (-1, 0, 1.0), (-1, 1, 1.414), (0, -1, 1.0),
             (0, 1, 1.0), (1, -1, 1.414), (1, 0, 1.0), (1, 1, 1.414)]

    def heur(c):
        return math.hypot(c[0] - goal[0], c[1] - goal[1])

    while pq:
        f, cur = heapq.heappop(pq)
        if cur == goal:
            break
        if f > dist.get(cur, 1e18) + heur(cur) + 1e-6:
            continue
        for dr, dc, cost in moves:
            nr, nc = cur[0] + dr, cur[1] + dc
            if not (0 <= nr < h and 0 <= nc < w) or not grid[nr, nc]:
                continue
            nd = dist[cur] + cost
            if nd < dist.get((nr, nc), 1e18):
                dist[(nr, nc)] = nd
                came[(nr, nc)] = cur
                heapq.heappush(pq, (nd + heur((nr, nc)), (nr, nc)))
    if goal not in came and goal != start:
        return []
    path = [goal]
    while path[-1] != start:
        path.append(came[path[-1]])
    return path[::-1]


def subsample_path(path: List[Tuple[int, int]], every: int = 10
                   ) -> List[Tuple[int, int]]:
    """Turn a dense grid path into sparse subgoals (every `every`-th cell
    and the goal)."""
    if not path:
        return []
    pts = path[::every]
    if pts[-1] != path[-1]:
        pts.append(path[-1])
    return pts


def skeleton_waypoints(grid: np.ndarray, start: Tuple[int, int],
                       goal: Tuple[int, int], every: int = 10
                       ) -> List[Tuple[int, int]]:
    """A* then subsample into subgoals."""
    return subsample_path(astar(grid, start, goal), every)
