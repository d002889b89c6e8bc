"""Linear assignment (the Hungarian algorithm) on the host, in float32.

A copy of optax 0.2.6's `optax.assignment.hungarian_algorithm` (the
Scenic variant: a shortest augmenting path per row with row and column
potentials), step for step and in its types, so that it returns the
indices that function returns on the same matrix, near-ties included:

  - a matrix with more rows than columns is solved transposed;
  - the row potentials have a dummy slot (`rows + 1`) that the potential
    update of unused columns adds to;
  - the next column is the first unused one of least reduced cost;
  - the result is read as `lax.top_k(parent[1:], rows)` reads it: the
    assigned columns in descending order of their row.

A different solver (scipy's `linear_sum_assignment`, or float64
potentials) can return another optimum, or another assignment on
near-ties: the query detector's set loss fills the columns of padded
ground truth with 1e4, where a float32 ulp is about 1e-3.

`hungarian_batch` solves a stack of equally shaped problems in lockstep
(the query detector's supervision layers and images of one training
step): each problem's loops run until it is done, the finished ones left
as they are.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def hungarian_algorithm(cost: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """cost [n, m] -> (row indices, column indices), min(n, m) pairs each,
    int32, in the order optax returns them."""
    rows, cols = hungarian_batch(np.asarray(cost)[None])
    return rows[0], cols[0]


def hungarian_batch(costs: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """costs [P, n, m] -> (row indices [P, k], column indices [P, k]),
    k = min(n, m): `hungarian_algorithm` of each problem."""
    costs = np.asarray(costs)
    npb, n, m = costs.shape
    if n == 0 or m == 0:
        empty = np.zeros((npb, 0), np.int32)
        return empty, empty
    transpose = n > m
    if transpose:
        costs = costs.transpose(0, 2, 1)
    # optax computes in float32 (JAX without x64): an integer matrix
    # promotes to float32 against the float32 potentials
    costs = np.ascontiguousarray(costs, dtype=np.float32)
    rows, cols = costs.shape[1:]
    pi = np.arange(npb)
    u = np.zeros((npb, rows + 2), np.float32)    # row potentials
    v = np.zeros((npb, cols + 1), np.float32)    # column potentials
    parent = np.zeros((npb, cols + 1), np.int64)  # column -> row + 1
    inf = np.float32(np.inf)
    for row in range(rows):
        parent[:, 0] = row + 1
        path = np.zeros((npb, cols), np.int64)
        used = np.zeros((npb, cols + 1), bool)
        minv = np.full((npb, cols), inf, np.float32)
        col = np.zeros(npb, np.int64)
        active = parent[pi, col] != 0
        # shortest augmenting path from `row` (optax's dfs loop)
        while active.any():
            a = pi[active]
            ca = col[a]
            used[a, ca] = True
            unused = ~used[a, 1:]
            prow = parent[a, ca]
            cur = costs[a, prow - 1, :] - u[a, prow][:, None] - v[a, 1:]
            cur = np.where(unused, cur, inf)
            less = cur < minv[a]
            path[a] = np.where(less, ca[:, None], path[a])
            mv = np.where(less, cur, minv[a])
            masked = np.where(unused, mv, inf)
            nxt = np.argmin(masked, axis=1) + 1
            delta = masked.min(axis=1)
            # u[parent[j]] += delta for every used column j (their rows are
            # distinct); the unused ones add to the dummy slot, never read
            ui, uj = np.nonzero(used[a])
            u[a[ui], parent[a[ui], uj]] += delta[ui]
            v[a] = np.where(used[a], v[a] - delta[:, None], v[a])
            minv[a] = np.where(unused, mv - delta[:, None], mv)
            col[a] = nxt
            active[a] = parent[a, nxt] != 0
        # back along the path (optax's backtracking loop)
        back = col != 0
        while back.any():
            b = pi[back]
            new = path[b, col[b] - 1]
            parent[b, col[b]] = parent[b, new]
            col[b] = new
            back[b] = new != 0
    assigned = parent[:, 1:]
    if rows == cols:
        par, idx = assigned, np.broadcast_to(np.arange(rows), (npb, rows))
    else:
        # lax.top_k(parent[1:], rows): descending, ties at the lower index
        idx = np.argsort(-assigned, axis=1, kind="stable")[:, :rows]
        par = np.take_along_axis(assigned, idx, axis=1)
    par = (par - 1).astype(np.int32)
    idx = np.ascontiguousarray(idx, dtype=np.int32)
    return (idx, par) if transpose else (par, idx)
