"""The port's Hungarian solver (`ops/assignment`) against optax's
`hungarian_algorithm` on the same matrices: equal row and column indices,
near-ties and padded columns included."""

import jax.numpy as jnp
import numpy as np
import pytest
from optax import assignment

from embodied_captioning_tpu_torch.ops.assignment import (
    hungarian_algorithm, hungarian_batch,
)


def _optax(cost: np.ndarray):
    rows, cols = assignment.hungarian_algorithm(jnp.asarray(cost))
    return np.asarray(rows), np.asarray(cols)


def _matrices(kind: str, shape, seed: int) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(6):
        if kind == "float":
            c = rng.standard_normal(shape).astype(np.float32)
        elif kind == "ties":
            # few distinct integer costs: many equal optima
            c = rng.integers(0, 3, shape).astype(np.int32)
        elif kind == "padded":
            # the set loss's matrices: costs in a few units, the columns of
            # padded ground truth at 1e4 (a float32 ulp there is ~1e-3)
            c = (rng.random(shape) * 12 - 2).astype(np.float32)
            c[:, rng.random(shape[1]) < 0.5] = 1e4
        else:  # near-ties: values a few ulps apart
            base = np.float32(rng.random())
            c = (base + rng.integers(0, 4, shape) * np.float32(6e-8)
                 ).astype(np.float32)
        out.append(c)
    return out


@pytest.mark.parametrize("shape", [(16, 8), (8, 16), (64, 16), (7, 7),
                                   (1, 5), (5, 1)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("kind", ["float", "ties", "padded", "near"])
def test_indices_equal_optax(kind, shape):
    for i, c in enumerate(_matrices(kind, shape, hash((kind, shape)) % 997)):
        rows, cols = hungarian_algorithm(c)
        want_r, want_c = _optax(c)
        np.testing.assert_array_equal(rows, want_r, err_msg=f"{i}")
        np.testing.assert_array_equal(cols, want_c, err_msg=f"{i}")
        assert rows.dtype == np.int32 and cols.dtype == np.int32


def test_as_many_queries_as_ground_truths_and_none():
    """G = Q (the square path: columns in order, no top_k) and G = 0."""
    rng = np.random.default_rng(3)
    for _ in range(4):
        c = rng.standard_normal((16, 16)).astype(np.float32)
        rows, cols = hungarian_algorithm(c)
        want_r, want_c = _optax(c)
        np.testing.assert_array_equal(rows, want_r)
        np.testing.assert_array_equal(cols, want_c)
        np.testing.assert_array_equal(cols, np.arange(16))
    rows, cols = hungarian_algorithm(np.zeros((16, 0), np.float32))
    want_r, want_c = _optax(np.zeros((16, 0), np.float32))
    assert rows.shape == cols.shape == want_r.shape == want_c.shape == (0,)


def test_lockstep_batch_equals_each_problem():
    """hungarian_batch over problems whose loops end at different
    iterations: each equal to its own solve, and to optax."""
    rng = np.random.default_rng(4)
    costs = (rng.random((12, 16, 8)) * 6).astype(np.float32)
    costs[::3, :, 5:] = 1e4
    costs[1::3] = np.round(costs[1::3])
    rows, cols = hungarian_batch(costs)
    assert rows.shape == cols.shape == (12, 8)
    for i, c in enumerate(costs):
        want_r, want_c = _optax(c)
        np.testing.assert_array_equal(rows[i], want_r, err_msg=f"{i}")
        np.testing.assert_array_equal(cols[i], want_c, err_msg=f"{i}")


def test_assignment_is_optimal():
    """The assignment's cost equals the brute-force optimum."""
    import itertools

    rng = np.random.default_rng(5)
    for _ in range(5):
        c = rng.random((6, 4)).astype(np.float32)
        rows, cols = hungarian_algorithm(c)
        best = min(sum(c[p[j], j] for j in range(4))
                   for p in itertools.permutations(range(6), 4))
        assert abs(c[rows, cols].sum() - best) <= 1e-5
