"""`detector_loss`'s softfocal and msefocal heads against the JAX package,
with and without masks: the loss, its parts and every leaf's gradient,
with the limits of test_torch_detector_train.py (whose tests these are,
on this file's heads; split so that the JAX gradient compiles run on two
workers)."""

import pytest

from test_torch_detector_train import (  # noqa: F401 (fixtures and tests)
    HEADS, HERE, _pair, base,
    test_every_leaf_gradient_matches_jax, test_loss_and_parts_match_jax,
)

THESE = tuple(h for h in HEADS if h not in HERE)


@pytest.fixture(scope="module", params=[(h, m) for h in THESE
                                        for m in (True, False)],
                ids=lambda p: f"{p[0]}-{'masks' if p[1] else 'nomasks'}")
def loss_pair(request, base):
    return _pair(base, *request.param)
