"""The port's `PartiallyAnnotatedEpisodeDataset` and profiling helpers.

The dataset is held to the JAX package's class (`tests/test_labeling.py`'s
fake episode and its partial-dataset check): the same frames annotated for
each fraction and seed, every label slot of the others invalid, the labels
of the annotated ones untouched. `trace` and `device_timer` are checked on
the CPU: a Chrome trace written, a positive time, and no silent fallback
where a card is asked for and there is none."""

import json
import os

import numpy as np
import pytest
import torch

from embodied_captioning_tpu.labeling.datasets import (
    PartiallyAnnotatedEpisodeDataset as JPartial,
)
from embodied_captioning_tpu_torch.labeling.datasets import (
    EpisodeDetectionDataset, PartiallyAnnotatedEpisodeDataset,
)
from embodied_captioning_tpu_torch.utils.profiling import device_timer, trace
from test_labeling import _write_fake_episode

STEPS = 8
KW = dict(label_modality="bbs", max_detections=4)


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    path = tmp_path_factory.mktemp("partial")
    _write_fake_episode(path, steps=STEPS)
    return str(path)


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("fraction", [0.0, 0.5, 1.0])
def test_partial_dataset_masks_the_frames_jax_masks(store, fraction, seed):
    ref = JPartial(store, annotated_fraction=fraction, seed=seed, **KW)
    part = PartiallyAnnotatedEpisodeDataset(
        store, annotated_fraction=fraction, seed=seed, **KW)
    full = EpisodeDetectionDataset(store, **KW)
    assert len(part) == len(ref) == len(full) == STEPS
    kept = [bool(ref[i].valid.any()) for i in range(STEPS)]
    if fraction == 0.0:
        assert not any(kept)
    elif fraction == 1.0:
        assert all(kept)
    for i in range(STEPS):
        got, want, base = part[i], ref[i], full[i]
        np.testing.assert_array_equal(got.valid, want.valid)
        np.testing.assert_array_equal(got.boxes, want.boxes)
        np.testing.assert_array_equal(got.classes, want.classes)
        np.testing.assert_array_equal(got.image, base.image)
        # an annotated frame keeps its labels, another has none
        np.testing.assert_array_equal(
            got.valid, base.valid if kept[i] else np.zeros_like(base.valid))


def test_partial_dataset_half_keeps_some_frames(store):
    # at 0.5 over 8 frames the seeded draw keeps some and drops some, so
    # the mask is not trivially all or none
    part = PartiallyAnnotatedEpisodeDataset(store, annotated_fraction=0.5,
                                            seed=0, **KW)
    kept = [bool(part[i].valid.any()) for i in range(STEPS)]
    assert 0 < sum(kept) < STEPS, kept


def test_trace_writes_a_chrome_trace(tmp_path):
    x = torch.randn(32, 32)
    with trace(str(tmp_path / "tr")):
        torch.matmul(x, x)
    files = os.listdir(tmp_path / "tr")
    assert len(files) == 1 and files[0].endswith(".json")
    with open(tmp_path / "tr" / files[0]) as fh:
        events = json.load(fh)["traceEvents"]
    assert any("matmul" in str(e.get("name", "")) for e in events)


def test_device_timer_times_cpu_inputs_and_needs_a_card_otherwise():
    x = torch.randn(64, 64)
    out, sec = device_timer(torch.matmul, x, x, iters=3)
    assert torch.equal(out, x @ x) and sec > 0
    out, sec = device_timer(lambda d: d["a"] + 1, {"a": x})
    assert torch.equal(out, x + 1) and sec > 0
    if not torch.cuda.is_available():
        # no tensor argument: it runs on the card, and there is none
        with pytest.raises((AssertionError, RuntimeError)):
            device_timer(lambda: 1)
