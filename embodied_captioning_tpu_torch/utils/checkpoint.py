"""Checkpoint / resume / preemption handling.

`CheckpointManager` keeps numbered snapshots of a tree of tensors and
arrays (params, optimizer state, counters) with optional JSON metadata,
with the contract of the JAX package's orbax-backed manager:

  - one directory per step (`<directory>/<step>/`): the tree's leaves in
    `state.npz` under their "/"-joined paths, and `metadata.json` when
    metadata is given. A step is written under a temporary name and
    renamed into place, so a reader never sees half a step;
  - a step at or below the latest saved step is not written again (orbax's
    `should_save`);
  - at most `max_to_keep` steps are kept, the oldest pruned first;
  - `restore(template)` rebuilds the template's structure and leaf types
    (tensors on the template leaf's device and dtype, numpy arrays, or
    Python scalars) from the saved leaves.

The format is the port's own: it reads no orbax directory (ROADMAP C).
`PreemptionGuard` turns SIGTERM / SIGUSR1 into a flag the train loop reads
at its update boundaries.
"""

from __future__ import annotations

import json
import os
import shutil
import signal
import tempfile
import threading
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..train.optim import tree_map_with_path

STATE_FILE = "state.npz"
METADATA_FILE = "metadata.json"


def _key(path: tuple) -> str:
    return "/" + "/".join(str(p) for p in path)


def _numpy(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _like(template: Any, arr: np.ndarray) -> Any:
    """A saved leaf in the type of the template's leaf."""
    if isinstance(template, torch.Tensor):
        return torch.from_numpy(np.array(arr)).to(device=template.device,
                                                  dtype=template.dtype)
    if isinstance(template, np.ndarray):
        return np.asarray(arr, dtype=template.dtype)
    if isinstance(template, (bool, int, float)):
        return type(template)(arr)
    return np.asarray(arr)


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def all_steps(self) -> List[int]:
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit()
                      and os.path.isdir(os.path.join(self.directory, n)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: Any,
             metadata: Optional[Dict] = None) -> bool:
        """Write `state` (and `metadata`) as step `step`; returns False,
        writing nothing, where a step at or after `step` is saved."""
        latest = self.latest_step()
        if latest is not None and latest >= step:
            return False
        tmp = tempfile.mkdtemp(prefix=f".{step}.tmp-", dir=self.directory)
        try:
            arrays = {}
            tree_map_with_path(
                lambda p, leaf: arrays.__setitem__(_key(p), _numpy(leaf)),
                state)
            np.savez(os.path.join(tmp, STATE_FILE), **arrays)
            if metadata:
                with open(os.path.join(tmp, METADATA_FILE), "w") as fh:
                    json.dump(metadata, fh)
            os.rename(tmp, os.path.join(self.directory, str(step)))
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        for old in self.all_steps()[:-self.max_to_keep or None]:
            shutil.rmtree(os.path.join(self.directory, str(old)))
        return True

    def restore(self, state_template: Any, step: Optional[int] = None,
                with_metadata: bool = False) -> Any:
        """The state saved at `step` (the latest by default) in the
        template's structure; `with_metadata=True` returns (state,
        metadata or None). (None, None) / None where nothing is saved."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return (None, None) if with_metadata else None
        where = os.path.join(self.directory, str(step))
        with np.load(os.path.join(where, STATE_FILE)) as arrays:
            state = tree_map_with_path(
                lambda p, leaf: _like(leaf, arrays[_key(p)]), state_template)
        if not with_metadata:
            return state
        meta = None
        if os.path.exists(os.path.join(where, METADATA_FILE)):
            with open(os.path.join(where, METADATA_FILE)) as fh:
                meta = json.load(fh)
        return state, meta

    def close(self) -> None:
        """Nothing is left pending: every save is written when it
        returns."""


class PreemptionGuard:
    """SIGTERM-aware training guard: on SIGTERM/SIGUSR1 sets
    `should_exit`; the train loop checks it and saves resume state before
    exiting. `on_exit` (run by `finalize` after a signal) is where a
    cluster requeue command goes. Installed only from the main thread."""

    def __init__(self, on_exit: Optional[Callable[[], None]] = None):
        self.should_exit = False
        self._on_exit = on_exit
        self._installed = False

    def install(self) -> None:
        if self._installed:
            return
        if threading.current_thread() is not threading.main_thread():
            return

        def handler(signum, frame):
            self.should_exit = True

        for sig in (signal.SIGTERM, signal.SIGUSR1):
            try:
                signal.signal(sig, handler)
            except (ValueError, OSError):
                pass
        self._installed = True

    def finalize(self) -> None:
        if self.should_exit and self._on_exit:
            self._on_exit()
