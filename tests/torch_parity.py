"""Helpers shared by the tests that hold the PyTorch port to the JAX
package: numpy conversion and the JAX kernel-path switch."""

from __future__ import annotations

import contextlib

import jax
import numpy as np
import pytest
import torch


def np32(x) -> np.ndarray:
    """A JAX array, torch tensor or numpy array as numpy (bf16 widened to
    float32)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def t(x, dtype=None) -> torch.Tensor:
    """numpy / JAX array -> CPU torch tensor (bf16 kept as bf16)."""
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        out = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        out = torch.from_numpy(np.array(a))
    return out if dtype is None else out.to(dtype)


@contextlib.contextmanager
def jax_kernel_path():
    """Run the JAX package with ECAP_USE_PALLAS=1 (its Pallas kernels in
    interpret mode on the CPU). The flags are read at trace time, so the
    jit caches are cleared on entry and exit."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ECAP_USE_PALLAS", "1")
        mp.delenv("ECAP_PALLAS_BLOCKS", raising=False)
        mp.delenv("ECAP_CROSS_V_HEADMAJOR", raising=False)
        jax.clear_caches()
        try:
            yield
        finally:
            jax.clear_caches()
    jax.clear_caches()
