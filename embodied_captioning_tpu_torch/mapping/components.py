"""Host-side 3D connected components and the native host library.

`connected_components_26` labels a class grid with 26-connectivity (cc3d
semantics); the voxel map's offline re-segmentation uses it. It runs in the
port's native C++ library (`native/ccl3d.cpp`, which also holds the
planner's A*), compiled with g++ at first use into `native/build/` and
loaded with ctypes; where no library can be built, a scipy.ndimage version
gives the same labels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import warnings
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

NATIVE = Path(__file__).resolve().parent.parent / "native"
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-Wall", "-shared"]

_LIB: Optional[ctypes.CDLL] = None
_LIB_TRIED = False


def build_native() -> Path:
    """Compile `native/ccl3d.cpp` if this source is not built yet; return
    the shared library's path. The build directory is keyed by a hash of
    the source and flags; raises with the compiler's output on failure."""
    src = NATIVE / "ccl3d.cpp"
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + src.read_bytes())
    out = NATIVE / "build" / h.hexdigest()[:16] / "libecap_port_native.so"
    if out.exists():
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("no C++ compiler: set CXX or put g++ on PATH")
    out.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        lib_tmp = Path(tmp) / out.name
        proc = subprocess.run([cxx, *CXX_FLAGS, str(src), "-o", str(lib_tmp)],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"building {src} failed:\n{proc.stderr}")
        os.replace(lib_tmp, out)
    return out


def native_library() -> ctypes.CDLL:
    """The loaded native library (built at first use); raises if it cannot
    be built or loaded."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build_native()))
        lib.connected_components_26.restype = ctypes.c_int32
        lib.connected_components_26.argtypes = [
            ctypes.POINTER(ctypes.c_int32),  # labels in (class+1, 0=free)
            ctypes.POINTER(ctypes.c_int32),  # out component labels
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,  # X, Y, Z
        ]
        lib.astar_2d.restype = ctypes.c_int32
        _LIB = lib
    return _LIB


def _load_native() -> Optional[ctypes.CDLL]:
    """`native_library()`, or None (once warned) where it cannot be built:
    the callers then take their Python versions."""
    global _LIB_TRIED
    if _LIB is None and not _LIB_TRIED:
        _LIB_TRIED = True
        try:
            native_library()
        except (RuntimeError, OSError, subprocess.SubprocessError) as exc:
            warnings.warn(f"native library unavailable, using the Python "
                          f"versions: {exc}")
    return _LIB


def connected_components_26(grid: np.ndarray) -> Tuple[np.ndarray, int]:
    """26-connectivity connected components over a labeled 3D grid.

    Args:
      grid: [X, Y, Z] int array; 0 = background. Two adjacent voxels join
        one component iff they hold the same nonzero value (cc3d's
        multilabel semantics).

    Returns (components [X, Y, Z] int32 with labels 1..n, n).
    """
    grid = np.ascontiguousarray(grid.astype(np.int32))
    lib = _load_native()
    if lib is not None:
        out = np.zeros_like(grid)
        n = lib.connected_components_26(
            grid.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            grid.shape[0], grid.shape[1], grid.shape[2])
        return out, int(n)
    return _scipy_cc(grid)


def _scipy_cc(grid: np.ndarray) -> Tuple[np.ndarray, int]:
    from scipy import ndimage

    structure = np.ones((3, 3, 3), bool)  # 26-connectivity
    out = np.zeros(grid.shape, np.int32)
    next_label = 0
    for value in np.unique(grid):
        if value == 0:
            continue
        comp, n = ndimage.label(grid == value, structure=structure)
        out[comp > 0] = comp[comp > 0] + next_label
        next_label += n
    return out, next_label


def resegment_objects(class_grid: np.ndarray, vox_obj: np.ndarray,
                      ) -> Tuple[np.ndarray, np.ndarray, int]:
    """Offline re-segmentation: run CC on the per-voxel (class+1) grid and
    return (cc_labels [X,Y,Z], old-object -> cc-label mapping,
    n_components).

    `vox_obj` is the map's per-voxel owning slot (-1 = free); the mapping
    lets callers union per-object embedding/logit sets across merged
    components. An old object maps to the component holding most of its
    voxels.
    """
    comps, n = connected_components_26(class_grid)
    max_obj = int(vox_obj.max()) + 1 if vox_obj.size else 0
    obj_to_comp = np.full((max(max_obj, 1),), -1, np.int64)
    occ = comps > 0
    if occ.any() and max_obj > 0:
        objs = vox_obj[occ]
        labels = comps[occ]
        keep = objs >= 0
        for o in np.unique(objs[keep]):
            sel = labels[objs == o]
            if sel.size:
                obj_to_comp[o] = np.bincount(sel).argmax()
    return comps, obj_to_comp, n
