"""Build and load the port's CUDA kernels; count their launches.

The sources under `csrc/` are compiled with nvcc for sm_90a at first use,
one nvcc process per source started together, then linked into one shared
library with a plain C interface, loaded with ctypes. The build directory
is keyed by a hash of the sources and flags, so an edited source rebuilds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import weakref
from pathlib import Path
from typing import Callable, Dict, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# launches of each kernel by its wrapper, for showing that a run went
# through the kernels (comparison launches are counted too; callers reset)
launches: Dict[str, int] = {
    "flash_attention": 0,
    "decode_self_attention": 0,
    "decode_cross_attention": 0,
    "decode_mlp": 0,
    "decode_self_block": 0,
    "decode_cross_block": 0,
    "raycast_minargmin": 0,
    "layernorm": 0,
    "layernorm_bwd": 0,
    "fused_preprocess": 0,
}

_lib: Optional[ctypes.CDLL] = None
# each C entry bound once, when the library loads
_entries: Dict[str, Callable[..., int]] = {}
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "ecap_flash_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
    "ecap_decode_self_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "ecap_decode_cross_attention": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                    _I, _P],
    "ecap_decode_mlp": [_P] * 12 + [_I, _I, _I, _F, _I, _I, _I, _P],
    "ecap_decode_self_block": [_P] * 20 + [_I] * 5 + [_F, _I, _I, _I, _P],
    "ecap_decode_cross_block": [_P] * 16 + [_I] * 4 + [_F] + [_I] * 4 + [_P],
    "ecap_raycast_minargmin": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "ecap_layernorm": [_P, _P, _P, _P, _I, _I, _F, _I, _I, _I, _P],
    "ecap_layernorm_bwd": [_P] * 7 + [_I, _I, _F] + [_I] * 7 + [_P],
    "ecap_layernorm_bwd_slots": [_I, _P, _P, _P],
    "ecap_fused_preprocess": [_P] * 8 + [_I] * 5 + [_F] * 6 + [_P],
}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    cand = home / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def build() -> Path:
    """Compile the kernels if this source set is not built yet; return the
    shared library's path. Prints nvcc's register/spill report."""
    sources = sorted(CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    out = BUILD / h.hexdigest()[:16] / "libecap_kernels.so"
    if out.exists():
        return out
    nvcc = _nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        objs = [Path(tmp) / (s.stem + ".o") for s in sources]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(s), "-o",
                                   str(o)], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for s, o in zip(sources, objs)]
        failed = []
        for s, p in zip(sources, procs):
            log, _ = p.communicate()
            print(f"[nvcc {s.name}]\n{log}", flush=True)
            if p.returncode != 0:
                failed.append(s.name)
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}")
        lib_tmp = Path(tmp) / out.name
        subprocess.run([nvcc, *NVCC_FLAGS[:4], "-shared", *map(str, objs),
                        "-o", str(lib_tmp)], check=True)
        os.replace(lib_tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built at first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, args in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
            _entries[name] = fn
        _lib = lib
    return _lib


def current_stream() -> int:
    """The current device's current stream, as a raw handle: without
    building a torch.cuda.Stream and without torch.cuda.current_device()'s
    initialisation check (the callers hold a CUDA tensor, so CUDA is
    initialised, and the kernels launch on the current device)."""
    return torch._C._cuda_getCurrentRawStream(torch._C._cuda_getDevice())


def call(name: str, *args) -> None:
    """Launch `name` on the current device's current stream; raise if CUDA
    refused it."""
    fn = _entries.get(name)
    if fn is None:
        library()
        fn = _entries[name]
    err = fn(*args, current_stream())
    if err != 0:
        raise RuntimeError(f"{name} failed: CUDA error {err}")


def check(t: torch.Tensor, name: str, dtypes, shape=None,
          align: int = 16) -> None:
    """Validate a tensor handed to a kernel."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtypes}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % align:
        raise ValueError(f"{name} must be {align}-byte aligned")


# tensors that passed `check_param`, by id: (a weak reference to the
# tensor, its storage address, the check's arguments)
_valid_params: Dict[int, tuple] = {}


def check_param(t: torch.Tensor, name: str, dtypes, shape=None,
                align: int = 16) -> None:
    """`check` for a tensor a wrapper is handed on every call, such as a
    model's parameter: the full check runs once per tensor; after that the
    same tensor with the same storage address passes at once."""
    key, spec = id(t), (dtypes, shape, align)
    seen = _valid_params.get(key)
    if (seen is not None and seen[0]() is t and seen[1] == t.data_ptr()
            and seen[2] == spec):
        return
    check(t, name, dtypes, shape, align)
    _valid_params[key] = (
        weakref.ref(t, lambda _, k=key: _valid_params.pop(k, None)),
        t.data_ptr(), spec)


def dispatch_device(t: torch.Tensor) -> str:
    """'cpu' -> the plain version; 'cuda' -> the kernel; anything else
    raises."""
    if t.is_cuda:
        return "cuda"
    if t.is_cpu:
        return "cpu"
    raise ValueError(f"no kernel or plain version for device {t.device}")
