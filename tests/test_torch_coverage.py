"""The port has a counterpart of every public top-level name of the JAX
package: for each module of `embodied_captioning_tpu/` (but the Pallas
kernels), every public function and class it defines is a name of the
port's module at the same path (defined, assigned or imported there),
unless `REPLACED` lists it with the reason the port does without it."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
JAX_PKG = ROOT / "embodied_captioning_tpu"
PORT_PKG = ROOT / "embodied_captioning_tpu_torch"

# (module path, name): why the port has no such name there
REPLACED = {
    ("agents/ppo.py", "make_optimizer"):
        "an optax chain; the port's Adam is train/optim.adam_init/update",
    ("train/captioner_train.py", "make_optimizer"):
        "an optax chain; the port's AdamW is train/optim.adam_update",
    ("models/common.py", "cross_v_headmajor"):
        "an environment switch; the port keeps cross V head-major (C.5)",
    ("models/common.py", "embedding_init"):
        "the port's inits draw embeddings with common.randn",
    ("models/common.py", "mlp_init"):
        "the port's block_init draws the MLP's two dense layers",
    ("models/detector.py", "init_rcnn_detector"):
        "the port's init_detector draws the rcnn family itself",
    ("models/detector.py", "norm_fn"):
        "the port picks the norm in detector._norm",
    ("models/quantize.py", "w8a8_enabled"):
        "an environment switch; the port takes a `w8a8` argument",
    ("models/quantize.py", "int8_kv_enabled"):
        "an environment switch; the port takes an `int8_kv` argument",
    ("parallel/mesh.py", "data_sharding"):
        "a jax.sharding object; the port shards with parallel/mesh groups",
    ("parallel/mesh.py", "replicated"):
        "a jax.sharding object; the port shards with parallel/mesh groups",
    ("tools/port.py", "jax_to_numpy"):
        "the port writes numpy trees with params.dump_tree",
}


def _modules():
    return sorted(str(p.relative_to(JAX_PKG)) for p in JAX_PKG.rglob("*.py")
                  if p.relative_to(JAX_PKG).parts[:2] != ("ops", "pallas"))


def _public_defs(path: Path) -> set:
    """Public functions and classes defined at the top of a module."""
    return {n.name for n in ast.parse(path.read_text()).body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef)) and not n.name.startswith("_")}


def _bound_names(path: Path) -> set:
    """Every name bound at the top of a module: definitions, assignments
    and imports."""
    out = set()
    for n in ast.parse(path.read_text()).body:
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.ClassDef)):
            out.add(n.name)
        elif isinstance(n, ast.Assign):
            out.update(t.id for t in n.targets if isinstance(t, ast.Name))
        elif isinstance(n, ast.AnnAssign) and isinstance(n.target, ast.Name):
            out.add(n.target.id)
        elif isinstance(n, (ast.Import, ast.ImportFrom)):
            out.update((a.asname or a.name).split(".")[0] for a in n.names)
    return out


@pytest.mark.parametrize("module", _modules())
def test_every_public_name_has_a_counterpart(module):
    port = PORT_PKG / module
    assert port.exists(), f"no port module {module}"
    missing = _public_defs(JAX_PKG / module) - _bound_names(port)
    unexplained = sorted(n for n in missing if (module, n) not in REPLACED)
    assert not unexplained, f"{module}: {unexplained}"


def test_every_listed_replacement_is_still_missing():
    # an entry whose name the port now has, or whose JAX name is gone,
    # is stale
    for (module, name), why in REPLACED.items():
        assert why, (module, name)
        assert name in _public_defs(JAX_PKG / module), (module, name)
        assert name not in _bound_names(PORT_PKG / module), (module, name)
