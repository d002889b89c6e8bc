"""Device mesh and sharding helpers over torch.distributed.

One process per device. A mesh is a `torch.distributed.device_mesh.
DeviceMesh` over the ranks of the default process group, with named axes
("data", "model" by default); each axis has its own process group. Where
the JAX package places a global array with a `PartitionSpec`, the port
gives each rank its local block: `shard_params` cuts each parameter by the
tensor-parallel rules (`TP_RULES`), `shard_batch` cuts the leading axis
over "data". Collectives are explicit (all-reduce, all-gather, send and
receive) in the modules that need them.

The multi-rank paths run at world size 2 on gloo process groups in the
CPU tests and on NCCL on the card (one card holds one rank: NCCL refuses
two ranks on one device). gloo takes CUDA tensors in `all_reduce` and
`broadcast` only, so on a gloo group of ranks that share a card every
other collective here moves a CUDA tensor through the host and back,
counted in `host_copies`.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..train.optim import tree_map_with_path

Spec = Tuple[Optional[str], ...]

# Megatron-style pairs: column-parallel first product, row-parallel
# second. Patterns are matched against "/"-joined param paths.
TP_RULES: Sequence[Tuple[str, Spec]] = (
    # transformer MLP: fc column-parallel, proj row-parallel
    (r".*mlp/fc/w$", (None, "model")),
    (r".*mlp/fc/b$", ("model",)),
    (r".*mlp/proj/w$", ("model", None)),
    # attention QKV column-parallel (head dim), output row-parallel
    (r".*attn/[qkv]/w$", (None, "model")),
    (r".*attn/[qkv]/b$", ("model",)),
    (r".*attn/o/w$", ("model", None)),
    (r".*xattn/[qkv]/w$", (None, "model")),
    (r".*xattn/[qkv]/b$", ("model",)),
    (r".*xattn/o/w$", ("model", None)),
    # vocabulary head column-parallel
    (r".*head/w$", (None, "model")),
    (r".*head/b$", ("model",)),
)


def mesh_shape(n: int, shape: Optional[Tuple[int, ...]] = None
               ) -> Tuple[int, ...]:
    """The mesh shape for `n` ranks: `shape` where given, else
    (n // model, model) with model = 2 where n is even and at least 4."""
    if shape is not None:
        return tuple(shape)
    model = 2 if n % 2 == 0 and n >= 4 else 1
    return (n // model, model)


def make_mesh(shape: Optional[Tuple[int, ...]] = None,
              axes: Tuple[str, ...] = ("data", "model"),
              device_type: Optional[str] = None):
    """A DeviceMesh over every rank of the default process group (see
    `initialize_distributed`), axes named `axes[:len(shape)]`;
    `device_type` defaults to "cuda" on an NCCL group, else "cpu"."""
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise ValueError("make_mesh needs a process group: call "
                         "initialize_distributed (or "
                         "torch.distributed.init_process_group) first")
    n = dist.get_world_size()
    shape = mesh_shape(n, shape)
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} does not hold {n} ranks")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=tuple(axes[:len(shape)]))


def axis_size(mesh, axis: str) -> int:
    """The size of `axis` (1 without a mesh or where it has no such
    axis)."""
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        return 1
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_rank(mesh, axis: str) -> int:
    """This rank's index along `axis` (0 without a mesh)."""
    if axis_size(mesh, axis) == 1:
        return 0
    return mesh.get_local_rank(axis)


def axis_group(mesh, axis: str):
    """The process group of `axis` (None where it has size 1)."""
    if axis_size(mesh, axis) == 1:
        return None
    return mesh.get_group(axis)


# ---------------------------------------------------------------------------
# collectives that gloo refuses on CUDA tensors
# ---------------------------------------------------------------------------

# collectives that moved a CUDA tensor through the host, by helper name
host_copies: Dict[str, int] = {}


def reset_host_copies() -> None:
    host_copies.clear()


def _host_side(x: torch.Tensor, group, what: str) -> torch.Tensor:
    """x as the group's backend takes it in a collective other than
    all_reduce and broadcast: a host copy of a CUDA tensor on a gloo
    group (counted), else x."""
    if x.is_cuda and dist.get_backend(group) == "gloo":
        host_copies[what] = host_copies.get(what, 0) + 1
        return x.cpu()
    return x


def _reduced(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """x reduced over the group's ranks by `op`, on every rank: in float32
    (float64 kept; gloo sums float32), then cast back to x's dtype."""
    y = x.to(torch.float64 if x.dtype == torch.float64 else torch.float32,
             copy=True)
    dist.all_reduce(y, op=op, group=group)
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# differentiable collectives for replicated values (Megatron's f and g)
# ---------------------------------------------------------------------------

class _SumReplicated(torch.autograd.Function):
    """Forward: the sum over the group's ranks, on every rank. Backward:
    the cotangent as it is: the result is replicated, so each rank's
    cotangent is the whole cotangent of its summand."""

    @staticmethod
    def forward(ctx, x, group):
        return _reduced(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Replicate(torch.autograd.Function):
    """Forward: identity on a value every rank holds. Backward: the sum of
    the ranks' cotangents, each rank's share of the gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _reduced(g, ctx.group), None


class _GatherBatch(torch.autograd.Function):
    """Forward: the group's blocks concatenated along dim 0 (each rank's
    loss may read every block). Backward: this rank's block of the
    cotangent summed over the group's ranks."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.rows = group, x.shape[0]
        return all_gather_cat(x, group)

    @staticmethod
    def backward(ctx, g):
        r = dist.get_rank(ctx.group)
        return _reduced(g, ctx.group)[r * ctx.rows:(r + 1) * ctx.rows], None


def sum_replicated(x: torch.Tensor, group) -> torch.Tensor:
    """All-reduce (sum) over `group` into a replicated result (x itself
    without a group)."""
    return x if group is None else _SumReplicated.apply(x, group)


def replicate(x: torch.Tensor, group) -> torch.Tensor:
    """Mark a value every rank holds as replicated: its gradient is
    summed over `group` (x itself without a group)."""
    return x if group is None else _Replicate.apply(x, group)


def gather_batch(x: torch.Tensor, group) -> torch.Tensor:
    """The group's blocks of a batch concatenated along dim 0 in rank
    order, differentiably: the gradient of this rank's block is its block
    of the cotangent summed over the group (x itself without a group).
    The data axis's gather of embeddings for a loss over the global
    batch."""
    return x if group is None else _GatherBatch.apply(x, group)


def max_replicated(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max over the group's ranks, on every rank (x itself
    without a group); a constant to autograd, as a softmax's max is."""
    if group is None:
        return x
    return _reduced(x.detach(), group, dist.ReduceOp.MAX)


def ring_shift(x: torch.Tensor, group, step: int = 1) -> torch.Tensor:
    """The block of the rank `step` places back around the group's ring:
    each rank sends x to rank + step and receives from rank - step (x
    itself on a ring of one). Bits are moved as they are."""
    n = 1 if group is None else dist.get_world_size(group)
    if n == 1:
        return x
    r = dist.get_rank(group)
    dst = dist.get_global_rank(group, (r + step) % n)
    src = dist.get_global_rank(group, (r - step) % n)
    raw = _host_side(x.contiguous(), group, "ring_shift")
    raw = raw.reshape(-1).view(torch.uint8)
    out = torch.empty_like(raw)
    for req in dist.batch_isend_irecv([
            dist.P2POp(dist.isend, raw, dst, group),
            dist.P2POp(dist.irecv, out, src, group)]):
        req.wait()
    return out.view(x.dtype).reshape(x.shape).to(x.device)


def all_gather_cat(x: torch.Tensor, group) -> torch.Tensor:
    """The group's equal-shaped blocks of x concatenated along dim 0, in
    rank order, bit for bit whatever the dtype (x itself without a
    group)."""
    if group is None:
        return x
    raw = _host_side(x.contiguous(), group, "all_gather")
    scalar = raw.dim() == 0
    raw = (raw.reshape(1) if scalar else raw).view(torch.uint8)
    out = [torch.empty_like(raw) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, raw, group=group)
    return torch.cat(out).view(x.dtype).reshape(-1, *x.shape[1:]).to(
        x.device)


# ---------------------------------------------------------------------------
# parameter partitioning: tensor-parallel rules by param-path pattern
# ---------------------------------------------------------------------------

def _path_str(path: Sequence[Any]) -> str:
    """A tree path (dict keys and list indices) "/"-joined."""
    return "/".join(str(p) for p in path)


def partition_spec_for(path: str, leaf, tp: bool) -> Spec:
    """The tensor-parallel spec of the leaf at `path`: a tuple of axis
    names or None per leading dim, () for replicated."""
    if tp:
        for pat, spec in TP_RULES:
            if re.match(pat, path):
                if len(spec) <= leaf.ndim:
                    return spec
    return ()


def _block(x: torch.Tensor, dim: int, n: int, i: int) -> torch.Tensor:
    step = x.shape[dim] // n
    return x.narrow(dim, i * step, step).contiguous()


def shard_params(params: Any, mesh, tp: bool = True) -> Any:
    """This rank's local parameters: each leaf a TP rule matches is cut
    along its "model" dim into `model`-axis blocks (where that dim
    divides), every other leaf is kept whole (replicated)."""
    model_size = axis_size(mesh, "model")
    model_rank = axis_rank(mesh, "model")

    def place(path, leaf):
        spec = partition_spec_for(_path_str(path), leaf,
                                  tp and model_size > 1)
        for i, axis in enumerate(spec):
            if axis == "model":
                if leaf.shape[i] % model_size != 0:
                    return leaf
                return _block(leaf, i, model_size, model_rank)
        return leaf

    return tree_map_with_path(place, params)


def shard_batch(batch: Any, mesh) -> Any:
    """This rank's block of the leading (batch) axis of every leaf, over
    "data"."""
    n, r = axis_size(mesh, "data"), axis_rank(mesh, "data")

    def place(path, leaf):
        if leaf.shape[0] % n != 0:
            raise ValueError(f"batch {leaf.shape[0]} not divisible by the "
                             f"data axis {n}")
        return _block(leaf, 0, n, r)

    return tree_map_with_path(place, batch)


def process_allgather(x) -> np.ndarray:
    """`x` from every process, stacked along a new leading axis (x itself
    in a single process)."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return np.asarray(x)
    t = torch.as_tensor(np.asarray(x))
    if dist.get_backend() == "nccl":
        t = t.cuda()
    out = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(out, t)
    return torch.stack(out).cpu().numpy()


def initialize_distributed(init_method: Optional[str] = None,
                           world_size: Optional[int] = None,
                           rank: Optional[int] = None) -> None:
    """Join the process group of `world_size` ranks: NCCL where there is
    a card (each rank on the card `LOCAL_RANK` names, else rank modulo the
    cards), gloo on the CPU. A no-op for a single process."""
    if not world_size or world_size <= 1 or dist.is_initialized():
        return
    if torch.cuda.is_available():
        local = int(os.environ.get("LOCAL_RANK",
                                   rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)
