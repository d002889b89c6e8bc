"""The port's gradient layer against the JAX package's, on the CPU.

- ROADMAP C.21: with the kernel branch forced (a fake kernel library that
  runs the plain versions on the memory behind the pointers it is
  handed), LayerNorm's output carries a `grad_fn` and gradients reach x,
  g and b; `flash_attention` refuses a gradient-recording input; `mha`
  under autograd launches no flash kernel, and under `no_grad` it does.
- `layernorm_bwd_plain` against the JAX package's `_ln_pallas_bwd` and
  against `jax.vjp` of `_layernorm_ref`, bf16 and f32.
- The batched `_MatmulF32` against autograd of the widened product.
- One ViT block's gradient of every leaf against `jax.grad` on the JAX
  package's default path (the path its `train_step` differentiates).
"""

import ctypes
import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from embodied_captioning_tpu.models import common as JC
from embodied_captioning_tpu_torch import kernels as K
from embodied_captioning_tpu_torch.kernels import _lib
from embodied_captioning_tpu_torch.models import common as TC
from embodied_captioning_tpu_torch.params import from_jax
from embodied_captioning_tpu_torch.train.optim import tree_leaves
from torch_parity import (
    gradient_errors, jax_train_path, leaf_names, np32, perturbed, t,
)

D, H = 64, 2


# ---------------------------------------------------------------------------
# C.21: the kernel branch, forced on the CPU
# ---------------------------------------------------------------------------


def _view(ptr: int, shape, dtype) -> torch.Tensor:
    """A CPU tensor over the memory at address `ptr`."""
    n = math.prod(shape)
    size = n * torch.empty((), dtype=dtype).element_size()
    buf = (ctypes.c_byte * size).from_address(ptr)
    return torch.frombuffer(buf, dtype=dtype, count=n).view(*shape)


def _fake_call(name, *a):
    """Stands in for `_lib.call`: runs the plain version of the kernel
    `name` on the tensors behind the pointers, writing the outputs in
    place, as the kernel would."""
    if name == "ecap_layernorm":
        x, g, b, out, rows, d, eps, two_pass, in_bf16, out_bf16 = a
        xd = torch.bfloat16 if in_bf16 else torch.float32
        od = torch.bfloat16 if out_bf16 else torch.float32
        _view(out, (rows, d), od).copy_(K.layernorm_plain(
            _view(x, (rows, d), xd), _view(g, (d,), torch.float32),
            _view(b, (d,), torch.float32), eps, od, bool(two_pass)))
    elif name == "ecap_layernorm_bwd_slots":
        _, slots, widest = a
        ctypes.c_int.from_address(slots).value = 33
        ctypes.c_int.from_address(widest).value = 16
    elif name == "ecap_layernorm_bwd":
        (x, g, dy, dx, dg, db, _, rows, d, eps, two_pass, x_bf16, dy_bf16,
         *_) = a
        xd = torch.bfloat16 if x_bf16 else torch.float32
        dyd = torch.bfloat16 if dy_bf16 else torch.float32
        got = K.layernorm_bwd_plain(
            _view(x, (rows, d), xd), _view(g, (d,), torch.float32),
            _view(dy, (rows, d), dyd), eps, bool(two_pass))
        for ptr, shape, dt, v in ((dx, (rows, d), xd, got[0]),
                                  (dg, (d,), torch.float32, got[1]),
                                  (db, (d,), torch.float32, got[2])):
            _view(ptr, shape, dt).copy_(v)
    elif name == "ecap_flash_attention":
        q, k, v, o, bh, tt, d, causal, vl, _, _ = a  # scale, kernel
        qkv = [_view(p, (bh, 1, tt, d), torch.bfloat16) for p in (q, k, v)]
        _view(o, (bh, 1, tt, d), torch.bfloat16).copy_(
            K.flash_attention_plain(*qkv, bool(causal), vl))
    else:
        raise AssertionError(f"unexpected kernel {name}")


@pytest.fixture
def kernel_branch(monkeypatch):
    """Every wrapper takes its kernel branch, on CPU tensors, through
    `_fake_call`; launches counted from 0."""
    monkeypatch.setattr(_lib, "dispatch_device", lambda x: "cuda")
    monkeypatch.setattr(_lib, "check", lambda *a, **k: None)
    monkeypatch.setattr(_lib, "check_param", lambda *a, **k: None)
    monkeypatch.setattr(_lib, "call", _fake_call)
    monkeypatch.setattr(_lib, "current_stream", lambda: 0)
    _lib.reset_launches()
    yield _lib.launches
    _lib.reset_launches()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_layernorm_kernel_branch_passes_gradients(kernel_branch, dtype):
    rng = np.random.default_rng(0)
    x0 = torch.from_numpy(rng.standard_normal((3, 5, D)).astype(
        np.float32) * 2 + 0.5).to(dtype)
    g0 = torch.from_numpy(1 + 0.1 * rng.standard_normal(D).astype(np.float32))
    b0 = torch.from_numpy(0.1 * rng.standard_normal(D).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((3, 5, D)).astype(np.float32))
    x, g, b = (v.clone().requires_grad_(True) for v in (x0, g0, b0))
    y = K.layernorm(x, g, b)
    assert y.grad_fn is not None
    (y.float() * w).sum().backward()
    assert kernel_branch["layernorm"] == 1
    assert kernel_branch["layernorm_bwd"] == 1
    # the same through the plain version's autograd: dx within one
    # ulp of its dtype at |dx| < 4 (the Function's formula rounds once,
    # autograd's chain at each step), dg and db in float32 to 1e-5
    xr, gr, br = (v.clone().requires_grad_(True) for v in (x0, g0, b0))
    (K.layernorm_plain(xr, gr, br).float() * w).sum().backward()
    tol = 2 ** -6 if dtype == torch.bfloat16 else 1e-5
    for got, want in ((x.grad, xr.grad), (g.grad, gr.grad),
                      (b.grad, br.grad)):
        assert got is not None and float(got.abs().sum()) > 0
        np.testing.assert_allclose(np32(got), np32(want),
                                   atol=tol if got is x.grad else 1e-5,
                                   rtol=1e-5)


@pytest.mark.parametrize("shape,dtype,dy_dtype", [
    ((3, 5, D), torch.bfloat16, torch.bfloat16),
    ((40, 256), torch.float32, torch.float32),
    ((6, 100), torch.bfloat16, torch.float32)])
def test_layernorm_bwd_kernel_branch_launches_its_plan(
        kernel_branch, monkeypatch, shape, dtype, dy_dtype):
    # the wrapper hands the kernel `bwd_plan`'s geometry for these rows on
    # a card of 33 cluster slots and few-row clusters of up to 16 blocks
    # (the fake library's answers), with a scratch at least as long as the
    # plan asks, kept for the next call
    KL = importlib.import_module(
        "embodied_captioning_tpu_torch.kernels.layernorm")
    seen = []

    def record(name, *a):
        if name == "ecap_layernorm_bwd":
            *_, vectors, blocks, cluster, warps = a
            seen.append(((vectors, blocks, cluster, warps), a[6]))
        _fake_call(name, *a)

    monkeypatch.setattr(_lib, "call", record)
    monkeypatch.setattr(KL, "_room", {})
    monkeypatch.setattr(KL, "_scratch", {})
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                         ).to(dtype)
    dy = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                          ).to(dy_dtype)
    g = torch.from_numpy(1 + 0.1 * rng.standard_normal(shape[-1]).astype(
        np.float32))
    got = K.layernorm_bwd(x, g, dy)
    want = K.layernorm_bwd_plain(x, g, dy)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    d = shape[-1]
    plan = KL.bwd_plan(x.numel() // d, d, x.element_size(),
                       dy.element_size(), 33, 16)
    geometry, scratch = seen[0]
    assert geometry == (plan.vectors, plan.blocks, plan.cluster,
                        plan.warps)
    buf = KL._scratch[x.device.index, 0]
    assert scratch == buf.data_ptr() and buf.numel() >= plan.scratch_floats
    K.layernorm_bwd(x, g, dy)
    assert seen[1][1] == scratch
    assert kernel_branch["layernorm_bwd"] == 2


def test_layernorm_bwd_scratch_is_one_per_stream(kernel_branch,
                                                 monkeypatch):
    # two streams each get their own partials, so that backwards in flight
    # on both at once do not write one buffer; a stream gets its own back
    KL = importlib.import_module(
        "embodied_captioning_tpu_torch.kernels.layernorm")
    seen = []

    def record(name, *a):
        if name == "ecap_layernorm_bwd":
            seen.append(a[6])
        _fake_call(name, *a)

    stream = [1]
    monkeypatch.setattr(_lib, "call", record)
    monkeypatch.setattr(_lib, "current_stream", lambda: stream[0])
    monkeypatch.setattr(KL, "_room", {})
    monkeypatch.setattr(KL, "_scratch", {})
    rng = np.random.default_rng(3)
    # past one cluster on a card of 33 slots: two launches, with partials
    x = torch.from_numpy(rng.standard_normal((600, 64)).astype(np.float32))
    dy = torch.from_numpy(rng.standard_normal((600, 64)).astype(np.float32))
    g = torch.ones(64)
    assert KL.bwd_plan(600, 64, 4, 4, 33, 16).partials > 1
    for s in (1, 2, 1):
        stream[0] = s
        K.layernorm_bwd(x, g, dy)
    assert seen[0] != seen[1] and seen[2] == seen[0]
    assert set(KL._scratch) == {(None, 1), (None, 2)}


def test_flash_attention_refuses_gradient_recording_input(kernel_branch):
    q = torch.randn(1, 2, 8, 32, dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="no backward"):
        K.flash_attention(q.clone().requires_grad_(True), q, q)
    with torch.no_grad():
        K.flash_attention(q.clone().requires_grad_(True), q, q)
    assert kernel_branch["flash_attention"] == 1


def test_mha_under_grad_launches_no_flash(kernel_branch):
    rng = np.random.default_rng(1)
    p = from_jax(JC.mha_init(jax.random.PRNGKey(0), D, H), "cpu")
    x = torch.from_numpy(rng.standard_normal((2, 9, D)).astype(
        np.float32)).to(torch.bfloat16)
    with torch.no_grad():
        served, _ = TC.mha(p, x, H)
    assert kernel_branch["flash_attention"] == 1
    tracked = {k: {n: v.clone().requires_grad_(True) for n, v in d.items()}
               for k, d in p.items()}
    out, _ = TC.mha(tracked, x, H)
    assert kernel_branch["flash_attention"] == 1
    out.float().sum().backward()
    assert all(tracked[k]["w"].grad is not None for k in "qkvo")
    # the plain attention's forward: the same attention as the flash
    # twin's, bf16 probabilities normalised before (flash) or after
    # (plain) the PV product: within 2 bf16 ulps at |y| < 2
    np.testing.assert_allclose(np32(out), np32(served), atol=2 ** -6,
                               rtol=0)


# ---------------------------------------------------------------------------
# the LayerNorm backward's plain version against the JAX package
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=["bfloat16", "float32"])
def ln_case(request):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, 7, 96)) * 1.5 + 0.3
    x[0, 0] = 3.0 + 1e-3 * rng.standard_normal(96)  # a near-constant row
    return dict(
        dtype=request.param, x=jnp.asarray(x, request.param),
        g=jnp.asarray(1 + 0.1 * rng.standard_normal(96), jnp.float32),
        b=jnp.asarray(0.1 * rng.standard_normal(96), jnp.float32),
        dy=jnp.asarray(rng.standard_normal((4, 7, 96)), request.param))


def _port_bwd(c):
    return K.layernorm_bwd_plain(t(c["x"]), t(c["g"]), t(c["dy"]), 1e-5)


def _assert_dx_close(c, got, want):
    """bf16 dx: one bf16 ulp of the largest |dx| (f32 sums in another
    order round some elements the other way). f32 dx: 1e-5 of the row's
    largest |dx| plus 1e-5 relative, since dx = inv * (dxhat - mean(dxhat)
    - xhat * mean(dxhat * xhat)) cancels to small values in rows whose
    other entries are large (the near-constant row: |dx| up to ~600)."""
    got, want = np32(got), np32(want)
    if c["dtype"] == "bfloat16":
        ulp = 2.0 ** (math.floor(math.log2(float(np.abs(want).max()))) - 7)
        np.testing.assert_allclose(got, want, atol=ulp, rtol=0)
        return
    scale = np.abs(want).max(axis=-1, keepdims=True)
    np.testing.assert_allclose(got / scale, want / scale, atol=1e-5,
                               rtol=1e-5)


def _assert_dg_db_close(got, want):
    """dg, db: sums over 28 rows in another order, 1e-4 relative; dg also
    within 1e-3 absolute: in f32 the near-constant row's xhat = (x - m) *
    inv carries the cancellation error of x - m (~2^-23 * 3 * inv ~ 1e-4
    of each element, at |dy| ~ 1 summed over the row's contributions)."""
    np.testing.assert_allclose(np32(got[0]), np32(want[0]), rtol=1e-4,
                               atol=1e-3)
    np.testing.assert_allclose(np32(got[1]), np32(want[1]), rtol=1e-4,
                               atol=1e-5)


def test_layernorm_bwd_matches_ln_pallas_bwd(ln_case):
    """`_ln_pallas_bwd` takes two-pass statistics for every dtype; the port
    takes the forward's mode (one-pass with the floor for bf16), which
    moves the variance by ~1e-7 of itself: dg, db to 1e-4 relative (sums
    of 28 rows in another order). In bf16 the near-constant row rounds to
    a constant, where the one-pass floor engages and the two modes'
    1/sqrt(var + eps) differ by design (C.2): its dx is held by the vjp
    test below, and left out here."""
    c = ln_case
    dx, dg, db = JC._ln_pallas_bwd(1e-5, (c["x"], c["g"], c["b"]), c["dy"])
    got = _port_bwd(c)
    assert got[0].dtype == t(c["x"]).dtype and got[1].dtype == torch.float32
    keep = np.ones((4, 7), bool)
    if c["dtype"] == "bfloat16":
        assert np.ptp(np32(c["x"])[0, 0]) == 0  # the floored row
        keep[0, 0] = False
    _assert_dx_close(c, np32(got[0])[keep], np32(dx)[keep])
    _assert_dg_db_close(got[1:], (dg, db))


def test_layernorm_bwd_matches_vjp_of_layernorm_ref(ln_case):
    """jax.vjp of the reference's default LayerNorm: the same gradient by
    autodiff through the forward's own statistics."""
    c = ln_case
    _, vjp = jax.vjp(lambda x, g, b: JC._layernorm_ref(x, g, b, 1e-5,
                                                       x.dtype),
                     c["x"], c["g"], c["b"])
    dx, dg, db = vjp(c["dy"])
    got = _port_bwd(c)
    _assert_dx_close(c, got[0], dx)
    _assert_dg_db_close(got[1:], (dg, db))


# ---------------------------------------------------------------------------
# the batched product's backward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("a_shape,b_shape", [
    ((2, 3, 5, 16), (2, 3, 16, 7)),   # attention: batch and heads
    ((2, 3, 5, 16), (1, 3, 16, 7)),   # b broadcast over the batch
    ((3, 5, 16), (2, 3, 16, 7)),      # a broadcast over a new leading axis
    ((2, 3, 5, 16), (16, 7)),         # a 2-D b (the dense route)
])
def test_batched_matmul_f32_backward(a_shape, b_shape):
    """Gradients of `matmul_f32` on bf16 operands against autograd of the
    float32 product of the widened operands, rounded to bf16: the same
    sums, so within one bf16 ulp of the largest gradient."""
    rng = np.random.default_rng(3)
    a0 = torch.from_numpy(rng.standard_normal(a_shape).astype(
        np.float32)).to(torch.bfloat16)
    b0 = torch.from_numpy(rng.standard_normal(b_shape).astype(
        np.float32)).to(torch.bfloat16)
    a, b = a0.clone().requires_grad_(True), b0.clone().requires_grad_(True)
    y = TC.matmul_f32(a, b)
    assert y.dtype == torch.float32 and y.grad_fn is not None
    w = torch.from_numpy(rng.standard_normal(tuple(y.shape)).astype(
        np.float32))
    (y * w).sum().backward()
    af, bf = (v.float().requires_grad_(True) for v in (a0, b0))
    (torch.matmul(af, bf) * w).sum().backward()
    for got, want, like in ((a.grad, af.grad, a0), (b.grad, bf.grad, b0)):
        assert got.shape == like.shape and got.dtype == torch.bfloat16
        ulp = 2.0 ** (math.floor(math.log2(float(want.abs().max()))) - 7)
        np.testing.assert_allclose(np32(got), np32(want.to(torch.bfloat16)),
                                   atol=ulp, rtol=0)


def test_attention_max_is_a_constant_to_autograd():
    """`_attention_plain` detaches the max, as the reference's
    stop_gradient: the scores' gradient goes through exp and the product
    alone."""
    rng = np.random.default_rng(4)
    q = torch.from_numpy(rng.standard_normal((1, 3, 2, 8)).astype(
        np.float32)).to(torch.bfloat16).requires_grad_(True)
    kt = torch.from_numpy(rng.standard_normal((1, 2, 8, 5)).astype(
        np.float32)).to(torch.bfloat16)
    v = torch.from_numpy(rng.standard_normal((1, 2, 5, 8)).astype(
        np.float32)).to(torch.bfloat16)
    out = TC._attention_plain(q, kt, v, None)
    names = set()
    fn = [out.grad_fn]
    while fn:
        f = fn.pop()
        if f is None or f.name() in names:
            continue
        names.add(f.name())
        fn += [n for n, _ in f.next_functions]
    assert not any("Amax" in n or "Max" in n for n in names), names


# ---------------------------------------------------------------------------
# one ViT block, every leaf
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def vit_block_grads():
    """The JAX package's gradients of sum(block(x) * w) for every leaf of
    one pre-LN block and for x, at the parameters and at two points moved
    by 1e-4 of themselves (their spread sets the limits), and the port's
    on the same parameters and inputs."""
    rng = np.random.default_rng(5)
    p = JC.block_init(jax.random.PRNGKey(3), D, H, 4.0)
    x = jnp.asarray(rng.standard_normal((2, 17, D)), jnp.bfloat16)
    w = jnp.asarray(rng.standard_normal((2, 17, D)), jnp.float32)

    def loss(pp, xx):
        return jnp.sum(JC.block(pp, xx, H)[0].astype(jnp.float32) * w)

    with jax_train_path():
        grad = jax.jit(jax.grad(loss, argnums=(0, 1)))
        want = grad(p, x)
        moved = [grad(perturbed(p, s), x) for s in (1, 2)]
    tp = from_jax(p, "cpu")
    leaves = [v.requires_grad_(True) for v in tree_leaves(tp)]
    tx = t(x).requires_grad_(True)
    out, _ = TC.block(tp, tx, H)
    (out.float() * t(w)).sum().backward()
    names = leaf_names(tp) + ["x"]
    got = [v.grad for v in leaves] + [tx.grad]

    def flat(g):
        return [np32(v) for v in jax.tree_util.tree_leaves(g[0])] + [
            np32(g[1])]

    ref = flat(want)
    spreads = [max(float(np.linalg.norm(np.asarray(m, np.float64) - r))
                   for m in ms) for r, ms in zip(ref, zip(*map(flat, moved)))]
    return names, [np32(g) for g in got], ref, spreads


def test_vit_block_gradients_match_jax(vit_block_grads):
    """Every leaf within the larger of 2% of its norm and 3x the JAX
    package's own spread (C.20: its bf16 gradients move by ~1% of their
    norm when the parameters move by 1e-4 of themselves, and the key
    bias's, mathematically zero, by more than its own norm)."""
    names, got, want, spreads = vit_block_grads
    assert len(got) == len(want) == 17
    errs = gradient_errors(got, want, spreads, 2e-2, 3.0)
    bad = [(n, e, lim) for n, (e, lim) in zip(names, errs) if e > lim]
    assert not bad, bad
    # every gradient that is not noise is there
    for n, g, w in zip(names, got, want):
        if not n.endswith("attn.k.b"):
            assert np.linalg.norm(g) > 0.5 * np.linalg.norm(w), n
