"""PyTorch port vs the JAX package: the Chamfer nearest-neighbour ops (K2, K3).

On the CPU the port's wrappers run their plain versions, which are what the
kernels are held to on the card (chip_smoke.py, test_torch_port_gpu.py). The
JAX side runs as the JAX package's own tests run it: ``chamfer_squared`` on
its XLA path, and K3's Pallas body in interpret mode.

Tolerances: K2's refined distances 1e-6 and equal indices on tie-free
random clouds; the gradient 1e-5; K3 1e-5 (bf16 operands, fp32 sums).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zeroshape_tpu.ops import chamfer as jch
from zeroshape_tpu_torch.ops import chamfer as tch

from test_torch_harness import close, t

SHAPES = [(2, 300, 257), (1, 1500, 1100)]  # the second crosses a 1024-row tile


def clouds(B, N, M, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1, 1, (B, N, 3)).astype(np.float32), rng.normal(0, 0.5, (B, M, 3)).astype(np.float32)


@pytest.mark.parametrize("B,N,M", SHAPES)
def test_nn_one_way_matches_jax(B, N, M):
    x1, x2 = clouds(B, N, M)
    d1, d2, i1, i2 = jch.chamfer_squared(jnp.asarray(x1), jnp.asarray(x2), False)
    got_d1, got_i1 = tch.nn_one_way(t(x1), t(x2))
    got_d2, got_i2 = tch.nn_one_way(t(x2), t(x1))
    close(got_d1, d1, 1e-6)
    close(got_d2, d2, 1e-6)
    np.testing.assert_array_equal(got_i1.numpy(), np.asarray(i1))
    np.testing.assert_array_equal(got_i2.numpy(), np.asarray(i2))
    assert got_i1.dtype == torch.int64 and tch.nn_one_way.launches == 0


def test_plain_k2_expanded_form_and_shared_cloud():
    """The plain K2 gives JAX's unrefined expanded-form minimum; a cloud
    shared by the batch (``expand``, batch stride 0) gives the same results
    as its copies."""
    x1, x2 = clouds(3, 200, 150, seed=1)
    d, i = tch._nn_one_way_plain(t(x1), t(x2))
    jd, ji = jch._nn_one_way_xla(jnp.asarray(x1), jnp.asarray(x2))
    close(d, jd, 1e-6)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    shared = t(x2[:1]).expand(3, -1, -1)
    assert shared.stride(0) == 0
    want = tch.nn_one_way(t(x1), t(np.repeat(x2[:1], 3, axis=0)))
    got = tch.nn_one_way(t(x1), shared)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(tch.nn_min_squared_fast(shared, t(x1)),
                       tch.nn_min_squared_fast(t(np.repeat(x2[:1], 3, axis=0)), t(x1)))


def test_chamfer_gradient_matches_jax():
    x1, x2 = clouds(2, 120, 90, seed=2)
    w1, w2 = (np.random.default_rng(3).normal(size=s).astype(np.float32) for s in ((2, 120), (2, 90)))

    def jloss(a, b):
        d1, d2, _, _ = jch.chamfer_squared(a, b, False)
        return jnp.sum(d1 * w1) + jnp.sum(d2 * w2)

    jg1, jg2 = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x1), jnp.asarray(x2))
    a, b = t(x1).requires_grad_(), t(x2).requires_grad_()
    d1, d2, _, _ = tch.chamfer_squared(a, b)
    ((d1 * t(w1)).sum() + (d2 * t(w2)).sum()).backward()
    close(a.grad, jg1, 1e-5)
    close(b.grad, jg2, 1e-5)
    # one direction alone: the unused output's gradient is None
    a2 = t(x1).requires_grad_()
    tch.chamfer_squared(a2, t(x2))[0].sum().backward()
    jg = jax.grad(lambda p: jnp.sum(jch.chamfer_squared(p, jnp.asarray(x2), False)[0]))(jnp.asarray(x1))
    close(a2.grad, jg, 1e-5)


def test_chamfer_distance_is_the_sqrt():
    x1, x2 = clouds(1, 64, 80, seed=4)
    got = tch.chamfer_distance(t(x1), t(x2))
    want = jch.chamfer_distance(jnp.asarray(x1), jnp.asarray(x2), False)
    for g, w in zip(got[:2], want[:2]):
        close(g, w, 1e-6)


@pytest.mark.parametrize("B,N,M", [(2, 200, 300), (1, 1100, 77)])
def test_nn_min_fast_matches_jax(B, N, M):
    x1, x2 = clouds(B, N, M, seed=5)
    got = tch.nn_min_squared_fast(t(x1), t(x2))
    close(got, jch._nn_min_xla(jnp.asarray(x1), jnp.asarray(x2)), 1e-5)
    if N <= 256:  # the Pallas body in interpret mode (tests/test_ops.py:259-270)
        close(got, jch.nn_min_squared_fast(jnp.asarray(x1), jnp.asarray(x2), interpret=True), 1e-5)
    # ranking-grade: within bf16 input rounding of the exact distance
    exact = tch.nn_one_way(t(x1), t(x2))[0]
    assert float((got - exact).abs().max()) < 2e-2
    assert tch.nn_min_squared_fast.launches == 0


@pytest.mark.parametrize(
    "x1,x2",
    [
        (torch.zeros(2, 5, 3, dtype=torch.float64), torch.zeros(2, 4, 3, dtype=torch.float64)),
        (torch.zeros(2, 5, 2), torch.zeros(2, 4, 2)),
        (torch.zeros(2, 5, 3), torch.zeros(3, 4, 3)),
        (torch.zeros(2, 5, 3), torch.zeros(2, 0, 3)),
        (torch.zeros(5, 3), torch.zeros(4, 3)),
    ],
)
def test_wrappers_reject_bad_operands(x1, x2):
    for fn in (tch.nn_one_way, tch.nn_min_squared_fast):
        with pytest.raises(ValueError):
            fn(x1, x2)


def _tf32(x):
    """fp32 -> TF32 (10 mantissa bits), to nearest with ties away from zero,
    as ``cvt.rna.tf32.f32``: add half of the 13 dropped bits, then mask them."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _fma(x, y, z):
    """fp32 fused multiply-add: the float64 product is exact, one rounding to fp32."""
    return (x.astype(np.float64) * y + z).astype(np.float32)


def _tensor_core_k2_argmin(a, b, chunk=128):
    """K2's choice on the card (``csrc/chamfer.cu``), emulated for one cloud
    pair ``a [N, 3]``, ``b [M, 3]``: the 3xTF32 tensor-core value
    ``|b|^2 - 2 a.b`` picks, for each of the four lanes that share a row
    (columns with ``(j % 8) // 2 == t``), the first 128-column chunk holding
    that lane's min; the lane rescans its columns of that chunk in the plain
    fp32 arithmetic, and the four candidates reduce by that value, the lower
    index winning a tie."""
    f64 = np.float64
    nb = (b[:, 0] * b[:, 0] + b[:, 1] * b[:, 1]) + b[:, 2] * b[:, 2]
    bv = np.concatenate([-2.0 * b, nb[:, None]], axis=1)  # [-2b, |b|^2], fp32
    bhi = _tf32(bv)
    blo = _tf32(bv - bhi)
    ahi = _tf32(a)
    alo = _tf32(a - ahi)
    ahi1 = np.concatenate([ahi, np.ones((len(a), 1), np.float32)], axis=1)
    # m16n8k8: [a_hi, 1, a_lo, 0].[b_hi, |b|^2_hi, b_hi, *]; then m16n8k4: [a_hi, 1].[b_lo, |b|^2_lo]
    step1 = (ahi1.astype(f64) @ bhi.T.astype(f64) + alo.astype(f64) @ bhi[:, :3].T.astype(f64)).astype(np.float32)
    tc = (step1.astype(f64) + ahi1.astype(f64) @ blo.T.astype(f64)).astype(np.float32)
    na = (a[:, 0] * a[:, 0] + a[:, 1] * a[:, 1]) + a[:, 2] * a[:, 2]
    cross = _fma(a[:, None, 2], bv[None, :, 2], _fma(a[:, None, 1], bv[None, :, 1], a[:, None, 0] * bv[None, :, 0]))
    plain = (na[:, None] + nb[None, :]) + cross
    j = np.arange(len(b))
    rows = np.arange(len(a))
    best_v = np.full(len(a), np.inf, np.float32)
    best_j = np.full(len(a), len(b))
    for t in range(4):
        cols = j[(j % 8) // 2 == t]
        if len(cols) == 0:
            continue
        c = cols[np.argmin(tc[:, cols], axis=1)] // chunk
        pv = np.where(cols[None, :] // chunk == c[:, None], plain[:, cols], np.inf)
        k = np.argmin(pv, axis=1)
        v, jj = pv[rows, k], cols[k]
        take = (v < best_v) | ((v == best_v) & (jj < best_j))
        best_v, best_j = np.where(take, v, best_v), np.where(take, jj, best_j)
    return best_j


@pytest.mark.parametrize("kind", ["torus", "capsule"])
def test_tensor_core_rounding_keeps_the_plain_argmin(kind):
    """The card's K2 rounding, emulated on the CPU, on two draws of one
    unit-normalised analytic surface (~2,000 points each, one turned): its
    argmins equal the plain version's on >= 99.9% of points, and where they
    differ the two candidates are equally near within 1e-5 (chip_smoke.py's
    gate)."""
    from zeroshape_tpu_torch.camera import get_rotation_sphere
    from zeroshape_tpu_torch.data import analytic
    from zeroshape_tpu_torch.metrics.eval3d import normalize_pc

    rng = np.random.default_rng(17)
    sdf, _ = analytic.make_sdf(kind, rng)
    R = get_rotation_sphere(4, 4, 4, device="cpu")[37]
    pred = normalize_pc(t(analytic.surface_points(sdf, 2000, rng))[None] @ R.T)[0].numpy()
    gt = normalize_pc(t(analytic.surface_points(sdf, 1900, rng))[None])[0].numpy()
    for a, b in ((pred, gt), (gt, pred)):
        got = _tensor_core_k2_argmin(a, b)
        _, ref = tch._nn_one_way_plain(t(a)[None], t(b)[None])
        ref = ref[0].numpy()
        same = got == ref
        assert same.mean() >= 0.999, same.mean()
        d = lambda idx: ((a - b[idx]) ** 2).sum(axis=1)  # noqa: E731
        np.testing.assert_allclose(d(got)[~same], d(ref)[~same], rtol=0, atol=1e-5)


def test_operand_layouts():
    """The kernels read a batch stride, 0 for a shared cloud; only a cloud
    whose rows are not contiguous ``[N, 3]`` is copied."""
    x = torch.zeros(4, 10, 3)
    assert tch._operand(x) == (x, 30)
    shared = x[:1].expand(4, -1, -1)
    got, stride = tch._operand(shared)
    assert got is shared and stride == 0
    strided = torch.zeros(8, 10, 3)[::2]
    assert tch._operand(strided) == (strided, 60)
    cols = torch.zeros(4, 3, 10).transpose(1, 2)
    got, stride = tch._operand(cols)
    assert got.is_contiguous() and stride == 30
