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
