"""The port's losses against ``zeroshape_tpu.losses``: values and gradients
(``jax.grad`` against autograd) at 1e-5, the masked median bit for bit.

Inputs are made with numpy from a seed; a gradient is taken of the sum of
the output times fixed random weights, so every output element counts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zeroshape_tpu import losses as jl
from zeroshape_tpu_torch import losses as tl

TOL = 1e-5


def _weights(shape, seed=99):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _check(jfn, tfn, args, grad_argnums=(0,), tol=TOL):
    """Value and gradient (with respect to ``grad_argnums``) of ``jfn`` and ``tfn`` on numpy ``args``."""
    jargs = [jnp.asarray(a) for a in args]
    want = np.asarray(jax.jit(jfn)(*jargs))
    w = _weights(want.shape)
    targs = [torch.tensor(a) for a in args]
    for i in grad_argnums:
        targs[i].requires_grad_(True)
    got = tfn(*targs)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=tol, atol=tol)
    (got * torch.tensor(w)).sum().backward()
    jgrads = jax.jit(jax.grad(lambda *a: jnp.sum(jfn(*a) * w), argnums=grad_argnums))(*jargs)
    for i, jg in zip(grad_argnums, jgrads):
        np.testing.assert_allclose(targs[i].grad.numpy(), np.asarray(jg), rtol=tol, atol=tol, err_msg=f"grad {i}")


def _depth_maps(seed, B=3, H=16, W=16, empty_row=False):
    rng = np.random.default_rng(seed)
    pred = rng.uniform(0.2, 1.5, (B, 1, H, W)).astype(np.float32)
    gt = rng.uniform(0.3, 1.2, (B, 1, H, W)).astype(np.float32)
    mask = (rng.uniform(size=(B, 1, H, W)) > 0.35).astype(np.float32)
    if empty_row:
        mask[-1] = 0.0
    return pred, gt, mask


@pytest.mark.parametrize("thres,weight", [(0.01, 1.0), (0.05, 3.0)])
def test_shape_loss(thres, weight):
    rng = np.random.default_rng(0)
    logits = rng.normal(0, 3, (2, 300)).astype(np.float32)
    sdf = rng.normal(0, 0.05, (2, 300)).astype(np.float32)
    _check(lambda x, s: jl.shape_loss(x, s, thres, weight), lambda x, s: tl.shape_loss(x, s, thres, weight),
           (logits, sdf))


def test_intr_loss():
    rng = np.random.default_rng(1)
    pred, gt = (rng.normal(size=(2, 64, 3)).astype(np.float32) for _ in range(2))
    mask = (rng.uniform(size=(2, 64)) > 0.4).astype(np.float32)
    _check(jl.intr_loss, tl.intr_loss, (pred, gt, mask))


def _median_rows():
    """Rows with ties, odd and even counts, an empty row, signed zeros."""
    rng = np.random.default_rng(2)
    x = rng.integers(-3, 4, (6, 40)).astype(np.float32) * 0.25  # many ties
    x[1] = rng.normal(size=40).astype(np.float32)
    x[2, :6] = [-0.0, 0.0, -0.0, 0.0, 1.0, -1.0]
    mask = rng.uniform(size=(6, 40)) > 0.3
    mask[2] = False
    mask[2, :6] = True  # even count over signed zeros
    mask[3] = False  # empty row
    mask[4, :] = False
    mask[4, :4] = True  # even count
    mask[5, :] = False
    mask[5, 7] = True  # one element
    return x, mask


def test_masked_median_is_bit_equal():
    x, mask = _median_rows()
    want = np.asarray(jl._masked_median(jnp.asarray(x), jnp.asarray(mask)))
    got = tl._masked_median(torch.tensor(x), torch.tensor(mask)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    # against the sort formulation of the JAX package as well
    ref = np.asarray(jl._masked_median_sort(jnp.asarray(x), jnp.asarray(mask)))
    np.testing.assert_array_equal(got, ref)


def test_masked_median_tie_gradient_is_equal():
    """The gradient goes to the mean of the masked elements tied at the median."""
    x, mask = _median_rows()
    w = _weights((x.shape[0],))
    jg = np.asarray(jax.grad(lambda v: jnp.sum(jl._masked_median(v, jnp.asarray(mask)) * w))(jnp.asarray(x)))
    t = torch.tensor(x, requires_grad=True)
    (tl._masked_median(t, torch.tensor(mask)) * torch.tensor(w)).sum().backward()
    np.testing.assert_array_equal(t.grad.numpy(), jg)
    assert (np.count_nonzero(jg, axis=1) > 1).any()  # some median is shared by ties


@pytest.mark.parametrize("empty_row", [False, True])
def test_masked_shift_and_scale(empty_row):
    pred, gt, mask = _depth_maps(3, empty_row=empty_row)
    _check(lambda p, g, m: jl.masked_shift_and_scale(p, g, m)[0], lambda p, g, m: tl.masked_shift_and_scale(p, g, m)[0],
           (pred, gt, mask))
    _check(lambda p, g, m: jl.masked_shift_and_scale(p, g, m)[1], lambda p, g, m: tl.masked_shift_and_scale(p, g, m)[1],
           (pred, gt, mask), grad_argnums=(1,))


def test_masked_l1_loss():
    pred, gt, mask = _depth_maps(4)
    _check(jl.masked_l1_loss, tl.masked_l1_loss, (pred, gt, mask), grad_argnums=(0, 1))


@pytest.mark.parametrize("output", [0, 1])
def test_compute_scale_and_shift(output):
    pred, gt, mask = _depth_maps(5, empty_row=True)
    args = (pred[:, 0], gt[:, 0], mask[:, 0])
    _check(lambda *a: jl.compute_scale_and_shift(*a)[output], lambda *a: tl.compute_scale_and_shift(*a)[output],
           args, grad_argnums=(0, 1))


@pytest.mark.parametrize("reduction", ["image-based", "batch-based"])
def test_gradient_matching_term(reduction):
    pred, gt, mask = _depth_maps(6, empty_row=True)
    _check(lambda p, g, m: jl.gradient_matching_term(p, g, m, reduction=reduction),
           lambda p, g, m: tl.gradient_matching_term(p, g, m, reduction=reduction),
           (pred[:, 0], gt[:, 0], mask[:, 0]), grad_argnums=(0, 1))


@pytest.mark.parametrize("size", [16, 18])
def test_erode_mask(size):
    mask = (np.random.default_rng(7).uniform(size=(2, 1, size, size)) > 0.1).astype(np.float32)
    want = np.asarray(jl.erode_mask(jnp.asarray(mask)))
    got = tl.erode_mask(torch.tensor(mask)).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < mask.sum()


@pytest.mark.parametrize(
    "alpha,inverse,shrink,empty_row",
    [(0.1, True, False, False), (0.1, False, True, False), (0.0, True, False, False), (0.1, True, False, True)],
)
def test_midas_loss(alpha, inverse, shrink, empty_row):
    pred, gt, mask = _depth_maps(8, empty_row=empty_row)
    kw = dict(alpha=alpha, inverse_depth=inverse, shrink_mask=shrink)
    _check(lambda p, g, m: jl.midas_loss(p, g, m, **kw), lambda p, g, m: tl.midas_loss(p, g, m, **kw),
           (pred, gt, mask))


def test_depth_loss():
    pred, gt, mask = _depth_maps(9)
    _check(jl.depth_loss, tl.depth_loss, (pred, gt, mask))


def test_summarize_loss():
    rng = np.random.default_rng(10)
    terms = {k: rng.normal(size=(3,)).astype(np.float32) for k in ("shape", "depth", "intr")}
    weights = {"shape": 1, "depth": None, "intr": 10}
    want = float(jl.summarize_loss({k: jnp.asarray(v) for k, v in terms.items()}, weights))
    got = float(tl.summarize_loss({k: torch.tensor(v) for k, v in terms.items()}, weights))
    assert abs(got - want) <= TOL * max(1.0, abs(want))
