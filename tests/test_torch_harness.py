"""Shared helpers for the PyTorch-port parity tests (no tests here).

Both packages get the same inputs, made from a numpy seed, and the same
weights: the JAX module's variables are drawn at random with numpy and go
to the port through ``zeroshape_tpu_torch.weights``. Arrays cross between
the two as numpy.
"""

import ctypes
import gc

import jax
import numpy as np
import pytest
import torch

from zeroshape_tpu_torch import weights


@pytest.fixture(scope="module", autouse=True)
def give_memory_back():
    """At the end of a test module, hand what it freed back to the system.

    A module that imports this fixture gets it for all its tests. glibc keeps
    freed heap pages (torch's and XLA's host buffers) in its arenas, so an
    xdist worker would otherwise hold a module's peak (up to ~8 GB for the
    full train step) for the rest of the run, beside the other workers and
    the 20 GB subprocess of ``test_graft_entry.py``'s dry run.
    """
    yield
    gc.collect()
    jax.clear_caches()
    try:
        ctypes.CDLL("libc.so.6").malloc_trim(0)
    except (OSError, AttributeError):  # not glibc: nothing to trim
        pass


def random_variables(module, *init_args, seed=0, **init_kw):
    """Variables of a flax ``module`` with numpy-random values.

    Shapes come from ``jax.eval_shape`` (no initialiser runs). As in the
    repo's torch-oracle fixtures (tests/torch_oracle_shape.py), every
    parameter and running mean ~ N(0, 0.05) and running variances
    ~ U(0.6, 1.4).
    """
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(
        lambda: module.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
                            *init_args, **init_kw)
    )

    def fill(path, leaf):
        name = path[-1].key
        if name == "var":
            return rng.uniform(0.6, 1.4, leaf.shape).astype(np.float32)
        return rng.normal(0.0, 0.05, leaf.shape).astype(np.float32)

    out = jax.tree_util.tree_map_with_path(fill, shapes)
    return {k: dict(v) for k, v in out.items()}


def load_port(module, entries, variables):
    """Load the flax ``variables`` into the port ``module`` through ``entries``."""
    sd = weights.convert(entries, variables["params"], variables.get("batch_stats"))
    return weights.load(module, sd).eval()


def np32(x):
    return np.asarray(x, np.float32)


def t(x):
    """numpy -> fp32 CPU tensor."""
    return torch.from_numpy(np.ascontiguousarray(np32(x)))


def nchw(x):
    """NHWC numpy -> NCHW tensor."""
    return t(x).permute(0, 3, 1, 2)


def nhwc(x):
    """NCHW tensor -> NHWC numpy."""
    return x.detach().permute(0, 2, 3, 1).numpy()


def close(got, want, tol, msg=""):
    np.testing.assert_allclose(np32(got), np32(want), rtol=tol, atol=tol, err_msg=msg)
