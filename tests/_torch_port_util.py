"""Helpers shared by the tests that hold mscl_torch against mscl_tpu."""
import jax
import numpy as np
import pytest
import torch

from mscl_tpu.ops import conv3d as _c3


@pytest.fixture(scope='module')
def xla3d_conv():
    """Pin the JAX convolutions to the direct lowering: the tap-stacked one
    sums in another order, and the 1/T logit scale amplifies that f32
    noise (as tests/test_mscl_torch_composite.py does)."""
    prev = _c3.get_conv3d_impl()
    _c3.set_conv3d_impl('xla3d')
    yield
    _c3.set_conv3d_impl(prev)


def perturb(tree, seed, scale=0.1):
    """Add seeded noise to every float leaf, so identity-valued BN params
    and statistics do not hide a conversion mistake."""
    rng = np.random.default_rng(seed)

    def f(x):
        x = np.asarray(x)
        if x.dtype != np.float32:
            return x
        noise = rng.normal(size=x.shape).astype(np.float32) * scale
        if x.ndim == 1:      # BN scale/var stay positive
            return x + np.abs(noise)
        return x + noise * np.abs(x).mean()
    return jax.tree.map(f, tree)


def ncthw(x):
    """NTHWC (numpy / jax) -> NCTHW numpy."""
    return np.transpose(np.asarray(x), (0, 4, 1, 2, 3))


def nthwc(x):
    return np.transpose(np.asarray(x), (0, 2, 3, 4, 1))


def t(x):
    return torch.from_numpy(np.array(x))
