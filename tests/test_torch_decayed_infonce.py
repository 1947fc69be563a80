"""The port's decayed-InfoNCE negatives (mscl_torch/ops/decayed_infonce.py)
against the JAX package's Pallas kernel (interpret mode) and its XLA
formulation, on the CPU, where the port runs its plain PyTorch versions.
The same cases as tests/test_ops.py:11-56."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mscl_tpu.ops import decayed_infonce_neg as jax_neg
from mscl_tpu.ops import decayed_infonce_neg_xla as jax_neg_xla
from mscl_torch.ops import decayed_infonce as di

T_DECAY = 0.99999


@pytest.fixture
def data():
    rng = np.random.default_rng(0)
    b, c, k = 8, 128, 4096
    q = rng.normal(size=(b, c)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    queue = rng.normal(size=(c, k)).astype(np.float32)
    queue /= np.linalg.norm(queue, axis=0, keepdims=True)
    count = rng.integers(0, 2000, size=(k,)).astype(np.int32)
    return q, queue, count


def _neg(q, queue, count, t_decay=T_DECAY):
    return di.decayed_neg(q, queue, di.decay_weights(count, t_decay))


def _torch(q, queue, count):
    return (torch.from_numpy(q).requires_grad_(True),
            torch.from_numpy(queue), torch.from_numpy(count.astype(np.int64)))


@pytest.mark.parametrize('ref', ['pallas_interpret', 'xla'])
def test_forward_matches_jax(data, ref):
    q, queue, count = data
    if ref == 'xla':
        want = jax_neg_xla(jnp.asarray(q), jnp.asarray(queue),
                           jnp.asarray(count))[0]
    else:
        want = jax_neg(jnp.asarray(q), jnp.asarray(queue),
                       jnp.asarray(count), T_DECAY, 1024, True)
    tq, tqueue, tcount = _torch(q, queue, count)
    got = _neg(tq, tqueue, tcount)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    decay = di.decay_weights(tcount, T_DECAY)
    np.testing.assert_allclose(di.l_neg_plain(tq, tqueue, decay)
                               .detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('ref', ['pallas_interpret', 'xla'])
def test_gradient_matches_jax(data, ref):
    q, queue, count = data
    if ref == 'xla':
        fn = lambda x: jax_neg_xla(x, jnp.asarray(queue),  # noqa: E731
                                   jnp.asarray(count))[0].sum()
    else:
        fn = lambda x: jax_neg(x, jnp.asarray(queue),  # noqa: E731
                               jnp.asarray(count), T_DECAY, 1024,
                               True).sum()
    want = np.asarray(jax.grad(fn)(jnp.asarray(q)))
    tq, tqueue, tcount = _torch(q, queue, count)
    _neg(tq, tqueue, tcount).sum().backward()
    np.testing.assert_allclose(tq.grad.numpy(), want, rtol=1e-4, atol=1e-4)
    g = torch.ones(q.shape[0], queue.shape[1])
    np.testing.assert_allclose(
        di.dq_plain(g, tqueue, di.decay_weights(tcount, T_DECAY)).numpy(),
        want, rtol=1e-4, atol=1e-4)


def test_decay_actually_applied(data):
    q, queue, count = data
    tq, tqueue, tcount = _torch(q, queue, count)
    out_decay = _neg(tq, tqueue, tcount, 0.9)
    out_nodecay = _neg(tq, tqueue, torch.zeros_like(tcount), 0.9)
    assert not np.allclose(out_decay.detach().numpy(),
                           out_nodecay.detach().numpy())
    scale = 0.9 ** count.astype(np.float32)
    np.testing.assert_allclose(out_decay.detach().numpy(),
                               out_nodecay.detach().numpy() * scale[None, :],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(
        out_decay.detach().numpy(),
        np.asarray(jax_neg(jnp.asarray(q), jnp.asarray(queue),
                           jnp.asarray(count), 0.9, 1024, True)),
        rtol=1e-5, atol=1e-5)


def test_queue_and_count_get_no_gradient(data):
    q, queue, count = data
    tq = torch.from_numpy(q).requires_grad_(True)
    tqueue = torch.from_numpy(queue).requires_grad_(True)
    _neg(tq, tqueue, torch.from_numpy(count.astype(np.int64))).sum() \
        .backward()
    assert tqueue.grad is None and tq.grad is not None


@pytest.mark.parametrize('fn', ['l_neg', 'dq'])
def test_ragged_k_is_refused(fn):
    """K=1000 is not a multiple of the 128-column forward tile, K=640 not
    of the 512-column backward slab; both wrappers refuse both."""
    for k in (1000, 640):
        queue = torch.zeros(4, k)
        decay = torch.ones(k)
        with pytest.raises(ValueError, match='not a multiple of the K-tile'):
            if fn == 'l_neg':
                di.l_neg(torch.zeros(2, 4), queue, decay)
            else:
                di.dq(torch.zeros(2, k), queue, decay)
