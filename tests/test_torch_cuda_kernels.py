"""The decayed-InfoNCE CUDA kernels against their plain PyTorch versions on
the card, at shapes that take every path of the kernels: more than 32 rows
(the forward's row chunks, the backward's chunk loop), a width that does not
divide 256, one K-tile and many. Skipped where there is no CUDA device."""
import numpy as np
import pytest
import torch

from mscl_torch.ops import decayed_infonce as di

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


@pytest.mark.parametrize('b,c,k', [(32, 128, 65536), (4, 32, 32),
                                   (40, 100, 2048), (70, 256, 1024),
                                   (1, 8, 512)])
def test_kernels_match_plain(dev, b, c, k):
    rng = np.random.default_rng(b * c + k)
    q = torch.from_numpy(rng.normal(size=(b, c)).astype(np.float32)).to(dev)
    queue = torch.from_numpy(rng.normal(size=(c, k)).astype(np.float32))
    queue = (queue / queue.norm(dim=0, keepdim=True)).to(dev)
    count = torch.from_numpy(rng.integers(0, 5000, size=k)).to(dev)
    g = torch.from_numpy(rng.normal(size=(b, k)).astype(np.float32)).to(dev)
    decay = di.decay_weights(count, 0.99999)
    launches = (di.l_neg.launches, di.dq.launches)
    qg = q.clone().requires_grad_(True)
    out = di.decayed_neg(qg, queue, decay)
    out.backward(g)
    torch.cuda.synchronize()
    assert (di.l_neg.launches, di.dq.launches) == (launches[0] + 1,
                                                    launches[1] + 1)
    torch.testing.assert_close(out.detach(), di.l_neg_plain(q, queue, decay),
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(qg.grad, di.dq_plain(g, queue, decay),
                               rtol=1e-4, atol=1e-4)


def test_in_place_queue_change_is_caught(dev):
    """The autograd function saves the queue: writing into it between
    forward and backward is an error, not a silent wrong gradient."""
    q = torch.randn(4, 16, device=dev, requires_grad=True)
    queue = torch.randn(16, 128, device=dev)
    out = di.decayed_neg(q, queue, torch.ones(128, device=dev))
    queue[:, :4] = 0
    with pytest.raises(RuntimeError, match='inplace'):
        out.sum().backward()
