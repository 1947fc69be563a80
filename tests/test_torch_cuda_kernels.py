"""The CUDA kernels against their plain PyTorch versions on the card.
Decayed InfoNCE at shapes that take every path of its kernels: more than 32
rows (the forward's row chunks, the backward's chunk loop), a width that
does not divide 256, one K-tile and many. The correlation lookup at odd
level sizes, C of 32, 100 and 256 (one, four and eight float4 chunks a
lane), N of 1 and 8, and windows off every edge. The five tensor-core fill
probes at M=3248 (ragged against every tile) and M=40, K of 64 to 1792, N of
64 and 128, carry's mt of 112, 464 and 1624 (spilled, and not a multiple of
16), and 1 and 8 steps. Skipped where there is no CUDA device."""
import numpy as np
import pytest
import torch

from mscl_torch.ops import corr_lookup as cl
from mscl_torch.ops import decayed_infonce as di
from mscl_torch.ops import mxu_fill as mf

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


@pytest.mark.parametrize('n,h,w,c,levels,radius', [
    (8, 16, 22, 256, 4, 4), (1, 55, 128, 256, 4, 4), (2, 13, 19, 100, 3, 3),
    (1, 9, 7, 32, 2, 1), (3, 6, 5, 64, 4, 0)])
def test_corr_lookup_matches_plain(dev, n, h, w, c, levels, radius):
    rng = np.random.default_rng(n * h * w + c)
    f1, f2 = (torch.from_numpy(rng.normal(size=(n, h, w, c)).astype(
        np.float32)).to(dev) for _ in range(2))
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing='ij')
    coords = np.stack([xs, ys], -1)[None].repeat(n, 0) + rng.normal(
        scale=4.0, size=(n, h, w, 2))
    # windows partly off the left, right, top and bottom edges, and far off
    coords[:, 0, :, 1] = -radius - 0.5
    coords[:, -1, :, 1] = h + 2.25
    coords[:, :, 0, 0] = -1.75
    coords[:, :, -1, 0] = w + radius - 1.5
    coords[:, h // 2, w // 2] = (-1000.0, 1000.0)
    coords = torch.from_numpy(coords.astype(np.float32)).to(dev)
    pyramid = cl.corr_pyramid(f2, levels)
    launches = cl.corr_lookup.launches
    got = cl.corr_lookup(f1, pyramid, coords, levels, radius)
    torch.cuda.synchronize()
    assert cl.corr_lookup.launches == launches + 1
    want = cl.corr_lookup_plain(f1, pyramid.levels, coords, radius)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert not got[:, h // 2, w // 2].any()
    assert got.abs().max() > 0


# kind, m, shape parameters, steps
MXU_CASES = [
    ('probe', 3248, dict(k=64, n=64, inner=27), 1),
    ('probe', 3248, dict(k=128, n=64, inner=27), 8),
    ('probe', 40, dict(k=256, n=128, inner=27), 8),
    ('probe', 3248, dict(k=256, n=128, inner=27), 1),
    ('carry', 3248, dict(mt=112, k=64, n=64, inner=27), 1),
    ('carry', 3248, dict(mt=464, k=128, n=64, inner=27), 8),
    ('carry', 3248, dict(mt=1624, k=128, n=64, inner=27), 1),
    ('carry', 40, dict(mt=40, k=256, n=128, inner=27), 8),
    ('bigdot', 3248, dict(k=1792, n=64), 1),
    ('bigdot', 40, dict(k=448, n=128), 8),
    ('bigdot', 3248, dict(k=896, n=128), 8),
    ('imcat', 3248, dict(k=64, n=64, inner=28), 1),
    ('imcat', 40, dict(k=64, n=128, inner=28), 8),
    ('imcat', 3248, dict(k=128, n=128, inner=16), 1),
    ('paircat', 3248, dict(k=64, n=64, inner=28), 1),
    ('paircat', 40, dict(k=128, n=128, inner=28), 8),
    ('paircat', 3248, dict(k=64, n=128, inner=28), 8),
]


@pytest.mark.parametrize('kind,m,shape,steps', MXU_CASES)
def test_mxu_fill_matches_plain(dev, kind, m, shape, steps):
    x_shape, w_shape = mf._shapes(kind, m, **shape)
    g = torch.Generator().manual_seed(m + shape['k'] + shape['n'])
    x = torch.randn(x_shape, generator=g).to(dev, torch.bfloat16)
    w = (0.05 * torch.randn(w_shape, generator=g)).to(dev, torch.bfloat16)
    entry = mf.ENTRY_POINTS[kind]
    launches = entry.launches
    got = entry(x, w, m=m, steps=steps, **shape)
    torch.cuda.synchronize()
    assert entry.launches == launches + 1
    want = mf.PLAIN_VERSIONS[kind](x, w, m=m, **shape)
    # one bf16 rounding of a float32 sum taken in another order
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2,
                               atol=1e-2)
    assert got.float().abs().max() > 0.1
