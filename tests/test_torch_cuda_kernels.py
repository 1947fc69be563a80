"""The CUDA kernels against their plain PyTorch versions on the card.
Decayed InfoNCE at shapes that take every path of its kernels: more than 32
rows (the row passes of both), rows that leave a micro-tile ragged (B=33)
and three passes (B=96), widths that are not a multiple of the micro-tile
or of a forward stage (C=100, 10, 8), one K-tile and many, fewer tiles than
the backward's split-K slabs (K=512), a K that is not a multiple of 4 (the
4-byte copies), a decay below float32's normal range, and dq's fixed
summing order (two calls give the same bits). The correlation lookup at odd
level sizes, C of 4, 32, 100 and 256 (one 8-channel chunk, mostly
zero-filled; four; a ragged last one; 32), r up to 8, N of 1 to 8 with tiles cut by the image's edge (H and W
not multiples of the tile), 8 levels of which the top ones are empty,
windows off every edge, a wide flow whose window union exceeds one stage,
and two calls giving the same bits. The five tensor-core fill
probes at M=3248 (ragged against every tile), 928, 200 and 40 (below one
tile), K of 64 (one chunk) to 1792, N of 64 and 128, 1, 2 and 27 taps (one
register set, both, an odd count), carry's mt of 40, 112, 464 and 1624
(tiles that end inside a sub-tile, and not a multiple of 16), and 1, 8 and
133 steps (not a multiple of the persistent blocks); each kernel's plan (its
tile, ring, slabs, sub-tiles, blocks and groups), and steps giving the bits
of one. Skipped where there is no CUDA device."""
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


def _infonce_inputs(dev, b, c, k, count_range=(0, 5000)):
    rng = np.random.default_rng(b * c + k)
    q = torch.from_numpy(rng.normal(size=(b, c)).astype(np.float32)).to(dev)
    queue = torch.from_numpy(rng.normal(size=(c, k)).astype(np.float32))
    queue = (queue / queue.norm(dim=0, keepdim=True)).to(dev)
    count = torch.from_numpy(rng.integers(*count_range, size=k)).to(dev)
    g = torch.from_numpy(rng.normal(size=(b, k)).astype(np.float32)).to(dev)
    return q, queue, g, di.decay_weights(count, 0.99999)


@pytest.mark.parametrize('b,c,k', [(32, 128, 65536), (4, 32, 32),
                                   (40, 100, 2048), (70, 256, 1024),
                                   (1, 8, 512), (33, 128, 4096),
                                   (96, 64, 2048), (16, 100, 65536),
                                   (5, 8, 1536), (32, 128, 512),
                                   (7, 10, 37), (33, 20, 100)])
def test_kernels_match_plain(dev, b, c, k):
    q, queue, g, decay = _infonce_inputs(dev, b, c, k)
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


def test_decay_below_normal_range(dev):
    """Counts of 8.5e6 to 1.2e7 drive 0.99999**count from the smallest
    normal float32 through the subnormals to 0."""
    q, queue, g, decay = _infonce_inputs(dev, 32, 128, 4096,
                                         (8_500_000, 12_000_000))
    assert (decay == 0).any() and ((decay > 0) & (decay < 1.2e-38)).any()
    qg = q.clone().requires_grad_(True)
    out = di.decayed_neg(qg, queue, decay)
    out.backward(g)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all() and torch.isfinite(qg.grad).all()
    assert not out[:, decay == 0].any()
    torch.testing.assert_close(out.detach(), di.l_neg_plain(q, queue, decay),
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(qg.grad, di.dq_plain(g, queue, decay),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize('b,c,k', [(32, 128, 65536), (70, 100, 1024)])
def test_dq_is_bitwise_deterministic(dev, b, c, k):
    """The split-K partials are summed in a fixed order: the same inputs
    give the same bits."""
    _, queue, g, decay = _infonce_inputs(dev, b, c, k)
    first = di.dq(g, queue, decay)
    second = di.dq(g, queue, decay)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_in_place_queue_change_is_caught(dev):
    """The autograd function saves the queue: writing into it between
    forward and backward is an error, not a silent wrong gradient."""
    q = torch.randn(4, 16, device=dev, requires_grad=True)
    queue = torch.randn(16, 128, device=dev)
    out = di.decayed_neg(q, queue, torch.ones(128, device=dev))
    queue[:, :4] = 0
    with pytest.raises(RuntimeError, match='inplace'):
        out.sum().backward()


def _corr_case(dev, n, h, w, c, radius, scale):
    rng = np.random.default_rng(n * h * w + c)
    f1, f2 = (torch.from_numpy(rng.normal(size=(n, h, w, c)).astype(
        np.float32)).to(dev) for _ in range(2))
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing='ij')
    coords = np.stack([xs, ys], -1)[None].repeat(n, 0) + rng.normal(
        scale=scale, size=(n, h, w, 2))
    # windows partly off the left, right, top and bottom edges, and far off
    coords[:, 0, :, 1] = -radius - 0.5
    coords[:, -1, :, 1] = h + 2.25
    coords[:, :, 0, 0] = -1.75
    coords[:, :, -1, 0] = w + radius - 1.5
    coords[:, h // 2, w // 2] = (-1000.0, 1000.0)
    return f1, f2, torch.from_numpy(coords.astype(np.float32)).to(dev)


# n, h, w, c, levels, radius, the scale of the flow's noise
CORR_CASES = [
    (8, 16, 22, 256, 4, 4, 4.0), (1, 55, 128, 256, 4, 4, 4.0),
    (2, 13, 19, 100, 3, 3, 4.0), (1, 9, 7, 32, 2, 1, 4.0),
    (3, 6, 5, 64, 4, 0, 4.0),
    (1, 55, 128, 256, 4, 4, 64.0),    # window unions beyond one stage
    (2, 16, 22, 256, 4, 8, 4.0),      # the widest radius at the widest C
    (2, 13, 19, 4, 3, 2, 4.0),        # C=4: one chunk, mostly zero-filled
    (1, 40, 70, 32, 8, 2, 8.0),       # levels 6 and 7 pooled to nothing
    (3, 10, 13, 64, 3, 3, 4.0),       # N>1, tiles cut by the bottom edge
    (2, 12, 21, 128, 4, 4, 4.0)]      # W not a multiple of the tile


@pytest.mark.parametrize('n,h,w,c,levels,radius,scale', CORR_CASES)
def test_corr_lookup_matches_plain(dev, n, h, w, c, levels, radius, scale):
    f1, f2, coords = _corr_case(dev, n, h, w, c, radius, scale)
    pyramid = cl.corr_pyramid(f2, levels)
    launches = cl.corr_lookup.launches
    got = cl.corr_lookup(f1, pyramid, coords, levels, radius)
    torch.cuda.synchronize()
    assert cl.corr_lookup.launches == launches + 1
    want = cl.corr_lookup_plain(f1, pyramid.levels, coords, radius)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert not got[:, h // 2, w // 2].any()
    assert got.abs().max() > 0


@pytest.mark.parametrize('n,h,w,c,levels,radius,scale', [
    (8, 16, 22, 256, 4, 4, 4.0), (1, 55, 128, 256, 4, 4, 64.0)])
def test_corr_lookup_is_bitwise_deterministic(dev, n, h, w, c, levels,
                                              radius, scale):
    """Each corner sum is taken by one thread in a fixed order: the same
    inputs give the same bits."""
    f1, f2, coords = _corr_case(dev, n, h, w, c, radius, scale)
    pyramid = cl.corr_pyramid(f2, levels)
    first = cl.corr_lookup(f1, pyramid, coords, levels, radius)
    second = cl.corr_lookup(f1, pyramid, coords, levels, radius)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


# kind, m, shape parameters, steps
MXU_CASES = [
    ('probe', 3248, dict(k=64, n=64, inner=27), 1),
    ('probe', 3248, dict(k=128, n=64, inner=27), 8),
    ('probe', 40, dict(k=256, n=128, inner=27), 8),
    ('probe', 3248, dict(k=256, n=128, inner=27), 1),
    ('probe', 3248, dict(k=128, n=128, inner=27), 1),
    ('probe', 200, dict(k=64, n=64, inner=1), 1),
    ('probe', 3248, dict(k=64, n=64, inner=2), 8),
    ('carry', 3248, dict(mt=112, k=64, n=64, inner=27), 1),
    ('carry', 3248, dict(mt=464, k=128, n=64, inner=27), 8),
    ('carry', 3248, dict(mt=1624, k=128, n=64, inner=27), 1),
    ('carry', 40, dict(mt=40, k=256, n=128, inner=27), 8),
    ('carry', 928, dict(mt=464, k=64, n=128, inner=27), 8),
    ('carry', 3248, dict(mt=1624, k=256, n=128, inner=3), 1),
    ('bigdot', 3248, dict(k=1792, n=64), 1),
    ('bigdot', 40, dict(k=448, n=128), 8),
    ('bigdot', 3248, dict(k=896, n=128), 8),
    ('bigdot', 3248, dict(k=64, n=64), 1),
    ('bigdot', 3248, dict(k=1792, n=128), 1),
    ('bigdot', 200, dict(k=448, n=64), 8),
    ('bigdot', 3248, dict(k=1792, n=64), 133),
    ('imcat', 3248, dict(k=64, n=64, inner=28), 1),
    ('imcat', 40, dict(k=64, n=128, inner=28), 8),
    ('imcat', 3248, dict(k=128, n=128, inner=16), 1),
    ('imcat', 3248, dict(k=256, n=64, inner=8), 1),
    ('imcat', 3248, dict(k=256, n=128, inner=8), 1),
    ('imcat', 3248, dict(k=64, n=64, inner=28), 133),
    ('paircat', 3248, dict(k=64, n=64, inner=28), 1),
    ('paircat', 40, dict(k=128, n=128, inner=28), 8),
    ('paircat', 3248, dict(k=64, n=128, inner=28), 8),
    ('paircat', 200, dict(k=64, n=64, inner=2), 1),
]


def _mxu_inputs(dev, kind, m, shape):
    x_shape, w_shape = mf._shapes(kind, m, **shape)
    g = torch.Generator().manual_seed(m + shape['k'] + shape['n'])
    x = torch.randn(x_shape, generator=g).to(dev, torch.bfloat16)
    w = (0.05 * torch.randn(w_shape, generator=g)).to(dev, torch.bfloat16)
    return x, w


@pytest.mark.parametrize('kind,m,shape,steps', MXU_CASES)
def test_mxu_fill_matches_plain(dev, kind, m, shape, steps):
    x, w = _mxu_inputs(dev, kind, m, shape)
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


@pytest.mark.parametrize('kind,shape', [
    ('bigdot', dict(k=1792, n=64)), ('imcat', dict(k=64, n=64, inner=28)),
    ('probe', dict(k=64, n=64, inner=27)),
    ('probe', dict(k=128, n=128, inner=27)),
    ('carry', dict(mt=112, k=64, n=64, inner=27)),
    ('carry', dict(mt=1624, k=128, n=64, inner=27)),
    ('paircat', dict(k=64, n=64, inner=28))])
def test_kcat_steps_give_the_same_bits(dev, kind, shape):
    """Every step of the persistent walk computes and stores its tile in
    the same order: 133 steps (not a multiple of the blocks) give the bits
    of one."""
    x, w = _mxu_inputs(dev, kind, 3248, shape)
    entry = mf.ENTRY_POINTS[kind]
    one = entry(x, w, m=3248, steps=1, **shape)
    many = entry(x, w, m=3248, steps=133, **shape)
    torch.cuda.synchronize()
    assert torch.equal(one, many)


# kind, m, shape, steps, the tile the plan must take: bigdot 256 rows at
# both widths, imcat 256 where its slab and 3 stages fit, else 128 (K=256)
KCAT_PLANS = [
    ('bigdot', 3248, dict(k=1792, n=64), 132, 256),
    ('bigdot', 40, dict(k=448, n=128), 8, 256),
    ('imcat', 3248, dict(k=64, n=64, inner=28), 133, 256),
    ('imcat', 3248, dict(k=128, n=128, inner=16), 1, 256),
    ('imcat', 3248, dict(k=256, n=64, inner=8), 132, 128),
    ('imcat', 3248, dict(k=256, n=128, inner=8), 132, 128),
]


@pytest.mark.parametrize('kind,m,shape,steps,bm', KCAT_PLANS)
def test_kcat_plan(dev, kind, m, shape, steps, bm):
    """The persistent walk's plan: the tile, a ring that fits a block, one
    unit for each (step, tile) and no more blocks than units or the SMs
    hold, and no more groups of blocks than blocks."""
    plan = mf.plan(kind, m, steps=steps, **shape)
    assert plan['bm'] == bm and plan['units'] == steps * -(-m // bm)
    assert plan['slabs'] == (kind == 'imcat') and plan['subtiles'] == 1
    _check_grid(dev, plan)


def _check_grid(dev, plan):
    """A ring that fits a block, no more blocks than units or the SMs
    hold, and no more groups of blocks than blocks."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert 2 <= plan['stages'] <= 8 and plan['smem_bytes'] <= 232448
    assert plan['blocks'] == min(plan['units'],
                                 sms * plan['blocks_per_sm'])
    assert 1 <= plan['groups'] <= plan['blocks']


# kind, m, shape, steps, the tile and sub-tiles the plan must take: carry
# the tile that computes the fewest rows of an mt-row tile (256 on a tie),
# probe and paircat 256 at N=64 and 128 at N=128; two slabs where they fit
TAP_PLANS = [
    ('probe', 3248, dict(k=64, n=64, inner=27), 132, 256, 1, 2),
    ('probe', 40, dict(k=256, n=64, inner=27), 8, 256, 1, 1),
    ('probe', 3248, dict(k=128, n=128, inner=27), 1, 128, 1, 2),
    ('probe', 3248, dict(k=256, n=128, inner=27), 132, 128, 1, 1),
    ('paircat', 3248, dict(k=64, n=64, inner=28), 133, 256, 1, 2),
    ('paircat', 3248, dict(k=64, n=128, inner=28), 132, 128, 1, 2),
    ('carry', 3248, dict(mt=112, k=64, n=64, inner=27), 132, 128, 1, 2),
    ('carry', 3248, dict(mt=464, k=128, n=64, inner=27), 132, 256, 2, 2),
    ('carry', 3248, dict(mt=1624, k=128, n=64, inner=27), 133, 128, 13, 2),
    ('carry', 40, dict(mt=40, k=256, n=128, inner=27), 8, 128, 1, 2),
]


@pytest.mark.parametrize('kind,m,shape,steps,bm,subtiles,slabs', TAP_PLANS)
def test_tap_plan(dev, kind, m, shape, steps, bm, subtiles, slabs):
    """The tap kernel's plan: the tile, the slabs, one unit for each step
    and tile (carry: each sub-tile of each mt-row tile), and a grid as
    kcat's."""
    plan = mf.plan(kind, m, steps=steps, **shape)
    tiles = (m // shape['mt'] * subtiles if kind == 'carry' else
             -(-m // bm))
    assert (plan['bm'], plan['subtiles'], plan['slabs']) == (bm, subtiles,
                                                             slabs)
    assert plan['units'] == steps * tiles
    _check_grid(dev, plan)
