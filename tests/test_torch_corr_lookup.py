"""mscl_torch's RAFT correlation lookup against mscl_tpu's, on the CPU: the
materialised volume (build_corr_pyramid + lookup_corr), the scan, and both
Pallas kernels in interpret mode, at the cases of tests/test_ops.py
(TestCorrLookup). On the CPU the port runs its plain version, which is what
the CUDA kernel is held to on the card."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mscl_tpu.flow.raft import build_corr_pyramid, lookup_corr
from mscl_tpu.ops.corr_lookup import (corr_lookup_pallas,
                                      corr_lookup_pallas_v2, corr_lookup_scan)
from mscl_torch.ops import corr_lookup as cl

from _torch_port_util import t

# name -> (h, w, levels, radius, flow scale); n=2, C=32 throughout
CASES = {'grid_noise': (12, 16, 3, 2, 6.0),
         'odd_levels_off_edge': (10, 14, 2, 3, 12.0),
         'far_out_of_range': (12, 16, 2, 2, None),
         # windows spread over most of each level (the kernel's sub-boxes)
         'wide_flow': (12, 16, 3, 2, 40.0),
         'radius_6': (14, 18, 2, 6, 5.0)}


def _inputs(case, n=2, c=32, seed=0):
    h, w, levels, radius, flow_scale = CASES[case]
    rng = np.random.default_rng(seed)
    f1 = rng.normal(size=(n, h, w, c)).astype(np.float32)
    f2 = rng.normal(size=(n, h, w, c)).astype(np.float32)
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing='ij')
    base = np.stack([xs, ys], -1)[None].repeat(n, 0)
    if flow_scale is None:
        coords = np.full(base.shape, -1000.0, np.float32)
    else:
        coords = (base + rng.normal(scale=flow_scale, size=base.shape)
                  ).astype(np.float32)
    return f1, f2, coords, levels, radius


def _jax(ref, f1, f2, coords, levels, radius):
    f1, f2, coords = (jnp.asarray(x) for x in (f1, f2, coords))
    if ref == 'volume':
        out = lookup_corr(build_corr_pyramid(f1, f2, levels), coords, radius)
    elif ref == 'scan':
        out = corr_lookup_scan(f1, f2, coords, levels, radius, tile=16)
    elif ref == 'pallas':
        out = corr_lookup_pallas(f1, f2, coords, levels, radius, tile=16,
                                 interpret=True)
    else:
        out = corr_lookup_pallas_v2(f1, f2, coords, levels, radius, tile=16,
                                    interpret=True)
    return np.asarray(out)


@pytest.mark.parametrize('ref', ['volume', 'scan', 'pallas', 'pallas_v2'])
@pytest.mark.parametrize('case', sorted(CASES))
def test_matches_jax(case, ref):
    f1, f2, coords, levels, radius = _inputs(case)
    want = _jax(ref, f1, f2, coords, levels, radius)
    launches = cl.corr_lookup.launches
    got = cl.corr_lookup(t(f1), t(f2), t(coords), levels, radius)
    assert cl.corr_lookup.launches == launches      # the CPU runs no kernel
    assert got.shape == want.shape == (2,) + f1.shape[1:3] + (
        levels * (2 * radius + 1) ** 2,)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    if case == 'far_out_of_range':
        assert not got.any()


def test_pyramid_levels_and_reuse():
    """The pooled levels (odd edges dropped) are the 2x2 means of the JAX
    wrapper, and a pyramid built once gives the lookup of fmap2 itself."""
    f1, f2, coords, _, _ = _inputs('odd_levels_off_edge')
    pyr = cl.corr_pyramid(t(f2), 3)
    assert [tuple(v.shape) for v in pyr.levels] == [
        (2, 10, 14, 32), (2, 5, 7, 32), (2, 2, 3, 32)]
    assert pyr.flat.numel() == sum(v.numel() for v in pyr.levels)
    want = f2[:, :8, :12].reshape(2, 4, 2, 6, 2, 32).mean(axis=(2, 4))
    np.testing.assert_allclose(pyr.levels[1][:, :4, :6].numpy(), want,
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(
        cl.corr_lookup(t(f1), pyr, t(coords), 3, 3).numpy(),
        cl.corr_lookup(t(f1), t(f2), t(coords), 3, 3).numpy())


def test_plain_chunks_and_float64(monkeypatch):
    """Chunking over pixels changes nothing but the order of bmm's sums,
    and the plain version keeps the inputs' dtype (the chip check's float64
    reference)."""
    f1, f2, coords, levels, radius = _inputs('grid_noise')
    whole = cl.corr_lookup(t(f1), t(f2), t(coords), levels, radius)
    monkeypatch.setattr(cl, 'PLAIN_CHUNK_FLOATS', 1000)
    chunked = cl.corr_lookup(t(f1), t(f2), t(coords), levels, radius)
    np.testing.assert_allclose(chunked.numpy(), whole.numpy(), atol=1e-6)
    f64 = cl.corr_lookup(*(t(x).double() for x in (f1, f2, coords)),
                         levels, radius)
    assert f64.dtype == torch.float64
    np.testing.assert_allclose(f64.numpy(), whole.numpy(), atol=1e-5)


def test_empty_top_level_is_zero():
    """A level pooled down to nothing (6 rows, 4 levels) looks up zeros."""
    rng = np.random.default_rng(3)
    f1, f2 = (t(rng.normal(size=(1, 6, 9, 8)).astype(np.float32))
              for _ in range(2))
    coords = t(rng.uniform(0, 6, size=(1, 6, 9, 2)).astype(np.float32))
    out = cl.corr_lookup(f1, f2, coords, 4, 1)
    assert out.shape == (1, 6, 9, 36)
    assert not out[..., 27:].any()
    assert out[..., :9].abs().sum() > 0


def test_plan_fills_the_card_within_shared_memory():
    """At the extraction shape (16x22, N=8) the kernel's tiles give at least
    one block for each of an H100's 132 SMs, and a block's shared memory
    fits Hopper's 227 KB at every width and radius the wrapper takes (two
    blocks an SM at C=256, r=4 and at the widest C and radius)."""
    plan = cl.plan(8, 16, 22, 256, 4)
    assert plan['blocks'] == 8 * 8 * 6 >= 132
    assert plan['stage_positions'] % 32 == 0
    assert 2 <= plan['stages'] and 4 <= plan['chunk_channels'] <= 32
    for c in (4, 100, cl.MAX_C):
        for r in range(cl.MAX_RADIUS + 1):
            assert cl.plan(1, 1, 1, c, r)['smem_bytes'] <= 232448
    for r in (4, cl.MAX_RADIUS):
        # the SM's 228 KB, less 1 KB the runtime keeps for each block
        assert 2 * (cl.plan(1, 1, 1, cl.MAX_C, r)['smem_bytes'] + 1024) <= \
            228 * 1024
    assert cl.plan(1, 55, 128, 256, 4)['blocks'] == 28 * 32


def _staged_brute(coords, levels, radius):
    """staged_positions, one tile at a time with Python sets."""
    n, h, w, _ = coords.shape
    kc, staged, boxed = 2 * radius + 2, 0, 0
    for l in range(levels):
        hl, wl = h >> l, w >> l
        for b in range(n):
            for ty in range(0, h, cl.TILE_H):
                for tx in range(0, w, cl.TILE_W):
                    held = set()
                    for y in range(ty, min(ty + cl.TILE_H, h)):
                        for x in range(tx, min(tx + cl.TILE_W, w)):
                            sx, sy = (int(np.floor(np.float32(v) / 2 ** l))
                                      - radius for v in coords[b, y, x])
                            held |= {(yy, xx)
                                     for yy in range(max(sy, 0),
                                                     min(sy + kc, hl))
                                     for xx in range(max(sx, 0),
                                                     min(sx + kc, wl))}
                    staged += len(held)
                    if held:
                        ys, xs = zip(*held)
                        boxed += (max(ys) - min(ys) + 1) * (
                            max(xs) - min(xs) + 1)
    return staged, boxed


@pytest.mark.parametrize('case', ['grid_noise', 'odd_levels_off_edge',
                                  'wide_flow', 'far_out_of_range'])
def test_staged_positions(case):
    """The host's count of the positions the kernel's tiles stage (each
    tile's in-range windows, unioned) and of their union boxes, against a
    tile-by-tile count."""
    _, _, coords, levels, radius = _inputs(case, n=2)
    got = cl.staged_positions(t(coords), levels, radius)
    assert got == _staged_brute(coords, levels, radius)
    assert got[0] <= got[1]
    if case == 'far_out_of_range':
        assert got == (0, 0)
