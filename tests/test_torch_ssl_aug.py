"""The port's device augmentation (mscl_torch/models/common/ssl_aug.py and
motion_map.py) against mscl_tpu's, on the CPU.

torch cannot replay jax.random, so every apply is fed JAX's own draws
(tests/_torch_aug_util.py splits each key as ssl_aug.py does) and compared
with the JAX function called on the same key, in float32 and in bfloat16.
The draws themselves are held by their shapes, ranges, broadcasting and
rates. Clips are B=4, T=8, 32x32; flows 16x16 over 2T frames.

Tolerances: float32 colour math 1e-5 (the JAX and torch CPU kernels differ
by an ulp here and there); bfloat16 exact (eager JAX rounds each op to
bf16, as torch does); the colour wheel's floor(255 col) may flip by 1/255
where an ulp moves col across a step, on a share of at most 1e-5 of the
elements, and nowhere else by more than 1e-6; motion maps 1e-6.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_aug_util as draws
from mscl_tpu.models.common import ssl_aug as J
from mscl_tpu.models.common.motion_map import MotionMapCalculator as JMotion
from mscl_tpu.utils import flow_viz as jflow_viz
from mscl_torch.models import build_ssl_aug
from mscl_torch.models.common import ssl_aug as P
from mscl_torch.models.common.motion_map import MotionMapCalculator
from mscl_torch.utils import flow_viz

B, T, HW, FLOW_HW = 4, 8, 32, 16
F32_TOL = 1e-5
WHEEL_STEP = 1 / 255 + 1e-6
WHEEL_SHARE = 1e-5
DTYPES = {'float32': (jnp.float32, torch.float32),
          'bfloat16': (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    """The torch side on one thread: its CPU kernels then take one code
    path for every element, and the JAX comparison is reproducible."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def nthwc(x):
    return np.transpose(np.asarray(x), (0, 2, 3, 4, 1))


def ncthw(x):
    return np.transpose(np.asarray(jnp.asarray(x).astype(jnp.float32)),
                        (0, 4, 1, 2, 3))


def pair(x, dtype):
    """numpy NCTHW float32 -> (JAX NTHWC, torch NCTHW), both in dtype."""
    jdt, tdt = DTYPES[dtype]
    return (jnp.asarray(nthwc(x)).astype(jdt),
            torch.from_numpy(np.ascontiguousarray(x)).to(tdt))


def assert_close(got, want, dtype, tol=F32_TOL):
    got = got.float().numpy()
    if dtype == 'bfloat16':
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def assert_wheel_close(got, want, step=WHEEL_STEP):
    """At most a 1/255 step (scaled by normalize, where it ran), on a
    share of at most WHEEL_SHARE of the elements (rounded up to one)."""
    diff = np.abs(got.float().numpy() - want)
    assert diff.max() <= step, diff.max()
    flips = int((diff > 1e-6).sum())
    assert flips <= max(1, math.floor(WHEEL_SHARE * diff.size)), flips


@pytest.fixture(scope='module')
def clips():
    rng = np.random.default_rng(0)
    return [rng.uniform(size=(B, 3, T, HW, HW)).astype(np.float32)
            for _ in range(2)]


@pytest.fixture(scope='module')
def flows():
    rng = np.random.default_rng(1)
    return [rng.normal(size=(B, 2, 2 * T, FLOW_HW, FLOW_HW))
            .astype(np.float32) for _ in range(2)]


# ------------------------------------------------------------- flow viz
def test_wheel_matches_colorwheel_at_every_index():
    wheel = np.asarray(jflow_viz.make_colorwheel())
    np.testing.assert_array_equal(flow_viz.make_colorwheel(), wheel)
    got = torch.stack(P._wheel_channels(torch.arange(55)), -1).numpy()
    np.testing.assert_array_equal(got, wheel)
    jax_got = np.stack(J._wheel_channels(jnp.arange(55)), -1)
    np.testing.assert_array_equal(got, jax_got)


def test_host_flow_uv_to_colors_matches():
    rng = np.random.default_rng(2)
    u, v = rng.normal(size=(2, 64, 80)) * 0.6
    np.testing.assert_array_equal(flow_viz.flow_uv_to_colors(u, v),
                                  jflow_viz.flow_uv_to_colors(u, v))
    np.testing.assert_array_equal(
        flow_viz.flow_uv_to_colors(u, v, convert_to_bgr=True),
        jflow_viz.flow_uv_to_colors(u, v, convert_to_bgr=True))


@pytest.mark.parametrize('dtype', list(DTYPES))
@pytest.mark.parametrize('scale', [0.5, 1.0, 3.0])
def test_flow_uv_to_colors(dtype, scale):
    """About 300k pixels of random flow: inside and outside the unit disc,
    every hue."""
    rng = np.random.default_rng(3)
    u, v = (rng.normal(size=(2, 400, 800)) * scale).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    want = np.asarray(J.flow_uv_to_colors(
        jnp.asarray(u).astype(jdt), jnp.asarray(v).astype(jdt),
        out_dtype=jdt).astype(jnp.float32))
    got = P.flow_uv_to_colors(torch.from_numpy(u).to(tdt),
                              torch.from_numpy(v).to(tdt), out_dtype=tdt)
    assert got.dtype == tdt
    assert_wheel_close(got, want)


@pytest.mark.parametrize('dtype', list(DTYPES))
def test_flow_visualizer(flows, dtype):
    fj, ft = pair(flows[0], dtype)
    got = P.FlowVisualizer()(ft)
    assert got.shape == (B, 3, 2 * T, FLOW_HW, FLOW_HW)
    assert got.dtype == ft.dtype
    assert_wheel_close(got, ncthw(J.FlowVisualizer()(fj)))


# ------------------------------------------------------------ colour math
@pytest.mark.parametrize('dtype', list(DTYPES))
def test_rgb_hsv_round_trip(clips, dtype):
    xj, xt = pair(clips[0], dtype)
    hsv_j = J.rgb_to_hsv(xj)                         # (..., 3) NTHWC
    hsv_t = P.rgb_to_hsv(xt)                         # (N, 3, ...) NCTHW
    assert_close(hsv_t, ncthw(hsv_j), dtype)
    assert_close(P.hsv_to_rgb(hsv_t), ncthw(J.hsv_to_rgb(hsv_j)), dtype)
    assert_close(P.rgb_to_gray(xt), ncthw(J.rgb_to_gray(xj)), dtype)


def test_hsv_ties_pick_red_before_green():
    """r == g == max: the hue takes the r branch (0), not the g one."""
    x = np.zeros((1, 3, 1, 1, 2), np.float32)
    x[0, :, 0, 0, 0] = (0.8, 0.8, 0.2)
    x[0, :, 0, 0, 1] = (0.3, 0.9, 0.9)
    xj, xt = pair(x, 'float32')
    h = P._rgb_to_hsv_channels(xt)[0].numpy()
    np.testing.assert_array_equal(h, np.asarray(J._rgb_to_hsv_channels(
        xj)[0]))
    assert abs(h[0, 0, 0, 0] - 1 / 6) < 1e-6          # (bc - gc) / 6


@pytest.mark.parametrize('dtype', list(DTYPES))
@pytest.mark.parametrize('per_frame', [True, False])
def test_color_jitter(clips, dtype, per_frame):
    """Brightness, contrast (a frame's mean), saturation and hue; every
    clip applied (p=1) so the factors all act, then p=0.5."""
    xj, xt = pair(clips[0], dtype)
    for i, p in enumerate((1.0, 0.5)):
        key = jax.random.PRNGKey(10 + i)
        params = draws.jitter(key, B, T, p=p, per_frame_params=per_frame)
        want = J.color_jitter_video(key, xj, p=p, per_frame_params=per_frame)
        got = P.color_jitter_video(xt, params)
        assert got.dtype == xt.dtype
        assert_close(got, ncthw(want), dtype)


def test_contrast_mean_is_per_frame(clips):
    """Frames of one clip with different brightness keep their own
    contrast centre: a clip-wide mean would pull them together."""
    x = clips[0].copy()
    x[:, :, : T // 2] *= 0.2
    xt = torch.from_numpy(x)
    params = dict(apply=torch.ones(B, dtype=torch.bool),
                  brightness=torch.ones(B, T), contrast=torch.zeros(B, T),
                  saturation=torch.ones(B, T), hue=None)
    out = P.color_jitter_video(xt, params)
    # contrast 0 leaves each frame at its gray mean
    frame_mean = P.rgb_to_gray(xt).mean(dim=(1, 3, 4))
    np.testing.assert_allclose(out[:, 0, :, 0, 0].numpy(),
                               frame_mean.numpy(), atol=1e-6)
    assert (frame_mean[:, 0] < frame_mean[:, -1]).all()


@pytest.mark.parametrize('dtype', list(DTYPES))
def test_random_grayscale(clips, dtype):
    xj, xt = pair(clips[0], dtype)
    key = jax.random.PRNGKey(4)
    got = P.random_grayscale_video(xt, draws.gray(key, B, 0.5))
    assert_close(got, ncthw(J.random_grayscale_video(key, xj, p=0.5)), dtype)


@pytest.mark.parametrize('dtype', list(DTYPES))
@pytest.mark.parametrize('img_size', [32, 112])
def test_gaussian_blur_reflect(clips, dtype, img_size):
    """Radius 3 (img_size 32) and 11 (112) on 32x32 clips, where the
    reflect borders reach 1 and 5 pixels in."""
    assert P.blur_radius(img_size) == {32: 3, 112: 11}[img_size]
    xj, xt = pair(clips[0], dtype)
    key = jax.random.PRNGKey(5)
    params = draws.blur(key, B, p=0.75)
    assert params['sigma'].dim() == 0
    want = J.gaussian_blur_video(key, xj, img_size=img_size, p=0.75)
    assert_close(P.gaussian_blur_video(xt, params, img_size=img_size),
                 ncthw(want), dtype)


@pytest.mark.parametrize('dtype', list(DTYPES))
def test_normalize_and_flip(clips, dtype):
    xj, xt = pair(clips[0], dtype)
    assert_close(P.normalize_video(xt), ncthw(J.normalize_video(xj)), dtype)
    mask = np.array([True, False, True, False])
    assert_close(P.hflip_video(xt, torch.from_numpy(mask)),
                 ncthw(J.hflip_video(xj, jnp.asarray(mask))), dtype)


@pytest.mark.parametrize('dtype', list(DTYPES))
def test_strong_aug(clips, dtype):
    xj, xt = pair(clips[0], dtype)
    key = jax.random.PRNGKey(6)
    for per_frame in (True, False):
        got = P.strong_aug(xt, draws.strong(key, B, T, per_frame), HW)
        want = J.strong_aug(key, xj, HW, per_frame_params=per_frame)
        assert_close(got, ncthw(want), dtype)


# ---------------------------------------------------------- aug classes
V5_CASES = {
    'flagship': dict(sync_level=('batch', 'batch'), weak_aug=(False, False),
                     visualize=True),
    'no_visualize': dict(visualize=False),
    'normalize_flow': dict(normalize_flow=True),
    'weak_k_params_q': dict(weak_aug=(False, True),
                            sync_level=('params', 'batch')),
    'no_flip': dict(flip_transform=None),
}


def _aux(flows, dtype, boxes=True):
    """The flow pair (and boxes) as JAX and torch aux_info."""
    (fqj, fqt), (fkj, fkt) = (pair(f, dtype) for f in flows)
    aux_j = {'flow_imgs_q': fqj, 'flow_imgs_k': fkj}
    aux_t = {'flow_imgs_q': fqt, 'flow_imgs_k': fkt}
    if boxes:
        rng = np.random.default_rng(7)
        for s in ('_q', '_k'):
            bx = rng.uniform(0, 112, size=(B, 3, 8)).astype(np.float32)
            aux_j['gt_bboxes' + s] = jnp.asarray(bx)
            aux_t['gt_bboxes' + s] = torch.from_numpy(bx)
    return aux_j, aux_t


def _check_class(jaug, taug, clips, flows, dtype, key, flow_step=WHEEL_STEP):
    (qj, qt), (kj, kt) = (pair(c, dtype) for c in clips)
    aux_j, aux_t = _aux(flows, dtype)
    want_q, want_k, want_aux = jaug(key, qj, kj, aux_j)
    params = draws.sync_v5(taug, key, B, T)
    got_q, got_k, got_aux = taug.apply(qt, kt, aux_t, params)
    assert_close(got_q, ncthw(want_q), dtype)
    assert_close(got_k, ncthw(want_k), dtype)
    assert sorted(got_aux) == sorted(want_aux)
    for name in ('flow_imgs_q', 'flow_imgs_k'):
        assert got_aux[name].dtype == qt.dtype
        assert_wheel_close(got_aux[name], ncthw(want_aux[name]), flow_step)
    for name in ('gt_bboxes_q', 'gt_bboxes_k'):
        np.testing.assert_array_equal(got_aux[name].numpy(),
                                      np.asarray(want_aux[name]))
    return params, got_aux


@pytest.mark.parametrize('dtype', list(DTYPES))
@pytest.mark.parametrize('case', list(V5_CASES))
def test_sync_v5(clips, flows, dtype, case):
    cfg = dict(V5_CASES[case], crop_size=HW, t=(T, T))
    jaug = J.SyncMoCoAugmentV5(**cfg)
    taug = build_ssl_aug(dict(cfg, type='SyncMoCoAugmentV5'))
    step = WHEEL_STEP / 0.224 if cfg.get('normalize_flow') else WHEEL_STEP
    params, aux = _check_class(jaug, taug, clips, flows, dtype,
                               jax.random.PRNGKey(20), step)
    want_ch = 3 if cfg.get('visualize', True) else 2
    assert aux['flow_imgs_q'].shape[1] == want_ch
    if case == 'no_flip':
        assert not params['q']['flip'].any()
    if case == 'weak_k_params_q':
        assert params['k']['strong'] is None
        hue = params['q']['strong']['jitter']['hue']
        assert (hue == hue[:, :1]).all()


@pytest.mark.parametrize('dtype', list(DTYPES))
@pytest.mark.parametrize('name', ['SyncMoCoAugmentV3', 'SyncMoCoAugmentV2'])
def test_sync_v3_v2(clips, flows, dtype, name):
    jaug = getattr(J, name)(crop_size=HW)
    taug = build_ssl_aug(dict(type=name, crop_size=HW))
    _, aux = _check_class(jaug, taug, clips, flows, dtype,
                          jax.random.PRNGKey(21))
    assert aux['flow_imgs_q'].shape[1] == (3 if name.endswith('3') else 2)


@pytest.mark.parametrize('pool', ['max', 'avg'])
def test_sync_v4_motion_maps(clips, pool):
    """Motion maps at 30x45 flows (neither a multiple of 7), flipped with
    the clip; the rest as V3."""
    rng = np.random.default_rng(8)
    flows = [rng.normal(size=(B, 2, T, 30, 45)).astype(np.float32)
             for _ in range(2)]
    jaug = J.SyncMoCoAugmentV4(crop_size=HW, motion_pool=pool)
    taug = build_ssl_aug(dict(type='SyncMoCoAugmentV4', crop_size=HW,
                              motion_pool=pool))
    key = jax.random.PRNGKey(22)
    (qj, qt), (kj, kt) = (pair(c, 'float32') for c in clips)
    aux_j, aux_t = _aux(flows, 'float32', boxes=False)
    want_q, _, want_aux = jaug(key, qj, kj, aux_j)
    params = draws.sync_v5(taug, key, B, T)
    got_q, _, got_aux = taug.apply(qt, kt, aux_t, params)
    assert_close(got_q, ncthw(want_q), 'float32')
    for s in ('_q', '_k'):
        mm = got_aux['motion_maps' + s]
        assert mm.shape == (B, 1, T, 30, 45)
        np.testing.assert_allclose(mm.numpy(),
                                   ncthw(want_aux['motion_maps' + s]),
                                   atol=1e-6, rtol=0)
        assert_wheel_close(got_aux['flow_imgs' + s],
                           ncthw(want_aux['flow_imgs' + s]))
    assert params['q']['flip'].any() and not params['q']['flip'].all()


@pytest.mark.parametrize('pool', ['max', 'avg'])
def test_motion_map_calculator(pool):
    rng = np.random.default_rng(9)
    f = rng.normal(size=(2, 2, 3, 23, 36)).astype(np.float32)
    want = JMotion(pool)(jnp.asarray(nthwc(f)))
    got = MotionMapCalculator(pool)(torch.from_numpy(f))
    np.testing.assert_allclose(got.numpy(), ncthw(want), atol=1e-6, rtol=0)
    assert float(got.amax()) <= 1.0


def test_motion_map_refuses_bf16_as_jax_does():
    f = np.zeros((1, 2, 2, 8, 8), np.float32)
    with pytest.raises(TypeError):
        JMotion()(jnp.asarray(nthwc(f)).astype(jnp.bfloat16))
    with pytest.raises(TypeError):
        MotionMapCalculator()(torch.from_numpy(f).bfloat16())


@pytest.mark.parametrize('dtype', list(DTYPES))
@pytest.mark.parametrize('name', ['MoCoAugment', 'MoCoAugmentV2'])
def test_moco_augment(clips, dtype, name):
    """Per-frame draws through the (B*T, 1, ...) reshape, for a pair and
    for q alone."""
    jaug = getattr(J, name)(crop_size=HW)
    taug = build_ssl_aug(dict(type=name, crop_size=HW))
    per_clip = (draws.moco_clips if name == 'MoCoAugment'
                else draws.moco_v2_clips)
    (qj, qt), (kj, kt) = (pair(c, dtype) for c in clips)
    key = jax.random.PRNGKey(23)
    want_q, want_k, _ = jaug(key, qj, kj, {})
    got_q, got_k, _ = taug.apply(qt, kt, {},
                                 draws.moco(per_clip, key, B * T))
    assert_close(got_q, ncthw(want_q), dtype)
    assert_close(got_k, ncthw(want_k), dtype)
    alone = taug.apply(qt, None, None,
                       draws.moco(per_clip, key, B * T, pair=False))
    assert_close(alone, ncthw(jaug(key, qj)), dtype)


def test_identity_aug():
    aug = build_ssl_aug(dict(type='IdentityAug'))
    x, y = torch.zeros(1), torch.ones(1)
    gen = torch.Generator().manual_seed(0)
    assert aug(gen, x) is x
    assert aug(gen, x, y, {'a': 1}) == (x, y, {'a': 1})


def test_sync_level_refused():
    with pytest.raises(AssertionError):
        build_ssl_aug(dict(type='SyncMoCoAugmentV5', crop_size=HW,
                           sync_level='frame'))
    with pytest.raises(AssertionError):
        build_ssl_aug(dict(type='SyncMoCoAugmentV3', crop_size=HW,
                           sync_level=('batch', 'clip')))


# ------------------------------------------------------------------ draws
def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def test_jitter_draw_shapes_ranges_and_broadcast():
    for per_frame in (True, False):
        p = P.draw_color_jitter(_gen(), 64, T, per_frame_params=per_frame)
        assert p['apply'].shape == (64,) and p['apply'].dtype == torch.bool
        for name, lo, hi in (('brightness', 0.6, 1.4), ('contrast', 0.6, 1.4),
                             ('saturation', 0.6, 1.4), ('hue', -0.1, 0.1)):
            x = p[name]
            assert x.shape == (64, T) and x.dtype == torch.float32
            assert float(x.min()) >= lo and float(x.max()) <= hi
            assert bool((x == x[:, :1]).all()) is not per_frame
    assert P.draw_color_jitter(_gen(), 4, T, hue=0)['hue'] is None


def test_blur_and_strong_draws():
    p = P.draw_gaussian_blur(_gen(), 16)
    assert p['sigma'].shape == () and 0.1 <= float(p['sigma']) <= 2.0
    s = P.draw_strong_aug(_gen(), 16, T)
    assert sorted(s) == ['blur', 'gray', 'jitter']
    aug = P.SyncMoCoAugmentV5(crop_size=HW, weak_aug=(True, False))
    x = torch.zeros(16, 3, T, 4, 4)
    d = aug.draw(_gen(), x, x)
    assert d['q']['strong'] is None and d['k']['strong'] is not None
    assert d['q']['flip'].shape == (16,)


def _rates(d):
    return {'flip': d['flip'].float().mean(),
            'jitter': d['strong']['jitter']['apply'].float().mean(),
            'gray': d['strong']['gray']['apply'].float().mean(),
            'blur': d['strong']['blur']['apply'].float().mean()}


def test_draw_rates_at_b4096():
    """Each apply decision's rate within 4 sigma of its p at B=4096."""
    n = 4096
    aug = P.SyncMoCoAugmentV5(crop_size=HW)
    x = torch.zeros(n, 3, 2, 1, 1)
    d = aug.draw(_gen(1), x, x)
    want = dict(flip=0.5, jitter=0.8, gray=0.2, blur=0.5)
    for branch in 'qk':
        for name, rate in _rates(d[branch]).items():
            p = want[name]
            assert abs(float(rate) - p) <= 4 * math.sqrt(p * (1 - p) / n), \
                (branch, name, float(rate))


def test_same_seed_same_draws():
    aug = P.SyncMoCoAugmentV5(crop_size=HW)
    x = torch.zeros(8, 3, T, 1, 1)
    a, b, c = (aug.draw(_gen(s), x, x) for s in (3, 3, 4))

    def flat(d):
        out = []
        for branch in 'qk':
            out.append(d[branch]['flip'].float())
            for part in d[branch]['strong'].values():
                out += [v.float().reshape(-1) for v in part.values()]
        return torch.cat([o.reshape(-1) for o in out])
    assert torch.equal(flat(a), flat(b))
    assert not torch.equal(flat(a), flat(c))
