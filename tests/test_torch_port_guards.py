"""Guards on the PyTorch port: it imports neither JAX nor mscl_tpu (nor cv2
or msgpack, which only the functions that read frames and pack blobs import),
runs on the card unless told otherwise, never falls back from a kernel to its
plain version on a CUDA tensor, and its copy of the flagship recipe agrees
with the config file."""
import os
import subprocess
import sys

import pytest
import torch

from mscl_torch.apis import (build_model_from_cfg, flagship_model_cfg,
                             load_flagship_config)
from mscl_torch.apis.flow_extraction import make_raft_fn
from mscl_torch.ops import corr_lookup as cl
from mscl_torch.ops import cuda_build
from mscl_torch.ops import decayed_infonce as di
from mscl_torch.ops import mxu_fill as mf

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_no_jax_and_no_mscl_tpu():
    code = (
        'import pkgutil, importlib, sys\n'
        'import mscl_torch\n'
        'for m in pkgutil.walk_packages(mscl_torch.__path__, "mscl_torch."):\n'
        '    importlib.import_module(m.name)\n'
        'import chip_smoke\n'
        'bad = sorted(m for m in sys.modules if m.split(".")[0] in\n'
        '             ("jax", "jaxlib", "flax", "optax", "mscl_tpu", "cv2",\n'
        '                               "msgpack"))\n'
        'print(len([m for m in sys.modules if m.startswith("mscl_torch.")]))\n'
        'assert not bad, bad\n'
        'assert {"mscl_torch.tools.bench_mxu_fill", "mscl_torch.ops.mxu_fill",'
        ' "mscl_torch.models.common", "mscl_torch.models.common.ssl_aug",'
        ' "mscl_torch.models.common.motion_map",'
        ' "mscl_torch.utils.flow_viz"} <= set(sys.modules)\n')
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 20


def test_build_model_needs_the_card_unless_told():
    if torch.cuda.is_available():
        pytest.skip('this box has a CUDA device')
    with pytest.raises(RuntimeError, match='CUDA'):
        build_model_from_cfg(flagship_model_cfg(K=64, dim=16))


def test_flow_extraction_needs_the_card_unless_told():
    if torch.cuda.is_available():
        pytest.skip('this box has a CUDA device')
    with pytest.raises(RuntimeError, match='CUDA'):
        make_raft_fn(None, iters=1)


@pytest.mark.parametrize('fn', ['l_neg', 'dq', 'corr_lookup', 'probe',
                                'probe_carry', 'probe_bigdot', 'probe_imcat',
                                'probe_paircat'])
def test_cuda_path_raises_without_kernel(monkeypatch, fn):
    """A tensor taken for a CUDA one, with no kernel library to be had,
    raises; the plain version is never called in its place."""
    def no_library(name):
        raise RuntimeError(f'no kernel library {name}')

    def plain_called(*args):
        raise AssertionError('fell back to the plain version')

    for mod in (di, cl, mf):
        monkeypatch.setattr(mod, '_on_cuda', lambda t: True)
        monkeypatch.setattr(mod, '_lib', lambda: cuda_build.load('missing'))
    monkeypatch.setattr(cuda_build, 'load', no_library)
    monkeypatch.setattr(di, 'l_neg_plain', plain_called)
    monkeypatch.setattr(di, 'dq_plain', plain_called)
    monkeypatch.setattr(cl, 'corr_lookup_plain', plain_called)
    for plain in mf.PLAIN_VERSIONS.values():
        monkeypatch.setattr(mf, plain.__name__, plain_called)
    queue, decay = torch.zeros(8, 256), torch.ones(256)
    counters = [di.l_neg, di.dq, cl.corr_lookup, *mf.ENTRY_POINTS.values()]
    launches = [f.launches for f in counters]
    with pytest.raises(RuntimeError, match='no kernel library'):
        if fn == 'l_neg':
            di.l_neg(torch.zeros(2, 8), queue, decay)
        elif fn == 'dq':
            di.dq(torch.zeros(2, 256), queue, decay)
        elif fn == 'corr_lookup':
            cl.corr_lookup(*_corr_operands())
        else:
            kind = 'probe' if fn == 'probe' else fn[len('probe_'):]
            x, w, shape = _probe_operands(kind)
            getattr(mf, fn)(x, w, **shape)
    assert [f.launches for f in counters] == launches


@pytest.mark.parametrize('case', ['q_width', 'g_width', 'device', 'dtype',
                                  'strided', 'decay_len'])
def test_cuda_path_refuses_what_the_kernel_cannot_take(monkeypatch, case):
    """Operands that would make a kernel read out of bounds or a host
    pointer are refused before any launch."""
    def no_launch():
        raise AssertionError('reached the kernel library')

    monkeypatch.setattr(di, '_on_cuda', lambda t: True)
    monkeypatch.setattr(di, '_lib', no_launch)
    q, queue, decay = torch.zeros(2, 8), torch.zeros(8, 256), torch.ones(256)
    g = torch.zeros(2, 256)
    if case == 'q_width':
        q = torch.zeros(2, 7)
    elif case == 'g_width':
        g = torch.zeros(2, 128)
    elif case == 'device':
        queue = torch.zeros(8, 256, device='meta')
    elif case == 'dtype':
        q = q.double()
    elif case == 'strided':
        queue = torch.zeros(256, 8).T
    else:
        decay = torch.ones(128)
    with pytest.raises((ValueError, TypeError)):
        if case == 'g_width':
            di.dq(g, queue, decay)
        else:
            di.l_neg(q, queue, decay)


def _corr_operands(n=2, h=6, w=10, c=32):
    return (torch.zeros(n, h, w, c), torch.zeros(n, h, w, c),
            torch.zeros(n, h, w, 2), 2, 2)


@pytest.mark.parametrize('case', ['f1_rank', 'coords_shape', 'c_ragged',
                                  'c_wide', 'radius', 'levels', 'pyramid',
                                  'device', 'dtype', 'strided', 'grad'])
def test_corr_lookup_refuses_what_the_kernel_cannot_take(monkeypatch, case):
    """Operands the lookup kernel would read out of bounds, misread or
    leave without a gradient are refused before any launch."""
    def no_launch():
        raise AssertionError('reached the kernel library')

    monkeypatch.setattr(cl, '_on_cuda', lambda t: True)
    monkeypatch.setattr(cl, '_lib', no_launch)
    f1, f2, coords, levels, radius = _corr_operands()
    if case == 'f1_rank':
        f1 = f1[0]
    elif case == 'coords_shape':
        coords = torch.zeros(2, 6, 10, 3)
    elif case == 'c_ragged':
        f1, f2 = torch.zeros(2, 6, 10, 30), torch.zeros(2, 6, 10, 30)
    elif case == 'c_wide':
        f1, f2 = torch.zeros(2, 6, 10, 260), torch.zeros(2, 6, 10, 260)
    elif case == 'radius':
        radius = cl.MAX_RADIUS + 1
    elif case == 'levels':
        f2 = cl.corr_pyramid(f2, 3)            # a pyramid of 3 levels, not 2
    elif case == 'pyramid':
        f2 = cl.corr_pyramid(torch.zeros(2, 6, 8, 32), levels)
    elif case == 'device':
        coords = torch.zeros(2, 6, 10, 2, device='meta')
    elif case == 'dtype':
        coords = coords.double()
    elif case == 'strided':
        f1 = torch.zeros(2, 6, 32, 10).transpose(2, 3)
    else:
        f1.requires_grad_(True)
    with pytest.raises((ValueError, TypeError)):
        cl.corr_lookup(f1, f2, coords, levels, radius)


def _probe_operands(kind, m=40, k=64, n=64, inner=4, mt=20):
    """bf16 zeros of a probe's shapes, and its shape parameters."""
    shape = dict(m=m, k=k, n=n)
    if kind != 'bigdot':
        shape['inner'] = inner
    if kind == 'carry':
        shape['mt'] = mt
    x, w = mf._shapes(kind, **shape)
    return (torch.zeros(x, dtype=torch.bfloat16),
            torch.zeros(w, dtype=torch.bfloat16), shape)


@pytest.mark.parametrize('case', [
    'carry_m_mt', 'imcat_odd_inner', 'paircat_odd_inner', 'imcat_k',
    'probe_x_shape', 'paircat_w_shape', 'n', 'probe_depth', 'paircat_depth',
    'probe_k', 'carry_k', 'bigdot_k', 'imcat_kcat', 'imcat_depth', 'steps',
    'bigdot_units', 'imcat_units', 'device', 'dtype',
    'strided', 'unaligned'])
def test_mxu_fill_refuses_what_the_kernel_cannot_take(monkeypatch, case):
    """What the JAX probes assert (m % mt, an odd inner for imcat and
    paircat, imcat's k not a multiple of 64) and what the kernels cannot
    take (a k that is not a multiple of their 64-deep chunks, a tap deeper
    than 256) are refused before any launch."""
    def no_launch():
        raise AssertionError('reached the kernel library')

    monkeypatch.setattr(mf, '_on_cuda', lambda t: True)
    monkeypatch.setattr(mf, '_lib', no_launch)
    kind = case.split('_')[0] if case.split('_')[0] in mf.ENTRY_POINTS \
        else 'probe'
    size = dict(n=dict(n=96), probe_depth=dict(k=320),
                paircat_depth=dict(k=192), probe_k=dict(k=80),
                carry_k=dict(k=48), bigdot_k=dict(k=96),
                imcat_kcat=dict(k=128, inner=18),
                imcat_depth=dict(k=320, inner=2), bigdot_units=dict(m=3248),
                imcat_units=dict(m=3248)).get(case, {})
    x, w, shape = _probe_operands(kind, **size)
    steps = 1
    if case.endswith('odd_inner'):
        shape['inner'] = 3
    elif case == 'carry_m_mt':
        shape['mt'] = 16                                    # 40 % 16 != 0
    elif case == 'imcat_k':
        x = torch.zeros(48, 32, dtype=torch.bfloat16)
        w = torch.zeros(4 * 32, 64, dtype=torch.bfloat16)
        shape['k'] = 32
    elif case == 'probe_x_shape':
        x = torch.zeros(40, 64, dtype=torch.bfloat16)       # no halo rows
    elif case == 'paircat_w_shape':
        w = w.reshape(4, 64, 64)                            # taps, not pairs
    elif case == 'steps':
        steps = 0
    elif case.endswith('units'):
        # 26 tiles of 128 rows: more (step, tile) units than a launch takes
        steps = (2 ** 31 - 1) // 26 + 1
    elif case == 'device':
        w = torch.zeros(w.shape, dtype=torch.bfloat16, device='meta')
    elif case == 'dtype':
        x = x.float()
    elif case == 'strided':
        x = torch.zeros(x.shape[::-1], dtype=torch.bfloat16).T
    elif case == 'unaligned':
        x = torch.zeros(x.numel() + 1, dtype=torch.bfloat16)[1:].view(x.shape)
    with pytest.raises((ValueError, TypeError)):
        mf.ENTRY_POINTS[kind](x, w, steps=steps, **shape)


def test_flagship_copy_matches_config_file():
    cfg = load_flagship_config()
    model = cfg.model.to_dict()
    assert model['aug'] == dict(type='SyncMoCoAugmentV5', crop_size=112,
                                sync_level=('batch', 'batch'), t=(8, 8),
                                flow_suffix='flow_imgs',
                                weak_aug=(False, False), visualize=True)
    copy = flagship_model_cfg(max_iters=219136 * 400)

    def norm(x):
        if isinstance(x, dict):
            return {k: norm(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [norm(v) for v in x]
        return x
    assert norm(model) == norm(copy)
