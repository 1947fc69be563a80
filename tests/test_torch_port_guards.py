"""Guards on the PyTorch port: it imports neither JAX nor mscl_tpu, runs on
the card unless told otherwise, never falls back from a kernel to its plain
version on a CUDA tensor, and its copy of the flagship recipe agrees with
the config file."""
import os
import subprocess
import sys

import pytest
import torch

from mscl_torch.apis import (build_model_from_cfg, flagship_model_cfg,
                             load_flagship_config)
from mscl_torch.ops import cuda_build
from mscl_torch.ops import decayed_infonce as di

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_no_jax_and_no_mscl_tpu():
    code = (
        'import pkgutil, importlib, sys\n'
        'import mscl_torch\n'
        'for m in pkgutil.walk_packages(mscl_torch.__path__, "mscl_torch."):\n'
        '    importlib.import_module(m.name)\n'
        'import chip_smoke\n'
        'bad = sorted(m for m in sys.modules if m.split(".")[0] in\n'
        '             ("jax", "jaxlib", "flax", "optax", "mscl_tpu"))\n'
        'print(len([m for m in sys.modules if m.startswith("mscl_torch.")]))\n'
        'assert not bad, bad\n')
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 20


def test_build_model_needs_the_card_unless_told():
    if torch.cuda.is_available():
        pytest.skip('this box has a CUDA device')
    with pytest.raises(RuntimeError, match='CUDA'):
        build_model_from_cfg(flagship_model_cfg(K=64, dim=16))


@pytest.mark.parametrize('fn', ['l_neg', 'dq'])
def test_cuda_path_raises_without_kernel(monkeypatch, fn):
    """A tensor taken for a CUDA one, with no kernel library to be had,
    raises; the plain version is never called in its place."""
    def no_library(name):
        raise RuntimeError(f'no kernel library {name}')

    def plain_called(*args):
        raise AssertionError('fell back to the plain version')

    monkeypatch.setattr(di, '_on_cuda', lambda t: True)
    monkeypatch.setattr(di, '_lib', lambda: cuda_build.load('missing'))
    monkeypatch.setattr(cuda_build, 'load', no_library)
    monkeypatch.setattr(di, 'l_neg_plain', plain_called)
    monkeypatch.setattr(di, 'dq_plain', plain_called)
    queue, decay = torch.zeros(8, 256), torch.ones(256)
    with pytest.raises(RuntimeError, match='no kernel library'):
        if fn == 'l_neg':
            di.l_neg(torch.zeros(2, 8), queue, decay)
        else:
            di.dq(torch.zeros(2, 256), queue, decay)
    assert di.l_neg.launches == 0 and di.dq.launches == 0


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


def test_flagship_copy_matches_config_file():
    cfg = load_flagship_config()
    model = cfg.model.to_dict()
    assert model['aug'] == dict(type='IdentityAug')
    copy = flagship_model_cfg(max_iters=219136 * 400)

    def norm(x):
        if isinstance(x, dict):
            return {k: norm(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [norm(v) for v in x]
        return x
    assert norm(model) == norm(copy)
