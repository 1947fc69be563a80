"""Guards on the PyTorch port: it imports neither JAX nor mscl_tpu (nor cv2
or msgpack; the README's data prep and training path needs neither), runs
on the card unless told otherwise (its models, flow extraction,
train_model, the training, test and retrieval CLIs, the recognizer loader
and retrieval's product), never falls back from a kernel to its plain
version on a CUDA tensor, refuses what it cannot read (a JAX ``.ckpt``, a
video file) with a way forward, and its copy of the flagship recipe agrees
with the config file."""
import os
import subprocess
import sys

import pytest
import torch

from mscl_torch.apis import (FLAGSHIP_CONFIG, apply_ssl_pretrain,
                             build_model_from_cfg, flagship_model_cfg,
                             inference_recognizer, init_recognizer,
                             load_flagship_config, retrieval_recall,
                             train_model)
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
        ' "mscl_torch.utils.flow_viz", "mscl_torch.utils.image_io",'
        ' "mscl_torch.datasets.loader", "mscl_torch.datasets.file_dataset",'
        ' "mscl_torch.datasets.pipelines.loading",'
        ' "mscl_torch.datasets.pipelines.loading_mscl",'
        ' "mscl_torch.datasets.pipelines.moco_augmentations",'
        ' "mscl_torch.datasets.pipelines.transforms_motion",'
        ' "mscl_torch.datasets.pipelines.formatting",'
        ' "mscl_torch.core.checkpoint", "mscl_torch.tools.train",'
        ' "mscl_torch.tools.test", "mscl_torch.tools.test_retrieval",'
        ' "mscl_torch.apis.inference", "mscl_torch.core.evaluation.accuracy",'
        ' "mscl_torch.core.evaluation.visualizer",'
        ' "mscl_torch.models.heads.i3d_head",'
        ' "mscl_torch.models.recognizers.recognizer3d",'
        ' "mscl_torch.parallel", "mscl_torch.parallel.dist",'
        ' "mscl_torch.parallel.launch", "mscl_torch.utils.jpeg",'
        ' "mscl_torch.utils.np4", "mscl_torch.tools.generate_mcl_samples",'
        ' "mscl_torch.tools.ablation_ordering",'
        ' "mscl_torch.tools.shufflebn_ab",'
        ' "mscl_torch.tools.ablation_summary",'
        ' "mscl_torch.models.heads.local_align_heads"}'
        ' <= set(sys.modules)\n')
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 20


def test_readme_data_prep_needs_neither_cv2_nor_msgpack(tmp_path):
    """The README's chain as the card's machine runs it, where cv2 and
    msgpack are not installed (both blocked in a subprocess), at tiny
    sizes on the CPU: JPEG frames -> the extraction CLI -> the MDS CLI ->
    the flagship's train pipeline reading one batch from JPEG frames,
    .np4 flows and the MDS chosen_idx."""
    import cv2
    import numpy as np
    rng = np.random.default_rng(0)
    base = rng.integers(0, 256, (64, 84, 3), dtype=np.uint8)
    for v in range(2):
        os.makedirs(tmp_path / 'frames' / f'video_{v}')
        for i in range(24):
            cv2.imwrite(str(tmp_path / 'frames' / f'video_{v}' /
                            f'img_{i:05d}.jpg'),
                        base[i % 16:i % 16 + 48, (i + v) % 20:
                             (i + v) % 20 + 64])
    code = f"""
import copy, pickle, sys
sys.modules['cv2'] = sys.modules['msgpack'] = None
import numpy as np, torch
torch.set_num_threads(1)
from mscl_torch.apis import flow_extraction
from mscl_torch.tools import generate_mcl_samples
from mscl_torch.config import Config
from mscl_torch.apis import FLAGSHIP_CONFIG
from mscl_torch.datasets import build_dataset, loader
root = {str(tmp_path)!r}
flow_extraction.main([root + '/frames', root + '/flows', '--anno-out',
                      root + '/annos.pkl', '--scale-hw', '24', '32',
                      '--iters', '1', '--batch-size', '8', '--device',
                      'cpu'])
out = generate_mcl_samples.main([root + '/annos.pkl', root + '/mds.pkl',
                                 '--weight-type', 'motion_map'])
assert [len(m['enc_flows']) for m in out] == [8, 8], out
assert all(0 < len(m['chosen_idx']) < 8 for m in out), out
pipeline = Config.fromfile(FLAGSHIP_CONFIG).to_dict()['train_pipeline']
for t in pipeline:
    if t['type'] in ('MoCoDecodePlan', 'MoCoResize'):
        t['target' if t['type'] == 'MoCoDecodePlan' else 'scale'] = (16, 16)
ds = build_dataset(dict(type='FileRawframeDataset', pkl_path=root +
                        '/mds.pkl', pipeline=pipeline,
                        extra_keys=['nids_flow', 'chosen_idx']))
batch = next(iter(loader.NumpyLoader(ds, 2, seed=0)))
assert [x.shape for x in batch['imgs']] == [(2, 3, 8, 16, 16)] * 2
assert [x.shape for x in batch['flow_imgs']] == [(2, 2, 16, 16, 16)] * 2
assert all(np.isfinite(x).all() for x in batch['flow_imgs'])
assert sys.modules['cv2'] is None and sys.modules['msgpack'] is None
print('ok')
"""
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split()[-1] == 'ok'


def test_build_model_needs_the_card_unless_told():
    if torch.cuda.is_available():
        pytest.skip('this box has a CUDA device')
    with pytest.raises(RuntimeError, match='CUDA'):
        build_model_from_cfg(flagship_model_cfg(K=64, dim=16))


def test_train_model_needs_the_card_unless_told():
    if torch.cuda.is_available():
        pytest.skip('this box has a CUDA device')
    with pytest.raises(RuntimeError, match='CUDA'):
        train_model(load_flagship_config(), seed=0)


def test_train_cli_needs_the_card_unless_told(tmp_path):
    if torch.cuda.is_available():
        pytest.skip('this box has a CUDA device')
    out = subprocess.run(
        [sys.executable, '-m', 'mscl_torch.tools.train', FLAGSHIP_CONFIG,
         '--work-dir', str(tmp_path)], cwd=ROOT, capture_output=True,
        text=True, timeout=300)
    assert out.returncode != 0
    assert "pass device='cpu'" in out.stderr
    assert not (tmp_path / 'log.json').exists()


def test_ranks_need_the_card_unless_told(tmp_path):
    """A rank takes a card unless told otherwise, and the CLI's ranks
    (NCCL's one a card) need cards: none falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip('this box has a CUDA device')
    from mscl_torch.parallel import dist
    from mscl_torch.tools import train as train_cli
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dist.init_distributed(init_method='tcp://127.0.0.1:1', world=1,
                              rank_=0)
    assert not dist.is_distributed()
    with pytest.raises(SystemExit, match='visible cards'):
        train_cli.main([FLAGSHIP_CONFIG, '--num-devices', '2',
                        '--work-dir', str(tmp_path)])
    assert not list(tmp_path.iterdir())


@pytest.mark.parametrize('tool', ['test', 'test_retrieval'])
def test_eval_clis_need_the_card_unless_told(tmp_path, tool):
    if torch.cuda.is_available():
        pytest.skip('this box has a CUDA device')
    cfg = tmp_path / 'cfg.py'
    cfg.write_text("model = dict(type='Recognizer3D', backbone=dict("
                   "type='torchvision.r3d_18'))\n"
                   "data = dict(videos_per_gpu=1, train={}, test={})\n")
    args = [str(cfg)] + (['unused.pth'] if tool == 'test' else [])
    out = subprocess.run(
        [sys.executable, '-m', f'mscl_torch.tools.{tool}', *args,
         '--out', str(tmp_path / 'out.json')], cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "pass device='cpu'" in out.stderr
    assert not (tmp_path / 'out.json').exists()


@pytest.mark.parametrize('tool', ['ablation_ordering', 'shufflebn_ab'])
def test_ablation_tools_need_the_card_unless_told(tmp_path, tool):
    if torch.cuda.is_available():
        pytest.skip('this box has a CUDA device')
    args = (['--arm', 'moco', '--out-dir', str(tmp_path)]
            if tool == 'ablation_ordering' else
            ['--out', str(tmp_path / 'ab.json')])
    out = subprocess.run(
        [sys.executable, '-m', f'mscl_torch.tools.{tool}', '--steps', '1',
         *args], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "pass device='cpu'" in out.stderr
    assert not list(tmp_path.iterdir())


def test_inference_needs_the_card_unless_told():
    if torch.cuda.is_available():
        pytest.skip('this box has a CUDA device')
    from mscl_torch.config import Config
    cfg = Config.fromdict(dict(model=dict(
        type='Recognizer3D', backbone=dict(type='torchvision.r3d_18'))))
    with pytest.raises(RuntimeError, match='CUDA'):
        init_recognizer(cfg)
    feats = torch.randn(4, 8).numpy()
    with pytest.raises(RuntimeError, match='CUDA'):
        retrieval_recall(feats, [0, 1, 0, 1], feats, [0, 1, 0, 1])


def test_unreadable_inputs_are_refused(tmp_path):
    """A JAX msgpack checkpoint (msgpack is absent where the card is) and a
    video file (cv2 would decode it) are refused with what to do instead."""
    with pytest.raises(NotImplementedError, match='jax_to_state_dict'):
        apply_ssl_pretrain(None, dict(pretrained=dict(
            filename=str(tmp_path / 'epoch_400.ckpt'))))
    video = tmp_path / 'clip.mp4'
    video.write_bytes(b'')
    with pytest.raises(NotImplementedError, match='extract its frames'):
        inference_recognizer(None, None, str(video))


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
