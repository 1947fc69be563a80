"""The port's MDS tool (``mscl_torch/tools/generate_mcl_samples.py``)
against ``tools/ssl/generate_mcl_samples.py``: each flow's weight map and
each video's ``chosen_idx`` for every weight type (motion_map, attention_map
with max and sum, rgb_map plain and attention-weighted) and pool type, on
``.npy`` and ``.np4`` flows; then both CLIs end to end on one annotation
pickle, the port's with its process pool too."""
import importlib.util
import os
import pickle
import sys

import numpy as np
import pytest

from mscl_tpu.utils.np4 import np4_encode
from mscl_torch.tools import generate_mcl_samples as tmds

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = [('motion_map', 'none'), ('attention_map', 'max'),
           ('attention_map', 'sum'), ('rgb_map', 'none'), ('rgb_map', 'max')]


@pytest.fixture(scope='module')
def jmds():
    """The JAX tool, loaded from its file (tools/ is not a package)."""
    spec = importlib.util.spec_from_file_location(
        'jax_generate_mcl_samples',
        os.path.join(ROOT, 'tools', 'ssl', 'generate_mcl_samples.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _flows(root, ext, n_videos=3, n_flows=(13, 9, 20), hw=(60, 87)):
    """Videos of smooth flows with a moving burst of motion (so the clip
    weights differ), as .npy or .np4 blobs; the annotations."""
    rng = np.random.default_rng(5)
    h, w = hw
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    annos = []
    for v in range(n_videos):
        paths = []
        for i in range(n_flows[v]):
            amp = 1 + 4 * np.exp(-((i - n_flows[v] / 2) / 3) ** 2)
            flow = np.stack([amp * np.sin(xx / 9 + i + v),
                             amp * np.cos(yy / 7 - i)], -1)
            flow += rng.normal(scale=0.3, size=flow.shape)
            flow = flow.astype(np.float32)
            paths.append(os.path.join(root, f'v{v}_flow_{i:05d}.{ext}'))
            if ext == 'npy':
                np.save(paths[-1], flow)
            else:
                with open(paths[-1], 'wb') as f:
                    f.write(np4_encode(flow))
        annos.append(dict(frames=[f'v{v}/img_{i:05d}.jpg'
                                  for i in range(2 * n_flows[v] + 8)],
                          enc_flows=paths, label=v, video_name=f'v{v}'))
    return annos


@pytest.mark.parametrize('ext', ['npy', 'np4'])
@pytest.mark.parametrize('weight,att', WEIGHTS)
def test_weight_maps_and_chosen_idx_match(jmds, tmp_path, ext, weight, att):
    annos = _flows(str(tmp_path), ext)
    for path in annos[0]['enc_flows'][:3]:
        flow = tmds.load_flow(path)
        np.testing.assert_array_equal(flow, jmds._load_flow(path))
        got = tmds.process_single_flow(flow, weight, att)
        want = jmds.process_single_flow(flow, weight, att)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    chosen = 0
    for pool in ('avg', 'max'):
        for clip_len, clip_stride in ((8, 4), (3, 2)):
            kw = dict(weight_type=weight, att_type=att, pool_type=pool,
                      clip_len=clip_len, clip_stride=clip_stride)
            for meta in annos:
                got = tmds.process_video(meta, **kw)
                want = jmds.process_video(meta, **kw)
                assert got == want
                assert len(got['chosen_idx']) < len(meta['enc_flows'])
                chosen += len(got['chosen_idx'])
    assert chosen > 0


def test_clis_write_the_same_pickle(jmds, tmp_path, monkeypatch, capsys):
    annos = _flows(str(tmp_path), 'np4')
    anno_pkl = str(tmp_path / 'annos.pkl')
    with open(anno_pkl, 'wb') as f:
        pickle.dump(annos, f)
    flags = ['--weight-type', 'attention_map', '--att-type', 'max',
             '--pool-type', 'max', '--clip-len', '4', '--clip-stride', '2']
    monkeypatch.setattr(sys, 'argv', ['generate_mcl_samples.py', anno_pkl,
                                      str(tmp_path / 'j.pkl'), *flags])
    jmds.main()
    for workers in ('1', '2'):
        out = tmds.main([anno_pkl, str(tmp_path / f't{workers}.pkl'),
                         *flags, '--num-workers', workers])
        with open(tmp_path / f't{workers}.pkl', 'rb') as f:
            assert pickle.load(f) == out
    printed = capsys.readouterr().out.splitlines()
    assert printed[0] == printed[1] == printed[2]
    with open(tmp_path / 'j.pkl', 'rb') as f:
        want = pickle.load(f)
    assert out == want
    assert [sorted(m) for m in out] == [sorted([*m, 'chosen_idx'])
                                        for m in annos]
