"""The port's flow tools against the JAX package's, on the CPU, on the same
fixture data (JPEG frames, np4 flow blobs with moving squares):

- ``flow2img --with-bboxes``: the annotation pickle's keys, ``gt_bboxes``
  and statistics equal, and every ``imflows`` JPEG byte for byte the JAX
  tool's (cv2's encoder there, the port's here);
- ``visualize_samples``: the contact sheets byte for byte;
- ``vis_flow --resize``: RAFT from the same seeded weights (a ``.pth`` both
  packages load) within tests/test_torch_raft.py's tolerance; the flow
  images, ``bboxes.npy`` and the summary lines equal when the port renders
  JAX's own flows (flows an ulp apart may round to other pixels).
"""
import importlib.util
import os
import pickle
import runpy
import sys

import numpy as np
import pytest
import torch

from mscl_torch.flow.raft import build_raft
from mscl_torch.tools import flow2img, vis_flow, visualize_samples
from mscl_torch.utils.jpeg import encode_jpeg
from mscl_torch.utils.np4 import np4_encode

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLOW_HW = (48, 64)
RAFT_TOL = dict(rtol=1e-4, atol=1e-4)     # tests/test_torch_raft.py's


def _run_jax(script, argv):
    saved = sys.argv
    sys.argv = [script] + argv
    try:
        runpy.run_path(os.path.join(ROOT, script), run_name='__main__')
    finally:
        sys.argv = saved


def _flow(i, v):
    rng = np.random.default_rng(10 * v + i)
    f = rng.normal(scale=0.05, size=FLOW_HW + (2,)).astype(np.float32)
    y, x = 8 + 2 * i, 10 + 3 * i + 5 * v
    f[y:y + 20, x:x + 18] += np.float32([3.0 + v, -2.0])
    return f


@pytest.fixture(scope='module')
def data(tmp_path_factory):
    """Two videos of 20 JPEG frames (40x50) and 6 np4 flows (48x64)."""
    root = tmp_path_factory.mktemp('flow_tools')
    annos = []
    for v in range(2):
        vdir = root / f'video_{v}'
        vdir.mkdir()
        rng = np.random.default_rng(v)
        base = rng.integers(0, 256, (60, 80, 3), dtype=np.uint8)
        frames, flows = [], []
        for i in range(20):
            p = vdir / f'img_{i:05d}.jpg'
            p.write_bytes(encode_jpeg(base[i % 10:i % 10 + 40,
                                           i:i + 50]))
            frames.append(str(p))
        for i in range(6):
            p = vdir / f'flow_{i:05d}.np4'
            p.write_bytes(np4_encode(_flow(i, v)))
            flows.append(str(p))
        annos.append(dict(frames=frames, enc_flows=flows, label=v,
                          video_name=f'video_{v}'))
    pkl = root / 'annos.pkl'
    with open(pkl, 'wb') as f:
        pickle.dump(annos, f)
    return dict(root=root, pkl=str(pkl))


def _files(d):
    return {os.path.relpath(os.path.join(r, f), d):
            open(os.path.join(r, f), 'rb').read()
            for r, _, fs in os.walk(d) for f in fs}


def test_flow2img_matches_jax(data, tmp_path):
    outs = {}
    for who in ('jax', 'port'):
        argv = [data['pkl'], str(tmp_path / who), str(tmp_path / f'{who}.pkl'),
                '--with-bboxes']
        np.random.seed(3)
        if who == 'jax':
            _run_jax('tools/misc/flow2img.py', argv)
        else:
            flow2img.main(argv)
        with open(tmp_path / f'{who}.pkl', 'rb') as f:
            outs[who] = pickle.load(f)
    want, got = outs['jax'], outs['port']
    assert len(want) == len(got) == 2
    for a, b in zip(want, got):
        assert sorted(a) == sorted(b)
        assert [os.path.relpath(p, tmp_path / 'jax') for p in a['imflows']] \
            == [os.path.relpath(p, tmp_path / 'port') for p in b['imflows']]
        assert b['gt_bboxes'].dtype == np.float32
        assert b['gt_bboxes'].shape == (20, 4)
        np.testing.assert_array_equal(a['gt_bboxes'], b['gt_bboxes'])
        for k in ('bbox_freq', 'bbox_picked_freq', 'corner_bbox_freq'):
            assert a[k] == b[k], k
    jfiles, tfiles = _files(tmp_path / 'jax'), _files(tmp_path / 'port')
    assert len(tfiles) == 12 and jfiles == tfiles


def test_visualize_samples_matches_jax(data, tmp_path):
    argv = ['--num-videos', '2', '--frames-per-video', '3']
    _run_jax('tools/misc/visualize_samples.py',
             [data['pkl'], str(tmp_path / 'jax'), *argv])
    written = visualize_samples.main([data['pkl'], str(tmp_path / 'port'),
                                      *argv])
    assert len(written) == 2
    assert _files(tmp_path / 'jax') == _files(tmp_path / 'port')


@pytest.fixture(scope='module')
def raft_pth(tmp_path_factory):
    path = str(tmp_path_factory.mktemp('raft') / 'raft.pth')
    torch.save(build_raft(None, device='cpu', seed=0).state_dict(), path)
    return path


def test_vis_flow_matches_jax(data, raft_pth, tmp_path, monkeypatch,
                              capsys):
    frame_dir = str(data['root'] / 'video_0')
    spec = importlib.util.spec_from_file_location(
        'flow_extraction', os.path.join(ROOT, 'tools', 'misc',
                                        'flow_extraction.py'))
    jfe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jfe)
    jax_flows = []

    def recorded(make):
        def wrapped(*args, **kwargs):
            fn = make(*args, **kwargs)
            return lambda a, b: jax_flows.append(np.asarray(fn(a, b))) or \
                jax_flows[-1]
        return wrapped

    monkeypatch.setattr(jfe, 'make_raft_fn', recorded(jfe.make_raft_fn))
    monkeypatch.setitem(sys.modules, 'flow_extraction', jfe)
    argv = ['--weights', raft_pth, '--gap', '4', '--adjacent', '4',
            '--iters', '2', '--resize', '64', '64']
    np.random.seed(5)
    _run_jax('tools/vis_flow.py',
             [frame_dir, *argv, '--out-dir', str(tmp_path / 'jax')])
    jax_lines = capsys.readouterr().out.splitlines()

    port_flows = []
    real = vis_flow.make_raft_fn

    def port_raft(*args, **kwargs):
        fn = real(*args, **kwargs)

        def run(a, b):
            port_flows.append(fn(a, b))
            return jax_flows[0]         # render JAX's flows
        return run

    monkeypatch.setattr(vis_flow, 'make_raft_fn', port_raft)
    np.random.seed(5)
    flows, boxes = vis_flow.main([frame_dir, *argv, '--out-dir',
                                  str(tmp_path / 'port'), '--device', 'cpu'])
    port_lines = capsys.readouterr().out.splitlines()

    assert port_flows[0].shape == jax_flows[0].shape == (4, 64, 64, 2)
    np.testing.assert_allclose(port_flows[0], jax_flows[0], **RAFT_TOL)
    jfiles, tfiles = _files(tmp_path / 'jax'), _files(tmp_path / 'port')
    assert sorted(tfiles) == ['bboxes.npy'] + [f'flow_{k:04d}.jpg'
                                               for k in range(4)]
    for name in tfiles:
        if name != 'bboxes.npy':
            assert jfiles[name] == tfiles[name], name
    jb = np.load(tmp_path / 'jax' / 'bboxes.npy', allow_pickle=True)
    tb = np.load(tmp_path / 'port' / 'bboxes.npy', allow_pickle=True)
    assert jb.shape == tb.shape and len(boxes) == 20
    np.testing.assert_array_equal(jb.astype(np.float64),
                                  tb.astype(np.float64))
    # the summary lines, but RAFT's time
    drop = [i for i, line in enumerate(jax_lines)
            if line.startswith('RAFT inference')]
    assert [ln for i, ln in enumerate(jax_lines) if i not in drop] == \
        [ln.replace(str(tmp_path / 'port'), str(tmp_path / 'jax'))
         for i, ln in enumerate(port_lines) if i not in drop]
