"""mscl_torch's flow-extraction CLI against tools/misc/flow_extraction.py,
on the CPU: the pair geometry, the video listing, np4 blobs that each
package's codec reads from the other, and a whole run of ``main`` on
synthetic frames that writes the annotations the JAX CLI writes."""
import importlib.util
import os
import pickle
import sys

import cv2
import numpy as np
import pytest

from mscl_tpu.utils import np4 as jnp4
from mscl_torch.apis import flow_extraction as tfe
from mscl_torch.utils import np4 as tnp4

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope='module')
def jfe():
    """The JAX CLI, loaded from its file (tools/ is not a package)."""
    spec = importlib.util.spec_from_file_location(
        'jax_flow_extraction',
        os.path.join(ROOT, 'tools', 'misc', 'flow_extraction.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize('num_frames,gap,adjacent', [
    (30, 2, 8), (9, 2, 8), (8, 2, 8), (17, 3, 4), (5, 1, 1)])
def test_window_indices_match(jfe, num_frames, gap, adjacent):
    assert tfe.window_indices(num_frames, gap, adjacent) == \
        jfe.window_indices(num_frames, gap, adjacent)


@pytest.fixture(params=['native', 'python'])
def jax_codec(request, monkeypatch):
    """The JAX codec with its native LZ4 library (compressed blocks) or its
    Python fallback."""
    if request.param == 'native':
        if jnp4._load_native() is None:
            pytest.skip('native lz4 codec unavailable')
    else:
        monkeypatch.setattr(jnp4, '_lib', None)
        monkeypatch.setattr(jnp4, '_lib_tried', True)
    return request.param


@pytest.mark.parametrize('shape', [(128, 171, 2), (0,), (3, 5 << 18)])
def test_np4_blobs_cross_decode(jax_codec, shape):
    """Port-written blobs decode exactly with mscl_tpu.utils.np4, and the
    port reads what the JAX writer wrote (over 4 MB: two LZ4 blocks)."""
    rng = np.random.default_rng(0)
    arr = rng.normal(size=shape).astype(np.float32)
    if arr.size > 1000:
        arr[: shape[0] // 2] = 0.0          # compressible, for the native lz4
    ours = tnp4.np4_encode(arr)
    for blob in (ours, jnp4.np4_encode(arr)):
        for decode in (jnp4.np4_decode, tnp4.np4_decode):
            out = decode(blob)
            assert out.dtype == arr.dtype and out.shape == arr.shape
            np.testing.assert_array_equal(out, arr)
    assert tnp4.np4_decode(b'not an np4 blob') is None


def _frames(root, h=44, w=60):
    """Two videos of 11 frames, one of 4 (too short for a pair), and a
    stray file; jpgs of a moving pattern."""
    rng = np.random.default_rng(1)
    base = rng.integers(0, 255, (h + 16, w + 16, 3), dtype=np.uint8)
    for name, n in (('vid_a', 11), ('vid_b', 11), ('vid_short', 4)):
        os.makedirs(root / name)
        for i in range(n):
            cv2.imwrite(str(root / name / f'img_{i:05d}.jpg'),
                        base[i % 16:i % 16 + h, i:i + w])
    (root / 'notes.txt').write_text('not a video')
    labels = root.parent / 'labels.txt'
    labels.write_text('vid_a 3\nvid_b 7\n')
    return labels


def test_main_writes_what_the_jax_cli_writes(jfe, tmp_path, monkeypatch,
                                            capsys):
    frames = tmp_path / 'frames'
    labels = _frames(frames)
    assert tfe.list_videos(str(frames)) == jfe.list_videos(str(frames))
    common = ['--labels', str(labels), '--gap', '2', '--adjacent', '4',
              '--batch-size', '3', '--scale-hw', '36', '52']
    tfe.main([str(frames), str(tmp_path / 'out_t'), '--anno-out',
              str(tmp_path / 't.pkl'), '--device', 'cpu', '--iters', '2',
              *common])

    def zero_flow_fn(weights_path, iters=12):       # no JAX RAFT needed
        return lambda a, b: np.zeros(a.shape[:3] + (2,), np.float32)
    monkeypatch.setattr(jfe, 'make_raft_fn', zero_flow_fn)
    monkeypatch.setattr(sys, 'argv', [
        'flow_extraction.py', str(frames), str(tmp_path / 'out_j'),
        '--anno-out', str(tmp_path / 'j.pkl'), *common])
    jfe.main()
    capsys.readouterr()

    with open(tmp_path / 't.pkl', 'rb') as f:
        ours = pickle.load(f)
    with open(tmp_path / 'j.pkl', 'rb') as f:
        theirs = pickle.load(f)
    assert [a['video_name'] for a in ours] == ['vid_a', 'vid_b']
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert sorted(a) == sorted(b)
        assert (a['frames'], a['label'], a['video_name']) == \
            (b['frames'], b['label'], b['video_name'])
        assert [os.path.relpath(p, tmp_path / 'out_t') for p in
                a['enc_flows']] == [os.path.relpath(p, tmp_path / 'out_j')
                                    for p in b['enc_flows']]
        assert len(a['enc_flows']) == 4            # pairs (0,4) .. (6,10)
        for p in a['enc_flows']:
            with open(p, 'rb') as f:
                flow = jnp4.np4_decode(f.read())
            assert flow.shape == (36, 52, 2) and flow.dtype == np.float32
            assert np.isfinite(flow).all()
