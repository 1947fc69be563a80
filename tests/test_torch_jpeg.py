"""The port's JPEG decoder (``mscl_torch/csrc/jpeg_decode.c`` through
``mscl_torch/utils/jpeg.py`` and ``image_io.imread_rgb``) bitwise against
``cv2.imdecode`` (libjpeg-turbo), which the JAX data path calls, at
``IMREAD_COLOR_RGB`` and ``IMREAD_REDUCED_COLOR_2``: every sampling factor,
grey, restart markers, optimized and 16-bit tables, qualities 50/90/100 on
smooth and noise images, odd sizes; the files it refuses; the committed
fixtures and their digests (what ``chip_smoke.py`` holds the card
machine's build to); and the flagship's train pipeline on JPEG frames
against the JAX pipeline."""
import copy
import hashlib
import json
import os
import pickle
import random
import struct

import numpy as np
import pytest

import _torch_jpeg_util as ju
from mscl_torch.config import Config
from mscl_torch.apis import FLAGSHIP_CONFIG
from mscl_torch.datasets import build_dataset as t_build_dataset
from mscl_torch.ops import cuda_build
from mscl_torch.utils import jpeg
from mscl_torch.utils.image_io import imread_rgb, read_image_shape

SIZES = [(1, 1), (7, 9), (17, 33), (255, 339), (256, 340)]
KINDS = ['444', '422', '440', '420', '411', 'grey']


def test_jpeg_decode_c_builds():
    """The C decoder is built wherever there is a host C compiler (here)
    and loaded once."""
    assert cuda_build.host_cc() is not None
    lib = jpeg._lib()
    assert lib is not None and lib is jpeg._lib()


def _decode(buf, reduce):
    return jpeg.decode_jpeg(np.frombuffer(buf, np.uint8), reduce)


def _assert_cv2_equal(buf, what):
    for reduce in (1, 2):
        want, got = ju.cv2_rgb(buf, reduce), _decode(buf, reduce)
        assert got.shape == want.shape, (what, reduce)
        diff = np.abs(got.astype(int) - want.astype(int))
        assert diff.max() == 0, (what, reduce, diff.max(), (diff > 0).sum())


@pytest.mark.parametrize('kind', KINDS)
@pytest.mark.parametrize('h,w', SIZES)
def test_decoder_matches_cv2(h, w, kind):
    """Qualities 50, 90 and 100 on a smooth and a noise image, with and
    without restart markers and optimized Huffman tables, at reduce 1 and
    2 (where odd sizes round up, unlike PNG's reduced decode)."""
    grey = kind == 'grey'
    for content in ('smooth', 'noise'):
        img = ju.smooth(h, w) if content == 'smooth' else \
            ju.noise(h, w, h * 1000 + w)
        for quality in (50, 90, 100):
            for rst in (0, 3):
                for optimize in (False, True):
                    buf = ju.encode(img, quality, '420' if grey else kind,
                                    rst, optimize, grey=grey)
                    _assert_cv2_equal(buf, (content, quality, rst,
                                            optimize))
    assert _decode(buf, 2).shape[:2] == ((h + 1) // 2, (w + 1) // 2)


@pytest.mark.parametrize('kind', ['444', '420', 'grey'])
def test_16_bit_tables(kind):
    """DQT tables with 16-bit entries decode as their 8-bit originals."""
    buf = ju.encode(ju.smooth(31, 45), 90, '420' if kind == 'grey' else kind,
                    grey=kind == 'grey')
    wide = ju.dqt16(buf)
    assert len(wide) > len(buf)
    _assert_cv2_equal(wide, 'dqt16')
    for reduce in (1, 2):
        np.testing.assert_array_equal(_decode(wide, reduce),
                                      _decode(buf, reduce))


def test_exif_orientation_1_is_decoded():
    buf = ju.encode(ju.smooth(33, 47))
    for little_endian in (True, False):
        _assert_cv2_equal(ju.with_exif_orientation(buf, 1, little_endian),
                          'orientation 1')


def _refused(case):
    """A file the decoder refuses, and the words its reason holds."""
    buf = ju.encode(ju.smooth(40, 56))
    sof = buf.index(b'\xff\xc0')
    if case == 'progressive':
        return ju.encode(ju.smooth(40, 56), progressive=True), 'progressive'
    if case == 'truncated_half':
        return buf[:len(buf) // 2], 'truncated'
    if case == 'truncated_tail':
        return buf[:-40], 'truncated'
    if case in ('exif6_le', 'exif6_be', 'exif3'):
        return ju.with_exif_orientation(
            buf, int(case[4]), case.endswith('le')), 'orientation'
    if case == 'arithmetic':
        return buf[:sof + 1] + b'\xc9' + buf[sof + 2:], 'arithmetic'
    if case == 'lossless':
        return buf[:sof + 1] + b'\xc3' + buf[sof + 2:], 'lossless'
    if case == 'precision12':
        return buf[:sof + 4] + b'\x0c' + buf[sof + 5:], '8-bit'
    if case == 'adobe_rgb':
        # no JFIF APP0, an Adobe APP14 with transform 0: RGB-coded
        app0 = buf.index(b'\xff\xe0')
        n = struct.unpack('>H', buf[app0 + 2:app0 + 4])[0]
        adobe = b'Adobe' + b'\x00\x64' + b'\x00' * 4 + b'\x00'
        return (buf[:2] + b'\xff\xee' + struct.pack('>H', len(adobe) + 2) +
                adobe + buf[app0 + 2 + n:]), 'RGB'
    if case == 'cmyk':
        comps = b''.join(bytes([i, 0x11, 0]) for i in range(1, 5))
        sof4 = b'\x08\x00\x10\x00\x10\x04' + comps
        return (b'\xff\xd8\xff\xc0' + struct.pack('>H', len(sof4) + 2) +
                sof4 + b'\xff\xd9'), 'CMYK'
    if case == 'multi_scan':
        # an SOS that names one of three components
        sos = buf.index(b'\xff\xda')
        scan = b'\x01\x01\x00\x00\x3f\x00'
        return (buf[:sos] + b'\xff\xda' + struct.pack('>H', len(scan) + 2) +
                scan + b'\x00' * 64 + b'\xff\xd9'), 'multi-scan'
    raise ValueError(case)


@pytest.mark.parametrize('case', [
    'progressive', 'truncated_half', 'truncated_tail', 'exif6_le',
    'exif6_be', 'exif3', 'arithmetic', 'lossless', 'precision12',
    'adobe_rgb', 'cmyk', 'multi_scan'])
def test_refusals_name_the_file_and_the_reason(tmp_path, case):
    buf, reason = _refused(case)
    path = str(tmp_path / f'{case}.jpg')
    with open(path, 'wb') as f:
        f.write(buf)
    for reduce in (1, 2):
        with pytest.raises(ValueError, match=reason) as err:
            imread_rgb(path, reduce)
        assert path in str(err.value)


def test_no_compiler_raises(tmp_path, monkeypatch):
    """There is no decoder in Python: without a C compiler, JPEG raises."""
    path = str(tmp_path / 'x.jpg')
    with open(path, 'wb') as f:
        f.write(ju.encode(ju.smooth(8, 8)))
    monkeypatch.setattr(jpeg, '_lib', lambda: None)
    with pytest.raises(RuntimeError, match='C compiler'):
        imread_rgb(path)


def _fixtures():
    with open(os.path.join(ju.FIXTURES, 'digests.json')) as f:
        return json.load(f)


def _digest(img):
    return dict(shape=list(img.shape),
                sha256=hashlib.sha256(np.ascontiguousarray(img)).hexdigest())


def test_fixture_digests_are_cv2s():
    """The committed digests are cv2's decode of the committed files."""
    digests = _fixtures()
    assert len([n for n in digests if n.startswith('frame_')]) == \
        ju.N_FRAMES
    for name, want in digests.items():
        with open(os.path.join(ju.FIXTURES, name), 'rb') as f:
            buf = f.read()
        for reduce in (1, 2):
            assert ju.digest(ju.cv2_rgb(buf, reduce)) == want[str(reduce)]


def test_fixtures_decode_to_their_digests():
    """What chip_smoke.py checks on the card's machine, here."""
    for name, want in _fixtures().items():
        path = os.path.join(ju.FIXTURES, name)
        for reduce in (1, 2):
            assert _digest(imread_rgb(path, reduce)) == want[str(reduce)], \
                (name, reduce)
        assert read_image_shape(path) == tuple(want['1']['shape'][:2])


def test_fixtures_are_what_the_generator_writes():
    files = {**ju.frame_files(), **ju.coverage_files()}
    assert sorted(files) == sorted(_fixtures())
    total = 0
    for name, buf in files.items():
        with open(os.path.join(ju.FIXTURES, name), 'rb') as f:
            assert f.read() == buf, name
        total += len(buf)
    assert total < 1 << 20


def _frames_pkl(root, n_videos=2, n_entries=40):
    """Videos whose frame entries cycle over the committed 256x340 frames,
    with 128x171 .npy flows, an MDS chosen_idx (the flagship's layout)."""
    rng = np.random.default_rng(0)
    frames = [os.path.join(ju.FIXTURES, f'frame_{i:02d}.jpg')
              for i in range(ju.N_FRAMES)]
    annos = []
    for v in range(n_videos):
        flows = []
        for i in range(len(range(0, n_entries - 8, 2))):
            flows.append(os.path.join(root, f'flow_{v}_{i}.npy'))
            np.save(flows[-1], rng.normal(size=(128, 171, 2)).astype(
                np.float32))
        annos.append(dict(frames=[frames[(i + 5 * v) % len(frames)]
                                  for i in range(n_entries)],
                          enc_flows=flows, chosen_idx=[0, 2, 5, 9],
                          label=v))
    pkl = os.path.join(root, 'train.pkl')
    with open(pkl, 'wb') as f:
        pickle.dump(annos, f)
    return pkl


def test_flagship_pipeline_on_jpeg_frames_matches_jax(tmp_path):
    """The flagship config's train pipeline (MoCoDecodePlan's half-scale
    decode where a crop allows it, LocalDecode, the crops and resizes) on
    the committed JPEG frames: the port's items equal the JAX pipeline's,
    bitwise, and some took the reduced decode."""
    from mscl_tpu.datasets import build_dataset as j_build_dataset
    cfg = Config.fromfile(FLAGSHIP_CONFIG).to_dict()
    pkl = _frames_pkl(str(tmp_path))
    ds_cfg = dict(type='FileRawframeDataset', pkl_path=pkl,
                  pipeline=cfg['train_pipeline'],
                  extra_keys=['nids_flow', 'chosen_idx'])
    jds, tds = j_build_dataset(copy.deepcopy(ds_cfg)), t_build_dataset(ds_cfg)
    for idx in range(len(jds)):
        for seed in range(3):
            random.seed(seed)
            np.random.seed(seed)
            want = jds[idx]
            random.seed(seed)
            np.random.seed(seed)
            got = tds[idx]
            assert sorted(got) == sorted(want)
            for key in want:
                for a, b in zip(want[key], got[key]):
                    assert a.dtype == b.dtype and a.shape == b.shape
                    assert a.tobytes() == b.tobytes(), (idx, seed, key)
    reduced = 0
    for seed in range(8):
        random.seed(seed)
        np.random.seed(seed)
        res = copy.deepcopy(tds.data_transfer(tds.video_infos[0]))
        res.update(filename_tmpl='', modality='RGB', start_index=0)
        for tr in tds.pipeline.transforms[:4]:       # up to LocalDecode
            res = tr(res)
        reduced += res['img_shape_dec_q'] == (128, 170)
    assert reduced > 0
