"""The rawframe recognition data path of the port against mscl_tpu's, on
the CPU: the grey decode of flow frames against cv2, the samplers,
RawFrameDecode (RGB and flow; JPEG and PNG frames of 17x33 and 64x48),
RawframeDataset (offsets, multi-class), the dataset wrappers, and every
train, val and test pipeline of the shipped I3D and SlowOnly configs, item
for item. The JAX side decodes with cv2; the port with its own decoders.
All of it is bitwise: the same arrays, dtypes and draws.
"""
import copy
import os
import os.path as osp
import random

import cv2
import numpy as np
import pytest

from mscl_torch.config import Config
from mscl_torch.datasets import build_dataset as t_build_dataset
from mscl_torch.datasets.pipelines import Compose as TCompose
from mscl_torch.utils.image_io import imread_grey, imresize
from mscl_tpu.datasets import build_dataset as j_build_dataset
from mscl_tpu.datasets.pipelines import Compose as JCompose

from test_torch_pipelines import assert_same

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
RAWFRAME_CONFIGS = [
    'i3d/i3d_r50_32x2x1_100e_kinetics400_rgb.py',
    'i3d/i3d_r50_dense_32x2x1_100e_kinetics400_rgb.py',
    'i3d/i3d_r50_lazy_32x2x1_100e_kinetics400_rgb.py',
    'slowonly/slowonly_imagenet_pretrained_r50_8x4x1_64e_kinetics400_rgb.py',
    'slowonly/slowonly_r50_4x16x1_256e_kinetics400_flow.py',
    'slowonly/slowonly_r50_4x16x1_256e_kinetics400_rgb.py',
    'slowonly/slowonly_r50_8x8x1_256e_kinetics400_rgb.py',
]


def _seed(s):
    random.seed(s)
    np.random.seed(s)


def _frame(rng, h, w, smooth):
    img = rng.integers(0, 256, (h, w, 3))
    if smooth:
        img = np.cumsum(img, axis=1) // 41
    return (img % 256).astype(np.uint8)


def write_rawframes(root, n_videos, n_frames, hw, ext='jpg', flow=False,
                    seed=0, offset=0):
    """A Kinetics-style rawframe set: a directory a video of
    ``img_{:05}`` frames from 1 (and with ``flow`` the grey
    ``x_{:05d}``/``y_{:05d}`` pairs), and the annotation list
    ("dir [offset] total_frames label") beside them."""
    rng = np.random.default_rng(seed)
    lines = []
    for v in range(n_videos):
        vdir = osp.join(root, f'video_{v}')
        os.makedirs(vdir, exist_ok=True)
        for i in range(1, n_frames + offset + 1):
            img = _frame(rng, *hw, smooth=i % 2)
            cv2.imwrite(osp.join(vdir, f'img_{i:05}.{ext}'), img)
            if flow:
                for k, axis in enumerate('xy'):
                    cv2.imwrite(osp.join(vdir, f'{axis}_{i:05d}.{ext}'),
                                img[..., k])
        lines.append(f'video_{v} ' + (f'{offset} ' if offset else '') +
                     f'{n_frames} {v % 3}')
    ann = osp.join(root, 'list.txt')
    with open(ann, 'w') as f:
        f.write('\n'.join(lines) + '\n')
    return ann


@pytest.fixture(scope='module')
def sets(tmp_path_factory):
    out = {}
    for ext in ('jpg', 'png'):
        for hw in ((17, 33), (64, 48)):
            root = str(tmp_path_factory.mktemp(f'{ext}{hw[0]}'))
            out[ext, hw] = (root, write_rawframes(root, 3, 40, hw, ext,
                                                  flow=True))
    return out


# ------------------------------------------------------------ grey decode

@pytest.mark.parametrize('kind', ['grey_jpg', '420', '422', '444', '411',
                                  'grey_png', 'rgb_png', 'rgba_png'])
def test_imread_grey_is_cv2s(tmp_path, kind):
    rng = np.random.default_rng(1)
    for hw in ((17, 33), (64, 48), (1, 1), (9, 200)):
        img = cv2.GaussianBlur(_frame(rng, *hw, smooth=True), (3, 3), 0)
        if kind.endswith('png'):
            path = str(tmp_path / 'f.png')
            arr = {'grey_png': img[..., 0], 'rgb_png': img,
                   'rgba_png': np.concatenate([img, img[..., 1:2]], -1)
                   }[kind]
            arr[:2, :2] = 7          # grey pixels pass as they are
            cv2.imwrite(path, arr)
        else:
            path = str(tmp_path / 'f.jpg')
            if kind == 'grey_jpg':
                cv2.imwrite(path, img[..., 0])
            else:
                factor = getattr(cv2, f'IMWRITE_JPEG_SAMPLING_FACTOR_{kind}')
                cv2.imwrite(path, img, [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                        factor])
        got, want = imread_grey(path), cv2.imread(path, cv2.IMREAD_GRAYSCALE)
        assert got.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want, err_msg=f'{kind} {hw}')


def test_grey_resize_is_cv2s():
    rng = np.random.default_rng(2)
    for h, w in ((17, 33), (64, 48), (240, 320)):
        img = _frame(rng, h, w, smooth=True)[..., 0]
        for size in ((w * 3, h * 2), (max(1, w // 3), max(1, h // 2)),
                     (341, 256)):
            np.testing.assert_array_equal(imresize(img, size),
                                          cv2.resize(img, size))


# ---------------------------------------------------------- transforms

def _both(cfg, results, seed=0):
    """A pipeline of the JAX package and of the port on copies of
    ``results``, from the same generator states."""
    outs = []
    for compose in (JCompose, TCompose):
        _seed(seed)
        outs.append(compose([dict(c) for c in cfg])(copy.deepcopy(results)))
        outs.append((random.getstate(), np.random.get_state()[1].tobytes()))
    assert outs[1] == outs[3], 'a different number of draws'
    assert_same(outs[0], outs[2])
    return outs[2]


@pytest.mark.parametrize('num_frames', [5, 40, 64, 70, 200])
@pytest.mark.parametrize('test_mode', [False, True])
def test_samplers_match(num_frames, test_mode):
    base = dict(total_frames=num_frames, start_index=1)
    for cfg in (dict(type='DenseSampleFrames', clip_len=8,
                     frame_interval=2, num_clips=2, test_mode=test_mode),
                dict(type='DenseSampleFrames', clip_len=4,
                     frame_interval=8, num_clips=1, test_mode=test_mode,
                     sample_range=32, num_sample_positions=3),
                dict(type='SampleFrames', clip_len=32, frame_interval=2,
                     num_clips=1, test_mode=test_mode),
                dict(type='UntrimmedSampleFrames', clip_len=3,
                     frame_interval=7)):
        for seed in range(4):
            _both([cfg], base, seed)


@pytest.mark.parametrize('ext', ['jpg', 'png'])
@pytest.mark.parametrize('hw', [(17, 33), (64, 48)])
@pytest.mark.parametrize('modality', ['RGB', 'Flow'])
def test_rawframe_decode_matches(sets, ext, hw, modality):
    root, _ = sets[ext, hw]
    tmpl = 'img_{:05}.' + ext if modality == 'RGB' else '{}_{:05d}.' + ext
    results = dict(frame_dir=osp.join(root, 'video_1'), total_frames=40,
                   filename_tmpl=tmpl, modality=modality, start_index=1,
                   offset=2,
                   gt_bboxes=np.array([[0.1, 0.2, 0.5, 0.9]], np.float32),
                   proposals=np.array([[0.0, 0.0, 1.0, 0.5]], np.float32))
    out = _both([dict(type='SampleFrames', clip_len=4, frame_interval=3,
                      num_clips=2),
                 dict(type='RawFrameDecode')], results)
    assert len(out['imgs']) == 8 * (2 if modality == 'Flow' else 1)
    if modality == 'Flow':
        assert out['imgs'][0].shape == hw


@pytest.mark.parametrize('multi_class', [False, True])
def test_rawframe_dataset_and_wrappers_match(tmp_path, multi_class):
    root = str(tmp_path)
    write_rawframes(root, 4, 12, (17, 33), 'png', offset=3)
    ann = osp.join(root, 'list.txt')
    if multi_class:
        with open(ann) as f:
            lines = [line.strip() + ' 4' for line in f]
        with open(ann, 'w') as f:
            f.write('\n'.join(lines) + '\n')
    pipeline = [dict(type='SampleFrames', clip_len=2, frame_interval=2),
                dict(type='RawFrameDecode'),
                dict(type='FormatShape', input_format='NCTHW')]
    ds = dict(type='RawframeDataset', ann_file=ann, data_prefix=root,
              pipeline=pipeline, with_offset=True, multi_class=multi_class,
              filename_tmpl='img_{:05}.png',
              num_classes=5 if multi_class else None)
    for cfg in (ds, dict(type='RepeatDataset', times=2, dataset=ds),
                dict(type='ConcatDataset', datasets=[ds, ds])):
        j, t = (build(copy.deepcopy(cfg))
                for build in (j_build_dataset, t_build_dataset))
        assert len(j) == len(t) == (4 if cfg is ds else 8)
        for i in (0, 3, len(t) - 1, -1):
            _seed(i % 7)
            a = j[i]
            _seed(i % 7)
            assert_same(a, t[i])
    assert t.datasets[1].video_infos[0]['offset'] == 3


@pytest.mark.parametrize('name', RAWFRAME_CONFIGS)
def test_config_pipelines_match(sets, name):
    """Each shipped config's train, val and test pipelines, item for item
    (PNG frames of 64x48; the flow config's train split on the grey
    frames)."""
    root, ann = sets['png', (64, 48)]
    cfg = Config.fromfile(osp.join(ROOT, 'configs', 'recognition', name))
    for split in ('train', 'val', 'test'):
        ds = cfg.data[split].to_dict()
        if split == 'test' and ds['pipeline'] == cfg.data.val.to_dict()[
                'pipeline']:
            continue                    # the val split's, held above
        ds.update(ann_file=ann, data_prefix=root)
        if ds.get('modality') == 'Flow':
            ds['filename_tmpl'] = '{}_{:05d}.png'
        else:
            ds['filename_tmpl'] = 'img_{:05}.png'
        j, t = j_build_dataset(copy.deepcopy(ds)), t_build_dataset(ds)
        for i in range(2 if split == 'train' else 1):
            _seed(i)
            a = j[i]
            _seed(i)
            b = t[i]
            assert_same(a, b)
        c, tt = b['imgs'].shape[-4], b['imgs'].shape[-3]
        if 'NTHWC' in str(ds['pipeline']):
            c = b['imgs'].shape[-1]
        assert c == (2 if ds.get('modality') == 'Flow' else 3)
        assert tt > 0 and b['imgs'].dtype == np.float32
