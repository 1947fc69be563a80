"""Synthetic rawframe sets on disk for the tests of the port's data path:
per-video frame files, raw flows and an annotation pickle in
FileRawframeDataset's format (``frames``, ``enc_flows``, ``chosen_idx``,
``label``)."""
import os
import pickle

import cv2
import numpy as np
import pytest
import torch

from mscl_tpu.utils.np4 import np4_encode


def write_videos(root, n_videos, n_frames, img_hw, flow_hw, frame_ext='png',
                 flow_ext='npy', seed=0, chosen_idx=(0, 1, 2),
                 name='train.pkl'):
    """``n_videos`` videos of ``n_frames`` frames (cv2-written PNG or JPEG,
    smooth noise so PNG's adaptive filters vary) and the
    ``len(range(0, n_frames - 8, 2))`` flows MatchFlow(gap=2, adjacent=8)
    expects (float32 ``.npy`` or ``.np4``); returns the pickle's path."""
    rng = np.random.default_rng(seed)
    h, w = img_hw
    annos = []
    for v in range(n_videos):
        vdir = os.path.join(root, f'video_{v}')
        os.makedirs(vdir, exist_ok=True)
        frames, flows = [], []
        for i in range(n_frames):
            img = rng.integers(0, 256, (h, w, 3))
            if i % 2:
                img = np.cumsum(img, axis=1) // 41
            path = os.path.join(vdir, f'img_{i:05d}.{frame_ext}')
            cv2.imwrite(path, (img % 256).astype(np.uint8))
            frames.append(path)
        for i in range(len(range(0, n_frames - 8, 2))):
            flow = rng.normal(size=tuple(flow_hw) + (2,)).astype(np.float32)
            path = os.path.join(vdir, f'flow_{i:05d}.{flow_ext}')
            if flow_ext == 'npy':
                np.save(path, flow)
            else:
                with open(path, 'wb') as f:
                    f.write(np4_encode(flow))
            flows.append(path)
        annos.append(dict(frames=frames, enc_flows=flows,
                          chosen_idx=list(chosen_idx), label=v % 2))
    pkl = os.path.join(root, name)
    with open(pkl, 'wb') as f:
        pickle.dump(annos, f)
    return pkl


def register_tiny3d():
    """``test.tiny3d`` (tests/test_e2e_workloads.py's backbone: one
    no-temporal block a stage, 8 wide, the flow stem) in the port's
    registry too."""
    from functools import partial

    from mscl_torch.models import BACKBONES
    from mscl_torch.models.backbones.video_resnet import VideoResNet
    import test_e2e_workloads  # noqa: F401  (registers it in mscl_tpu's)
    if 'test.tiny3d' not in BACKBONES:
        BACKBONES.register_module(
            name='test.tiny3d',
            module=partial(VideoResNet, conv_makers=('no_temporal',) * 4,
                           layers=(1, 1, 1, 1), stem='flow_basic',
                           base_width=8))


def tiny_pretrain_cfg(pkl, work_dir, aug=None, videos_per_gpu=4,
                      val_pkl=None, total_epochs=2):
    """tests/test_e2e_workloads.py's tiny pretrain config as a plain dict,
    with ``aug`` (None: its SyncMoCoAugmentV5), the batch and, given
    ``val_pkl``, a val set under the flagship's val pipeline (cut to the
    same 16x16 crops) with validation by loss every epoch."""
    from test_e2e_workloads import pretrain_cfg
    cfg = pretrain_cfg(dict(pkl=pkl), work_dir).to_dict()
    if aug is not None:
        cfg['model']['aug'] = dict(aug)
    cfg['data']['videos_per_gpu'] = videos_per_gpu
    cfg['total_epochs'] = total_epochs
    if val_pkl is not None:
        val = [dict(t) for t in cfg['data']['train']['pipeline']]
        val[1] = dict(type='ChosenSampleFrames', clip_len=val[1]['clip_len'],
                      frame_interval=val[1]['frame_interval'], num_clips=1)
        cfg['data']['val'] = dict(cfg['data']['train'], pkl_path=val_pkl,
                                  pipeline=val)
        cfg['evaluation'] = dict(interval=1, simple=True)
    return cfg


@pytest.fixture(scope='module')
def one_torch_thread():
    """Torch on one thread for a module: the training runs here are tiny,
    and on a loaded machine torch's waiting pool threads, the loader's
    producer thread and the other test processes slow them tenfold."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
