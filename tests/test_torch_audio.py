"""The audio recognition slice of the port against mscl_tpu's, on the CPU:

- ``ResNetAudio`` (depth 50 cut to one block a stage, base 8, 32x16
  spectrograms) in eval and train mode: outputs and BN statistics within
  1e-4, gradients rtol 5e-3 / atol 1e-4 (``_torch_zoo_util.hold``); its
  NCHW / channels-last input rule;
- ``AudioRecognizer`` over ResNetAudio and over the 2D ResNet with one
  input channel (one Basic block a stage): ``forward_test`` ('prob',
  three clips) and a ``train_step`` (``_torch_model_util``);
- the data, bit for bit: each pipeline step (wav decode of 8, 16 and
  32-bit mono and stereo PCM, missing files with zeros and with the global
  ``np.random``'s draws, the mel filterbank and spectrogram), every split
  of both audio configs item for item, ``AudioVisualDataset``'s records
  and ``build_audio_features``' ``.npy`` files;
- two ``train_model`` steps of the audio-feature config, narrowed, in
  both packages (``_torch_recognition_util.check``);
- JAX's evaluation loop reads ``imgs`` alone, so it cannot validate or
  test an audio model; the port's reads the model's ``input_key``.
"""
import contextlib
import copy
import os
import os.path as osp
import random
import runpy
import wave
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mscl_tpu.models.backbones.resnet_audio as jax_ra
from mscl_torch.apis import build_model_from_cfg
from mscl_torch.apis.inference import make_eval_fn
from mscl_torch.config import Config
from mscl_torch.datasets import build_dataloader
from mscl_torch.datasets import build_dataset as t_build_dataset
from mscl_torch.datasets import audio_dataset as tad
from mscl_torch.models.backbones import resnet_audio as port_ra
from mscl_torch.tools import build_audio_features
from mscl_tpu.datasets import audio_dataset as jad
from mscl_tpu.datasets import build_dataloader as j_build_dataloader
from mscl_tpu.datasets import build_dataset as j_build_dataset
from mscl_tpu.models import RECOGNIZERS as JAX_RECOGNIZERS

from _torch_ava_util import write_features, write_wavs
from _torch_model_util import carry, hold_eval, hold_train
from _torch_recognition_util import ONE_BASIC, check, cut_tables
from _torch_zoo_util import hold
from test_torch_pipelines import assert_same

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
AUDIO = 'recognition_audio/resnet/'
FEATURE_CFG = AUDIO + 'tsn_r50_64x1x1_100e_kinetics400_audio_feature.py'
RAW_CFG = AUDIO + 'tsn_r50_64x1x1_100e_kinetics400_audio.py'
ONE_BLOCK = {50: (1, 1, 1, 1)}


@contextlib.contextmanager
def one_block_a_stage():
    """ResNetAudio-50 cut to one Bottleneck a stage in both packages."""
    with mock.patch.dict(jax_ra.ARCH_AUDIO, ONE_BLOCK), \
            mock.patch.dict(port_ra.ARCH_AUDIO, ONE_BLOCK):
        yield


def _seed(s):
    random.seed(s)
    np.random.seed(s)


class _NHWC(port_ra.ResNetAudio):
    """The port's ResNetAudio with its output moved to JAX's (N, T, F, C)."""

    def forward(self, x):
        return super().forward(x).permute(0, 2, 3, 1)


def test_resnet_audio_matches_jax():
    x = np.random.default_rng(0).normal(size=(2, 1, 32, 16)).astype(
        np.float32)
    with one_block_a_stage():
        hold(lambda dt: jax_ra.ResNetAudio(depth=50, base_channels=8,
                                           dtype=dt),
             _NHWC(depth=50, base_channels=8), x)


def test_resnet_audio_reads_nchw_and_channels_last():
    """Axis 1 equal to in_channels reads NCHW, else (N, T, F, C): a clip
    of one frame, (N, 1, F, C), reads NCHW (in both packages)."""
    with one_block_a_stage():
        model = port_ra.ResNetAudio(depth=50, base_channels=4).eval()
    model.init_weights(torch.Generator().manual_seed(0))
    x = torch.randn(2, 1, 16, 12)
    with torch.no_grad():
        assert torch.equal(model(x), model(x.permute(0, 2, 3, 1)))
        assert model(torch.randn(2, 1, 12, 1)).shape == (2, 128, 2, 1)


def _recognizer_cfg(backbone):
    cfg = Config.fromfile(osp.join(ROOT, 'configs', FEATURE_CFG if backbone
                                   == 'ResNetAudio' else RAW_CFG)).model
    cfg = cfg.to_dict()
    cfg['cls_head'].update(num_classes=5, dropout_ratio=0.0)
    if backbone == 'ResNetAudio':
        cfg['backbone']['base_channels'] = 8
        cfg['cls_head']['in_channels'] = 256
    else:
        cfg['backbone']['depth'] = ONE_BASIC
        cfg['cls_head']['in_channels'] = 512
    return cfg


@pytest.mark.parametrize('backbone', ['ResNetAudio', 'ResNet'])
def test_audio_recognizer_matches_jax(backbone):
    """The 2D ResNet's step in float64 in both packages: its last stage
    is 1x1 on these spectrograms, so its train-mode BN normalises two
    values a channel, and the stem's BN gradients lie up to 1.5 % apart in
    float32."""
    rng = np.random.default_rng(1)
    audios = rng.normal(-3, 2, (2, 3, 1, 32, 16)).astype(np.float32)
    batch = dict(audios=audios[:, :1].copy(),
                 label=np.array([[1], [4]], np.int64))
    with one_block_a_stage(), cut_tables():
        cfg = _recognizer_cfg(backbone)
        port = build_model_from_cfg(copy.deepcopy(cfg), device='cpu')
        jcfg = dict(cfg)
        jmodel = JAX_RECOGNIZERS.get(jcfg.pop('type'))(**jcfg)
        variables = carry(jmodel, port, batch)
        scores = hold_eval(jmodel, port, variables, (audios,))
        np.testing.assert_allclose(scores.sum(-1), 1.0, rtol=1e-5)
        x64 = backbone == 'ResNet'
        if x64:
            jmodel = JAX_RECOGNIZERS.get(cfg['type'])(dtype=jnp.float64,
                                                      **jcfg)
        log, n_masks = hold_train(jmodel, port, variables, batch, x64=x64)
    assert n_masks == 0 and np.isfinite(log['loss'])


def _pcm(path, y, width, channels):
    with wave.open(path, 'wb') as w:
        w.setnchannels(channels)
        w.setsampwidth(width)
        w.setframerate(16000)
        w.writeframes(y.tobytes())


def test_audio_pipeline_steps_bitwise(tmp_path):
    rng = np.random.default_rng(2)
    paths = []
    for width, dtype in ((1, np.int8), (2, np.int16), (4, np.int32)):
        for channels in (1, 2):
            info = np.iinfo(dtype)
            y = rng.integers(info.min // 4, info.max // 4,
                             (7000, channels)).astype(dtype)
            paths.append(str(tmp_path / f'w{width}_c{channels}.wav'))
            _pcm(paths[-1], y, width, channels)
    np.save(tmp_path / 'f.npy', rng.normal(size=(50, 80)).astype(
        np.float32))
    paths += [str(tmp_path / 'missing.wav')]
    for pad in ('zero', 'random'):
        for path in paths:
            res = dict(audio_path=path, total_frames=30, start_index=0)
            _seed(3)
            want = jad.AudioDecodeInit(pad_method=pad)(dict(res))
            _seed(3)
            got = tad.AudioDecodeInit(pad_method=pad)(dict(res))
            assert_same(got, want)
            frame_inds = np.array([3, 4, 5, 6, 20, 21, 22, 23, 27, 28, 29,
                                   30])
            got.update(frame_inds=frame_inds, num_clips=3)
            want.update(frame_inds=frame_inds, num_clips=3)
            for jstep, tstep in ((jad.AudioDecode(3000),
                                  tad.AudioDecode(3000)),
                                 (jad.AudioAmplify(1.5),
                                  tad.AudioAmplify(1.5))):
                want, got = jstep(want), tstep(got)
                assert_same(got, want)
            for kw in (dict(n_mels=40, fixed_length=16),
                       dict(window_size=20, step_size=10, fixed_length=40)):
                for jmel, tmel in ((jad.MelSpectrogram, tad.MelSpectrogram),
                                   (jad.MelLogSpectrogram,
                                    tad.MelLogSpectrogram)):
                    jout = jad.FormatAudioShape()(jmel(**kw)(dict(want)))
                    assert_same(tad.FormatAudioShape()(tmel(**kw)(
                        dict(got))), jout)
        for path in (str(tmp_path / 'f.npy'), str(tmp_path / 'no.npy')):
            res = dict(audio_path=path, total_frames=100,
                       frame_inds=np.arange(10, 74), num_clips=2)
            _seed(4)
            want = jad.AudioFeatureSelector(24)(
                jad.LoadAudioFeature(pad)(dict(res)))
            _seed(4)
            assert_same(tad.AudioFeatureSelector(24)(
                tad.LoadAudioFeature(pad)(dict(res))), want)
    for sr, n_fft, n_mels in ((16000, 512, 80), (8000, 200, 40),
                              (22050, 706, 64)):
        assert_same(tad._mel_filterbank(sr, n_fft, n_mels),
                    jad._mel_filterbank(sr, n_fft, n_mels))


@pytest.fixture(scope='module')
def audio_sets(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('audio'))
    return root, write_wavs(root, n=4, seconds=2.2), write_features(root)


@pytest.mark.parametrize('cfg_name', [FEATURE_CFG, RAW_CFG])
def test_config_pipelines_bitwise(cfg_name, audio_sets):
    root, wav_ann, feat_ann = audio_sets
    cfg = Config.fromfile(osp.join(ROOT, 'configs', cfg_name)).to_dict()
    for split in ('train', 'val', 'test'):
        if split not in cfg['data']:
            continue
        ds_cfg = dict(cfg['data'][split], data_prefix=root,
                      ann_file=feat_ann if cfg_name == FEATURE_CFG
                      else wav_ann)
        port = t_build_dataset(copy.deepcopy(ds_cfg),
                               dict(test_mode=split == 'test'))
        jax_ds = j_build_dataset(copy.deepcopy(ds_cfg),
                                 dict(test_mode=split == 'test'))
        assert_same(port.video_infos, jax_ds.video_infos)
        for i in range(len(port)):
            _seed(i)
            want = jax_ds[i]
            _seed(i)
            assert_same(port[i], want)
    assert port[0]['audios'].shape[-2:] == (128, 80)


def test_audio_visual_dataset_bitwise(tmp_path):
    ann = tmp_path / 'list.txt'
    ann.write_text('a/v0 10 1\nb/v1 12 0\n')
    kw = dict(ann_file=str(ann), pipeline=[], audio_prefix='/feats',
              data_prefix=str(tmp_path), video_prefix='/videos')
    from mscl_torch.datasets import AudioVisualDataset
    from mscl_tpu.datasets.rawframe_dataset import \
        AudioVisualDataset as JAudioVisual
    port, want = AudioVisualDataset(**kw), JAudioVisual(**kw)
    assert_same(port.video_infos, want.video_infos)
    assert port.video_infos[1]['audio_path'] == '/feats/b/v1.npy'


def test_build_audio_features_bytes_match_jax(audio_sets, tmp_path):
    root = audio_sets[0]
    tool = runpy.run_path(osp.join(ROOT, 'tools', 'data',
                                   'build_audio_features.py'))
    wavs = sorted(f for f in os.listdir(root) if f.endswith('.wav'))
    jax_out, port_out = str(tmp_path / 'jax'), str(tmp_path / 'port')
    os.makedirs(jax_out)
    for w in wavs:
        tool['build_one']((osp.join(root, w), jax_out, 80, 96))
    assert build_audio_features.main(
        [root, port_out, '--fixed-length', '96', '--num-workers', '2']) == \
        len(wavs)
    assert sorted(os.listdir(port_out)) == sorted(os.listdir(jax_out))
    for name in os.listdir(jax_out):
        with open(osp.join(jax_out, name), 'rb') as a, \
                open(osp.join(port_out, name), 'rb') as b:
            assert a.read() == b.read(), name


def test_feature_config_trains_as_in_jax(audio_sets, tmp_path):
    """Two train_model steps of the narrowed audio-feature config: the
    losses within 2e-4, each tensor's change within 5e-3, both packages in
    float64 (``port64``). The features are zero-padded to 128 rows
    (AudioFeatureSelector), and on such maps JAX's float32 train-mode BN
    (one-pass statistics) puts the stem's BN-bias gradient 4.3 % from its
    own float64, where the port's float32 lies within 2.3e-4 of float64."""
    root, _, feat_ann = audio_sets

    def update(cfg):
        cfg['model']['backbone'].pop('stage_blocks')
        for split in ('train', 'test'):
            cfg['data'][split]['data_prefix'] = root
    with one_block_a_stage():
        runner = check(FEATURE_CFG, root, feat_ann, str(tmp_path), False,
                       x64=True, port64=True, update=update)
    assert runner.optimizer.steps == 2


def test_evaluation_reads_the_model_input_key(audio_sets):
    """mscl_tpu's eval loop reads batch['imgs'] (mscl_tpu/apis/
    inference.py:44): on an audio batch it stops with a KeyError; the
    port's gives each video's scores, those of forward_test."""
    from mscl_tpu.apis.inference import make_eval_fn as jax_eval_fn
    root, _, feat_ann = audio_sets
    cfg = Config.fromfile(osp.join(ROOT, 'configs', FEATURE_CFG)).to_dict()
    ds_cfg = dict(cfg['data']['test'], data_prefix=root, ann_file=feat_ann)
    jloader = j_build_dataloader(j_build_dataset(copy.deepcopy(ds_cfg)), 2,
                                 shuffle=False)
    jcfg = _recognizer_cfg('ResNetAudio')
    jmodel = JAX_RECOGNIZERS.get(jcfg.pop('type'))(**jcfg)
    with pytest.raises(KeyError, match='imgs'):
        jax_eval_fn(jmodel)(None, jloader)
    with one_block_a_stage():
        model = build_model_from_cfg(_recognizer_cfg('ResNetAudio'),
                                     device='cpu')
    loader = build_dataloader(t_build_dataset(ds_cfg), 2, shuffle=False)
    scores = make_eval_fn(model)(loader)
    model.eval()
    with torch.no_grad():
        first = model.forward_test(torch.from_numpy(
            t_build_dataset(ds_cfg)[0]['audios'][None]))
    assert len(scores) == 4 and scores[0].shape == (5,)
    np.testing.assert_allclose(scores[0], first[0].numpy(), rtol=1e-6)
