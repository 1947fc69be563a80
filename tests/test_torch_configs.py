"""Every shipped config in the port: the counterpart of
tests/test_configs.py over the repo's own ``configs/``.

For each of the config files outside ``configs/**/_base_/`` the port loads
the file, builds the model at full width on the meta device (every
constructor runs; no weight is allocated or drawn, the recipes' own tests
hold the init) and constructs every dataset and pipeline step of
``data.train``, ``val`` and ``test``, with the annotation files left
unread. A file either builds in full or is refused
with an error that names what is missing (a ``type`` of the file, or the
argument ``left_kp``). The counts are a gate that later slices raise and
never lower.
"""
import contextlib
import glob
import os.path as osp
from unittest import mock

import pytest
import torch

from mscl_torch.config import Config
from mscl_torch.datasets import DATASETS, build_dataset
from mscl_torch.datasets.pipelines import Compose
from mscl_torch.models import RECOGNIZERS

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
CONFIGS = sorted(p for p in glob.glob(f'{ROOT}/configs/**/*.py',
                                      recursive=True)
                 if f'{osp.sep}_base_{osp.sep}' not in p)

FULL = {
    'moco/moco_r18_consistent_augmentation_lr3e-2.py',
    'moco/moco_r18_cosistent_video_lr3e-2.py', 'moco/moco_r18_lr3e-2.py',
    'moco/moco_r50_consistent_augmentation_lr3e-2.py',
    'moco/mscl_r18_cosm_lr2e-2.py', 'moco/mscl_r50_cosm_lr3e-2.py',
    'ssl_test/test_ssv2_r18.py', 'ssl_test/test_ucf101_r18.py',
    'i3d/i3d_r50_32x2x1_100e_kinetics400_rgb.py',
    'i3d/i3d_r50_dense_32x2x1_100e_kinetics400_rgb.py',
    'i3d/i3d_r50_lazy_32x2x1_100e_kinetics400_rgb.py',
    'slowonly/slowonly_imagenet_pretrained_r50_8x4x1_64e_kinetics400_rgb.py',
    'slowonly/slowonly_r50_4x16x1_256e_kinetics400_flow.py',
    'slowonly/slowonly_r50_4x16x1_256e_kinetics400_rgb.py',
    'slowonly/slowonly_r50_8x8x1_256e_kinetics400_rgb.py',
    'posec3d/slowonly_r50_u48_240e_ntu120_xsub_keypoint.py',
    'posec3d/slowonly_r50_u48_240e_ntu60_xsub_keypoint.py',
    # the frame-based family and C3D
    'tsn/tsn_r50_1x1x3_100e_kinetics400_rgb.py',
    'tsn/tsn_r50_1x1x3_110e_kinetics400_flow.py',
    'tsn/tsn_r50_1x1x3_75e_ucf101_rgb.py',
    'tsn/tsn_r50_1x1x8_100e_kinetics400_rgb.py',
    'tsn/tsn_r50_1x1x8_50e_sthv1_rgb.py',
    'tsn/tsn_r101_1x1x5_50e_mmit_rgb.py',
    'tsm/tsm_r50_1x1x16_50e_kinetics400_rgb.py',
    'tsm/tsm_r50_1x1x8_50e_kinetics400_rgb.py',
    'tsm/tsm_r50_1x1x8_50e_sthv2_rgb.py',
    'tsm/tsm_r50_dense_1x1x8_100e_kinetics400_rgb.py',
    'tin/tin_r50_1x1x8_40e_sthv1_rgb.py',
    'tanet/tanet_r50_1x1x8_100e_kinetics400_rgb.py',
    'mobilenet_v2/tsm_mobilenetv2_1x1x8_50e_kinetics400_rgb.py',
    'trn/trn_r50_1x1x8_50e_sthv1_rgb.py',
    'c3d/c3d_sports1m_16x1x1_45e_ucf101_rgb.py',
    # its two train sets build; train_model refuses the list
    # (tests/test_torch_omnisource.py)
    'omnisource/tsn_r50_1x1x8_100e_minikinetics_rgb.py',
    # the 3D zoo and the TPN neck
    'slowfast/slowfast_r50_4x16x1_256e_kinetics400_rgb.py',
    'slowfast/slowfast_r50_8x8x1_256e_kinetics400_rgb.py',
    'slowfast/slowfast_r101_8x8x1_256e_kinetics400_rgb.py',
    'r2plus1d/r2plus1d_r18_8x8x1_180e_kinetics400_rgb.py',
    'r2plus1d/r2plus1d_r34_8x8x1_180e_kinetics400_rgb.py',
    'x3d/x3d_m_16x5x1_facebook_kinetics400_rgb.py',
    'csn/ircsn_r152_32x2x1_180e_kinetics400_rgb.py',
    's3d/s3d_64x1x1_100e_kinetics400_rgb.py',
    'timesformer/timesformer_divST_8x32x1_15e_kinetics400_rgb.py',
    'tpn/tpn_slowonly_r50_8x8x1_150e_kinetics400_rgb.py',
    'tpn/tpn_tsm_r50_1x1x8_150e_sthv1_rgb.py',
    # the external-name 2D backbones
    'custom_backbones/tsn_dense161_1x1x3_100e_kinetics400_rgb.py',
    'custom_backbones/tsn_rn101_32x4d_1x1x3_100e_kinetics400_rgb.py',
    'custom_backbones/tsn_swin_base_1x1x3_100e_kinetics400_rgb.py',
    # temporal localization and HVU's tags; train_model refuses BMN, TEM
    # and PEM, and the HVU data path fails as JAX's does
    # (tests/test_torch_localization.py)
    'bmn/bmn_400x100_2x8_9e_activitynet_feature.py',
    'bsn/bsn_pem_400x100_1x16_20e_activitynet_feature.py',
    'bsn/bsn_tem_400x100_1x16_20e_activitynet_feature.py',
    'ssn/ssn_r50_450e_thumos14_rgb_train.py',
    'tsn/tsn_r18_1x1x8_100e_hvu_action_rgb.py',
    # audio recognition over features and raw wavs
    'resnet/tsn_r50_64x1x1_100e_kinetics400_audio.py',
    'resnet/tsn_r50_64x1x1_100e_kinetics400_audio_feature.py',
    # AVA spatio-temporal detection, the LFB and ACRN heads
    # (tests/test_torch_detection.py, tests/test_torch_ava_data.py)
    'acrn/slowfast_acrn_r50_8x8x1_cosine_10e_ava22_rgb.py',
    'ava/slowfast_context_r50_4x16x1_20e_ava_rgb.py',
    'ava/slowfast_r50_4x16x1_20e_ava_rgb.py',
    'ava/slowfast_r50_4x16x1_20e_ava_rgb_custom_classes.py',
    'ava/slowfast_r50_8x8x1_20e_ava_rgb.py',
    'ava/slowfast_r50_8x8x1_cosine_10e_ava22_rgb.py',
    'ava/slowfast_temporal_max_focal_alpha3_gamma1_r50_8x8x1_cosine_10e_'
    'ava22_rgb.py',
    'ava/slowfast_temporal_max_r50_8x8x1_cosine_10e_ava22_rgb.py',
    'ava/slowonly_nl_r50_4x16x1_10e_ava_rgb.py',
    'ava/slowonly_nl_r50_8x8x1_10e_ava_rgb.py',
    'ava/slowonly_r101_8x8x1_20e_ava_rgb.py',
    'ava/slowonly_r50_4x16x1_20e_ava_rgb.py',
    'ava/slowonly_r50_4x16x1_20e_ava_rgb_custom_classes.py',
    'lfb/lfb_avg_r50_4x16x1_20e_ava_rgb.py',
    'lfb/lfb_max_r50_4x16x1_20e_ava_rgb.py',
    'lfb/lfb_nl_r50_4x16x1_20e_ava_rgb.py',
}
# model builds, data refused by name
REFUSED = {
    'i3d/i3d_r50_video_32x2x1_100e_kinetics400_rgb.py': 'VideoDataset',
    'posec3d/slowonly_r50_u48_240e_ntu60_xsub_limb.py': 'left_kp',
    'tsn/tsn_r50_video_1x1x8_100e_kinetics400_rgb.py': 'VideoDataset',
    'tsm/tsm_r50_video_1x1x8_50e_kinetics400_rgb.py': 'VideoDataset',
    # OpenCVInit / OpenCVDecode over video files: a codec
    'x3d/x3d_s_13x6x1_facebook_kinetics400_rgb.py': 'VideoDataset',
}


def _short(path):
    return '/'.join(path.split(osp.sep)[-2:])


def _types(node):
    if isinstance(node, dict):
        if isinstance(node.get('type'), str):
            yield node['type']
        for v in node.values():
            yield from _types(v)
    elif isinstance(node, (list, tuple)):
        for v in node:
            yield from _types(v)


def _split_cfgs(cfg):
    """Each split's dataset config; a list-valued split (OmniSource's
    train sets) gives each of its sets."""
    for split in ('train', 'val', 'test'):
        node = (cfg.get('data') or {}).get(split)
        for ds_cfg in node if isinstance(node, (list, tuple)) else [node]:
            if ds_cfg is not None:
                yield ds_cfg.to_dict() if hasattr(ds_cfg, 'to_dict') \
                    else dict(ds_cfg)


def _build_data(cfg):
    """Construct each split's dataset (its annotation file unread) and its
    pipeline's steps."""
    for ds_cfg in _split_cfgs(cfg):
        with contextlib.ExitStack() as stack:
            for cls in DATASETS.module_dict.values():
                if 'load_annotations' in vars(cls):
                    stack.enter_context(mock.patch.object(
                        cls, 'load_annotations', lambda self: []))
            dataset = build_dataset(ds_cfg)
        inner = getattr(dataset, 'dataset', None) or dataset
        for d in getattr(inner, 'datasets', [inner]):
            assert isinstance(d.pipeline, Compose)
            assert len(d.pipeline.transforms) == \
                len(ds_cfg.get('pipeline') or ds_cfg['dataset']['pipeline'])


def _build_model(model_cfg):
    cfg = dict(model_cfg)
    cls = RECOGNIZERS.get(cfg.pop('type'))
    if cls is None:
        raise KeyError(f'unknown recognizer {model_cfg["type"]}')
    with torch.device('meta'):
        return cls(**cfg)


def _sweep(path):
    """('full' | 'data' | 'model', the refusal's message)."""
    cfg = Config.fromfile(path)
    types = set(_types(cfg.to_dict()))
    try:
        model = _build_model(cfg.model.to_dict())
    except Exception as e:     # noqa: BLE001 -- every refusal is checked
        return 'model', str(e), types
    del model
    try:
        _build_data(cfg)
    except Exception as e:     # noqa: BLE001
        return 'data', str(e), types
    return 'full', '', types


@pytest.fixture(scope='module')
def sweep():
    return {_short(p): _sweep(p) for p in CONFIGS}


def test_every_config_builds_or_is_refused_by_name(sweep):
    assert len(sweep) == 75
    for name, (stage, msg, types) in sweep.items():
        if stage == 'full':
            continue
        named = [t for t in types if t in msg] + \
            (['left_kp'] if 'left_kp' in msg else [])
        assert named, (name, stage, msg)


def test_the_counts(sweep):
    models = {n for n, (stage, _, _) in sweep.items() if stage != 'model'}
    full = {n for n, (stage, _, _) in sweep.items() if stage == 'full'}
    assert len(models) == 75
    assert full == FULL
    assert models == FULL | set(REFUSED)
    for name, word in REFUSED.items():
        stage, msg, _ = sweep[name]
        assert stage == 'data' and word in msg, (name, msg)
    for name, word in REFUSED.items():
        if word == 'VideoDataset':
            assert 'codec' in sweep[name][1]


def test_the_datasets_are_registered():
    for name in ('RawframeDataset', 'PoseDataset', 'RepeatDataset',
                 'ConcatDataset', 'ImageDataset', 'AudioDataset',
                 'AudioFeatureDataset', 'AudioVisualDataset', 'AVADataset',
                 'RedisAVADataset'):
        assert name in DATASETS


# the MSCL family's last slice: heads, losses, the TwoR5 backbone and the
# host transforms no shipped config names, each registered in the port
MSCL_FAMILY = {
    'models': ('MoCoHeadV2', 'MSFHead', 'NMSFHead', 'MSCLWithAugMSFMxHead',
               'MSCLWithAugDistillMxHead', 'MultiPositiveSumLoss',
               'MultiPositiveUniLoss', 'MultiPositiveCircleLoss',
               'TripletLoss', 'TSMReidSimpleHead', 'FGTSMReidSimpleHead',
               'TSMHead3D', 'RcMoDistHead', 'ResNet3dSlowOnly_TwoR5'),
    'pipelines': ('AlignIndex', 'TemporalShiftSampleFrames', 'FlowToGT',
                  'Flow2ImgWithAug', 'NormFlowWithStidedAugV2',
                  'NormFlowWithAugV2', 'NormFlowV2', 'MoCoNormalizeV2'),
}
# the frame-based family and the OmniSource parts, each registered in the
# port (every head of recognition_heads.py, whether a shipped config names
# it or not)
FRAME_FAMILY = {
    'models': ('Recognizer2D', 'ResNet', 'ResNetTSM', 'C3D', 'MobileNetV2',
               'MobileNetV2TSM', 'ResNetTIN', 'TANet', 'TSNHead', 'TSMHead',
               'TPNHead', 'AudioTSNHead', 'TimeSformerHead', 'X3DHead',
               'SlowFastHead', 'TRNHead'),
    'pipelines': ('ImageDecode', 'BuildPseudoClip'),
    'datasets': ('ImageDataset',),
}
# the 3D recognition zoo and the TPN neck, each registered in the port
ZOO_3D = {
    'models': ('ResNet3dSlowFast', 'ResNet3dCSN', 'ResNet3dLayer',
               'ResNet2Plus1d', 'R3D', 'X3D', 'S3D', 'TimeSformer', 'TPN'),
}
# the external-name 2D backbones, under their own names and the names the
# custom_backbones configs give
EXTERN_2D = {
    'models': ('ResNeXt', 'mmcls.ResNeXt', 'DenseNet',
               'torchvision.densenet161', 'SwinTransformer',
               'timm.swin_base_patch4_window7_224'),
}
# temporal localization and HVU, each registered in the port
LOCALIZATION = {
    'models': ('BMN', 'TEM', 'PEM', 'SSN', 'SSNHead', 'SSNLoss', 'BMNLoss',
               'BinaryLogisticRegressionLoss', 'OHEMHingeLoss', 'HVULoss'),
    'pipelines': ('LoadLocalizationFeature', 'GenerateLocalizationLabels',
                  'LoadProposals', 'LoadHVULabel', 'SampleProposalFrames'),
    'datasets': ('ActivityNetDataset', 'SSNDataset', 'HVUDataset'),
}
# audio recognition, each registered in the port
AUDIO = {
    'models': ('AudioRecognizer', 'ResNetAudio', 'ConvAudio'),
    'pipelines': ('LoadAudioFeature', 'AudioDecodeInit', 'AudioDecode',
                  'AudioFeatureSelector', 'AudioAmplify', 'MelSpectrogram',
                  'MelLogSpectrogram', 'FormatAudioShape'),
    'datasets': ('AudioDataset', 'AudioFeatureDataset',
                 'AudioVisualDataset'),
}
# AVA spatio-temporal detection and the LFB and ACRN heads, each
# registered in the port
DETECTION = {
    'models': ('AVAFastRCNN', 'FastRCNN', 'BBoxHeadAVA',
               'SingleRoIExtractor3D', 'FBOHead', 'LFBInferHead',
               'ACRNHead'),
    'pipelines': ('SampleAVAFrames', 'AVAAssignSample'),
    'datasets': ('AVADataset', 'RedisAVADataset'),
}
# what the JAX registries hold that the port does not (ROADMAP.md Queue
# 1): a gate that later slices shrink and never grow. The 12 pipelines
# left are the video decoders and the third-party wrappers, outside the
# port by design.
MODELS_LEFT = 0
PIPELINES_LEFT = 12


def _registry(kind):
    from mscl_torch.datasets.builder import PIPELINES
    from mscl_torch.models import MODELS
    return dict(models=MODELS, pipelines=PIPELINES, datasets=DATASETS)[kind]


@pytest.mark.parametrize('kind,name', [(k, n) for k, names in
                                       sorted(MSCL_FAMILY.items())
                                       for n in names])
def test_the_mscl_family_is_registered(kind, name):
    assert _registry(kind).get(name) is not None


@pytest.mark.parametrize('kind,name', [(k, n) for k, names in
                                       sorted(FRAME_FAMILY.items())
                                       for n in names])
def test_the_frame_family_is_registered(kind, name):
    assert _registry(kind).get(name) is not None


@pytest.mark.parametrize('kind,name', [(k, n) for k, names in
                                       sorted(ZOO_3D.items())
                                       for n in names])
def test_the_3d_zoo_is_registered(kind, name):
    assert _registry(kind).get(name) is not None


@pytest.mark.parametrize('kind,name', [(k, n) for k, names in
                                       sorted(EXTERN_2D.items())
                                       for n in names])
def test_the_extern_2d_backbones_are_registered(kind, name):
    assert _registry(kind).get(name) is not None


@pytest.mark.parametrize('kind,name', [(k, n) for k, names in
                                       sorted(LOCALIZATION.items())
                                       for n in names])
def test_the_localization_family_is_registered(kind, name):
    assert _registry(kind).get(name) is not None


@pytest.mark.parametrize('kind,name', [(k, n) for k, names in
                                       sorted(AUDIO.items())
                                       for n in names])
def test_the_audio_family_is_registered(kind, name):
    assert _registry(kind).get(name) is not None


@pytest.mark.parametrize('kind,name', [(k, n) for k, names in
                                       sorted(DETECTION.items())
                                       for n in names])
def test_the_detection_family_is_registered(kind, name):
    assert _registry(kind).get(name) is not None


def test_the_jax_registries_left_to_port():
    """Every type the JAX package registers is the port's too, but for
    those the queues still hold; none of the MSCL family among them."""
    import mscl_tpu.datasets  # noqa: F401  (registers the pipelines)
    import mscl_tpu.models  # noqa: F401
    from mscl_tpu.datasets.builder import PIPELINES as JAX_PIPELINES
    from mscl_tpu.models import MODELS as JAX_MODELS
    left = {}
    for kind, jax_registry in (('models', JAX_MODELS),
                               ('pipelines', JAX_PIPELINES)):
        port = _registry(kind)
        # 'test.*' names are the test files' own modules, put into the
        # JAX registries by whichever files a worker ran before this one
        left[kind] = sorted(n for n in jax_registry.module_dict
                            if port.get(n) is None and
                            not n.startswith('test.'))
        assert not set(left[kind]) & set(MSCL_FAMILY[kind])
        assert not set(left[kind]) & set(FRAME_FAMILY[kind])
        assert not set(left[kind]) & set(ZOO_3D.get(kind, ()))
        assert not set(left[kind]) & set(EXTERN_2D.get(kind, ()))
        assert not set(left[kind]) & set(LOCALIZATION[kind])
        assert not set(left[kind]) & set(AUDIO[kind])
        assert not set(left[kind]) & set(DETECTION[kind])
    assert len(left['models']) <= MODELS_LEFT, left['models']
    assert len(left['pipelines']) <= PIPELINES_LEFT, left['pipelines']
