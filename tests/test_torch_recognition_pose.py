"""The PoseC3D keypoint recipes (NTU-60 and NTU-120) through
``train_model`` against mscl_tpu's (tests/_torch_recognition_util.py),
and the refusals: a Recognizer3D batch whose channel axis is not the
backbone's ``in_channels`` (the NTHWC configs ``i3d_r50_32x2x1`` and
``slowonly_r50_4x16x1_..._rgb``, stopped before their first step), the
PoseC3D limb config's train pipeline (``left_kp``) and the video config
(``VideoDataset``)."""
import os
import os.path as osp

import pytest
import torch

from mscl_torch.apis import build_model_from_cfg, train_model
from mscl_torch.config import Config

from _torch_data_util import one_torch_thread  # noqa: F401
from _torch_port_util import xla3d_conv  # noqa: F401
from _torch_recognition_util import check, narrow_cfg, sets  # noqa: F401

pytestmark = pytest.mark.usefixtures('one_torch_thread')
P = 'skeleton/posec3d/'
NTHWC = ['recognition/i3d/i3d_r50_32x2x1_100e_kinetics400_rgb.py',
         'recognition/slowonly/slowonly_r50_4x16x1_256e_kinetics400_rgb.py']


@pytest.mark.parametrize('name', [
    P + 'slowonly_r50_u48_240e_ntu60_xsub_keypoint.py',
    P + 'slowonly_r50_u48_240e_ntu120_xsub_keypoint.py'])
def test_train_model_matches_jax(sets, tmp_path, xla3d_conv, name):
    check(name, *sets['pose'], str(tmp_path), True, x64=True)


def test_a_channels_last_batch_is_refused():
    cfg = narrow_cfg(NTHWC[0], '', '', '', False)['model']
    model = build_model_from_cfg(cfg, device='cpu')
    clip = torch.zeros(2, 1, 8, 16, 16, 3)          # FormatShape('NTHWC')
    for call in (lambda: model.forward_train(clip, torch.zeros(2)),
                 lambda: model.forward_test(clip),
                 lambda: model.extract_features_pooled(clip)):
        with pytest.raises(ValueError, match=r"NTHWC.*in_channels|"
                           r"in_channels.*NTHWC"):
            call()
    model.eval()
    assert model.forward_test(torch.zeros(2, 1, 3, 8, 16, 16)).shape == \
        (2, 400)


@pytest.mark.parametrize('name', NTHWC)
def test_nthwc_configs_stop_before_their_first_step(sets, tmp_path, name):
    cfg = narrow_cfg(name, *sets['rgb'], str(tmp_path), False)
    with pytest.raises(ValueError, match="FormatShape\\('NTHWC'\\)"):
        train_model(Config.fromdict(cfg), validate=False, seed=0,
                    device='cpu')
    log = osp.join(str(tmp_path), 'log.json')
    assert not osp.exists(log) or not open(log).read().strip()
    assert not [f for f in os.listdir(str(tmp_path)) if f.endswith('.pth')]


@pytest.mark.parametrize('name,word', [
    (P + 'slowonly_r50_u48_240e_ntu60_xsub_limb.py', 'left_kp'),
    ('recognition/i3d/i3d_r50_video_32x2x1_100e_kinetics400_rgb.py',
     'VideoDataset'),
])
def test_refused_configs(sets, tmp_path, name, word):
    kind = 'pose' if 'posec3d' in name else 'rgb'
    cfg = narrow_cfg(name, *sets[kind], str(tmp_path), False)
    with pytest.raises((TypeError, NotImplementedError), match=word):
        train_model(Config.fromdict(cfg), validate=False, seed=0,
                    device='cpu')
