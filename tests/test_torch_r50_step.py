"""Two consecutive train steps of the r50 pretrain configs' models in
mscl_torch against mscl_tpu: MoCo on ResNet3dSlowOnly-50
(moco_r50_consistent_augmentation_lr3e-2.py, SyncMoCoAugmentV2) and
MSCLWithAug with the mscl_r50 towers (mscl_r50_cosm_lr3e-2.py:
ResNet3dSlowOnly-50 + TPNMoCo with SEPC at stride (1,2,2) and one Pconv,
resnet_flow.r2d_50 + BaseMoCo, LMCL with trans_flow, SyncMoCoAugmentV5).

Each config's model as it stands, narrowed: one block a stage, SlowOnly
4 wide, r2d_50 2 wide (its last stage 64 channels, bkb_channels (None,
64)), the TPN at its 128, K=32, dim 32; B=4, T=8, RGB and flows 64x64 (flows
T=8 each half), the aug's draws replayed from JAX's key
(tests/_torch_step_util.py, which states the tolerances). At 64x64 the
last stages are 2x2 (RGB) and 1x1 (flow), as 224 and 112 would be 7x7 and
4x4 at full width.
"""
import numpy as np
import pytest

from mscl_torch.apis import flagship_batch
from mscl_torch.config import Config

import _torch_step_util as su
from _torch_port_util import xla3d_conv  # noqa: F401

B, T, HW, FLOW_HW, K, DIM = 4, 8, 64, 64, 32, 32
RGB_W, FLOW_W, TPN = 4, 2, 128


def _cfg(name):
    return Config.fromfile(
        f'configs/recognition/moco/{name}.py').to_dict()['model']


def _narrow_slowonly(tower):
    tower['backbone'] = dict(tower['backbone'], stage_blocks=(1, 1, 1, 1),
                             base_channels=RGB_W)
    tower.update(dim_in=RGB_W * 8 * 4, K=K, dim=DIM)


def moco_r50_cfg():
    cfg = _cfg('moco_r50_consistent_augmentation_lr3e-2')
    _narrow_slowonly(cfg)
    cfg['aug'] = dict(cfg['aug'], crop_size=HW)
    return cfg


def mscl_r50_cfg():
    cfg = _cfg('mscl_r50_cosm_lr3e-2')
    rgb, flow = cfg['recognizer'], cfg['recognizer_flow']
    _narrow_slowonly(rgb)
    rgb['neck'] = dict(rgb['neck'], in_channels=[
        RGB_W * 4 * 2, RGB_W * 4 * 4, RGB_W * 4 * 8])
    flow['backbone'] = dict(flow['backbone'], layers=(1, 1, 1, 1),
                            base_width=FLOW_W)
    flow.update(dim_in=FLOW_W * 8 * 4, K=K, dim=DIM)
    cfg['sup_head'] = dict(cfg['sup_head'], bkb_channels=(None, FLOW_W * 32))
    cfg['aug'] = dict(cfg['aug'], crop_size=HW)
    assert rgb['neck']['out_channels'] == TPN
    return cfg


CASES = {'moco_r50': moco_r50_cfg, 'mscl_r50': mscl_r50_cfg}


def _batches(name):
    if name == 'mscl_r50':
        return [flagship_batch(B, num_frames=T, hw=HW, flow_hw=FLOW_HW,
                               seed=s) for s in (41, 42)]
    rng = np.random.default_rng(43)
    return [{'imgs': [rng.uniform(size=(B, 3, T, HW, HW)).astype(np.float32)
                      for _ in range(2)]} for _ in range(2)]


@pytest.fixture(scope='module', params=sorted(CASES))
def runs(request, xla3d_conv):
    return request.param, su.two_steps(CASES[request.param](),
                                       _batches(request.param), K, B, T)


@pytest.mark.parametrize('step', [0, 1])
def test_losses_match(runs, step):
    name, r = runs
    su.check_losses(r, step)
    if name == 'mscl_r50':
        assert {'loss_cls', 'loss_cls_flow', 'loss_cls_flow_aug',
                'loss_cls_mx', 'loss_cls_mx_aug', 'loss_pos'} <= \
            set(r['tlogs'][step])


@pytest.mark.parametrize('step', [0, 1])
def test_queue_state_matches(runs, step):
    name, r = runs
    su.check_queues(r, step, [''] if name == 'moco_r50' else
                    ['recognizer.', 'recognizer_flow.'])


def test_ema_key_params_match(runs):
    su.check_ema(runs[1])


def test_bn_running_stats_match(runs):
    su.check_bn_stats(runs[1])


def test_sgd_updated_params_match(runs):
    su.check_sgd(runs[1])


def test_r50_geometry(runs):
    """T = 4 at every level the LMCL head and SEPC see."""
    name, r = runs
    model = r['model']
    if name == 'moco_r50':
        assert type(model).__name__ == 'MoCo'
        return
    assert model.sup_head.trans_flow.in_features == FLOW_W * 32
    assert model.recognizer.neck_q.tpn.sepc.Pconv_num == 1
