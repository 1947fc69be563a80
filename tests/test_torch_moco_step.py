"""Two consecutive train steps of the plain-MoCo r18 configs' model (MoCo,
fixed momentum, a tower trained on its own with its own device aug) in
mscl_torch against mscl_tpu, one case per config and aug: MoCoAugmentV2,
SyncMoCoAugmentV2 at sync_level 'params' and at 'batch'. Each config's
model, narrowed (r3d_18 8 wide, one block a stage, K=32, dim 32) at B=4,
T=8, 32x32; the aug's draws replayed from JAX's key
(tests/_torch_step_util.py, which states the tolerances)."""
import numpy as np
import pytest

from mscl_torch.config import Config

import _torch_step_util as su
from _torch_port_util import xla3d_conv  # noqa: F401

B, T, HW, K, DIM, WIDTH = 4, 8, 64, 32, 32, 8
CONFIGS = {
    'moco_r18_lr3e-2': 'MoCoAugmentV2',
    'moco_r18_consistent_augmentation_lr3e-2': 'SyncMoCoAugmentV2/params',
    'moco_r18_cosistent_video_lr3e-2': 'SyncMoCoAugmentV2/batch',
}


def narrow_cfg(name):
    cfg = Config.fromfile(
        f'configs/recognition/moco/{name}.py').to_dict()['model']
    cfg['backbone'] = dict(cfg['backbone'], layers=(1, 1, 1, 1),
                           base_width=WIDTH)
    cfg.update(dim_in=WIDTH * 8, K=K, dim=DIM)
    cfg['aug'] = dict(cfg['aug'], crop_size=HW)
    return cfg


def batches():
    rng = np.random.default_rng(31)
    return [{'imgs': [rng.uniform(size=(B, 3, T, HW, HW)).astype(np.float32)
                      for _ in range(2)]} for _ in range(2)]


@pytest.fixture(scope='module', params=sorted(CONFIGS))
def runs(request, xla3d_conv):
    cfg = narrow_cfg(request.param)
    want = CONFIGS[request.param].split('/')
    assert cfg['type'] == 'MoCo' and cfg['aug']['type'] == want[0]
    if len(want) > 1:
        assert cfg['aug']['sync_level'] == want[1]
    return su.two_steps(cfg, batches(), K, B, T)


@pytest.mark.parametrize('step', [0, 1])
def test_losses_match(runs, step):
    su.check_losses(runs, step)
    assert {'loss_cls', 'top1_acc', 'top5_acc', 'loss'} <= \
        set(runs['tlogs'][step])


@pytest.mark.parametrize('step', [0, 1])
def test_queue_state_matches(runs, step):
    su.check_queues(runs, step, [''])
    got = runs['tstates'][step]
    assert int(got['queue_ptr']) == (K - 2 * B + (step + 1) * B) % K
    assert int(got['iters']) == 300 + B * (step + 1)


def test_ema_key_params_match(runs):
    """The key tower, twice EMA'd with the fixed m."""
    su.check_ema(runs)


def test_bn_running_stats_match(runs):
    su.check_bn_stats(runs)


def test_sgd_updated_params_match(runs):
    su.check_sgd(runs)
