"""What the ablation-family step tests share: the ablation tool's tiny
scale (``abl.tiny3d`` towers, 32x32, T = 4, K = 256) at B = 8, its arms'
configs as the JAX tool builds them, its own host batches, the option
cases, and the checks of two steps against JAX's
(tests/_torch_step_util.py, which states the tolerances; JAX runs in
float64 there, see ``two_steps(x64=True)``). A test file imports the
checks and defines a module fixture ``runs`` over its cases, so the cases
spread over the workers of a parallel run."""
import json

import numpy as np
import pytest

from mscl_torch.tools import ablation_ordering as tool

import _torch_step_util as su

B, T, HW, K = 8, 4, 32, 256
KEYS = ['flow_imgs', 'rot_flow_imgs']   # both end as the aug's flow_suffix
OPTIONS = ('batch_flow_passes', 'two_flow_keys', 'shuffle_bn')


def jax_arm_cfg(arm):
    """The model config the JAX tool builds for an arm (its build_arm,
    with the JAX builder replaced by one that returns the config)."""
    from mscl_tpu.apis import train as jax_train
    from tools.analysis import ablation_ordering as jax_tool
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_train, 'build_model_from_cfg',
                   lambda cfg, dtype=None: cfg)
        return jax_tool.build_arm(arm, 'tiny', T, K, 300, 16, HW)


def arm_cfg(arm):
    """The port tool's config of an arm, checked equal to the JAX tool's
    (which registers abl.tiny3d in JAX's registry on the way)."""
    cfg = tool.arm_cfg(arm, 'tiny', T, K, 300, 16, HW)
    assert json.dumps(cfg, sort_keys=True) == json.dumps(
        jax_arm_cfg(arm), sort_keys=True)
    return cfg


def tool_batches(arm, seed=0):
    data = tool.make_videos(4, HW, T, seed=100)
    train_idx = np.arange(len(data['labels']))[::2]
    rng = np.random.default_rng(seed)
    return [tool.make_batch(rng, data, train_idx, arm, B, T)
            for _ in range(2)]


def two_keys(batch):
    """The concatenated flow split into the base and rotated keys."""
    out = dict(batch)
    flows = out.pop('flow_imgs')
    out[KEYS[0]] = [f[:, :, :T] for f in flows]
    out[KEYS[1]] = [f[:, :, T:] for f in flows]
    return out


def case_runs(case):
    """Two JAX steps and two port steps of an arm, or of the full arm with
    one option: its flow passes as one forward, under two flow keys, or
    ShuffleBN (4 groups) in both towers."""
    if case not in OPTIONS:
        return su.two_steps(arm_cfg(case), tool_batches(case), K, B, T,
                            x64=True)
    cfg, batches = arm_cfg('mscl'), tool_batches('mscl')
    if case == 'batch_flow_passes':
        cfg['batch_flow_passes'] = True
    elif case == 'two_flow_keys':
        cfg['flow_key'] = list(KEYS)
        batches = [two_keys(b) for b in batches]
    else:
        for tower in ('recognizer', 'recognizer_flow'):
            cfg[tower] = dict(cfg[tower], shuffle_bn=4)
    return su.two_steps(cfg, batches, K, B, T, x64=True)


def towers(runs):
    return [p for p, _ in su.towers(runs['model'])]


@pytest.mark.parametrize('step', [0, 1])
def test_losses_match(runs, step):
    su.check_losses(runs, step)
    assert 'loss' in runs['tlogs'][step]


@pytest.mark.parametrize('step', [0, 1])
def test_queue_state_matches(runs, step):
    su.check_queues(runs, step, towers(runs))


def test_ema_key_params_match(runs):
    su.check_ema(runs)


def test_bn_running_stats_match(runs):
    su.check_bn_stats(runs)


def test_sgd_updated_params_match(runs):
    su.check_sgd(runs)
