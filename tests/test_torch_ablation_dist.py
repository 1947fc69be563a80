"""The ablation family's options in a process group (``mscl_torch/
parallel``) on the CPU: two steps of the narrow MSCLWithAug with
SyncMoCoAugmentV5 (tests/_torch_dist_util.py ``mscl_steps``, a global
batch of 8) with ShuffleBN in both towers (``shuffle_bn=4``: the key clips
gathered, one permutation of the global batch drawn alike on every rank,
four groups with their own BN statistics) and with the flow passes as one
forward (``batch_flow_passes``), at n = 2 and 4 gloo ranks against one
device with no group: the ``shuffle_bn`` and ``flow_batched`` arms of
tests/test_distributed.py's ``test_n8_equals_n1``. The world of one is
held against JAX in tests/test_torch_ablation_options.py and
test_torch_ablation_shuffle_bn.py. Tolerances: as
tests/test_torch_distributed.py (losses 2e-4, queues 2e-5 with count,
queue_ptr and iters exact, EMA 1e-5, BN statistics 1e-4, parameters after
SGD 5e-3 / 1e-4), and every rank's state the same."""
import numpy as np
import pytest
import torch

import _torch_dist_util as du
from mscl_torch.apis import MOCO_FREEZE
from mscl_torch.parallel import dist

from _torch_data_util import one_torch_thread  # noqa: F401

JOIN_S = 300
OPTIONS = ('shuffle_bn', 'flow_batched')
pytestmark = pytest.mark.usefixtures('one_torch_thread')


@pytest.fixture(scope='module')
def one():
    return du.ablation_options()


@pytest.fixture(scope='module')
def groups():
    return {n: dist.spawn(du.ablation_options, n, device='cpu',
                          join_timeout_s=JOIN_S) for n in (2, 4)}


def _close(got, want, rtol, atol, what):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol, err_msg=what)


def _families(k):
    if k.endswith(('queue', 'count', 'queue_ptr', 'iters')):
        return 'queue'
    if 'running' in k:
        return 'bn'
    if any(f'.{p}.' in k for p in MOCO_FREEZE):
        return 'ema'
    return 'sgd'


TOL = dict(queue=(0, 2e-5), bn=(1e-4, 1e-5), ema=(1e-5, 1e-6),
           sgd=(5e-3, 1e-4))


@pytest.mark.parametrize('world', [2, 4])
@pytest.mark.parametrize('option', OPTIONS)
def test_option_matches_one_device(one, groups, option, world):
    """Every logged value after each step, then the state after each step
    by family; count, queue_ptr and iters exactly."""
    want = one[option]
    for r, res in enumerate(groups[world]):
        got = res[option]
        for step in (0, 1):
            assert sorted(got['logs'][step]) == sorted(want['logs'][step])
            for k, v in want['logs'][step].items():
                _close(got['logs'][step][k], v, 2e-4, 2e-4,
                       f'{k} step {step} rank {r}')
            for k, v in want['states'][step].items():
                g = got['states'][step][k]
                if k.endswith(('count', 'queue_ptr', 'iters')):
                    assert torch.equal(g, v), (k, step, r)
                    continue
                rtol, atol = TOL[_families(k)]
                _close(g, v, rtol, atol, f'{k} step {step} rank {r}')


@pytest.mark.parametrize('world', [2, 4])
@pytest.mark.parametrize('option', OPTIONS)
def test_option_ranks_hold_one_state(groups, option, world):
    runs = [res[option] for res in groups[world]]
    for res in runs[1:]:
        for step in (0, 1):
            assert res['logs'][step] == runs[0]['logs'][step]
            for k, v in runs[0]['states'][step].items():
                assert torch.equal(res['states'][step][k], v), k


@pytest.mark.parametrize('option', OPTIONS)
def test_option_gathers_and_calls(one, groups, option):
    """7 l_neg and 7 dq products a step on each rank; ShuffleBN gathers
    the key clips once a tower pass (3 a step), the flow passes as one
    forward gather the keys twice."""
    assert one[option]['collectives'] == {}
    for res in groups[2]:
        got = res[option]
        assert got['calls'] == [dict(l_neg_plain=7, dq_plain=7)] * 2
        c = got['collectives']
        assert c['moco_keys']['calls'] == 2 * 2
        if option == 'shuffle_bn':
            assert c['shuffle_bn']['calls'] == 2 * 3
        else:
            assert 'shuffle_bn' not in c
