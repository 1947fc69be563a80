"""The port's Round-5 tools against the JAX package's, on the CPU:
``mscl_torch.tools.ablation_ordering`` (its data, host draws and batches
bitwise the JAX tool's for one seed, the batch assembled from the videos
as a tensor bitwise its host batch, and ``main --scale tiny --steps 2
--device cpu`` (4 videos a class, batch 8) for each arm writing the JAX tool's JSON),
``shufflebn_ab`` (its videos bitwise, both runs' JSON) and
``ablation_summary`` (the same table and JSON as the JAX copy over the
same files)."""
import json
import shutil
import sys

import numpy as np
import pytest
import torch

from mscl_torch.tools import ablation_ordering as tool
from mscl_torch.tools import ablation_summary as summary
from mscl_torch.tools import shufflebn_ab

from _torch_data_util import one_torch_thread  # noqa: F401

EVIDENCE = 'docs/evidence/ablation'
pytestmark = pytest.mark.usefixtures('one_torch_thread')


@pytest.fixture(scope='module')
def jax_tool():
    from tools.analysis import ablation_ordering
    return ablation_ordering


@pytest.fixture(scope='module')
def videos(jax_tool):
    return (tool.make_videos(3, 32, 4, seed=7),
            jax_tool.make_videos(3, 32, 4, seed=7))


@pytest.mark.parametrize('arm', tool.ARMS)
def test_host_batches_are_the_jax_tools(videos, jax_tool, arm):
    data, jdata = videos
    for k in ('rgb', 'flow', 'labels', 'best', 'worst', 'n_off'):
        np.testing.assert_array_equal(data[k], jdata[k], err_msg=k)
    for c, jc in zip(data['chosen'], jdata['chosen']):
        np.testing.assert_array_equal(c, jc)
    train_idx = np.arange(len(data['labels']))[::2]
    rngs = [np.random.default_rng(3) for _ in range(3)]
    for _ in range(2):
        host = tool.make_batch(rngs[0], data, train_idx, arm, 6, 4)
        want = jax_tool.make_batch(rngs[1], jdata, train_idx, arm, 6, 4)
        idx = tool.sample_batch_idx(rngs[2], data, train_idx, arm, 6, 4)
        dev = tool.assemble_batch(torch.from_numpy(data['rgb']),
                                  torch.from_numpy(data['flow']), *idx, arm,
                                  4)
        assert set(host) == set(want) == set(dev)
        for key in host:
            for b in (0, 1):
                assert host[key][b].dtype == want[key][b].dtype
                np.testing.assert_array_equal(host[key][b], want[key][b])
                np.testing.assert_array_equal(dev[key][b].numpy(),
                                              host[key][b])
    # each path took as many draws
    draws = [r.integers(0, 1 << 30) for r in rngs]
    assert draws[0] == draws[1] == draws[2]


@pytest.mark.parametrize('arm', tool.ARMS)
def test_main_writes_the_jax_tools_json(tmp_path, arm):
    record = tool.main(['--arm', arm, '--scale', 'tiny', '--steps', '2',
                        '--n-per-class', '4', '--batch', '8',
                        '--device', 'cpu',
                        '--out-dir', str(tmp_path)])
    with open(tmp_path / f'{arm}_tiny_s0.json') as f:
        written = json.load(f)
    with open(f'{EVIDENCE}/{arm}_full_s0.json') as f:
        jax_record = json.load(f)

    def shape(d):
        return {k: shape(v) if isinstance(v, dict) else type(v).__name__
                for k, v in d.items() if k != 'losses'}
    assert shape(written) == shape(jax_record)
    assert sorted(written['losses']) == ['0', '1']
    assert written['losses']['1'].keys() == jax_record['losses']['0'].keys()
    assert written == json.loads(json.dumps(record))
    assert (written['platform'], written['steps'], written['batch'],
            written['K'], written['hw'], written['T'],
            written['n_videos']) == ('cpu', 2, 8, 256, 32, 4, 16)
    for when in ('init', 'final'):
        m = written[when]
        assert all(0 <= v <= 1 for v in (m['motion']['R@1'],
                                         m['motion']['R@5'], m['probe_acc'],
                                         m['instance_R1']))


def test_summary_is_the_jax_tools(tmp_path, monkeypatch, capsys):
    for arm in ('moco', 'mscl'):
        shutil.copy(f'{EVIDENCE}/{arm}_full_s0.json', tmp_path)
    from tools.analysis import ablation_summary as jax_summary
    monkeypatch.setattr(sys, 'argv', [
        'ablation_summary.py', '--dir', str(tmp_path), '--out',
        str(tmp_path / 'jax.json')])
    jax_summary.main()
    jax_table = capsys.readouterr().out
    got = summary.main(['--dir', str(tmp_path), '--out',
                        str(tmp_path / 'port.json')])
    assert capsys.readouterr().out.replace('port.json', 'jax.json') == \
        jax_table
    with open(tmp_path / 'jax.json') as f:
        assert got == json.load(f)
    assert set(got['arms']) == {'moco', 'mscl'}


def test_shufflebn_ab_writes_its_json(tmp_path):
    from tools.analysis import shufflebn_ab as jax_ab
    for got, want in zip(shufflebn_ab.make_videos(n_per_class=2),
                         jax_ab.make_videos(n_per_class=2)):
        np.testing.assert_array_equal(got, want)
    out = shufflebn_ab.main(['--steps', '2', '--batch', '8', '--device',
                             'cpu', '--out', str(tmp_path / 'ab.json')])
    with open(tmp_path / 'ab.json') as f:
        assert json.load(f) == json.loads(json.dumps(out))
    assert set(out) == {'global_bn', 'shuffle_bn4'}
    for r in out.values():
        assert set(r) == {'losses', 'R@1', 'R@5'} and len(r['losses']) == 2
        assert all(np.isfinite(r['losses'])) and 0 <= r['R@1'] <= r['R@5']
