"""mscl_torch's tensor-core fill probes against the Pallas probes of
tools/analysis/bench_mxu_fill.py, on the CPU: each JAX probe runs in TPU
interpret mode, the port runs its plain version (what the CUDA kernels are
held to on the card), from the same bf16 inputs. Also the port's CLI on the
CPU, and its refusal to run without a card unless told."""
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mscl_torch.ops import mxu_fill as mf
from mscl_torch.tools import bench_mxu_fill as bm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOL = os.path.join(ROOT, 'tools', 'analysis', 'bench_mxu_fill.py')
# One bf16 rounding of a float32 sum taken in another order: 2^-7 relative
# at the output's size (entries up to about 1 here).
TOL = dict(rtol=1e-2, atol=1e-2)
STEPS = 2

# name -> (kind, shape parameters); m=32, n=64 throughout
CASES = {
    'probe_inner4': ('probe', dict(k=64, inner=4)),
    'probe_odd_inner3': ('probe', dict(k=64, inner=3)),
    'probe_k128': ('probe', dict(k=128, inner=4)),
    'carry_mt16': ('carry', dict(mt=16, k=64, inner=4)),
    'carry_mt_m': ('carry', dict(mt=32, k=64, inner=4)),
    'bigdot': ('bigdot', dict(k=128)),
    'imcat': ('imcat', dict(k=64, inner=4)),
    'paircat': ('paircat', dict(k=64, inner=4)),
}
M, N = 32, 64


@pytest.fixture(scope='module')
def jtool():
    """The JAX tool, loaded from its file (tools/ is not a package)."""
    spec = importlib.util.spec_from_file_location('jax_bench_mxu_fill', TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inputs(kind, shape, seed=0):
    """float32 numpy x and w of a probe, the weights scaled by 0.05; both
    sides round them to bf16 the same way (to nearest even)."""
    x_shape, w_shape = mf._shapes(kind, M, n=N, **shape)
    rng = np.random.default_rng(seed)
    return (rng.normal(size=x_shape).astype(np.float32),
            (0.05 * rng.normal(size=w_shape)).astype(np.float32))


def _jax(jtool, kind, shape, x, w):
    k, inner = shape['k'], shape.get('inner')
    make = {'probe': lambda: jtool.make_probe(M, k, N, inner, STEPS),
            'carry': lambda: jtool.make_probe_carry(M, shape['mt'], k, N,
                                                    inner, STEPS),
            'bigdot': lambda: jtool.make_probe_bigdot(M, k, N, STEPS),
            'imcat': lambda: jtool.make_probe_imcat(M, k, N, inner, STEPS),
            'paircat': lambda: jtool.make_probe_paircat(M, k, N, inner,
                                                        STEPS)}[kind]
    with pltpu.force_tpu_interpret_mode():
        out = make()(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16))
        return np.asarray(out.astype(jnp.float32))


def _port(kind, shape, x, w, steps=STEPS):
    xt, wt = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, w))
    return mf.ENTRY_POINTS[kind](xt, wt, m=M, n=N, steps=steps, **shape)


@pytest.mark.parametrize('case', sorted(CASES))
def test_plain_matches_jax_probe(jtool, case):
    kind, shape = CASES[case]
    x, w = _inputs(kind, shape)
    want = _jax(jtool, kind, shape, x, w)
    launches = mf.ENTRY_POINTS[kind].launches
    got = _port(kind, shape, x, w)
    assert mf.ENTRY_POINTS[kind].launches == launches   # the CPU runs no kernel
    assert got.dtype == torch.bfloat16 and got.shape == want.shape == (M, N)
    np.testing.assert_allclose(got.float().numpy(), want, **TOL)
    assert np.abs(want).max() > 0.1


def test_pair_order_is_paircat_s_not_the_tap_loop_s():
    """imcat and paircat compute one function (paircat's w is imcat's cut
    into pairs), and it is not the tap loop's: for odd pairs the two reads
    come at offsets 8 then 0."""
    x, w = _inputs('imcat', dict(k=64, inner=4))
    xt, wt = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, w))
    imcat = mf.probe_imcat(xt, wt, M, 64, N, 4)
    paircat = mf.probe_paircat(xt, wt.reshape(2, 128, N), M, 64, N, 4)
    tap_loop = mf.probe(xt, wt.reshape(4, 64, N), M, 64, N, 4)
    np.testing.assert_allclose(imcat.float().numpy(), paircat.float().numpy(),
                               **TOL)
    assert (imcat.float() - tap_loop.float()).abs().max() > 0.5


@pytest.mark.parametrize('case', ['probe_odd_inner3', 'carry_mt16', 'bigdot',
                                  'imcat', 'paircat'])
def test_steps_repeat_the_work_not_the_result(case):
    """Every step computes the same pass, so steps leaves the result as it
    is; the float64 reference agrees within one bf16 rounding."""
    kind, shape = CASES[case]
    x, w = _inputs(kind, shape, seed=1)
    one, three = (_port(kind, shape, x, w, steps=s) for s in (1, 3))
    assert torch.equal(one, three)
    ref = mf.reference(kind, *(torch.from_numpy(a).to(torch.bfloat16)
                               for a in (x, w)), m=M, n=N, **shape)
    assert ref.dtype == torch.float64
    assert (one.double() - ref).abs().max() <= 8e-3 * ref.abs().max()


def test_cli_case_lists_are_the_jax_tool_s():
    with open(TOOL) as f:
        source = f.read()
    names = [c.name for mode in ('', 'carry', 'kchain')
             for c in bm.cases(mode)]
    assert len(names) == 18
    for name in names:
        if name.startswith('bigdot  K=') and 'N=64' in name:
            continue                     # an f-string in the JAX tool
        assert repr(name) in source, name
    assert "f'bigdot  K={kk:4d} N=64 '" in source
    assert [bm.flops_per_pass(c) for c in bm.cases('')[:1] +
            bm.cases('kchain')[2:3]] == [718405632, 745013248]
    assert bm.default_steps(bm.cases('')[0]) == max(8, int(2e13 / 718405632))


@pytest.mark.parametrize('flags', [[], ['--carry'], ['--kchain']])
def test_cli_runs_the_plain_versions_on_the_cpu(capsys, flags):
    results = bm.main(flags + ['--device', 'cpu', '--iters', '1',
                               '--steps', '1'])
    mode = flags[0][2:] if flags else ''
    assert [r['name'] for r in results] == [c.name.strip()
                                           for c in bm.cases(mode)]
    assert all(r['steps'] == 1 and r['ms'] > 0 and 'peak_share' not in r
               for r in results)
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == len(results)
    assert all('TF/s (CPU, plain version)' in line for line in lines)


def test_cli_needs_the_card_unless_told():
    if torch.cuda.is_available():
        pytest.skip('this box has a CUDA device')
    with pytest.raises(RuntimeError, match='CUDA'):
        bm.main(['--iters', '1', '--steps', '1'])
