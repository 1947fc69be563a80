"""mscl_torch's PWC-Lite (ARFlow) against mscl_tpu's, on the CPU: the cost
volume, the warp and the align-corners resize within 1e-6; the whole model
at 64x64, N = 2, in 2-frame mode with and without the backward pass and in
3-frame mode, from perturbed weights carried over with
``pwclite_jax_to_state_dict``; and the extraction CLI's ARFlow function
(edge padding to multiples of 64, cropping back) against the JAX CLI's
formula."""
import jax
import numpy as np
import pytest
import torch

from mscl_tpu.flow import pwclite as jpwc
from mscl_torch.apis import flow_extraction as tfe
from mscl_torch.convert import pwclite_jax_to_state_dict
from mscl_torch.flow import pwclite as tpwc

from _torch_data_util import one_torch_thread  # noqa: F401
from _torch_port_util import perturb, t

# one torch thread: small CPU forwards slow down tenfold when the other
# test processes share the cores
pytestmark = pytest.mark.usefixtures('one_torch_thread')
HW = 64
# the ops: float32 sums of at most a few hundred terms in another order
OP_TOL = 1e-6
# whole flows: float32 convolutions of two frameworks, relative to each
# level's largest entry
REL = 1e-4


def nchw(x):
    return np.transpose(np.asarray(x), (0, 3, 1, 2))


def nhwc(x):
    return np.transpose(np.asarray(x), (0, 2, 3, 1))


@pytest.mark.parametrize('radius', [1, 4])
def test_cost_volume(radius):
    rng = np.random.default_rng(radius)
    x1 = rng.normal(size=(2, 9, 11, 16)).astype(np.float32)
    x2 = rng.normal(size=(2, 9, 11, 16)).astype(np.float32)
    ref = np.asarray(jpwc.cost_volume(x1, x2, radius))
    out = tpwc.cost_volume(t(nchw(x1)), t(nchw(x2)), radius)
    assert out.shape == (2, (2 * radius + 1) ** 2, 9, 11)
    np.testing.assert_allclose(nhwc(out.numpy()), ref, rtol=0, atol=OP_TOL)


@pytest.mark.parametrize('case', ['identity', 'shift', 'out_of_range'])
def test_flow_warp(case):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 10, 13, 5)).astype(np.float32)
    flow = {'identity': np.zeros((2, 10, 13, 2)),
            'shift': np.broadcast_to([2.25, -1.5], (2, 10, 13, 2)),
            'out_of_range': rng.normal(scale=12.0, size=(2, 10, 13, 2))
            }[case].astype(np.float32)
    ref = np.asarray(jpwc.flow_warp(x, flow))
    out = tpwc.flow_warp(t(nchw(x)), t(nchw(flow)))
    np.testing.assert_allclose(nhwc(out.numpy()), ref, rtol=0, atol=OP_TOL)
    if case == 'identity':
        np.testing.assert_array_equal(nhwc(out.numpy()), x)


@pytest.mark.parametrize('hw,out_hw', [((4, 5), (8, 10)), ((7, 3), (28, 12)),
                                       ((1, 6), (4, 24))])
def test_resize_align(hw, out_hw):
    x = np.random.default_rng(4).normal(size=(2,) + hw + (3,)) \
        .astype(np.float32)
    ref = np.asarray(jpwc._resize_align(x, *out_hw))
    out = tpwc._resize_align(t(nchw(x)), *out_hw)
    np.testing.assert_allclose(nhwc(out.numpy()), ref, rtol=0, atol=OP_TOL)
    if out_hw == (2 * hw[0], 2 * hw[1]):
        np.testing.assert_array_equal(
            tpwc.upsample2x_align(t(nchw(x))).numpy(), out.numpy())


def _jax_variables(tmodel):
    """The port's seeded weights as flax variables (conv kernels OIHW ->
    HWIO under the same module path); ``pwclite_jax_to_state_dict`` must
    carry them back unchanged."""
    params = {}
    for name, value in tmodel.state_dict().items():
        *path, leaf = name.split('.')
        node = params
        for seg in path:
            node = node.setdefault(seg, {})
        a = value.numpy()
        node['kernel' if leaf == 'weight' else 'bias'] = \
            np.transpose(a, (2, 3, 1, 0)) if leaf == 'weight' else a
    v = {'params': perturb(params, 1, 0.05)}
    sd = {k: t(a) for k, a in pwclite_jax_to_state_dict(v).items()}
    tmodel.load_state_dict(sd, strict=True)
    return v


def _jax_flows(jmodel, v, x, with_bk=False):
    """JAX's apply, compiled without LLVM's expensive passes (the same
    flows, a fifth less compile time)."""
    fn = jax.jit(lambda v, x: jmodel.apply(v, x, with_bk=with_bk))
    return fn.lower(v, x).compile(compiler_options={
        'xla_llvm_disable_expensive_passes': True})(v, x)


def _pair(n_frames):
    tmodel = tpwc.PWCLite(n_frames=n_frames)
    tmodel.init_weights(torch.Generator().manual_seed(n_frames))
    v = _jax_variables(tmodel)
    return jpwc.PWCLite(n_frames=n_frames), v, tmodel.eval()


# the ARFlow function's input: 40x50 frames, edge-padded to 64x64 as it
# pads them; the 2-frame fixture's frames are those pads, scaled to [0, 1]
ARFLOW_HW = (40, 50)


@pytest.fixture(scope='module')
def pairs_uint8():
    rng = np.random.default_rng(5)
    img1 = rng.integers(0, 256, (2,) + ARFLOW_HW + (3,)).astype(np.uint8)
    return img1, np.roll(img1, (2, 3), axis=(1, 2))


@pytest.fixture(scope='module')
def two(pairs_uint8):
    """The 2-frame model pair and JAX's flows (with the backward pass) on
    the padded pairs."""
    jmodel, v, tmodel = _pair(2)
    pad = ((0, 0), (0, HW - ARFLOW_HW[0]), (0, HW - ARFLOW_HW[1]), (0, 0))
    x = (np.stack([np.pad(i, pad, mode='edge') for i in pairs_uint8],
                  axis=1) / 255.0).astype(np.float32)
    ref = _jax_flows(jmodel, v, x, with_bk=True)
    return dict(tmodel=tmodel, x=x, ref=ref)


@pytest.fixture(scope='module')
def frames():
    """Three frames (N = 2) in [0, 1] of a moving pattern."""
    rng = np.random.default_rng(0)
    base = rng.uniform(0, 1, (2, HW + 8, HW + 8, 3)).astype(np.float32)
    return np.stack([base[:, i:i + HW, 2 * i:2 * i + HW] for i in range(3)],
                    axis=1)


def _check_levels(out, ref):
    assert len(out) == len(ref) == 5
    for o, r in zip(out, ref):
        r = np.asarray(r)
        o = nhwc(o.numpy())
        assert o.shape == r.shape
        np.testing.assert_allclose(o, r, rtol=REL,
                                   atol=REL * np.abs(r).max())


@pytest.mark.parametrize('with_bk', [False, True])
def test_two_frames(two, with_bk):
    """JAX's forward flows do not depend on ``with_bk``: one JAX run
    holds both. Without the backward pass the input is the reference's
    NCHW layout, (N, 6, H, W); with it, (N, 2, H, W, 3)."""
    tmodel, x, ref = two['tmodel'], two['x'], two['ref']
    if not with_bk:
        x = np.concatenate([nchw(x[:, 0]), nchw(x[:, 1])], axis=1)
    with torch.no_grad():
        out = tmodel(t(x), with_bk=with_bk)
    assert set(out) == ({'flows_fw', 'flows_bw'} if with_bk
                        else {'flows_fw'})
    _check_levels(out['flows_fw'], ref['flows_fw'])
    assert ref['flows_fw'][0].shape == (2, HW, HW, 2)
    if with_bk:
        _check_levels(out['flows_bw'], ref['flows_bw'])


def test_three_frames(frames):
    jmodel, v, tmodel = _pair(3)
    ref = _jax_flows(jmodel, v, frames)
    with torch.no_grad():
        out = tmodel(t(frames))
    _check_levels(out['flows_fw'], ref['flows_fw'])
    _check_levels(out['flows_bw'], ref['flows_bw'])


def test_arflow_fn_pads_and_crops(two, pairs_uint8, monkeypatch):
    """At 40x50 (padded to 64x64) the port's ARFlow function gives what
    the JAX CLI's ``arflow_fn`` computes (edge pad, / 255, stack,
    ``flows_fw[0]``, crop): JAX's flows on the padded pairs, cropped."""
    monkeypatch.setattr(tfe, 'build_pwclite', lambda *a, **k: two['tmodel'])
    out = tfe.make_arflow_fn(seed=0, device='cpu')(*pairs_uint8)
    ref = np.asarray(two['ref']['flows_fw'][0])[:, :ARFLOW_HW[0],
                                                 :ARFLOW_HW[1]]
    assert out.shape == ref.shape == (2,) + ARFLOW_HW + (2,)
    assert out.dtype == np.float32
    np.testing.assert_allclose(out, ref, rtol=REL,
                               atol=REL * np.abs(ref).max())
