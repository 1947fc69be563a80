"""mscl_torch's RAFT against mscl_tpu's, on the CPU: each module, the
helper functions, and the whole model (64x64, 4 levels, radius 4, 2
iterations; the port's lookup op against the JAX volume path), from
perturbed JAX weights carried over with ``raft_jax_to_state_dict``, and from
an official-named .pth read by both packages' loaders."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mscl_tpu.flow import raft as jraft
from mscl_torch.convert import raft_jax_to_state_dict
from mscl_torch.flow import raft as traft

from _torch_port_util import perturb, t

HW, ITERS = 64, 2
# flows and module outputs: float32 sums in another order (the CPU's conv
# and einsum kernels of two frameworks)
TOL = dict(rtol=1e-4, atol=1e-4)


def nchw(x):
    return np.transpose(np.asarray(x), (0, 3, 1, 2))


def _sd(variables):
    return {k: torch.from_numpy(v)
            for k, v in raft_jax_to_state_dict(variables).items()}


@pytest.fixture(scope='module')
def pair():
    """JAX RAFT variables (perturbed), the port loaded from them, two
    image batches (NHWC numpy) and the JAX flows."""
    jmodel = jraft.RAFT(iters=ITERS, corr_impl='volume')
    zero = jnp.zeros((1, HW, HW, 3))
    v = jax.jit(jmodel.init)(jax.random.PRNGKey(0), zero, zero)
    v = {'params': perturb(v['params'], 1, 0.05),
         'batch_stats': perturb(v['batch_stats'], 2)}
    rng = np.random.default_rng(0)
    img1 = rng.uniform(0, 255, (2, HW, HW, 3)).astype(np.float32)
    img2 = np.roll(img1, (3, -2), axis=(1, 2)) + rng.normal(
        scale=4.0, size=img1.shape).astype(np.float32)
    apply = jax.jit(jmodel.apply)
    flow_low, flow_up = apply(v, img1, img2)
    tmodel = traft.RAFT(iters=ITERS)
    tmodel.load_state_dict(_sd(v), strict=True)
    return dict(v=v, apply=apply, tmodel=tmodel, img1=img1, img2=img2,
                flows=(np.asarray(flow_low), np.asarray(flow_up)))


def test_converted_names_are_the_official_ones(pair):
    sd = raft_jax_to_state_dict(pair['v'])
    assert set(sd) == set(pair['tmodel'].state_dict())
    for key in ('fnet.conv1.weight', 'fnet.layer1.0.conv1.weight',
                'cnet.layer2.0.downsample.0.weight',
                'cnet.layer2.0.downsample.1.running_var',
                'cnet.layer2.0.norm3.weight',
                'update_block.encoder.convc1.weight',
                'update_block.encoder.conv.weight',
                'update_block.gru.convz1.weight',
                'update_block.flow_head.conv1.weight',
                'update_block.mask.0.weight', 'update_block.mask.2.bias'):
        assert key in sd, key
    np.testing.assert_array_equal(sd['cnet.layer3.0.norm3.bias'],
                                  sd['cnet.layer3.0.downsample.1.bias'])


@pytest.mark.parametrize('name', ['fnet', 'cnet'])
def test_encoders_match(pair, name):
    norm, dim = ('instance', 256) if name == 'fnet' else ('batch', 256)
    v = {c: pair['v'][c][name] for c in pair['v'] if name in pair['v'][c]}
    x = np.random.default_rng(5).normal(size=(2, 40, 48, 3)).astype(
        np.float32)
    want = jraft.BasicEncoder(dim, norm).apply(v, x)
    with torch.no_grad():
        got = getattr(pair['tmodel'], name)(t(nchw(x)))
    np.testing.assert_allclose(got.numpy(), nchw(want), **TOL)


@pytest.mark.parametrize('part', ['encoder', 'gru', 'flow_head',
                                  'update_block'])
def test_update_block_parts_match(pair, part):
    rng = np.random.default_rng(6)
    n, h, w = 2, 6, 10

    def x(c):
        return rng.normal(size=(n, h, w, c)).astype(np.float32)
    net, inp, corr, flow = x(128), x(128), x(4 * 81), x(2)
    ub = pair['v']['params']['update_block']
    block = pair['tmodel'].update_block
    if part == 'update_block':
        args = (net, inp, corr, flow)
        want = jraft.BasicUpdateBlock(128, 4, 4).apply({'params': ub}, *args)
    elif part == 'encoder':
        args = (flow, corr)
        want = jraft.BasicMotionEncoder(4, 4).apply(
            {'params': ub['encoder']}, *args)
    elif part == 'gru':
        args = (net, x(256))
        want = jraft.SepConvGRU(128).apply({'params': ub['gru']}, *args)
    else:
        args = (net,)
        want = jraft.FlowHead(256).apply({'params': ub['flow_head']}, *args)
    mod = block if part == 'update_block' else getattr(block, part)
    with torch.no_grad():
        got = mod(*(t(nchw(a)) for a in args))
    for g, wnt in zip(got if isinstance(got, tuple) else (got,),
                      want if isinstance(want, tuple) else (want,)):
        np.testing.assert_allclose(g.numpy(), nchw(wnt), **TOL)


@pytest.mark.parametrize('norm', ['instance', 'batch', 'group', 'none'])
def test_residual_block_norms(norm):
    """The norm choice of _Norm, through a strided block with a
    downsample (norm3 under both of its names)."""
    x = np.random.default_rng(7).normal(size=(2, 12, 12, 16)).astype(
        np.float32)
    jblock = jraft.ResidualBlock(24, norm, 2)
    v = jblock.init(jax.random.PRNGKey(1), x)
    v = {c: perturb(v[c], 3) for c in v}
    tblock = traft.ResidualBlock(16, 24, norm, 2).eval()
    tblock.load_state_dict(_sd(v), strict=True)
    with torch.no_grad():
        got = tblock(t(nchw(x)))
    np.testing.assert_allclose(got.numpy(), nchw(jblock.apply(v, x)), **TOL)


@pytest.mark.parametrize('piece', ['instance_norm', 'coords_grid',
                                   'upsample_flow_convex'])
def test_functions_match(piece):
    rng = np.random.default_rng(8)
    if piece == 'instance_norm':
        x = rng.normal(2.0, 3.0, size=(2, 5, 7, 6)).astype(np.float32)
        want, got = jraft.instance_norm(x), traft.instance_norm(t(nchw(x)))
    elif piece == 'coords_grid':
        want, got = jraft.coords_grid(2, 3, 5), traft.coords_grid(2, 3, 5)
    else:
        flow = rng.normal(size=(2, 4, 5, 2)).astype(np.float32)
        mask = rng.normal(size=(2, 4, 5, 576)).astype(np.float32)
        want = jraft.upsample_flow_convex(flow, mask)
        got = traft.upsample_flow_convex(t(nchw(flow)), t(nchw(mask)))
    np.testing.assert_allclose(got.numpy(), nchw(want), rtol=1e-5,
                               atol=1e-5)


def test_raft_matches_jax(pair):
    with torch.no_grad():
        got = pair['tmodel'](t(nchw(pair['img1'])), t(nchw(pair['img2'])))
    for g, want, shape in zip(got, pair['flows'], [(2, 2, 8, 8),
                                                    (2, 2, HW, HW)]):
        assert tuple(g.shape) == shape
        np.testing.assert_allclose(g.numpy(), nchw(want), **TOL)
    assert np.abs(pair['flows'][1]).max() > 0.1     # the check sees a flow


def test_official_pth_loads_in_both(pair, tmp_path):
    """The port's state_dict, saved under DataParallel's ``module.``
    prefix, is read by the JAX package's converter and by load_raft_pth,
    and the two models give the same flows."""
    path = tmp_path / 'raft-official-names.pth'
    torch.save({f'module.{k}': v for k, v in
                pair['tmodel'].state_dict().items()}, path)
    jflows = pair['apply'](jraft.load_torch_raft_weights(str(path)),
                           pair['img1'], pair['img2'])
    tmodel = traft.load_raft_pth(traft.RAFT(iters=ITERS), str(path))
    with torch.no_grad():
        tflows = tmodel(t(nchw(pair['img1'])), t(nchw(pair['img2'])))
    for g, want, ref in zip(tflows, jflows, pair['flows']):
        np.testing.assert_allclose(g.numpy(), nchw(want), **TOL)
        np.testing.assert_allclose(np.asarray(want), ref, rtol=1e-6,
                                   atol=1e-6)


def test_build_raft_seeded():
    a = traft.build_raft(device='cpu', seed=3, iters=1)
    b = traft.build_raft(device='cpu', seed=3, iters=1)
    assert not a.training
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    assert not torch.backends.cudnn.allow_tf32
