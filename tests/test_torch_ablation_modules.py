"""The MSCL ablation family's heads and necks in mscl_torch against
mscl_tpu, on the CPU: every head of ``local_align_heads.py`` (outputs,
every loss term, the gradients of their sum in the inputs and the
parameters), TPNMoCo with TemporalModulation (T not a multiple of the
scale, so the ceil-mode window is partial), with ``reverse_st`` and with
SEPC's integrated BN, and the necks MixBaseMoCo, TPNProjMoCo,
BaseMoCo_TwoR5 and TPNProjMoCoV2, in train and eval mode (outputs, input
gradients, BN running statistics). The JAX weights, perturbed, go through
``mscl_torch.convert``. Tolerances: outputs and losses 1e-5 (rtol) /
1e-4, gradients rtol 5e-3 / atol 1e-4 (ROADMAP), BN statistics 1e-4."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mscl_tpu.models import HEADS as JAX_HEADS
from mscl_tpu.models import NECKS as JAX_NECKS
from mscl_torch.convert import jax_to_state_dict, load_jax_variables
from mscl_torch.models import BACKBONES, HEADS, NECKS

from _torch_data_util import one_torch_thread  # noqa: F401
from _torch_port_util import ncthw, nthwc, perturb, t, xla3d_conv  # noqa: F401

B = 2
pytestmark = pytest.mark.usefixtures('one_torch_thread')
CE = dict(type='CrossEntropyLoss_torch', ignore_index=-1)
OUT_TOL = dict(rtol=1e-5, atol=1e-4)
GRAD_TOL = dict(rtol=5e-3, atol=1e-4)


def _rng_feats(rng, *shapes):
    """NCTHW float32 features."""
    return [rng.normal(size=(B,) + s).astype(np.float32) for s in shapes]


def _head_inputs(name, rng):
    """The head's keyword inputs in the port's layout (NCTHW features);
    the channels of the levels a case compares agree after its
    projections, as the JAX heads need."""
    if name in ('FGMoDistPredHead', 'MAMSCLWithAugPosHead'):
        # the flow projected to 128 meets the RGB's 128 channels
        kw = dict(q_mlvl=_rng_feats(rng, (128, 4, 8, 8)),
                  q_flow_mlvl=_rng_feats(rng, (16, 4, 2, 2)))
        if name == 'MAMSCLWithAugPosHead':
            kw['motion_maps'] = rng.uniform(size=(B, 4, 8, 8)).astype(
                np.float32)
        return kw
    if name == 'MSCLWithAugAPPosHead':
        def with_emb(feats, d):
            return feats + [rng.normal(size=(B, d)).astype(np.float32)]
        # the flow projected to 128 meets the RGB's 128 channels
        return dict(q_mlvl=with_emb(_rng_feats(rng, (128, 4, 3, 3)), 12),
                    q_flow_mlvl=with_emb(_rng_feats(rng, (16, 4, 3, 3)), 6),
                    q_aug_flow_mlvl=with_emb(_rng_feats(rng, (16, 4, 3, 3)),
                                             6),
                    ap_labels=rng.integers(0, 8, size=(B,)))
    return dict(q_mlvl=_rng_feats(rng, (8, 4, 3, 3), (12, 2, 3, 3),
                                  (12, 1, 2, 2)),
                q_flow_mlvl=_rng_feats(rng, (8, 4, 3, 3), (12, 4, 3, 3)),
                q_aug_flow_mlvl=_rng_feats(rng, (8, 4, 3, 3), (12, 4, 3, 3)))


PROJ = dict(bkb_channels=(8, 12))
HEAD_CASES = {
    'MoDistPredHead': dict(PROJ),
    'MoDistPredHead/concat': dict(PROJ, flow_source='concat'),
    'MoDistMSEPredHead': dict(PROJ, pred_weights=(0.7, 2.0)),
    'FGMoDistPredHead': dict(bkb_channels=(None, 16), mlvl_ids=(0, 0)),
    'MoDistPredDTHead': dict(bkb_channels=(None, 12), mlvl_ids=(1, 1)),
    'MTMoDistPredHead': dict(bkb_channels=(8, 8)),
    'MoDistv2PosHead': dict(PROJ),
    'MoDistv2PosHead/identity': dict(bkb_channels=(None, None),
                                     mlvl_ids=(1, 1)),
    'MSCLWithAugPosHead': dict(PROJ),
    'MSCLWithAugSimpleHead': dict(),
    'MSCLWithAugAPPosHead': dict(bkb_channels=(None, 16),
                                 loss_cls=dict(type='CrossEntropyLoss')),
    'MlvlMSCLWithAugPosHead': dict(bkb_channels=(None, None),
                                   mlvl_ids=(0, 1, 2),
                                   mlvl_flow_ids=(0, 1, 1)),
    'MlvlMSCLWithAugPosHead/max': dict(bkb_channels=(8, 12), mlvl_ids=(0,),
                                       mlvl_flow_ids=(-1,), pool_type='max'),
    'MAMSCLWithAugPosHead': dict(bkb_channels=(None, 16), mlvl_ids=(0, 0),
                                 chosen_rate=0.3),
}


def _jax_layout(kw):
    out = {}
    for k, v in kw.items():
        if isinstance(v, list):
            out[k] = [jnp.asarray(nthwc(x) if x.ndim == 5 else x) for x in v]
        else:
            out[k] = jnp.asarray(v)
    return out


def _sum_losses(losses):
    return sum(v for k, v in losses.items() if k.startswith('loss'))


@pytest.mark.parametrize('case', sorted(HEAD_CASES))
def test_align_head_matches(case):
    name = case.split('/')[0]
    cfg = dict(HEAD_CASES[case], basename='', loss_pos=CE, T=0.07)
    kw = _head_inputs(name, np.random.default_rng(len(case)))
    jhead = JAX_HEADS.get(name)(**cfg)
    jkw = _jax_layout(kw)
    variables = jhead.init(jax.random.PRNGKey(0), **jkw)
    params = perturb(variables.get('params', {}), 1)

    def jloss(params, inputs):
        v = {'params': params} if params else {}
        out = jhead.apply(v, **inputs)
        losses = jhead.apply(v, **{**inputs, **out}, method='loss')
        return _sum_losses(losses) if losses else jnp.zeros(()), \
            (out, losses)

    diff = {k: v for k, v in jkw.items() if k.endswith('mlvl')}
    rest = {k: v for k, v in jkw.items() if k not in diff}
    (jtotal, (jout, jlosses)), (jgp, jgx) = jax.value_and_grad(
        lambda p, x: jloss(p, {**x, **rest}), argnums=(0, 1),
        has_aux=True)(params, diff)

    thead = HEADS.get(name)(**cfg)
    thead.init_weights(torch.Generator().manual_seed(0))
    if params:
        load_jax_variables(thead, {'params': params})
    tkw = {k: [t(x).requires_grad_(True) for x in v] if isinstance(v, list)
           else t(v) for k, v in kw.items()}
    tout = thead(**tkw)
    tlosses = thead.loss(**{**tkw, **tout})
    assert sorted(tout) == sorted(jout) and sorted(tlosses) == sorted(jlosses)
    for k, v in tout.items():
        for got, want in zip(v if isinstance(v, list) else [v],
                             jout[k] if isinstance(v, list) else [jout[k]]):
            if got.dtype.is_floating_point:
                np.testing.assert_allclose(got.detach().numpy(),
                                           np.asarray(want), err_msg=k,
                                           **OUT_TOL)
            else:
                np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                              err_msg=k)
    for k in jlosses:
        np.testing.assert_allclose(tlosses[k].item(), float(jlosses[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    if not tlosses:
        return
    _sum_losses(tlosses).backward()
    for k, xs in diff.items():
        for i, (x, g) in enumerate(zip(tkw[k], jgx[k])):
            got = torch.zeros_like(x) if x.grad is None else x.grad
            want = np.asarray(g)
            np.testing.assert_allclose(
                got.numpy(), ncthw(want) if want.ndim == 5 else want,
                err_msg=f'{k}[{i}] grad', **GRAD_TOL)
    want_gp = jax_to_state_dict({'params': jgp})
    got_gp = {n: p.grad for n, p in thead.named_parameters()}
    assert sorted(got_gp) == sorted(want_gp)
    for n, g in want_gp.items():
        np.testing.assert_allclose(got_gp[n].numpy(), g, err_msg=n,
                                   **GRAD_TOL)


def test_mlvl_head_refuses_what_flax_refuses():
    """Several levels with a projection: flax refuses the JAX head (one
    name for every level's Dense), and so does the port."""
    cfg = dict(bkb_channels=(8, 12), mlvl_ids=(0, 1), mlvl_flow_ids=(0, 1),
               loss_pos=CE)
    kw = _jax_layout(_head_inputs('MlvlMSCLWithAugPosHead',
                                  np.random.default_rng(0)))
    with pytest.raises(Exception, match='Name in use'):
        JAX_HEADS.get('MlvlMSCLWithAugPosHead')(**cfg).init(
            jax.random.PRNGKey(0), **kw)
    with pytest.raises(NotImplementedError, match='trans_rgb'):
        HEADS.get('MlvlMSCLWithAugPosHead')(**cfg)


def test_dense_takes_its_width_from_the_first_input():
    """The projections are lecun-normal of the width they first see (flax
    Dense), drawn from the seed init_weights took, on any device."""
    head = HEADS.get('MoDistPredHead')(bkb_channels=(8, 16), mlvl_ids=(0, 0))
    head.init_weights(torch.Generator().manual_seed(3))
    again = HEADS.get('MoDistPredHead')(bkb_channels=(8, 16),
                                        mlvl_ids=(0, 0))
    again.init_weights(torch.Generator().manual_seed(3))
    x = [torch.randn(B, 24, 4, 3, 3)]
    for h in (head, again):
        h(q_mlvl=x, q_flow_mlvl=x)
    assert head.trans_rgb.weight.shape == (128, 24)
    assert torch.equal(head.trans_rgb.weight, again.trans_rgb.weight)
    assert head.trans_rgb.weight.abs().max() <= 2 * 24 ** -0.5 / 0.8796 + 1e-6
    assert not head.trans_rgb.bias.any()


# ------------------------------------------------------------------ necks
TM_STAGES = [(16, 16, 16, 16), (32, 8, 8, 8), (64, 4, 4, 4), (64, 2, 2, 2)]
PROJ_STAGES = [(8, 16, 16, 16), (16, 8, 8, 8), (32, 4, 4, 4), (64, 2, 2, 2)]
TPN_TM = dict(type='TPNMoCo', in_channels=[32, 64, 64], out_channels=32,
              temporal_modulation_cfg=dict(downsample_scales=(3, 3, 3)),
              sepc_cfg=dict(in_channels=[32, 32, 32], out_channels=32,
                            stride=(2, 2, 2), iBN=True, Pconv_num=2))
NECK_CASES = {
    'TPNMoCo/tm_ibn': (TPN_TM, TM_STAGES),
    'TPNMoCo/tm_reverse_st': (dict(TPN_TM, reverse_st=True), TM_STAGES),
    'TPNMoCo/tm': (dict(TPN_TM, sepc_cfg=None), TM_STAGES),
    'MixBaseMoCo': (dict(type='MixBaseMoCo'), PROJ_STAGES),
    'TPNProjMoCo': (dict(type='TPNProjMoCo', dims_in=(16, 32, 64),
                         dims_out=(8, 8, 8), temporal_sizes=(4, 2, 1)),
                    PROJ_STAGES),
    'BaseMoCo_TwoR5': (dict(type='BaseMoCo_TwoR5'), PROJ_STAGES),
    'TPNProjMoCoV2': (dict(type='TPNProjMoCoV2', dims_in=(16, 32, 64),
                           dims_out=(8, 12, 8), ft_ids=(0, 1, 2),
                           temporal_sizes=(4, 2, 1), chunks=(1, 2, 2)),
                      PROJ_STAGES),
}


def _neck_inputs(case, stages):
    xs = _rng_feats(np.random.default_rng(9), *stages)
    if case == 'BaseMoCo_TwoR5':
        local = np.random.default_rng(10).normal(
            size=(B,) + stages[-1]).astype(np.float32)
        return xs[:-1] + [(xs[-1], local)]
    return xs


def _tree(fn, x):
    return tuple(fn(v) for v in x) if isinstance(x, tuple) else fn(x)


@pytest.mark.parametrize('train', [True, False], ids=['train', 'eval'])
@pytest.mark.parametrize('case', sorted(NECK_CASES))
def test_ablation_neck_matches(xla3d_conv, case, train):
    cfg, stages = NECK_CASES[case]
    cfg = dict(cfg)
    name = cfg.pop('type')
    xs = _neck_inputs(case, stages)
    jneck = JAX_NECKS.get(name)(**cfg)
    jx = [_tree(lambda a: jnp.asarray(nthwc(a)), x) for x in xs]
    variables = dict(jneck.init(jax.random.PRNGKey(0), jx, train=False))
    if 'params' in variables:
        variables['params'] = perturb(variables['params'], 2)
    if 'batch_stats' in variables:
        variables['batch_stats'] = perturb(variables['batch_stats'], 3)

    def jfwd(inputs):
        if train and 'batch_stats' in variables:
            return jneck.apply(variables, inputs, train=True,
                               mutable=['batch_stats'])
        return jneck.apply(variables, inputs, train=train), {}

    (jemb, jfeats), jstats = jfwd(jx)
    rng = np.random.default_rng(5)
    wts = [jnp.asarray(rng.normal(size=np.shape(a)).astype(np.float32))
           for a in [jemb] + list(jfeats)]

    def jloss(inputs):
        (emb, feats), _ = jfwd(inputs)
        return (emb * wts[0]).sum() + sum((f * w).sum() for f, w in
                                          zip(feats, wts[1:]))

    jgrads = jax.grad(jloss)(jx)

    tneck = NECKS.get(name)(**cfg)
    tneck.init_weights(torch.Generator().manual_seed(0))
    if variables:
        load_jax_variables(tneck, variables)
    tneck.train(train)
    tx = [_tree(lambda a: t(a).requires_grad_(True), x) for x in xs]
    temb, tfeats = tneck(tx)
    np.testing.assert_allclose(temb.detach().numpy(), np.asarray(jemb),
                               **OUT_TOL)
    assert len(tfeats) == len(jfeats)
    for i, (g, w) in enumerate(zip(tfeats, jfeats)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.detach().numpy(),
                                   ncthw(w) if w.ndim == 5 else w,
                                   err_msg=f'feature {i}', **OUT_TOL)
    tw = [t(np.asarray(wts[0]))] + [
        t(ncthw(w) if w.ndim == 5 else np.asarray(w)) for w in wts[1:]]
    ((temb * tw[0]).sum() + sum((f * w).sum() for f, w in
                                zip(tfeats, tw[1:]))).backward()
    for i, (x, g) in enumerate(zip(tx, jgrads)):
        for j, (xx, gg) in enumerate(zip(*(
                (x, g) if isinstance(x, tuple) else ((x,), (g,))))):
            got = torch.zeros_like(xx) if xx.grad is None else xx.grad
            np.testing.assert_allclose(got.numpy(), ncthw(gg),
                                       err_msg=f'input {i}.{j} grad',
                                       **GRAD_TOL)
    if jstats:
        want = jax_to_state_dict({'batch_stats': jstats['batch_stats']})
        got = tneck.state_dict()
        assert want
        for k, v in want.items():
            np.testing.assert_allclose(got[k].numpy(), v, rtol=1e-4,
                                       atol=1e-4, err_msg=k)


def test_temporal_modulation_pads_with_minus_infinity():
    """A window past the last frame takes the max of the frames it holds
    (the JAX module pads T with -inf), whatever their sign."""
    from mscl_torch.models.necks import TemporalModulation
    tm = TemporalModulation(32, downsample_scale=4)
    with torch.no_grad():
        tm.conv.weight.zero_()
        tm.conv.weight[:, :, 1] = 1.0          # identity per group member
    x = -torch.rand(1, 32, 6, 1, 1) - 1.0       # all negative
    y = tm(x)
    assert y.shape[2] == 2
    torch.testing.assert_close(y[:, :, 1], x[:, :, 4:].amax(dim=2))


def test_tool_flows_make_jax_float32_bn_ill_conditioned(xla3d_conv):
    """Why the ablation steps hold the port against JAX in float64
    (tests/test_torch_ablation_steps.py): on the tool's visualised
    synthetic flows (mostly white, so each stem channel is nearly
    constant) JAX's float32 BN statistics, E[x^2] - E[x]^2, lose most of
    their digits. The abl.tiny3d flow tower in train mode, every level
    against JAX in float64: the port's float32 at least 5 times closer
    than JAX's float32 (the normalisation by a small deviation amplifies
    any float32 rounding; the port's distance depends on the convolution's
    summation order, so on the CPU's thread count)."""
    import os

    from functools import partial

    from mscl_tpu.models.backbones.video_resnet import VideoResNet
    from mscl_tpu.models.common.ssl_aug import FlowVisualizer
    from mscl_torch.tools import ablation_ordering as tool
    data = tool.make_videos(4, 32, 4, seed=100)
    batch = tool.make_batch(np.random.default_rng(0), data,
                            np.arange(16)[::2], 'modist', 8, 4)
    x = np.asarray(FlowVisualizer()(jnp.asarray(
        nthwc(batch['flow_imgs'][0]))))
    tool.register_tiny3d()
    jcls = partial(VideoResNet, block='basic', conv_makers=('simple3d',) * 4,
                   layers=(1, 1, 1, 1), stem='flow_basic', base_width=16)
    variables = dict(jcls().init(jax.random.PRNGKey(0), x))
    variables = {'params': perturb(variables['params'], 1),
                 'batch_stats': perturb(variables['batch_stats'], 2)}
    j32, _ = jcls().apply(variables, x, train=True, mutable=['batch_stats'])
    prev = os.environ.get('MSCL_BN_IMPL')
    os.environ['MSCL_BN_IMPL'] = 'flax'
    try:
        with jax.enable_x64(True):
            v64 = jax.tree.map(lambda a: jnp.asarray(np.asarray(a, np.float64)),
                               variables)
            j64, _ = jcls(dtype=jnp.float64).apply(
                v64, x.astype(np.float64), train=True,
                mutable=['batch_stats'])
            j64 = [np.asarray(a) for a in j64]
    finally:
        if prev is None:
            del os.environ['MSCL_BN_IMPL']
        else:
            os.environ['MSCL_BN_IMPL'] = prev
    port = BACKBONES.get('abl.tiny3d')(in_channels=3)
    load_jax_variables(port, variables)
    p32 = port.train()(t(ncthw(x)))
    for level, (a32, a64, b32) in enumerate(zip(j32, j64, p32)):
        want = ncthw(a64)
        jax_err = np.abs(ncthw(a32) - want).max()
        port_err = np.abs(b32.detach().numpy() - want).max()
        print(f'level {level}: JAX float32 {jax_err:.3g}, port float32 '
              f'{port_err:.3g} from JAX float64')
        assert jax_err > 5 * port_err, (level, jax_err, port_err)
