"""The TPN neck of mscl_torch against mscl_tpu's on the CPU
(tests/_torch_zoo_util.py: eval and train outputs with the auxiliary
loss, gradients, BN statistics; the train pass's aux dropout mask
recorded from JAX and replayed into the port), the neck path of both
recognizers, and the two TPN recipes through ``train_model``
(tests/_torch_recognition_util.py: over SlowOnly in Recognizer3D, clips
formatted NCTHW, and over TSM in Recognizer2D).

Sizes: two levels of 64 and 128 channels (8x8 and 4x4, T = 8), out 64.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mscl_tpu.models import NECKS as JAX_NECKS
from mscl_tpu.models import RECOGNIZERS as JAX_RECOGNIZERS
from mscl_torch.models import RECOGNIZERS
from mscl_torch.models.necks import TPN

from _torch_data_util import one_torch_thread  # noqa: F401
from _torch_port_util import perturb, xla3d_conv  # noqa: F401
from _torch_recognition_util import (check, cut_tables, port_to_jax,  # noqa
                                     recorded_bernoulli, sets)
from _torch_zoo_util import from_jax_init, hold

pytestmark = pytest.mark.usefixtures('xla3d_conv', 'one_torch_thread')

SHIPPED = dict(spatial_modulation_cfg=dict(in_channels=(64, 128),
                                           out_channels=128),
               temporal_modulation_cfg=dict(downsample_scales=(8, 8)),
               upsample_cfg=dict(scale_factor=(1, 1, 1)),
               downsample_cfg=dict(downsample_scale=(1, 1, 1)),
               level_fusion_cfg=dict(in_channels=(64, 64),
                                     mid_channels=(64, 64),
                                     out_channels=128),
               aux_head_cfg=dict(out_channels=10, loss_weight=0.5))
CASES = {
    # name -> (config, levels' (C, T, H, W))
    'shipped': (dict(SHIPPED), ((64, 8, 8, 8), (128, 8, 4, 4))),
    # per-level temporal rates onto one pyramid length (the level fusions
    # concatenate the levels, so their lengths must agree), and the aux
    # head's own class count and loss weight
    'rates': (dict(SHIPPED, temporal_modulation_cfg=dict(
        downsample_scales=(4, 2)), aux_head_cfg=dict(
            num_classes=6, loss_weight=0.7)),
        ((64, 8, 8, 8), (128, 4, 4, 4))),
    # no top-down flow, no aux head, three levels (two spatial convs)
    'three_levels_no_cascade': (dict(
        in_channels=(32, 64, 128), out_channels=64, flow_type='parallel',
        temporal_modulation_cfg=dict(downsample_scales=(4, 4, 4))),
        ((32, 4, 16, 16), (64, 4, 8, 8), (128, 4, 4, 4))),
}


@pytest.mark.parametrize('name', sorted(CASES))
def test_tpn_matches_jax(name):
    cfg, shapes = CASES[name]
    cfg = dict(dict(in_channels=(64, 128), out_channels=64), **cfg)
    rng = np.random.default_rng(1)
    x = [rng.normal(size=(2,) + s).astype(np.float32) for s in shapes]
    labels = np.array([3, 5])
    masks = []

    class Replayed(TPN):
        """The port's TPN taking JAX's recorded aux masks in training."""

        def dropout(self, feat):
            if not self.training:
                return feat
            keep = torch.from_numpy(masks.pop(0))
            return torch.where(keep, feat / 0.5, torch.zeros_like(feat))

    tmodel = Replayed(**cfg)
    with recorded_bernoulli(masks):
        hold(lambda dt: JAX_NECKS.get('TPN')(dtype=dt, **cfg), tmodel, x,
             x64=True, jkw=dict(labels=jnp.asarray(labels)),
             tkw=dict(labels=torch.from_numpy(labels)),
             rngs={'dropout': jax.random.PRNGKey(7)})
    assert not masks


def test_a_jax_init_carries_across():
    """The JAX neck's own init (its aux head's too), read by
    ``mscl_torch/convert.py``: the fused feature and the eval-mode aux
    loss as JAX's."""
    cfg, shapes = CASES['shipped']
    cfg = dict(dict(in_channels=(64, 128), out_channels=64), **cfg)
    rng = np.random.default_rng(4)
    x = [rng.normal(size=(2,) + s).astype(np.float32) for s in shapes]
    labels = np.array([1, 7])
    from_jax_init(JAX_NECKS.get('TPN')(**cfg), TPN(**cfg), x,
                  jkw=dict(labels=jnp.asarray(labels)),
                  tkw=dict(labels=torch.from_numpy(labels)))


R = 'recognition/'


@pytest.mark.parametrize('name,validate', [
    (R + 'tpn/tpn_slowonly_r50_8x8x1_150e_kinetics400_rgb.py', True),
    (R + 'tpn/tpn_tsm_r50_1x1x8_150e_sthv1_rgb.py', False)])
def test_train_model_matches_jax(sets, tmp_path, name, validate):
    """Two steps of each TPN recipe (``loss_aux`` among the logged losses,
    JAX's aux dropout masks replayed); the SlowOnly one validates through
    Recognizer3D's neck path (tpn_tsm's val pipeline is its base's NTHWC
    clip, which Recognizer2D does not read as frames). At 32x32 crops the
    pyramid is 1x1 and one frame long after the temporal modulation, so
    the level fusions' BN normalise 2 values a channel: the port runs in
    float64 too (``check``'s ``port64``)."""
    check(name, *sets['rgb'], str(tmp_path), validate, x64=True,
          ncthw=True, port64=True)


@pytest.mark.parametrize('name', [
    'tpn_slowonly_r50_8x8x1_150e_kinetics400_rgb.py',
    'tpn_tsm_r50_1x1x8_150e_sthv1_rgb.py'])
def test_forward_test_through_the_neck(name):
    """forward_test of each narrowed TPN recipe's model (three clips of 8
    frames a video; for Recognizer2D the segments folded into the neck's
    T) against JAX's, from the port's weights with their BN statistics
    perturbed: the averaged softmaxes within 1e-5."""
    from mscl_torch.config import Config
    from _torch_recognition_util import ROOT, narrow_model
    cfg = narrow_model(Config.fromfile(
        f'{ROOT}/configs/recognition/tpn/{name}').to_dict()['model'])
    typ = cfg.pop('type')
    shape = (2, 3, 3, 8, 32, 32) if typ == 'Recognizer3D' else \
        (2, 8, 3, 32, 32)
    x = np.random.default_rng(2).normal(size=shape).astype(np.float32)
    with cut_tables():
        jmodel = JAX_RECOGNIZERS.get(typ)(**cfg)
        tmodel = RECOGNIZERS.get(typ)(**cfg)
        shapes = jax.eval_shape(lambda k, xx: jmodel.init(
            {'params': k, 'dropout': k}, xx, train=False, return_loss=False),
            jax.random.PRNGKey(0), jnp.asarray(x))
        tmodel.init_weights(torch.Generator().manual_seed(0))
        variables = port_to_jax(shapes, {k: v.numpy() for k, v in
                                         tmodel.state_dict().items()},
                                jnp.float32)
        variables['batch_stats'] = perturb(variables['batch_stats'], 3)
        tmodel.load_state_dict(_merged(tmodel, variables))
        want = jax.jit(lambda v, xx: jmodel.apply(
            v, xx, train=False, return_loss=False))(variables,
                                                    jnp.asarray(x))
        tmodel.eval()
        with torch.no_grad():
            got = tmodel(torch.from_numpy(x), return_loss=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def _merged(tmodel, variables):
    """The port's state dict with JAX's (its subset: no aux head, which
    the test path does not build in JAX) put in."""
    from mscl_torch.convert import jax_to_state_dict
    sd = dict(tmodel.state_dict())
    sd.update({k: torch.from_numpy(v)
               for k, v in jax_to_state_dict(variables).items()})
    return sd
