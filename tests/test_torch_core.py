"""mscl_torch's LR schedule and SGD against mscl_tpu's (optax), on the CPU:
the cosine policy with each warmup form, and several SGD updates with
momentum, weight decay, frozen parameters and the global-norm clip both
acting and idle."""
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from mscl_tpu.core import build_lr_schedule as jax_lr
from mscl_tpu.core import build_optimizer as jax_optimizer
from mscl_torch.core import build_lr_schedule, build_optimizer


@pytest.mark.parametrize('lr_config', [
    dict(policy='CosineAnnealing', min_lr=0, warmup_iters=5,
         warmup_by_epoch=True),
    dict(policy='CosineAnnealing', min_lr=1e-4, warmup='linear',
         warmup_iters=2, warmup_by_epoch=True, warmup_ratio=0.1),
    dict(policy='CosineAnnealing', min_lr_ratio=0.01, by_epoch=False,
         warmup='exp', warmup_iters=7),
    dict(policy='fixed', warmup='constant', warmup_iters=3),
])
def test_lr_schedule_matches(lr_config):
    want = jax_lr(dict(lr_config), 0.02, 4, 5)
    got = build_lr_schedule(dict(lr_config), 0.02, 4, 5)
    for step in range(0, 25):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6,
                                   atol=1e-9, err_msg=f'step {step}')


class _Tiny(nn.Module):
    def __init__(self):
        super().__init__()
        self.encoder_q = nn.Linear(3, 4)
        self.encoder_k = nn.Linear(3, 4)


@pytest.mark.parametrize('max_norm', [0.5, 1e3])
def test_sgd_matches_optax(max_norm):
    rng = np.random.default_rng(0)
    model = _Tiny()
    params = {n: rng.normal(size=tuple(p.shape)).astype(np.float32)
              for n, p in model.named_parameters()}
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(torch.from_numpy(params[n]))
    cfg = dict(type='SGD', lr=0.1, momentum=0.9, weight_decay=1e-2)
    lr = dict(policy='CosineAnnealing', min_lr=0)
    tx = jax_optimizer(cfg, jax_lr(lr, 0.1, 4, 2),
                       grad_clip=dict(max_norm=max_norm),
                       freeze_patterns=('encoder_k',))
    opt = build_optimizer(model, cfg, build_lr_schedule(lr, 0.1, 4, 2),
                          grad_clip=dict(max_norm=max_norm),
                          freeze_patterns=('encoder_k',))
    jparams = {n: jnp.asarray(v) for n, v in params.items()}
    state = tx.init(jparams)
    for step in range(4):
        # the key tower takes no gradient (stop_gradient in the model)
        grads = {n: rng.normal(size=v.shape).astype(np.float32) *
                 ('encoder_q' in n) for n, v in params.items()}
        updates, state = tx.update({n: jnp.asarray(g) for n, g in
                                    grads.items()}, state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for n, p in model.named_parameters():
            p.grad = torch.from_numpy(grads[n])
        opt.step()
        for n, p in model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(jparams[n]), rtol=1e-5,
                                       atol=1e-6, err_msg=f'{n} step {step}')
    assert not any(p is q for p in opt.params
                   for q in model.encoder_k.parameters())
