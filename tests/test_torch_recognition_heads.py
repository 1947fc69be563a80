"""Every head of ``recognition_heads.py`` in mscl_torch against mscl_tpu,
on the CPU, each head alone: TSNHead over segments, TSMHead (its own
segment count, and halved by is_shift with temporal_pool), TPNHead on a
clip, AudioTSNHead, TimeSformerHead on tokens, X3DHead, SlowFastHead on the
two pathways, and TRNHead ('TRN'; 'TRNMultiScale' in train with JAX's
subset draws replayed into the port's ``relation_picks``, and flattened
over 5 segments in eval): the scores, the loss terms and the gradients of
their sum in the input and the parameters, from the same (perturbed)
weights carried across by ``mscl_torch.convert``. Dropout is 0 (the port's
masks are not JAX's). Layouts: JAX channels-last, the port NCHW / NCTHW
(the TimeSformer tokens channels-last in both). Tolerances: scores and
losses 2e-4, gradients rtol 5e-3 / atol 1e-4 (ROADMAP)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mscl_tpu.models import HEADS as JAX_HEADS
from mscl_torch.convert import jax_to_state_dict, load_jax_variables
from mscl_torch.models import HEADS

from _torch_data_util import one_torch_thread  # noqa: F401
from _torch_port_util import perturb, t
from _torch_recognition_util import _recorded_choice

pytestmark = pytest.mark.usefixtures('one_torch_thread')
N, SEGS, C, CLASSES = 2, 8, 16, 6
TOL = dict(rtol=2e-4, atol=2e-4)
GRAD_TOL = dict(rtol=5e-3, atol=1e-4)
LABELS = np.array([1, 4])


def _jax_layout(x):
    """Port layout -> JAX's: channels last for maps and clips."""
    if x.ndim == 4:
        return np.transpose(x, (0, 2, 3, 1))
    if x.ndim == 5:
        return np.transpose(x, (0, 2, 3, 4, 1))
    return x


CASES = {
    # name -> (head type, config, input shapes (port layout), num_segs, train)
    'TSNHead': ('TSNHead', dict(), [(N * SEGS, C, 3, 3)], SEGS, True),
    'TSMHead/own_segments': ('TSMHead', dict(num_segments=SEGS),
                             [(N * SEGS, C, 3, 3)], None, True),
    'TSMHead/temporal_pool': ('TSMHead', dict(num_segments=SEGS,
                                              temporal_pool=True),
                              [(N * SEGS // 2, C, 3, 3)], SEGS, True),
    'TPNHead': ('TPNHead', dict(), [(N, C, 2, 3, 3)], 1, True),
    'AudioTSNHead': ('AudioTSNHead', dict(), [(N, C, 4, 5)], 1, False),
    'TimeSformerHead': ('TimeSformerHead', dict(), [(N, 5, C)], 1, True),
    'X3DHead': ('X3DHead', dict(mid_channels=12), [(N, C, 2, 3, 3)], 1,
                True),
    'X3DHead/fc1_bias': ('X3DHead', dict(mid_channels=12, fc1_bias=True),
                         [(N, C, 2, 3, 3)], 1, False),
    'SlowFastHead': ('SlowFastHead', dict(in_channels=C + 4),
                     [(N, C, 2, 3, 3), (N, 4, 8, 3, 3)], 1, True),
    'TRNHead/TRN': ('TRNHead', dict(relation_type='TRN', hidden_dim=8,
                                    num_segments=SEGS),
                    [(N * SEGS, C, 3, 3)], SEGS, True),
    'TRNHead/multiscale_train': ('TRNHead', dict(hidden_dim=8,
                                                 num_segments=SEGS),
                                 [(N * SEGS, C, 3, 3)], SEGS, True),
    'TRNHead/multiscale_eval_flattened_5_segments': ('TRNHead', dict(
        hidden_dim=8, num_segments=5, spatial_type='none',
        in_channels=C * 4), [(N * 5, C, 2, 2)], 5, False),
}


@pytest.mark.parametrize('case', sorted(CASES))
def test_head_matches(case):
    typ, extra, shapes, num_segs, train = CASES[case]
    cfg = dict(dict(num_classes=CLASSES, in_channels=C, dropout_ratio=0.0),
               **extra)
    rng = np.random.default_rng(len(case))
    xs = [rng.normal(size=s).astype(np.float32) for s in shapes]
    jx = [jnp.asarray(_jax_layout(x)) for x in xs]
    jx = tuple(jx) if len(jx) > 1 else jx[0]
    jhead = JAX_HEADS.get(typ)(**cfg)
    variables = jhead.init({'params': jax.random.PRNGKey(0),
                            'dropout': jax.random.PRNGKey(1)}, jx,
                           num_segs=num_segs)
    variables = {'params': perturb(variables['params'], 2, scale=0.5)}
    picks = []

    def jfn(params, x):
        score = jhead.apply({'params': params}, x, train=train,
                            num_segs=num_segs,
                            rngs={'dropout': jax.random.PRNGKey(3)})
        losses = jhead.apply({'params': params}, score,
                             jnp.asarray(LABELS), method='loss')
        return losses['loss_cls'], (score, losses)
    with _recorded_choice(picks):
        (_, (jscore, jlosses)), (jgp, jgx) = jax.jit(jax.value_and_grad(
            jfn, argnums=(0, 1), has_aux=True))(variables['params'], jx)
    if case == 'TRNHead/multiscale_train':
        assert len(picks) == SEGS - 2       # scales 7 .. 2 draw

    head = HEADS.build(dict(cfg, type=typ))
    load_jax_variables(head, variables)
    replay = iter(picks)
    if picks:
        head.relation_picks = lambda n_rel, n_sub, device: \
            torch.from_numpy(next(replay).astype(np.int64))
    head.train(train)
    txs = [t(x).requires_grad_(True) for x in xs]
    score = head(tuple(txs) if len(txs) > 1 else txs[0], num_segs=num_segs)
    losses = head.loss(score, t(LABELS))
    losses['loss_cls'].backward()
    assert next(replay, None) is None
    np.testing.assert_allclose(score.detach().numpy(), np.asarray(jscore),
                               **TOL)
    assert sorted(losses) == sorted(jlosses)
    for k in jlosses:
        np.testing.assert_allclose(losses[k].detach().numpy(),
                                   np.asarray(jlosses[k]), err_msg=k, **TOL)
    jgx = jgx if isinstance(jgx, tuple) else (jgx,)
    for tx, g in zip(txs, jgx):
        np.testing.assert_allclose(_jax_layout(tx.grad.numpy()),
                                   np.asarray(g), **GRAD_TOL)
    want = jax_to_state_dict({'params': jgp})
    got = {k: p.grad.numpy() for k, p in head.named_parameters()}
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **GRAD_TOL)


def test_trn_draws_distinct_subsets_from_its_generator():
    """In training each scale with more than three subsets takes three
    distinct ones, from the head's generator (seeded: the same draws
    again); in eval the first three."""
    head = HEADS.build(dict(type='TRNHead', num_classes=CLASSES,
                            in_channels=C, hidden_dim=8, num_segments=SEGS,
                            dropout_ratio=0.0))
    head.train()
    draws = []
    for _ in range(2):
        head.seed_dropout(5)
        draws.append([head.relation_picks(28, 3, torch.device('cpu'))
                      for _ in range(4)])
    for a, b in zip(*draws):
        assert torch.equal(a, b) and len(set(a.tolist())) == 3
    assert len({tuple(d.tolist()) for d in draws[0]}) > 1
    head.eval()
    assert head.relation_picks(28, 3, 'cpu').tolist() == [0, 1, 2]
