"""A whole recognizer of mscl_tpu and its port from the same weights, on
the same numpy batch: the audio and detection tests' holder.

- ``carry``: the JAX init traced (``jax.eval_shape``, not run), the port's
  init carried across (``port_to_jax``), every parameter and BN statistic
  perturbed by seeded noise (``perturb``), and loaded back into the port;
- ``hold_eval``: ``method`` (``forward_test``) of both, jitted once with
  ``FAST_COMPILE``, within 1e-4;
- ``hold_train``: ``train_step`` of both in train mode: every logged
  value within 1e-4 (the losses and metrics), each parameter's gradient
  of the loss within rtol 5e-3 / atol 1e-4, the BN statistics the step
  leaves within 1e-4. The JAX pass is compiled with XLA's optimisations:
  without them (``FAST_COMPILE``) XLA:CPU's gradients of the detectors
  lie up to 9 % (float64) from the eager ones, which the port's match to
  1e-17. JAX's dropout masks (flax's ``bernoulli``) are
  recorded from its pass and replayed into the port's ``RateDropout``
  sites in order; ``x64`` runs both packages in float64 (JAX with x64 on,
  the port's model and batch in float64).
"""
import contextlib
import copy

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mscl_torch.convert import jax_to_state_dict, load_jax_variables
from mscl_torch.models.heads.base import RateDropout

from _torch_port_util import perturb
from _torch_recognition_util import (FAST_COMPILE, port_to_jax,
                                     recorded_bernoulli, replay_dropout)
from _torch_step_util import jax_float64

OUT_TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_TOL = dict(rtol=5e-3, atol=1e-4)


def _numpy_state(model):
    return {k: v.detach().numpy() for k, v in model.state_dict().items()}


def carry(jmodel, tmodel, batch, seed=2):
    """JAX variables for ``jmodel`` holding ``tmodel``'s perturbed init,
    which the port then loads; returns them."""
    shapes = jax.eval_shape(lambda k, b: jmodel.init(
        {'params': k, 'dropout': k}, b, method='train_step'),
        jax.random.PRNGKey(0), batch)
    tmodel.init_weights(torch.Generator().manual_seed(0))
    variables = port_to_jax(shapes, _numpy_state(tmodel), jnp.float32)
    variables = {'params': perturb(variables['params'], seed),
                 'batch_stats': perturb(variables.get('batch_stats', {}),
                                        seed + 1)}
    load_jax_variables(tmodel, variables)
    return variables


def _torch(x, dtype=torch.float32):
    t = torch.from_numpy(np.ascontiguousarray(x))
    return t.to(dtype) if t.is_floating_point() else t


def hold_eval(jmodel, tmodel, variables, args, kwargs=None,
              method='forward_test'):
    kwargs = dict(kwargs or {})
    want = np.asarray(jax.jit(
        lambda v, a, kw: jmodel.apply(v, *a, method=method, **kw),
        compiler_options=FAST_COMPILE)(variables, args, kwargs))
    tmodel.eval()
    with torch.no_grad():
        got = getattr(tmodel, method)(
            *[_torch(a) for a in args],
            **{k: _torch(v) for k, v in kwargs.items()}).numpy()
    np.testing.assert_allclose(got, want, **OUT_TOL)
    return got


def hold_train(jmodel, tmodel, variables, batch, x64=False):
    """Returns the port's logged values and the number of masks replayed;
    with ``x64``, ``jmodel`` is the float64 one (its ``dtype``)."""
    masks = []
    dt = np.float64 if x64 else np.float32
    with jax_float64() if x64 else contextlib.nullcontext():
        cast = jax.tree.map(lambda a: jnp.asarray(
            np.asarray(a).astype(dt) if np.asarray(a).dtype == np.float32
            else np.asarray(a)), variables)
        jbatch = {k: np.asarray(v).astype(dt) if np.asarray(v).dtype ==
                  np.float32 else v for k, v in batch.items()}

        def loss_fn(params, b):
            (loss, log_vars), new = jmodel.apply(
                {'params': params, 'batch_stats': cast['batch_stats']}, b,
                method='train_step', mutable=['batch_stats'],
                rngs={'dropout': jax.random.PRNGKey(5)})
            return loss, (log_vars, new)
        with recorded_bernoulli(masks):
            (_, (jlog, jnew)), jgrads = jax.jit(
                jax.value_and_grad(loss_fn, has_aux=True))(cast['params'],
                                                           jbatch)
            jax.effects_barrier()
    model = copy.deepcopy(tmodel)
    if x64:
        model = model.double()
    model.train()
    real = RateDropout.dropout
    replay_dropout(RateDropout, masks)
    try:
        loss, log_vars = model.train_step(
            {k: _torch(v, torch.float64 if x64 else torch.float32)
             for k, v in batch.items()})
        loss.backward()
    finally:
        RateDropout.dropout = real
    got = {k: float(v.detach()) for k, v in log_vars.items()}
    assert sorted(got) == sorted(jlog)
    for k in sorted(got):
        np.testing.assert_allclose(got[k], float(jlog[k]), err_msg=k,
                                   **OUT_TOL)
    want = jax_to_state_dict({'params': jgrads})
    grads = {k: p.grad.numpy() for k, p in model.named_parameters()
             if p.grad is not None}
    assert sorted(grads) == sorted(want), set(grads) ^ set(want)
    for k in sorted(want):
        np.testing.assert_allclose(grads[k], want[k], err_msg=k, **GRAD_TOL)
    want = jax_to_state_dict({'batch_stats': jnew.get('batch_stats', {})})
    stats = {k: v.numpy() for k, v in model.state_dict().items()
             if 'running' in k}
    assert sorted(stats) == sorted(want)
    for k in sorted(want):
        np.testing.assert_allclose(stats[k], want[k], err_msg=k, **OUT_TOL)
    return got, len(masks)
