"""Shared by the 3D zoo's tests (tests/test_torch_slowfast_csn.py,
test_torch_video_zoo.py, test_torch_tpn.py): a mscl_tpu module and its
port from the same converted weights, on the same inputs, in eval mode and
then in train mode with a backward.

``hold`` initialises the JAX module, adds seeded noise to every parameter
and BN statistic (``_torch_port_util.perturb``, so that identity-valued BN
and zero biases cannot hide a conversion mistake), loads them into the
port through ``mscl_torch/convert.py`` and compares:

- eval mode (BN on running statistics): every output within 1e-4;
- train mode: every output within 1e-4, each parameter's gradient of
  sum_i <out_i, w_i> / sqrt(size of out_i) (w_i normal from a fixed JAX
  key, drawn inside the jitted pass) within rtol 5e-3 / atol 1e-4, and the
  BN statistics the pass leaves within 1e-4.

The eval pass is jitted once for a module's repr (``jax_eval``), so a
module case and its init case share the compilation. The eval pass and
the init run once, a forward at a small size, so each is compiled without
LLVM's optimisation (``FAST_COMPILE``); the train pass, a forward and a
backward in float64, runs slower so.

With ``x64`` both packages run in float64 (JAX with x64 on, the model's
dtype float64 and flax's BatchNorm; the port's model and inputs in
float64): the depth-50 stacks' train-mode BN over a few positions a
channel is too ill-conditioned in float32 for these tolerances
(tests/test_torch_resnet3d.py measures it), and float64 against float64
shows any fault of padding, stride, grouping or layout as plainly.
"""
import contextlib
import copy

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mscl_torch.convert import jax_to_state_dict, load_jax_variables

from _torch_port_util import ncthw, nthwc, perturb
from _torch_recognition_util import FAST_COMPILE, port_to_jax
from _torch_step_util import jax_float64

OUT_TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_TOL = dict(rtol=5e-3, atol=1e-4)


def flat(out):
    """A nested output (tuples and lists of arrays, dicts of losses) as a
    list of numpy arrays, 5-D ones NCTHW."""
    if isinstance(out, dict):
        return [a for k in sorted(out) for a in flat(out[k])]
    if isinstance(out, (list, tuple)):
        return [a for o in out for a in flat(o)]
    if isinstance(out, torch.Tensor):
        return [out.detach().numpy()]
    a = np.asarray(out)
    return [ncthw(a) if a.ndim == 5 else a]


def to_jax(x, dtype=np.float32):
    """A port input (NCTHW numpy, or a list of them) in JAX's layout."""
    if isinstance(x, (list, tuple)):
        return [to_jax(v, dtype) for v in x]
    x = np.asarray(x)
    return jnp.asarray((nthwc(x) if x.ndim == 5 else x).astype(dtype))


def to_torch(x, dtype=torch.float32):
    if isinstance(x, (list, tuple)):
        return [to_torch(v, dtype) for v in x]
    return torch.from_numpy(np.array(x)).to(dtype)


def _close(got, want, tol, what):
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, (what, i, g.shape, w.shape)
        np.testing.assert_allclose(g, w, err_msg=f'{what} {i}', **tol)


# the jitted eval passes by the JAX module's repr and its inputs' shapes:
# a module case and its init case (the same config on inputs of one shape)
# share one compilation
_EVAL = {}


def jax_eval(jmodel, variables, x, jkw):
    """``jmodel.apply(variables, x, train=False, **jkw)``, jitted once for
    every module of the same repr."""
    key = repr(jmodel)
    if key not in _EVAL:
        _EVAL[key] = jax.jit(lambda v, xx, kw: jmodel.apply(
            v, xx, train=False, **kw), compiler_options=FAST_COMPILE)
    return _EVAL[key](variables, x, jkw)


def hold(jfactory, tmodel, x, x64=False, jkw=None, tkw=None, rngs=None):
    """``jfactory(dtype)`` builds the JAX module, ``tmodel`` is the port's;
    ``x`` the port's input (NCTHW numpy or a list). ``jkw`` / ``tkw``: more
    arguments of the JAX call and the port's (labels ...); ``rngs`` the JAX
    call's (a caller that replays JAX's dropout into the port records the
    masks around this call: the JAX train pass runs before the port's).
    The JAX variables are the port's init carried across (``port_to_jax``:
    the JAX init traced, not run) and then perturbed; the JAX passes are
    jitted."""
    jkw, tkw = dict(jkw or {}), dict(tkw or {})
    jmodel = jfactory(jnp.float32)
    shapes = jax.eval_shape(lambda k, xx: jmodel.init(k, xx, train=False,
                                                      **jkw),
                            jax.random.PRNGKey(0), to_jax(x))
    tmodel.init_weights(torch.Generator().manual_seed(0))
    variables = port_to_jax(shapes, {k: v.numpy() for k, v in
                                     tmodel.state_dict().items()},
                            jnp.float32)
    variables = {'params': perturb(variables['params'], 2),
                 'batch_stats': perturb(variables.get('batch_stats', {}), 3)}
    load_jax_variables(tmodel, variables)
    want = flat(jax_eval(jmodel, variables, to_jax(x), jkw))
    tmodel.eval()
    with torch.no_grad():
        got = flat(tmodel(to_torch(x), **tkw))
    _close(got, want, OUT_TOL, 'eval output')
    dt, tdt = (np.float64, torch.float64) if x64 else \
        (np.float32, torch.float32)
    with jax_float64() if x64 else contextlib.nullcontext():
        jm = jfactory(jnp.float64 if x64 else jnp.float32)
        cast = jax.tree.map(lambda a: jnp.asarray(np.asarray(a).astype(
            dt) if np.asarray(a).dtype == np.float32 else np.asarray(a)),
            variables)

        def loss(params, xx):
            out, new = jm.apply(
                {'params': params, 'batch_stats': cast['batch_stats']}, xx,
                train=True, mutable=['batch_stats'], rngs=rngs, **jkw)
            outs = _jax_flat(out)
            # the weights drawn here from the outputs' shapes (no trace of
            # their own), returned in the port's layout
            keys = jax.random.split(jax.random.PRNGKey(1), len(outs))
            ws = [jax.random.normal(k, o.shape, o.dtype) /
                  np.sqrt(max(o.size, 1)) for k, o in zip(keys, outs)]
            return sum(jnp.sum(o * w) for o, w in zip(outs, ws)), \
                (out, new, ws)
        (_, (jout, jnew, weights)), jgrads = jax.jit(jax.value_and_grad(
            loss, has_aux=True))(cast['params'], to_jax(x, dt))
        jout = flat(jout)
        weights = [np.asarray(w) for w in weights]
        jax.effects_barrier()            # its host callbacks have run
        model = copy.deepcopy(tmodel).to(tdt)
        model.train()
        out = model(to_torch(x, tdt), **tkw)
    _close(flat(out), jout, OUT_TOL, 'train output')
    sum((o * torch.from_numpy(np.ascontiguousarray(w.astype(dt)))).sum()
        for o, w in zip(_torch_flat(out), weights)).backward()
    want = jax_to_state_dict({'params': jgrads})
    got = {k: p.grad.numpy() for k, p in model.named_parameters()
           if p.grad is not None}
    assert sorted(got) == sorted(want), set(got) ^ set(want)
    for k in sorted(want):
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **GRAD_TOL)
    want = jax_to_state_dict({'batch_stats': jnew.get('batch_stats', {})})
    got = {k: v.numpy() for k, v in model.state_dict().items()
           if 'running' in k}
    assert sorted(got) == sorted(want)
    for k in sorted(want):
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **OUT_TOL)


def _jax_flat(out):
    """``flat``'s order over a JAX output, 5-D arrays moved to NCTHW."""
    if isinstance(out, dict):
        return [a for k in sorted(out) for a in _jax_flat(out[k])]
    if isinstance(out, (list, tuple)):
        return [a for o in out for a in _jax_flat(o)]
    return [jnp.transpose(out, (0, 4, 1, 2, 3)) if out.ndim == 5 else out]


def _torch_flat(out):
    if isinstance(out, dict):
        return [a for k in sorted(out) for a in _torch_flat(out[k])]
    if isinstance(out, (list, tuple)):
        return [a for o in out for a in _torch_flat(o)]
    return [out]


def from_jax_init(jmodel, tmodel, x, jkw=None, tkw=None):
    """The JAX module's own init (jitted), carried into the port by
    ``load_jax_variables`` alone: both modules' eval outputs within 1e-4
    on ``x``."""
    jkw, tkw = dict(jkw or {}), dict(tkw or {})
    variables = jax.jit(lambda k, xx: jmodel.init(k, xx, train=False,
                                                  **jkw),
                        compiler_options=FAST_COMPILE)(
        jax.random.PRNGKey(3), to_jax(x))
    load_jax_variables(tmodel, variables)
    want = flat(jax_eval(jmodel, variables, to_jax(x), jkw))
    tmodel.eval()
    with torch.no_grad():
        got = flat(tmodel(to_torch(x), **tkw))
    _close(got, want, OUT_TOL, 'eval output from the JAX init')
