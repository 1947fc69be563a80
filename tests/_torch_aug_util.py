"""JAX's augmentation draws, replayed for the port.

torch cannot reproduce ``jax.random``. These helpers split a key exactly as
``mscl_tpu/models/common/ssl_aug.py`` splits it and draw what it draws, in
the port's parameter layout (``draw_*`` of ``mscl_torch``'s ssl_aug), so
that the port's deterministic apply can be fed JAX's own draws.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch


def _t(x):
    return torch.from_numpy(np.array(x))


def jitter(key, b, t, brightness=0.4, contrast=0.4, saturation=0.4, hue=0.1,
           p=0.8, per_frame_params=True):
    k_apply, kb, kc, ks, kh = jax.random.split(key, 5)

    def per(k, lo, hi):
        if per_frame_params:
            x = jax.random.uniform(k, (b, t), minval=lo, maxval=hi)
        else:
            x = jnp.broadcast_to(
                jax.random.uniform(k, (b, 1), minval=lo, maxval=hi), (b, t))
        return _t(x)

    return dict(
        apply=_t(jax.random.bernoulli(k_apply, p, (b,))),
        brightness=per(kb, max(0., 1 - brightness), 1 + brightness),
        contrast=per(kc, max(0., 1 - contrast), 1 + contrast),
        saturation=per(ks, max(0., 1 - saturation), 1 + saturation),
        hue=per(kh, -hue, hue) if hue else None)


def gray(key, b, p=0.2):
    return dict(apply=_t(jax.random.bernoulli(key, p, (b,))))


def blur(key, b, sigma_range=(0.1, 2.0), p=0.5):
    k_apply, k_sigma = jax.random.split(key)
    return dict(apply=_t(jax.random.bernoulli(k_apply, p, (b,))),
                sigma=_t(jax.random.uniform(k_sigma, (), minval=sigma_range[0],
                                            maxval=sigma_range[1])))


def strong(key, b, t, per_frame_params=True):
    k1, k2, k3 = jax.random.split(key, 3)
    return dict(jitter=jitter(k1, b, t, 0.4, 0.4, 0.4, 0.1, p=0.8,
                              per_frame_params=per_frame_params),
                gray=gray(k2, b, 0.2), blur=blur(k3, b, p=0.5))


def sync_v5(aug, key, b, t):
    """The draws of a SyncMoCoAugmentV5 (V2, V3, V4) call on clips (B, T),
    for the port's ``apply``: aug is the port's (or JAX's) instance."""
    out = {}
    for name, k, weak, sync in zip('qk', jax.random.split(key),
                                   aug.weak_aug, aug.sync_level):
        k_flip, k_aug = jax.random.split(k)
        if aug.flip_enabled:
            flip = _t(jax.random.bernoulli(k_flip, aug.flip_p, (b,)))
        else:
            flip = torch.zeros(b, dtype=torch.bool)
        out[name] = dict(flip=flip, strong=None if weak else strong(
            k_aug, b, t, per_frame_params=(sync == 'batch')))
    return out


def moco_clips(key, n):
    """MoCoAugment.augment's draws for n frames."""
    k1, k2, k3, _ = jax.random.split(key, 4)
    return dict(gray=gray(k1, n, 0.2),
                jitter=jitter(k2, n, 1, 0.4, 0.4, 0.4, 0.4, p=1.0),
                flip=_t(jax.random.bernoulli(k3, 0.5, (n,))))


def moco_v2_clips(key, n):
    """MoCoAugmentV2.augment's draws for n frames."""
    k1, k2, k3, k4, _ = jax.random.split(key, 5)
    return dict(jitter=jitter(k1, n, 1, 0.4, 0.4, 0.4, 0.1, p=0.8),
                gray=gray(k2, n, 0.2), blur=blur(k3, n, p=0.5),
                flip=_t(jax.random.bernoulli(k4, 0.5, (n,))))


def moco(draw_clips, key, n, pair=True):
    """MoCoAugment(V2)'s draws: one key for q alone, split for a pair."""
    if not pair:
        return dict(q=draw_clips(key, n))
    kq, kk = jax.random.split(key)
    return dict(q=draw_clips(kq, n), k=draw_clips(kk, n))
