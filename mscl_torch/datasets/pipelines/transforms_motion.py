"""Flow Rotation Augmentation (FRA) and flow normalization.

Port of ``mscl_tpu/datasets/pipelines/transforms_motion.py`` (reference
mmaction transforms_motion.py:7-243): ``norm_flow``, ``rotate_flow``, their
(T, H, W, 2) forms, and ``NormFlowWithAug`` / ``NormFlowWithStidedAug``,
which rotate every flow vector of a clip by one angle drawn from the global
``np.random`` and append the rotated, normalised flows after the originals
(the V2s write them under 'flows'); ``NormFlowV2`` normalises only;
``Flow2ImgWithAug`` draws an angle a frame and writes colour-wheel images
(``utils/flow_viz.flow_to_image``) of the flows and of their rotations.
"""
from __future__ import annotations

import numpy as np

from ..builder import PIPELINES
from ...utils.flow_viz import flow_to_image


def norm_flow(flow_uv: np.ndarray, clip_flow=None) -> np.ndarray:
    """Normalize flow by its max radius (reference
    transforms_motion.py:7-29)."""
    assert flow_uv.ndim == 3 and flow_uv.shape[2] == 2
    if clip_flow is not None:
        flow_uv = np.clip(flow_uv, 0, clip_flow)
    u = flow_uv[:, :, 0]
    v = flow_uv[:, :, 1]
    rad = np.sqrt(np.square(u) + np.square(v))
    rad_max = np.max(rad)
    epsilon = 1e-5
    u = u / (rad_max + epsilon)
    v = v / (rad_max + epsilon)
    return np.stack((u, v), axis=-1)


def rotate_flow(flow_uv: np.ndarray, beta: float) -> np.ndarray:
    """Rotate each (u, v) vector by angle beta (radians)."""
    u = flow_uv[:, :, 0]
    v = flow_uv[:, :, 1]
    sin_b, cos_b = np.sin(beta), np.cos(beta)
    new_u = cos_b * u - sin_b * v
    new_v = sin_b * u + cos_b * v
    return np.stack((new_u, new_v), axis=-1)


def _norm_flow_frames(flows: np.ndarray) -> np.ndarray:
    """Vectorized norm_flow over a (T, H, W, 2) clip — each frame divided
    by its OWN max radius (bit-identical to mapping norm_flow per frame:
    sqrt(max(rad^2)) == max(sqrt(rad^2)) elementwise, and the square-sum
    form avoids strided channel views). One fused numpy pass instead of
    2T small ops — this loop is on the decode-worker critical path."""
    sq = np.square(flows)
    rad2 = sq[..., 0] + sq[..., 1]
    rad_max = np.sqrt(rad2.max(axis=(1, 2)))[:, None, None, None]
    # in-place divide: callers pass freshly-stacked/rotated arrays they
    # own; avoiding the output allocation halves the page-fault cost
    np.divide(flows, rad_max + flows.dtype.type(1e-5), out=flows)
    return flows


def _rotate_flow_frames(flows: np.ndarray, beta: float) -> np.ndarray:
    """Vectorized rotate_flow over (T, H, W, 2) with one shared angle.

    f32 clips rotate as one contiguous complex64 multiply (~8x the
    strided channel-view form). Precision note: the reference's
    per-frame path silently promotes the rotated copy to float64 (numpy
    scalar-promotion accident); this stays in f32, deviating <= ~2.5e-6
    absolutely on recipe-scale flows — invisible at the model's bf16
    input precision and half the host bandwidth downstream."""
    if flows.dtype == np.float32:
        fc = np.ascontiguousarray(flows).view(np.complex64)[..., 0]
        rot = fc * np.complex64(complex(np.cos(beta), np.sin(beta)))
        return rot.view(np.float32).reshape(flows.shape)
    u = flows[..., 0]
    v = flows[..., 1]
    sin_b, cos_b = np.sin(beta), np.cos(beta)
    return np.stack((cos_b * u - sin_b * v, sin_b * u + cos_b * v),
                    axis=-1)


@PIPELINES.register_module()
class Flow2ImgWithAug:
    """FRA with colour-wheel images out, an angle a frame (reference
    transforms_motion.py:33-65)."""

    def __init__(self, ratios, convert_to_bgr=False, merge_aug=True):
        self.ratios = ratios
        self.convert_to_bgr = convert_to_bgr
        self.merge_aug = merge_aug

    def __call__(self, results):
        flow_imgs, rotated = [], []
        for flow_uv in results['flows']:
            beta = np.random.uniform(*self.ratios) * np.pi
            new_flow_uv = rotate_flow(flow_uv, beta)
            flow_imgs.append(
                flow_to_image(flow_uv, convert_to_bgr=self.convert_to_bgr))
            rotated.append(
                flow_to_image(new_flow_uv,
                              convert_to_bgr=self.convert_to_bgr))
        if self.merge_aug:
            results['flow_imgs'] = flow_imgs + rotated
        else:
            results['flow_imgs'] = flow_imgs
            results['rotated_flow_imgs'] = rotated
        return results


class _NormFlowAugBase:
    """Shared FRA body: one angle per clip, normalize both original and
    rotated flow by their own max radii."""

    out_key = 'flow_imgs'
    delete_flows = True

    def _angle(self):
        raise NotImplementedError

    def _emit_label(self, results, cid):
        pass

    def __call__(self, results):
        beta, cid = self._angle()
        flows = np.stack(results['flows'])
        rot = _rotate_flow_frames(flows, beta)   # before norm mutates flows
        flow_imgs = list(_norm_flow_frames(flows))
        rotated = list(_norm_flow_frames(rot))
        if self.merge_aug:
            results[self.out_key] = flow_imgs + rotated
        else:
            results[self.out_key] = flow_imgs
            results['rotated_' + self.out_key] = rotated
        self._emit_label(results, cid)
        if self.delete_flows and self.out_key != 'flows':
            del results['flows']
        return results


@PIPELINES.register_module()
class NormFlowWithAug(_NormFlowAugBase):
    """Continuous-angle FRA (reference transforms_motion.py:67-100)."""

    def __init__(self, ratios, merge_aug=True):
        self.ratios = ratios
        self.merge_aug = merge_aug

    def _angle(self):
        return np.random.uniform(*self.ratios) * np.pi, None


@PIPELINES.register_module()
class NormFlowWithStidedAug(_NormFlowAugBase):
    """Discrete-angle FRA with angle-chunk label for the optional
    angle-prediction head (reference transforms_motion.py:103-146):
    beta = (start + stride*cid)*pi, cid ~ U[0, num_chunks)."""

    def __init__(self, ratios, num_chunks, merge_aug=True):
        self.ratios = ratios
        self.start = ratios[0]
        self.stride = (ratios[1] - ratios[0]) / num_chunks
        self.num_chunks = num_chunks
        self.merge_aug = merge_aug

    def _angle(self):
        cid = np.random.randint(0, self.num_chunks)
        return (self.start + self.stride * cid) * np.pi, int(cid)

    def _emit_label(self, results, cid):
        results['ap_labels'] = cid


@PIPELINES.register_module()
class NormFlowWithStidedAugV2(NormFlowWithStidedAug):
    """NormFlowWithStidedAug writing under 'flows' (reference
    transforms_motion.py:149-190)."""
    out_key = 'flows'
    delete_flows = False


@PIPELINES.register_module()
class NormFlowWithAugV2(NormFlowWithAug):
    """NormFlowWithAug writing under 'flows' (reference
    transforms_motion.py:210-243)."""
    out_key = 'flows'
    delete_flows = False


@PIPELINES.register_module()
class NormFlowV2:
    """Normalise only, no augmentation (reference
    transforms_motion.py:193-207)."""

    def __call__(self, results):
        results['flows'] = list(
            _norm_flow_frames(np.stack(results['flows'])))
        return results
