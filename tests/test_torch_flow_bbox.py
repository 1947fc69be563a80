"""mscl_torch.flow.flow_bbox against mscl_tpu.flow.flow_bbox, bit for bit
on the CPU: candidate boxes of seeded flows with moving squares, of static
flows and of flows whose box touches a corner; the DP smoothing; and every
value that ``inference_bboxs`` returns, under the same ``np.random`` seed
(the smoothing's jitter draws from it)."""
import numpy as np
import pytest

from mscl_tpu.flow import flow_bbox as jfb
from mscl_torch.flow import flow_bbox as tfb

H, W = 96, 128


def _flows(kind, n=9, seed=0):
    """n flows (H, W, 2): background noise plus a moving square."""
    rng = np.random.default_rng(seed)
    flows = []
    for i in range(n):
        f = rng.normal(scale=0.05, size=(H, W, 2)).astype(np.float32)
        if kind == 'static':
            f[:] = np.float32(0.5)
        elif kind == 'moving':
            y, x = 20 + 3 * i, 30 + 5 * i
            f[y:y + 28, x:x + 24] += np.float32([4.0, -2.5])
        elif kind == 'corner':
            f[:30, :36] += np.float32([-3.0, 3.0])
        elif kind == 'two':
            f[10:40, 10:40] += np.float32([3.0, 0.0])
            f[50:90, 70 + i:110 + i] += np.float32([0.0, 5.0])
        flows.append(f)
    return flows


@pytest.mark.parametrize('kind', ['moving', 'static', 'corner', 'two'])
def test_flow_to_bbox(kind):
    for f in _flows(kind):
        assert tfb.flow_to_bbox(f) == jfb.flow_to_bbox(f)


@pytest.mark.parametrize('kind', ['moving', 'static', 'corner', 'two'])
def test_inference_bboxs(kind):
    flows = _flows(kind)
    n = len(flows) * 2 + 8
    np.random.seed(7)
    ref = jfb.inference_bboxs(n, flows, gap=2, adjacent=8)
    np.random.seed(7)
    out = tfb.inference_bboxs(n, flows, gap=2, adjacent=8)
    boxes, picked, stats = out
    rboxes, rpicked, rstats = ref
    assert picked == rpicked
    np.testing.assert_array_equal(np.asarray(boxes, np.float64),
                                  np.asarray(rboxes, np.float64))
    assert stats[0] == rstats[0]
    assert stats[1:] == rstats[1:]
    if kind == 'moving':
        assert picked and len(boxes) == n


def test_smooth_bbox_dp_and_stats():
    rng = np.random.default_rng(3)
    cands = [[tuple(float(v) for v in np.sort(rng.uniform(0, 120, 4)))
              for _ in range(rng.integers(0, 3))] for _ in range(12)]
    np.random.seed(11)
    ref = jfb.smooth_bbox_dp(cands, length=40, gap=3)
    np.random.seed(11)
    out = tfb.smooth_bbox_dp(cands, length=40, gap=3)
    np.testing.assert_array_equal(np.asarray(out[0]), np.asarray(ref[0]))
    assert out[1:] == ref[1:]
    assert tfb.calc_nearby_bbox_freq(out[1], 40, gap=3) == \
        jfb.calc_nearby_bbox_freq(ref[1], 40, gap=3)
    assert tfb.calc_corner_bbox_freq(out[0], (H, W)) == \
        jfb.calc_corner_bbox_freq(ref[0], (H, W))
    for a, b in zip(cands[:-1], cands[1:]):
        for x in a:
            for y in b:
                assert tfb.DIOU_modify(x, y) == jfb.DIOU_modify(x, y)
                assert tfb.IOU(x, y) == jfb.IOU(x, y)
