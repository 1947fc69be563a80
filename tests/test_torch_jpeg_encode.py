"""The port's JPEG encoder against cv2.imencode('.jpg') (libjpeg-turbo),
byte for byte: RGB and grey at 1x1, 7x9, 16x16, 17x33 and 128x171, at
qualities 95 (cv2's default), 75 and 30, and ``imwrite`` against
``cv2.imwrite``; the committed digests that ``chip_smoke.py`` checks on the
card's machine; and the drawing and resizing the tools take from cv2
(``image_io.rectangle``, the 3-channel float32 ``imresize``), bit for
bit."""
import json
import os
import sys

import cv2
import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]
from mscl_torch.utils import image_io, jpeg  # noqa: E402

import _torch_jpeg_encode_util as eu  # noqa: E402


def cv2_bytes(name):
    img, q = eu.case_image(name)
    bgr = img[..., ::-1] if img.ndim == 3 else img
    ok, buf = cv2.imencode('.jpg', bgr, [cv2.IMWRITE_JPEG_QUALITY, q])
    assert ok
    return buf.tobytes()


@pytest.mark.parametrize('name', eu.cases())
def test_encode_matches_cv2(name):
    img, q = eu.case_image(name)
    assert jpeg.encode_jpeg(img, q) == cv2_bytes(name)
    if img.ndim == 2:
        assert jpeg.encode_jpeg(img[..., None], q) == cv2_bytes(name)


def test_committed_digests_are_cv2s():
    with open(eu.DIGESTS) as f:
        digests = json.load(f)
    assert digests == {n: eu.sha256(cv2_bytes(n)) for n in eu.cases()}


def test_imwrite_matches_cv2(tmp_path):
    bgr = np.random.default_rng(0).integers(0, 256, (37, 53, 3),
                                            dtype=np.uint8)
    jpeg.imwrite(str(tmp_path / 'a.jpg'), bgr)
    cv2.imwrite(str(tmp_path / 'b.jpg'), bgr)
    assert (tmp_path / 'a.jpg').read_bytes() == \
        (tmp_path / 'b.jpg').read_bytes()
    # and the port's decoder reads it back as cv2 does
    np.testing.assert_array_equal(
        jpeg.decode_jpeg(np.fromfile(str(tmp_path / 'a.jpg'), np.uint8)),
        cv2.imread(str(tmp_path / 'b.jpg'))[..., ::-1])


def test_encode_refuses_other_images():
    for bad in (np.zeros((4, 4, 3), np.float32), np.zeros((4, 4, 4),
                                                         np.uint8),
                np.zeros((0, 4, 3), np.uint8)):
        with pytest.raises(ValueError):
            jpeg.encode_jpeg(bad)


def test_rectangle_matches_cv2():
    rng = np.random.default_rng(0)
    for _ in range(400):
        h, w = (int(v) for v in rng.integers(1, 40, 2))
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        p1 = tuple(int(v) for v in rng.integers(-20, 60, 2))
        p2 = tuple(int(v) for v in rng.integers(-20, 60, 2))
        color = tuple(int(v) for v in rng.integers(0, 256, 3))
        np.testing.assert_array_equal(
            image_io.rectangle(img.copy(), p1, p2, color),
            cv2.rectangle(img.copy(), p1, p2, color, 1, cv2.LINE_8))


@pytest.mark.parametrize('hw,out_hw', [
    ((128, 171), (64, 86)), ((44, 60), (128, 171)), ((17, 33), (40, 20)),
    ((100, 100), (50, 50)), ((2, 2), (5, 5)), ((1, 5), (3, 4)),
    ((5, 7), (3, 2))])
def test_float32_rgb_resize_matches_cv2(hw, out_hw):
    img = np.random.default_rng(1).uniform(0, 255, hw + (3,)) \
        .astype(np.float32)
    np.testing.assert_array_equal(
        image_io.imresize(img, out_hw[::-1]),
        cv2.resize(img, out_hw[::-1], interpolation=cv2.INTER_LINEAR))


if __name__ == '__main__':
    with open(eu.DIGESTS, 'w') as f:
        json.dump({n: eu.sha256(cv2_bytes(n)) for n in eu.cases()}, f,
                  indent=1, sort_keys=True)
    print(f'wrote {eu.DIGESTS}')
