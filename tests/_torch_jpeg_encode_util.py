"""The cases that hold the port's JPEG encoder to cv2, without cv2.

Each case is a seeded image (a colour gradient with grain; grey is its
green channel) and a quality. ``tests/test_torch_jpeg_encode.py`` holds
``mscl_torch.utils.jpeg.encode_jpeg`` to ``cv2.imencode('.jpg')`` on every
case and checks the committed ``encode_digests.json`` (the sha256 of cv2's
bytes); ``chip_smoke.py`` holds the card machine's build to the same
digests, where there is no cv2.

    python tests/test_torch_jpeg_encode.py     # rewrite encode_digests.json
"""
import hashlib
import os

import numpy as np

DIGESTS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       'fixtures_torch', 'jpeg', 'encode_digests.json')
SIZES = ((1, 1), (7, 9), (16, 16), (17, 33), (128, 171))
QUALITIES = (95, 75, 30)


def cases():
    """Case names: ``{rgb|grey}_{h}x{w}_q{quality}``."""
    return [f'{kind}_{h}x{w}_q{q}' for kind in ('rgb', 'grey')
            for h, w in SIZES for q in QUALITIES]


def case_image(name):
    """(image, quality) of a case: RGB (h, w, 3) or grey (h, w) uint8."""
    kind, hw, q = name.split('_')
    h, w = (int(v) for v in hw.split('x'))
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([(7 * y + 3 * x) % 256, 128 + 100 * np.sin(x / 9.0),
                    (11 * y) % 256], -1).astype(np.float64)
    img += np.random.default_rng(h * 1000 + w).normal(0, 24, img.shape)
    img = np.clip(np.rint(img), 0, 255).astype(np.uint8)
    return (img if kind == 'rgb' else np.ascontiguousarray(img[..., 1])), \
        int(q[1:])


def sha256(buf):
    return hashlib.sha256(buf).hexdigest()
