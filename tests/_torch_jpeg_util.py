"""JPEG files for the port's decoder tests, written with cv2 (libjpeg-turbo).

``write_fixtures(dir)`` writes the committed set under
``tests/fixtures_torch/jpeg/``: 16 frames of 256x340 (a smooth pattern that
moves from frame to frame, with a little grain, quality 90, 4:2:0), the
frames ``chip_smoke.py`` builds its Kinetics-shaped set from, and a small
coverage set (every sampling factor, grey, restart markers, optimized
tables, 16-bit tables, odd sizes), with ``digests.json``: the shape and sha256 of cv2's RGB decode
of each file at reduce 1 and 2. The card's machine has no cv2, so the
digests are what its build of ``csrc/jpeg_decode.c`` is held to there.

    python tests/_torch_jpeg_util.py      # rewrite the committed set
"""
import hashlib
import json
import os
import struct

import cv2
import numpy as np

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        'fixtures_torch', 'jpeg')
FRAME_HW = (256, 340)
N_FRAMES = 16
SAMPLING = {'444': cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            '422': cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            '440': cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
            '420': cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            '411': cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411}


def smooth(h, w, t=0, grain=0.0):
    """A smooth colour pattern, moved by (3t, 2t) pixels at step t, with a
    bright square moving across it; ``grain``: the sigma of a sensor-like
    noise drawn anew each step."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    x, y = x + 3 * t, y + 2 * t
    img = np.stack([
        128 + 70 * np.sin(x / 23) * np.cos(y / 17),
        128 + 60 * np.sin((x + y) / 31 + 1),
        110 + 50 * np.cos((x - 2 * y) / 29) + y / 8], -1)
    s = min(h, w) // 4
    if s:
        y0, x0 = (h // 3 + 5 * t) % max(h - s, 1), (w // 4 + 7 * t) % \
            max(w - s, 1)
        img[y0:y0 + s, x0:x0 + s] = [230, 220, 40]
    if grain:
        img += np.random.default_rng(t).normal(0, grain, img.shape)
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


def noise(h, w, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3),
                                                dtype=np.uint8)


def encode(rgb, quality=90, sampling='420', rst=0, optimize=False,
           progressive=False, grey=False):
    """cv2.imencode of an RGB image (grey: its luma); the file's bytes."""
    img = cv2.cvtColor(rgb, cv2.COLOR_RGB2GRAY) if grey else \
        cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR)
    ok, buf = cv2.imencode('.jpg', img, [
        cv2.IMWRITE_JPEG_QUALITY, quality,
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling],
        cv2.IMWRITE_JPEG_RST_INTERVAL, rst,
        cv2.IMWRITE_JPEG_OPTIMIZE, int(optimize),
        cv2.IMWRITE_JPEG_PROGRESSIVE, int(progressive)])
    assert ok
    return buf.tobytes()


def segments(buf):
    """(marker, payload offset, payload length) of each segment up to SOS."""
    pos, out = 2, []
    while pos < len(buf):
        marker = buf[pos + 1]
        length = struct.unpack('>H', buf[pos + 2:pos + 4])[0]
        out.append((marker, pos + 4, length - 2))
        if marker == 0xDA:
            break
        pos += 2 + length
    return out


def dqt16(buf):
    """The same file with every DQT table stored with 16-bit entries (the
    same values; cv2's encoder writes 8-bit ones)."""
    out, pos = bytearray(buf[:2]), 2
    for marker, start, n in segments(buf):
        seg = buf[start:start + n]
        if marker == 0xDB:
            tables, i = b'', 0
            while i < n:
                pq, tq = seg[i] >> 4, seg[i] & 15
                assert pq == 0
                tables += bytes([0x10 | tq]) + struct.pack(
                    '>64H', *seg[i + 1:i + 65])
                i += 65
            seg = tables
        out += bytes([0xFF, marker]) + struct.pack('>H', len(seg) + 2) + seg
        pos = start + n
    return bytes(out + buf[pos:])


def with_exif_orientation(buf, orientation, little_endian=True):
    """The file with an APP1 Exif segment whose IFD0 holds Orientation."""
    e = '<' if little_endian else '>'
    tiff = (b'II*\x00' if little_endian else b'MM\x00*') + \
        struct.pack(e + 'IH', 8, 1) + \
        struct.pack(e + 'HHI', 0x0112, 3, 1) + \
        struct.pack(e + 'HH', orientation, 0) + b'\x00' * 4
    data = b'Exif\x00\x00' + tiff
    return buf[:2] + b'\xff\xe1' + struct.pack('>H', len(data) + 2) + \
        data + buf[2:]


def cv2_rgb(buf, reduce=1):
    """What the JAX data path decodes (``loading.py`` ``_imread_rgb``)."""
    arr = np.frombuffer(buf, np.uint8)
    if reduce == 2:
        return cv2.cvtColor(cv2.imdecode(arr, cv2.IMREAD_REDUCED_COLOR_2),
                            cv2.COLOR_BGR2RGB)
    return cv2.imdecode(arr, cv2.IMREAD_COLOR_RGB)


def digest(img):
    return dict(shape=list(img.shape),
                sha256=hashlib.sha256(np.ascontiguousarray(img)).hexdigest())


def frame_files():
    """The 16 frames: name -> bytes."""
    return {f'frame_{i:02d}.jpg': encode(smooth(*FRAME_HW, t=i, grain=3))
            for i in range(N_FRAMES)}


def coverage_files():
    """The small coverage set: name -> bytes."""
    files = {}
    for s in SAMPLING:
        files[f'cov_{s}_q100_noise_17x33.jpg'] = encode(
            noise(17, 33, 1), 100, s)
        files[f'cov_{s}_q50_smooth_255x339.jpg'] = encode(
            smooth(255, 339), 50, s)
    files['cov_grey_q90_smooth_255x339.jpg'] = encode(
        smooth(255, 339), 90, grey=True)
    files['cov_grey_q100_noise_7x9.jpg'] = encode(noise(7, 9, 2), 100,
                                                  grey=True)
    files['cov_420_q90_rst3_smooth_255x339.jpg'] = encode(
        smooth(255, 339), 90, rst=3)
    files['cov_422_q90_opt_noise_7x9.jpg'] = encode(noise(7, 9, 3), 90,
                                                    '422', optimize=True)
    files['cov_420_q90_1x1.jpg'] = encode(noise(1, 1, 4), 90)
    files['cov_420_q90_dqt16_smooth_17x33.jpg'] = dqt16(encode(
        smooth(17, 33), 90))
    return files


def write_fixtures(root=FIXTURES):
    os.makedirs(root, exist_ok=True)
    digests = {}
    for name, buf in {**frame_files(), **coverage_files()}.items():
        with open(os.path.join(root, name), 'wb') as f:
            f.write(buf)
        digests[name] = {str(r): digest(cv2_rgb(buf, r)) for r in (1, 2)}
    with open(os.path.join(root, 'digests.json'), 'w') as f:
        json.dump(digests, f, indent=1, sort_keys=True)
        f.write('\n')


if __name__ == '__main__':
    write_fixtures()
