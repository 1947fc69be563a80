"""The port's frame I/O (``mscl_torch/utils/image_io.py``) against OpenCV,
which the JAX data path calls: the PNG reader bitwise against
``cv2.imread`` and ``IMREAD_REDUCED_COLOR_2``, through its C row unfilter
and through its numpy one, and ``imresize`` against
``cv2.resize(INTER_LINEAR)`` on every crop size the flagship pipeline can
resize (uint8 and float32 bitwise; float32 is held to 1e-6 too)."""
import struct
import zlib

import cv2
import numpy as np
import pytest

from mscl_torch.ops import cuda_build
from mscl_torch.utils import image_io
from mscl_torch.utils.image_io import (decode_png, imread_rgb, imresize,
                                       read_image_shape)

TARGET = 112


def _cv2_rgb(path, reduce=1):
    buf = np.fromfile(path, np.uint8)
    flag = cv2.IMREAD_REDUCED_COLOR_2 if reduce == 2 else cv2.IMREAD_COLOR
    return cv2.cvtColor(cv2.imdecode(buf, flag), cv2.COLOR_BGR2RGB)


@pytest.fixture(params=['c', 'numpy'])
def unfilter(request, monkeypatch):
    """The row unfilter under test: the C one, or numpy's where the machine
    has no C compiler."""
    if request.param == 'numpy':
        monkeypatch.setattr(image_io, '_unfilter_lib', lambda: None)
    else:
        assert image_io._unfilter_lib() is not None
    return request.param


def test_png_unfilter_c_builds():
    """The C unfilter is built wherever there is a host C compiler (here),
    so the decode threads never fall back to numpy's wavefront there."""
    assert cuda_build.host_cc() is not None
    lib = image_io._unfilter_lib()
    assert lib is not None and lib is image_io._unfilter_lib()


def _image(rng, h, w, ch, smooth):
    shape = (h, w) if ch == 1 else (h, w, ch)
    img = rng.integers(0, 256, shape)
    if smooth:      # gradients make the adaptive filter pick Avg/Paeth
        img = np.cumsum(np.cumsum(img, axis=0), axis=1) // 97
    return (img % 256).astype(np.uint8)


def _filters(path, h):
    """The filter type of each row of a PNG file."""
    buf, pos, idat = open(path, 'rb').read(), 8, []
    while pos < len(buf):
        length = int.from_bytes(buf[pos:pos + 4], 'big')
        if buf[pos + 4:pos + 8] == b'IDAT':
            idat.append(buf[pos + 8:pos + 8 + length])
        pos += 12 + length
    rows = np.frombuffer(zlib.decompress(b''.join(idat)), np.uint8)
    return rows.reshape(h, -1)[:, 0]


@pytest.mark.parametrize('ch', [1, 3, 4])
@pytest.mark.parametrize('h,w', [(1, 1), (17, 5), (37, 53), (64, 86)])
def test_png_reader_matches_cv2(tmp_path, h, w, ch, unfilter):
    """cv2's default writer (Sub rows in cv2 5) and libpng's adaptive
    choice of all five filters, as other writers use it."""
    rng = np.random.default_rng(h * 100 + w + ch)
    types = []
    for smooth in (False, True):
        for flags in ([], [cv2.IMWRITE_PNG_FILTER,
                           cv2.IMWRITE_PNG_ALL_FILTERS]):
            img = _image(rng, h, w, ch, smooth)
            path = str(tmp_path / f'x{smooth}{len(flags)}.png')
            cv2.imwrite(path, img, flags)
            types.extend(_filters(path, h))
            np.testing.assert_array_equal(imread_rgb(path), _cv2_rgb(path))
            if min(h, w) >= 2:
                np.testing.assert_array_equal(imread_rgb(path, reduce=2),
                                              _cv2_rgb(path, reduce=2))
    if h * w > 1:
        assert {1, 4} <= set(int(t) for t in types), types


def _png(img, filt):
    """A PNG whose every row uses filter ``filt`` (0-4), written by hand."""
    h, w, bpp = img.shape
    data = img.astype(np.int64)
    rows = []
    for r in range(h):
        cur = data[r].reshape(-1)
        prior = data[r - 1].reshape(-1) if r else np.zeros_like(cur)
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prior[:-bpp]])
        if filt == 0:
            pred = 0
        elif filt == 1:
            pred = left
        elif filt == 2:
            pred = prior
        elif filt == 3:
            pred = (left + prior) // 2
        else:
            p = left + prior - upleft
            pa, pb, pc = abs(p - left), abs(p - prior), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prior, upleft))
        rows.append(bytes([filt]) + ((cur - pred) % 256).astype(
            np.uint8).tobytes())

    def chunk(kind, body):
        return (struct.pack('>I', len(body)) + kind + body +
                struct.pack('>I', zlib.crc32(kind + body)))

    colour = {1: 0, 3: 2, 4: 6}[bpp]
    return (b'\x89PNG\r\n\x1a\n' +
            chunk(b'IHDR', struct.pack('>IIBBBBB', w, h, 8, colour, 0, 0, 0))
            + chunk(b'IDAT', zlib.compress(b''.join(rows)))
            + chunk(b'IEND', b''))


@pytest.mark.parametrize('filt', [0, 1, 2, 3, 4])
@pytest.mark.parametrize('bpp', [1, 3, 4])
def test_png_every_filter(tmp_path, filt, bpp, unfilter):
    rng = np.random.default_rng(filt * 10 + bpp)
    img = rng.integers(0, 256, (23, 31, bpp)).astype(np.uint8)
    path = tmp_path / 'f.png'
    path.write_bytes(_png(img, filt))
    want = _cv2_rgb(str(path))
    got = imread_rgb(str(path))
    np.testing.assert_array_equal(got, want)
    expect = np.repeat(img, 3, axis=2) if bpp == 1 else img[..., :3]
    np.testing.assert_array_equal(got, expect)
    np.testing.assert_array_equal(imread_rgb(str(path), reduce=2),
                                  _cv2_rgb(str(path), reduce=2))


def test_png_not_taken_goes_to_cv2(tmp_path):
    """A 16-bit PNG is not the reader's: it goes to cv2, as the JAX path."""
    img = np.random.default_rng(0).integers(0, 65535, (9, 11, 3)).astype(
        np.uint16)
    path = str(tmp_path / 'deep.png')
    cv2.imwrite(path, img)
    assert decode_png(open(path, 'rb').read()) is None
    np.testing.assert_array_equal(imread_rgb(path), _cv2_rgb(path))


def test_jpeg_through_cv2_and_its_error_without_it(tmp_path, monkeypatch):
    img = np.random.default_rng(1).integers(0, 256, (40, 54, 3)).astype(
        np.uint8)
    path = str(tmp_path / 'f.jpg')
    cv2.imwrite(path, img)
    assert read_image_shape(path) == (40, 54)
    np.testing.assert_array_equal(imread_rgb(path), _cv2_rgb(path))
    np.testing.assert_array_equal(imread_rgb(path, 2), _cv2_rgb(path, 2))
    import builtins
    real_import = builtins.__import__

    def no_cv2(name, *args, **kwargs):
        if name == 'cv2':
            raise ImportError('no cv2')
        return real_import(name, *args, **kwargs)
    monkeypatch.setattr(builtins, '__import__', no_cv2)
    with pytest.raises(ImportError, match='f.jpg needs OpenCV'):
        imread_rgb(path)
    png = str(tmp_path / 'f.png')
    (tmp_path / 'f.png').write_bytes(_png(img, 4))
    assert read_image_shape(png) == (40, 54)
    np.testing.assert_array_equal(imread_rgb(png), img)  # no cv2 needed


def _crop_sizes(h, w, area=(0.2, 1.0), ratio=(3 / 4, 4 / 3)):
    """Every (crop_h, crop_w) that get_random_resized_crop_bbox can return
    on an h x w frame: round(sqrt(A * r)) x round(sqrt(A / r)) inside the
    frame, and the centre-square fallback (a superset at the rounding
    edges)."""
    cw = np.arange(1, w + 1)[None, :]
    ch = np.arange(1, h + 1)[:, None]
    full = h * w
    ok = (((cw + 0.5) * (ch + 0.5) >= area[0] * full) &
          ((cw - 0.5) * (ch - 0.5) <= area[1] * full) &
          ((cw + 0.5) / (ch - 0.5) >= ratio[0]) &
          ((cw - 0.5) / (ch + 0.5) <= ratio[1]))
    ys, xs = np.nonzero(ok)
    sizes = set(zip((ys + 1).tolist(), (xs + 1).tolist()))
    sizes.add((min(h, w), min(h, w)))
    return sorted(sizes)


def _flow_crop_sizes(fh, fw, h, w):
    """The flow crop sizes MoCoRandomResizedCrop replays from each frame
    crop: the box scaled by the flow/frame resolution ratio and rounded."""
    out = set()
    hr, wr = fh / h, fw / w
    for ch, cw in _crop_sizes(h, w):
        for y in range(0, 2):          # both roundings of the box edges
            for x in range(0, 2):
                out.add((min(fh, round((y + ch) * hr) - round(y * hr)),
                         min(fw, round((x + cw) * wr) - round(x * wr))))
    return sorted(out)


def _check_u8(src, sizes, target):
    bad = []
    for ch, cw in sizes:
        a = src[:ch, :cw]
        if not np.array_equal(imresize(a, target),
                              cv2.resize(a, target,
                                         interpolation=cv2.INTER_LINEAR)):
            bad.append((ch, cw))
    assert not bad, f'{len(bad)} of {len(sizes)} sizes differ: {bad[:10]}'


@pytest.mark.parametrize('shape', [(256, 340), (128, 170)])
def test_imresize_uint8_every_frame_crop(shape):
    """Frame crops on 256x340 and, under a half-scale decode plan, on
    128x170, to 112x112: bitwise."""
    h, w = shape
    src = np.random.default_rng(h).integers(0, 256, (h, w, 3)).astype(
        np.uint8)
    sizes = _crop_sizes(h, w)
    assert (h // 2 * 2, h // 2 * 2) in sizes or h < 224
    _check_u8(src, sizes, (TARGET, TARGET))


def test_imresize_uint8_upscales_and_odd_targets():
    rng = np.random.default_rng(3)
    src = rng.integers(0, 256, (256, 340, 3)).astype(np.uint8)
    sizes = [(h, w) for h in range(1, 112, 3) for w in range(1, 112, 5)]
    _check_u8(src, sizes, (TARGET, TARGET))
    _check_u8(src, [(224, 224), (33, 47), (100, 1)], (23, 19))
    gray = src[..., 0]
    _check_u8(gray, [(57, 91), (112, 112), (256, 340)], (TARGET, TARGET))


def test_imresize_float32_every_flow_crop():
    """Flow crops replayed on 128x171 flows (the README's extraction size)
    from 256x340 frame crops, to 112x112: bitwise (the port's bar is 1e-6;
    OpenCV's float taps and products are float32, as the port's)."""
    rng = np.random.default_rng(4)
    flow = rng.normal(size=(128, 171, 2)).astype(np.float32)
    flow /= np.abs(flow).max()
    worst, differ = 0.0, 0
    for ch, cw in _flow_crop_sizes(128, 171, 256, 340):
        a = flow[:ch, :cw]
        got = imresize(a, (TARGET, TARGET))
        assert got.dtype == np.float32 and got.shape == (TARGET, TARGET, 2)
        want = cv2.resize(a, (TARGET, TARGET), interpolation=cv2.INTER_LINEAR)
        worst = max(worst, float(np.abs(got - want).max()))
        differ += int(got.tobytes() != want.tobytes())
    assert worst <= 1e-6, worst
    assert differ == 0, differ


def test_reduce_half_is_opencvs_exact_linear():
    rng = np.random.default_rng(5)
    for h, w in [(256, 340), (33, 47), (7, 2)]:
        img = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        want = cv2.resize(img, (w // 2, h // 2),
                          interpolation=cv2.INTER_LINEAR_EXACT)
        np.testing.assert_array_equal(image_io.reduce_half(img), want)
