"""The port's np4 codec (``mscl_torch/utils/np4.py``: the native LZ4 codec
``csrc/lz4codec.cpp`` and its own msgpack of the np4 map) against
``mscl_tpu.utils.np4``: the same blob bytes, each package decoding the
other's blobs, the blobs other msgpack writers produce, what is not a blob;
and ``cuda_build.load_host`` building a C++ source into the ignored build
directory at first use."""
import os
import struct
import subprocess

import msgpack
import numpy as np
import pytest

from mscl_tpu.utils import np4 as jnp4
from mscl_torch.ops import cuda_build
from mscl_torch.utils import np4 as tnp4

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = [(5,), (0,), (300,), (3, 4), (128, 171), (2, 3, 4), (16, 17, 2),
          (128, 171, 2), (1, 2, 3, 4), (2, 300, 3, 1)]


def _array(dtype, shape, seed=0):
    rng = np.random.default_rng(seed)
    if dtype == 'uint8':
        return rng.integers(0, 256, shape).astype(np.uint8)
    arr = rng.normal(scale=4, size=shape).astype(dtype)
    if arr.size > 8:
        arr.reshape(-1)[: arr.size // 3] = 0       # compressible runs
    return arr


@pytest.fixture(autouse=True)
def native_codecs():
    """Both packages with their native LZ4 codec."""
    assert tnp4._native() is not None
    assert jnp4._load_native() is not None


def test_lz4codec_cpp_builds():
    """The native codec is built wherever there is a host C++ compiler
    (here), from the port's own copy of native/lz4codec.cpp."""
    assert cuda_build.host_cxx() is not None
    assert cuda_build.host_source('lz4codec').name == 'lz4codec.cpp'
    assert 'lz4codec.cpp' in cuda_build.host_sources()
    assert 'jpeg_decode.c' in cuda_build.host_sources()
    assert tnp4._native() is tnp4._native()


@pytest.mark.parametrize('dtype', ['float32', 'float16', 'uint8'])
@pytest.mark.parametrize('shape', SHAPES)
def test_blobs_are_mscl_tpus_bytes(dtype, shape):
    arr = _array(dtype, shape)
    ours = tnp4.np4_encode(arr)
    assert ours == jnp4.np4_encode(arr)
    assert tnp4.pack_np4_map(arr) == msgpack.packb(
        {'d': arr.tobytes(), 't': str(arr.dtype), 's': list(arr.shape)},
        use_bin_type=True)
    for blob in (ours, jnp4.np4_encode(arr)):
        for decode in (tnp4.np4_decode, jnp4.np4_decode):
            out = decode(blob)
            assert out.dtype == arr.dtype and out.shape == arr.shape
            assert out.tobytes() == arr.tobytes()


@pytest.mark.parametrize('n', [255, 256, 65535, 65536, 1 << 16 | 7])
def test_bin_and_array_widths(n):
    """bin8/16/32 data and array16 shapes, at their edges."""
    for arr in (np.zeros(n, np.uint8), np.zeros((1,) * 16 + (n // 8,),
                                                np.uint8)):
        blob = tnp4.pack_np4_map(arr)
        assert blob == msgpack.packb({'d': arr.tobytes(), 't': 'uint8',
                                      's': list(arr.shape)},
                                     use_bin_type=True)
        assert tnp4.unpack_np4_map(blob) == (arr.tobytes(), 'uint8',
                                             list(arr.shape))


def test_python_codec_where_there_is_no_compiler(monkeypatch):
    """Without a C++ compiler the port writes stored LZ4 blocks, which
    both packages read, and reads compressed ones in Python."""
    arr = _array('float32', (128, 171, 2))
    native = jnp4.np4_encode(arr)
    monkeypatch.setattr(tnp4, '_native', lambda: None)
    stored = tnp4.np4_encode(arr)
    assert stored != native and len(stored) > len(native)
    for blob in (stored, native):
        for decode in (tnp4.np4_decode, jnp4.np4_decode):
            assert decode(blob).tobytes() == arr.tobytes()


def _frame(payload):
    return jnp4.lz4_frame_compress(payload)


@pytest.mark.parametrize('writer', ['raw_str', 'byte_keys', 'wide_ints',
                                    'map16', 'extra_keys', 'str8_dtype'])
def test_reads_other_writers(writer):
    """msgpack without use_bin_type (the data as a raw str), byte keys,
    shape ints in uint16/32/64, a map16, keys it does not know."""
    arr = _array('float32', (6, 7))
    d, t, s = arr.tobytes(), 'float32', [6, 7]
    if writer == 'raw_str':
        payload = msgpack.packb({'d': d, 't': t, 's': s}, use_bin_type=False)
        assert payload[3] == 0xDA                   # str16: raw, not bin
    elif writer == 'byte_keys':
        payload = msgpack.packb({b'd': d, b't': t.encode(), b's': s},
                                use_bin_type=True)
    elif writer == 'wide_ints':
        arr = np.zeros((0, 70000, 1 << 33), np.float32)
        payload = msgpack.packb({'d': b'', 't': t, 's': list(arr.shape)},
                                use_bin_type=True)
        assert b'\xce' in payload and b'\xcf' in payload
    elif writer == 'map16':
        payload = b'\xde\x00\x03' + msgpack.packb(
            {'d': d, 't': t, 's': s}, use_bin_type=True)[1:]
    elif writer == 'extra_keys':
        payload = msgpack.packb({'v': [1.5, None, True, {'x': -3}], 'd': d,
                                 't': t, 's': s, 'n': -70000},
                                use_bin_type=True)
    else:
        payload = b'\x83\xa1d\xc5' + struct.pack('>H', len(d)) + d + \
            b'\xa1t\xd9\x07float32\xa1s\x92\x06\x07'
    out = tnp4.np4_decode(_frame(payload))
    assert out is not None and out.shape == arr.shape
    assert out.tobytes() == arr.tobytes()


@pytest.mark.parametrize('blob', [
    b'', b'not an np4 blob', b'\x04\x22\x4d\x18',
    'truncated', 'no_shape', 'shape_not_ints', 'data_not_bytes',
    'not_a_map', 'wrong_size'])
def test_what_is_not_a_blob_decodes_to_none(blob):
    good = jnp4.np4_encode(np.ones((4, 5), np.float32))
    payloads = {
        'no_shape': msgpack.packb({'d': b'\0' * 4, 't': 'float32'}),
        'shape_not_ints': msgpack.packb({'d': b'\0' * 4, 't': 'float32',
                                         's': ['a']}),
        'data_not_bytes': msgpack.packb({'d': 3, 't': 'float32', 's': [1]}),
        'not_a_map': msgpack.packb([1, 2, 3]),
        'wrong_size': msgpack.packb({'d': b'\0' * 6, 't': 'float32',
                                     's': [2]}, use_bin_type=True)}
    if blob == 'truncated':
        blob = good[:len(good) // 2]
    elif isinstance(blob, str):
        blob = _frame(payloads[blob])
    assert tnp4.np4_decode(blob) is None


def test_host_cpp_source_builds_once_into_the_ignored_build_dir(
        tmp_path, monkeypatch):
    """A csrc/<name>.cpp is compiled by the host C++ compiler into build/
    (which .gitignore lists) at its first load and reused after."""
    src = tmp_path / 'csrc'
    src.mkdir()
    (src / 'probe_cxx.cpp').write_text(
        '#include <cstdint>\nextern "C" int64_t answer() '
        '{ return static_cast<int64_t>(42); }\n')
    monkeypatch.setattr(cuda_build, 'CSRC', src)
    cuda_build._load_host.cache_clear()
    built = []
    real_run = subprocess.run

    def run(cmd, *args, **kwargs):
        built.append(cmd[0])
        return real_run(cmd, *args, **kwargs)
    monkeypatch.setattr(cuda_build.subprocess, 'run', run)
    try:
        assert cuda_build.host_sources() == ['probe_cxx.cpp']
        lib = cuda_build.load_host('probe_cxx')
        assert lib.answer() == 42 and len(built) == 1
        assert os.path.basename(built[0]) in ('c++', 'g++', 'clang++') or \
            built[0] == os.environ.get('CXX')
        out = [p for p in os.listdir(cuda_build.BUILD_DIR)
               if p.startswith('probe_cxx-') and p.endswith('.so')]
        assert len(out) == 1
        cuda_build._load_host.cache_clear()      # a new process, as it were
        assert cuda_build.load_host('probe_cxx').answer() == 42
        assert len(built) == 1                   # reused, not rebuilt
    finally:
        cuda_build._load_host.cache_clear()
        for p in os.listdir(cuda_build.BUILD_DIR):
            if p.startswith('probe_cxx-'):
                os.remove(os.path.join(cuda_build.BUILD_DIR, p))
    assert os.path.relpath(cuda_build.BUILD_DIR, ROOT) == 'build'
    with open(os.path.join(ROOT, '.gitignore')) as f:
        assert 'build/' in f.read().split()
