"""np4 flow blobs: an LZ4 frame around msgpack of {d: raw bytes, t: dtype
string, s: shape}.

The port's own copy of the format of ``mscl_tpu/utils/np4.py`` (the
reference's ``mmaction/utils/data_transform.py`` reader and
``flow_extraction_meg.py`` writer), without the ``msgpack`` package:

- the LZ4 frame: ``csrc/lz4codec.cpp`` (a copy of ``native/lz4codec.cpp``),
  built with the host C++ compiler at first use and bound by ctypes, so the
  blobs are the bytes ``mscl_tpu.utils.np4.np4_encode`` writes with its
  native codec. On a machine without a C++ compiler the pure-Python codec
  below stands in: its writer stores uncompressed LZ4 blocks, which every
  LZ4-frame reader takes; its reader decodes both kinds of block.
- the map: written as ``msgpack.packb(..., use_bin_type=True)`` writes it
  (fixmap, fixstr keys, bin8/16/32 data, fixstr/str8 dtype, fixarray or
  array16 of the smallest unsigned ints); read from any writer: str or
  bin keys, the data as bin or as a raw str (``use_bin_type=False``), map16
  and map32, every int width. Anything else decodes to None.
"""
from __future__ import annotations

import ctypes
import struct
from typing import Optional

import numpy as np

from ..ops import cuda_build

_MAGIC = 0x184D2204
_BLOCK = 4 << 20          # the frame descriptor's block maximum (4 MB)


def _block_decompress(src: bytes, out: bytearray) -> None:
    ip, n = 0, len(src)
    while ip < n:
        token = src[ip]
        ip += 1
        lit_len = token >> 4
        if lit_len == 15:
            while True:
                s = src[ip]
                ip += 1
                lit_len += s
                if s != 255:
                    break
        out += src[ip:ip + lit_len]
        ip += lit_len
        if ip >= n:
            break
        offset = src[ip] | (src[ip + 1] << 8)
        ip += 2
        match_len = token & 0x0F
        if match_len == 15:
            while True:
                s = src[ip]
                ip += 1
                match_len += s
                if s != 255:
                    break
        match_len += 4
        start = len(out) - offset
        if offset >= match_len:
            out += out[start:start + match_len]
        else:
            for i in range(match_len):
                out.append(out[start + i])


def _py_frame_decompress(buf: bytes) -> bytes:
    if len(buf) < 7 or struct.unpack('<I', buf[:4])[0] != _MAGIC:
        raise ValueError('not an LZ4 frame')
    flg = buf[4]
    if (flg >> 6) != 1:
        raise ValueError('unsupported LZ4 frame version')
    ip = 6                                  # magic, FLG, BD
    block_checksum = (flg >> 4) & 1
    if (flg >> 3) & 1:                      # content size
        ip += 8
    if flg & 1:                             # dictionary id
        ip += 4
    ip += 1                                 # header checksum
    out = bytearray()
    while True:
        block_size = struct.unpack('<I', buf[ip:ip + 4])[0]
        ip += 4
        if block_size == 0:
            break
        uncompressed = block_size >> 31
        block_size &= 0x7FFFFFFF
        block = buf[ip:ip + block_size]
        ip += block_size
        if uncompressed:
            out += block
        else:
            _block_decompress(block, out)
        if block_checksum:
            ip += 4
    return bytes(out)


def _xxh32(data: bytes, seed: int = 0) -> int:
    """xxHash32, for the frame header checksum (data shorter than 16
    bytes, as a header is)."""
    p1, p2, p3, p4, p5 = (2654435761, 2246822519, 3266489917, 668265263,
                          374761393)
    mask = 0xFFFFFFFF

    def rotl(x, r):
        return ((x << r) | (x >> (32 - r))) & mask

    if len(data) >= 16:
        raise ValueError('_xxh32 hashes frame headers only')
    h = (seed + p5 + len(data)) & mask
    i = 0
    while i + 4 <= len(data):
        (lane,) = struct.unpack_from('<I', data, i)
        h = (rotl((h + lane * p3) & mask, 17) * p4) & mask
        i += 4
    while i < len(data):
        h = (rotl((h + data[i] * p5) & mask, 11) * p1) & mask
        i += 1
    h ^= h >> 15
    h = (h * p2) & mask
    h ^= h >> 13
    h = (h * p3) & mask
    h ^= h >> 16
    return h


def _py_frame_compress(data: bytes) -> bytes:
    """A valid LZ4 frame of uncompressed blocks, with the content size."""
    header = bytes([(1 << 6) | (1 << 5) | (1 << 3), 7 << 4]) + \
        struct.pack('<Q', len(data))
    out = bytearray(struct.pack('<I', _MAGIC) + header +
                    bytes([(_xxh32(header) >> 8) & 0xFF]))
    for off in range(0, len(data), _BLOCK):
        chunk = data[off:off + _BLOCK]
        out += struct.pack('<I', len(chunk) | 0x80000000) + chunk
    out += struct.pack('<I', 0)
    return bytes(out)


def _native():
    """``csrc/lz4codec.cpp`` loaded, or None without a C++ compiler."""
    lib = cuda_build.load_host('lz4codec')
    if lib is not None and lib.lz4f_compress.argtypes is None:
        lib.lz4f_decompress.restype = ctypes.c_int64
        lib.lz4f_decompress.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                        ctypes.c_void_p, ctypes.c_size_t]
        lib.lz4f_compress.restype = ctypes.c_int64
        lib.lz4f_compress.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                      ctypes.c_void_p, ctypes.c_size_t]
        lib.lz4f_compress_bound.restype = ctypes.c_size_t
        lib.lz4f_compress_bound.argtypes = [ctypes.c_size_t]
    return lib


def frame_compress(data: bytes) -> bytes:
    """An LZ4 frame of ``data``: the native codec's compressed blocks, or
    the pure-Python writer's stored ones."""
    lib = _native()
    if lib is None:
        return _py_frame_compress(data)
    cap = lib.lz4f_compress_bound(len(data))
    out = ctypes.create_string_buffer(int(cap))
    n = lib.lz4f_compress(data, len(data), out, cap)
    if n < 0:
        raise RuntimeError('lz4f_compress failed')
    return out.raw[:n]


def frame_decompress(buf: bytes) -> bytes:
    """An LZ4 frame's content, by the native codec where it is built."""
    lib = _native()
    if lib is None or len(buf) < 7:
        return _py_frame_decompress(buf)
    # the content size, where the frame carries it, sizes the output
    if (buf[4] >> 3) & 1 and len(buf) >= 14:
        cap = struct.unpack('<Q', buf[6:14])[0]
    else:
        cap = max(len(buf) * 64, 1 << 20)
    out = ctypes.create_string_buffer(max(int(cap), 1))
    n = lib.lz4f_decompress(buf, len(buf), out, len(out))
    if n < 0:
        raise ValueError('corrupt LZ4 frame')
    return out.raw[:n]


def _pack_uint(v: int) -> bytes:
    if v < 0x80:
        return bytes([v])
    for tag, fmt, top in ((0xCC, '>B', 1 << 8), (0xCD, '>H', 1 << 16),
                          (0xCE, '>I', 1 << 32), (0xCF, '>Q', 1 << 64)):
        if v < top:
            return bytes([tag]) + struct.pack(fmt, v)
    raise ValueError(f'{v} does not fit msgpack\'s uint64')


def _pack_len(n: int, fix: int, fix_max: int, tags) -> bytes:
    """A msgpack length header: fix | n where it fits, else the tag of the
    smallest of 8-, 16- and 32-bit lengths (``tags``, None where the type
    has no such form)."""
    if fix is not None and n <= fix_max:
        return bytes([fix | n])
    for tag, fmt, top in zip(tags, ('>B', '>H', '>I'),
                             (1 << 8, 1 << 16, 1 << 32)):
        if tag is not None and n < top:
            return bytes([tag]) + struct.pack(fmt, n)
    raise ValueError('too long for msgpack')


def _pack_str(s: str) -> bytes:
    b = s.encode()
    return _pack_len(len(b), 0xA0, 31, (0xD9, 0xDA, 0xDB)) + b


def pack_np4_map(arr: np.ndarray) -> bytes:
    """``msgpack.packb({'d': arr.tobytes(), 't': str(arr.dtype), 's':
    list(arr.shape)}, use_bin_type=True)``, byte for byte."""
    data = arr.tobytes()
    return b''.join([
        b'\x83',
        _pack_str('d'), _pack_len(len(data), None, 0, (0xC4, 0xC5, 0xC6)),
        data,
        _pack_str('t'), _pack_str(str(arr.dtype)),
        _pack_str('s'), _pack_len(arr.ndim, 0x90, 15, (None, 0xDC, 0xDD)),
        *(_pack_uint(int(n)) for n in arr.shape)])


class _Reader:
    """Just enough of a msgpack reader for the np4 map and keys beside it:
    every type but the extension types, strs and bins both as bytes."""

    _FIXED = {0xCC: '>B', 0xCD: '>H', 0xCE: '>I', 0xCF: '>Q', 0xD0: '>b',
              0xD1: '>h', 0xD2: '>i', 0xD3: '>q', 0xCA: '>f', 0xCB: '>d'}
    _RAW = {0xC4: '>B', 0xC5: '>H', 0xC6: '>I', 0xD9: '>B', 0xDA: '>H',
            0xDB: '>I'}

    def __init__(self, buf: bytes):
        self.buf, self.pos = buf, 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.buf):
            raise ValueError('truncated msgpack')
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        tag = self.take(1)[0]
        if tag < 0x80 or tag >= 0xE0:                   # fixints
            return tag if tag < 0x80 else tag - 0x100
        if tag <= 0x8F:
            return self.map(tag & 0x0F)
        if tag <= 0x9F:
            return [self.value() for _ in range(tag & 0x0F)]
        if tag <= 0xBF:
            return self.take(tag & 0x1F)
        if tag in (0xC0, 0xC2, 0xC3):
            return (None, None, False, True)[tag - 0xC0]
        if tag in self._FIXED:
            return self.unpack(self._FIXED[tag])
        if tag in self._RAW:
            return self.take(self.unpack(self._RAW[tag]))
        if tag in (0xDC, 0xDD):
            n = self.unpack('>H' if tag == 0xDC else '>I')
            return [self.value() for _ in range(n)]
        if tag in (0xDE, 0xDF):
            return self.map(self.unpack('>H' if tag == 0xDE else '>I'))
        raise ValueError(f'msgpack type 0x{tag:02x}')

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key.decode() if isinstance(key, bytes) else key] = \
                self.value()
        return out


def unpack_np4_map(buf: bytes):
    """The np4 map -> (data bytes, dtype string, shape list)."""
    p = _Reader(buf).value()
    d, t, s = p['d'], p['t'], p['s']
    if not isinstance(d, bytes) or not isinstance(s, list) or \
            not all(isinstance(n, int) for n in s):
        raise ValueError('not an np4 map')
    return d, t.decode() if isinstance(t, bytes) else t, s


def np4_encode(arr: np.ndarray) -> bytes:
    return frame_compress(pack_np4_map(arr))


def np4_decode(buf: bytes) -> Optional[np.ndarray]:
    """np4 blob -> ndarray; None if it is not one."""
    try:
        d, t, s = unpack_np4_map(frame_decompress(buf))
        return np.frombuffer(d, dtype=t).reshape(s)
    except Exception:
        return None
