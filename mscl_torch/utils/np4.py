"""np4 flow blobs: an LZ4 frame around msgpack of {d: raw bytes, t: dtype
string, s: shape}.

The port's own copy of the format of ``mscl_tpu/utils/np4.py`` (the
reference's ``mmaction/utils/data_transform.py`` reader and
``flow_extraction_meg.py`` writer), in pure Python: the writer stores
uncompressed LZ4 blocks, which every LZ4-frame reader takes; the reader
decodes compressed and uncompressed blocks. ``msgpack`` is imported where a
blob is packed or unpacked, not with the module.
"""
from __future__ import annotations

import struct
from typing import Optional

import numpy as np

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


def lz4_frame_decompress(buf: bytes) -> bytes:
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


def lz4_frame_compress(data: bytes) -> bytes:
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


def np4_encode(arr: np.ndarray) -> bytes:
    import msgpack
    return lz4_frame_compress(msgpack.packb(
        {'d': arr.tobytes(), 't': str(arr.dtype), 's': list(arr.shape)},
        use_bin_type=True))


def np4_decode(buf: bytes) -> Optional[np.ndarray]:
    """np4 blob -> ndarray; None if it is not one."""
    import msgpack
    try:
        p = msgpack.unpackb(lz4_frame_decompress(buf), raw=False,
                            strict_map_key=False)
        d, t, s = (p[k] if k in p else p[k.encode()] for k in 'dts')
    except Exception:
        return None
    return np.frombuffer(d, dtype=t).reshape(s)
