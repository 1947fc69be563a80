"""RAFT correlation lookup without the all-pairs volume.

Port of ``mscl_tpu/ops/corr_lookup.py`` (``corr_lookup_pallas_v2`` and
``corr_lookup_pallas``, which compute one function). For each query pixel
and pyramid level ``l`` it returns the (2r+1)^2 bilinear window (zero
padding, align_corners=True) at ``coords / 2^l`` of the correlation
``f1 . f2_l / sqrt(C)``, where ``f2_l`` is ``fmap2`` 2x2-mean-pooled ``l``
times (an odd last row or column is dropped). Correlation is linear in f2,
so this equals the lookup in the pooled all-pairs volume of
``flow/raft.py``'s ``'volume'`` path, without building that volume.

Layout at the boundary is the JAX one: NHWC fmaps, (x, y) pixel coords, and
output (N, H, W, L*(2r+1)^2) with levels outermost and taps dy-major.

On a CUDA tensor the lookup runs in the hand-written Hopper kernel of
``csrc/corr_lookup.cu`` (its source note gives what bounds it and how: one
block per tile of pixels, each level's window union staged once in shared
memory); on a CPU tensor it runs ``corr_lookup_plain``, which is also what
the kernel is checked against. ``plan`` and ``staged_positions`` count, on
the host, the kernel's launch and what it stages. A CUDA call never falls
back to the plain version: it launches the kernel or raises. There is no backward (RAFT's lookup sits
under a stop-gradient, and neither TPU kernel has one): the CUDA path refuses
operands that require a gradient.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Tuple

import torch

from . import cuda_build

MAX_C = 256           # widest f1 tile the kernel's shared memory holds
MAX_RADIUS = 8        # (2r+2)^2 corner sums a pixel in shared memory
MAX_LEVELS = 8
# the kernel's launch (csrc/corr_lookup.cu): a block of WARPS warps takes a
# TILE_H x TILE_W tile of one image; a warp stages 32 positions (one a
# lane) CHUNK channels at a time into its ring of STAGES slots
TILE_H, TILE_W = 2, 4
WARPS, CHUNK, STAGES = 8, 8, 4
LAUNCH_INFO_KEYS = ('smem_bytes', 'threads', 'blocks_per_sm', 'registers',
                    'tile_h', 'tile_w', 'stage_positions', 'chunk_channels',
                    'stages')
PLAIN_CHUNK_FLOATS = 2 ** 25   # gathered corner rows per plain-version chunk


class CorrPyramid(NamedTuple):
    """The pooled f2 levels, back to back in one buffer (what the kernel
    reads) and as (N, H>>l, W>>l, C) views of it (what the plain version
    reads). RAFT builds it once per forward and looks it up every
    iteration."""
    flat: torch.Tensor
    levels: Tuple[torch.Tensor, ...]


def level_dims(h: int, w: int, num_levels: int):
    """(h_l, w_l) of each level: each halves the one before, flooring."""
    return [(h >> l, w >> l) for l in range(num_levels)]


def corr_pyramid(fmap2: torch.Tensor, num_levels: int = 4) -> CorrPyramid:
    """fmap2 (N, H, W, C) -> its pyramid, in fmap2's dtype and device."""
    n, h, w, c = fmap2.shape
    dims = level_dims(h, w, num_levels)
    sizes = [n * hl * wl * c for hl, wl in dims]
    flat = torch.empty(sum(sizes), dtype=fmap2.dtype, device=fmap2.device)
    levels, off = [], 0
    for (hl, wl), size in zip(dims, sizes):
        lvl = flat[off:off + size].view(n, hl, wl, c)
        if not levels:
            lvl.copy_(fmap2)
        else:
            prev = levels[-1]
            lvl.copy_(prev[:, :2 * hl, :2 * wl].reshape(
                n, hl, 2, wl, 2, c).mean(dim=(2, 4)))
        levels.append(lvl)
        off += size
    return CorrPyramid(flat, tuple(levels))


def corr_lookup_plain(fmap1: torch.Tensor, levels, coords: torch.Tensor,
                      radius: int = 4) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch, in the inputs' dtype:
    gather the in-range integer corners of each window from the pooled f2,
    dot them with f1, and blend them bilinearly. Chunked over pixels so the
    gathered rows stay under ``PLAIN_CHUNK_FLOATS``."""
    n, h, w, c = fmap1.shape
    r, k, kc = radius, 2 * radius + 1, 2 * radius + 2
    f1 = fmap1.reshape(n * h * w, c)
    cds = coords.reshape(n * h * w, 2)
    dev = fmap1.device
    image = torch.arange(n, device=dev).repeat_interleave(h * w)
    offs = torch.arange(kc, device=dev)
    out = torch.zeros(n * h * w, len(levels), k * k, dtype=fmap1.dtype,
                      device=dev)
    chunk = max(1, PLAIN_CHUNK_FLOATS // (kc * kc * c))
    sqrt_c = math.sqrt(c)
    for l, f2 in enumerate(levels):
        hl, wl = f2.shape[1], f2.shape[2]
        if hl == 0 or wl == 0:
            continue
        rows = f2.reshape(n * hl * wl, c)
        cx, cy = cds[:, 0] / 2 ** l, cds[:, 1] / 2 ** l
        x0, y0 = torch.floor(cx), torch.floor(cy)
        fx, fy = cx - x0, cy - y0
        ix = x0.clamp(-65536, 65536).long() - r
        iy = y0.clamp(-65536, 65536).long() - r
        for s in range(0, n * h * w, chunk):
            sl = slice(s, s + chunk)
            ys, xs = iy[sl, None] + offs, ix[sl, None] + offs   # (P, kc)
            valid = (((ys >= 0) & (ys < hl))[:, :, None] &
                     ((xs >= 0) & (xs < wl))[:, None, :])
            idx = (image[sl, None, None] * (hl * wl) +
                   ys.clamp(0, hl - 1)[:, :, None] * wl +
                   xs.clamp(0, wl - 1)[:, None, :])
            p = idx.shape[0]
            gathered = rows[idx.reshape(-1)].view(p, kc * kc, c)
            corr = torch.bmm(gathered, f1[sl, :, None]).view(p, kc, kc)
            corr = torch.where(valid, corr / sqrt_c, torch.zeros_like(corr))
            wx, wy = fx[sl, None, None], fy[sl, None, None]
            win = ((1 - wy) * (1 - wx) * corr[:, :k, :k] +
                   (1 - wy) * wx * corr[:, :k, 1:] +
                   wy * (1 - wx) * corr[:, 1:, :k] +
                   wy * wx * corr[:, 1:, 1:])
            out[sl, l] = win.reshape(p, k * k)
    return out.view(n, h, w, len(levels) * k * k)


def _check(fmap1, pyramid, coords, num_levels, radius):
    """What the kernel takes: float32 contiguous operands on one device,
    f1 (N,H,W,C) with C % 4 == 0 and C <= MAX_C, coords (N,H,W,2), a
    pyramid of num_levels levels of f1's size, 0 <= radius <= MAX_RADIUS,
    and no operand that asks for a gradient."""
    if fmap1.dim() != 4:
        raise ValueError('corr_lookup: fmap1 must be (N, H, W, C)')
    n, h, w, c = fmap1.shape
    if n * h * w == 0:
        raise ValueError('corr_lookup: empty fmap1')
    if tuple(coords.shape) != (n, h, w, 2):
        raise ValueError(f'corr_lookup: coords {tuple(coords.shape)} != '
                         f'{(n, h, w, 2)}')
    if c % 4 or c > MAX_C:
        raise ValueError(f'corr_lookup: C={c} is not a multiple of 4 up to '
                         f'{MAX_C}')
    if not 0 <= radius <= MAX_RADIUS:
        raise ValueError(f'corr_lookup: radius {radius} not in '
                         f'[0, {MAX_RADIUS}]')
    if not 1 <= num_levels <= MAX_LEVELS:
        raise ValueError(f'corr_lookup: {num_levels} levels not in '
                         f'[1, {MAX_LEVELS}]')
    dims = level_dims(h, w, num_levels)
    if [tuple(v.shape) for v in pyramid.levels] != [
            (n, hl, wl, c) for hl, wl in dims]:
        raise ValueError('corr_lookup: the pyramid does not fit fmap1 and '
                         f'{num_levels} levels')
    if pyramid.flat.shape != (sum(n * hl * wl * c for hl, wl in dims),):
        raise ValueError('corr_lookup: the pyramid buffer has the wrong size')
    for t in (fmap1, pyramid.flat, coords):
        if t.dtype != torch.float32:
            raise TypeError(f'corr_lookup: float32 tensors only, got '
                            f'{t.dtype}')
        if not t.is_contiguous():
            raise ValueError('corr_lookup: tensors must be contiguous')
        if t.device != fmap1.device:
            raise ValueError(f'corr_lookup: operands on {t.device} and '
                             f'{fmap1.device}')
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (fmap1, pyramid.flat, coords)):
        raise ValueError('corr_lookup has no backward on the card: call it '
                         'under torch.no_grad() or on detached tensors')


def plan(n: int, h: int, w: int, c: int, radius: int) -> dict:
    """The kernel's launch for f1 (n, h, w, c) at this radius, as its source
    sizes it: tile, threads, what a warp stages at once, ring, dynamic
    shared memory (the rings, the tile's f1 rows padded to whole chunks,
    its corner sums) and blocks."""
    kc = 2 * radius + 2
    pixels = TILE_H * TILE_W
    smem = 4 * (WARPS * STAGES * 32 * CHUNK + pixels * -(-c // CHUNK) *
                CHUNK + pixels * kc * kc)
    return dict(tile_h=TILE_H, tile_w=TILE_W, threads=32 * WARPS,
                stage_positions=32, chunk_channels=CHUNK, stages=STAGES,
                smem_bytes=smem, blocks=n * -(-h // TILE_H) * -(-w // TILE_W))


def staged_positions(coords: torch.Tensor, num_levels: int,
                     radius: int) -> Tuple[int, int]:
    """(staged, boxed): the f2 positions the kernel copies into shared
    memory for these coords (N, H, W, 2), summed over its tiles and levels,
    each a row of C floats read once from L2: the positions of a tile's
    union box that lie in one of its pixels' in-range windows; and all the
    union boxes' positions. Counted with the kernel's tile plan."""
    n, h, w, _ = coords.shape
    tiles_y, tiles_x = -(-h // TILE_H), -(-w // TILE_W)
    dev = coords.device
    ys, xs = torch.meshgrid(torch.arange(h, device=dev),
                            torch.arange(w, device=dev), indexing='ij')
    tile = ((torch.arange(n, device=dev)[:, None, None] * tiles_y +
             ys // TILE_H) * tiles_x + xs // TILE_W).reshape(-1)
    tiles = n * tiles_y * tiles_x
    kc, staged, boxed = 2 * radius + 2, 0, 0
    for l in range(num_levels):
        hl, wl = h >> l, w >> l
        if hl == 0 or wl == 0:
            continue
        start = (torch.floor(coords.reshape(-1, 2).double() / 2 ** l)
                 .clamp(-65536, 65536).long() - radius)
        x0, y0 = start[:, 0].clamp(min=0), start[:, 1].clamp(min=0)
        x1 = (start[:, 0] + kc).clamp(max=wl)
        y1 = (start[:, 1] + kc).clamp(max=hl)
        ok = (x0 < x1) & (y0 < y1)
        t, x0, x1, y0, y1 = (v[ok] for v in (tile, x0, x1, y0, y1))
        # the union of each tile's rects: a 2-D difference array, summed
        diff = torch.zeros(tiles, hl + 1, wl + 1, dtype=torch.int32,
                           device=dev)
        one = torch.ones_like(t, dtype=torch.int32)
        for yy, xx, sign in ((y0, x0, 1), (y0, x1, -1), (y1, x0, -1),
                             (y1, x1, 1)):
            diff.index_put_((t, yy, xx), sign * one, accumulate=True)
        cover = diff.cumsum(1).cumsum(2)[:, :hl, :wl] > 0
        staged += int(cover.sum().item())
        lo = torch.full((tiles, 2), 1 << 30, dtype=torch.long, device=dev)
        hi = torch.zeros((tiles, 2), dtype=torch.long, device=dev)
        lo.scatter_reduce_(0, t[:, None].expand(-1, 2),
                           torch.stack([x0, y0], 1), 'amin')
        hi.scatter_reduce_(0, t[:, None].expand(-1, 2),
                           torch.stack([x1, y1], 1), 'amax')
        size = (hi - lo).clamp(min=0)
        boxed += int((size[:, 0] * size[:, 1]).sum().item())
    return staged, boxed


def _on_cuda(t: torch.Tensor) -> bool:
    return t.is_cuda


def _stream(device):
    """PyTorch's current stream on device, as the raw handle."""
    return torch._C._cuda_getCurrentRawStream(device.index)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = cuda_build.load('corr_lookup')
    i, p = ctypes.c_int, ctypes.c_void_p
    lib.corr_lookup.argtypes = [p, p, p, p, i, i, i, i, i, i, p]
    lib.corr_lookup.restype = i
    lib.corr_lookup_launch_info.argtypes = [i, i, p]
    lib.corr_lookup_launch_info.restype = i
    return lib


def launch_info(c: int, radius: int) -> dict:
    """The kernel's launch at width c and this radius on the current CUDA
    device, as its library reports it: ``LAUNCH_INFO_KEYS``."""
    vals = (ctypes.c_int * len(LAUNCH_INFO_KEYS))()
    err = _lib().corr_lookup_launch_info(c, radius, vals)
    if err != 0:
        raise RuntimeError(f'corr_lookup_launch_info failed with error {err}')
    return dict(zip(LAUNCH_INFO_KEYS, vals))


def corr_lookup(fmap1: torch.Tensor, fmap2, coords: torch.Tensor,
                num_levels: int = 4, radius: int = 4) -> torch.Tensor:
    """fmap1 (N,H,W,C); fmap2 (N,H,W,C) or its ``corr_pyramid``; coords
    (N,H,W,2) level-0 (x, y) -> (N,H,W,num_levels*(2r+1)^2).
    Kernel on CUDA, plain on CPU."""
    pyramid = fmap2 if isinstance(fmap2, CorrPyramid) else \
        corr_pyramid(fmap2, num_levels)
    if not _on_cuda(fmap1):
        if len(pyramid.levels) != num_levels:
            raise ValueError('corr_lookup: the pyramid has '
                             f'{len(pyramid.levels)} levels, not {num_levels}')
        return corr_lookup_plain(fmap1, pyramid.levels, coords, radius)
    _check(fmap1, pyramid, coords, num_levels, radius)
    n, h, w, c = fmap1.shape
    k2 = (2 * radius + 1) ** 2
    out = torch.empty((n, h, w, num_levels * k2), device=fmap1.device,
                      dtype=torch.float32)
    err = _lib().corr_lookup(
        fmap1.data_ptr(), pyramid.flat.data_ptr(), coords.data_ptr(),
        out.data_ptr(), n, h, w, c, num_levels, radius,
        _stream(fmap1.device))
    if err != 0:
        raise RuntimeError(f'corr_lookup: CUDA launch failed with error {err}')
    corr_lookup.launches += 1
    return out


# kernel launches made by the wrapper (the chip check reads and resets it)
corr_lookup.launches = 0
