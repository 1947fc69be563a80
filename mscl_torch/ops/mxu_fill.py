"""Matrix-unit fill probes, rebuilt on Hopper's tensor cores.

Port of the five Pallas probes of ``tools/analysis/bench_mxu_fill.py``,
which measured how fast hand-written matrix-unit code runs at r3d_18
layer1's implicit-GEMM geometry under each way of accumulating across the
27 taps. Write ``S(o)`` for ``x[o:o+m]``; operands are bf16, products sum in
float32, and the (m, n) bf16 output is rounded once:

- ``probe`` (``make_probe``) and ``probe_carry`` (``make_probe_carry``,
  per mt-row tile): ``sum_{i<inner} S((i%2)*8) @ w[i]``;
- ``probe_bigdot`` (``make_probe_bigdot``): ``x @ w``;
- ``probe_paircat`` (``make_probe_paircat``):
  ``sum_{j<inner/2} [S((j%2)*8) | S(((j+1)%2)*8)] @ w[j]``;
- ``probe_imcat`` (``make_probe_imcat``): ``X_cat @ w``, with column blocks
  ``2j`` and ``2j+1`` of ``X_cat`` the two halves of paircat's pair ``j``.

Each entry point takes ``(x, w)`` and the JAX function's shape parameters,
``steps`` included: the TPU grid runs the same pass ``steps`` times and so
does the kernel, so ``steps`` multiplies the work, not the result. On a CUDA
tensor each launches its hand-written kernel of ``csrc/mxu_fill.cu`` (whose
source note gives what bounds the kernels and how each keeps its probe's
accumulation structure); on a CPU tensor it runs its plain version below,
which is also what the kernel is held to on the card. A CUDA call never falls
back to the plain version: it launches the kernel or raises.

No weights cross between the packages: the probes have none, and
``convert.py`` has nothing to convert for them.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_build

HALO = 8                 # rows of x past m that the offset taps read
NS = (64, 128)           # output widths the kernels are built for
MAX_TAP_DEPTH = 256      # K (paircat 2K) of one tap staged in shared memory
MAX_MT = 2048            # carry: at most 4 m16 fragments for each of 32 warps
MAX_KCAT = 2048          # imcat: inner*K columns of a 32-row patch slab
KCAT_CHUNK = 64          # bigdot and imcat: depth of a staged w chunk
TILE_ROWS = {'probe': 64, 'paircat': 64, 'bigdot': 64, 'imcat': 32}


def _window(x, off, m):
    return x[off:off + m]


def _pair(x, j, m):
    """Paircat's pair j: S((j%2)*8) and S(((j+1)%2)*8)."""
    return (_window(x, (j % 2) * HALO, m),
            _window(x, ((j + 1) % 2) * HALO, m))


def _probe_sum(x, w, m, inner):
    acc = torch.zeros((m, w.shape[-1]), dtype=x.dtype, device=x.device)
    for i in range(inner):
        acc += _window(x, (i % 2) * HALO, m) @ w[i]
    return acc


def _carry_sum(x, w, m, mt, inner):
    out = torch.empty((m, w.shape[-1]), dtype=x.dtype, device=x.device)
    for base in range(0, m, mt):
        acc = torch.zeros((mt, w.shape[-1]), dtype=x.dtype, device=x.device)
        for i in range(inner):
            acc = acc + _window(x, base + (i % 2) * HALO, mt) @ w[i]
        out[base:base + mt] = acc
    return out


def _bigdot_sum(x, w):
    return x @ w


def _imcat_sum(x, w, m, inner):
    blocks = [b for j in range(inner // 2) for b in _pair(x, j, m)]
    return torch.cat(blocks, dim=1) @ w


def _paircat_sum(x, w, m, inner):
    acc = torch.zeros((m, w.shape[-1]), dtype=x.dtype, device=x.device)
    for j in range(inner // 2):
        acc += torch.cat(_pair(x, j, m), dim=1) @ w[j]
    return acc


def _sum(kind, x, w, m, k, n, inner=None, mt=None):
    if kind == 'probe':
        return _probe_sum(x, w, m, inner)
    if kind == 'carry':
        return _carry_sum(x, w, m, mt, inner)
    if kind == 'bigdot':
        return _bigdot_sum(x, w)
    if kind == 'imcat':
        return _imcat_sum(x, w, m, inner)
    return _paircat_sum(x, w, m, inner)


def _shapes(kind, m, k, n, inner=None, mt=None):
    """x and w shapes of a probe; raises on what the JAX function asserts
    (carry: m % mt; imcat and paircat: an even inner; imcat: k a multiple
    of 64, through ``pl.multiple_of(j * 2 * k, 128)``)."""
    if m < 1 or k < 1 or n < 1 or (inner is not None and inner < 1):
        raise ValueError(f'{kind}: m, k, n and inner must be positive')
    if kind == 'carry' and (mt < 1 or m % mt):
        raise ValueError(f'carry: m={m} is not a multiple of mt={mt}')
    if kind in ('imcat', 'paircat') and inner % 2:
        raise ValueError(f'{kind}: inner={inner} is odd (pad the taps to '
                         'even)')
    if kind == 'imcat' and k % 64:
        raise ValueError(f'imcat: k={k} is not a multiple of 64')
    if kind == 'bigdot':
        return (m, k), (k, n)
    w = {'probe': (inner, k, n), 'carry': (inner, k, n),
         'imcat': (inner * k, n), 'paircat': (inner // 2, 2 * k, n)}[kind]
    return (m + HALO, k), w


def _check_shapes(kind, x, w, m, k, n, inner=None, mt=None, steps=1):
    want_x, want_w = _shapes(kind, m, k, n, inner, mt)
    if tuple(x.shape) != want_x or tuple(w.shape) != want_w:
        raise ValueError(f'{kind}: x {tuple(x.shape)} and w '
                         f'{tuple(w.shape)}, expected {want_x} and {want_w}')
    if steps < 1:
        raise ValueError(f'{kind}: steps={steps} < 1')


def _check_kernel(kind, x, w, m, k, n, inner=None, mt=None, steps=1):
    """What the kernels take, beyond the JAX shapes: bf16 contiguous operands
    on one device at 16-byte aligned addresses, n of 64 or 128, and the
    depths and tiles that fit a block's shared memory and registers."""
    _check_shapes(kind, x, w, m, k, n, inner, mt, steps)
    for t in (x, w):
        if t.dtype != torch.bfloat16:
            raise TypeError(f'{kind}: bfloat16 tensors only, got {t.dtype}')
        if not t.is_contiguous():
            raise ValueError(f'{kind}: tensors must be contiguous')
        if t.device != x.device:
            raise ValueError(f'{kind}: operands on {t.device} and {x.device}')
        if t.data_ptr() % 16:
            raise ValueError(f'{kind}: operands must be 16-byte aligned')
    if n not in NS:
        raise ValueError(f'{kind}: n={n} is not one of {NS}')
    depth = 2 * k if kind == 'paircat' else k
    if kind != 'bigdot' and (k % 16 or depth > MAX_TAP_DEPTH):
        raise ValueError(f'{kind}: tap depth {depth} is not a multiple of 16 '
                         f'up to {MAX_TAP_DEPTH}')
    if kind == 'carry' and mt > MAX_MT:
        raise ValueError(f'carry: mt={mt} > {MAX_MT}')
    if kind == 'bigdot' and k % KCAT_CHUNK:
        raise ValueError(f'bigdot: k={k} is not a multiple of {KCAT_CHUNK}')
    if kind == 'imcat' and inner * k > MAX_KCAT:
        raise ValueError(f'imcat: inner*k={inner * k} > {MAX_KCAT}')
    tiles = m // mt if kind == 'carry' else -(-m // TILE_ROWS[kind])
    if tiles * steps > 2 ** 31 - 1:
        raise ValueError(f'{kind}: {tiles} tiles x {steps} steps is more '
                         'blocks than one launch takes')


def _plain(kind, x, w, steps, **shape):
    _check_shapes(kind, x, w, steps=steps, **shape)
    xf, wf = x.float(), w.float()
    for _ in range(steps):
        acc = _sum(kind, xf, wf, **shape)
    return acc.to(torch.bfloat16)


def probe_plain(x, w, m, k, n, inner, steps=1):
    return _plain('probe', x, w, steps, m=m, k=k, n=n, inner=inner)


def probe_carry_plain(x, w, m, mt, k, n, inner, steps=1):
    return _plain('carry', x, w, steps, m=m, k=k, n=n, inner=inner, mt=mt)


def probe_bigdot_plain(x, w, m, k, n, steps=1):
    return _plain('bigdot', x, w, steps, m=m, k=k, n=n)


def probe_imcat_plain(x, w, m, k, n, inner, steps=1):
    return _plain('imcat', x, w, steps, m=m, k=k, n=n, inner=inner)


def probe_paircat_plain(x, w, m, k, n, inner, steps=1):
    return _plain('paircat', x, w, steps, m=m, k=k, n=n, inner=inner)


def reference(kind, x, w, **shape):
    """One pass of a probe's sum in float64, not rounded: the yardstick that
    the kernel and the plain version are both held to on the card."""
    _check_shapes(kind, x, w, **shape)
    return _sum(kind, x.double(), w.double(), **shape)


def _on_cuda(t: torch.Tensor) -> bool:
    return t.is_cuda


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _stream(t):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = cuda_build.load('mxu_fill')
    i, p = ctypes.c_int, ctypes.c_void_p
    lib.mxu_fill_tap.argtypes = [p, p, p, i, i, i, i, i, i, p]
    lib.mxu_fill_carry.argtypes = [p, p, p, i, i, i, i, i, i, p]
    lib.mxu_fill_kcat.argtypes = [p, p, p, i, i, i, i, i, i, p]
    for fn in (lib.mxu_fill_tap, lib.mxu_fill_carry, lib.mxu_fill_kcat):
        fn.restype = i
    return lib


def _out(x, m, n):
    return torch.empty((m, n), dtype=torch.bfloat16, device=x.device)


def _raise_on(err, what):
    if err != 0:
        raise RuntimeError(f'{what}: CUDA launch failed with error {err}')


def probe(x, w, m, k, n, inner, steps=1):
    """``make_probe(m, k, n, inner, steps)(x, w)``: x (m+8, k), w (inner, k,
    n) -> (m, n), f32 accumulator in shared memory read-modify-written each
    tap. Kernel on CUDA, plain on CPU."""
    if not _on_cuda(x):
        return probe_plain(x, w, m, k, n, inner, steps)
    _check_kernel('probe', x, w, m, k, n, inner, steps=steps)
    out = _out(x, m, n)
    _raise_on(_lib().mxu_fill_tap(_ptr(x), _ptr(w), _ptr(out), m, k, n,
                                  inner, 0, steps, _stream(x)), 'probe')
    probe.launches += 1
    return out


def probe_carry(x, w, m, mt, k, n, inner, steps=1):
    """``make_probe_carry(m, mt, k, n, inner, steps)(x, w)``: the probe's
    function, with each mt-row tile's accumulator in registers across all
    taps. Kernel on CUDA, plain on CPU."""
    if not _on_cuda(x):
        return probe_carry_plain(x, w, m, mt, k, n, inner, steps)
    _check_kernel('carry', x, w, m, k, n, inner, mt, steps)
    out = _out(x, m, n)
    _raise_on(_lib().mxu_fill_carry(_ptr(x), _ptr(w), _ptr(out), m, mt, k, n,
                                    inner, steps, _stream(x)), 'probe_carry')
    probe_carry.launches += 1
    return out


def probe_bigdot(x, w, m, k, n, steps=1):
    """``make_probe_bigdot(m, k, n, steps)(x, w)``: x (m, k) @ w (k, n), one
    GEMM with register accumulators. Kernel on CUDA, plain on CPU."""
    if not _on_cuda(x):
        return probe_bigdot_plain(x, w, m, k, n, steps)
    _check_kernel('bigdot', x, w, m, k, n, steps=steps)
    out = _out(x, m, n)
    _raise_on(_lib().mxu_fill_kcat(_ptr(x), _ptr(w), _ptr(out), m, k, n, 1,
                                   0, steps, _stream(x)), 'probe_bigdot')
    probe_bigdot.launches += 1
    return out


def probe_imcat(x, w, m, k, n, inner, steps=1):
    """``make_probe_imcat(m, k, n, inner, steps)(x, w)``: x (m+8, k), w
    (inner*k, n); the K-concatenated patch slab is built on chip, then one
    GEMM. Kernel on CUDA, plain on CPU."""
    if not _on_cuda(x):
        return probe_imcat_plain(x, w, m, k, n, inner, steps)
    _check_kernel('imcat', x, w, m, k, n, inner, steps=steps)
    out = _out(x, m, n)
    _raise_on(_lib().mxu_fill_kcat(_ptr(x), _ptr(w), _ptr(out), m, k, n,
                                   inner, 1, steps, _stream(x)),
              'probe_imcat')
    probe_imcat.launches += 1
    return out


def probe_paircat(x, w, m, k, n, inner, steps=1):
    """``make_probe_paircat(m, k, n, inner, steps)(x, w)``: x (m+8, k), w
    (inner/2, 2k, n), one (m, 2k) product a pair, f32 accumulator in shared
    memory. Kernel on CUDA, plain on CPU."""
    if not _on_cuda(x):
        return probe_paircat_plain(x, w, m, k, n, inner, steps)
    _check_kernel('paircat', x, w, m, k, n, inner, steps=steps)
    out = _out(x, m, n)
    _raise_on(_lib().mxu_fill_tap(_ptr(x), _ptr(w), _ptr(out), m, k, n,
                                  inner, 1, steps, _stream(x)),
              'probe_paircat')
    probe_paircat.launches += 1
    return out


# kernel launches made by each wrapper (the chip check reads and resets them)
probe.launches = 0
probe_carry.launches = 0
probe_bigdot.launches = 0
probe_imcat.launches = 0
probe_paircat.launches = 0
ENTRY_POINTS = {'probe': probe, 'carry': probe_carry, 'bigdot': probe_bigdot,
                'imcat': probe_imcat, 'paircat': probe_paircat}
PLAIN_VERSIONS = {'probe': probe_plain, 'carry': probe_carry_plain,
                  'bigdot': probe_bigdot_plain, 'imcat': probe_imcat_plain,
                  'paircat': probe_paircat_plain}
