"""Build the hand-written CUDA kernels under ``mscl_torch/csrc`` and load them.

Each ``csrc/<name>.cu`` exposes a plain C interface. It is compiled by
``nvcc`` for ``sm_90a`` into ``build/<name>-<hash>.so`` at the root of the
checkout (the hash is of the source, so an edited source rebuilds) and
loaded with ``ctypes``; ptxas's report of each kernel's registers, shared
memory and spills goes to ``build/<name>-<hash>.log``. Host helpers,
``csrc/<name>.c`` and ``csrc/<name>.cpp``, are compiled the same way by the
host C or C++ compiler (``load_host``). Nothing is compiled or loaded at
import time.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent.parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')
CC_FLAGS = ('-std=c99', '-O3', '-shared', '-fPIC')
CXX_FLAGS = ('-std=c++17', '-O3', '-shared', '-fPIC')
_HOST_LOCK = threading.Lock()


def nvcc() -> str:
    path = shutil.which('nvcc') or '/usr/local/cuda/bin/nvcc'
    if not os.path.exists(path):
        raise RuntimeError('nvcc not found: the CUDA kernels of mscl_torch '
                           'need the CUDA toolkit')
    return path


def library_path(name: str) -> Path:
    digest = hashlib.sha1((CSRC / f'{name}.cu').read_bytes()).hexdigest()
    return BUILD_DIR / f'{name}-{digest[:12]}.so'


def build(names: Iterable[str]) -> Dict[str, Path]:
    """Compile the named sources that are not built yet, one nvcc process
    each, all started together."""
    names = list(names)
    jobs = []
    try:
        for name in names:
            out = library_path(name)
            if out.exists():
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f'.{os.getpid()}.tmp')
            cmd = [nvcc(), *NVCC_FLAGS, '-o', str(tmp),
                   str(CSRC / f'{name}.cu')]
            jobs.append((subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True), tmp, out))
        for proc, tmp, out in jobs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f'nvcc failed for {out.name}:\n{log}')
            out.with_suffix('.log').write_text(log)
            os.replace(tmp, out)
    finally:
        for proc, _, _ in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return {n: library_path(n) for n in names}


def ptxas_report(name: str) -> Dict[str, dict]:
    """Registers, static shared memory, stack frame and spill bytes of each
    kernel of a built source, by mangled name, from its ptxas log (empty if
    the library was built without one), and ``wgmma_serialized``, ptxas's
    reason, where it serialized the kernel's wgmma."""
    log = library_path(name).with_suffix('.log')
    text = log.read_text() if log.exists() else ''
    report = {}
    for entry in re.split(r"Compiling entry function '", text)[1:]:
        kernel = entry.split("'", 1)[0]
        info = dict(kernel=kernel)
        frame = re.search(r'(\d+) bytes stack frame, (\d+) bytes spill '
                          r'stores, (\d+) bytes spill loads', entry)
        regs = re.search(r'Used (\d+) registers', entry)
        smem = re.search(r'(\d+) bytes smem', entry)
        if frame:
            info.update(stack_bytes=int(frame[1]), spill_store_bytes=int(
                frame[2]), spill_load_bytes=int(frame[3]))
        if regs:
            info['registers'] = int(regs[1])
        info['static_smem_bytes'] = int(smem[1]) if smem else 0
        report[kernel] = info
    # ptxas names the kernels whose wgmma it had to serialize, and why
    for why, kernel in re.findall(r'wgmma\.mma_async instructions are '
                                  r"serialized due to (.*?) in the "
                                  r"function '([^']+)'", text):
        if kernel in report:
            report[kernel]['wgmma_serialized'] = why
    return report


def all_sources() -> list:
    """The CUDA sources, by name (``build`` compiles them with nvcc)."""
    return sorted(p.stem for p in CSRC.glob('*.cu'))


def host_sources() -> list:
    """The host sources, ``csrc/<name>.c`` and ``.cpp``, by file name."""
    return sorted(p.name for p in CSRC.iterdir()
                  if p.suffix in ('.c', '.cpp'))


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if needed and load it (once per process)."""
    return ctypes.CDLL(str(build([name])[name]))


def _first_on_path(*names) -> Optional[str]:
    for name in names:
        path = name and shutil.which(name)
        if path:
            return path
    return None


def host_cc() -> Optional[str]:
    """The host C compiler: ``$CC``, else ``cc``, ``gcc`` or ``clang`` on
    the PATH; None if there is none."""
    return _first_on_path(os.environ.get('CC'), 'cc', 'gcc', 'clang')


def host_cxx() -> Optional[str]:
    """The host C++ compiler: ``$CXX``, else ``c++``, ``g++`` or ``clang++``
    on the PATH; None if there is none."""
    return _first_on_path(os.environ.get('CXX'), 'c++', 'g++', 'clang++')


def host_source(name: str) -> Path:
    """``csrc/<name>.c`` or, failing that, ``csrc/<name>.cpp``."""
    src = CSRC / f'{name}.c'
    return src if src.exists() else CSRC / f'{name}.cpp'


@functools.lru_cache(maxsize=None)
def _load_host(name: str) -> Optional[ctypes.CDLL]:
    src = host_source(name)
    cpp = src.suffix == '.cpp'
    compiler = host_cxx() if cpp else host_cc()
    if compiler is None:
        return None
    digest = hashlib.sha1(src.read_bytes()).hexdigest()
    out = BUILD_DIR / f'{name}-{digest[:12]}.so'
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f'.{os.getpid()}.tmp')
        flags = CXX_FLAGS if cpp else CC_FLAGS
        proc = subprocess.run([compiler, *flags, '-o', str(tmp), str(src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f'{compiler} failed for {src.name}:\n'
                               f'{proc.stdout}{proc.stderr}')
        os.replace(tmp, out)
    return ctypes.CDLL(str(out))


def load_host(name: str) -> Optional[ctypes.CDLL]:
    """Build ``csrc/<name>.c`` with the host C compiler, or
    ``csrc/<name>.cpp`` with the host C++ compiler, if needed and load it
    (once per process, whichever thread asks first); None when the machine
    has no such compiler."""
    with _HOST_LOCK:
        return _load_host(name)
