"""Build and load the port's native code (compiler -> shared library ->
ctypes).

Each `csrc/<name>.cu` exposes a plain C interface and is compiled on its own
with nvcc for Hopper (`sm_90a`); each `csrc/<name>.cpp` (host code: the
image decoder) with the host C++ compiler (`$CXX`, else `c++`). Both go
into `build/mm_distillnet_torch/` at the root of the checkout, at first use
(`load`) or all at once, in parallel (`build_all`). The library's file name
carries a hash of the sources and flags, so an edited source is rebuilt and
an unchanged one is loaded as it is. A failed build raises with the
compiler's output; there is no fallback.

Nothing here runs at import: the CPU tests import every module, and a
CPU-only machine may have no nvcc.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent.parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'mm_distillnet_torch'
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v']
HOST_FLAGS = ['-std=c++17', '-O3', '-shared', '-fPIC',
              '-ffp-contract=off']

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOAD_LOCK = threading.Lock()     # the loader's threads load at first use
# name -> the compiler's output (nvcc: ptxas's register / smem report)
build_logs: Dict[str, str] = {}


def sources() -> List[str]:
    return sorted(p.stem for p in CSRC.glob('*.cu')) + \
        sorted(p.stem for p in CSRC.glob('*.cpp'))


def _source(name: str) -> Path:
    cu = CSRC / f'{name}.cu'
    return cu if cu.exists() else CSRC / f'{name}.cpp'


def _nvcc() -> str:
    for cand in (os.environ.get('CUDA_HOME'), '/usr/local/cuda'):
        if cand and Path(cand, 'bin', 'nvcc').exists():
            return str(Path(cand, 'bin', 'nvcc'))
    found = shutil.which('nvcc')
    if not found:
        raise RuntimeError('nvcc not found (set CUDA_HOME or put it on PATH)')
    return found


def _cxx() -> str:
    found = os.environ.get('CXX') or shutil.which('c++')
    if not found:
        raise RuntimeError('no host C++ compiler (set CXX or put c++ on PATH)')
    return found


def _lib_path(name: str) -> Path:
    src = _source(name)
    if src.suffix == '.cu':
        h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
        deps = [src] + sorted(CSRC.glob('*.cuh'))
    else:
        h = hashlib.sha256(' '.join([_cxx()] + HOST_FLAGS).encode())
        deps = [src]
    for p in deps:
        h.update(p.read_bytes())
    return BUILD_DIR / f'lib{name}-{h.hexdigest()[:16]}.so'


def _start(name: str):
    """Start the compiler for csrc/<name>.cu or .cpp unless its library is
    already built."""
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f'.{os.getpid()}.tmp')
    src = _source(name)
    compiler = [_nvcc(), *NVCC_FLAGS] if src.suffix == '.cu' \
        else [_cxx(), *HOST_FLAGS]
    cmd = [*compiler, '-o', str(tmp), str(src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, out = started
    log, _ = proc.communicate()
    build_logs[name] = log
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f'the build of csrc/{_source(name).name} '
                           f'failed:\n{log}')
    os.replace(tmp, out)


def build_all() -> List[str]:
    """Build every source that is not built yet, one compiler each, all started
    together. Returns the sources' names."""
    names = sources()
    started = {n: _start(n) for n in names}
    errors = []
    for n in names:
        try:
            _finish(n, started[n])
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError('\n'.join(errors))
    return names


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu or .cpp, building it if
    needed."""
    lib = _LIBS.get(name)
    if lib is None:
        with _LOAD_LOCK:
            lib = _LIBS.get(name)
            if lib is None:
                _finish(name, _start(name))
                lib = _LIBS[name] = ctypes.CDLL(str(_lib_path(name)))
    return lib
