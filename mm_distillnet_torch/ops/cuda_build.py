"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

Each `csrc/<name>.cu` exposes a plain C interface and is compiled on its own
with nvcc for Hopper (`sm_90a`) into `build/mm_distillnet_torch/` at the
root of the checkout, at first use. The library's file name carries a hash
of the sources and flags, so an edited source is rebuilt and an unchanged
one is loaded as it is. A failed build raises with nvcc's output.

Nothing here runs at import: the CPU tests import every module, and a
CPU-only machine may have no nvcc.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent.parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'mm_distillnet_torch'
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v']

_LIBS: Dict[str, ctypes.CDLL] = {}
build_logs: Dict[str, str] = {}   # name -> nvcc output (ptxas register/smem report)


def sources() -> List[str]:
    return sorted(p.stem for p in CSRC.glob('*.cu'))


def _nvcc() -> str:
    for cand in (os.environ.get('CUDA_HOME'), '/usr/local/cuda'):
        if cand and Path(cand, 'bin', 'nvcc').exists():
            return str(Path(cand, 'bin', 'nvcc'))
    found = shutil.which('nvcc')
    if not found:
        raise RuntimeError('nvcc not found (set CUDA_HOME or put it on PATH)')
    return found


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for p in [CSRC / f'{name}.cu'] + sorted(CSRC.glob('*.cuh')):
        h.update(p.read_bytes())
    return BUILD_DIR / f'lib{name}-{h.hexdigest()[:16]}.so'


def _build(name: str) -> None:
    """Compile csrc/<name>.cu unless its library is already built."""
    out = _lib_path(name)
    if out.exists():
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f'.{os.getpid()}.tmp')
    cmd = [_nvcc(), *NVCC_FLAGS, '-o', str(tmp), str(CSRC / f'{name}.cu')]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    build_logs[name] = proc.stdout
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f'nvcc failed for csrc/{name}.cu:\n{proc.stdout}')
    os.replace(tmp, out)


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, building it if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        _build(name)
        lib = _LIBS[name] = ctypes.CDLL(str(_lib_path(name)))
    return lib
