"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each ``ssp_torch/csrc/<name>.cu`` compiles on its own into
``ssp_torch/_build/lib<name>-<hash>.so``: a plain C interface, no PyTorch
headers, so a build takes seconds.  The hash covers the source, the
headers beside it and the flags, so an edited source is never served by a
stale library.  Building happens at first use (or up front through
:func:`build_all`, which starts one ``nvcc`` per source, all at once); it
needs the CUDA toolkit that ``torch.utils.cpp_extension`` finds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
SOURCES = ("down1", "nms", "stem", "vresample")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME): cannot build the kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _lib_path(name: str, flags=NVCC_FLAGS) -> Path:
    h = hashlib.sha256(" ".join(flags).encode())
    h.update((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str, out: Path, flags=NVCC_FLAGS) -> subprocess.Popen:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *flags, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _finish(name: str, out: Path, proc: subprocess.Popen) -> str:
    log, _ = proc.communicate()
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)
    return log


def resource_usage(name: str) -> str:
    """What ``ptxas -v`` says of ``csrc/<name>.cu``: registers, spills and
    shared memory of each kernel.  Compiles into a library of its own that
    is never loaded."""
    flags = (*NVCC_FLAGS, "-Xptxas", "-v")
    out = _lib_path(name, flags)
    return _finish(name, out, _start(name, out, flags))


def build_all() -> None:
    """Compile every source that has no current library, in parallel."""
    with _LOCK:
        todo = {n: _lib_path(n) for n in SOURCES}
        procs = {n: (p, _start(n, p)) for n, p in todo.items() if not p.exists()}
        try:
            for n, (p, proc) in procs.items():
                _finish(n, p, proc)
        finally:
            for _, proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is not None:
            return lib
        path = _lib_path(name)
        if not path.exists():
            _finish(name, path, _start(name, path))
        lib = ctypes.CDLL(str(path))
        _LIBS[name] = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
