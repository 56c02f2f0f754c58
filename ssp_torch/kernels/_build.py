"""Build the port's native code and load it with ctypes: the CUDA kernels
with ``nvcc``, the host libraries (the image decoder, the rasteriser, the
host ops) with the system ``g++``.

Each ``ssp_torch/csrc/<name>.cu`` (and the host source ``<name>.cpp``)
compiles on its own into ``ssp_torch/_build/lib<name>-<hash>.so``: a plain
C interface, no PyTorch headers, so a build takes seconds.  The hash covers
the source, the headers beside it (``*.cuh`` for a kernel, ``*.h`` for a
host library) and the flags, so an edited source is
never served by a stale library.  A build writes a file of its own process
and is put in place with ``os.replace``, so processes that build at once do
not race.  Building happens at first use (or up front through
:func:`build_all`, which starts one compiler per source, all at once); the
kernels need the CUDA toolkit that ``torch.utils.cpp_extension`` finds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
SOURCES = ("bfmatch", "down1", "nms", "stem", "vresample")
HOST_SOURCES = ("features_host", "imageio_host", "ops_host", "raster_host")  # csrc/<name>.cpp, g++
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)
# no -ffast-math and no contraction into FMA: every machine gives the same
# bytes (the rasteriser's double arithmetic must round as OpenCV's does)
GXX_FLAGS = ("-std=c++17", "-O2", "-shared", "-fPIC", "-ffp-contract=off")

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME): cannot build the kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _gxx() -> str:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("no g++ on the PATH: cannot build the host libraries")
    return gxx


def _source(name: str) -> Path:
    return CSRC / (f"{name}.cpp" if name in HOST_SOURCES else f"{name}.cu")


def _default_flags(name: str):
    return GXX_FLAGS if name in HOST_SOURCES else NVCC_FLAGS


def _lib_path(name: str, flags=None) -> Path:
    src = _source(name)
    h = hashlib.sha256(" ".join(flags or _default_flags(name)).encode())
    h.update(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh" if src.suffix == ".cu" else "*.h")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str, out: Path, flags=None) -> subprocess.Popen:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    src = _source(name)
    compiler = _gxx() if src.suffix == ".cpp" else _nvcc()
    cmd = [compiler, *(flags or _default_flags(name)), "-o", str(tmp), str(src)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _finish(name: str, out: Path, proc: subprocess.Popen) -> str:
    log, _ = proc.communicate()
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    if proc.returncode != 0:
        compiler = Path(proc.args[0]).name
        raise RuntimeError(f"{compiler} failed for {_source(name).name} (exit "
                           f"{proc.returncode}):\n{log}")
    os.replace(tmp, out)
    return log


def resource_usage(name: str) -> str:
    """What ``ptxas -v`` says of ``csrc/<name>.cu``: registers, spills and
    shared memory of each kernel.  Compiles into a library of its own that
    is never loaded."""
    flags = (*NVCC_FLAGS, "-Xptxas", "-v")
    out = _lib_path(name, flags)
    return _finish(name, out, _start(name, out, flags))


def build_all() -> Dict[str, float]:
    """Compile every source (the kernels and the host libraries) that has no
    current library, all at once; returns the seconds from the start to
    each build's end (0 for a library that was current)."""
    names = SOURCES + HOST_SOURCES
    with _LOCK:
        todo = {n: _lib_path(n) for n in names}
        t0 = time.perf_counter()
        procs = {n: (p, _start(n, p)) for n, p in todo.items() if not p.exists()}
        seconds = {n: 0.0 for n in names}

        def finish(item):
            n, (p, proc) = item
            _finish(n, p, proc)
            return n, time.perf_counter() - t0

        try:
            with ThreadPoolExecutor(max(len(procs), 1)) as pool:
                seconds.update(pool.map(finish, procs.items()))
            return seconds
        finally:
            for _, proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` (or ``.cpp``), building it
    if needed."""
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
