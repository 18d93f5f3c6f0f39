"""Build the CUDA sources under ``repro_torch/csrc`` and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on
first use by ``nvcc`` for ``sm_90a`` into ``<build dir>/<name>-<hash>.so``
(the hash covers the source and the flags, so an edited source rebuilds
and an unchanged one loads at once).  :func:`build_all` starts one
``nvcc`` per source, all at once, and waits for them together.

The build directory is ``$REPRO_TORCH_BUILD_DIR`` or ``build/kernels``
next to the package's ``src`` directory (listed in ``.gitignore``).
Nothing here runs when a module is imported: the CPU tests import every
module on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
SOURCES = ("gemm", "paged_attention", "flash_attention", "ssd_scan")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def build_dir() -> str:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return env
    src_root = os.path.dirname(os.path.dirname(CSRC))  # .../src
    return os.path.join(os.path.dirname(src_root), "build", "kernels")


def nvcc_path() -> str:
    for cand in (
        os.environ.get("NVCC"),
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set $NVCC or $CUDA_HOME to build the kernels")


def library_path(name: str) -> str:
    """Where the library of ``csrc/<name>.cu`` is (or will be) built."""

    with open(os.path.join(CSRC, f"{name}.cu"), "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return os.path.join(build_dir(), f"{name}-{digest}.so")


def _start(name: str) -> Optional[subprocess.Popen]:
    """Start ``nvcc`` for one source unless its library is already built."""

    out = library_path(name)
    if os.path.exists(out):
        return None
    os.makedirs(build_dir(), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    proc.tmp, proc.out, proc.cmd = tmp, out, cmd  # type: ignore[attr-defined]
    return proc


def _finish(proc: subprocess.Popen) -> str:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(proc.cmd)}\n{log}"  # type: ignore[attr-defined]
        )
    os.replace(proc.tmp, proc.out)  # type: ignore[attr-defined]
    with open(proc.out + ".log", "w") as f:  # type: ignore[attr-defined]
        f.write(log)
    return log


def build_all(names=SOURCES) -> dict[str, str]:
    """Compile every missing library in parallel; returns nvcc's logs
    (``-Xptxas -v`` register and shared-memory reports) by source name."""

    procs = {name: _start(name) for name in names}
    logs = {}
    for name, proc in procs.items():
        logs[name] = _finish(proc) if proc is not None else _cached_log(name)
    return logs


def _cached_log(name: str) -> str:
    path = library_path(name) + ".log"
    if os.path.exists(path):
        with open(path) as f:
            return f.read()
    return ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""

    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build_all((name,))
            lib = ctypes.CDLL(library_path(name))
            _LIBS[name] = lib
        return lib


def check(status: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry point."""

    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status}")


__all__ = ["CSRC", "SOURCES", "build_all", "build_dir", "check", "library_path", "load",
           "nvcc_path"]
