"""Build and bind the port's CUDA kernels.

Each kernel source (``*/csrc/*.cu``) is compiled at first use with ``nvcc``
for ``sm_90a`` into one shared library with a plain C interface, under
``build/`` beside this file (gitignored), and bound with ``ctypes``.  The
library's file name carries a hash of its flags and of every file in its
``csrc/`` directory, so an edited source or header is rebuilt.  ``build``
starts one ``nvcc`` per missing library, all together, and waits for all.

A failed build raises ``BuildError``; a wrapper whose launch returns a CUDA
error raises ``LaunchError`` with the ``cudaError_t`` number, and
``poisons_context`` says, by that number, whether the context is lost.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Iterable

BUILD_DIR = Path(__file__).parent / "build"
BASE_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")


@dataclasses.dataclass(frozen=True)
class Library:
    """One kernel source compiled into one shared library.

    ``bind`` sets the ``argtypes``/``restype`` of the C entry points on the
    loaded library."""
    name: str
    source: Path
    flags: tuple[str, ...]
    bind: Callable[[ctypes.CDLL], None]

    def path(self) -> Path:
        h = hashlib.sha256(" ".join(BASE_FLAGS + self.flags).encode())
        for f in sorted(self.source.parent.iterdir()):
            h.update(f.name.encode() + f.read_bytes())
        return BUILD_DIR / f"lib{self.name}-{h.hexdigest()[:16]}.so"


class BuildError(Exception):
    """A kernel library that could not be built.  Not a RuntimeError, so a
    caller that retries failing work or blames it on one request (the
    serving engine) cannot swallow it."""


class LaunchError(RuntimeError):
    """A kernel launch whose ``cudaGetLastError`` was not ``cudaSuccess``;
    ``code`` is the ``cudaError_t`` number."""

    def __init__(self, what: str, code: int):
        super().__init__(f"{what}: CUDA error {code} at launch")
        self.code = code


# the cudaError_t numbers after which the context cannot be used, with the
# text cudaGetErrorString (and so torch's own CUDA errors) gives for each
STICKY_CUDA_ERRORS = {
    214: "uncorrectable ECC error encountered",
    700: "an illegal memory access was encountered",
    702: "the launch timed out and was terminated",
    710: "device-side assert triggered",
    714: "hardware stack error",
    715: "an illegal instruction was encountered",
    716: "misaligned address",
    717: "operation not supported on global/shared address space",
    718: "invalid program counter",
    719: "unspecified launch failure",
}


def check_launch(err: int, what: str) -> None:
    """Raise ``LaunchError`` for a launch's nonzero ``cudaError_t``."""
    if err != 0:
        raise LaunchError(what, err)


def poisons_context(e: BaseException) -> bool:
    """Whether ``e`` is a CUDA error that leaves the context unusable: a
    ``LaunchError`` by its number, torch's own CUDA errors by their text."""
    if isinstance(e, LaunchError):
        return e.code in STICKY_CUDA_ERRORS
    msg = str(e)
    return "CUDA error" in msg and any(
        m in msg for m in STICKY_CUDA_ERRORS.values())


_LOADED: dict[str, ctypes.CDLL] = {}
# the compiler's output of each library built by this process, by name
LOGS: dict[str, str] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise BuildError("nvcc not found: the port's kernels are built with "
                           "the CUDA toolkit on the machine with the card")
    return found


def build(libs: Iterable[Library], verbose: bool = False) -> float:
    """Build every library of ``libs`` that is not built yet, one ``nvcc``
    per source, all started together.  Returns the seconds spent (0 when all
    were built already).  Raises with the compiler's output on failure."""
    todo = [lib for lib in libs if not lib.path().exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    for lib in todo:
        path = lib.path()
        tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc, *BASE_FLAGS, *lib.flags,
               *(["-Xptxas", "-v"] if verbose else []),
               "-o", str(tmp), str(lib.source)]
        procs.append((lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, path))
    failed = []
    for lib, proc, tmp, path in procs:
        out, _ = proc.communicate()
        LOGS[lib.name] = out
        if verbose and out:
            print(f"[nvcc {lib.source.name}]\n{out}")
        if proc.returncode != 0:
            failed.append(f"{lib.source.name}:\n{out}")
        else:
            os.replace(tmp, path)
    if failed:
        raise BuildError("nvcc failed for " + "\n".join(failed))
    return time.perf_counter() - t0


def load(lib: Library) -> ctypes.CDLL:
    """The bound library, built first if needed."""
    with _LOCK:
        cdll = _LOADED.get(lib.name)
        if cdll is None:
            build([lib])
            cdll = ctypes.CDLL(str(lib.path()))
            lib.bind(cdll)
            _LOADED[lib.name] = cdll
        return cdll
