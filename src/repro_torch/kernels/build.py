"""Build of the port's hand-written CUDA kernels: ``nvcc`` -> a shared
library with a plain C interface in ``kernels/_build/`` -> ``ctypes``.

Each kernel package holds one :class:`KernelLibrary` for its ``.cu``
source.  The library is compiled at first use, once per digest of its
source, the headers it includes (``#include "..."``, followed
recursively) and the flags (an unchanged source reuses its ``.so``), for
``sm_90a``; nothing is compiled or loaded when a module is imported.
:func:`build_all` starts one ``nvcc`` per library not yet built, all at
once, and loads them when they are done.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Callable, Iterable, Optional

BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


_INCLUDE = re.compile(r'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def sources_of(source: Path) -> list:
    """``source`` and every file it includes with ``#include "..."``,
    followed recursively, each path resolved against the directory of the
    file that names it (as nvcc does); a name that resolves to no file is
    left to nvcc's own search path."""
    seen, order, stack = set(), [], [Path(source).resolve()]
    while stack:
        path = stack.pop()
        if path in seen:
            continue
        seen.add(path)
        order.append(path)
        for name in _INCLUDE.findall(path.read_text()):
            dep = (path.parent / name).resolve()
            if dep.is_file():
                stack.append(dep)
    return order


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the port's CUDA kernels are "
                           "built from source at first use on the card")
    return path


class KernelLibrary:
    """One ``.cu`` source and its loaded library.  ``declare`` sets the
    ``argtypes`` / ``restype`` of the library's C functions."""

    def __init__(self, name: str, source: Path,
                 declare: Callable[[ctypes.CDLL], None]):
        self.name = name
        self.source = Path(source)
        self._declare = declare
        self.lib: Optional[ctypes.CDLL] = None
        self.seconds = 0.0       # wall time of the last build (0: cached)
        self.log = ""            # nvcc's output (ptxas registers / smem)

    def path(self) -> Path:
        h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
        for src in sources_of(self.source):
            h.update(src.read_bytes())
        digest = h.hexdigest()
        return BUILD_DIR / f"{self.name}_{digest[:12]}.so"

    def load(self) -> ctypes.CDLL:
        """The library, compiled first if no build of this source exists."""
        if self.lib is None:
            build_all([self])
        return self.lib

    def _open(self, path: Path) -> None:
        lib = ctypes.CDLL(str(path))
        self._declare(lib)
        self.lib = lib


def build_all(libraries: Iterable[KernelLibrary]) -> None:
    """Compile every library not yet built (one ``nvcc`` each, all started
    together), then load each; raise with nvcc's output if one fails."""
    pending = []
    for lib in libraries:
        if lib.lib is not None:
            continue
        out = lib.path()
        if out.exists():
            lib.seconds = 0.0
            lib._open(out)
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(lib.source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        pending.append((lib, out, tmp, proc, time.perf_counter()))
    failed = []
    for lib, out, tmp, proc, t0 in pending:
        lib.log, _ = proc.communicate()
        lib.seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"nvcc failed on {lib.source.name} "
                          f"({proc.returncode}):\n{lib.log}")
            continue
        os.replace(tmp, out)
        lib._open(out)
    if failed:
        raise RuntimeError("\n".join(failed))
