"""Build and load a kernel library from the package's own CUDA sources.

Each kernel package keeps one ``csrc/*.cu`` file with a plain C interface.
``CudaLibrary`` compiles it with ``nvcc`` for ``sm_90a`` into a shared
library at first use, into ``build/`` beside ``csrc/``, and loads it with
``ctypes``.  The library's name carries a digest of the source and the
flags, so an edited source is rebuilt and never mistaken for a stale build.
Builds of different libraries may run at once (each is one ``nvcc``
process), which is how ``chip_smoke.py`` starts them all together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Optional

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def find_nvcc() -> str:
    """``nvcc`` from ``CUDA_HOME``, else from ``PATH``; raises if the CUDA
    compiler is in neither."""
    home = os.environ.get("CUDA_HOME")
    if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError(
        "nvcc (the CUDA compiler) was not found through CUDA_HOME or PATH; "
        "no CUDA kernel can be built")


class CudaLibrary:
    """One kernel library: ``source`` is its ``.cu`` file, ``name`` the stem
    of the built ``lib<name>_<digest>.so``, and ``bind`` sets the argument
    and result types of its C functions once it is loaded."""

    def __init__(self, source: Path, name: str,
                 bind: Callable[[ctypes.CDLL], None]):
        self.source = source
        self.name = name
        self.build_dir = source.parent.parent / "build"
        self.build_log = ""     # compiler output of this process's build
        self._bind = bind
        self._lib: Optional[ctypes.CDLL] = None
        self._lock = threading.Lock()

    def library_path(self) -> Path:
        """Where the built library lives: keyed by a digest of the source
        and the compiler flags."""
        key = hashlib.sha256(self.source.read_bytes()
                             + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        return self.build_dir / f"lib{self.name}_{key}.so"

    def nvcc_command(self, nvcc: str, out: Path) -> list:
        return [nvcc, *NVCC_FLAGS, "-o", str(out), str(self.source)]

    def build(self) -> Path:
        """Compile the library unless this source's build exists; the
        compiler's output (``-Xptxas -v``: registers, spills) goes to
        ``build_log``.  Writes to a temporary name and renames, so a
        concurrent or interrupted build never leaves a torn library."""
        lib = self.library_path()
        if lib.exists():
            return lib
        self.build_dir.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
        proc = subprocess.run(self.nvcc_command(find_nvcc(), tmp),
                              capture_output=True, text=True)
        self.build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed to build {self.source}:\n"
                               f"{self.build_log}")
        os.replace(tmp, lib)
        return lib

    def load(self) -> ctypes.CDLL:
        """The library, built if needed and loaded once per process."""
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(self.build()))
                self._bind(lib)
                self._lib = lib
            return self._lib
