"""CUDA kernel for the streaming integrity hash: build, load and launch.

``csrc/checksum.cu`` is compiled with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, at first use, from the package's own
sources, into ``build/`` beside this file.  The library's name carries a
digest of the source and the flags, so an edited source is rebuilt and
never mistaken for a stale build.  It is loaded with ``ctypes``.

``fold_words_cuda`` is the wrapper: it checks its tensors, launches the
kernel on PyTorch's current stream and counts the launch in ``launches``.
It never falls back to another implementation: a tensor the kernel does not
take raises.  The plain version it is held to is ``ref.fold_words_torch``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import torch

_SOURCE = Path(__file__).resolve().parent / "csrc" / "checksum.cu"
_BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# kernel launches since import (or since a caller last reset it); a launch
# is counted only where the kernel was actually launched
launches = 0

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()
build_log = ""          # compiler output of this process's build, if any


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
        "the integrity-hash kernel cannot be built")


def library_path() -> Path:
    """Where the built library lives: keyed by a digest of the source and
    the compiler flags."""
    key = hashlib.sha256(_SOURCE.read_bytes()
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return _BUILD_DIR / f"libchecksum_{key}.so"


def nvcc_command(nvcc: str, out: Path) -> list:
    return [nvcc, *NVCC_FLAGS, "-o", str(out), str(_SOURCE)]


def build() -> Path:
    """Compile the kernel library unless this source's build exists; the
    compiler's output (``-Xptxas -v``: registers, spills) goes to
    ``build_log``.  Writes to a temporary name and renames, so a
    concurrent or interrupted build never leaves a torn library behind."""
    global build_log
    lib = library_path()
    if lib.exists():
        return lib
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
    proc = subprocess.run(nvcc_command(find_nvcc(), tmp),
                          capture_output=True, text=True)
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed to build {_SOURCE}:\n{build_log}")
    os.replace(tmp, lib)
    return lib


def load() -> ctypes.CDLL:
    """The kernel library, built if needed and loaded once per process."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.repro_fold_words.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint32,
                ctypes.c_void_p, ctypes.c_void_p]
            lib.repro_fold_words.restype = ctypes.c_int
            _lib = lib
        return _lib


def _check(words: torch.Tensor, acc: torch.Tensor) -> None:
    if words.dtype != torch.int32:
        raise TypeError(f"words must be int32 (the bit pattern of uint32 "
                        f"words), got {words.dtype}")
    if words.device.type != "cuda":
        raise ValueError(f"fold_words_cuda needs a CUDA tensor, got "
                         f"{words.device}")
    if words.dim() != 1 or not words.is_contiguous():
        raise ValueError("words must be a contiguous 1-D tensor")
    if (acc.device != words.device or acc.dtype != torch.int32
            or acc.shape != (1,)):
        raise ValueError("acc must be a one-element int32 tensor on the "
                         "words' device")


def fold_words_cuda(words: torch.Tensor, start_word: int,
                    acc: torch.Tensor) -> torch.Tensor:
    """XOR the fold of ``words`` (global word offset ``start_word``) into
    ``acc`` on the current stream, without synchronising.  ``words`` is a
    contiguous 1-D int32 CUDA tensor; ``acc`` a one-element int32 tensor on
    the same device.  An empty ``words`` launches nothing (a grid of no
    blocks is an invalid launch; the fold of no words is 0)."""
    global launches
    _check(words, acc)
    n = words.numel()
    if n == 0:
        return acc
    lib = load()
    with torch.cuda.device(words.device):
        stream = torch.cuda.current_stream(words.device).cuda_stream
        err = lib.repro_fold_words(words.data_ptr(), n,
                                   start_word & 0xFFFFFFFF, acc.data_ptr(),
                                   stream)
    if err != 0:
        raise RuntimeError(f"fold_words kernel launch failed with CUDA error "
                           f"{err}")
    launches += 1
    return acc
