"""Public op: checksum arbitrary-size byte/tensor payloads on a device.

``fold_words`` dispatches on where its tensor lies: a CUDA tensor goes to
the kernel (``checksum.fold_words_cuda``) or raises, a CPU tensor to the
plain PyTorch version (``ref.fold_words_torch``).  Nothing falls back from
one to the other.  The kernel masks its tail by the word count, so unlike
the TPU path no zero-padding is needed; only the final partial word of a
byte payload is zero-filled, exactly as the reference does, and the true
byte length is folded into the finalizer.
"""
from __future__ import annotations

import warnings
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels.checksum.checksum import fold_words_cuda
from repro_torch.kernels.checksum.ref import (MASK32, bytes_to_words,
                                              finalize32_np, fold_words_torch)
from repro_torch.kernels.device import Device, require_device


def words_tensor(data: bytes, n_words: int, device: torch.device
                 ) -> torch.Tensor:
    """The first ``n_words`` little-endian uint32 words of ``data`` as an
    int32 tensor on ``device`` (one host-to-device copy for CUDA)."""
    arr = np.frombuffer(data, dtype="<u4", count=n_words).view(np.int32)
    with warnings.catch_warnings():
        # ``bytes`` are immutable, so the array is read-only; the tensor is
        # only ever read (and copied, for a CUDA device)
        warnings.filterwarnings("ignore", message="The given NumPy array is "
                                "not writable")
        return torch.from_numpy(arr).to(device)


def new_accumulator(device: torch.device) -> torch.Tensor:
    return torch.zeros(1, dtype=torch.int32, device=device)


def accumulator_value(acc: torch.Tensor) -> int:
    """Read an accumulator back to the host as a uint32 value."""
    return int(acc.item()) & MASK32


def fold_words(words: torch.Tensor, start_word: int = 0,
               acc: Optional[torch.Tensor] = None) -> torch.Tensor:
    """XOR the fold of ``words`` (1-D int32, global word offset
    ``start_word``) into ``acc`` — a one-element int32 tensor on the words'
    device, made fresh when not given — and return ``acc``.  No
    synchronisation on CUDA: read the value with ``accumulator_value``."""
    if acc is None:
        acc = new_accumulator(words.device)
    if words.device.type == "cuda":
        return fold_words_cuda(words, start_word, acc)
    if words.device.type != "cpu":
        raise ValueError(f"no integrity-hash implementation for "
                         f"{words.device}")
    h = fold_words_torch(words, start_word)
    acc ^= torch.where(h >= 2 ** 31, h - 2 ** 32, h).to(torch.int32)
    return acc


def checksum_bytes(data: bytes, device: Device = "cuda") -> int:
    """Counterpart of ``checksum_bytes_np``, with the fold on ``device``."""
    dev = require_device(device)
    words = torch.from_numpy(bytes_to_words(data).view(np.int32)).to(dev)
    acc = fold_words(words)
    return finalize32_np(accumulator_value(acc), len(data) & 0xFFFFFFFF)


def checksum_tensor(x: torch.Tensor, device: Device = "cuda") -> int:
    """Hash a tensor's raw contents (its bytes in memory order), like the
    reference's ``checksum_array``.  The payload is reinterpreted as words in
    place on ``device``; one whose length is not a multiple of four bytes is
    first copied, on ``device``, into a zeroed buffer of whole words, which
    zero-fills the final partial word as ``bytes_to_words`` does."""
    dev = require_device(device)
    flat = x.detach().contiguous().reshape(-1).to(dev).view(torch.uint8)
    nbytes = flat.numel()
    if nbytes % 4:
        padded = torch.zeros(nbytes + 4 - nbytes % 4, dtype=torch.uint8,
                             device=dev)
        padded[:nbytes] = flat
        flat = padded
    acc = fold_words(flat.view(torch.int32))
    return finalize32_np(accumulator_value(acc), nbytes & 0xFFFFFFFF)
