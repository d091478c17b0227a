"""Reference (oracle) implementation of the streaming integrity hash.

Construction (exact uint32 arithmetic, order-sensitive, fully parallel):

    g[i] = mix32(word[i] ^ (i * PHI))        # position baked into each word
    H    = finalize32( XOR_i g[i]  ^  nbytes )

``mix32``/``finalize32`` are xorshift-multiply avalanches.  XOR-reduction is
associative+commutative, so the hash can be computed in any tiling/order —
the CUDA kernel in ``checksum.py`` XORs per-block partials into one device
word with atomics — while position mixing keeps it order-*sensitive* over
the data.

Three implementations, all bit-identical:
  * ``checksum_bytes_np``  — numpy, the host hasher (``faults.stable_digest``
    and the tests' oracle);
  * ``fold_words_torch``   — plain PyTorch, any device; the CPU path of
    ``ops.fold_words`` and the yardstick the kernel is held to on the card;
  * the CUDA kernel ``csrc/checksum.cu`` behind ``checksum.fold_words_cuda``.
"""
from __future__ import annotations

import numpy as np
import torch

PHI = np.uint32(0x9E3779B1)
MASK32 = 0xFFFFFFFF


# ------------------------------------------------------------------- mix/fin
def _mix32_np(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint32)
    x ^= x >> np.uint32(16)
    x = (x * np.uint32(0x7FEB352D)).astype(np.uint32)
    x ^= x >> np.uint32(15)
    x = (x * np.uint32(0x846CA68B)).astype(np.uint32)
    x ^= x >> np.uint32(16)
    return x


def finalize32_np(h: int, nbytes: int) -> int:
    x = np.uint32(h) ^ np.uint32(nbytes & 0xFFFFFFFF)
    x = _mix32_np(np.array([x], np.uint32))[0]
    return int(x)


# ------------------------------------------------------------------ word prep
def bytes_to_words(data: bytes) -> np.ndarray:
    pad = (-len(data)) % 4
    if pad:
        data = data + b"\0" * pad
    return np.frombuffer(data, dtype="<u4").astype(np.uint32)


# ------------------------------------------------------------------- hashers
def fold_words_np(words: np.ndarray, start_word: int = 0) -> int:
    """XOR-fold a word slice whose first element sits at global word offset
    ``start_word``.  Because the reduction is associative+commutative and the
    position is baked into each word, partial folds over consecutive slices
    XOR together to the whole-buffer fold — the basis of the streaming
    (chunked) hasher in ``core.integrity``."""
    words = words.astype(np.uint32)
    if not words.size:
        return 0
    idx = np.arange(words.size, dtype=np.uint32) + np.uint32(
        start_word & 0xFFFFFFFF)
    g = _mix32_np(words ^ (idx * PHI))
    return int(np.bitwise_xor.reduce(g))


def checksum_words_np(words: np.ndarray, nbytes: int) -> int:
    return finalize32_np(fold_words_np(words), nbytes)


def checksum_bytes_np(data: bytes) -> int:
    return checksum_words_np(bytes_to_words(data), len(data))


# --------------------------------------------------------- plain PyTorch fold
# torch's uint32 lacks ``>>``, ``arange`` and ``<`` on the CPU, so the plain
# version holds each uint32 value in an int64 in [0, 2**32).  A 32x32-bit
# product would overflow int64's signed range, so every multiply by a
# constant is split into the constant's 16-bit halves: both partial products
# stay below 2**48, and only the low 16 bits of the high one can reach the
# result's low 32 bits.

def _mul32_torch(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x * c) mod 2**32`` for int64 ``x`` in [0, 2**32)."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def _mix32_torch(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul32_torch(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32_torch(x, 0x846CA68B)
    return x ^ (x >> 16)


def _xor_reduce_torch(g: torch.Tensor) -> torch.Tensor:
    """XOR of all elements (PyTorch has no XOR reduction): fold pairs until
    one element is left; a zero pads odd lengths (the XOR identity)."""
    while g.numel() > 1:
        if g.numel() % 2:
            g = torch.cat([g, g.new_zeros(1)])
        g = g[0::2] ^ g[1::2]
    return g.reshape(())


def fold_words_torch(words: torch.Tensor, start_word: int = 0) -> torch.Tensor:
    """Plain PyTorch ``fold_words_np``: ``words`` is a 1-D int32 tensor (the
    bit pattern of the uint32 words) on any device.  Returns a 0-dim int64
    tensor in [0, 2**32) on the same device; the fold of no words is 0."""
    w = words.reshape(-1).to(torch.int64) & MASK32
    if not w.numel():
        return torch.zeros((), dtype=torch.int64, device=words.device)
    idx = (torch.arange(w.numel(), dtype=torch.int64, device=w.device)
           + (start_word & MASK32)) & MASK32
    g = _mix32_torch(w ^ _mul32_torch(idx, int(PHI)))
    return _xor_reduce_torch(g)
