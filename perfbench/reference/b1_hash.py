"""The integrity hash (B1) in NumPy, for the audit's digests.

    g[i] = mix32(word[i] ^ (i * 0x9E3779B1))     words: little-endian uint32
    H    = mix32(XOR_i g[i] ^ nbytes)            the last word zero-padded

``mix32`` is the xorshift-multiply avalanche (16, 0x7FEB352D, 15,
0x846CA68B, 16), all arithmetic mod 2**32.  ``digest`` folds a buffer in
slices of ``SLICE`` words so that the temporaries stay small; the fold is
an XOR of per-word values, so the slices give the whole buffer's.
"""
from __future__ import annotations

import numpy as np

PHI = np.uint32(0x9E3779B1)
SLICE = 1 << 22


def mix32(x: np.ndarray) -> np.ndarray:
    x = x ^ (x >> np.uint32(16))
    x = x * np.uint32(0x7FEB352D)
    x = x ^ (x >> np.uint32(15))
    x = x * np.uint32(0x846CA68B)
    return x ^ (x >> np.uint32(16))


def digest(data) -> int:
    """The hash of ``data`` (bytes, or a uint8 array)."""
    buf = np.frombuffer(data, dtype=np.uint8)
    nbytes = buf.size
    pad = -nbytes % 4
    tail = np.zeros(pad, np.uint8)
    acc = np.uint32(0)
    n_words = (nbytes + pad) // 4
    with np.errstate(over="ignore"):
        for w0 in range(0, n_words, SLICE):
            w1 = min(n_words, w0 + SLICE)
            raw = buf[4 * w0:4 * w1]
            if raw.size % 4:
                raw = np.concatenate([raw, tail])
            words = raw.view("<u4").astype(np.uint32)
            idx = np.arange(w0, w1, dtype=np.uint32)
            acc ^= np.bitwise_xor.reduce(mix32(words ^ (idx * PHI)))
        h = np.array([acc ^ np.uint32(nbytes & 0xFFFFFFFF)], np.uint32)
        return int(mix32(h)[0])
