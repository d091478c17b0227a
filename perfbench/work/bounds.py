"""Least device time of a kernel call from its shapes: the larger of its
bytes over HBM bandwidth and its operations over their peak.  Each input
byte is counted read once and each output byte written once."""
from __future__ import annotations

from perfbench.work import peaks


def checksum_s(n_bytes: int) -> float:
    """B1 over ``n_bytes`` (whole words): 4 B a word read and the 4-byte
    accumulator, against 12 integer operations a word."""
    words = n_bytes // 4
    return max((4 * words + 4) / peaks.HBM_BYTES,
               12 * words / peaks.INT32_OPS)


def scan_s(B: int, T: int, D: int, N: int) -> float:
    """B4, the selective scan over (B, T, D) channels of N states, float32:
    u, dt and y (B, T, D), B and C (B, T, N), A (D, N), h0 and hT (B, D,
    N), against one exp a state a step."""
    nbytes = 4 * (3 * B * T * D + 2 * B * T * N + D * N + 2 * B * D * N)
    return max(nbytes / peaks.HBM_BYTES, B * T * D * N / peaks.SFU_EXPS)
