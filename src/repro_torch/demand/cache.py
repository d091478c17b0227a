"""Per-replica read cache with pluggable eviction.

Serving tiers in front of archive storage keep hot datasets on fast media;
this models that layer per replica site.  Three eviction disciplines:

  * ``"lru"``        — classic least-recently-used;
  * ``"popularity"`` — evict the least popular entry first (highest
    popularity rank), breaking ties toward the least recently used;
  * ``"pin"``        — pin-all: admitted entries are never evicted, and new
    admissions are refused once the capacity is full.

All state lives in one insertion-ordered dict, so iteration (and therefore
eviction tie-breaking and serialization) is deterministic and survives a
checkpoint/resume byte-for-byte.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import List


class ReadCache:
    def __init__(self, site: str, capacity_bytes: int = 0,
                 eviction: str = "lru"):
        self.site = site
        self.capacity = int(capacity_bytes)      # 0 = unbounded
        self.eviction = eviction
        # path -> [nbytes, popularity rank at admission, last-used sim time]
        self._entries: "OrderedDict[str, List]" = OrderedDict()
        self.used = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._entries)

    def contains(self, path: str) -> bool:
        return path in self._entries

    # -------------------------------------------------------------- serving
    def touch(self, path: str, now: float, count: int = 1) -> bool:
        """Serve ``count`` requests for ``path``; True on a cache hit."""
        e = self._entries.get(path)
        if e is None:
            self.misses += count
            return False
        e[2] = now
        self._entries.move_to_end(path)
        self.hits += count
        return True

    def admit(self, path: str, nbytes: int, rank: int, now: float) -> bool:
        """Admit ``path`` after a miss, evicting per policy to make room;
        False when the entry cannot fit (over-capacity, or pin-all full)."""
        if path in self._entries:
            return True
        nbytes = int(nbytes)
        if self.capacity and nbytes > self.capacity:
            return False
        while self.capacity and self.used + nbytes > self.capacity:
            if not self._evict_one():
                return False
        self._entries[path] = [nbytes, int(rank), float(now)]
        self.used += nbytes
        return True

    def _evict_one(self) -> bool:
        if not self._entries or self.eviction == "pin":
            return False
        if self.eviction == "lru":
            victim = next(iter(self._entries))
        else:  # popularity-weighted: least popular first, then oldest use
            victim = max(self._entries,
                         key=lambda p: (self._entries[p][1],
                                        -self._entries[p][2]))
        e = self._entries.pop(victim)
        self.used -= e[0]
        self.evictions += 1
        return True

    # -------------------------------------------------------------- summary
    def summary(self) -> dict:
        return {"entries": len(self._entries), "used_bytes": self.used,
                "hits": self.hits, "misses": self.misses,
                "evictions": self.evictions}

    # ---------------------------------------------------------- checkpoints
    def state_dict(self) -> dict:
        return {"entries": [[p, e[0], e[1], e[2]]
                            for p, e in self._entries.items()],
                "used": self.used, "hits": self.hits, "misses": self.misses,
                "evictions": self.evictions}

    def load_state_dict(self, d: dict) -> None:
        self._entries = OrderedDict(
            (p, [int(nb), int(rank), float(last)])
            for p, nb, rank, last in d["entries"])
        self.used = int(d["used"])
        self.hits = int(d["hits"])
        self.misses = int(d["misses"])
        self.evictions = int(d["evictions"])
