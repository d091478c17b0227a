"""The one traffic generator: sizes from a traffic file's distributions,
contents from the run's seed.

Every seed gets the same set of sizes, in another order, so that runs with
different seeds do the same work: a distribution is sampled at fixed
quantiles, never by random draws.  Two samplers, each one value from each
of ``n`` equal strata of the distribution:

* ``stratified(spec, n)``: each stratum's midpoint (a wave of ``n``
  requests holds one request of every stratum);
* ``stratum_means(spec, n)``: each stratum's mean, so that the values'
  mean is the distribution's and the top stratum carries its tail's bytes
  (a tree of ``n`` files).

A distribution is ``{"dist": "lognormal", "median", "sigma", "min",
"max"}`` (clipped to [min, max]) or ``{"dist": "fixed", "value"}``.  The
seed only permutes and fills: ``permutation`` and ``rng`` give its order
and its contents.
"""
from __future__ import annotations

import math
from statistics import NormalDist
from typing import List, Mapping

import numpy as np

_NORMAL = NormalDist()


def quantile(spec: Mapping, q: float) -> int:
    """The ``q`` quantile of ``spec``, an integer within its clip."""
    if spec["dist"] == "fixed":
        return int(spec["value"])
    if spec["dist"] != "lognormal":
        raise ValueError(f"unknown distribution {spec['dist']!r}")
    v = spec["median"] * math.exp(spec["sigma"] * _NORMAL.inv_cdf(q))
    return int(min(max(round(v), spec["min"]), spec["max"]))


def stratified(spec: Mapping, n: int) -> List[int]:
    """One value from each of ``n`` equal strata, at their midpoints, in
    ascending order."""
    return [quantile(spec, (i + 0.5) / n) for i in range(n)]


def stratum_means(spec: Mapping, n: int, sub: int = 1024) -> List[int]:
    """The mean of each of ``n`` equal strata, in ascending order: the
    midpoint rule over ``sub`` equal parts of the stratum."""
    return [round(sum(quantile(spec, (i + (j + 0.5) / sub) / n)
                      for j in range(sub)) / sub) for i in range(n)]


def rng(seed: int, *stream: int) -> np.random.Generator:
    """A generator for one stream of the run's seed (any whole numbers)."""
    return np.random.default_rng([x & (2 ** 64 - 1) for x in (seed, *stream)])


def torch_seed(seed: int, *stream: int) -> int:
    """A seed for ``torch.Generator.manual_seed`` drawn from one stream."""
    return int(rng(seed, *stream).integers(0, 2 ** 62))


def permutation(seed: int, n: int, *stream: int) -> List[int]:
    return [int(i) for i in rng(seed, *stream).permutation(n)]
