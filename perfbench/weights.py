"""Seeded weights for the benchmark's models, made on the device.

A configuration file (``configs/<name>.json``) holds the published keys of
the model's ``config.json`` and names its ``family``; ``families/<family>.py``
reads them into sizes and lays out the parameter tree.  ``tree`` draws that
tree, in the layout that the port's ``LM(cfg, params=...)`` takes (and that
the references read): nested dicts, lists of layers under ``blocks`` and
``lead``, weights in the ``(in, out)`` layout, each leaf in the dtype the
program serves it in.

The numbers come from one ``torch.Generator`` on the device and two large
calls, one normal draw for the bf16 leaves and one for the f32 leaves; a
leaf is a view of its buffer, at an offset of a whole number of 128
elements, scaled in place.  The same seed gives the same tree, so a
reference made after the program's run regenerates the inputs the program
was given.

Initial values: matrices N(0, 1/fan_in) (fan_in the contraction axis);
the token embedding N(0, 1); RMSNorm scales 1; Mamba1's ``A_log`` the
S4D-real log(1..N), ``D`` 1, ``conv_b`` 0, and ``dt_bias`` the inverse
softplus of a dt log-uniform in [time_step_min, time_step_max], as the
published Mamba initialisation gives it (taken from the normal draw
through its CDF).
"""
from __future__ import annotations

import importlib
import math
from types import SimpleNamespace
from typing import Any, Iterator, Mapping, Tuple

import torch

ALIGN = 128            # elements: every leaf starts on a 256-byte boundary


def family(cfg: Mapping):
    """``families/<family>.py`` of a configuration file."""
    return importlib.import_module(f"perfbench.families.{cfg['family']}")


def sizes(cfg: Mapping) -> SimpleNamespace:
    return family(cfg).sizes(cfg)


# A leaf: (shape, dtype, init); init is ("normal", std), ("ones",),
# ("zeros",), ("a_log", n) or ("dt_bias", dt_min, dt_max).
Spec = Tuple[Tuple[int, ...], torch.dtype, tuple]
BF16, F32 = torch.bfloat16, torch.float32


def w(*shape: int, dtype=BF16, std=None) -> Spec:
    """A matrix, N(0, std^2), 1/fan_in by default (the contraction axis,
    second from last)."""
    return (shape, dtype, ("normal", std if std is not None
                           else shape[-2] ** -0.5))


def ones(n: int, dtype=BF16) -> Spec:
    return ((n,), dtype, ("ones",))


def zeros(n: int, dtype=BF16) -> Spec:
    return ((n,), dtype, ("zeros",))


def specs(cfg: Mapping) -> dict:
    return family(cfg).specs(sizes(cfg))


def walk(tree: Any, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(path, leaf) of a nested tree of dicts and lists, keys sorted; a
    leaf is anything else (a tensor, or a spec tuple of ``specs``)."""
    if isinstance(tree, Mapping):
        for k in sorted(tree):
            yield from walk(tree[k], f"{prefix}{k}.")
    elif isinstance(tree, list):
        for i, x in enumerate(tree):
            yield from walk(x, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def _set(tree: dict, path: str, value) -> None:
    keys = path.split(".")
    node = tree
    for k in keys[:-1]:
        node = node[int(k)] if isinstance(node, list) else node[k]
    last = keys[-1]
    if isinstance(node, list):
        node[int(last)] = value
    else:
        node[last] = value


def _skeleton(tree):
    if isinstance(tree, Mapping):
        return {k: _skeleton(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_skeleton(x) for x in tree]
    return None


@torch.no_grad()
def tree(cfg: Mapping, seed: int, device) -> dict:
    """The parameter tree of ``cfg``'s model drawn from ``seed`` on
    ``device``."""
    spec = specs(cfg)
    leaves = list(walk(spec))
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    out = _skeleton(spec)
    for dtype in (BF16, F32):
        mine = [(p, sp) for p, sp in leaves if sp[1] == dtype]
        offsets, total = [], 0
        for _, (shape, _, init) in mine:
            offsets.append(total)
            if init[0] in ("normal", "dt_bias"):
                total += -(-math.prod(shape) // ALIGN) * ALIGN
        buf = torch.randn(max(total, 1), generator=gen, dtype=dtype,
                          device=device)
        for (path, (shape, _, init)), off in zip(mine, offsets):
            n = math.prod(shape)
            kind = init[0]
            if kind == "normal":
                leaf = buf[off:off + n].view(shape).mul_(init[1])
            elif kind == "dt_bias":
                z = buf[off:off + n].view(shape)
                u = 0.5 * (1 + torch.erf(z / math.sqrt(2)))
                lo, hi = math.log(init[1]), math.log(init[2])
                dt = torch.exp(lo + u * (hi - lo))
                z.copy_(dt + torch.log(-torch.expm1(-dt)))   # softplus^-1
                leaf = z
            elif kind == "ones":
                leaf = torch.ones(shape, dtype=dtype, device=device)
            elif kind == "zeros":
                leaf = torch.zeros(shape, dtype=dtype, device=device)
            elif kind == "a_log":
                leaf = torch.log(torch.arange(
                    1, init[1] + 1, dtype=dtype, device=device)).expand(
                        shape).contiguous()
            else:
                raise ValueError(f"unknown init {kind!r}")
            _set(out, path, leaf)
    return out
