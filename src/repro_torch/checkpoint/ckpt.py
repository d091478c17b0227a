"""Sharded checkpointing with integrity manifests.

Layout of a checkpoint directory, the JAX package's byte for byte::

    step-000123/
      tree.json          # pytree structure + per-leaf dtype/shape/chunking
      leaf-00000.c00.npy # leaf payload, chunked on the leading axis so a
      leaf-00000.c01.npy #   large cluster restores in parallel reads
      ...
      data_state.npz     # data-pipeline iterator state
      MANIFEST.json      # per-file (size, checksum) — verified on restore
      COMMITTED          # written last: crash-safe atomicity marker

Save is atomic (tmp dir + rename + COMMITTED marker); restore refuses
uncommitted or corrupt checkpoints and falls back to the previous step —
the checkpoint/restart half of fault tolerance.  The MANIFEST is the
integrity layer's (``core/integrity.py``): every file is hashed on
``device``, by the integrity-hash kernel on ``"cuda"`` (the default).

Either package restores the other's checkpoints:

* leaves are numbered in ``jax.tree_util.tree_flatten``'s order
  (``repro_torch.tree``): mapping keys sorted, ``AdamWState`` in field
  order;
* the port's per-layer ``blocks`` lists are written as the reference's
  layer banks (each leaf stacked on axis 0) and cut back into layers on
  restore;
* a leaf's dtype tag is numpy's name (``"bfloat16"``, ``"float32"``,
  ``"int32"``), and bf16 is written as its uint16 bits;
* the ``treedef`` token spells the structure as ``str(PyTreeDef)`` does;
  neither package reads it back.

As in the reference, a checkpoint restores by the caller's example tree,
whose leaf count must be the checkpoint's.
"""
from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.core.integrity import Manifest
from repro_torch.kernels.device import Device, require_device

PyTree = Any


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """(host array, numpy dtype name) of a leaf; bf16 as its uint16
    bits."""
    t = torch.as_tensor(leaf).detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).cpu().numpy().view(np.uint16), "bfloat16"
    arr = t.cpu().numpy()
    return arr, str(arr.dtype)


def _from_numpy(arr: np.ndarray, dtype_tag: str,
                device: torch.device) -> torch.Tensor:
    """A tensor on ``device`` of a loaded leaf (``np.load`` arrays are C
    order, and ``astype`` copies them so)."""
    if dtype_tag == "bfloat16":
        bits = arr.astype(np.uint16).view(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr.astype(dtype_tag)).to(device)


def save_checkpoint(ckpt_root: str, step: int, tree: PyTree,
                    data_state_path: Optional[str] = None,
                    n_chunks: int = 4, keep: int = 3,
                    device: Device = "cuda") -> str:
    """Write checkpoint for ``step``; returns the committed directory."""
    dev = require_device(device)
    final = os.path.join(ckpt_root, f"step-{step:06d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)

    banks = T.stack_layers(tree, torch.stack)
    meta: List[Dict] = []
    for i, leaf in enumerate(T.leaves(banks)):
        arr, dtype_tag = _to_numpy(leaf)
        chunks = max(1, min(n_chunks, arr.shape[0] if arr.ndim else 1))
        bounds = np.linspace(0, arr.shape[0] if arr.ndim else 1,
                             chunks + 1).astype(int) if arr.ndim else [0, 1]
        files = []
        for c in range(chunks):
            name = f"leaf-{i:05d}.c{c:02d}.npy"
            if arr.ndim:
                np.save(os.path.join(tmp, name), arr[bounds[c]:bounds[c + 1]])
            else:
                np.save(os.path.join(tmp, name), arr)
            files.append(name)
        meta.append({"dtype": dtype_tag, "shape": list(arr.shape),
                     "files": files})
    with open(os.path.join(tmp, "tree.json"), "w") as f:
        json.dump({"treedef": T.treedef_token(banks), "step": step,
                   "leaves": meta}, f)
    if data_state_path and os.path.exists(data_state_path):
        shutil.copy(data_state_path, os.path.join(tmp, "data_state.npz"))

    manifest = Manifest.scan(tmp, dev)
    manifest.save(os.path.join(tmp, "MANIFEST.json"))
    with open(os.path.join(tmp, "COMMITTED"), "w") as f:
        f.write("ok")
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _gc(ckpt_root, keep)
    return final


def restore_checkpoint(ckpt_root: str, example_tree: PyTree,
                       step: Optional[int] = None, device: Device = "cuda",
                       ) -> Optional[Tuple[int, PyTree, str]]:
    """Restore the latest committed+verified checkpoint (or a given step)
    into the structure of ``example_tree``, its leaves on ``device`` in
    their saved dtypes.

    Returns (step, tree, dir) or None.  Corrupt/uncommitted candidates are
    skipped with a warning — restart never loads bad state.  A checkpoint
    whose leaf count is not the example's raises ``ValueError``, as the
    reference's ``tree_unflatten`` does.
    """
    dev = require_device(device)
    for cand_step, d in _candidates(ckpt_root, step):
        manifest_path = os.path.join(d, "MANIFEST.json")
        if not (os.path.exists(os.path.join(d, "COMMITTED"))
                and os.path.exists(manifest_path)):
            continue
        manifest = Manifest.load(manifest_path)
        problems = {k: v for k, v in manifest.verify(d, dev).items()
                    if k not in ("MANIFEST.json", "COMMITTED")}
        if problems:
            print(f"[ckpt] skipping corrupt {d}: {problems}")
            continue
        with open(os.path.join(d, "tree.json")) as f:
            info = json.load(f)
        leaves = []
        for m in info["leaves"]:
            parts = [np.load(os.path.join(d, fn)) for fn in m["files"]]
            arr = parts[0] if len(parts) == 1 else np.concatenate(parts, 0)
            leaves.append(_from_numpy(arr, m["dtype"], dev))
        banks = T.stack_layers(example_tree, lambda xs: xs[0])
        tree = T.unstack_layers(example_tree, T.unflatten(banks, leaves))
        return info["step"], tree, d
    return None


def latest_step(ckpt_root: str) -> Optional[int]:
    cands = _candidates(ckpt_root, None)
    return cands[0][0] if cands else None


# ---------------------------------------------------------------------- util
def _candidates(root: str, step: Optional[int]):
    if not os.path.isdir(root):
        return []
    out = []
    for name in os.listdir(root):
        m = re.match(r"step-(\d+)$", name)
        if not m:
            continue
        s = int(m.group(1))
        if step is not None and s != step:
            continue
        out.append((s, os.path.join(root, name)))
    return sorted(out, reverse=True)


def _gc(root: str, keep: int) -> None:
    cands = _candidates(root, None)
    for s, d in cands[keep:]:
        shutil.rmtree(d, ignore_errors=True)
