"""Sharding rules: parameter specs, optimizer-state specs, cache specs, and
input specs for every (arch × shape × mesh) combination.

A port of the JAX package's ``launch/shardings.py``.  The specs stay the
reference's data: a ``Spec`` a leaf, one entry a tensor dim, each entry
``None``, a mesh axis name, or a tuple of names.  The functions that make
them take the mesh's *shape*, a ``{axis: size}`` mapping (a ``DeviceMesh``
or anything with such a ``shape`` is read the same way), so they are pure
and compare with the reference's on a mesh that does not exist.
``Spec``, ``mesh_sizes`` and ``placements`` (a spec's DTensor placements on
a ``DeviceMesh``) live in ``models/axes.py``, below both the models and
this module.

Strategy (the reference's baseline):
  * TP on "model": attention projections, FFN hidden, experts (EP), vocab.
  * DP on ("pod","data"): batch.  Cross-pod is pure DP (grad all-reduce over
    the slow axis — where grad compression applies).
  * FSDP/ZeRO on "data": parameters of ≥3B models are sharded over "data" on
    their non-TP dimension; optimizer moments always are (ZeRO-1).
  * KV caches: batch over ("pod","data"); kv-head dim over "model" when
    divisible, else the sequence dim over "model" (sequence-parallel cache).

The rules match leaf paths of the reference's *stacked* layout
(``blocks/attn/wq`` of a (L, d, H·hd) bank).  The port's models keep a list
of layers instead, so ``layer_param_specs`` computes the specs on the
stacked stand-in (``tree.stack_layers``) and cuts each bank's spec back to
its layers: a layer's spec is the bank's without its leading stack dims.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import tree as T
from repro_torch.models.axes import Spec, axis_names, axis_size, mesh_sizes
from repro_torch.models.config import ModelConfig, param_count

PyTree = Any

FSDP_THRESHOLD = 3e9


def _path_map(fn, node, path=()):
    """``fn(path, leaf)`` over a tree of mappings, lists and tuples (a
    NamedTuple's fields by name, as JAX's key paths spell them)."""
    if node is None:
        return None
    if isinstance(node, dict):
        return {k: _path_map(fn, v, path + (str(k),))
                for k, v in node.items()}
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return type(node)(*(_path_map(fn, v, path + (f,))
                            for f, v in zip(node._fields, node)))
    if isinstance(node, (list, tuple)):
        return type(node)(_path_map(fn, v, path + (str(i),))
                          for i, v in enumerate(node))
    return fn("/".join(path), node)


# -------------------------------------------------------------- param specs
# (regex on the path suffix, spec builder taking (ndim, fsdp_axis))
def _mat(in_ax, out_ax):
    """Spec for a (..., in, out) matrix; leading dims are stacked layers."""
    def build(ndim, fsdp):
        lead = (None,) * (ndim - 2)
        ia = fsdp if in_ax == "fsdp" else in_ax
        oa = fsdp if out_ax == "fsdp" else out_ax
        return Spec(*lead, ia, oa)
    return build


def _vec(ax):
    def build(ndim, fsdp):
        return Spec(*((None,) * (ndim - 1)), ax)
    return build


def _moe_expert(in_ax, out_ax):
    """(..., E, in, out): experts over 'model' (EP)."""
    def build(ndim, fsdp):
        lead = (None,) * (ndim - 3)
        ia = fsdp if in_ax == "fsdp" else in_ax
        oa = fsdp if out_ax == "fsdp" else out_ax
        return Spec(*lead, "model", ia, oa)
    return build


def _none(nd, f):
    return Spec(*((None,) * nd))


_PARAM_RULES = [
    (r"embed$", lambda nd, f: Spec(*((None,) * (nd - 2)), "model", None)),
    (r"lm_head$", lambda nd, f: Spec(*((None,) * (nd - 2)), None, "model")),
    (r"attn/wq$", _mat("fsdp", "model")),
    (r"attn/wk$", _mat("fsdp", "model")),
    (r"attn/wv$", _mat("fsdp", "model")),
    (r"attn/wo$", _mat("model", "fsdp")),
    (r"attn/w_dkv$", _mat("fsdp", None)),
    (r"attn/w_krope$", _mat("fsdp", None)),
    (r"attn/w_uk$", _mat(None, "model")),
    (r"attn/w_uv$", _mat(None, "model")),
    (r"(mlp|shared)/w_gate$", _mat("fsdp", "model")),
    (r"(mlp|shared)/w_up$", _mat("fsdp", "model")),
    (r"(mlp|shared)/w_down$", _mat("model", "fsdp")),
    (r"moe/router$", _mat(None, None)),
    (r"moe/w_gate$", _moe_expert("fsdp", None)),
    (r"moe/w_up$", _moe_expert("fsdp", None)),
    (r"moe/w_down$", _moe_expert(None, "fsdp")),
    (r"ssm/in_[xz]$", _mat("fsdp", "model")),
    (r"ssm/in_[BC]$", _mat("fsdp", None)),
    (r"ssm/in_dt$", _mat("fsdp", None)),
    (r"ssm/x_proj$", _mat("model", None)),
    (r"ssm/dt_proj$", _mat(None, "model")),
    (r"ssm/out_proj$", _mat("model", "fsdp")),
    (r"ssm/A_log$", lambda nd, f: Spec(*((None,) * (nd - 2)), "model", None)
        if nd >= 2 else Spec(*((None,) * (nd - 1)), None)),
    (r"ssm/conv_x_w$", lambda nd, f: Spec(*((None,) * (nd - 1)), "model")),
    (r"ssm/conv_x_b$", _vec("model")),
    (r"ssm/(conv_[BC]_[wb]|conv_w|conv_b|dt_bias|D)$", _none),
    (r"(scale|norm/scale|ln\d?/scale|.*norm.*)$", _none),
]


def param_specs(shapes: PyTree, cfg: ModelConfig, mesh) -> PyTree:
    """Spec tree matching a param tree of the reference's stacked layout
    (leaves with ``shape`` and ``ndim``)."""
    total, _ = param_count(cfg)
    fsdp = "data" if total >= FSDP_THRESHOLD else None
    sizes = mesh_sizes(mesh)

    def assign(path, leaf):
        for pat, builder in _PARAM_RULES:
            if re.search(pat, path):
                spec = builder(leaf.ndim, fsdp)
                return _fix_divisibility(spec, tuple(leaf.shape), sizes)
        return Spec(*((None,) * leaf.ndim))   # default: replicate

    return _path_map(assign, shapes)


def _fix_divisibility(spec: Spec, shape: Tuple[int, ...], mesh) -> Spec:
    """Drop axis assignments whose mesh size does not divide the dim."""
    sizes = mesh_sizes(mesh)
    entries = tuple(spec) + (None,) * (len(shape) - len(spec))
    return Spec(*(ax if ax is None or dim % axis_size(ax, sizes) == 0 else None
                  for dim, ax in zip(shape, entries)))


def opt_state_specs(param_spec_tree: PyTree, shapes: PyTree, mesh,
                    params_shapes: PyTree) -> PyTree:
    """ZeRO-1: master/m/v follow the param spec, with 'data' added on the
    first unsharded divisible dim when the param itself is not data-sharded.
    Pure over the two trees' layout: on the stacked layout it is the
    reference's; on the port's per-layer trees 'data' lands on a dim of the
    layer (a bank's first free dim can be its stack dim)."""
    dp = mesh_sizes(mesh).get("data", 1)

    def zero1(spec, shape_leaf):
        spec_t = tuple(spec) + (None,) * (shape_leaf.ndim - len(spec))
        used = {a for ax in spec_t for a in axis_names(ax)}
        if "data" in used:
            return Spec(*spec_t)
        out = list(spec_t)
        for i, (dim, ax) in enumerate(zip(shape_leaf.shape, spec_t)):
            if ax is None and dim % dp == 0 and dim >= dp:
                out[i] = "data"
                break
        return Spec(*out)

    return T.tree_map(zero1, param_spec_tree, params_shapes)


# --------------------------------------------------------------- cache specs
def cache_specs(cache_shapes: PyTree, batch: int, seq: int, mesh,
                batch_ax) -> PyTree:
    """Shape-driven assignment: batch dim -> batch_ax; then shard heads over
    'model' if divisible, else the sequence dim over 'model'.  On the
    reference's stacked caches it gives the reference's specs; the port's
    per-layer caches (``LM.init_cache``) take it as they are, so that the
    batch lands on a layer's own batch dim (a stacked bank of as many
    layers as sequences would put it on the stack dim)."""
    sizes = mesh_sizes(mesh)
    tp = sizes.get("model", 1)

    def assign(path, leaf):
        dims = list(leaf.shape)
        spec = [None] * leaf.ndim
        # batch: first dim equal to `batch` after the leading stack dims
        b_idx = None
        for i, d in enumerate(dims):
            if d == batch and i <= 2:
                b_idx = i
                break
        if b_idx is not None and batch_ax is not None \
                and batch % axis_size(batch_ax, sizes) == 0:
            spec[b_idx] = batch_ax
        # model axis: prefer a head-like dim (divisible, not batch/seq),
        # searching from the last dim backwards; else the seq dim
        s_idx = None
        for i, d in enumerate(dims):
            if d == seq and i != b_idx:
                s_idx = i
                break
        for i in range(leaf.ndim - 1, -1, -1):
            if i in (b_idx, s_idx):
                continue
            if dims[i] % tp == 0 and dims[i] >= tp:
                spec[i] = "model"
                break
        else:
            if s_idx is not None and dims[s_idx] % tp == 0:
                spec[s_idx] = "model"
        return Spec(*spec)

    return _path_map(assign, cache_shapes)


# ------------------------------------------- the port's per-layer layout
def _meta(tree: PyTree) -> PyTree:
    """Meta stand-ins of ``tree``'s tensors (shape and dtype only)."""
    return T.tree_map(lambda x: torch.empty(tuple(x.shape), dtype=x.dtype,
                                            device="meta"), tree)


class _Bank:
    """A bank's spec; indexing it (a layer's row) drops its stack dim."""

    def __init__(self, spec: Spec):
        self.spec = spec

    def __getitem__(self, i):
        return _Bank(Spec(*tuple(self.spec)[1:]))


def _cut(example: PyTree, stacked_specs: PyTree) -> PyTree:
    banks = T.tree_map(_Bank, stacked_specs)
    return T.tree_map(lambda b: b.spec, T.unstack_layers(example, banks))


def stacked(tree: PyTree) -> PyTree:
    """The reference's stacked layout of a port tree, as meta tensors."""
    return T.stack_layers(_meta(tree), torch.stack)


def layer_param_specs(params: PyTree, cfg: ModelConfig, mesh) -> PyTree:
    """``param_specs`` for the port's per-layer params tree."""
    return _cut(params, param_specs(stacked(params), cfg, mesh))


def layer_opt_specs(params: PyTree, cfg: ModelConfig, mesh) -> PyTree:
    """ZeRO-1 moment specs for the port's per-layer params tree."""
    specs = layer_param_specs(params, cfg, mesh)
    return opt_state_specs(specs, None, mesh, params)


# --------------------------------------------------------------- input specs
def batch_axis(mesh, global_batch: int):
    sizes = mesh_sizes(mesh)
    axes = tuple(a for a in ("pod", "data") if a in sizes)
    if not axes:
        return None
    if global_batch % axis_size(axes, sizes) == 0:
        return axes if len(axes) > 1 else axes[0]
    # try data only
    if "data" in sizes and global_batch % sizes["data"] == 0:
        return "data"
    return None


def logical_rules(mesh, global_batch: int,
                  cfg: Optional[ModelConfig] = None) -> Dict[str, Any]:
    """Logical-axis rules.  Head sharding is enabled only when the KV-head
    count divides the TP axis (otherwise the (Hkv, g) reshape would misalign
    shard boundaries); the ff / ssm-channel / expert constraints are
    divisibility-guarded per-tensor in axes.constrain."""
    tp = mesh_sizes(mesh).get("model", 1)
    heads_ok = cfg is not None and (
        (cfg.mla is not None and cfg.n_heads % tp == 0)
        or (cfg.mla is None and cfg.n_kv_heads > 0
            and cfg.n_kv_heads % tp == 0))
    rules = {
        "batch": batch_axis(mesh, global_batch),
        "seq": None,
        "vocab": "model",
        "expert": "model",
        "ff": "model",
        "heads": "model" if heads_ok else None,
        "kv": "model" if heads_ok else None,
        "ssm_ch": "model",
        "ssm_heads": "model",
    }
    return rules
