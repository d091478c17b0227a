"""Decoder LM: init, forward, loss, prefill, decode.

A port of the JAX package's ``models/model.py`` for all five of its layer
patterns (``derive_pattern``), and a sixth of the port's own:

* ``uniform_attn`` with GQA attention (smollm-135m, qwen3-14b with qk-norm,
  starcoder2-15b; qwen2-vl-7b with M-RoPE over the frontend's embeddings,
  musicgen-large with 4 codebooks);
* ``moe``: ``n_lead`` dense blocks (FFN width ``d_ff_dense``), then blocks
  whose FFN is a mixture of experts, with GQA attention (qwen3-moe-30b-a3b)
  or Multi-head Latent Attention (deepseek-v2-lite-16b);
* ``ssm`` with Mamba1 layers (falcon-mamba-7b);
* ``local_global`` (gemma3-27b): groups of ``group_local`` sliding-window
  layers and one global layer, then a tail of windowed layers; the
  windowed layers keep ring-buffer caches of the window's length;
* ``hybrid`` (zamba2-1.2b): groups of ``group_local`` Mamba2 layers, each
  group followed by one weight-shared attention block (with a KV cache per
  call site), then a tail of Mamba2 layers;
* ``mixed`` (a ``MixedConfig``): a list of blocks, each a mixer (GQA
  attention or Mamba1) and an FFN (a gated MLP or a mixture of experts) as
  the config's schedule gives them per layer (Jamba), or each one
  sublayer, Mamba2, GQA attention or a mixture of experts, as the
  config's ``blocks`` list them; the cache holds a ``KVCache``, a
  ``Mamba1State`` or a ``Mamba2State`` by layer, and None for an experts
  block.

The reference scans over stacked parameter banks to keep its compiled
graph small; here each layer is an ``nn.Module`` in an ``nn.ModuleList``,
run in a Python loop, and a layer's parameters are the reference's,
unstacked, in its ``(in, out)`` layout.  The parameter tree mirrors the
reference's: ``blocks`` and the MoE ``lead`` are lists of layers;
``groups`` a list of ``{"local": [layers], "global": layer}`` (local_global)
or of lists of layers (hybrid); ``shared`` one block; ``tail`` a list of
layers, or None where there is none, as the reference's ``stack_init``
gives.  ``plan_stack`` reads that layout from the config once: the layers
in the order they run, each with its parameters' place in the tree, its
module, its window and its cache's kind and place; the model walks it.
Parameters start frozen (``requires_grad=False``), and serving runs
under ``no_grad``.  A trainer calls ``requires_grad_()`` and differentiates
``loss_fn``: the kernels' ops then go through their ``autograd.Function``s,
whose backward is eager PyTorch.  ``load_params`` writes a parameter tree
into the model (the optimizer's new bf16 params, a restored checkpoint),
leaf dtypes included.  ``remat`` recomputes each block in the backward pass
(``torch.utils.checkpoint``), as the reference's ``jax.checkpoint`` does in
its train mode.

Inputs are token ids (B, T), or (B, T, K) for K codebooks, or a batch
mapping: ``{"tokens"}`` or, where the config has ``embed_inputs=False``,
``{"embeds"}`` from the frontend, with M-RoPE's ``positions3`` (3, B, T)
beside them.  Caches mirror the parameter tree, with a state a call site
under ``shared`` and no part without layers.  KV and MLA caches are
written in place (the new entries cast to the cache's dtype); an SSM
layer's state is replaced by the new one each call, so the conv state
takes the dtype its concatenation promotes to, as the reference's scan
output does.  As in the reference, KV and MLA caches and conv states start
as bf16 even for f32 parameters, and ``h`` is f32.

On the card, a stack whose cache is recurrent (``StackPlan.recurrent``:
the ``ssm`` pattern's) decodes as a CUDA graph per batch size
(``decode_step``).  Every other stack writes KV caches at the host integer
``t``, and decodes eagerly.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Mapping, NamedTuple, \
    Optional, Tuple, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import tree as T
from repro_torch.kernels.device import Device, require_device
from repro_torch.kernels.local import is_dtensor
from repro_torch.models import layers as L
from repro_torch.models.axes import constrain
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.models.config import ModelConfig, is_mixed, mamba2_heads

Cache = Dict[str, Any]
Inputs = Union[torch.Tensor, Mapping[str, Any]]


# ===================================================================== pattern
class Pattern(NamedTuple):
    """Static description of the layer stack (derived from cfg)."""
    kind: str  # uniform_attn | local_global | moe | ssm | hybrid | mixed
    n_scan: int          # layers in the main bank
    n_lead: int = 0
    n_groups: int = 0
    group_local: int = 0  # local layers per group / ssm layers per group
    n_tail: int = 0


def derive_pattern(cfg: ModelConfig) -> Pattern:
    if is_mixed(cfg):
        return Pattern("mixed", n_scan=cfg.n_layers)
    if cfg.family == "ssm":
        return Pattern("ssm", n_scan=cfg.n_layers)
    if cfg.hybrid is not None:
        e = cfg.hybrid.shared_attn_every
        g = cfg.n_layers // e
        return Pattern("hybrid", n_scan=0, n_groups=g, group_local=e,
                       n_tail=cfg.n_layers - g * e)
    if cfg.local_global_ratio > 0:
        r = cfg.local_global_ratio
        g = cfg.n_layers // (r + 1)
        return Pattern("local_global", n_scan=0, n_groups=g, group_local=r,
                       n_tail=cfg.n_layers - g * (r + 1))
    if cfg.moe is not None:
        lead = cfg.moe.first_dense_layers
        return Pattern("moe", n_scan=cfg.n_layers - lead, n_lead=lead)
    return Pattern("uniform_attn", n_scan=cfg.n_layers)


Path = Tuple[Union[str, int], ...]


class Layer(NamedTuple):
    """One layer of the stack as ``plan_stack`` lays it out.  Its mixer
    names its cache: a ``KVCache`` (a ring of ``ring`` positions where that
    is set), an ``MLACache``, a ``Mamba1State`` or a ``Mamba2State``; a
    layer without a mixer caches None.  A ``Block`` has both a mixer and an
    FFN, a ``Sublayer`` one of the two."""
    params: Path              # its parameters in the tree, its module in LM
    mixer: Optional[str]      # "attn", "mla", "mamba1", "mamba2" or None
    ffn: Optional[str]        # "mlp", "dense" (the MoE lead's width),
    #                           "moe" or None
    window: Optional[int]     # attention's window
    cache: Optional[Path]     # its state in the cache tree
    ring: Optional[int]       # a KV ring's length (at most the cache's)
    positions3: bool          # whether M-RoPE's ids reach it


class StackPlan(NamedTuple):
    """The layer stack of a config: ``layers`` in the order they run;
    ``params`` the parameter tree's layer keys with each layer's ``Layer``
    at its place (the hybrid's shared block once, where no call site may
    run it); ``cache`` the cache tree with each call site's ``Layer`` at
    its state's place."""
    pattern: Pattern
    layers: Tuple[Layer, ...]
    params: Dict[str, Any]
    cache: Dict[str, Any]

    @property
    def recurrent(self) -> bool:
        """Whether the cache is the list ``blocks`` of one recurrent state
        a layer, all of one kind: a step reads and replaces it whatever its
        position, so its shapes and addresses do not depend on ``t``."""
        return (len({layer.mixer for layer in self.layers}) == 1
                and self.layers[0].mixer in ("mamba1", "mamba2")
                and list(self.cache) == ["blocks"])

    @property
    def mamba1(self) -> int:
        """The Mamba1 mixers (a step runs each once)."""
        return sum(layer.mixer == "mamba1" for layer in self.layers)


def plan_stack(cfg: ModelConfig) -> StackPlan:
    """The layout of ``cfg``'s layer stack, read from its pattern."""
    pat = derive_pattern(cfg)
    w = cfg.sliding_window
    attn = "mla" if cfg.mla is not None else "attn"
    layers: List[Layer] = []

    def add(path, mixer, ffn, window=None, ring=None, p3=False):
        layers.append(Layer(path, mixer, ffn, window, path, ring, p3))
        return layers[-1]

    def run(key, n, *args, **kw):
        return [add((*key, i), *args, **kw) for i in range(n)] or None

    if pat.kind == "mixed":
        params = {"blocks": [add(("blocks", i), attn if m == "attn" else m, f)
                             for i, (m, f) in enumerate(cfg.layer_plan())]}
    elif pat.kind == "ssm":
        params = {"blocks": run(("blocks",), pat.n_scan,
                                f"mamba{cfg.ssm.version}", None)}
    elif pat.kind in ("uniform_attn", "moe"):
        params = {"lead": run(("lead",), pat.n_lead, attn, "dense",
                              p3=True)} if pat.n_lead else {}
        params["blocks"] = run(("blocks",), pat.n_scan, attn,
                               "moe" if pat.kind == "moe" else "mlp", w,
                               p3=True)
    elif pat.kind == "local_global":
        params = {"groups": [
            {"local": run(("groups", g, "local"), pat.group_local, attn,
                          "mlp", w, w),
             "global": add(("groups", g, "global"), attn, "mlp")}
            for g in range(pat.n_groups)],
            "tail": run(("tail",), pat.n_tail, attn, "mlp", w, w)}
    else:                                                # hybrid
        ssm = f"mamba{cfg.ssm.version}"
        shared = Layer(("shared",), attn, "mlp", None, None, None, False)
        groups = []
        for g in range(pat.n_groups):
            groups.append(run(("groups", g), pat.group_local, ssm, None))
            layers.append(shared._replace(cache=("shared", g)))
        params = {"groups": groups, "shared": shared,
                  "tail": run(("tail",), pat.n_tail, ssm, None)}
    cache = {k: v for k, v in params.items() if v is not None}
    if "shared" in cache:                      # a state a call site
        cache["shared"] = [x for x in layers if x.params == ("shared",)]
    return StackPlan(pat, tuple(layers), params, cache)


def count_mamba1(cfg: ModelConfig) -> int:
    """The layer stack's Mamba1 mixers: a ``mixed`` schedule's "mamba1"
    layers, and every SSM layer of the ``ssm`` and ``hybrid`` patterns
    whose SSM is Mamba1; none elsewhere."""
    return plan_stack(cfg).mamba1


def _map(fn: Callable[[Layer], Any], node):
    """A plan's tree with ``fn`` of each ``Layer`` in its place, the
    ``Layer``s taken in the tree's order."""
    if isinstance(node, Layer):
        return fn(node)
    if isinstance(node, dict):
        return {k: _map(fn, v) for k, v in node.items()}
    if isinstance(node, list):
        return [_map(fn, v) for v in node]
    return None


def _at(tree, path: Path):
    for key in path:
        tree = tree[key]
    return tree


_SUBLAYERS = ("ssm", "attn", "moe")


def _key(mixer: Optional[str], ffn: Optional[str]) -> str:
    """The parameter key of a layer's one sublayer or its mixer."""
    if mixer is None:
        return ffn
    return "ssm" if mixer.startswith("mamba") else "attn"


def _layout(node):
    """The layers of a parameter tree, or of a plan's, each as a
    ``Sublayer``'s key ("ssm", "attn" or "moe") or a ``Block``'s (mixer
    key, FFN key); None for a part without any."""
    if isinstance(node, Layer):
        node = dict.fromkeys(
            ("ln", _key(node.mixer, node.ffn))
            if node.mixer is None or node.ffn is None else
            ("ln1", _key(node.mixer, None), node.ffn))
    if isinstance(node, Mapping):
        if "ln" in node:
            return next(k for k in _SUBLAYERS if k in node)
        if "ln1" in node:
            return ("ssm" if "ssm" in node else "attn",
                    "moe" if "moe" in node else "mlp")
        out = {k: v for k, x in node.items()
               if (v := _layout(x)) is not None}
        return out or None
    if isinstance(node, list):
        return [_layout(x) for x in node] or None
    return None


# the parameter tree's keys that hold layers (the rest is ``LM.io``)
LAYER_KEYS = ("blocks", "lead", "groups", "shared", "tail")


# ===================================================================== blocks
class ParamTree(nn.Module):
    """A nested mapping of tensors as a module: tensors become frozen
    parameters, mappings child modules; ``tree["wq"]`` reads either."""

    def __init__(self, tree: Mapping[str, Any]):
        super().__init__()
        for name, value in tree.items():
            if isinstance(value, Mapping):
                self.add_module(name, ParamTree(value))
            else:
                self.register_parameter(
                    name, nn.Parameter(value, requires_grad=False))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def tree(self, device=None) -> dict:
        """The parameters as the nested mapping they were built from, on
        ``device`` (the same tensors where it is None)."""
        out = {name: p.detach() if device is None else p.detach().to(device)
               for name, p in self._parameters.items()}
        out.update((name, m.tree(device)) for name, m in
                   self._modules.items())
        return out

    def parameter_tree(self) -> dict:
        """The ``nn.Parameter``s themselves, in the mapping of ``tree``."""
        out = dict(self._parameters)
        out.update((name, m.parameter_tree()) for name, m in
                   self._modules.items())
        return out


def init_block(gen: torch.Generator, cfg: ModelConfig, dtype,
               use_moe: bool = False, dense_ff: int = 0,
               mixer: str = "attn") -> dict:
    p = {"ln1": L.init_rmsnorm(cfg.d_model, dtype, gen.device),
         "ln2": L.init_rmsnorm(cfg.d_model, dtype, gen.device)}
    if mixer == "mamba1":
        p["ssm"] = SSM.init_mamba1(gen, cfg, dtype)
    else:
        p["attn"] = (L.init_mla(gen, cfg, dtype) if cfg.mla is not None
                     else L.init_attention(gen, cfg, dtype))
    if use_moe:
        p["moe"] = MOE.init_moe(gen, cfg, dtype)
    else:
        p["mlp"] = L.init_mlp(gen, cfg.d_model, dense_ff or cfg.d_ff, dtype)
    return p


class Block(ParamTree):
    """Pre-norm block: ``ln1``, a mixer (``attn``: GQA or MLA; or, in the
    mixed pattern, ``ssm``: Mamba1), ``ln2``, then ``mlp`` or ``moe``.
    Returns (x, new cache, aux loss), the aux loss None for an MLP block
    (the reference's 0).  A Mamba1 mixer's cache is its state, which it
    replaces (``cache_index``, ``window`` and ``positions3`` do not reach
    it)."""

    def __init__(self, cfg: ModelConfig, params: Mapping[str, Any]):
        super().__init__(params)
        self.cfg = cfg

    def forward(self, x, positions, cache=None, cache_index=None,
                window=None, positions3=None):
        cfg = self.cfg
        h = L.rmsnorm(self["ln1"], x, cfg.norm_eps)
        if "ssm" in self._modules:
            a, new_cache = SSM.mamba1_block(self["ssm"], cfg, h, cache)
        elif cfg.mla is not None:
            a, new_cache = L.mla_attention(self["attn"], cfg, h, positions,
                                           cache, cache_index)
        else:
            a, new_cache = L.attention(self["attn"], cfg, h, positions,
                                       cache, cache_index, window,
                                       positions3)
        x = x + a
        h = L.rmsnorm(self["ln2"], x, cfg.norm_eps)
        if "moe" in self._modules:
            f, aux = MOE.moe_forward(self["moe"], cfg, h)
        else:
            f, aux = L.mlp(self["mlp"], h), None
        return constrain(x + f, ("batch", "seq", None)), new_cache, aux


def init_sublayer(gen: torch.Generator, cfg: ModelConfig, dtype,
                  key: str) -> dict:
    init = {"ssm": SSM.init_ssm_block, "attn": L.init_attention,
            "moe": MOE.init_moe}[key]
    return {"ln": L.init_rmsnorm(cfg.d_model, dtype, gen.device),
            key: init(gen, cfg, dtype)}


class Sublayer(ParamTree):
    """Pre-norm block of one sublayer: ``ln``, then ``ssm`` (Mamba1 or
    Mamba2), ``attn`` (GQA) or ``moe``; ``x + sub(rmsnorm(x))``.  Called
    as a ``Block`` is, it returns (x, new cache, aux loss): an SSM's cache
    is its state, which it replaces; attention writes its KV cache at
    ``cache_index``; the experts cache nothing and give the aux loss (None
    elsewhere)."""

    def __init__(self, cfg: ModelConfig, params: Mapping[str, Any]):
        super().__init__(params)
        self.cfg = cfg

    def forward(self, x, positions=None, cache=None, cache_index=None,
                window=None, positions3=None):
        cfg = self.cfg
        h = L.rmsnorm(self["ln"], x, cfg.norm_eps)
        aux = None
        if "ssm" in self._modules:
            y, cache = SSM.ssm_block(self["ssm"], cfg, h, cache)
        elif "attn" in self._modules:
            y, cache = L.attention(self["attn"], cfg, h, positions, cache,
                                   cache_index, window, positions3)
        else:
            y, aux = MOE.moe_forward(self["moe"], cfg, h)
        return constrain(x + y, ("batch", "seq", None)), cache, aux


# ======================================================================== model
class LM(nn.Module):
    """The decoder on ``device`` (default ``"cuda"``; ``"cpu"`` runs the
    kernels' plain versions).  ``params`` is a tree as ``init`` returns it;
    without one, ``init(seed)`` draws the weights from a seeded
    ``torch.Generator`` on the device."""

    def __init__(self, cfg: ModelConfig, dtype=torch.bfloat16,
                 device: Device = "cuda",
                 params: Optional[Mapping[str, Any]] = None, seed: int = 0,
                 remat: bool = True):
        super().__init__()
        self.plan = plan_stack(cfg)
        self.pattern = self.plan.pattern
        self.cfg = cfg
        # the Mamba1 mixers a decode step runs, each one conv step and one
        # selective-state step
        self.mamba1_layers = self.plan.mamba1
        self.dtype = dtype
        self.remat = remat
        self.device = require_device(device)
        if params is None:
            params = self.init(seed)
        self._check_layers(params)
        self.io = ParamTree({k: v for k, v in params.items()
                             if k not in LAYER_KEYS})
        mods = _map(lambda layer: (
            Block if layer.mixer and layer.ffn else Sublayer)(
                cfg, _at(params, layer.params)), self.plan.params)
        # (an empty list where the plan has no such part)
        self.lead = _module_tree(mods.get("lead"))
        self.blocks = _module_tree(mods.get("blocks"))
        self.groups = _module_tree(mods.get("groups"))
        self.shared = _module_tree(mods.get("shared"))
        self.tail = _module_tree(mods.get("tail"))
        # each layer in the order it runs, with its module
        self._layers = tuple((layer, _at(self._modules, layer.params))
                            for layer in self.plan.layers)
        # the decode graphs by batch size, and whether this model decodes
        # through them (``graphs_decode``)
        self._graphs: Dict[int, DecodeGraph] = {}
        self._graph_ok: Optional[bool] = None
        # the path of the last ``decode_step``: "capture", "replay", "eager"
        self.decode_path: Optional[str] = None

    def _check_layers(self, params: Mapping[str, Any]) -> None:
        """``ValueError`` unless the tree holds the plan's layers."""
        got = _layout({k: params.get(k) for k in LAYER_KEYS})
        want = _layout(self.plan.params)
        if got != want:
            raise ValueError(f"a tree of layers {got} for the plan of "
                             f"{self.cfg.n_layers} layers: {want}")

    # ------------------------------------------------------------------ init
    def init(self, seed: int) -> dict:
        """A parameter tree drawn from ``torch.Generator(device)`` seeded
        with ``seed``: the reference's shapes, dtypes and scales, not its
        numbers (``jax.random`` draws others).  On the meta device, the
        shapes and dtypes alone."""
        cfg, dtype = self.cfg, self.dtype
        gen = (L.MetaGenerator() if self.device.type == "meta" else
               torch.Generator(device=self.device).manual_seed(seed))
        K = cfg.n_codebooks
        books = (K,) if K > 1 else ()
        p: Dict[str, Any] = {
            "embed": L._dense_init(
                gen, (*(books if cfg.embed_inputs else ()), cfg.vocab_size,
                      cfg.d_model), dtype, scale=0.02),
            "final_norm": L.init_rmsnorm(cfg.d_model, dtype, self.device)}
        if not cfg.tie_embeddings:
            # (d, V) per codebook; L._dense_init scales by the first axis of
            # its shape, so a book's head is drawn as the reference's is,
            # at 1/sqrt(K) for K codebooks
            p["lm_head"] = L._dense_init(gen, (*books, cfg.d_model,
                                               cfg.vocab_size), dtype)

        def draw(layer):
            if layer.mixer is None or layer.ffn is None:
                return init_sublayer(gen, cfg, dtype,
                                     _key(layer.mixer, layer.ffn))
            return init_block(
                gen, cfg, dtype, use_moe=layer.ffn == "moe",
                dense_ff=cfg.moe.d_ff_dense if layer.ffn == "dense" else 0,
                mixer=layer.mixer)
        p.update(_map(draw, self.plan.params))
        return p

    def _trees(self, of) -> dict:
        out = dict(of(self.io))
        out.update(_map(lambda layer: of(_at(self._modules, layer.params)),
                        self.plan.params))
        return out

    def params(self, device=None) -> dict:
        """The parameter tree, as ``init`` returns it, on ``device``."""
        return self._trees(lambda m: m.tree(device))

    def parameter_tree(self) -> dict:
        """The ``nn.Parameter``s, in the tree of ``params``."""
        return self._trees(lambda m: m.parameter_tree())

    @torch.no_grad()
    def load_params(self, params: Mapping[str, Any]) -> None:
        """Make ``params`` (a tree of ``params``' structure) the model's
        parameters, each leaf moved to the device in its own dtype: the
        optimizer's new params are bf16 whatever the model's dtype, as in
        the reference.  A DTensor parameter keeps its placements: the new
        leaf is redistributed to them (``set_param``).  The decode graphs,
        which read the old parameters, are dropped."""
        from torch.distributed.tensor import DTensor
        got, want = T.leaves(params), T.leaves(self.parameter_tree())
        if len(got) != len(want):
            raise ValueError(f"{len(got)} leaves for a model of "
                             f"{len(want)}")
        for p, new in zip(want, got):
            if tuple(new.shape) != tuple(p.shape):
                raise ValueError(f"a leaf of shape {tuple(new.shape)} for a "
                                 f"parameter of {tuple(p.shape)}")
            if isinstance(p, DTensor):
                set_param(p, new.redistribute(p.device_mesh, p.placements))
            else:
                p.data = new.to(self.device)
        self._graphs.clear()
        self._graph_ok = None

    # ----------------------------------------------------------------- cache
    def _state(self, layer: Layer, batch: int, max_seq: int):
        """A layer's zero cache: its KV (ring) or MLA cache, or its SSM
        state; None without a mixer."""
        cfg = self.cfg
        if layer.mixer is None:
            return None

        def zeros(*shape, dtype=torch.bfloat16):
            return torch.zeros(shape, dtype=dtype, device=self.device)
        seq = min(layer.ring or max_seq, max_seq)
        if layer.mixer == "mla":
            return L.MLACache(zeros(batch, seq, cfg.mla.kv_lora_rank),
                              zeros(batch, seq, cfg.mla.qk_rope_head_dim))
        if layer.mixer == "attn":
            shape = (batch, seq, cfg.n_kv_heads, cfg.head_dim)
            return L.KVCache(zeros(*shape), zeros(*shape))
        s = cfg.ssm
        if layer.mixer == "mamba1":
            d_in = s.expand * cfg.d_model
            conv, h = d_in, (d_in, s.d_state)
            state = SSM.Mamba1State
        else:
            d_in, H = mamba2_heads(cfg)
            conv = d_in + 2 * s.n_groups * s.d_state
            h = (H, s.headdim, s.d_state)
            state = SSM.Mamba2State
        return state(zeros(batch, s.d_conv - 1, conv),
                     zeros(batch, *h, dtype=torch.float32))

    def init_cache(self, batch: int, max_seq: int) -> Cache:
        """Zero caches for ``batch`` sequences of up to ``max_seq``
        positions; a windowed layer's ring holds min(window, max_seq)."""
        return _map(lambda layer: self._state(layer, batch, max_seq),
                    self.plan.cache)

    # ------------------------------------------------------------- embedding
    def embed(self, inputs: Inputs) -> torch.Tensor:
        """(B, T, d) activations of token ids (B, T) or (B, T, K), or of a
        batch mapping: its ``embeds`` where the config takes the frontend's
        (``embed_inputs=False``) and the batch has them, else its
        ``tokens``.  K codebooks' embeddings are summed in order."""
        cfg = self.cfg
        batch = inputs if isinstance(inputs, Mapping) else {"tokens": inputs}
        if not cfg.embed_inputs and "embeds" in batch:
            return torch.as_tensor(batch["embeds"]).to(self.device,
                                                       self.dtype)
        tokens = torch.as_tensor(batch["tokens"]).to(self.device, torch.long)
        table = self.io["embed"]
        look = _sharded_lookup if is_dtensor(table) else \
            (lambda t, ids: t[ids])
        if cfg.n_codebooks > 1:
            x = look(table[0], tokens[..., 0])
            for k in range(1, cfg.n_codebooks):
                x = x + look(table[k], tokens[..., k])
            return x
        return look(table, tokens)

    def unembed(self, x: torch.Tensor) -> torch.Tensor:
        """Logits (B, T, V), or (B, T, K, V) for K codebooks."""
        cfg = self.cfg
        if cfg.tie_embeddings:
            head = self.io["embed"]
            if cfg.n_codebooks > 1:
                return torch.einsum("btd,kvd->btkv", x, head)
            return x @ head.T
        head = self.io["lm_head"]
        if cfg.n_codebooks > 1:
            return torch.einsum("btd,kdv->btkv", x, head)
        return x @ head

    def _positions3(self, inputs: Inputs) -> Optional[torch.Tensor]:
        p3 = inputs.get("positions3") if isinstance(inputs, Mapping) else None
        return None if p3 is None else torch.as_tensor(p3).to(self.device)

    # ------------------------------------------------------------- backbone
    def backbone(self, x: torch.Tensor, positions: torch.Tensor,
                 cache: Optional[Cache] = None, t: Optional[int] = None,
                 positions3: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, Optional[Cache], torch.Tensor]:
        """The layer stack and the final norm: (x, the new cache, the sum of
        the MoE blocks' aux losses, f32).  Without a cache, the forward over
        positions arange(T); with one, serving from position ``t``.
        ``positions3`` reaches the layers the plan marks (the attention
        layers of the uniform_attn and moe patterns, as in the reference)."""
        serving = cache is not None
        remat = self.remat and not serving and torch.is_grad_enabled()
        aux = torch.zeros((), dtype=torch.float32, device=self.device)
        states = {}

        def run(block, *args):
            if remat:
                return checkpoint(block, *args, use_reentrant=False)
            return block(*args)

        for layer, block in self._layers:
            state = _at(cache, layer.cache) if serving else None
            x, state, a = run(block, x, positions, state, t, layer.window,
                              positions3 if layer.positions3 else None)
            if a is not None:
                aux = aux + a
            states[layer.cache] = state
        x = L.rmsnorm(self.io["final_norm"], x, self.cfg.norm_eps)
        if not serving:
            return x, None, aux
        return x, _map(lambda layer: states[layer.cache],
                       self.plan.cache), aux

    def _run(self, inputs: Inputs, cache=None, t=None):
        x = constrain(self.embed(inputs), ("batch", "seq", None))
        B, T = x.shape[:2]
        positions = torch.arange(T, device=self.device)[None].expand(B, T)
        return self.backbone(x, positions, cache, t,
                             self._positions3(inputs))

    @torch.no_grad()
    def forward(self, inputs: Inputs) -> torch.Tensor:
        """Logits (B, T, V) (or (B, T, K, V)) of the full causal forward over
        token ids (B, T) or a batch mapping (``embed``; its ``positions3``
        for M-RoPE)."""
        x, _, _ = self._run(inputs)
        return self.unembed(x)

    # ------------------------------------------------------------------ loss
    def loss_fn(self, batch: Mapping[str, Any], aux_weight: float = 0.01
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(loss, {"ce", "aux"}) of ``batch`` ({"tokens"} or {"embeds"},
        integer "labels", and "positions3" for M-RoPE): the mean
        cross-entropy of the causal forward (over codebooks too), plus
        ``aux_weight`` times the MoE blocks' summed load-balancing loss (0
        without MoE).  Differentiable where grad is enabled."""
        x, _, aux = self._run(batch)
        logits = self.unembed(x)
        labels = torch.as_tensor(batch["labels"]).to(self.device)
        ce = softmax_xent(logits, labels)
        loss = ce + aux_weight * aux
        return loss, {"ce": ce, "aux": aux}

    # --------------------------------------------------------------- serving
    @torch.no_grad()
    def prefill(self, inputs: Inputs, cache: Cache
                ) -> Tuple[torch.Tensor, Cache]:
        """Run the prompt (token ids, or a batch mapping as ``forward``
        takes) through the model, writing the cache at positions 0..T-1;
        the last position's logits (B, 1, V) (or (B, 1, K, V))."""
        x, cache, _ = self._run(inputs, cache, 0)
        return self.unembed(x[:, -1:]), cache

    @torch.no_grad()
    def decode_step(self, cache: Cache, token: torch.Tensor, t: int
                    ) -> Tuple[torch.Tensor, Cache]:
        """token: (B, 1) (or (B, 1, K)) at position ``t``, embedded from the
        token table; M-RoPE takes ``t`` on all three streams.  Logits
        (B, 1, V) (or (B, 1, K, V)).

        Where ``graphs_decode`` holds, the step replays a CUDA graph of
        batch size B, captured at B's first step (``decode_path``
        "capture"; after it "replay", and "eager" off the graph): the
        token is copied into the graph's buffer and, unless ``cache`` is
        the cache the graph returned, ``cache`` into its state.  The
        logits and the cache returned are then the graph's own buffers,
        valid until this model's next ``decode_step`` at B."""
        if not self.graphs_decode():
            self.decode_path = "eager"
            return self._decode_eager(cache, token, t)
        g = self._graphs.get(token.shape[0])
        if g is None or (cache is not g.cache and not self._fits(cache, g)):
            g = self._capture(cache, token)
            self.decode_path = "capture"
        else:
            self.decode_path = "replay"
        g.token.copy_(token)
        if cache is not g.cache:
            _stack_into(g.banks, cache["blocks"])
        g.graph.replay()
        return g.logits, g.cache

    def _decode_eager(self, cache: Cache, token: torch.Tensor, t: int
                      ) -> Tuple[torch.Tensor, Cache]:
        x = self.embed(token)
        B = x.shape[0]
        positions = torch.full((B, 1), t, device=self.device)
        positions3 = (torch.full((3, B, 1), t, device=self.device)
                      if self.cfg.mrope else None)
        x, cache, _ = self.backbone(x, positions, cache, t, positions3)
        return self.unembed(x), cache

    # ---------------------------------------------------------- decode graph
    def graphs_decode(self) -> bool:
        """Whether ``decode_step`` runs as a CUDA graph: the model is on a
        CUDA device, its plan's cache is recurrent (every layer's entry a
        recurrent state of a fixed size, ``StackPlan.recurrent``: the
        ``ssm`` pattern's), and no parameter is a DTensor (the sharded path
        stays eager).  Read once, and again after ``load_params``."""
        if self._graph_ok is None:
            self._graph_ok = (self.device.type == "cuda"
                              and self.plan.recurrent
                              and not any(is_dtensor(p)
                                          for p in self.parameters()))
        return self._graph_ok

    def _state_dtype(self, x: torch.Tensor) -> torch.dtype:
        """The dtype of a state leaf after a step from ``x``: a conv state
        takes what its concatenation with the activations promotes to, as
        ``decode_step``'s eager path gives it; ``h`` stays f32."""
        return torch.promote_types(x.dtype, self.io["embed"].dtype)

    def _fits(self, cache: Cache, g: "DecodeGraph") -> bool:
        """Whether ``cache`` can be copied into ``g``'s state as the eager
        step would read it: as many layers, and each field of a layer's
        state in the shape and the dtype a step gives its bank."""
        layers = cache["blocks"]
        return len(layers) == len(g.banks[0]) and all(
            x.shape == bank.shape[1:] and self._state_dtype(x) == bank.dtype
            for state in layers for x, bank in zip(state, g.banks))

    def _decode_into(self, token: torch.Tensor, cache: Cache,
                     banks: Tuple[torch.Tensor, ...]) -> torch.Tensor:
        """The step a decode graph holds: the logits of ``token`` (ids on
        the device) from ``cache`` (views of ``banks``), with the new state
        written over the banks."""
        x, new, _ = self.backbone(self.embed(token), None, cache)
        _stack_into(banks, new["blocks"])
        return self.unembed(x)

    def _capture(self, cache: Cache, token: torch.Tensor) -> "DecodeGraph":
        """Capture batch size B's decode graph over static buffers, which
        first hold ``cache`` and ``token`` for the warm-up: the state as
        one bank a field of a layer's state (every layer's conv state in
        one tensor, every layer's ``h`` in another, each in the dtype a
        step gives), and the cache of views of them that ``decode_step``
        returns.  It replaces any graph B had; the model's graphs share one
        memory pool, which goes with the last of them."""
        layers = cache["blocks"]
        banks = tuple(torch.empty((len(layers), *x.shape),
                                  dtype=self._state_dtype(x),
                                  device=self.device) for x in layers[0])
        state = {"blocks": [type(s)(*(bank[i] for bank in banks))
                            for i, s in enumerate(layers)]}
        tok = torch.empty(token.shape, dtype=torch.long, device=self.device)
        tok.copy_(token)
        _stack_into(banks, layers)
        pool = next(iter(self._graphs.values())).graph.pool() \
            if self._graphs else None
        graph, logits = capture(lambda: self._decode_into(tok, state, banks),
                                self.device, pool)
        g = self._graphs[token.shape[0]] = DecodeGraph(graph, tok, banks,
                                                       state, logits)
        return g


class DecodeGraph(NamedTuple):
    """A batch size's decode step as a CUDA graph, and its static buffers,
    which each ``graph.replay()`` reads and rewrites: the token ids (B, 1)
    int64, the state's banks, the cache of views of them (the cache
    ``decode_step`` returns) and the logits."""
    graph: Any
    token: torch.Tensor
    banks: Tuple[torch.Tensor, ...]
    cache: Cache
    logits: torch.Tensor


def _module_tree(node) -> nn.Module:
    """A tree of modules as one: lists as ``nn.ModuleList``s (None as an
    empty one), mappings as ``nn.ModuleDict``s."""
    if isinstance(node, nn.Module):
        return node
    if isinstance(node, dict):
        return nn.ModuleDict({k: _module_tree(v) for k, v in node.items()})
    return nn.ModuleList(_module_tree(v) for v in node or [])


def _stack_into(banks: Tuple[torch.Tensor, ...], layers: list) -> None:
    """Each field of every layer's state into its bank: one stacking copy a
    field, where a copy a leaf would launch one kernel a layer."""
    for f, bank in enumerate(banks):
        torch.stack([state[f] for state in layers], out=bank)


def capture(body: Callable[[], torch.Tensor], device: torch.device, pool
            ) -> Tuple[Any, torch.Tensor]:
    """``body`` run once on a side stream (cuBLAS's handle and workspace
    made, the allocator warm), then captured on that stream into a CUDA
    graph whose memory comes from ``pool`` (a new pool where it is None):
    (the graph, body's output, which each ``replay`` rewrites).  Unlike
    ``torch.cuda.graph``, it leaves the allocator's cache of free blocks as
    it is, so the next prefill finds them there."""
    current = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(current)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        body()
        graph.capture_begin(pool=pool)
        try:
            out = body()
        finally:
            graph.capture_end()
    current.wait_stream(side)
    return graph, out


def set_param(p: nn.Parameter, new: torch.Tensor) -> None:
    """Make ``new`` the value of the parameter ``p`` (which stays the
    module's object, and keeps ``requires_grad``).  ``p.data = new`` does
    so for a plain tensor; a DTensor parameter keeps its old local shard
    under that assignment, so its contents are swapped instead."""
    from torch.distributed.tensor import DTensor
    if not isinstance(p, DTensor):
        p.data = new
        return
    with torch.no_grad():
        torch.utils.swap_tensors(p, nn.Parameter(new.detach(),
                                                 requires_grad=p.requires_grad))


def _sharded_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Rows ``ids`` of a DTensor ``table`` (V, d) that may be split on the
    vocab over some mesh dims (the rules' "vocab" -> "model"): every rank
    looks up the ids its own rows hold and zeros the rest, and the partial
    rows are summed over those dims (exactly one rank adds a row that is
    not zero, so the sum is the row).  This is the vocab-parallel lookup;
    DTensor's own sharding of an index or an ``embedding`` is not there in
    every release (its backward fails in some).  The output is laid out as
    ``ids`` on the other dims."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from repro_torch.kernels import local
    mesh = table.device_mesh
    if not is_dtensor(ids):
        ids = DTensor.from_local(ids, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    split = [i for i, p in enumerate(table.placements) if p == Shard(0)]
    if any(table.placements[i] != Replicate() for i in range(mesh.ndim)
           if i not in split) or any(ids.placements[i] != Replicate()
                                     for i in split):
        raise ValueError(f"a lookup of {ids.placements} ids in a "
                         f"{table.placements} table")
    block = 0                    # this rank's block of rows, mesh order
    for i in split:
        block = block * mesh.size(i) + mesh.get_local_rank(i)
    rows = table.shape[0] // math.prod(mesh.size(i) for i in split)
    out_pl = [Partial() if i in split else ids.placements[i]
              for i in range(mesh.ndim)]

    def body(t, x, v0):
        at = x - v0
        hit = (at >= 0) & (at < t.shape[0])
        return t[torch.where(hit, at, 0)] * hit[..., None]
    return local.run_local(body, (table, ids), (out_pl,), (block * rows,))


# ------------------------------------------------------------------ loss util
def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy of ``logits`` (..., V) at integer ``labels``
    (...), in f32.  The reference picks the label's logit with a one-hot
    product (partition-friendly over a sharded vocab); a gather picks the
    same value, and does so here, except over DTensor logits, which take
    the one-hot product (where(hot, logit, 0) summed: the same value
    again)."""
    lf = logits.float()
    m = torch.amax(lf, dim=-1, keepdim=True)
    lse = torch.log(torch.sum(torch.exp(lf - m), dim=-1)) + m[..., 0]
    labels = labels.long()
    if is_dtensor(lf):
        hot = labels[..., None] == torch.arange(lf.shape[-1],
                                                device=labels.device)
        picked = torch.sum(torch.where(hot, lf, 0.0), dim=-1)
    else:
        picked = torch.gather(lf, -1, labels[..., None])[..., 0]
    return torch.mean(lse - picked)
