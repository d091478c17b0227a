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
* ``mixed`` (a ``MixedConfig``: Jamba): a list of blocks, each a mixer
  (GQA attention or Mamba1) and an FFN (a gated MLP or a mixture of
  experts) as the config's schedule gives them per layer; the cache holds
  a ``KVCache`` or a ``Mamba1State`` by layer.

The reference scans over stacked parameter banks to keep its compiled
graph small; here each layer is an ``nn.Module`` in an ``nn.ModuleList``,
run in a Python loop, and a layer's parameters are the reference's,
unstacked, in its ``(in, out)`` layout.  The parameter tree mirrors the
reference's: ``blocks`` and the MoE ``lead`` are lists of layers;
``groups`` a list of ``{"local": [layers], "global": layer}`` (local_global)
or of lists of layers (hybrid); ``shared`` one block; ``tail`` a list of
layers, or None where there is none, as the reference's ``stack_init``
gives.  Parameters start frozen (``requires_grad=False``), and serving runs
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
beside them.  Caches mirror the parameter tree: ``{"blocks": [per-layer
state]}`` plus ``"lead"``; ``{"groups": [{"local": [...], "global": ...}],
"tail": [...]}``; or ``{"groups": [[...]], "shared": [per call site],
"tail": [...]}``; the mixed pattern's ``blocks`` hold either kind of
state.  KV and MLA caches are written in place (the new entries cast to the
cache's dtype); an SSM layer's state is replaced by the new one each call,
so the conv state takes the dtype its concatenation promotes to, as the
reference's scan output does.  As in the reference, KV and MLA
caches and conv states start as bf16 even for f32 parameters, and ``h`` is
f32.

On the card, the ``ssm`` pattern's decode step is a CUDA graph per batch
size (``decode_step``): its cache is a recurrent state of a fixed size in
every layer, which a step reads and replaces whatever its position, so the
step's shapes and addresses do not depend on ``t``.  Every other pattern
writes its KV caches at the host integer ``t``, and decodes eagerly.
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
from repro_torch.models.config import ModelConfig, option

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
    if option(cfg, "schedule") is not None:
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


def count_mamba1(cfg: ModelConfig) -> int:
    """The layer stack's Mamba1 mixers: a ``mixed`` schedule's "mamba1"
    layers, and every SSM layer of the ``ssm`` and ``hybrid`` patterns
    whose SSM is Mamba1; none elsewhere."""
    schedule = option(cfg, "schedule")
    if schedule is not None:
        return sum(mixer == "mamba1"
                   for mixer, _ in schedule.plan(cfg.n_layers))
    pat = derive_pattern(cfg)
    if pat.kind not in ("ssm", "hybrid") or cfg.ssm.version != 1:
        return 0
    return pat.n_scan + pat.n_groups * pat.group_local + pat.n_tail


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


def init_ssm_layer(gen: torch.Generator, cfg: ModelConfig, dtype) -> dict:
    return {"ln": L.init_rmsnorm(cfg.d_model, dtype, gen.device),
            "ssm": SSM.init_ssm_block(gen, cfg, dtype)}


class SSMLayer(ParamTree):
    """Pre-norm SSM layer (Mamba1 or Mamba2): ``ln``, ``ssm``."""

    def __init__(self, cfg: ModelConfig, params: Mapping[str, Any]):
        super().__init__(params)
        self.cfg = cfg

    def forward(self, x, state=None, return_state=False):
        h = L.rmsnorm(self["ln"], x, self.cfg.norm_eps)
        y, new_state = SSM.ssm_block(self["ssm"], self.cfg, h, state,
                                     return_state)
        return constrain(x + y, ("batch", "seq", None)), new_state


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
        self.pattern = pat = derive_pattern(cfg)
        self.cfg = cfg
        # the Mamba1 mixers a decode step runs, each one conv step and one
        # selective-state step
        self.mamba1_layers = count_mamba1(cfg)
        self.dtype = dtype
        self.remat = remat
        self.device = require_device(device)
        if params is None:
            params = self.init(seed)
        self._check_layers(params)
        self.io = ParamTree({k: v for k, v in params.items()
                             if k not in LAYER_KEYS})
        attn = lambda p: Block(cfg, p)                       # noqa: E731
        ssm = lambda p: SSMLayer(cfg, p)                     # noqa: E731
        self.lead = nn.ModuleList(attn(p) for p in params.get("lead") or [])
        self.blocks = nn.ModuleList(
            (ssm if pat.kind == "ssm" else attn)(p)
            for p in params.get("blocks") or [])
        if pat.kind == "local_global":
            self.groups = nn.ModuleList(nn.ModuleDict({
                "local": nn.ModuleList(attn(p) for p in g["local"]),
                "global": attn(g["global"])}) for g in params["groups"])
        elif pat.kind == "hybrid":
            self.groups = nn.ModuleList(nn.ModuleList(ssm(p) for p in g)
                                        for g in params["groups"])
            self.shared = attn(params["shared"])
        tail = ssm if pat.kind == "hybrid" else attn
        self.tail = nn.ModuleList(tail(p) for p in params.get("tail") or [])
        # the decode graphs by batch size, and whether this model decodes
        # through them (``graphs_decode``)
        self._graphs: Dict[int, DecodeGraph] = {}
        self._graph_ok: Optional[bool] = None
        # the path of the last ``decode_step``: "capture", "replay", "eager"
        self.decode_path: Optional[str] = None

    def _check_layers(self, params: Mapping[str, Any]) -> None:
        """``ValueError`` unless the tree holds the pattern's layers."""
        pat, kind = self.pattern, self.pattern.kind
        n_tail = len(params.get("tail") or [])
        if kind == "mixed":
            have = [("attn" if "attn" in b else "mamba1",
                     "moe" if "moe" in b else "mlp")
                    for b in params.get("blocks") or []]
            got = f"blocks of {have}"
            ok = have == list(self.cfg.layer_plan())
        elif kind in ("local_global", "hybrid"):
            groups = params["groups"]
            per = [len(g["local"] if kind == "local_global" else g)
                   for g in groups]
            got = (f"{len(groups)} groups of {per} and a tail of {n_tail}")
            ok = (len(groups) == pat.n_groups and n_tail == pat.n_tail
                  and all(n == pat.group_local for n in per))
        else:
            n_lead = len(params.get("lead") or [])
            n_blocks = len(params.get("blocks") or [])
            got = f"{n_lead} lead and {n_blocks} blocks"
            ok = (n_lead == pat.n_lead
                  and n_lead + n_blocks == self.cfg.n_layers)
        if not ok:
            raise ValueError(f"{got} for {self.cfg.n_layers} layers "
                             f"({pat})")

    # ------------------------------------------------------------------ init
    def init(self, seed: int) -> dict:
        """A parameter tree drawn from ``torch.Generator(device)`` seeded
        with ``seed``: the reference's shapes, dtypes and scales, not its
        numbers (``jax.random`` draws others).  On the meta device, the
        shapes and dtypes alone."""
        cfg, dtype, pat = self.cfg, self.dtype, self.pattern
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

        def attn(**kw):
            return init_block(gen, cfg, dtype, **kw)

        def ssm():
            return init_ssm_layer(gen, cfg, dtype)

        def stack(n, fn):
            return [fn() for _ in range(n)] or None

        if pat.kind == "ssm":
            p["blocks"] = stack(pat.n_scan, ssm)
        elif pat.kind == "mixed":
            p["blocks"] = [attn(mixer=mixer, use_moe=ffn == "moe")
                           for mixer, ffn in cfg.layer_plan()]
        elif pat.kind == "moe":
            if pat.n_lead:
                p["lead"] = [attn(dense_ff=cfg.moe.d_ff_dense)
                             for _ in range(pat.n_lead)]
            p["blocks"] = stack(pat.n_scan, lambda: attn(use_moe=True))
        elif pat.kind == "local_global":
            p["groups"] = [{"local": stack(pat.group_local, attn),
                            "global": attn()} for _ in range(pat.n_groups)]
            p["tail"] = stack(pat.n_tail, attn)
        elif pat.kind == "hybrid":
            p["groups"] = [stack(pat.group_local, ssm)
                           for _ in range(pat.n_groups)]
            p["shared"] = attn()
            p["tail"] = stack(pat.n_tail, ssm)
        else:
            p["blocks"] = stack(pat.n_scan, attn)
        return p

    def _trees(self, of) -> dict:
        out = dict(of(self.io))
        kind = self.pattern.kind
        if self.pattern.n_lead:
            out["lead"] = [of(b) for b in self.lead]
        if kind == "local_global":
            out["groups"] = [{"local": [of(b) for b in g["local"]],
                              "global": of(g["global"])}
                             for g in self.groups]
        elif kind == "hybrid":
            out["groups"] = [[of(b) for b in g] for g in self.groups]
            out["shared"] = of(self.shared)
        else:
            out["blocks"] = [of(b) for b in self.blocks] or None
        if kind in ("local_global", "hybrid"):
            out["tail"] = [of(b) for b in self.tail] or None
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
    def _attn_cache(self, batch: int, max_seq: int):
        cfg, dev = self.cfg, self.device

        def zeros(*shape):
            return torch.zeros(shape, dtype=torch.bfloat16, device=dev)
        if cfg.mla is not None:
            return L.MLACache(zeros(batch, max_seq, cfg.mla.kv_lora_rank),
                              zeros(batch, max_seq, cfg.mla.qk_rope_head_dim))
        shape = (batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
        return L.KVCache(zeros(*shape), zeros(*shape))

    def _ssm_state(self, batch: int):
        s, dev = self.cfg.ssm, self.device
        d_in = s.expand * self.cfg.d_model
        if s.version == 1:
            conv, h = d_in, (d_in, s.d_state)
            state = SSM.Mamba1State
        else:
            conv = d_in + 2 * s.n_groups * s.d_state
            h = (d_in // s.headdim, s.headdim, s.d_state)
            state = SSM.Mamba2State
        return state(
            torch.zeros((batch, s.d_conv - 1, conv), dtype=torch.bfloat16,
                        device=dev),
            torch.zeros((batch, *h), dtype=torch.float32, device=dev))

    def init_cache(self, batch: int, max_seq: int) -> Cache:
        """Zero caches for ``batch`` sequences of up to ``max_seq``
        positions; a windowed layer's ring holds min(window, max_seq)."""
        cfg, pat = self.cfg, self.pattern

        def kv(n, seq=max_seq):
            return [self._attn_cache(batch, seq) for _ in range(n)]

        def ssm(n):
            return [self._ssm_state(batch) for _ in range(n)]

        c: Cache = {}
        if pat.kind == "ssm":
            c["blocks"] = ssm(pat.n_scan)
        elif pat.kind == "mixed":
            c["blocks"] = [self._attn_cache(batch, max_seq) if mixer == "attn"
                           else self._ssm_state(batch)
                           for mixer, _ in cfg.layer_plan()]
        elif pat.kind == "local_global":
            w = min(cfg.sliding_window or max_seq, max_seq)
            c["groups"] = [{"local": kv(pat.group_local, w),
                            "global": self._attn_cache(batch, max_seq)}
                           for _ in range(pat.n_groups)]
            if pat.n_tail:
                c["tail"] = kv(pat.n_tail, w)
        elif pat.kind == "hybrid":
            c["groups"] = [ssm(pat.group_local) for _ in range(pat.n_groups)]
            c["shared"] = kv(pat.n_groups)
            if pat.n_tail:
                c["tail"] = ssm(pat.n_tail)
        else:
            c["blocks"] = kv(pat.n_scan)
            if pat.n_lead:
                c["lead"] = kv(pat.n_lead)
        return c

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
        ``positions3`` reaches the attention layers of the uniform_attn and
        moe patterns, as in the reference."""
        cfg, kind = self.cfg, self.pattern.kind
        serving = cache is not None
        remat = self.remat and not serving and torch.is_grad_enabled()
        aux = torch.zeros((), dtype=torch.float32, device=self.device)
        new_cache: Cache = {}

        def run(block, *args):
            if remat:
                return checkpoint(block, *args, use_reentrant=False)
            return block(*args)

        def attn(block, x, state, window, p3=None):
            nonlocal aux
            x, state, a = run(block, x, positions, state, t, window, p3)
            if a is not None:
                aux = aux + a
            return x, state

        def ssm(block, x, state):
            return run(block, x, state)

        def stack(blocks, layer, caches):
            nonlocal x
            states = []
            for i, block in enumerate(blocks):
                x, state = layer(block, x, caches[i] if serving else None)
                states.append(state)
            return states

        def cached(*path):
            node = cache
            for key in path:
                node = node[key] if serving else None
            return node

        if kind == "mixed":
            new_cache["blocks"] = stack(
                self.blocks, lambda b, x, s: attn(b, x, s, None),
                cached("blocks"))
        elif kind in ("uniform_attn", "moe"):
            for name, window in (("lead", None),
                                 ("blocks", cfg.sliding_window)):
                blocks = getattr(self, name)
                if len(blocks):
                    new_cache[name] = stack(
                        blocks, lambda b, x, s, w=window: attn(
                            b, x, s, w, positions3), cached(name))
        elif kind == "ssm":
            new_cache["blocks"] = stack(self.blocks, ssm, cached("blocks"))
        elif kind == "local_global":
            w = cfg.sliding_window
            local = lambda b, x, s: attn(b, x, s, w)          # noqa: E731
            groups = []
            for i, g in enumerate(self.groups):
                states = stack(g["local"], local, cached("groups", i,
                                                         "local"))
                x, state = attn(g["global"], x, cached("groups", i,
                                                       "global"), None)
                groups.append({"local": states, "global": state})
            new_cache["groups"] = groups
            if len(self.tail):
                new_cache["tail"] = stack(self.tail, local, cached("tail"))
        elif kind == "hybrid":
            groups, shared = [], []
            for i, g in enumerate(self.groups):
                groups.append(stack(g, ssm, cached("groups", i)))
                x, state = attn(self.shared, x, cached("shared", i), None)
                shared.append(state)
            new_cache.update(groups=groups, shared=shared)
            if len(self.tail):
                new_cache["tail"] = stack(self.tail, ssm, cached("tail"))
        x = L.rmsnorm(self.io["final_norm"], x, cfg.norm_eps)
        return x, (new_cache if serving else None), aux

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
        CUDA device, its pattern is ``ssm`` (every layer's cache entry is a
        recurrent state of a fixed size), and no parameter is a DTensor (the
        sharded path stays eager).  Read once, and again after
        ``load_params``."""
        if self._graph_ok is None:
            self._graph_ok = (self.device.type == "cuda"
                              and self.pattern.kind == "ssm"
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
