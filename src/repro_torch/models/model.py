"""Decoder LM: init, forward, loss, prefill, decode.

A port of the JAX package's ``models/model.py`` for three of its layer
patterns (``derive_pattern``):

* ``uniform_attn`` with plain GQA attention (smollm-135m, qwen3-14b with
  qk-norm, starcoder2-15b);
* ``moe``: ``n_lead`` dense blocks (FFN width ``d_ff_dense``), then blocks
  whose FFN is a mixture of experts, with GQA attention (qwen3-moe-30b-a3b)
  or Multi-head Latent Attention (deepseek-v2-lite-16b);
* ``ssm`` with Mamba1 layers (falcon-mamba-7b).

Every other pattern or option raises ``NotImplementedError`` naming the
ROADMAP item that ports it.  The reference scans over stacked parameter
banks to keep its compiled graph small; here each layer is an ``nn.Module``
in an ``nn.ModuleList``, run in a Python loop, and a layer's parameters are
the reference's, unstacked, in its ``(in, out)`` layout.  The lead blocks
are a plain list in the reference too (``params["lead"]``).  Parameters
start frozen (``requires_grad=False``), and serving runs under
``no_grad``.  A trainer calls ``requires_grad_()`` and differentiates
``loss_fn``: the kernels' ops then go through their ``autograd.Function``s,
whose backward is eager PyTorch.  ``load_params`` writes a parameter tree
into the model (the optimizer's new bf16 params, a restored checkpoint),
leaf dtypes included.  ``remat`` recomputes each block in the backward pass
(``torch.utils.checkpoint``), as the reference's per-layer
``jax.checkpoint`` does in its train mode.

Caches are ``{"blocks": [per-layer state]}``, plus ``"lead"`` for the lead
blocks.  KV and MLA caches are written in place (the new entries cast to
the cache's dtype); a Mamba1 layer's state is replaced by the new one each
call, so the conv state takes the dtype its concatenation promotes to, as
the reference's scan output does.  As in the reference, KV and MLA caches
and conv states start as bf16 even for f32 parameters, and ``h`` is f32.
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, NamedTuple, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import tree as T
from repro_torch.kernels.device import Device, require_device
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.models.config import ModelConfig

Cache = Dict[str, List[Any]]


# ===================================================================== pattern
class Pattern(NamedTuple):
    """Static description of the layer stack (derived from cfg)."""
    kind: str            # uniform_attn | local_global | moe | ssm | hybrid
    n_scan: int          # layers in the main bank
    n_lead: int = 0
    n_groups: int = 0
    group_local: int = 0  # local layers per group / ssm layers per group
    n_tail: int = 0


def derive_pattern(cfg: ModelConfig) -> Pattern:
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


def check_ported(cfg: ModelConfig) -> Pattern:
    """The config's pattern, or ``NotImplementedError`` naming the ROADMAP
    item (Queue A, step 7) that ports what it needs."""
    pat = derive_pattern(cfg)
    missing = []
    if pat.kind not in ("uniform_attn", "moe", "ssm"):
        missing.append({"local_global": "local_global and ring caches",
                        "hybrid": "hybrid and Mamba2"}[pat.kind])
    if cfg.ssm is not None and cfg.ssm.version != 1:
        missing.append("Mamba2")
    if cfg.mrope:
        missing.append("M-RoPE and frontends")
    if cfg.n_codebooks > 1:
        missing.append("multiple codebooks")
    if not cfg.embed_inputs:
        missing.append("embed_inputs=False (frontends)")
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} not ported yet (ROADMAP "
            f"Queue A, step 7); the port runs the uniform_attn (GQA), moe "
            f"(GQA or MLA attention) and ssm (Mamba1) patterns")
    return pat


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


def init_attn_block(gen: torch.Generator, cfg: ModelConfig, dtype,
                    use_moe: bool = False, dense_ff: int = 0) -> dict:
    p = {"ln1": L.init_rmsnorm(cfg.d_model, dtype, gen.device),
         "ln2": L.init_rmsnorm(cfg.d_model, dtype, gen.device),
         "attn": (L.init_mla(gen, cfg, dtype) if cfg.mla is not None
                  else L.init_attention(gen, cfg, dtype))}
    if use_moe:
        p["moe"] = MOE.init_moe(gen, cfg, dtype)
    else:
        p["mlp"] = L.init_mlp(gen, cfg.d_model, dense_ff or cfg.d_ff, dtype)
    return p


class AttnBlock(ParamTree):
    """Pre-norm transformer block: ``ln1``, ``attn`` (GQA or MLA), ``ln2``,
    then ``mlp`` or ``moe``.  Returns (x, new cache, aux loss), the aux loss
    None for an MLP block (the reference's 0)."""

    def __init__(self, cfg: ModelConfig, params: Mapping[str, Any]):
        super().__init__(params)
        self.cfg = cfg

    def forward(self, x, positions, cache=None, cache_index=None,
                window=None):
        cfg = self.cfg
        h = L.rmsnorm(self["ln1"], x, cfg.norm_eps)
        if cfg.mla is not None:
            a, new_cache = L.mla_attention(self["attn"], cfg, h, positions,
                                           cache, cache_index)
        else:
            a, new_cache = L.attention(self["attn"], cfg, h, positions,
                                       cache, cache_index, window)
        x = x + a
        h = L.rmsnorm(self["ln2"], x, cfg.norm_eps)
        if "moe" in self._modules:
            f, aux = MOE.moe_forward(self["moe"], cfg, h)
        else:
            f, aux = L.mlp(self["mlp"], h), None
        return x + f, new_cache, aux


def init_ssm_layer(gen: torch.Generator, cfg: ModelConfig, dtype) -> dict:
    return {"ln": L.init_rmsnorm(cfg.d_model, dtype, gen.device),
            "ssm": SSM.init_mamba1(gen, cfg, dtype)}


class SSMLayer(ParamTree):
    """Pre-norm Mamba1 layer: ``ln``, ``ssm``."""

    def __init__(self, cfg: ModelConfig, params: Mapping[str, Any]):
        super().__init__(params)
        self.cfg = cfg

    def forward(self, x, state=None, return_state=False):
        h = L.rmsnorm(self["ln"], x, self.cfg.norm_eps)
        y, new_state = SSM.mamba1_block(self["ssm"], self.cfg, h, state,
                                        return_state)
        return x + y, new_state


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
        self.pattern = check_ported(cfg)
        self.cfg = cfg
        self.dtype = dtype
        self.remat = remat
        self.device = require_device(device)
        if params is None:
            params = self.init(seed)
        lead = params.get("lead") or []
        if (len(lead) != self.pattern.n_lead
                or len(lead) + len(params["blocks"]) != cfg.n_layers):
            raise ValueError(f"{len(lead)} lead and {len(params['blocks'])} "
                             f"blocks for {cfg.n_layers} layers "
                             f"({self.pattern.n_lead} lead)")
        self.io = ParamTree({k: v for k, v in params.items()
                             if k not in ("blocks", "lead")})
        self.lead = nn.ModuleList(AttnBlock(cfg, p) for p in lead)
        block = SSMLayer if self.pattern.kind == "ssm" else AttnBlock
        self.blocks = nn.ModuleList(block(cfg, p) for p in params["blocks"])

    # ------------------------------------------------------------------ init
    def init(self, seed: int) -> dict:
        """A parameter tree drawn from ``torch.Generator(device)`` seeded
        with ``seed``: the reference's shapes, dtypes and scales, not its
        numbers (``jax.random`` draws others)."""
        cfg, dtype, pat = self.cfg, self.dtype, self.pattern
        gen = torch.Generator(device=self.device).manual_seed(seed)
        p: Dict[str, Any] = {
            "embed": L._dense_init(gen, (cfg.vocab_size, cfg.d_model), dtype,
                                   scale=0.02),
            "final_norm": L.init_rmsnorm(cfg.d_model, dtype, self.device)}
        if not cfg.tie_embeddings:
            p["lm_head"] = L._dense_init(gen, (cfg.d_model, cfg.vocab_size),
                                         dtype)
        if pat.kind == "ssm":
            p["blocks"] = [init_ssm_layer(gen, cfg, dtype)
                           for _ in range(pat.n_scan)]
        elif pat.kind == "moe":
            if pat.n_lead:
                p["lead"] = [init_attn_block(gen, cfg, dtype,
                                             dense_ff=cfg.moe.d_ff_dense)
                             for _ in range(pat.n_lead)]
            p["blocks"] = [init_attn_block(gen, cfg, dtype, use_moe=True)
                           for _ in range(pat.n_scan)]
        else:
            p["blocks"] = [init_attn_block(gen, cfg, dtype)
                           for _ in range(pat.n_scan)]
        return p

    def _trees(self, of) -> dict:
        out = dict(of(self.io))
        if self.pattern.n_lead:
            out["lead"] = [of(b) for b in self.lead]
        out["blocks"] = [of(b) for b in self.blocks]
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
        the reference."""
        got, want = T.leaves(params), T.leaves(self.parameter_tree())
        if len(got) != len(want):
            raise ValueError(f"{len(got)} leaves for a model of "
                             f"{len(want)}")
        for p, new in zip(want, got):
            if tuple(new.shape) != tuple(p.shape):
                raise ValueError(f"a leaf of shape {tuple(new.shape)} for a "
                                 f"parameter of {tuple(p.shape)}")
            p.data = new.to(self.device)

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

    def init_cache(self, batch: int, max_seq: int) -> Cache:
        cfg, dev, pat = self.cfg, self.device, self.pattern
        if pat.kind != "ssm":
            c = {"blocks": [self._attn_cache(batch, max_seq)
                            for _ in range(pat.n_scan)]}
            if pat.n_lead:
                c["lead"] = [self._attn_cache(batch, max_seq)
                             for _ in range(pat.n_lead)]
            return c
        s = cfg.ssm
        d_in = s.expand * cfg.d_model
        return {"blocks": [
            SSM.Mamba1State(
                torch.zeros((batch, s.d_conv - 1, d_in), dtype=torch.bfloat16,
                            device=dev),
                torch.zeros((batch, d_in, s.d_state), dtype=torch.float32,
                            device=dev))
            for _ in range(pat.n_scan)]}

    # ------------------------------------------------------------- embedding
    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.io["embed"][tokens.to(self.device, torch.long)]

    def unembed(self, x: torch.Tensor) -> torch.Tensor:
        if self.cfg.tie_embeddings:
            return x @ self.io["embed"].T
        return x @ self.io["lm_head"]

    # ------------------------------------------------------------- backbone
    def backbone(self, x: torch.Tensor, positions: torch.Tensor,
                 cache: Optional[Cache] = None, t: Optional[int] = None
                 ) -> Tuple[torch.Tensor, Optional[Cache], torch.Tensor]:
        """The layer stack and the final norm: (x, the new cache, the sum of
        the MoE blocks' aux losses, f32).  Without a cache, the forward over
        positions arange(T); with one, serving from position ``t``."""
        serving = cache is not None
        remat = self.remat and not serving and torch.is_grad_enabled()
        aux = torch.zeros((), dtype=torch.float32, device=self.device)
        new_cache: Cache = {}

        def run(block, *args):
            if remat:
                return checkpoint(block, *args, use_reentrant=False)
            return block(*args)

        for name, stack, window in (("lead", self.lead, None),
                                    ("blocks", self.blocks,
                                     self.cfg.sliding_window)):
            if not len(stack):
                continue
            states = []
            for i, block in enumerate(stack):
                state = cache[name][i] if serving else None
                if self.pattern.kind == "ssm":
                    x, state = run(block, x, state)
                else:
                    x, state, a = run(block, x, positions, state, t, window)
                    if a is not None:
                        aux = aux + a
                states.append(state)
            new_cache[name] = states
        x = L.rmsnorm(self.io["final_norm"], x, self.cfg.norm_eps)
        return x, (new_cache if serving else None), aux

    @torch.no_grad()
    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """Logits (B, T, V) of the full causal forward over tokens (B, T)."""
        x = self.embed(tokens)
        B, T = x.shape[:2]
        positions = torch.arange(T, device=self.device)[None].expand(B, T)
        x, _, _ = self.backbone(x, positions)
        return self.unembed(x)

    # ------------------------------------------------------------------ loss
    def loss_fn(self, batch: Mapping[str, Any], aux_weight: float = 0.01
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(loss, {"ce", "aux"}) of ``batch`` ({"tokens", "labels"}, (B, T)
        integers): the mean cross-entropy of the causal forward, plus
        ``aux_weight`` times the MoE blocks' summed load-balancing loss (0
        without MoE).  Differentiable where grad is enabled."""
        x = self.embed(torch.as_tensor(batch["tokens"]))
        B, T = x.shape[:2]
        positions = torch.arange(T, device=self.device)[None].expand(B, T)
        x, _, aux = self.backbone(x, positions)
        logits = self.unembed(x)
        labels = torch.as_tensor(batch["labels"]).to(self.device)
        ce = softmax_xent(logits, labels)
        loss = ce + aux_weight * aux
        return loss, {"ce": ce, "aux": aux}

    # --------------------------------------------------------------- serving
    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, cache: Cache
                ) -> Tuple[torch.Tensor, Cache]:
        """Run the prompt (B, T) through the model, writing the cache at
        positions 0..T-1; the last position's logits (B, 1, V)."""
        x = self.embed(tokens)
        B, T = x.shape[:2]
        positions = torch.arange(T, device=self.device)[None].expand(B, T)
        x, cache, _ = self.backbone(x, positions, cache, 0)
        return self.unembed(x[:, -1:]), cache

    @torch.no_grad()
    def decode_step(self, cache: Cache, token: torch.Tensor, t: int
                    ) -> Tuple[torch.Tensor, Cache]:
        """token: (B, 1) at position ``t``; logits (B, 1, V)."""
        x = self.embed(token)
        positions = torch.full((x.shape[0], 1), t, device=self.device)
        x, cache, _ = self.backbone(x, positions, cache, t)
        return self.unembed(x), cache


# ------------------------------------------------------------------ loss util
def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy of ``logits`` (..., V) at integer ``labels``
    (...), in f32.  The reference picks the label's logit with a one-hot
    product (partition-friendly over a sharded vocab); a gather picks the
    same value."""
    lf = logits.float()
    m = torch.amax(lf, dim=-1, keepdim=True)
    lse = torch.log(torch.sum(torch.exp(lf - m), dim=-1)) + m[..., 0]
    picked = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    return torch.mean(lse - picked)
