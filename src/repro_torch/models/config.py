"""Unified model configuration covering all assigned architectures.

One dataclass describes every architecture in the pool (dense GQA, MLA+MoE,
sliding-window/global hybrids, Mamba1/2 SSMs, Zamba2-style shared-attention
hybrids, multi-codebook audio LMs, M-RoPE VLM backbones).  The block pattern is
derived from the config; models are built by ``repro_torch.models.model``.

The fields of ``ModelConfig``, ``SSMConfig`` and ``MoEConfig`` mirror the JAX
package's, key for key.  The port's own options live on subclasses:
``MixedConfig`` (a per-layer schedule of mixer and FFN, Jamba's, or a
per-block list of single sublayers read from a pattern string; its
attention has no rotary embedding), ``SSMNormConfig`` (Mamba1 with an
RMSNorm over dt, B and C), ``Mamba2HeadsConfig`` (Mamba2 whose inner width
is its head count times the head dim, with a gated RMSNorm a group) and
``SigmoidMoEConfig`` (a sigmoid router with a selection bias over
non-gated relu² experts).  The modules read them through ``option``,
which gives their off values for every other config, the JAX package's
included.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, ClassVar, Optional, Tuple


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2)."""
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    q_lora_rank: Optional[int] = None  # V2-Lite: no q compression


@dataclass(frozen=True)
class MoEConfig:
    n_routed: int = 64
    top_k: int = 6
    n_shared: int = 0              # shared (always-on) experts
    d_ff_expert: int = 1408
    capacity_factor: Optional[float] = 1.25   # None: dropless
    first_dense_layers: int = 0    # leading dense layers (deepseek-v2)
    d_ff_dense: int = 0            # ffn width of those dense layers
    router_norm_topk: bool = True  # normalize top-k weights to sum to 1


@dataclass(frozen=True)
class SSMConfig:
    version: int = 1               # 1 = Mamba (S6), 2 = Mamba2 (SSD)
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    headdim: int = 64              # mamba2 only
    n_groups: int = 1              # mamba2 B/C groups
    chunk: int = 256               # SSD chunk length


@dataclass(frozen=True)
class SSMNormConfig(SSMConfig):
    """Mamba1 whose dt, B and C pass an RMSNorm (eps ``norm_eps``, scales of
    widths dt rank, d_state and d_state) between ``x_proj`` and their use,
    dt before ``dt_proj`` (Jamba's mixer)."""
    dt_bc_norm: ClassVar[bool] = True


@dataclass(frozen=True)
class Mamba2HeadsConfig(SSMConfig):
    """Mamba2 of ``mamba_heads`` heads of ``headdim``: its inner width is
    their product, not ``expand`` times d; the gated RMSNorm after the SSD
    (``y * silu(z)``, then the norm) runs over each of the ``n_groups``
    groups of channels on its own."""
    mamba_heads: int = 0
    group_norm: ClassVar[bool] = True


@dataclass(frozen=True)
class SigmoidMoEConfig(MoEConfig):
    """Experts chosen by a sigmoid router: the top k of ``sigmoid(logits) +
    score_bias`` (a per-expert f32 vector that picks, and weighs nothing),
    weighted by their unbiased scores (renormalised to sum 1 where
    ``router_norm_topk`` holds) times ``routed_scaling``.  Each expert, and
    the shared one of width ``d_ff_shared``, is non-gated:
    ``down(relu(up(h))^2)``."""
    routed_scaling: float = 1.0
    d_ff_shared: int = 0
    sigmoid_router: ClassVar[bool] = True
    relu2: ClassVar[bool] = True


@dataclass(frozen=True)
class HybridConfig:
    """Zamba2-style weight-shared attention block interleaved with SSM layers."""
    shared_attn_every: int = 6     # invoke the shared block after every N ssm layers


@dataclass(frozen=True)
class ScheduleConfig:
    """Each layer's mixer and FFN by period and offset (the rule of the HF
    ``JambaConfig``): layer i mixes by attention where ``i % attn_period ==
    attn_offset`` and by Mamba1 elsewhere; its FFN is a mixture of experts
    where ``i % expert_period == expert_offset`` and a dense MLP elsewhere."""
    attn_period: int
    attn_offset: int
    expert_period: int
    expert_offset: int

    def plan(self, n_layers: int) -> Tuple[Tuple[str, str], ...]:
        """(mixer, ffn) of each layer: mixer "attn" or "mamba1", ffn "moe"
        or "mlp"."""
        return tuple(
            ("attn" if i % self.attn_period == self.attn_offset else "mamba1",
             "moe" if i % self.expert_period == self.expert_offset else "mlp")
            for i in range(n_layers))


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    # --- attention options -------------------------------------------------
    rope_theta: float = 10000.0
    qk_norm: bool = False
    sliding_window: Optional[int] = None      # window size for local layers
    local_global_ratio: int = 0               # N local : 1 global (0 = all global)
    mla: Optional[MLAConfig] = None
    mrope: bool = False                       # 3-section M-RoPE (qwen2-vl)
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)
    # --- mixture / ssm / hybrid -------------------------------------------
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid: Optional[HybridConfig] = None
    # --- io ----------------------------------------------------------------
    n_codebooks: int = 1                      # musicgen: 4 parallel EnCodec books
    tie_embeddings: bool = False
    embed_inputs: bool = True                 # False -> frontend supplies embeddings
    # --- numerics / misc ----------------------------------------------------
    norm_eps: float = 1e-5
    max_seq_len: int = 8192
    subquadratic: bool = False                # eligible for long_500k decode
    notes: str = ""

    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    # ------------------------------------------------------------------ util
    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer block kinds, length n_layers.

        Kinds: 'attn' (global), 'local' (sliding window), 'ssm', 'shared_attn'
        (zamba2 shared block call-site marker — not counted in n_layers; see
        blocks.py which inserts call-sites between ssm layers).
        """
        if self.family == "ssm":
            return ("ssm",) * self.n_layers
        if self.hybrid is not None:
            return ("ssm",) * self.n_layers
        if self.local_global_ratio > 0:
            r = self.local_global_ratio
            kinds = []
            for i in range(self.n_layers):
                kinds.append("attn" if (i % (r + 1)) == r else "local")
            return tuple(kinds)
        return ("attn",) * self.n_layers

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # Reduced config of the same family for CPU smoke tests.
    def smoke(self) -> "ModelConfig":
        kw = dict(
            n_layers=min(self.n_layers, 4),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(4, max(1, self.n_kv_heads // max(1, self.n_heads // 4))) if self.n_kv_heads else 0,
            head_dim=32,
            d_ff=256,
            vocab_size=512,
            max_seq_len=128,
        )
        if self.local_global_ratio > 0:
            kw["n_layers"] = self.local_global_ratio + 1  # one full pattern group
            kw["sliding_window"] = 16
        if self.moe is not None:
            kw["moe"] = dataclasses.replace(
                self.moe, n_routed=8, top_k=2,
                d_ff_expert=64,
                d_ff_dense=128 if self.moe.d_ff_dense else 0)
        if self.ssm is not None:
            kw["ssm"] = dataclasses.replace(self.ssm, d_state=8, headdim=16, chunk=32)
        if self.hybrid is not None:
            kw["n_layers"] = 4
            kw["hybrid"] = dataclasses.replace(self.hybrid, shared_attn_every=2)
        if self.mla is not None:
            kw["mla"] = dataclasses.replace(
                self.mla, kv_lora_rank=64, qk_nope_head_dim=32,
                qk_rope_head_dim=16, v_head_dim=32)
        if self.mrope:
            hd2 = kw["head_dim"] // 2
            s = hd2 // 4
            kw["mrope_sections"] = (hd2 - 2 * s, s, s)
        return self.with_(**kw, name=self.name + "-smoke")


@dataclass(frozen=True)
class MixedConfig(ModelConfig):
    """A stack of pre-norm layers, in one of two layouts.  By ``schedule``
    (Jamba) each layer pairs a mixer with an FFN: ``x += mixer(rmsnorm(x));
    x += ffn(rmsnorm(x))``, the mixer GQA attention or Mamba1 (``ssm``),
    the FFN a gated MLP of width ``d_ff`` or the experts of ``moe``.  By
    ``blocks`` (a kind a block, "mamba2", "attn" or "moe", as a hybrid
    pattern string such as "MEM*E" spells them) each block is one
    sublayer, ``x += sub(rmsnorm(x))``: Mamba2 (``ssm``), GQA attention or
    the experts of ``moe``.  The attention has no positional encoding."""
    schedule: Optional[ScheduleConfig] = None
    blocks: Optional[Tuple[str, ...]] = None
    use_rope: ClassVar[bool] = False

    def layer_plan(self) -> Tuple[Tuple[Optional[str], Optional[str]], ...]:
        """(mixer, ffn) of each layer: a mixer "attn", "mamba1" or "mamba2"
        or None, an FFN "moe" or "mlp" or None (a block of one sublayer
        has one of the two)."""
        if self.blocks is not None:
            return tuple((None, k) if k == "moe" else (k, None)
                         for k in self.blocks)
        return self.schedule.plan(self.n_layers)

    def layer_kinds(self) -> Tuple[str, ...]:
        return tuple("attn" if m == "attn" else "moe" if m is None
                     else "ssm" for m, _ in self.layer_plan())


# the port's own options at their off values: what ``option`` gives for a
# config whose class lacks them
_OFF = {"schedule": None, "blocks": None, "use_rope": True,
        "dt_bc_norm": False, "mamba_heads": 0, "group_norm": False,
        "sigmoid_router": False, "relu2": False, "routed_scaling": 1.0,
        "d_ff_shared": 0}


def option(cfg: Any, name: str) -> Any:
    """The port-only option ``name`` of ``cfg`` (a ``ModelConfig`` for
    ``schedule``, ``blocks`` and ``use_rope``, an ``SSMConfig`` for
    ``dt_bc_norm``, ``mamba_heads`` and ``group_norm``, a ``MoEConfig`` for
    ``sigmoid_router``, ``relu2``, ``routed_scaling`` and ``d_ff_shared``),
    or its off value where the config's class has no such option."""
    return getattr(cfg, name, _OFF[name])


def mamba2_heads(cfg: ModelConfig) -> Tuple[int, int]:
    """(inner width, heads) of the config's Mamba2: ``mamba_heads`` heads
    of ``headdim`` where the option is set, else ``expand`` times d cut
    into heads of ``headdim``."""
    s = cfg.ssm
    H = option(s, "mamba_heads") or s.expand * cfg.d_model // s.headdim
    return H * s.headdim, H


def is_mixed(cfg: ModelConfig) -> bool:
    """Whether the config lays its stack out by a ``schedule`` or by
    ``blocks`` (the mixed pattern)."""
    return option(cfg, "schedule") is not None \
        or option(cfg, "blocks") is not None


def param_count(cfg: ModelConfig) -> Tuple[int, int]:
    """(total_params, active_params) — analytic, for roofline MODEL_FLOPS."""
    if is_mixed(cfg):
        return _mixed_param_count(cfg)
    d = cfg.d_model
    total = 0
    active = 0
    # embeddings
    # the token embedding exists even for stub-frontend archs (decode path)
    emb = cfg.vocab_size * d * cfg.n_codebooks
    unemb = 0 if cfg.tie_embeddings else cfg.vocab_size * d * cfg.n_codebooks
    total += emb + unemb
    active += emb + unemb

    def attn_params() -> int:
        if cfg.mla is not None:
            m = cfg.mla
            qk_hd = m.qk_nope_head_dim + m.qk_rope_head_dim
            p = d * cfg.n_heads * qk_hd                       # W_q
            p += d * (m.kv_lora_rank + m.qk_rope_head_dim)    # W_dkv (+ rope k)
            p += m.kv_lora_rank * cfg.n_heads * (m.qk_nope_head_dim + m.v_head_dim)
            p += cfg.n_heads * m.v_head_dim * d               # W_o
            return p
        hd = cfg.head_dim
        return d * hd * (cfg.n_heads * 2 + cfg.n_kv_heads * 2)

    def mlp_params(ff: int) -> int:
        return 3 * d * ff  # gated (SwiGLU): up, gate, down

    def ssm_params() -> int:
        s = cfg.ssm
        d_in = s.expand * d
        if s.version == 1:
            dt_rank = max(1, d // 16)
            p = d * 2 * d_in                    # in_proj (x, z)
            p += s.d_conv * d_in                # conv
            p += d_in * (dt_rank + 2 * s.d_state)  # x -> (dt, B, C)
            p += dt_rank * d_in                 # dt_proj
            p += d_in * s.d_state               # A
            p += d_in                           # D
            p += d_in * d                       # out_proj
            return p
        nheads = d_in // s.headdim
        conv_dim = d_in + 2 * s.n_groups * s.d_state
        p = d * (2 * d_in + 2 * s.n_groups * s.d_state + nheads)  # in_proj
        p += s.d_conv * conv_dim
        p += nheads * 2                         # A, D
        p += d_in * d                           # out_proj
        return p

    kinds = cfg.layer_kinds()
    for k in kinds:
        if k in ("attn", "local"):
            total += attn_params()
            active += attn_params()
        elif k == "ssm":
            total += ssm_params()
            active += ssm_params()
    # MLP / MoE per layer (attention archs only; ssm archs have no separate mlp)
    for i, k in enumerate(kinds):
        if k == "ssm":
            continue
        if cfg.moe is not None and i >= cfg.moe.first_dense_layers:
            m = cfg.moe
            routed = m.n_routed * 3 * d * m.d_ff_expert
            shared = m.n_shared * 3 * d * m.d_ff_expert
            router = d * m.n_routed
            total += routed + shared + router
            active += (m.top_k + m.n_shared) * 3 * d * m.d_ff_expert + router
        elif cfg.moe is not None:
            total += mlp_params(cfg.moe.d_ff_dense)
            active += mlp_params(cfg.moe.d_ff_dense)
        else:
            total += mlp_params(cfg.d_ff)
            active += mlp_params(cfg.d_ff)
    # zamba2 shared attention+mlp block (one set of weights)
    if cfg.hybrid is not None:
        shared = attn_params() + mlp_params(cfg.d_ff)
        total += shared
        n_sites = cfg.n_layers // cfg.hybrid.shared_attn_every
        active += shared * max(1, n_sites)  # executed at every call-site
    # final norm ~ negligible
    return total, active


def _mixed_param_count(cfg: MixedConfig) -> Tuple[int, int]:
    """``param_count`` of a ``MixedConfig``, leaf for leaf as the port's
    tree holds it: every norm scale (one a sublayer), Mamba1's conv bias
    and dt bias, Mamba2's conv biases, dt bias, A, D and norm, and the
    router and its selection bias counted; the active count takes the top-k
    experts of each MoE."""
    d, V, hd = cfg.d_model, cfg.vocab_size, cfg.head_dim
    s, m = cfg.ssm, cfg.moe

    def mamba(version: int) -> int:
        if version == 2:
            d_in, H = mamba2_heads(cfg)
            conv = d_in + 2 * s.n_groups * s.d_state
            return (d * (d_in + conv + H) + (s.d_conv + 1) * conv + 3 * H
                    + d_in + d_in * d)
        d_in = s.expand * d
        r = max(1, d // 16)
        p = (2 * d * d_in + (s.d_conv + 1) * d_in
             + d_in * (r + 2 * s.d_state) + r * d_in + d_in
             + d_in * s.d_state + d_in + d_in * d)
        return p + (r + 2 * s.d_state if option(s, "dt_bc_norm") else 0)
    attn = d * hd * (2 * cfg.n_heads + 2 * cfg.n_kv_heads)
    total = active = V * d * (1 if cfg.tie_embeddings else 2) + d
    for mixer, ffn in cfg.layer_plan():
        sub = d * ((mixer is not None) + (ffn is not None))
        if mixer is not None:
            sub += attn if mixer == "attn" else mamba(int(mixer[-1]))
        total += sub
        active += sub
        if ffn == "moe":
            mats = 2 if option(m, "relu2") else 3
            expert = mats * d * m.d_ff_expert
            shared = mats * d * (option(m, "d_ff_shared")
                                 or m.n_shared * m.d_ff_expert)
            router = d * m.n_routed + (m.n_routed if option(
                m, "sigmoid_router") else 0)
            total += router + expert * m.n_routed + shared
            active += router + expert * m.top_k + shared
        elif ffn == "mlp":
            total += 3 * d * cfg.d_ff
            active += 3 * d * cfg.d_ff
    return total, active
