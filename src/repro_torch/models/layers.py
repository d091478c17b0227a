"""Core transformer layers: RMSNorm, RoPE and M-RoPE, GQA and MLA attention,
gated MLP (and the non-gated relu² one of the port's sigmoid-routed
experts).

A port of the JAX package's ``models/layers.py``.
Conventions are the reference's:

* Functions take their parameters as a mapping of tensors (``p["wq"]``),
  weights in the ``(in, out)`` layout applied as ``x @ w``, so the JAX
  package's parameters carry across without transposes.
* ``x``: (B, T, D) activations; ``positions``: (B, T) integer positions.
* The cast points are the reference's, which the bf16 comparison with it
  depends on: norms, RoPE and softmax compute in f32 and cast back to the
  input dtype; q and k are cast back after RoPE; ``sdpa`` casts its output
  to q's dtype; the MLP takes its SiLU (or relu²) in f32 and casts before
  ``w_down``.

Attention runs full causal, sliding-window causal, and decode over a KV
cache: a full-length one, or for a windowed layer whose cache is no longer
than its window a ring buffer (slot = position mod S, each stored key
rotated at its absolute position).  Where the queries are the whole
sequence at positions arange(T) and the keys are those same T tokens (the
forward, and a prefill into a cache or a ring from position 0), ``sdpa``
goes to the flash-attention op (B3): the CUDA kernel for tensors on the
card, its plain version on the CPU.  Everything else (decode, with a
``valid`` mask and cache offsets) is plain PyTorch, as it is jnp outside any
kernel in the reference.

Multi-head Latent Attention (``mla_attention``, DeepSeek-V2) is plain
PyTorch throughout, as the reference computes it outside any kernel: its
q.k head dim (nope + rope, 192 for deepseek-v2-lite) is not its v head dim
(128), which the flash-attention kernel does not take.
"""
from __future__ import annotations

import math
from typing import Mapping, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.axes import constrain
from repro_torch.models.config import MLAConfig, ModelConfig, option

Params = Mapping[str, torch.Tensor]
NEG_INF = -1e30


# --------------------------------------------------------------------------- init
class MetaGenerator:
    """Stands in for a ``torch.Generator`` on the meta device, which has
    none: an init then makes meta tensors of the parameters' shapes and
    dtypes (the dry run's), and draws nothing."""
    device = torch.device("meta")


def _dense_init(gen: torch.Generator, shape, dtype,
                scale: Optional[float] = None) -> torch.Tensor:
    """Normal(0, scale^2) drawn in f32 on the generator's device, 1/sqrt(fan
    in) by default, cast to ``dtype``."""
    scale = scale if scale is not None else 1.0 / math.sqrt(shape[0])
    w = torch.randn(shape, device=gen.device, dtype=torch.float32,
                    generator=None if isinstance(gen, MetaGenerator) else gen)
    return (w * scale).to(dtype)


def init_rmsnorm(d: int, dtype, device) -> dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(x.dtype)


# --------------------------------------------------------------------------- rope
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, T, H, hd); positions: (B, T) -> rotated x (same dtype)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)           # (hd/2,)
    ang = positions[..., None].float() * freqs                  # (B, T, hd/2)
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, theta: float,
                sections: Tuple[int, int, int]) -> torch.Tensor:
    """Multimodal RoPE (Qwen2-VL): positions3 (3, B, T) = (t, h, w) ids.

    The frequencies are split into 3 sections, each rotated by its own
    position stream; ``sections`` counts frequency *pairs* and sums to
    head_dim // 2."""
    hd = x.shape[-1]
    assert sum(sections) == hd // 2, (sections, hd)
    freqs = rope_freqs(hd, theta, x.device)                     # (hd/2,)
    sec_id = torch.repeat_interleave(
        torch.arange(3, device=x.device),
        torch.tensor(sections, device=x.device),
        output_size=hd // 2)                                    # (hd/2,)
    pos = positions3.to(x.device).float()[sec_id]               # (hd/2, B, T)
    ang = pos.permute(1, 2, 0) * freqs                          # (B, T, hd/2)
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------- attention
class KVCache(NamedTuple):
    k: torch.Tensor   # (B, S, Hkv, hd)
    v: torch.Tensor   # (B, S, Hkv, hd)
    # the write index is carried by the caller (the same for all layers)


def causal_mask(q_pos: torch.Tensor, k_pos: torch.Tensor,
                window: Optional[int] = None) -> torch.Tensor:
    """(B, Tq, Tk) boolean mask: True = attend."""
    m = q_pos[:, :, None] >= k_pos[:, None, :]
    if window is not None:
        m &= (q_pos[:, :, None] - k_pos[:, None, :]) < window
    return m


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         q_pos: Optional[torch.Tensor], k_pos: Optional[torch.Tensor],
         window: Optional[int] = None,
         valid: Optional[torch.Tensor] = None,
         prefix: bool = False) -> torch.Tensor:
    """Causal attention scaled by hd^-1/2.  q: (B, T, H, hd); k, v: (B, S,
    Hkv, hd); q_pos: (B, T); k_pos: (B, S); valid: (B, S) cache-slot
    validity.

    ``prefix=True`` is the caller's statement that q_pos and k_pos are both
    arange(T) and that there is no ``valid`` mask: the call then goes to the
    flash-attention op (the kernel on the card), and the positions are not
    read.  Otherwise the masked attention is computed here in f32, over
    the whole (T, S) score matrix at once: the reference's query chunking
    only bounds the memory its compiler plans for, and changes no value."""
    B, T, H, hd = q.shape
    if prefix:
        if valid is not None or k.shape[1] != T:
            raise ValueError("a prefix attention has T keys and no valid "
                             "mask")
        return flash_attention(q, k, v, window)
    Hkv = k.shape[2]
    qg = (q.float() * hd ** -0.5).reshape(B, T, Hkv, H // Hkv, hd)
    logits = torch.einsum("btkgh,bskh->bkgts", qg, k.float())
    mask = causal_mask(q_pos, k_pos, window)
    if valid is not None:
        mask = mask & valid[:, None, :]
    logits = torch.where(mask[:, None, None], logits,
                         torch.full((), NEG_INF, device=q.device))
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgts,bskh->btkgh", w, v.float())
    return out.reshape(B, T, H, hd).to(q.dtype)


def init_attention(gen: torch.Generator, cfg: ModelConfig, dtype) -> dict:
    d, hd = cfg.d_model, cfg.head_dim
    H, Hkv = cfg.n_heads, cfg.n_kv_heads
    p = {
        "wq": _dense_init(gen, (d, H * hd), dtype),
        "wk": _dense_init(gen, (d, Hkv * hd), dtype),
        "wv": _dense_init(gen, (d, Hkv * hd), dtype),
        "wo": _dense_init(gen, (H * hd, d), dtype),
    }
    if cfg.qk_norm:
        p["q_norm"] = init_rmsnorm(hd, dtype, gen.device)
        p["k_norm"] = init_rmsnorm(hd, dtype, gen.device)
    return p


def attention(p: Params, cfg: ModelConfig, x: torch.Tensor,
              positions: torch.Tensor,
              cache: Optional[KVCache] = None,
              cache_index: Optional[int] = None,
              window: Optional[int] = None,
              positions3: Optional[torch.Tensor] = None,
              ) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """GQA attention.  Forward: cache=None, positions arange(T).  Serving:
    a cache and the write index ``cache_index``; the new k and v are written
    into the cache in place (cast to its dtype), and the same cache is
    returned.  A windowed layer whose cache is no longer than its window
    keeps a ring buffer.  ``positions3`` (3, B, T) rotates q and k by
    M-RoPE where the config has it; a config without ``use_rope`` (the
    mixed pattern's) rotates neither."""
    B, T, _ = x.shape
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    # under sharding rules, heads stay split over "model" through rope and
    # attention where the rules' head gate is on, else the projections are
    # replicated there before they are cut into heads (a split of H * hd
    # that is not one of whole heads cannot be viewed as heads); the
    # attention's output is laid out by heads again once flat, so that the
    # gradient the row-parallel wo sends back, split over H * hd, is
    # gathered before it is viewed as heads; past the cut, single-token
    # decode keeps the cache's layout, as in the reference
    def _maybe(t, names):
        return constrain(t, names) if T > 1 else t

    def merged(out):
        return _maybe(out.reshape(B, T, H * hd), ("batch", "seq", "heads"))

    def heads(w, n, name):
        y = constrain(x @ w, ("batch", "seq", name)).reshape(B, T, n, hd)
        return _maybe(y, ("batch", "seq", name, None))
    q = heads(p["wq"], H, "heads")
    k = heads(p["wk"], Hkv, "kv")
    v = heads(p["wv"], Hkv, "kv")
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(p["k_norm"], k, cfg.norm_eps)
    if cfg.mrope and positions3 is not None:
        q = apply_mrope(q, positions3, cfg.rope_theta, cfg.mrope_sections)
        k = apply_mrope(k, positions3, cfg.rope_theta, cfg.mrope_sections)
    elif option(cfg, "use_rope"):
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    if cache is None:
        out = sdpa(q, k, v, positions, positions, window, prefix=True)
        return merged(out) @ p["wo"], None

    S = cache.k.shape[1]
    ring = window is not None and S <= window
    if ring and T > 1:
        # prefill into a ring: windowed attention over the call's own k and
        # v (uncast), then the last W = min(T, S) of them stored at slots
        # pos % S.  The reference attends at the given positions; a prefill
        # from position 0 has them at arange(T), so it goes to the op.
        if cache_index == 0:
            out = sdpa(q, k, v, None, None, window, prefix=True)
        else:
            out = sdpa(q, k, v, positions, positions, window)
        W = min(T, S)
        slots = torch.arange(T - W, T, device=x.device) % S
        cache.k[:, slots] = k[:, -W:].to(cache.k.dtype)
        cache.v[:, slots] = v[:, -W:].to(cache.v.dtype)
    elif ring:
        # decode into a ring: write at slot t % S; each slot's absolute
        # position is t - ((t - j) mod S), valid where it is >= 0
        slot = cache_index % S
        cache.k[:, slot:slot + T] = k.to(cache.k.dtype)
        cache.v[:, slot:slot + T] = v.to(cache.v.dtype)
        j = torch.arange(S, device=x.device)
        t_now = positions[:, -1:]                              # (B, 1)
        k_pos = t_now - torch.remainder(t_now - j[None, :], S)  # (B, S)
        out = sdpa(q, cache.k, cache.v, positions, k_pos, window,
                   valid=k_pos >= 0)
    else:
        # full cache: write the new k/v at cache_index (in place), attend
        # over the filled slots
        cache.k[:, cache_index:cache_index + T] = k.to(cache.k.dtype)
        cache.v[:, cache_index:cache_index + T] = v.to(cache.v.dtype)
        if cache_index == 0 and T > 1:
            # A prefill from position 0.  The reference attends over the
            # whole cache with k_pos = arange(S) and valid = k_pos <= T - 1:
            # slots >= T are exactly the ones `valid` masks, and slots < T
            # hold this call's k and v as written (cast to the cache dtype).
            # So causal attention over the cache's first T slots, with
            # queries and keys both at arange(T), gives the reference's
            # result; it goes to the flash-attention op, reading the cache
            # slice through its strides.
            ck = _maybe(cache.k[:, :T].to(q.dtype),
                        ("batch", "seq", "kv", None))
            cv = _maybe(cache.v[:, :T].to(q.dtype),
                        ("batch", "seq", "kv", None))
            out = sdpa(q, ck, cv, None, None, window, prefix=True)
        else:
            k_pos = torch.arange(S, device=x.device)[None].expand(B, S)
            valid = k_pos <= positions[:, -1:]    # (B, S): only filled slots
            out = sdpa(q, cache.k, cache.v, positions, k_pos, window,
                       valid=valid)
    return merged(out) @ p["wo"], cache


# --------------------------------------------------------------------------- MLA
def init_mla(gen: torch.Generator, cfg: ModelConfig, dtype) -> dict:
    m: MLAConfig = cfg.mla
    d, H = cfg.d_model, cfg.n_heads
    qk_hd = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "wq": _dense_init(gen, (d, H * qk_hd), dtype),
        "w_dkv": _dense_init(gen, (d, m.kv_lora_rank), dtype),
        "w_krope": _dense_init(gen, (d, m.qk_rope_head_dim), dtype),
        "kv_norm": init_rmsnorm(m.kv_lora_rank, dtype, gen.device),
        "w_uk": _dense_init(gen, (m.kv_lora_rank, H * m.qk_nope_head_dim),
                            dtype),
        "w_uv": _dense_init(gen, (m.kv_lora_rank, H * m.v_head_dim), dtype),
        "wo": _dense_init(gen, (H * m.v_head_dim, d), dtype),
    }


class MLACache(NamedTuple):
    c_kv: torch.Tensor    # (B, S, kv_lora_rank): the compressed latent
    k_rope: torch.Tensor  # (B, S, rope_dim): the rope key shared by heads


def mla_attention(p: Params, cfg: ModelConfig, x: torch.Tensor,
                  positions: torch.Tensor,
                  cache: Optional[MLACache] = None,
                  cache_index: Optional[int] = None,
                  ) -> Tuple[torch.Tensor, Optional[MLACache]]:
    """Multi-head Latent Attention (DeepSeek-V2).  The cache holds the
    latent and the shared rope key, written in place at ``cache_index``
    (cast to the cache's dtype) and returned; per-head K and V are expanded
    from the cached latent, so they are the reference's bit for bit.

    The reference attends over the whole cache with ``valid`` = the filled
    slots (k_pos <= the last query position); the slots past
    ``cache_index + T`` are exactly the ones it masks, so only the filled
    ones are read here.  Its query chunking only bounds memory and changes
    no value, so the whole (T, S) score matrix is formed at once."""
    m: MLAConfig = cfg.mla
    B, T, _ = x.shape
    H = cfg.n_heads
    nope, rope_d, vd = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim

    q = (x @ p["wq"]).reshape(B, T, H, nope + rope_d)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    c_kv = rmsnorm(p["kv_norm"], x @ p["w_dkv"], cfg.norm_eps)    # (B,T,r)
    k_rope = apply_rope((x @ p["w_krope"])[:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0, :]                # (B,T,rd)

    if cache is not None:
        end = cache_index + T
        cache.c_kv[:, cache_index:end] = c_kv.to(cache.c_kv.dtype)
        cache.k_rope[:, cache_index:end] = k_rope.to(cache.k_rope.dtype)
        c_kv, k_rope = cache.c_kv[:, :end], cache.k_rope[:, :end]
        S = end
        k_pos = torch.arange(S, device=x.device)[None].expand(B, S)
        mask = (causal_mask(positions, k_pos)
                & (k_pos <= positions[:, -1:])[:, None, :])
    else:
        S = T
        mask = causal_mask(positions, positions)

    # expand the latent to per-head K (the nope part) and V; a bf16 cache
    # under f32 weights is promoted to f32, as jnp promotes it
    c_kv = c_kv.to(torch.promote_types(c_kv.dtype, p["w_uk"].dtype))
    k_nope = (c_kv @ p["w_uk"]).reshape(B, S, H, nope)
    vv = (c_kv @ p["w_uv"]).reshape(B, S, H, vd)
    scale = (nope + rope_d) ** -0.5
    lg = torch.einsum("bthn,bshn->bhts", q_nope.float(), k_nope.float())
    lg = lg + torch.einsum("bthr,bsr->bhts", q_rope.float(), k_rope.float())
    lg = torch.where(mask[:, None], lg * scale,
                     torch.full((), NEG_INF, device=x.device))
    w = torch.softmax(lg, dim=-1)
    out = torch.einsum("bhts,bshv->bthv", w, vv.float())
    y = out.reshape(B, T, H * vd).to(x.dtype) @ p["wo"]
    return y, cache


# --------------------------------------------------------------------------- mlp
def init_mlp(gen: torch.Generator, d: int, ff: int, dtype,
             gated: bool = True) -> dict:
    p = {"w_gate": _dense_init(gen, (d, ff), dtype)} if gated else {}
    p["w_up"] = _dense_init(gen, (d, ff), dtype)
    p["w_down"] = _dense_init(gen, (ff, d), dtype)
    return p


def mlp(p: Params, x: torch.Tensor, gated: bool = True) -> torch.Tensor:
    """``silu(x w_gate) * (x w_up)``, or non-gated ``relu(x w_up)^2``, then
    ``w_down``."""
    if gated:
        g = x @ p["w_gate"]
        u = x @ p["w_up"]
        h = F.silu(g.float()) * u.float()
    else:
        h = torch.square(F.relu((x @ p["w_up"]).float()))
    return h.to(x.dtype) @ p["w_down"]
