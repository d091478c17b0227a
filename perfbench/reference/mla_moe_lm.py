"""Plain MLA + MoE language model (DeepSeek-V2-Lite's layout): its loss, its
gradients and AdamW, float32, following the port's equations.

A block: ``h = rmsnorm(x)``; Multi-head Latent Attention (queries
``h @ wq`` split into a no-rope and a rope part; the latent ``c =
rmsnorm(h @ w_dkv)``; per-head keys ``c @ w_uk`` and values ``c @ w_uv``;
one rope key ``h @ w_krope`` shared by the heads; rotary embedding by
halves at theta; causal softmax scaled by (nope + rope)^-1/2); ``x = x +
out @ wo``; then ``h = rmsnorm(x)`` and a gated SiLU MLP (the leading dense
layers) or a mixture of experts: router softmax in float32, top-k by a
stable descending sort, the top-k weights renormalised only where
``norm_topk_prob`` says so, an auxiliary loss ``E * sum(mean(probs) *
share of routings)``; each expert takes at most ``C`` routings, ``C`` the
capacity ``max(8, ceil8(int(N K cf / E)))``, in the order of a stable sort
of the routings (token by token, top choice first) by expert; the dropped
routings add nothing; shared experts are one MLP of their summed width.
The loss is the mean cross-entropy plus ``aux_weight`` times the summed
auxiliary losses.

Departures from DeepSeek-V2-Lite as published, which the port shares: yarn
rope scaling and its softmax ``mscale`` are not modelled (they act past
4096 positions); the auxiliary loss is the Switch-style batch loss, not
DeepSeek's sequence-level one.  Capacity factor and auxiliary weight are
assumed, as the configuration file says.

Every block runs under activation checkpointing, and the cross-entropy in
blocks of rows, so that the float32 model and its AdamW state fit on one
card beside one block's activations.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from perfbench.reference.precision import Precision, exact

CE_ROWS = 1024


def rmsnorm(x, scale, eps):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) \
        * scale


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, T, H, hd) rotated at positions 0..T-1, by halves."""
    T, hd = x.shape[1], x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=x.device) / hd)
    ang = torch.arange(T, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def mla(p, s, h, prec: Precision):
    B, T, _ = h.shape
    H = s.heads
    q = prec.mm(h, p["wq"]).view(B, T, H, s.nope + s.rope)
    q_nope, q_rope = q[..., :s.nope], rope(q[..., s.nope:], s.theta)
    c = rmsnorm(prec.mm(h, p["w_dkv"]), p["kv_norm"]["scale"], s.eps)
    k_rope = rope(prec.mm(h, p["w_krope"])[:, :, None, :], s.theta)[:, :, 0]
    k_nope = prec.mm(c, p["w_uk"]).view(B, T, H, s.nope)
    v = prec.mm(c, p["w_uv"]).view(B, T, H, s.vd)
    lg = (prec.einsum("bthn,bshn->bhts", q_nope, k_nope)
          + prec.einsum("bthr,bsr->bhts", q_rope, k_rope))
    lg = lg * (s.nope + s.rope) ** -0.5
    causal = torch.ones(T, T, dtype=torch.bool, device=h.device).tril()
    w = torch.softmax(lg.masked_fill(~causal, float("-inf")), dim=-1)
    out = prec.einsum("bhts,bshv->bthv", w, v).reshape(B, T, H * s.vd)
    return prec.mm(out, p["wo"])


def mlp(p, x, prec: Precision):
    return prec.mm(F.silu(prec.mm(x, p["w_gate"])) * prec.mm(x, p["w_up"]),
                   p["w_down"])


def capacity(s, n_tokens: int) -> int:
    cap = int(n_tokens * s.top_k * s.capacity_factor / s.experts)
    return max(8, -(-cap // 8) * 8)


def moe(p, s, h, prec: Precision):
    B, T, d = h.shape
    N, E, K = B * T, s.experts, s.top_k
    x = h.reshape(N, d)
    probs = torch.softmax(prec.mm(x, p["router"]), dim=-1)
    top_i = torch.sort(probs.detach(), dim=-1, descending=True,
                       stable=True).indices[:, :K]
    top_w = torch.gather(probs, 1, top_i)
    if s.norm_topk:
        top_w = top_w / (top_w.sum(-1, keepdim=True) + 1e-9)
    flat = top_i.reshape(-1)
    counts = torch.bincount(flat, minlength=E)
    aux = E * torch.sum(probs.mean(0) * counts.float() / (N * K))
    order = torch.argsort(flat, stable=True)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.empty_like(flat)
    pos[order] = torch.arange(N * K, device=x.device) - starts[flat[order]]
    keep = pos < capacity(s, N)
    tok = torch.arange(N * K, device=x.device) // K
    per_routing = []
    index = []
    for e in range(E):
        sel = torch.nonzero((flat == e) & keep)[:, 0]
        if sel.numel():
            xe = x[tok[sel]]
            per_routing.append(mlp({"w_gate": p["w_gate"][e],
                                    "w_up": p["w_up"][e],
                                    "w_down": p["w_down"][e]}, xe, prec))
            index.append(sel)
    y = x.new_zeros((N * K, d))
    if index:
        y = y.index_put((torch.cat(index),), torch.cat(per_routing))
    out = (y * top_w.reshape(-1, 1)).view(N, K, d).sum(1)
    if s.shared:
        out = out + mlp(p["shared"], x, prec)
    return out.view(B, T, d), aux


def block(p, s, x, prec: Precision):
    h = rmsnorm(x, p["ln1"]["scale"], s.eps)
    x = x + mla(p["attn"], s, h, prec)
    h = rmsnorm(x, p["ln2"]["scale"], s.eps)
    if "moe" in p:
        f, aux = moe(p["moe"], s, h, prec)
    else:
        f, aux = mlp(p["mlp"], h, prec), x.new_zeros(())
    return x + f, aux


def _ce_rows(x, head, labels, prec: Precision):
    lg = prec.mm(x, head)
    return torch.sum(torch.logsumexp(lg, -1)
                     - lg.gather(1, labels[:, None])[:, 0])


def loss_fn(params, s, tokens, labels, prec: Precision = Precision()
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(loss, ce, summed aux) of ``tokens``/``labels`` (B, T)."""
    x = params["embed"][tokens]
    aux = x.new_zeros(())
    for p in list(params["lead"]) + list(params["blocks"]):
        x, a = checkpoint(block, p, s, x, prec, use_reentrant=False)
        aux = aux + a
    x = rmsnorm(x, params["final_norm"]["scale"], s.eps)
    N = tokens.numel()
    xf, lf = x.reshape(N, -1), labels.reshape(N)
    ce = sum(checkpoint(_ce_rows, xf[i:i + CE_ROWS], params["lm_head"],
                        lf[i:i + CE_ROWS], prec, use_reentrant=False)
             for i in range(0, N, CE_ROWS)) / N
    return ce + s.aux_weight * aux, ce, aux


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def _paths(tree, prefix="") -> List[Tuple[str, torch.Tensor]]:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _paths(tree[k],
                                                        f"{prefix}{k}.")]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree) for x in _paths(v,
                                                              f"{prefix}{i}.")]
    return [(prefix[:-1], tree)]


def warmup_cosine(step: int, peak: float, warmup: int, total: int,
                  floor: float = 0.1) -> float:
    """The learning rate before update ``step`` (from 0), float32."""
    s = torch.tensor(float(step))
    warm = peak * torch.clamp(s / max(1, warmup), max=1.0)
    prog = torch.clamp((s - warmup) / max(1, total - warmup), 0.0, 1.0)
    cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
    return float(warm if step < warmup else peak * cos)


def train(tree: dict, s, batches: Sequence[Tuple[torch.Tensor,
                                                 torch.Tensor]],
          opt: Dict[str, float], lr: Callable[[int], float],
          prec: Precision = Precision()) -> dict:
    """Steps of AdamW (float32 moments, decoupled weight decay, gradients
    clipped by their global norm, bias corrections at the incremented
    step) on ``batches`` from the weights ``tree``.  Returns each step's
    loss, each leaf's first gradient as AdamW takes it (clipped) and
    unclipped, by norm, and each leaf's change after the last step, by
    norm."""
    out: dict = {"loss": [], "grad": {}, "raw_grad": {}, "change": {}}
    with exact():
        params = _tree_map(lambda t: t.detach().float().clone()
                           .requires_grad_(True), tree)
        named = _paths(params)
        m = [torch.zeros_like(p) for _, p in named]
        v = [torch.zeros_like(p) for _, p in named]
        for step, (tokens, labels) in enumerate(batches):
            loss, _, _ = loss_fn(params, s, tokens, labels, prec)
            grads = torch.autograd.grad(loss, [p for _, p in named])
            out["loss"].append(float(loss.detach()))
            gnorm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            scale = torch.clamp(opt["grad_clip"] / (gnorm + 1e-9), max=1.0)
            b1c = 1 - opt["b1"] ** (step + 1)
            b2c = 1 - opt["b2"] ** (step + 1)
            rate = lr(step)
            with torch.no_grad():
                for i, ((name, p), g) in enumerate(zip(named, grads)):
                    if step == 0:
                        norm = float(torch.linalg.vector_norm(g))
                        out["raw_grad"][name] = norm
                        out["grad"][name] = norm * float(scale)
                    g = g * scale
                    m[i].mul_(opt["b1"]).add_((1 - opt["b1"]) * g)
                    v[i].mul_(opt["b2"]).add_((1 - opt["b2"]) * g * g)
                    upd = (m[i] / b1c) / (torch.sqrt(v[i] / b2c)
                                          + opt["eps"])
                    p.sub_(rate * (upd + opt["weight_decay"] * p))
            del grads
        with torch.no_grad():
            for name, p in named:
                start = _leaf(tree, name).float()
                out["change"][name] = float(torch.linalg.vector_norm(
                    p - start))
    return out


def _leaf(tree, path: str):
    node = tree
    for k in path.split("."):
        node = node[int(k)] if isinstance(node, list) else node[k]
    return node
