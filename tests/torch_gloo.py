"""Spawned gloo ranks for the port's multi-rank tests on the CPU.

``run(job, world, tmp_path, **kw)`` starts ``world`` Python processes that
each join a gloo process group (rendezvous through a file store in
``tmp_path``, so parallel test workers never share a port), run
``job(rank, world, **kw)`` (a function of this module, which imports
neither JAX nor the JAX package) and pickle its result; it returns the
results in rank order.  A job runs all of one test file's cases, so a file
spawns its ranks once per world size.  A job catches each case's error
and returns it as the case's result, so one failing case fails its own
test only.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import subprocess
import sys
import traceback
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]


def run(job: str, world: int, tmp_path, timeout: float = 600, **kw):
    tmp = Path(tmp_path)
    with open(tmp / f"{job}.kw.pkl", "wb") as f:
        pickle.dump(kw, f)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO / "src"), str(REPO / "tests")]), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, __file__, job, str(r), str(world), str(tmp)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    logs = [p.communicate(timeout=timeout)[0] for p in procs]
    out = []
    for r, (p, log) in enumerate(zip(procs, logs)):
        path = tmp / f"{job}.rank{r}.pkl"
        if p.returncode or not path.exists():
            raise RuntimeError(f"rank {r} of {job}: exit {p.returncode}\n"
                               f"{log[-4000:]}")
        with open(path, "rb") as f:
            out.append(pickle.load(f))
    return out


def _cases(cases):
    """Run each (name, thunk); a case's error becomes its result."""
    out = {}
    for name, fn in cases:
        try:
            out[name] = fn()
        except Exception:                                   # noqa: BLE001
            out[name] = {"error": traceback.format_exc()}
    return out


def _arr(t):
    from torch.distributed.tensor import DTensor
    if isinstance(t, DTensor):
        t = t.full_tensor()
    return t.detach().float().cpu().numpy()


# ---------------------------------------------------------------- collectives
def collectives(rank, world, x, y, g):
    """Relay (src 0 and 3), naive and ring on 8 ranks, each holding its
    slice of axis 0; ``psum_compressed`` on a group of ranks 0-3."""
    import torch
    import torch.distributed as dist

    from repro_torch.core import relay_collectives as RC
    from repro_torch.optim.grad_compress import psum_compressed
    xs = torch.from_numpy(x).chunk(world)[rank].clone()
    ys = torch.from_numpy(y).chunk(world)[rank].clone()
    four = dist.new_group([0, 1, 2, 3])
    cases = [
        ("relay_src0", lambda: RC.relay_broadcast_inner(xs, None, 0, 4)),
        ("relay_src3", lambda: RC.relay_broadcast_inner(xs, None, 3, 4)),
        ("naive", lambda: RC.naive_broadcast_inner(xs, None, 0)),
        ("ring", lambda: RC.ring_all_gather_inner(ys)),
    ]
    out = _cases([(n, (lambda f=f: f().numpy())) for n, f in cases])
    if rank < 4:
        gs = torch.from_numpy(g).chunk(4)[rank].clone()
        out.update(_cases([("compressed",
                            lambda: psum_compressed(gs, four).numpy())]))
    return out


# ------------------------------------------------------------- sharded paths
def _setup(cfg_name, shape, dtype="float32", **replace):
    """(cfg, plain model, mesh, param specs, sharded model) of a smoke
    config; the sharded model holds the plain one's weights."""
    import torch

    from repro_torch import tree as T
    from repro_torch.checkpoint.elastic import load_for_mesh
    from repro_torch.configs import get_config
    from repro_torch.launch import shardings as SH
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import LM
    cfg = get_config(cfg_name).smoke()
    if replace:
        cfg = dataclasses.replace(cfg, **replace)
    dt = getattr(torch, dtype)
    plain = LM(cfg, dtype=dt, device="cpu", seed=0, remat=False)
    mesh = make_mesh(shape, "cpu")
    params = T.tree_map(lambda t: t.clone(), plain.params())
    specs = SH.layer_param_specs(params, cfg, mesh)
    model = LM(cfg, dtype=dt, device="cpu",
               params=load_for_mesh(params, mesh, specs), remat=False)
    return cfg, plain, mesh, specs, model


def _tokens(cfg, B, T, seed):
    import torch
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, (B, T), generator=g)


def _place(x, mesh, *spec):
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.models.axes import Spec, placements
    return distribute_tensor(x, mesh, placements(Spec(*spec), mesh))


def _forward(arch, shape, B=4, T=16, **replace):
    """The sharded forward's logits beside the plain one's, and the local
    head count B3 was handed."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.launch import shardings as SH
    from repro_torch.models.axes import logical_axis_rules
    cfg, plain, mesh, _, model = _setup(arch, shape, **replace)
    toks = _tokens(cfg, B, T, 1)
    want = plain(toks)
    rules = SH.logical_rules(mesh, B, cfg)
    heads = []
    real = fops.attention_torch

    def seen(q, k, v, window):
        heads.append((q.shape[0], q.shape[2], k.shape[2]))
        return real(q, k, v, window)
    fops.attention_torch = seen
    try:
        with implicit_replication(), logical_axis_rules(mesh, rules):
            got = model(_place(toks, mesh, rules["batch"], None))
    finally:
        fops.attention_torch = real
    return {"got": _arr(got), "want": _arr(want), "rules": rules,
            "local_b_h_hkv": sorted(set(heads))}


def _train(arch, shape, hoist=False, B=4, T=16, **replace):
    """One ``build_train_step`` step sharded on ``shape`` and one
    unsharded, from the same weights and batch: (new params, master
    params, moments, loss) of each."""
    import torch

    from repro_torch import tree as T_
    from repro_torch.launch import dryrun
    from repro_torch.launch import shardings as SH
    from repro_torch.models.axes import logical_axis_rules
    from repro_torch.optim import adamw
    threshold = SH.FSDP_THRESHOLD
    if hoist:                      # params sharded over "data" (FSDP)
        SH.FSDP_THRESHOLD = 0
    try:
        cfg, plain, mesh, specs, model = _setup(arch, shape, **replace)
    finally:
        SH.FSDP_THRESHOLD = threshold
    plain.requires_grad_(True)
    model.requires_grad_(True)
    toks = _tokens(cfg, B, T + 1, 2)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    rules = SH.logical_rules(mesh, B, cfg)
    step_p = dryrun.build_train_step(plain)
    p_new, p_opt, p_loss = step_p(plain.params(), adamw.init(plain.params()),
                                  batch)
    opt = dryrun.place_opt_state(adamw.init(model.params()), mesh,
                                 SH.layer_opt_specs(model.params(), cfg,
                                                    mesh))
    step_s = dryrun.build_train_step(model, 1, mesh, specs, hoist_fsdp=hoist)
    with logical_axis_rules(mesh, rules):
        dbatch = {k: _place(v, mesh, rules["batch"], None)
                  for k, v in batch.items()}
        s_new, s_opt, s_loss = step_s(model.params(), opt, dbatch)

    def flat(tree):
        return [_arr(t) for t in T_.leaves(tree)]
    return {"got": {"params": flat(s_new), "master": flat(s_opt.master),
                    "m": flat(s_opt.m), "v": flat(s_opt.v),
                    "loss": float(_arr(s_loss))},
            "want": {"params": flat(p_new), "master": flat(p_opt.master),
                     "m": flat(p_opt.m), "v": flat(p_opt.v),
                     "loss": float(_arr(p_loss))},
            "dtypes": sorted({str(t.dtype) for t in T_.leaves(s_new)}),
            "fsdp": any("data" in tuple(s) for s in T_.leaves(specs))}


def _restore(ckpts, shape):
    """Each checkpoint restored onto the mesh ``shape``, placed by
    ``load_for_mesh`` and gathered back: its leaves in checkpoint order."""
    import torch

    from repro_torch import tree as T
    from repro_torch.checkpoint.ckpt import restore_checkpoint
    from repro_torch.checkpoint.elastic import load_for_mesh
    from repro_torch.configs import get_config
    from repro_torch.launch import shardings as SH
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import LM
    mesh = make_mesh(shape, "cpu")
    out = {}
    for name, (root, arch) in ckpts.items():
        cfg = get_config(arch).smoke()
        example = LM(cfg, dtype=torch.bfloat16, device="cpu").params()
        step, tree, _ = restore_checkpoint(root, example, device="cpu")
        placed = load_for_mesh(tree, mesh, SH.layer_param_specs(tree, cfg,
                                                                mesh))
        full = T.tree_map(lambda t: t.full_tensor(), placed)
        stacked = T.stack_layers(full, torch.stack)
        out[name] = {"step": step, "leaves": [
            t.view(torch.int16).numpy() if t.dtype == torch.bfloat16
            else t.numpy() for t in T.leaves(stacked)],
            "sharded": any(any(p.is_shard() for p in t.placements)
                           for t in T.leaves(placed))}
    return out


def sharded2(rank, world, ckpts):
    """The 2-rank cases of ``test_torch_sharded.py``."""
    cases = []
    for arch in ("smollm-135m", "falcon-mamba-7b"):
        for shape in ({"data": 2, "model": 1}, {"data": 1, "model": 2}):
            cases.append((f"forward {arch} {shape}",
                          lambda a=arch, s=shape: _forward(a, s)))
    cases += [
        ("forward heads", lambda: _forward(
            "smollm-135m", {"data": 1, "model": 2}, n_kv_heads=2)),
        ("train data2", lambda: _train("smollm-135m",
                                       {"data": 2, "model": 1})),
        ("train model2", lambda: _train("smollm-135m",
                                        {"data": 1, "model": 2},
                                        n_kv_heads=2)),
        ("train model2_odd_heads", lambda: _train(
            "smollm-135m", {"data": 1, "model": 2}, n_heads=3)),
        ("train hoist", lambda: _train("smollm-135m",
                                       {"data": 2, "model": 1}, True)),
        ("restore", lambda: _restore(ckpts, {"data": 1, "model": 2})),
        ("decode graph", _decode_graph),
    ]
    for shape in ({"data": 2, "model": 1}, {"data": 1, "model": 2}):
        cases.append((f"decode falcon-mamba-7b {shape}",
                      lambda s=shape: _decode(s)))
    return _cases(cases)


def _decode(shape, B=4, T=12, steps=3):
    """falcon-mamba-7b's prefill of T tokens and ``steps`` decode steps on
    the mesh beside the plain model's decode logits, and the local shapes
    of (z, h) that the Mamba1 step's plain version was handed."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.checkpoint.elastic import load_for_mesh
    from repro_torch.kernels.mamba_scan import ops
    from repro_torch.launch import shardings as SH
    from repro_torch.models.axes import logical_axis_rules
    cfg, plain, mesh, _, model = _setup("falcon-mamba-7b", shape)
    toks = _tokens(cfg, B, T + steps, 2)

    def serve(lm, place=lambda x: x, cache=None):
        cache = lm.init_cache(B, T + steps) if cache is None else cache
        _, cache = lm.prefill(place(toks[:, :T]), cache)
        out = []
        for t in range(T, T + steps):
            lg, cache = lm.decode_step(cache, place(toks[:, t:t + 1]), t)
            out.append(_arr(lg))
        return np.stack(out)
    want = serve(plain)
    rules = SH.logical_rules(mesh, B, cfg)
    cache = model.init_cache(B, T + steps)
    cache = load_for_mesh(cache, mesh, SH.cache_specs(cache, B, T + steps,
                                                      mesh, rules["batch"]))
    seen, real = [], ops.state_step_torch

    def step(*ins):
        seen.append((tuple(ins[8].shape), tuple(ins[9].shape)))
        return real(*ins)
    ops.state_step_torch = step
    try:
        with implicit_replication(), logical_axis_rules(mesh, rules):
            got = serve(model, lambda x: _place(x, mesh, rules["batch"],
                                                None), cache)
    finally:
        ops.state_step_torch = real
    return {"got": got, "want": want, "local_z_h": sorted(set(seen)),
            "steps": len(seen)}


def _decode_graph():
    """Whether falcon-mamba-7b's plain and sharded models would decode as a
    CUDA graph, their rule read as on a CUDA device (no kernel run)."""
    import torch
    _, plain, _, _, model = _setup("falcon-mamba-7b",
                                   {"data": 1, "model": 2})
    out = {}
    for name, lm in (("plain", plain), ("sharded", model)):
        lm.device = torch.device("cuda")
        out[name] = lm.graphs_decode()
    return out


def _moe(ref_path):
    """``moe_forward`` of the reference's weights on the 2 x 2 mesh, its
    gradients, and the port's dense path."""
    import torch
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.checkpoint.elastic import load_for_mesh
    from repro_torch.configs import get_config
    from repro_torch.launch import shardings as SH
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe as MOE
    from repro_torch.models.axes import logical_axis_rules
    ref = dict(np.load(ref_path))
    mesh = make_mesh({"data": 2, "model": 2}, "cpu")
    out = {}
    for cf in (1.25, 8.0):
        cfg = get_config("qwen3-moe-30b-a3b").smoke()
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cf))
        p = {k: torch.from_numpy(ref[f"p_{k}"]) for k in
             ("router", "w_gate", "w_up", "w_down")}
        x, r = torch.from_numpy(ref["x"]), torch.from_numpy(ref["r"])
        specs = {k: SH.Spec("model", None, None) if k != "router"
                 else SH.Spec(None, None) for k in p}
        rules = SH.logical_rules(mesh, x.shape[0], cfg)
        with implicit_replication(), logical_axis_rules(mesh, rules):
            got, aux = MOE.moe_forward(load_for_mesh(p, mesh, specs), cfg,
                                       _place(x, mesh, rules["batch"], None,
                                              None))
        dense, dense_aux = MOE.moe_forward(p, cfg, x)
        out[cf] = {"out": _arr(got), "aux": float(_arr(aux)),
                   "dense": _arr(dense), "dense_aux": float(dense_aux),
                   "grads": {of: _moe_grads(p, x, r, cfg, mesh, specs,
                                            rules, of)
                             for of in ("out", "aux")}}
    return out


def _moe_grads(p, x, r, cfg, mesh, specs, rules, of):
    """The gradients of sum(out * r) (``of="out"``) or of aux with respect
    to the placed weights and x, gathered."""
    import torch
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.checkpoint.elastic import load_for_mesh
    from repro_torch.models import moe as MOE
    from repro_torch.models.axes import logical_axis_rules
    dp = load_for_mesh(p, mesh, specs)
    dx = _place(x, mesh, rules["batch"], None, None)
    leaves = [dp[k].requires_grad_() for k in sorted(dp)] + [
        dx.requires_grad_()]
    with implicit_replication(), logical_axis_rules(mesh, rules):
        got, aux = MOE.moe_forward(dp, cfg, dx)
        loss = (got * _place(r, mesh, rules["batch"], None, None)).sum() \
            if of == "out" else aux
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    # aux does not reach the experts: their gradient is zero, as jax.grad's
    return dict(zip(sorted(dp) + ["x"], (
        _arr(g) if g is not None else np.zeros(t.shape, np.float32)
        for g, t in zip(grads, leaves))))


def sharded4(rank, world, ref_path, ckpts):
    """The 4-rank (2 x 2) cases of ``test_torch_sharded.py``."""
    return _cases([("moe", lambda: _moe(ref_path)),
                   ("restore", lambda: _restore(ckpts, {"data": 2,
                                                        "model": 2}))])


def _main():
    job, rank, world, tmp = sys.argv[1], int(sys.argv[2]), \
        int(sys.argv[3]), Path(sys.argv[4])
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    with open(tmp / f"{job}.kw.pkl", "rb") as f:
        kw = pickle.load(f)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/{job}.store",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    try:
        result = globals()[job](rank, world, **kw)
    finally:
        dist.destroy_process_group()
    with open(tmp / f"{job}.rank{rank}.pkl", "wb") as f:
        pickle.dump(result, f)


if __name__ == "__main__":
    _main()
