"""Dry run of a sharded step: lay a full-size (arch × input shape) cell out on
a mesh that need not exist, and count what one step holds and does.

A port of the JAX package's ``launch/dryrun.py``.  The reference lowers and
compiles each step onto 256 or 512 fake XLA devices and reads the compiled
artifact.  Here the step runs once, eagerly, on **meta** DTensors: parameters,
optimizer state, caches and inputs carry shapes and placements but no data,
over a ``"fake"`` process group of ``prod(mesh)`` ranks in this one process
(its collectives return at once).  The fake group comes from
``torch.testing._internal.distributed.fake_pg``, a private module of
PyTorch: this file is the only one of the package that imports it, and
only inside ``run_cell``.  A fake group and a real one cannot share a
process, so call ``run_cell`` in a process of its own (the CLI is one).

For each cell the JSON record holds:
  * ``memory``: per-device bytes of parameters, optimizer state (ZeRO-1)
    and cache, from the placements (rank 0's shards; the counterpart of
    ``memory_analysis``), beside the global parameter bytes and elements;
  * ``flops``: the step's FLOPs from ``FlopCounterMode``, counted over the
    same step built without a mesh on meta tensors, so every op is counted
    at its global size (over DTensors the mode would count a ``local_map``
    body, e.g. attention, at one rank's size).  These are GLOBAL, as
    ``analytic_cost`` is, and are set beside its ``model_flops``
    (2 FLOPs a parameter a token, 6 in training).  They exceed it: the
    count takes matmuls only, but every one, and on meta the attention is
    its plain version's, all T x S scores and their product with V (as
    the reference's analytic model charges them; the kernel skips the
    masked half), and training adds the remat forward (smollm-135m
    train_4k: 2.20e15 counted, 8.46e14 model FLOPs);
  * ``collectives``: the collective counts by type over the sharded step,
    counted as ``CommDebugMode`` counts them (``_CommCounts``; the
    counterpart of the reference's HLO parser, ``parse_collectives``, which
    reads TPU HLO and has none here).

Run one cell:   python -m repro_torch.launch.dryrun --arch qwen3-14b
                    --shape train_4k [--multi-pod | --both-meshes]
Run everything: python -m repro_torch.launch.dryrun --all [--force]
                    (a subprocess a cell, as the reference runs them)
Records land in experiments/dryrun_torch/{arch}__{shape}__{pod1|pod2}.json,
beside the reference's experiments/dryrun/.  The mesh is the reference's
production mesh (``mesh.make_production_mesh``: 16 x 16, or 2 x 16 x 16
with ``--multi-pod``) unless ``--mesh data=8,model=8 --out F`` gives
another (an H100 deployment's shape) and the record's path.
``--all`` skips a cell whose record exists unless ``--force``, and writes
skip records for ``long_500k`` on archs that are not subquadratic.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from contextlib import nullcontext
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.configs import ARCH_IDS, SHAPES, get_config, \
    shape_applicable
from repro_torch.launch import shardings as SH
from repro_torch.launch.analytic import analytic_cost
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.axes import Spec, logical_axis_rules, placements
from repro_torch.models.config import ModelConfig, param_count
from repro_torch.models.model import LM, set_param
from repro_torch.optim import adamw
from repro_torch.optim.schedule import warmup_cosine

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")


def _replicated():
    """The context in which a sharded step runs: the model's plain tensors
    (positions, masks, zero states) count as replicated."""
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


# --------------------------------------------------------------- input specs
def train_inputs(cfg: ModelConfig, B: int, T_: int, device="meta"
                 ) -> Dict[str, torch.Tensor]:
    """A batch of the step's shapes and dtypes (zeros), as the reference's
    ``train_inputs`` describes it."""
    def z(*shape, dtype=torch.long):
        return torch.zeros(shape, dtype=dtype, device=device)
    batch: Dict[str, torch.Tensor] = {}
    if cfg.n_codebooks > 1:
        batch["tokens"] = z(B, T_, cfg.n_codebooks)
        batch["labels"] = z(B, T_, cfg.n_codebooks)
    elif not cfg.embed_inputs:
        batch["embeds"] = z(B, T_, cfg.d_model, dtype=torch.bfloat16)
        batch["labels"] = z(B, T_)
    else:
        batch["tokens"] = z(B, T_)
        batch["labels"] = z(B, T_)
    if cfg.mrope:
        batch["positions3"] = z(3, B, T_)
    return batch


def place_batch(batch: Dict[str, torch.Tensor], mesh, bax
                ) -> Dict[str, torch.Tensor]:
    """The batch's leaves split on the batch dim over ``bax`` (dim 1 of
    ``positions3``)."""
    from torch.distributed.tensor import distribute_tensor

    def put(k, v):
        spec = (Spec(None, bax) if k == "positions3" else Spec(bax))
        return distribute_tensor(v, mesh, placements(spec, mesh))
    return {k: put(k, v) for k, v in batch.items()}


def place_opt_state(state: adamw.AdamWState, mesh, mom_specs
                    ) -> adamw.AdamWState:
    """``state``'s master params and moments laid out by ZeRO-1
    (``mom_specs``, a tree of the params' structure)."""
    def put(x, spec):
        return x.redistribute(x.device_mesh, placements(spec, mesh))
    return state._replace(**{k: T.tree_map(put, getattr(state, k), mom_specs)
                             for k in ("master", "m", "v")})


def _split(v: torch.Tensor, mb: int, dim: int):
    """``mb`` microbatches of ``v`` on ``dim``: contiguous blocks of a plain
    tensor (the reference's reshape), of each rank's local rows for a
    DTensor (each microbatch a DTensor of the same placements)."""
    from torch.distributed.tensor import DTensor
    if not isinstance(v, DTensor):
        return list(torch.chunk(v, mb, dim=dim))
    return [DTensor.from_local(x, v.device_mesh, v.placements,
                               run_check=False)
            for x in torch.chunk(v.to_local(), mb, dim=dim)]


def _drop_data(spec: Spec) -> Spec:
    out = []
    for ax in spec:
        if ax == "data":
            out.append(None)
        elif isinstance(ax, tuple):
            kept = tuple(a for a in ax if a != "data")
            out.append(kept if len(kept) > 1 else (kept[0] if kept else None))
        else:
            out.append(ax)
    return Spec(*out)


# ------------------------------------------------------------- step builders
def build_train_step(model: LM, microbatches: int = 1, mesh=None,
                     pspecs=None, hoist_fsdp: bool = False,
                     opt_cfg: adamw.AdamWConfig = adamw.AdamWConfig()):
    """Gradient-accumulation train step: forward and backward per
    microbatch, one optimizer update per step; (params, opt_state, batch)
    -> (params, opt_state, loss), ``params`` the model's tree (written into
    the model first, and the new ones after the update).

    With several microbatches each gradient is cast to bf16 before it is
    accumulated in f32 (the reference's bf16 gradient reduction).  A plain
    batch is cut into contiguous blocks, as the reference cuts it; a
    sharded one into blocks of every rank's own rows, which are other rows
    of the global batch per microbatch but the same rows in all.

    hoist_fsdp: gather FSDP-sharded weights ONCE per step (outside the
    microbatch loop: the params laid out without "data") and lay each
    microbatch's gradients back out as the params (reduce-scatter over
    "data"), as the reference's option does."""
    leaves = T.leaves(model.parameter_tree())
    hoist = hoist_fsdp and mesh is not None and pspecs is not None
    sharded = mesh is not None

    def grads_of(batch):
        loss = model.loss_fn(batch)[0]
        return loss, list(torch.autograd.grad(
            loss, leaves, allow_unused=True, materialize_grads=True))

    def train_step(params, opt_state, batch):
        with _replicated() if sharded else nullcontext():
            model.load_params(params)
            homes = [(p.device_mesh, p.placements) for p in leaves] \
                if hoist else []
            if hoist:
                for p, sp in zip(leaves, T.leaves(pspecs)):
                    set_param(p, p.redistribute(
                        mesh, placements(_drop_data(sp), mesh)))

            def reshard(g):
                return [x.redistribute(*home) for x, home in zip(g, homes)] \
                    if hoist else g

            if microbatches == 1:
                loss, grads = grads_of(batch)
                grads = reshard(grads)
            else:
                parts = {k: _split(v, microbatches, 1 if k == "positions3"
                                   else 0) for k, v in batch.items()}
                grads, loss = None, 0.0
                for i in range(microbatches):
                    l, g = grads_of({k: v[i] for k, v in parts.items()})
                    g = reshard([x.to(torch.bfloat16) for x in g])
                    grads = [x.float() for x in g] if grads is None else \
                        [a + x.float() for a, x in zip(grads, g)]
                    loss = loss + l.detach()
                grads = [g / microbatches for g in grads]
                loss = loss / microbatches
            for p, home in zip(leaves, homes):
                set_param(p, p.redistribute(*home))
            lr = warmup_cosine(opt_state.step, 3e-4, 2000, 100_000)
            new, opt_state, _ = adamw.update(
                T.unflatten(model.parameter_tree(), grads), opt_state, lr,
                opt_cfg)
            model.load_params(new)
            return model.params(), opt_state, loss.detach()
    return train_step


def build_prefill_step(model: LM, mesh=None):
    """(params, batch, cache) -> (last logits, cache)."""
    def prefill_step(params, batch, cache):
        with _replicated() if mesh is not None else nullcontext():
            model.load_params(params)
            return model.prefill(batch, cache)
    return prefill_step


def build_decode_step(model: LM, mesh=None):
    """(params, cache, token, t) -> (logits, cache)."""
    def decode_step(params, cache, token, t):
        with _replicated() if mesh is not None else nullcontext():
            model.load_params(params)
            return model.decode_step(cache, token, t)
    return decode_step


# -------------------------------------------------------------------- runner
def _local_bytes(tree) -> int:
    """Bytes of rank 0's shards of a tree of DTensors."""
    return sum(x.to_local().numel() * x.element_size()
               for x in T.leaves(tree))


class _CommCounts:
    """Counts the collectives a block issues, by type, as ``CommDebugMode``
    does: a dispatch mode that lets DTensor's own dispatch run under it (so
    it sees the collectives of every redistribution) and counts the
    functional collectives.  ``CommDebugMode`` itself also tracks modules,
    and its hooks fail on a checkpointed block that a second microbatch
    calls again."""

    _NAMESPACES = ("_c10d_functional", "c10d_functional")
    _COLLECTIVES = ("all_reduce", "all_gather_into_tensor",
                    "reduce_scatter_tensor", "all_to_all_single",
                    "broadcast", "all_reduce_coalesced",
                    "all_gather_into_tensor_coalesced",
                    "reduce_scatter_tensor_coalesced")

    def __init__(self):
        self.counts: Dict[str, int] = {}

    def __enter__(self):
        from torch.distributed.tensor import DTensor
        from torch.utils._python_dispatch import TorchDispatchMode
        counts, spaces, names = (self.counts, self._NAMESPACES,
                                 self._COLLECTIVES)

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                if any(t is DTensor for t in types):
                    return NotImplemented
                name = func.overloadpacket.__name__
                if func.namespace in spaces and name in names:
                    counts[name] = counts.get(name, 0) + 1
                return func(*args, **(kwargs or {}))
        self._mode = Mode()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self._mode.__exit__(*exc)


def _step(cfg: ModelConfig, mode: str, B: int, T_: int, microbatches: int,
          mesh=None, rules=None, memory: Optional[dict] = None):
    """Build the cell's model and inputs on meta (sharded on ``mesh`` when
    given, with rank 0's bytes written into ``memory``) and return a thunk
    that runs the step once."""
    from repro_torch.checkpoint.elastic import load_for_mesh
    params = LM(cfg, device="meta").params()
    bax = rules["batch"] if rules else None
    pspecs = None
    if mesh is not None:
        pspecs = SH.layer_param_specs(params, cfg, mesh)
        params = load_for_mesh(params, mesh, pspecs)
        memory["params_per_device"] = _local_bytes(params)
    model = LM(cfg, device="meta", params=params, remat=(mode == "train"))
    params = model.params()
    batch = train_inputs(cfg, B, T_)
    if mesh is not None:
        batch = place_batch(batch, mesh, bax)
    if mode == "train":
        model.requires_grad_(True)
        opt = adamw.init(params)
        if mesh is not None:
            opt = place_opt_state(opt, mesh,
                                  SH.layer_opt_specs(params, cfg, mesh))
            memory["opt_state_per_device"] = sum(
                _local_bytes(getattr(opt, k)) for k in ("master", "m", "v"))
        step = build_train_step(model, microbatches, mesh, pspecs)
        return lambda: step(params, opt, batch)
    cache = model.init_cache(B, T_)
    if mesh is not None:
        cache = load_for_mesh(cache, mesh, SH.cache_specs(cache, B, T_, mesh,
                                                          bax))
        memory["cache_per_device"] = _local_bytes(cache)
    if mode == "prefill":
        batch.pop("labels", None)
        step = build_prefill_step(model, mesh)
        return lambda: step(params, batch, cache)
    K = cfg.n_codebooks
    tok = {"tokens": torch.zeros((B, 1, K) if K > 1 else (B, 1),
                                 dtype=torch.long, device="meta")}
    if mesh is not None:
        tok = place_batch(tok, mesh, bax)
    step = build_decode_step(model, mesh)
    return lambda: step(params, cache, tok["tokens"], T_ - 1)


def run_cell(arch: str, shape_name: str, mesh_shape: Dict[str, int],
             microbatches: Optional[int] = None, verbose: bool = True
             ) -> Dict[str, Any]:
    """One cell on a fake mesh of ``mesh_shape`` ({axis: size}, the major
    axis first), in this process (which it gives the fake process group).
    A train cell takes the reference's microbatches (two sequences a data
    shard each) unless ``microbatches`` says otherwise; the FLOPs are
    counted with one, which changes no product's total."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch.mesh import make_mesh

    cfg = get_config(arch)
    shp = SHAPES[shape_name]
    B, T_, mode = shp["global_batch"], shp["seq_len"], shp["mode"]
    chips = int(np.prod(list(mesh_shape.values())))
    if dist.is_initialized() and dist.get_world_size() != chips:
        dist.destroy_process_group()       # a fake group of another mesh
    if not dist.is_initialized():
        dist.init_process_group("fake", rank=0, world_size=chips,
                                store=FakeStore())
    mesh = make_mesh(mesh_shape, "cpu")
    rules = SH.logical_rules(mesh_shape, B, cfg)
    bax = rules["batch"]
    dp = SH.axis_size(bax, mesh_shape)
    if microbatches is None:
        microbatches = max(1, (B // dp) // 2) if mode == "train" else 1
    total_p, active_p = param_count(cfg)
    memory: Dict[str, int] = {}
    rec: Dict[str, Any] = {
        "arch": arch, "shape": shape_name, "mode": mode,
        "mesh": dict(mesh_shape), "chips": chips, "global_batch": B,
        "seq_len": T_, "microbatches": microbatches,
        "params_total": total_p, "params_active": active_p,
        "rules": rules, "ok": False, "memory": memory}

    t0 = time.time()
    with logical_axis_rules(mesh, rules):
        run = _step(cfg, mode, B, T_, microbatches, mesh, rules, memory)
        with _CommCounts() as comm:
            run()
    rec["collectives"] = comm.counts
    rec["sharded_s"] = time.time() - t0

    params = LM(cfg, device="meta").params()
    memory["param_elements"] = sum(x.numel() for x in T.leaves(params))
    memory["param_bytes"] = sum(x.numel() * x.element_size()
                                for x in T.leaves(params))
    t0 = time.time()
    run = _step(cfg, mode, B, T_, 1)
    with FlopCounterMode(display=False) as fc:
        run()
    rec["flops"] = float(fc.get_total_flops())
    rec["flops_s"] = time.time() - t0
    rec["analytic"] = analytic_cost(cfg, B, T_, mode)
    rec["model_flops"] = rec["analytic"]["model_flops"]
    rec["ok"] = True
    if verbose:
        print(json.dumps({k: rec[k] for k in ("arch", "shape", "mesh",
                                             "memory", "flops",
                                             "model_flops", "collectives")}))
    return rec


def cell_path(arch: str, shape: str, multi_pod: bool) -> str:
    pods = "pod2" if multi_pod else "pod1"
    return os.path.join(OUT_DIR, f"{arch}__{shape}__{pods}.json")


def _write_skip(arch: str, shape: str) -> None:
    for mp in (False, True):
        with open(cell_path(arch, shape, mp), "w") as f:
            json.dump({"arch": arch, "shape": shape, "ok": True,
                       "skipped": "full-attention arch at 500k (DESIGN.md §5)",
                       "chips": 512 if mp else 256}, f, indent=2)


def _launch(cmd) -> int:
    """Run one cell's command; its exit code."""
    return subprocess.run(cmd).returncode


def sweep(force: bool = False) -> int:
    """Every (arch, applicable shape) on both production meshes, a
    subprocess a cell, skipping a cell whose record exists unless
    ``force``; skip records for the shapes an arch does not take."""
    failures = []
    for arch in ARCH_IDS:
        for shape in SHAPES:
            if not shape_applicable(arch, shape):
                _write_skip(arch, shape)
                continue
            for mp in (False, True):
                if os.path.exists(cell_path(arch, shape, mp)) and not force:
                    continue
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                       "--arch", arch, "--shape", shape]
                if mp:
                    cmd.append("--multi-pod")
                print(">>", " ".join(cmd), flush=True)
                if _launch(cmd) != 0:
                    failures.append((arch, shape, mp))
    print("FAILURES:", failures)
    return 1 if failures else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--mesh", default=None,
                    help="axis=size,... in mesh order, e.g. data=8,model=8 "
                         "(default: the production mesh)")
    ap.add_argument("--out", default=None,
                    help="the JSON record's path (default: cell_path)")
    ap.add_argument("--microbatches", type=int, default=None,
                    help="train cells: default two sequences a data shard")
    args = ap.parse_args(argv)
    if args.all:
        if args.mesh or args.out or args.microbatches:
            ap.error("--all runs the production meshes' defaults into "
                     "OUT_DIR")
        os.makedirs(OUT_DIR, exist_ok=True)
        return sweep(args.force)
    if not (args.arch and args.shape):
        ap.error("--arch and --shape are required without --all")
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    if len(meshes) > 1 and (args.mesh or args.out):
        ap.error("--both-meshes writes the production meshes' records")
    if args.mesh and not args.out:
        ap.error("--mesh needs --out: OUT_DIR holds the production meshes' "
                 "records")
    for mp in meshes:
        mesh_shape = ({k: int(v) for k, v in
                       (kv.split("=") for kv in args.mesh.split(","))}
                      if args.mesh else make_production_mesh(multi_pod=mp))
        rec = run_cell(args.arch, args.shape, mesh_shape, args.microbatches)
        out = args.out or cell_path(args.arch, args.shape, mp)
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w") as f:
            json.dump(rec, f, indent=2)
        print(json.dumps({k: rec[k] for k in
                          ("arch", "shape", "chips", "ok", "sharded_s",
                           "flops_s")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
