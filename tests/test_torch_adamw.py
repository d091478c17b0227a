"""AdamW's two passes (``kernels/adamw``): on the CPU the plain versions,
through ``optim.adamw.update``, against the update's previous code, kept
below as the yardstick, bit for bit (bf16 and f32 gradients, clipped or
not, leaves over ``CHUNK``); the ops' dispatch (CPU and meta tensors to the
plain versions, DTensors to their local shards); the CUDA wrappers'
refusals.  On the card (the ``card`` marker; skipped without CUDA) the
kernels against the plain versions, and their launch counts:

    python -m pytest tests/test_torch_adamw.py -m card

Tolerances on the card, each with its reason:

* the update's master, m, v and bf16 params are the plain version's bit
  for bit, given the same clip scale, lr and bias corrections: the kernel
  takes the eager operations in their order, each rounded on its own.
* the norm's sum of squares: relative 1e-5 (``NORM_REL_TOL``).  It sums in
  f32 in another order than ``torch.sum``; the error of either order is a
  few ulps times log2 of the terms summed per partial, well under 1e-5 of
  a sum of squares (no cancellation).  The same leaves give the same bits
  from run to run.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import pytest
import torch

from repro_torch import tree as T
from repro_torch.kernels.adamw import adamw as K
from repro_torch.kernels.adamw import ops, ref
from repro_torch.optim import adamw

NORM_REL_TOL = 1e-5


# ---------------------------------------------- the update's previous code
def _old_local_sum_sq(x, chunk):
    if x.numel() <= chunk:
        return torch.sum(torch.square(x.float()))
    x = x.reshape(-1)
    return sum(torch.sum(torch.square(x[i:i + chunk].float()))
               for i in range(0, x.numel(), chunk))


@torch.no_grad()
def _old_update(grads, state, lr, cfg, chunk
                ) -> Tuple[Any, adamw.AdamWState, Dict[str, torch.Tensor]]:
    """``optim/adamw.py update`` before the kernels, for plain tensors."""
    gl, pl, ml, vl = (T.leaves(t) for t in (grads, state.master, state.m,
                                              state.v))
    gnorm = torch.sqrt(sum(_old_local_sum_sq(x, chunk) for x in gl))
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    b1c = 1.0 - cfg.b1 ** step.float()
    b2c = 1.0 - cfg.b2 ** step.float()

    def upd(g, p, m, v):
        new = torch.empty(p.shape, dtype=torch.bfloat16, device=p.device)
        g = g.reshape(-1)
        flat = [x.view(-1) for x in (p, m, v, new)]
        for i in range(0, g.numel(), chunk):
            p_, m_, v_, new_ = (x[i:i + chunk] for x in flat)
            g_ = g[i:i + chunk].float() * scale
            m_.copy_(cfg.b1 * m_ + (1 - cfg.b1) * g_)
            v_.copy_(cfg.b2 * v_ + (1 - cfg.b2) * g_ * g_)
            mh = m_ / b1c
            vh = v_ / b2c
            p_.copy_(p_ - lr * (mh / (torch.sqrt(vh) + cfg.eps)
                                + cfg.weight_decay * p_))
            new_.copy_(p_.to(torch.bfloat16))
        return new

    bf16 = [upd(g, p, m, v) for g, p, m, v in zip(gl, pl, ml, vl)]
    return T.unflatten(grads, bf16), adamw.AdamWState(
        step, state.master, state.m, state.v), {
        "grad_norm": gnorm, "clip_scale": scale}


def _trees(seed: int, device="cpu"):
    """bf16 params and a source of gradients of the same shapes, the
    shapes of a small model: a matrix, a bank, a vector and a scalar-like
    leaf."""
    rng = np.random.default_rng(seed)

    def leaf(shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32) * 0.5).to(device).bfloat16()
    params = {"w": leaf((12, 11)), "bank": {"e": leaf((3, 5, 7))},
              "b": leaf((9,)), "s": leaf((1,))}

    def grads(step, scale, dtype):
        r = np.random.default_rng(seed * 100 + step)
        return T.tree_map(lambda p: torch.from_numpy(r.standard_normal(
            tuple(p.shape)).astype(np.float32) * scale).to(device).to(dtype),
            params)
    return params, grads


def _bits(x: torch.Tensor) -> torch.Tensor:
    ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    return x.contiguous().view(ints[x.dtype])


def _assert_same(a, b) -> None:
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(_bits(a), _bits(b))


def _copy_state(s: adamw.AdamWState) -> adamw.AdamWState:
    return adamw.AdamWState(*(T.tree_map(lambda x: x.clone(), t) for t in s))


# ------------------------------------------------------------- on the CPU
@pytest.mark.parametrize("chunk", [ref.CHUNK, 7], ids=["whole", "chunk7"])
@pytest.mark.parametrize("grad_scale", [0.01, 10.0],
                         ids=["unclipped", "clipped"])
@pytest.mark.parametrize("gdtype", [torch.bfloat16, torch.float32],
                         ids=["bf16_grads", "f32_grads"])
def test_plain_update_equals_the_previous_code(gdtype, grad_scale, chunk,
                                               monkeypatch):
    """Three steps of ``optim.adamw.update`` on the CPU (the plain versions)
    against the previous code, state, params and metrics bit for bit; with
    ``chunk`` 7 every leaf over 7 elements is taken in slices."""
    monkeypatch.setattr(ref, "CHUNK", chunk)
    params, grads = _trees(4)
    cfg = adamw.AdamWConfig()
    new_state = adamw.init(params)
    old_state = _copy_state(new_state)
    for i in range(3):
        g = grads(i, grad_scale, gdtype)
        lr = torch.tensor(1e-3 * (i + 1))
        got, new_state, gm = adamw.update(g, new_state, lr, cfg)
        want, old_state, wm = _old_update(g, old_state, lr, cfg, chunk)
        for a, b in zip(T.leaves(got), T.leaves(want)):
            _assert_same(a, b)
        for t_new, t_old in zip(new_state[1:], old_state[1:]):
            for a, b in zip(T.leaves(t_new), T.leaves(t_old)):
                _assert_same(a, b)
        assert int(new_state.step) == int(old_state.step) == i + 1
        for k in ("grad_norm", "clip_scale"):
            _assert_same(gm[k], wm[k])
    assert (float(gm["clip_scale"]) < 1.0) == (grad_scale > 1)


def test_ops_send_cpu_and_meta_tensors_to_the_plain_versions(monkeypatch):
    calls = {"update": 0, "sum_squares": 0}

    def counting(name):
        fn = getattr(ref, name)

        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped
    for name in calls:
        monkeypatch.setattr(ref, name, counting(name))
    before = (K.launches, K.norm_launches, K.finish_launches)
    params, grads = _trees(5)
    state = adamw.init(params)
    adamw.update(grads(0, 0.1, torch.bfloat16), state, torch.tensor(1e-3))
    assert calls == {"update": 4, "sum_squares": 1}
    # meta tensors (the dry run's shapes): outputs of the right shapes
    g = torch.empty((6, 5), dtype=torch.bfloat16, device="meta")
    p, m, v = (torch.empty((6, 5), device="meta") for _ in range(3))
    one = torch.ones((), device="meta")
    [new] = ops.update([g], [p], [m], [v], one, one, one, one, 0.9, 0.95,
                       1e-8, 0.1)
    assert new.device.type == "meta" and new.dtype == torch.bfloat16
    assert new.shape == (6, 5)
    sums, total = ops.sum_squares([g, p])
    assert [s.shape for s in sums] == [(), ()] and total.device.type == "meta"
    assert calls == {"update": 5, "sum_squares": 2}
    assert (K.launches, K.norm_launches, K.finish_launches) == before


@pytest.fixture
def mesh2():
    """A 2-rank mesh on a fake process group in this process (as the dry
    run makes one): DTensors whose local shards are real."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", rank=0, world_size=2, store=FakeStore())
    try:
        yield init_device_mesh("cpu", (2,))
    finally:
        dist.destroy_process_group()


def test_ops_run_dtensors_on_their_local_shards(mesh2):
    from torch.distributed.tensor import DTensor, Shard
    rng = np.random.default_rng(6)

    def local(scale, dtype=torch.float32, square=False):
        x = torch.from_numpy(rng.standard_normal((3, 4)).astype(
            np.float32) * scale)
        return (x * x if square else x).to(dtype)
    g, p, m, v = (local(0.1, torch.bfloat16), local(0.5), local(1e-2),
                  local(1e-2, square=True))
    want_p, want_m, want_v = (x.clone() for x in (p, m, v))
    dts = [DTensor.from_local(x, mesh2, [Shard(0)], run_check=False)
           for x in (g, p, m, v)]
    scalars = (torch.tensor(0.8), torch.tensor(1e-3), torch.tensor(0.1),
               torch.tensor(0.05))
    [new] = ops.update(*([x] for x in dts), *scalars, 0.9, 0.95, 1e-8, 0.1)
    want = ref.update(g, want_p, want_m, want_v, *scalars, 0.9, 0.95, 1e-8,
                      0.1)
    assert isinstance(new, DTensor) and new.placements == (Shard(0),)
    assert new.shape == (6, 4)
    _assert_same(new.to_local(), want)
    for dt, w in zip(dts[1:], (want_p, want_m, want_v)):
        _assert_same(dt.to_local(), w)               # written in place
    sums, total = ops.sum_squares([dts[0], p])
    want_sums, want_total = ref.sum_squares([g, p])
    for a, b in zip(sums, want_sums):
        _assert_same(a, b)
    _assert_same(total, want_total)


def test_cuda_wrappers_refuse_what_they_cannot_take():
    p = torch.zeros(8)
    one = torch.ones(())
    with pytest.raises(ValueError, match="on the card"):
        K.update_cuda([p.bfloat16()], [p], [p.clone()], [p.clone()], one,
                      one, one, one, 0.9, 0.95, 1e-8, 0.1)
    with pytest.raises(TypeError, match="gradient"):
        K.check_update(p.half(), p, p, p, p.device)
    with pytest.raises(TypeError, match="master"):
        K.check_update(p.bfloat16(), p.bfloat16(), p, p, p.device)
    with pytest.raises(ValueError, match="at least one"):
        K.sum_squares_cuda([])
    for bad in (torch.ones((), dtype=torch.float64), torch.ones(1)):
        with pytest.raises(ValueError, match="lr must be a 0-d float32"):
            K.check_scalars((("scale", one), ("lr", bad)), one.device)
    with pytest.raises(ValueError, match="on the card"):
        K.sum_squares_cuda([p])
    with pytest.raises(TypeError, match="leaf 0"):
        K.sum_squares_cuda([p.half()])


# ------------------------------------------------------------- on the card
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda")


def _twin(x: torch.Tensor, offset: int) -> torch.Tensor:
    """A copy of ``x`` that starts ``offset`` elements into a buffer of its
    own."""
    buf = torch.empty(x.numel() + offset, dtype=x.dtype, device=x.device)
    out = buf[offset:].view(x.shape)
    out.copy_(x)
    return out


def _leaf_inputs(card, shape, gdtype, offset, seed=0):
    """(g, master, m, v) of ``shape`` on views ``offset`` elements into
    their buffers; g ~ 1e-3 in ``gdtype``, m ~ 1e-4, v ~ 1e-8 (>= 0)."""
    gen = torch.Generator(device=card).manual_seed(seed)
    n = int(np.prod(shape))

    def leaf(scale, dtype=torch.float32, square=False):
        x = torch.randn(n, generator=gen, device=card) * scale
        return _twin((x * x if square else x).to(dtype).view(shape), offset)
    return (leaf(1e-3, gdtype), leaf(0.02), leaf(1e-4),
            leaf(1e-4, square=True))


def _scalars(card, step=3):
    s = torch.full((), step, dtype=torch.int32, device=card)
    return (torch.full((), 0.73, device=card),
            torch.full((), 3e-4, device=card),
            1.0 - 0.9 ** s.float(), 1.0 - 0.95 ** s.float())


HYPER = (0.9, 0.95, 1e-8, 0.1)
# the train cell's leaf shapes (deepseek-v2-lite-16b: an expert bank, the
# embedding, a norm's weight), a ragged leaf, a leaf of three 8-element
# units and a tail of 7 (the tail ~7/31 of its sum of squares, so a tail
# dropped or counted twice fails the norm's tolerance), a leaf under 8
# elements and views one element past an aligned start (the scalar path)
CARD_CASES = [((64, 2048, 1408), torch.bfloat16, 0),
              ((102400, 2048), torch.bfloat16, 0),
              ((2048,), torch.bfloat16, 0),
              ((2048,), torch.float32, 0),
              ((1000003,), torch.bfloat16, 0),
              ((1000003,), torch.float32, 0),
              ((31,), torch.bfloat16, 0),
              ((31,), torch.float32, 0),
              ((5,), torch.bfloat16, 0),
              ((4096, 1027), torch.bfloat16, 1),
              ((4096, 1027), torch.float32, 1)]


@pytest.mark.card
@pytest.mark.parametrize("shape, gdtype, offset", CARD_CASES)
def test_update_kernel_equals_the_plain_version(card, shape, gdtype, offset):
    g, p, m, v = _leaf_inputs(card, shape, gdtype, offset)
    got = [_twin(x, offset) for x in (p, m, v)]
    want = [_twin(x, offset) for x in (p, m, v)]
    scalars = _scalars(card)
    before = K.launches
    [new] = K.update_cuda([g], *([x] for x in got), *scalars, *HYPER)
    new_ref = ref.update(g, *want, *scalars, *HYPER)
    torch.cuda.synchronize()
    assert K.launches - before == 1
    for a, b in zip(got + [new], want + [new_ref]):
        _assert_same(a, b)


@pytest.mark.card
def test_norm_is_the_plain_one_within_f32_rounding_and_repeats(card):
    leaves = [_leaf_inputs(card, shape, gdtype, offset, seed=k)[0]
              for k, (shape, gdtype, offset) in enumerate(CARD_CASES)]
    before = (K.norm_launches, K.finish_launches)
    sums, total = K.sum_squares_cuda([x.reshape(-1) for x in leaves])
    sums2, total2 = K.sum_squares_cuda([x.reshape(-1) for x in leaves])
    want_sums, want_total = ref.sum_squares(leaves)
    torch.cuda.synchronize()
    assert (K.norm_launches - before[0], K.finish_launches - before[1]) \
        == (2 * len(leaves), 2)
    for a, b in zip(sums + [total], want_sums + [want_total]):
        assert abs(a.item() - b.item()) <= NORM_REL_TOL * b.item()
    for a, b in zip(sums + [total], sums2 + [total2]):
        _assert_same(a, b)


def _card_tree(card, scale):
    params, grads = _trees(8, device=card)
    return params, grads(0, scale, torch.bfloat16)


@pytest.mark.card
def test_update_launches_each_kernel_and_waits_for_no_host(card):
    params, g = _card_tree(card, 0.1)
    state = adamw.init(params)
    lr = torch.full((), 1e-3, device=card)
    leaves = len(T.leaves(params))
    before = (K.launches, K.norm_launches, K.finish_launches)
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            _, state, _ = adamw.update(g, state, lr)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert (K.launches - before[0], K.norm_launches - before[1],
            K.finish_launches - before[2]) == (3 * leaves, 3 * leaves, 3)


@pytest.mark.card
def test_update_on_the_card_is_the_plain_one_unclipped(card, monkeypatch):
    """Below the clip the scale is 1 whatever the norm's order, so the whole
    update on the kernels gives the plain versions' state and params bit
    for bit, and the same norm within f32 rounding."""
    params, g = _card_tree(card, 1e-3)
    lr = torch.full((), 1e-3, device=card)
    state = adamw.init(params)
    plain_state = _copy_state(state)
    new, state, metrics = adamw.update(g, state, lr)
    monkeypatch.setattr(ops, "update", lambda gs, ps, ms, vs, *a: [
        ref.update(g, p, m, v, *a) for g, p, m, v in zip(gs, ps, ms, vs)])
    monkeypatch.setattr(ops, "sum_squares", ref.sum_squares)
    want, plain_state, want_metrics = adamw.update(g, plain_state, lr)
    assert float(metrics["clip_scale"]) == 1.0
    for a, b in zip(T.leaves(new), T.leaves(want)):
        _assert_same(a, b)
    for t, u in zip(state[1:], plain_state[1:]):
        for a, b in zip(T.leaves(t), T.leaves(u)):
            _assert_same(a, b)
    assert float(metrics["grad_norm"]) == pytest.approx(
        float(want_metrics["grad_norm"]), rel=NORM_REL_TOL)


@pytest.mark.card
def test_wrapper_refuses_a_non_contiguous_master(card):
    p = torch.zeros((8, 4), device=card).t()
    one = torch.ones((), device=card)
    with pytest.raises(ValueError, match="contiguous"):
        K.update_cuda([torch.zeros(32, dtype=torch.bfloat16, device=card)],
                      [p], [torch.zeros(32, device=card)],
                      [torch.zeros(32, device=card)], one, one, one, one,
                      *HYPER)
