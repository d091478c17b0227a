"""The port's MoE training against the JAX package's, on the CPU.

The smoke configs of deepseek-v2-lite-16b and qwen3-moe-30b-a3b with the
JAX package's own parameters (the ``models`` fixture of
``test_torch_moe.py``): the loss, its ``aux`` and every gradient against
``jax.value_and_grad(model.loss_fn)`` within 1e-4, with and without remat,
and one AdamW step on the same seeded gradients equal, the router's f32
state included.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as jadamw
from repro_torch import tree as T
from repro_torch.optim import adamw
from test_torch_moe import ARCHS, B, T_, _t, _tokens, models  # noqa: F401

GRAD_TOL = 1e-4


_JAX_GRADS = {}


def _jax_loss_and_grads(arch, jlm, params, batch):
    """``jax.value_and_grad(jlm.loss_fn)`` of ``batch``, once per arch."""
    if arch not in _JAX_GRADS:
        _JAX_GRADS[arch] = jax.jit(jax.value_and_grad(
            jlm.loss_fn, has_aux=True))(
            params, {k: jnp.asarray(v) for k, v in batch.items()})
    return _JAX_GRADS[arch]


def _batch(cfg, seed):
    toks = _tokens(cfg, seed, (B, T_ + 1))
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _banks(tlm, flat):
    """The port's per-leaf list (``parameter_tree`` order) as the
    reference's leaves: blocks stacked into banks."""
    tree = T.unflatten(tlm.parameter_tree(), list(flat))
    return T.leaves(T.stack_layers(tree, torch.stack))


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_aux_and_grads_equal_reference(arch, remat, models):
    cfg, jlm, params, tlm = models[arch, "f32"]
    batch = _batch(cfg, seed=7)
    (jloss, jm), jgrads = _jax_loss_and_grads(arch, jlm, params, batch)
    tlm.remat = remat
    tlm.requires_grad_(True)
    try:
        loss, metrics = tlm.loss_fn(batch)
        grads = torch.autograd.grad(loss, T.leaves(tlm.parameter_tree()))
    finally:
        tlm.requires_grad_(False)
        tlm.remat = True
    assert float(metrics["aux"].detach()) > 0
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=GRAD_TOL)
    for k in ("ce", "aux"):
        assert float(metrics[k].detach()) == pytest.approx(float(jm[k]),
                                                           rel=GRAD_TOL)
    jleaves = jax.tree_util.tree_leaves(jgrads)
    got = _banks(tlm, grads)
    assert len(jleaves) == len(got)
    for a, b in zip(jleaves, got):
        a = np.asarray(a)
        assert b.shape == a.shape
        np.testing.assert_allclose(b.numpy(), a, rtol=GRAD_TOL,
                                   atol=GRAD_TOL * np.abs(a).max())


@pytest.mark.parametrize("arch", ARCHS)
def test_adamw_step_equal_with_router_f32(arch, models):
    """One AdamW step from the model's bf16 params on seeded gradients of
    the params' dtypes, small enough that the step does not clip (a clip
    scale takes the global norm's rounding, which depends on the order of
    its sums): f32 state within 1e-6 relative, the new bf16 params equal;
    the router's master and moments stay f32."""
    _, _, params, tlm = models[arch, "bf16"]
    rng = np.random.default_rng(8)
    gnp = [1e-4 * rng.standard_normal(a.shape).astype(np.float32)
           for a in jax.tree_util.tree_leaves(params)]
    jgrads = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(params),
        [jnp.asarray(g, a.dtype) for g, a in
         zip(gnp, jax.tree_util.tree_leaves(params))])
    # eager, as the port runs it: jitted, XLA rounds some of the state a
    # last bit apart
    jp, jstate, _ = jadamw.update(jgrads, jax.jit(jadamw.init)(params),
                                  jnp.float32(1e-3))
    tparams = tlm.params()
    routers = [b["moe"]["router"] for b in tparams["blocks"]]
    assert all(r.dtype == torch.float32 for r in routers)
    assert sum(x.dtype == torch.float32 for x in T.leaves(tparams)) == len(
        routers)
    tgrads = T.unstack_layers(tparams, T.unflatten(
        T.stack_layers(tparams, lambda xs: xs[0]),
        [_t(g, torch.bfloat16 if a.dtype == jnp.bfloat16 else torch.float32)
         for g, a in zip(jax.tree_util.tree_leaves(jgrads),
                         jax.tree_util.tree_leaves(params))]))
    tp, tstate, metrics = adamw.update(tgrads, adamw.init(tparams),
                                       torch.tensor(1e-3))
    assert float(metrics["clip_scale"]) == 1.0
    for jt, tt in ((jstate.master, tstate.master), (jstate.m, tstate.m),
                   (jstate.v, tstate.v)):
        assert all(b["moe"]["router"].dtype == torch.float32
                   for b in tt["blocks"])
        got = T.leaves(T.stack_layers(tt, torch.stack))
        for a, b in zip(jax.tree_util.tree_leaves(jt), got):
            assert b.dtype == torch.float32
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                       atol=0)
    got = T.leaves(T.stack_layers(tp, torch.stack))
    for a, b in zip(jax.tree_util.tree_leaves(jp), got):
        assert b.dtype == torch.bfloat16 and a.dtype == jnp.bfloat16
        np.testing.assert_array_equal(b.float().numpy(),
                                      np.asarray(a, np.float32))
