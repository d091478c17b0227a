"""The decode step as a CUDA graph (``LM.decode_step`` on the card), on the
CPU.

A CUDA graph cannot be captured here, so ``capture`` is replaced by one that
keeps the step's body and runs it again at each ``replay``, into the output
the capture returned: everything else (the static token and state buffers,
the copy of a foreign cache into them, the restore before the first replay,
the reuse of the graph's own cache, the recapture after ``load_params``) is
the program's.  The eligibility rule is asked as on a CUDA device (the
model's ``device`` set to cuda, no kernel run): it takes falcon-mamba-7b's
``ssm`` pattern and refuses the five other patterns, Jamba's ``mixed`` one
among them; a model with DTensor parameters is refused in
``tests/test_torch_sharded.py``'s gloo ranks.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models.model import LM as JLM
from repro.serve.engine import Engine as JEngine
from repro_torch import tree as T
from repro_torch.configs import get_config
from repro_torch.models import model as M
from repro_torch.models.model import LM
from repro_torch.models.params import params_from_jax
from repro_torch.obs import spans
from repro_torch.serve.engine import Engine
from test_torch_jamba import SMALL
from test_torch_plan import jamba_config

ARCH = "falcon-mamba-7b"
REFUSED = ("smollm-135m", "deepseek-v2-lite-16b", "gemma3-27b",
           "zamba2-1.2b", "jamba2-mini")


class Replayed:
    """A captured step on the CPU: ``replay`` runs the body again and
    writes its result into the output the capture returned."""

    def __init__(self, body, out):
        self.body, self.out, self.replays = body, out, 0

    def replay(self):
        self.out.copy_(self.body())
        self.replays += 1

    def pool(self):
        return None


@pytest.fixture
def graphs(monkeypatch):
    """Models that take the graph path on the CPU: ``on(lm)`` marks one;
    the captures made are listed."""
    made = []

    def capture(body, device, pool):
        body()                                  # the warm-up
        g = Replayed(body, body())
        made.append(g)
        return g, g.out
    monkeypatch.setattr(M, "capture", capture)

    def on(lm):
        lm.graphs_decode = lambda: True
        return lm
    on.made = made
    return on


@pytest.fixture
def log(monkeypatch):
    fresh = spans.LOG.__class__(maxlen=spans.CAPACITY)
    monkeypatch.setattr(spans, "LOG", fresh)
    return fresh


@pytest.fixture(scope="module")
def reference():
    """(JAX config, JAX f32 params, their numpy tree) of the smoke config."""
    jcfg = jget_config(ARCH).smoke()
    params = JLM(jcfg, dtype=jnp.float32, remat=False).init(
        jax.random.PRNGKey(0))
    return jcfg, params, jax.tree_util.tree_map(
        lambda a: np.array(a, np.float32), params)


def _port(reference):
    return params_from_jax(reference[2], get_config(ARCH).smoke(),
                           device="cpu", dtype=torch.float32)


def _prompts(vocab):
    rng = np.random.default_rng(3)
    return [rng.integers(0, vocab, n) for n in (5, 11, 7)]


def _serve(eng, prompts, max_new):
    for p in prompts:
        eng.submit(p, max_new_tokens=max_new)
    return [r.out_tokens for r in sorted(eng.run_to_completion(),
                                         key=lambda r: r.rid)]


def test_graph_engine_returns_the_eager_and_reference_tokens(
        reference, graphs, log):
    """Two waves through one engine: the first captures at its first
    step and replays on the graph's own cache; the second's prefill cache
    is copied into that state.  Tokens equal the eager engine's and the
    JAX engine's."""
    jcfg, params, _ = reference
    prompts = _prompts(jcfg.vocab_size)
    jeng = JEngine(jcfg, params, max_batch=2, max_seq=32)
    want = _serve(jeng, prompts, 6)
    cfg = get_config(ARCH).smoke()
    eager = Engine(cfg, model=_port(reference), max_batch=2, max_seq=32,
                   device="cpu")
    got_eager = _serve(eager, prompts, 6)
    paths = [r.attrs["graph"] for r in log if r.name == "lm.decode_step"]
    assert paths and set(paths) == {"eager"}
    log.clear()
    lm = graphs(_port(reference))
    eng = Engine(cfg, model=lm, max_batch=2, max_seq=32, device="cpu")
    caches = []
    step = lm.decode_step

    def seen(cache, token, t):
        caches.append(cache)
        return step(cache, token, t)
    lm.decode_step = seen
    got = _serve(eng, prompts, 6)
    assert got == got_eager == want
    assert eng.waves == 2 and len(graphs.made) == 1
    g = lm._graphs[2]
    paths = [r.attrs["graph"] for r in log if r.name == "lm.decode_step"]
    assert paths == ["capture"] + ["replay"] * (len(paths) - 1)
    assert graphs.made[0].replays == len(paths)
    # each wave's first step is handed its prefill's cache, the rest the
    # graph's own, which every step returns
    foreign = [i for i, c in enumerate(caches) if c is not g.cache]
    assert foreign == [0, 5]
    assert all(c is g.cache for i, c in enumerate(caches)
               if i not in foreign)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_graph_step_is_the_eager_step_bit_for_bit(dtype, graphs):
    """Logits and state of the graph's step equal the eager step's exactly,
    from a prefill's cache and then from the graph's own."""
    cfg = get_config(ARCH).smoke()
    eager = LM(cfg, dtype=dtype, device="cpu", seed=1)
    lm = graphs(LM(cfg, dtype=dtype, device="cpu", params=eager.params()))
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (3, 12)))
    _, c_eager = eager.prefill(toks[:, :8], eager.init_cache(3, 16))
    _, c_graph = lm.prefill(toks[:, :8], lm.init_cache(3, 16))
    for t in range(8, 12):
        want, c_eager = eager.decode_step(c_eager, toks[:, t:t + 1], t)
        got, c_graph = lm.decode_step(c_graph, toks[:, t:t + 1], t)
        assert lm.decode_path == ("capture" if t == 8 else "replay")
        assert eager.decode_path == "eager"
        assert torch.equal(got, want)
        for a, b in zip(T.leaves(c_graph), T.leaves(c_eager)):
            assert a.dtype == b.dtype and torch.equal(a, b)
    assert c_graph is lm._graphs[3].cache and len(graphs.made) == 1


def test_a_cache_of_other_dtypes_or_parameters_recaptures(graphs):
    """A cache whose state a step would give in other dtypes (an f32 conv
    state for a bf16 model) captures anew at its batch size, as does a new
    batch size; ``load_params`` drops the graphs, whose buffers read the
    old parameters, and asks the rule again."""
    cfg = get_config(ARCH).smoke()
    lm = graphs(LM(cfg, dtype=torch.bfloat16, device="cpu", seed=2))
    tok = torch.zeros((2, 1), dtype=torch.long)
    lm.decode_step(lm.init_cache(2, 8), tok, 0)
    assert lm.decode_path == "capture"
    lm.decode_step(lm.init_cache(2, 8), tok, 0)
    assert lm.decode_path == "replay"
    assert [b.dtype for b in lm._graphs[2].banks] == [torch.bfloat16,
                                                      torch.float32]
    wide = T.tree_map(lambda x: x.float(), lm.init_cache(2, 8))
    lm.decode_step(wide, tok, 0)
    assert lm.decode_path == "capture"
    assert lm._graphs[2].banks[0].dtype == torch.float32
    lm.decode_step(lm.init_cache(3, 8), torch.zeros((3, 1),
                                                    dtype=torch.long), 0)
    assert lm.decode_path == "capture" and sorted(lm._graphs) == [2, 3]
    lm.load_params(lm.params())
    assert lm._graphs == {} and lm._graph_ok is None
    lm.decode_step(lm.init_cache(2, 8), tok, 0)
    assert lm.decode_path == "capture" and len(graphs.made) == 4


def test_a_bf16_state_is_widened_for_an_f32_model_as_eagerly(graphs):
    """The zero cache (bf16 conv states) handed to an f32 model: the
    graph's conv bank is f32, as the eager step's new conv state is, and
    both steps agree bit for bit."""
    cfg = get_config(ARCH).smoke()
    eager = LM(cfg, dtype=torch.float32, device="cpu", seed=5)
    lm = graphs(LM(cfg, dtype=torch.float32, device="cpu",
                   params=eager.params()))
    c_eager, c_graph = eager.init_cache(2, 8), lm.init_cache(2, 8)
    assert T.leaves(c_graph)[0].dtype == torch.bfloat16
    for t, tok in enumerate((3, 17, 5)):
        ids = torch.full((2, 1), tok, dtype=torch.long)
        want, c_eager = eager.decode_step(c_eager, ids, t)
        got, c_graph = lm.decode_step(c_graph, ids, t)
        assert torch.equal(got, want)
        for a, b in zip(T.leaves(c_graph), T.leaves(c_eager)):
            assert a.dtype == b.dtype and torch.equal(a, b)
    assert lm._graphs[2].banks[0].dtype == torch.float32


def _probe(lm):
    """``graphs_decode`` as it reads on a CUDA device."""
    dev = lm.device
    lm.device, lm._graph_ok = torch.device("cuda"), None
    try:
        return lm.graphs_decode()
    finally:
        lm.device, lm._graph_ok = dev, None


@pytest.mark.parametrize("arch", (ARCH,) + REFUSED)
def test_only_the_ssm_pattern_decodes_as_a_graph(arch):
    cfg = (jamba_config(**SMALL) if arch == "jamba2-mini"
           else get_config(arch).smoke())
    lm = LM(cfg, device="cpu", seed=0)
    assert _probe(lm) == (arch == ARCH)
    assert not lm.graphs_decode()              # on the CPU: never
    tok = torch.zeros((1, 1, cfg.n_codebooks) if cfg.n_codebooks > 1
                      else (1, 1), dtype=torch.long)
    lm.decode_step(lm.init_cache(1, 8), tok, 0)
    assert lm.decode_path == "eager" and lm._graphs == {}
