"""The port's four examples against the JAX package's, on the CPU.

* ``torch_replication_campaign`` prints what ``replication_campaign``
  prints, line for line: paper-2022 on both engines, a federation, a
  demand scenario, the dashboard and the defaults, whose last line is the
  one ``chip_smoke.py`` expects on the card.
* ``torch_quickstart``, ``torch_serve_batched`` and
  ``torch_train_with_replication`` run with ``--device cpu`` (the kernels'
  plain versions) at small sizes, and every printed quantity that does not
  depend on the weights equals the reference's: the logged steps, the
  injected failure, final step and restarts; requests, waves and tokens;
  scheduler steps, ``verified``, checkpoint steps, ``replicated`` and the
  restore's step and site.  Losses and sampled tokens differ by design: each
  package draws its own init.

Each example runs in this process through its ``main`` (the reference's
reads ``sys.argv``), the reference's first.
"""
import importlib.util
import re
import sys
from pathlib import Path

import pytest
import torch

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The examples' tensors are small: one intra-op thread runs them as
    fast alone, and beside other busy test workers it does not stall at
    every op's barrier as a full pool does."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _load(name: str):
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(name: str, argv, capsys, monkeypatch) -> str:
    """The stdout of ``examples/<name>.py`` run with ``argv``: the
    reference's ``main()`` reads ``sys.argv``, the port's takes ``argv``."""
    mod = _load(name)
    capsys.readouterr()
    if name.startswith("torch_"):
        assert mod.main(list(argv)) == 0
    else:
        monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
        mod.main()
    return capsys.readouterr().out


def _both(name: str, argv, capsys, monkeypatch, device=True):
    ref = _run(name, argv, capsys, monkeypatch)
    port = _run(f"torch_{name}", [*argv, *(["--device", "cpu"] if device
                                           else [])], capsys, monkeypatch)
    return ref, port


SMALL = ["--datasets", "24", "--scale", "0.02"]
CAMPAIGNS = {
    "paper-2022-events": ["--scenario", "paper-2022", *SMALL],
    "paper-2022-step": ["--scenario", "paper-2022", *SMALL, "--engine",
                        "step"],
    "federation-paper-twice": ["--scenario", "federation-paper-twice",
                               *SMALL],
    "esgf-serving": ["--scenario", "esgf-serving", *SMALL],
    "dashboard": [*SMALL, "--dashboard"],
    "defaults": [],
}


def _smoke_campaign_last() -> str:
    """The line ``chip_smoke.py`` holds the campaign example's run on the
    card to: what the reference prints last at its defaults."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", EXAMPLES.parent / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.CAMPAIGN_EXAMPLE_LAST


@pytest.mark.parametrize("case", CAMPAIGNS)
def test_campaign_example_prints_the_reference(case, capsys, monkeypatch):
    ref, port = _both("replication_campaign", CAMPAIGNS[case], capsys,
                      monkeypatch, device=False)
    assert len(ref.splitlines()) > 3
    assert port.splitlines() == ref.splitlines()
    if case == "defaults":
        assert ref.splitlines()[-1] == _smoke_campaign_last()


def _quickstart_facts(out: str):
    steps = re.findall(r"^\[train\] step (\d+) loss", out, re.M)
    failures = re.findall(r"^\[train\] FAILURE: .*$", out, re.M)
    final = re.search(r"^arch=(\S+) steps=(\d+) restarts=(\d+) ", out, re.M)
    loss = re.search(r"^loss: (\S+) -> (\S+) ", out, re.M)
    return steps, failures, final.groups(), loss is not None


def test_quickstart_example_matches_the_reference(capsys, monkeypatch):
    """A failure after the step-10 checkpoint: the restart restores it and
    logs step 10 again."""
    ref, port = _both("quickstart", ["--steps", "12", "--batch", "2",
                                     "--seq", "16", "--fail-at", "11"],
                      capsys, monkeypatch)
    facts = _quickstart_facts(port)
    assert facts == _quickstart_facts(ref)
    assert facts[0] == ["0", "10", "10"]
    assert facts[2] == ("smollm-135m-smoke", "12", "1")


def _serve_facts(out: str):
    head = re.search(r"^arch=(\S+): served (\d+) requests in (\d+) waves, "
                     r"(\d+) tokens in ", out, re.M).groups()
    reqs = re.findall(r"^  req (\d+): (.*)$", out, re.M)
    # each request's first tokens: ids shown, and whether a token is a list
    # of codebook ids
    shapes = [(rid, len(re.findall(r"\d+", body)), body.startswith("[["))
              for rid, body in reqs]
    return head, shapes


@pytest.mark.parametrize("arch", ["smollm-135m", "falcon-mamba-7b",
                                  "musicgen-large"])
def test_serve_example_matches_the_reference(arch, capsys, monkeypatch):
    ref, port = _both("serve_batched", ["--arch", arch, "--requests", "5",
                                        "--max-new", "3", "--batch", "2"],
                      capsys, monkeypatch)
    facts = _serve_facts(port)
    assert facts == _serve_facts(ref)
    assert facts[0][1:] == ("5", "3", "15")
    assert "tok/s on cpu)" in port


def _replication_facts(out: str):
    return (re.findall(r"^\[stage\] .*$", out, re.M),
            re.findall(r"^\[train\] step (\d+) loss \S+ ckpt "
                       r"replicated=(\w+)$", out, re.M),
            re.findall(r"^\[failure\] .*$", out, re.M),
            re.findall(r"^\[recover\] restored step (\d+) from (\w+);", out,
                       re.M))


def test_train_with_replication_example_matches_the_reference(capsys,
                                                              monkeypatch):
    ref, port = _both("train_with_replication", ["--steps", "20"], capsys,
                      monkeypatch)
    facts = _replication_facts(port)
    assert facts == _replication_facts(ref)
    assert facts[0] == ["[stage] dataset staged to both pods in 3 scheduler "
                        "steps; verified=True"]
    assert facts[1] == [("20", "True")] and facts[3] == [("20", "POD1")]
