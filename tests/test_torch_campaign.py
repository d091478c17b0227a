"""The port's replication engine against the JAX package's.

The scheduler, transfer table, simulated transport and fault draws are host
numpy/sqlite in both packages and follow the same operations, so the float64
trajectories and every report must be exactly equal.  Real-bytes transfers
hash on the CPU here (``device="cpu"``).  Also the port's hygiene: it
imports neither JAX nor the JAX package.
"""
import dataclasses
import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro.core import campaign as jcamp
from repro.core import faults as jfaults
from repro.core.routes import Dataset as JDataset
from repro.core.transport import LocalFSTransport as JLocalFSTransport
from repro.data.staging import StagingArea as JStagingArea
from repro_torch.core import campaign as tcamp
from repro_torch.core import faults as tfaults
from repro_torch.core.routes import Dataset as TDataset
from repro_torch.core.transport import LocalFSTransport as TLocalFSTransport
from repro_torch.data.staging import StagingArea as TStagingArea

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"


def _plain(obj):
    """asdict with enum members as their values (the packages' ``Status``
    enums are distinct classes with equal values)."""
    d = dataclasses.asdict(obj)
    return {k: getattr(v, "value", v) for k, v in d.items()}


# ------------------------------------------------------------- campaign
@pytest.mark.parametrize("kw", [
    dict(n_datasets=48, scale=1.0, seed=0),
    dict(n_datasets=24, scale=0.02, seed=1, unreadable_fraction=0.1)])
def test_run_campaign_report_equals_reference(kw):
    port = tcamp.run_campaign(tcamp.CampaignConfig(**kw))
    want = jcamp.run_campaign(jcamp.CampaignConfig(**kw))
    assert dataclasses.asdict(port) == dataclasses.asdict(want)
    if kw["seed"] == 0:
        # the paper-scale reference point (7.3 PB in 48 datasets)
        assert round(port.duration_days, 3) == 106.167
        assert port.faults_total == 703
        assert port.faults_per_transfer_max == 195
        assert port.quarantined == 0
        assert len(port.timeline) == 106


def test_build_catalog_equals_reference():
    cfg = dict(n_datasets=300, scale=0.5, seed=3)
    port = tcamp.build_catalog(tcamp.CampaignConfig(**cfg),
                               tcamp.paper_route_graph())
    want = jcamp.build_catalog(jcamp.CampaignConfig(**cfg),
                               jcamp.paper_route_graph())
    assert ({k: dataclasses.asdict(v) for k, v in port.items()}
            == {k: dataclasses.asdict(v) for k, v in want.items()})


# ---------------------------------------------------------------- faults
def test_stable_digest_equals_reference():
    rng = np.random.default_rng(0)
    texts = ["", "perm|0|/css03_data/CMIP6/x"] + [
        rng.bytes(int(n)).hex() for n in rng.integers(0, 64, 50)]
    for t in texts:
        assert tfaults.stable_digest(t) == jfaults.stable_digest(t)


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_fault_injector_draws_equal_reference(seed):
    port = tfaults.FaultInjector(seed=seed, transient_per_tb=50.0)
    want = jfaults.FaultInjector(seed=seed, transient_per_tb=50.0)
    rng = np.random.default_rng(100 + seed)
    for i in range(200):
        ds = f"/ds/{int(rng.integers(0, 40))}"
        nbytes = int(rng.integers(1, 2 ** 42))
        assert port.transient_marks(ds, nbytes) == want.transient_marks(
            ds, nbytes)
        assert (port.is_persistent_unreadable(ds)
                == want.is_persistent_unreadable(ds))
        np.testing.assert_array_equal(
            port.latent_corrupt_offsets(ds, "ALCF", nbytes, 5e3, i % 3 + 1),
            want.latent_corrupt_offsets(ds, "ALCF", nbytes, 5e3, i % 3 + 1))
    assert port.state_dict() == want.state_dict()


# ------------------------------------------------------------ real bytes
def _write_dataset(root: str, seed: int, sizes=(1000, 4099, 3, 9_000_001)):
    rng = np.random.default_rng(seed)
    for i, size in enumerate(sizes):
        p = os.path.join(root, "A", "ds", "sub" if i % 2 else "", f"f{i}.bin")
        os.makedirs(os.path.dirname(p), exist_ok=True)
        with open(p, "wb") as f:
            f.write(rng.bytes(size))
    return sum(sizes), len(sizes)


def _flip_first_attempt(victims):
    """A corruptor that flips one byte of the first chunk it sees of each
    victim file, so only a victim's first attempt arrives corrupted."""
    seen = set()

    def corruptor(path, data):
        if os.path.basename(path) in victims and path not in seen:
            seen.add(path)
            return data[:-1] + bytes([data[-1] ^ 1])
        return data
    return corruptor


@pytest.mark.parametrize("victims", [(), ("f0.bin",), ("f1.bin", "f3.bin")])
def test_localfs_retransmits_equal_reference(tmp_path, victims):
    root = str(tmp_path)
    nbytes, nfiles = _write_dataset(root, seed=2)
    states = []
    for transport, dataset in (
            (JLocalFSTransport(root, corruptor=_flip_first_attempt(victims)),
             JDataset("ds", nbytes, nfiles, 2)),
            (TLocalFSTransport(root, corruptor=_flip_first_attempt(victims),
                               device="cpu"),
             TDataset("ds", nbytes, nfiles, 2))):
        st = transport.poll(transport.submit(dataset, "A", "B"))
        states.append(_plain(st))
        report = transport.audit(dataset, "A", "B")
        assert report and all(r["ok"] for r in report.values())
    assert states[0] == states[1]
    assert states[1]["faults"] == len(victims)
    assert states[1]["status"] == "SUCCEEDED"


def test_localfs_persistent_corruption_equals_reference(tmp_path):
    root = str(tmp_path)
    nbytes, nfiles = _write_dataset(root, seed=3, sizes=(100, 200))

    def always(path, data):
        return bytes([data[0] ^ 1]) + data[1:]

    jst = JLocalFSTransport(root, corruptor=always)
    tst = TLocalFSTransport(root, corruptor=always, device="cpu")
    a = _plain(jst.poll(jst.submit(JDataset("ds", nbytes, nfiles, 2),
                                   "A", "B")))
    b = _plain(tst.poll(tst.submit(TDataset("ds", nbytes, nfiles, 2),
                                   "A", "B")))
    assert a == b and b["status"] == "FAILED"


def test_staging_area_table_rows_equal_reference(tmp_path):
    rows = []
    for name, cls, kw in (("jax", JStagingArea, {}),
                          ("port", TStagingArea, {"device": "cpu"})):
        root = str(tmp_path / name)
        rng = np.random.default_rng(8)
        for rel in ("train/shard0.bin", "train/sub/shard1.bin",
                    "eval/shard0.bin"):
            p = os.path.join(root, "STORE", "corpus", rel)
            os.makedirs(os.path.dirname(p), exist_ok=True)
            with open(p, "wb") as f:
                f.write(rng.bytes(int(rng.integers(1, 200_000))))
        area = cls(root, **kw)
        area.register("corpus/train")
        area.register("corpus/eval")
        steps = area.run_until_staged()
        assert area.staged_ok("corpus/train") and area.staged_ok("corpus/eval")
        rows.append((steps, [{k: v for k, v in _plain(r).items()
                              if k != "uuid"} for r in area.table.all()]))
    assert rows[0] == rows[1]


# --------------------------------------------------------------- hygiene
def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages([str(PORT)],
                                                         "repro_torch."))


def test_importing_every_port_module_loads_neither_jax_nor_repro():
    mods = _port_modules()
    for m in ("repro_torch.data.staging", "repro_torch.models.model",
              "repro_torch.serve.engine", "repro_torch.launch.serve",
              "repro_torch.configs.falcon_mamba_7b",
              "repro_torch.kernels.flash_attention.ops",
              "repro_torch.kernels.mamba_scan.ops", "repro_torch.tree",
              "repro_torch.models.frontends", "repro_torch.optim.adamw",
              "repro_torch.optim.schedule", "repro_torch.data.synthetic",
              "repro_torch.data.sharded", "repro_torch.checkpoint.ckpt",
              "repro_torch.checkpoint.replicate", "repro_torch.train.loop",
              "repro_torch.launch.train", "repro_torch.models.moe",
              "repro_torch.scenarios.run", "repro_torch.scenarios.sweep",
              "repro_torch.core.dashboard", "repro_torch.obs.report",
              "repro_torch.obs.profile"):
        assert m in mods, m
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.')]\n"
            "print(bad)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_port_sources_import_neither_jax_nor_repro():
    pattern = re.compile(r"^\s*(import jax|from jax|from repro\.|"
                         r"import repro\b|from repro import)", re.M)
    files = sorted(PORT.rglob("*.py")) + sorted(REPO.glob("chip_*.py"))
    assert len(files) > 12 and REPO / "chip_smoke.py" in files
    for f in files:
        assert not pattern.search(f.read_text()), f
