"""The benchmark's own checks, on the CPU: ``BENCHMARK.json`` against the
contract's shape, every cell's files found by name, every traffic key
read, the traffic repeating from its seed, a traced run reading the
program's spans, ``run.py`` refusing to run without a card, and no import of
JAX or the JAX package anywhere under ``perfbench/`` (nor of the port
under ``perfbench/reference/``)."""
from __future__ import annotations

import ast
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import tiny  # noqa: E402

from perfbench import gen, harness  # noqa: E402

BENCH = harness.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_lines():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append((group in ("end_to_end", "per_layer"), e["name"]))
            for key in ("why", "layer", "source"):
                if key in e:
                    assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] \
                        and "\t" not in e[key], (e["name"], key)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    assert len(names) == len(set(names))
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        for key in c["reduced"]:
            assert NAME.match(key)
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_bounds():
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" and "workloads" not in m
               for m in BENCH["end_to_end"])


def test_every_cell_reports_enough_and_moves_are_reported():
    cells = {w["name"] for w in BENCH["workloads"]}
    for cell in cells:
        e2e = {m["name"] for m in harness.end_to_end_of(cell, BENCH)}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert harness.per_layer_of(cell, BENCH)
    by_name = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in by_name
        for cell in m["workloads"]:
            assert cell in cells
            assert m["moves"] in {e["name"] for e in
                                  harness.end_to_end_of(cell, BENCH)}


def test_rooflines_have_an_mfu_beside_them():
    for m in BENCH["per_layer"]:
        if "_roofline" in m["name"]:
            assert any("mfu" in re.split(r"[._]", o["name"])
                       and o["moves"] == m["moves"]
                       for o in BENCH["per_layer"]), m["name"]


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_cell_files_found_by_name(cell):
    held = cell in tiny.HELD
    assert held != any(w["name"] == cell for w in BENCH["workloads"])
    c = harness.cell_of(tiny.HELD[cell]) if held else \
        harness.find_cell(cell, BENCH)
    root = harness.BENCH_DIR
    assert (root / "drivers" / f"{c.driver}.py").is_file()
    if not held:
        conf = next(x for x in BENCH["configs"]
                    if x["name"] == c.entry["config"])
        assert conf["file"] == f"perfbench/configs/{conf['name']}.json"
        assert sorted(conf["reduced"]) == sorted(c.config["reduced"])
    for m in harness.per_layer_of(cell, BENCH):
        reader = harness.load_module(root / "metrics" / f"{m['name']}.py",
                                     "t_" + m["name"].replace(".", "_"))
        assert callable(reader.read)
    assert c.limits and all(isinstance(v, (int, float))
                            for v in c.limits.values())


def test_every_benchmark_file_is_named_from_name_characters():
    for p in harness.BENCH_DIR.rglob("*"):
        if "__pycache__" in p.parts:
            continue
        rel = p.relative_to(harness.ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_.\-/]{1,200}$", rel), rel


def test_traffic_repeats_from_the_seed():
    from perfbench.weights import sizes
    audit = tiny.cell("audit-esgf-cmip6")
    drivers = harness.BENCH_DIR / "drivers"
    a = harness.load_module(drivers / "audit.py", "t_audit")
    s = harness.load_module(drivers / "serve.py", "t_serve")

    class Ctx:
        def __init__(self, cell, seed):
            self.cell, self.seed = cell, seed
    one, again, other = (a.layout(Ctx(audit, x)) for x in (5, 5, 2 ** 31 + 7))
    assert one == again and one != other
    assert sorted(one[1]) == sorted(other[1])          # the same sizes
    chat = tiny.cell("serve-falcon-mamba-7b-chat")
    v = sizes(chat.config).vocab
    w1, w2 = (s.wave(chat.traffic, v, 5, 3) for _ in range(2))
    w3 = s.wave(chat.traffic, v, 6, 3)
    assert all((p1 == p2).all() and n1 == n2
               for (p1, n1), (p2, n2) in zip(w1, w2))
    assert sorted(len(p) for p, _ in w1) == sorted(len(p) for p, _ in w3)
    assert sorted(n for _, n in w1) == sorted(n for _, n in w3)
    assert gen.stratified({"dist": "fixed", "value": 4}, 3) == [4, 4, 4]


def test_every_traffic_key_is_read():
    for path in (harness.BENCH_DIR / "traffic").glob("*.json"):
        traffic = harness.load_json(path)
        src = "".join((harness.BENCH_DIR / f).read_text() for f in (
            f"drivers/{traffic['driver']}.py", "harness.py"))
        for key in traffic:
            assert f'"{key}"' in src or key == "why", (path.name, key)


def test_replica_sizes_carry_the_published_mean_and_the_tail():
    cell = harness.cell_of(tiny.HELD["audit-esgf-cmip6"])
    spec = cell.traffic["file_size"]
    sizes = gen.stratum_means(spec, cell.config["files"])
    mean = cell.config["published"]["mean_file_bytes"]
    assert abs(sum(sizes) / len(sizes) / mean - 1) < 2e-3
    assert max(sizes) > gen.quantile(spec, 0.95)    # the tail's bytes
    assert sum(sizes) < 4 << 30                     # the write budget


def test_traced_serving_run_reads_program_spans_untraced():
    c = tiny.cell("serve-falcon-mamba-7b-prompts")
    c.traffic.update(trace_lead_seconds=0.3, trace_seconds=0.3)
    r = tiny.run(c.name, seconds=5, trace=True, c=c)
    assert r["correct"] and r["breakdown"]["idle_gaps"]
    assert {"pad_share.prefill", "prefill_mfu", "decode_ms.serve"} <= set(
        r["metrics"])
    assert r["_outcome"].counters["decode_s"]


def test_run_refuses_without_a_card(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, str(harness.BENCH_DIR / "run.py"), "--workload",
         "train-deepseek-v2-lite-16b", "--seed", "2147483700", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, env=env, capture_output=True,
        text=True, timeout=120)
    assert proc.returncode != 0
    assert "{" not in proc.stdout


def _imports(path: Path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_jax_nor_the_jax_package():
    for p in harness.BENCH_DIR.rglob("*.py"):
        tops = set(_imports(p))
        assert not tops & {"jax", "jaxlib", "flax", "repro", "benchmarks"}, p
        if "reference" in p.relative_to(harness.BENCH_DIR).parts:
            assert "repro_torch" not in tops, p
