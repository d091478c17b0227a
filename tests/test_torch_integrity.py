"""The port's streaming checksum and manifests against the JAX package's.

Data is made from a seed with numpy; the port hashes with its plain PyTorch
version (``device="cpu"``).  Hashes are integers and manifests JSON, so the
tolerance is exact equality.
"""
import os

import numpy as np
import pytest
import torch

from repro.core import integrity as jint
from repro.kernels.checksum.ref import checksum_bytes_np
from repro_torch.core import integrity as tint
from repro_torch.core.transport import LocalFSTransport
from repro_torch.data.staging import StagingArea
from repro_torch.kernels.checksum.ops import checksum_bytes, checksum_tensor


def _chunks(data: bytes, rng: np.random.Generator):
    """A random split of ``data``: empty, 1-3 byte and long chunks."""
    i = 0
    while i < len(data):
        n = int(rng.choice([0, 1, 2, 3, 5, rng.integers(1, 5000)]))
        yield data[i:i + n]
        i += n


def _make_tree(root: str, seed: int) -> None:
    rng = np.random.default_rng(seed)
    for rel, size in [("a.nc", 1000), ("sub/b.nc", 4099), ("sub/c.nc", 3),
                      ("sub/deep/d.nc", 70_001), ("e.nc", 0)]:
        p = os.path.join(root, rel)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        with open(p, "wb") as f:
            f.write(rng.bytes(size))


@pytest.mark.parametrize("seed", range(6))
def test_streaming_checksum_matches_reference_under_random_chunking(seed):
    rng = np.random.default_rng(seed)
    data = rng.bytes(int(rng.integers(0, 40_000)))
    port, jax_side = tint.StreamingChecksum("cpu"), jint.StreamingChecksum()
    for chunk in _chunks(data, rng):
        port.update(chunk)
        jax_side.update(chunk)
    assert port.digest() == jax_side.digest() == checksum_bytes_np(data)


def test_digest_does_not_consume_the_tail():
    """``digest()`` folds the carried tail into a copy of the accumulator,
    so digesting mid-stream and continuing matches the reference."""
    data = np.random.default_rng(9).bytes(1003)
    port, jax_side = tint.StreamingChecksum("cpu"), jint.StreamingChecksum()
    for part in (data[:501], data[501:]):
        port.update(part)
        jax_side.update(part)
        assert port.digest() == port.digest() == jax_side.digest()


def test_stream_file_checksum_matches_reference_across_chunks(tmp_path):
    p = str(tmp_path / "f.bin")
    with open(p, "wb") as f:              # crosses the 4 MiB scan chunk
        f.write(np.random.default_rng(1).bytes(tint._SCAN_CHUNK + 5))
    assert (tint.stream_file_checksum(p, "cpu")
            == jint.stream_file_checksum(p))


@pytest.mark.parametrize("data", [b"", b"abc", b"payload" * 100])
def test_file_checksum_matches_reference(data):
    assert tint.file_checksum(data, "cpu") == jint.file_checksum(data)


def test_manifest_scan_and_verify_many_match_reference(tmp_path):
    src, dst = str(tmp_path / "src"), str(tmp_path / "dst")
    _make_tree(src, seed=4)
    _make_tree(dst, seed=4)
    port, jax_side = tint.Manifest.scan(src, "cpu"), jint.Manifest.scan(src)
    assert port.entries == jax_side.entries
    assert port.total_bytes == jax_side.total_bytes
    # a flipped byte, a truncated file and a missing file
    with open(os.path.join(dst, "sub/b.nc"), "r+b") as f:
        f.seek(17)
        b = f.read(1)
        f.seek(17)
        f.write(bytes([b[0] ^ 0x40]))
    with open(os.path.join(dst, "sub/deep/d.nc"), "r+b") as f:
        f.truncate(70_000)
    os.remove(os.path.join(dst, "a.nc"))
    want = jax_side.verify_many(dst)
    assert port.verify_many(dst, device="cpu") == want
    assert {r for r, v in want.items() if not v["ok"]} == {
        "sub/b.nc", "sub/deep/d.nc", "a.nc"}
    rels = ["sub/c.nc", "sub/b.nc"]
    assert (port.verify_many(dst, rels, device="cpu")
            == jax_side.verify_many(dst, rels))
    assert port.verify(dst, device="cpu") == jax_side.verify(dst)


@pytest.mark.parametrize("saver", ["port", "reference"])
def test_manifest_saved_by_either_package_verifies_in_both(tmp_path, saver):
    root = str(tmp_path / "tree")
    _make_tree(root, seed=5)
    path = str(tmp_path / "MANIFEST.json")
    if saver == "port":
        tint.Manifest.scan(root, "cpu").save(path)
    else:
        jint.Manifest.scan(root).save(path)
    assert tint.Manifest.load(path).verify(root, device="cpu") == {}
    assert jint.Manifest.load(path).verify(root) == {}
    other = str(tmp_path / "other.json")
    (jint.Manifest.scan(root) if saver == "port"
     else tint.Manifest.scan(root, "cpu")).save(other)
    with open(path) as a, open(other) as b:
        assert a.read() == b.read()          # the JSON format is unchanged


@pytest.mark.parametrize("entry", ["checksum_bytes", "checksum_tensor",
                                   "StreamingChecksum", "stream_file_checksum",
                                   "Manifest.scan", "LocalFSTransport",
                                   "StagingArea"])
def test_default_cuda_device_raises_without_cuda(tmp_path, monkeypatch,
                                                  entry):
    """Every entry point that touches bytes defaults to the card and refuses
    to run when there is none, instead of quietly hashing on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    p = tmp_path / "f.bin"
    p.write_bytes(b"abcdef")
    calls = {
        "checksum_bytes": lambda: checksum_bytes(b"abc"),
        "checksum_tensor": lambda: checksum_tensor(torch.zeros(4)),
        "StreamingChecksum": lambda: tint.StreamingChecksum(),
        "stream_file_checksum": lambda: tint.stream_file_checksum(str(p)),
        "Manifest.scan": lambda: tint.Manifest.scan(str(tmp_path)),
        "LocalFSTransport": lambda: LocalFSTransport(str(tmp_path)),
        "StagingArea": lambda: StagingArea(str(tmp_path / "stage")),
    }
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[entry]()
