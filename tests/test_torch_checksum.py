"""The port's integrity hash against the JAX package's.

Inputs are made from a seed with numpy and handed to both packages.  The
hash is integer arithmetic, so the tolerance is exact equality.  The port
runs its plain PyTorch version (``device="cpu"``); the JAX package runs its
numpy reference and its Pallas kernel in interpret mode, as
``tests/test_kernels.py`` does.  The CUDA kernel itself is held to the plain
version on the card by ``chip_smoke.py``; here the wrapper's checks, its
build command and the plan that cuts a call into pieces (``checksum.plan``,
the mirror of the source's ``plan_for``), which need no card, are tested.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.checksum import ref as jref
from repro.kernels.checksum.ops import checksum_array as pallas_checksum_array
from repro.kernels.checksum.ops import checksum_bytes as pallas_checksum_bytes
from repro_torch.kernels.checksum import checksum as kernel
from repro_torch.kernels.checksum import ref
from repro_torch.kernels.checksum.ops import (accumulator_value,
                                              checksum_bytes, checksum_tensor,
                                              fold_words)
from repro_torch.kernels.nvcc import find_nvcc

# the sizes of tests/test_kernels.py::test_checksum_matches_refs
SIZES = [0, 1, 3, 4, 7, 100, 4096, 65536, 131072 * 4 + 5, 1_000_003,
         5, 1021, 65537, 131072 * 4 - 1]


def _words(n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 2 ** 32, n,
                                                dtype=np.uint32)


def _tensor(words: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(words.view(np.int32).copy())


@pytest.mark.parametrize("size", SIZES)
def test_checksum_bytes_matches_reference(size):
    data = np.random.default_rng(size).bytes(size)
    want = jref.checksum_bytes_np(data)
    assert pallas_checksum_bytes(data) == want
    assert ref.checksum_bytes_np(data) == want
    assert checksum_bytes(data, device="cpu") == want
    words = _tensor(ref.bytes_to_words(data))
    assert ref.finalize32_np(int(ref.fold_words_torch(words)), size) == want


@pytest.mark.parametrize("start_word", [0, 1, 12345, 2 ** 32 - 3])
@pytest.mark.parametrize("n_words", [1, 7, 1000, 4099])
def test_partial_fold_matches_reference(start_word, n_words):
    w = _words(n_words, seed=n_words + start_word % 997)
    want = jref.fold_words_np(w, start_word)
    assert ref.fold_words_np(w, start_word) == want
    assert int(ref.fold_words_torch(_tensor(w), start_word)) == want
    assert accumulator_value(fold_words(_tensor(w), start_word)) == want


def test_partial_folds_compose_across_index_wrap():
    """Consecutive slices folded at their global offsets XOR to the whole
    fold, also where the global word index wraps past 2**32."""
    w = _words(5000, seed=3)
    start = 2 ** 32 - 3
    acc = None
    for lo, hi in [(0, 1), (1, 3), (3, 4), (4, 2048), (2048, 5000)]:
        acc = fold_words(_tensor(w[lo:hi]), start + lo, acc)
    assert accumulator_value(acc) == jref.fold_words_np(w, start)


def test_fold_of_no_words_is_zero():
    empty = torch.zeros(0, dtype=torch.int32)
    assert int(ref.fold_words_torch(empty, 12345)) == 0
    assert accumulator_value(fold_words(empty, 12345)) == 0


def test_checksum_order_sensitive():
    a = b"x" * 100 + b"y" * 100
    b = b"y" * 100 + b"x" * 100
    assert checksum_bytes(a, "cpu") != checksum_bytes(b, "cpu")


def test_checksum_length_sensitive():
    # trailing zero bytes must change the hash (length is mixed in)
    a = b"hello"
    assert checksum_bytes(a, "cpu") != checksum_bytes(a + b"\0", "cpu")


@pytest.mark.parametrize("dtype,shape", [
    (np.float32, (37, 3)), (np.uint8, (7,)), (np.int16, (5,)),
    (np.uint32, (1024,)), (np.float64, (4, 4))])
def test_checksum_tensor_matches_checksum_array(dtype, shape):
    rng = np.random.default_rng(11)
    x = (rng.normal(size=shape) * 1000).astype(dtype)
    want = jref.checksum_bytes_np(x.tobytes())
    if dtype != np.float64:          # jax keeps 32-bit types by default
        assert int(pallas_checksum_array(jnp.asarray(x))) == want
    assert checksum_tensor(torch.from_numpy(x), device="cpu") == want


@pytest.mark.parametrize("case", ["cpu", "dtype_on_cpu", "meta"])
def test_kernel_wrapper_raises_instead_of_falling_back(case):
    """The wrapper launches only on an int32 CUDA tensor; anything else
    raises before a launch, and the launch count does not move."""
    before = kernel.launches
    acc = torch.zeros(1, dtype=torch.int32)
    if case == "cpu":
        with pytest.raises(ValueError):
            kernel.fold_words_cuda(torch.zeros(8, dtype=torch.int32), 0, acc)
    elif case == "dtype_on_cpu":
        with pytest.raises(TypeError, match="int32"):
            kernel.fold_words_cuda(torch.zeros(8, dtype=torch.int64), 0, acc)
    else:
        with pytest.raises(ValueError):
            fold_words(torch.zeros(8, dtype=torch.int32, device="meta"))
    assert kernel.launches == before


def test_build_command_targets_hopper_from_package_source():
    cmd = kernel.LIBRARY.nvcc_command("nvcc", Path("out.so"))
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert "-shared" in cmd and "-fPIC" in cmd
    src = Path(cmd[-1])
    assert src.name == "checksum.cu" and src.is_file()
    pkg = Path(kernel.__file__).resolve().parent
    assert pkg in src.parents
    assert kernel.LIBRARY.library_path().parent == pkg / "build"


def test_find_nvcc_raises_without_toolkit(tmp_path, monkeypatch):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        find_nvcc()


# the kernel's plan: every piece it folds, at every size, alignment and card
def _plan_sizes(sms: int):
    """Word counts from 1 to a few million: every small count, and each
    side of one block's tile, one wave of the card (where a thread's loads
    go from one to four) and one tile of four loads beyond it."""
    wave = sms * (kernel.THREADS_PER_SM // kernel.THREADS) * kernel.THREADS
    edges = [4 * kernel.THREADS, 4 * wave,
             4 * (wave + kernel.THREADS * kernel.LOADS_BIG), 1 << 20,
             3_000_000]
    return sorted(set(range(1, 41)) | {e + d for e in edges
                                       for d in range(-3, 8)})


@pytest.mark.parametrize("sms", [1, 8, 132])
@pytest.mark.parametrize("ptr_mod_16", [0, 4, 8, 12])
def test_plan_covers_every_word_once(sms, ptr_mod_16):
    """The plan's pieces (head, each block's quads, tail) tile [0, n)
    exactly once, whatever the alignment."""
    for n in _plan_sizes(sms):
        p = kernel.plan(n, ptr_mod_16, sms)
        assert p.head == min(n, (16 - ptr_mod_16) % 16 // 4)
        assert p.tail < 4 and p.blocks >= 1
        at = 0
        for lo, hi in sorted(p.pieces()):
            assert lo == at and hi > lo, (n, lo, hi, at)
            at = hi
        assert at == n, (n, at)


@pytest.mark.parametrize("sms", [1, 8, 132])
def test_one_load_a_thread_only_within_one_pass(sms):
    """The kernel's one-load path walks quads with 32-bit indices; the plan
    takes it only where one pass of the grid covers every quad, and takes
    four loads a thread, in a grid of at most one wave, beyond it."""
    wave = sms * (kernel.THREADS_PER_SM // kernel.THREADS)
    for n in _plan_sizes(sms):
        p = kernel.plan(n, 0, sms)
        if p.loads == 1:
            assert p.blocks * p.threads >= p.n_quads, n
        else:
            assert p.loads == kernel.LOADS_BIG and p.blocks <= wave, n
            assert p.n_quads > wave * p.threads, n


@pytest.mark.parametrize("start", [0, 2 ** 32 - 3])
@pytest.mark.parametrize("sms", [1, 8, 132])
@pytest.mark.parametrize("ptr_mod_16", [0, 4, 12])
def test_planned_pieces_fold_to_the_whole(start, sms, ptr_mod_16):
    """Each planned piece folded by the plain version at its own global
    start, XORed together, equals the numpy fold of the whole, also where
    the global word index wraps past 2**32."""
    n = 4 * kernel.THREADS * kernel.LOADS_BIG * 3 + 2 * kernel.THREADS + 7
    w = _words(n, seed=n + sms + ptr_mod_16)
    words = _tensor(w)
    p = kernel.plan(n, ptr_mod_16, sms)
    h = 0
    for lo, hi in p.pieces():
        h ^= int(ref.fold_words_torch(words[lo:hi], start + lo))
    assert h == jref.fold_words_np(w, start)


def test_plan_at_the_main_path_shapes():
    """At 132 SMs a 4 MiB chunk is one quad a thread in 512 blocks; a
    256 MiB buffer four quads a thread in one wave of 528 blocks."""
    chunk = kernel.plan(1 << 20, 0, 132)
    assert (chunk.threads, chunk.blocks, chunk.loads) == (512, 512, 1)
    big = kernel.plan(64 << 20, 0, 132)
    assert (big.threads, big.blocks, big.loads) == (512, 528, 4)


def test_plan_constants_mirror_the_source():
    """The Python mirror's constants are the source's ``plan_for``'s."""
    src = (Path(kernel.__file__).resolve().parent / "csrc" / "checksum.cu"
           ).read_text()
    for name, value in (("kThreads", kernel.THREADS),
                        ("kLoadsBig", kernel.LOADS_BIG),
                        ("kThreadsPerSm", kernel.THREADS_PER_SM)):
        found = re.search(rf"constexpr int {name} = (\d+);", src)
        assert found and int(found.group(1)) == value, name
    fields = re.search(r"struct Plan \{(.*?)\};", src, re.S).group(1)
    assert re.findall(r"int64_t (\w+);", fields) == list(kernel.PLAN_FIELDS)


@pytest.mark.parametrize("bad", [dict(n_words=0), dict(ptr_mod_16=2),
                                 dict(ptr_mod_16=16), dict(sms=0)])
def test_plan_rejects_what_no_launch_takes(bad):
    args = dict(n_words=100, ptr_mod_16=0, sms=132)
    args.update(bad)
    with pytest.raises(ValueError):
        kernel.plan(**args)
