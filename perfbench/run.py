"""The benchmark's one command.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout on a machine with the cell's CUDA devices;
it exits with a code other than 0, and prints no result, without them.
The build and kernel caches go to fixed directories inside the checkout
(``build/perfbench/``), and the program's nvcc builds to its own
``src/repro_torch/kernels/*/build/``.
"""
import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _environment() -> None:
    cache = ROOT / "build" / "perfbench"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels"),
                     ("CUDA_CACHE_PATH", "nv_compute_cache")):
        os.environ[var] = str(cache / sub)
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [str(ROOT), str(ROOT / "src")] + [
        p for p in sys.path if p and Path(p).resolve() != Path(here)]


if __name__ == "__main__":
    _environment()
    from perfbench import harness
    sys.exit(harness.main(sys.argv[1:], T0))
