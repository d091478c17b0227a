"""The benchmark of the PyTorch and CUDA port (``repro_torch``) on an H100.

``run.py`` is the one command.  A cell of ``BENCHMARK.json`` names a
configuration (``configs/<name>.json``) and a traffic mix
(``traffic/<name>.json``); the traffic names its driver
(``drivers/<kind>.py``), each per-layer metric has its reader
(``metrics/<name>.py``), and each cell its correctness limits
(``limits/<cell>.json``).  The harness finds all of them by name, so a
cell or a metric is added as files, without editing one that is there.
"""
