"""Operation and byte counts from shapes, and the H100's peaks: the
yardstick of ``mfu`` and of every kernel roofline, kept with the benchmark
and independent of the program's own estimates."""
