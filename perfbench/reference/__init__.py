"""Plain references the benchmark judges the port's outputs by.

Plain PyTorch and NumPy, float32 with TF32 off (``precision.exact``).
Nothing here imports the port, JAX or the JAX package; the references take
the inputs the harness made (weights regenerated from the seed, token ids,
file bytes) and never a tensor the program has made.
"""
