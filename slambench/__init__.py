"""slambench — the benchmark of ``tpu3dtk_torch``, the PyTorch/CUDA
port: registered scans per second on the port's registration entries,
the per-layer readings of a traced job, and the comparison with a plain
reference that decides ``correct``.  ``python3 -m slambench.run --help``.
It imports neither JAX nor the JAX package."""
