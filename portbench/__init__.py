"""The benchmark of the PyTorch and CUDA port (``deepblast_torch``) on one
NVIDIA H100: ``python3 -m portbench --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` (see :mod:`portbench.run`).  It imports
the port, PyTorch, NumPy and the standard library, and never JAX or the
JAX package."""
