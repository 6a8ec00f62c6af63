"""Plain references of what the benchmark's cells compute.

Each module is plain PyTorch (or NumPy) written from the published
descriptions: the T5 encoder (:mod:`.t5`), DeepBLAST's CNN heads and
potentials (:mod:`.heads`), the soft Needleman-Wunsch recursion and its
expected alignment (:mod:`.nw`), the masked cross entropy and AdamW
(:mod:`.train`).  Nothing here imports JAX, the JAX package or the
PyTorch port: the benchmark hands the same seeded inputs and weights to
the program and to these functions, and judges the program's outputs
against theirs.
"""
