"""deepblast_torch — the PyTorch/CUDA port of ``deepblast_tpu`` for NVIDIA
Hopper GPUs.

It imports torch, numpy and the standard library only; the JAX package
stays the reference it is tested against (``tests/test_torch_*.py``).
Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"``.
"""
