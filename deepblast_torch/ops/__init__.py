"""Alignment DP: smoothed-max operators, the stream layout, the CUDA
kernels and their plain PyTorch versions.  The package exports what
``deepblast_tpu.ops`` exports (``ops/__init__.py:1-9``); the backends are
registered by ``ops/dp.py`` itself."""

from deepblast_torch.ops.dp import (  # noqa: F401
    AlignmentDecoder,
    NeedlemanWunschDecoder,
    SmithWatermanDecoder,
    alignment_score,
    expected_alignment,
    traceback,
)
from deepblast_torch.ops.smooth import OPERATORS  # noqa: F401
