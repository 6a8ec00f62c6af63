"""Language models, embedding heads and the neural aligner."""

import torch

__all__ = ["exact_cuda_math"]


def exact_cuda_math():
    """Process-wide PyTorch flags that make CUDA float32 arithmetic float32
    and bf16 / fp16 products accumulate in float32, as on the TPU: TF32 off
    for matmuls and for cuDNN (convolutions and the LSTM / GRU), and no
    reduced-precision split-K reductions; and cuDNN's deterministic
    algorithms (no atomic sums in a convolution's weight gradient), so
    that a run repeats bit for bit, as an XLA program does.  Idempotent;
    set where a model is placed on a CUDA device (the trainer,
    ``load_bilm``, ``load_converted_lm``), never by a module's forward."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    matmul = torch.backends.cuda.matmul
    matmul.allow_bf16_reduced_precision_reduction = False
    matmul.allow_fp16_reduced_precision_reduction = False
