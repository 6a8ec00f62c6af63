"""Published peaks of one NVIDIA H100 SXM (NVIDIA's H100 data sheet; dense
rates, full 700 W power limit)."""

#: float32 outside the tensor cores (matmuls with TF32 off), FLOP/s
FP32_FLOPS = 67e12
#: HBM3 bandwidth, bytes/s
HBM_BYTES = 3.35e12
#: special-function (MUFU: exp2, lg2, rcp, ...) results a second:
#: 16 a clock per SM x 132 SMs x 1.98 GHz (CUDA C++ Programming Guide,
#: arithmetic instructions, compute capability 9.0)
MUFU_PER_S = 16 * 132 * 1.98e9
