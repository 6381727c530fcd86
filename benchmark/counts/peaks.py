"""NVIDIA H100 SXM, dense rates (NVIDIA's data sheet), at its 700 W limit."""

FP16_TENSOR_FLOPS = 989e12   # float16 / bfloat16 tensor cores, dense
FP32_FLOPS = 67e12           # float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12    # HBM3
