"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates), against which the benchmark states its roofline and MFU shares.

float32 is taken at the 3xTF32 rate, 495 / 3 TFLOP/s: the port's conv
computes float32 as three TF32 products on the tensor cores, so no honest
float32 path reads above 100% against it.  The IWAE combine runs on the
CUDA cores, whose float32 rate is 67 TFLOP/s.
"""

HBM_BYTES_PER_S = 3.35e12
FLOAT32_FLOPS = 495e12 / 3
CUDA_CORE_FLOAT32_FLOPS = 67e12
