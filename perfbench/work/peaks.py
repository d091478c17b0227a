"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
700 W), and the two derived rates the kernel bounds use."""
BF16_FLOPS = 989e12        # tensor cores, dense
HBM_BYTES = 3.35e12        # HBM3
# 132 SMs x 16 special-function results a clock x 1.98 GHz: exp2 a second
SFU_EXPS = 4.18e12
# 132 SMs x 64 int32 results a clock x 1.98 GHz
INT32_OPS = 1.67e13
