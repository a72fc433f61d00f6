"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit). A card set below
that limit reaches less; the run prints the card's limit beside every
share of a peak."""

BF16_FLOPS = 989e12  # bf16 and fp16 tensor cores
TF32_FLOPS = 495e12  # the highest rate at which the card multiplies float32 inputs
FP32_FLOPS = 67e12  # float32 outside the tensor cores
HBM_BYTES = 3.35e12  # bytes/s
