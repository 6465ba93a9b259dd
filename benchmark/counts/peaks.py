"""Peak rates of one NVIDIA H100 SXM and the roofline bound of a call.

Frozen from chip_smoke.py:326-329 (HBM_PEAK_GBS, PEAK_TFLOPS) and
chip_smoke.py:502-507 (`bound`), NVIDIA's data sheet, dense rates: 989
TFLOP/s bf16 on the tensor cores; 495 TFLOP/s TF32, so float32-exact
work (TF32 off) is taken at 3xTF32, three TF32 products a float32 one,
165 TFLOP/s effective, which also bounds float32 work on the CUDA cores
(67 TFLOP/s); HBM3 at 3.35 TB/s.  A share of these peaks is stated
beside the card's power limit: a card set below 700 W reads lower.
"""

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 495e12 / 3}
ELEMENT_BYTES = {"bfloat16": 2, "float32": 4}


def bound_s(flops: float, nbytes: float, dtype: str) -> float:
    """The least seconds the card could take: the larger of the operations
    over the peak for their precision and the bytes over HBM's rate."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S)
