"""Which part of the program a CUDA kernel's name belongs to.

Frozen from pfnl_tpu_torch/infer/profile_serving.py:56 (PORT_KERNELS) and
:94-103 (`_category`): substrings of the port's kernel entry names
(csrc/*.cu), then convolutions (cuDNN, CUTLASS, GEMM), layout copies
(NCHW <-> NHWC, copies, transposes), and the rest (elementwise).
"""

PORT_KERNELS = ("nonlocal_flash", "pfrb_", "tail_", "splat", "duf_")


def category(name: str) -> str:
    k = name.lower()
    layout = any(t in k for t in ("nchwtonhwc", "nhwctonchw"))
    if any(t in k for t in PORT_KERNELS):
        return "port kernel"
    if any(t in k for t in ("conv", "xmma", "cutlass", "gemm", "cudnn")) and not layout:
        return "convolution"
    if layout or any(t in k for t in ("copy", "transpose")):
        return "layout/copy"
    return "elementwise/other"
