"""The benchmark of pfnl_tpu_torch on one NVIDIA H100: `python benchmark/run.py`."""
