"""The benchmark of heat_tpu_torch on NVIDIA H100 cards (``run.py``)."""
