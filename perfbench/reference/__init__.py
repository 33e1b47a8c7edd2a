"""Plain PyTorch references that judge the program's outputs.

Nothing here imports ``jax``, ``heat_tpu`` or ``heat_tpu_torch``, and nothing
takes a value that the program derived: the benchmark hands the same inputs
to both sides, and the program's outputs are only read to be judged.
"""
