"""magicdec_tpu_torch: the PyTorch + CUDA (Hopper) port of magicdec_tpu.

Mirrors magicdec_tpu's module layout (models/, ops/, engine/, cache.py,
checkpoint/) so each module's counterpart is found by name. The port imports
torch and numpy only: nothing of JAX and nothing of magicdec_tpu. Its
hand-written CUDA kernels live in csrc/ and are built with nvcc at first use
(ops/_build.py).
"""
