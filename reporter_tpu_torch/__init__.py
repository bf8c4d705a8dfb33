"""reporter_tpu_torch — the PyTorch / CUDA port of reporter_tpu.

Same map matcher (GPS probe traces → OSMLR segment records), same tables
and the same wire format, with the device half in PyTorch and the dense
candidate sweep as a hand-written CUDA kernel for Hopper
(``kernels/sweep_exact.cu``: one ring-fed template, five arms, one
``nvcc``). Module names mirror
the JAX package's so each counterpart is easy to find. Entry points run
on ``cuda`` unless the caller passes ``device="cpu"``
(device.resolve_device).
"""
