"""muax_tpu_torch — the PyTorch and CUDA port of muax_tpu.

Module names mirror the JAX package: the counterpart of ``muax_tpu/x/y.py``
is ``muax_tpu_torch/x/y.py``. The port imports ``torch`` and ``numpy`` and
nothing of JAX or of ``muax_tpu``. Entry points run on the CUDA card unless
the caller passes ``device="cpu"``; every hand-written kernel has a plain
PyTorch version beside it that serves CPU tensors only.
"""

__version__ = "0.1.0"
