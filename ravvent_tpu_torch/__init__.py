"""ravvent_tpu_torch — the PyTorch/CUDA port of ravvent_tpu for NVIDIA Hopper.

A second package beside the JAX reference ``ravvent_tpu``, with the same
layout and names. Plain tensor code is PyTorch; each Pallas kernel of the
JAX package on the ported path becomes a hand-written CUDA kernel for
``sm_90a`` (``csrc/``), built with nvcc and bound with ctypes
(``ops/cuda_lib.py``). Host modules (config, tokenizer, data, assembly,
native helpers) are the port's own copies: this package never imports
``ravvent_tpu`` or JAX.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
