"""cvpytorch_tpu_torch — the PyTorch/CUDA port of ``cvpytorch_tpu``.

Module paths mirror the JAX package, so each counterpart sits at the same
relative path.  The port imports ``torch`` and never JAX or anything of
``cvpytorch_tpu``; the greedy NMS runs as a hand-written CUDA kernel
(``csrc/nms_kernel.cu``) built with ``nvcc`` at first use.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without CUDA such a call raises instead of falling back.
"""

__version__ = "0.1.0"
