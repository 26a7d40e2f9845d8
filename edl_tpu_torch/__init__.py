"""edl_tpu_torch — the PyTorch and CUDA port of edl_tpu.

It sits beside the JAX package and mirrors its subpackage and module
names, so each ported module lives where its counterpart does. It
imports ``torch``, never JAX, and nothing of ``edl_tpu``: modules the
two share (the RPC substrate, observability, robustness) are copies.

Entry points run on CUDA unless the caller passes ``device="cpu"``;
hot-path kernels are hand-written CUDA under ``ops/csrc``.
"""

__version__ = "0.1.0"
