"""Tensor ops of the port: attention dispatch, the flash-attention
forward kernel (``csrc/``), weight quantization."""
