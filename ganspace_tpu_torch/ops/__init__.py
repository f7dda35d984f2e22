"""Tensor ops of the port: two CUDA kernels (``moments``, ``modconv``) with
their plain PyTorch versions, and stock-PyTorch layers (``linear``,
``upfirdn``) under the float32 policy of ``precision``."""
