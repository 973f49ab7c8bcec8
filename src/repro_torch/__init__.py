"""PyTorch/CUDA port of the subtractor-based CNN inference accelerator.

The package mirrors ``repro`` (the JAX reference) module for module and
runs on an NVIDIA H100: the paired subtractor GEMM is a hand-written CUDA
kernel (``kernels/csrc/paired_matmul.cu``); everything around it is plain
PyTorch.  It never imports ``jax`` or ``repro``.  Public functions keep the
JAX layouts: NHWC activations, HWIO conv weights, im2col lanes ordered
``(kh, kw, cin)``.
"""
