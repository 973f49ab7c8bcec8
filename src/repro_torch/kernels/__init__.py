"""The paired GEMM kernel, its plain PyTorch version and the conv lowering."""
