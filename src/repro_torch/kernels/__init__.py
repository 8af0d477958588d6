"""Hand-written Hopper kernels and their plain PyTorch versions.

``taom_gemm`` — the chunked TAOM GEMM (CUDA C++ in ``csrc/``, built with
nvcc at first use, never at import); ``ref`` — the plain versions;
``ops`` — the dispatching entry point ``photonic_matmul``.
"""
