"""Hand-written Hopper kernels and their plain PyTorch versions.

``taom_gemm``, ``ssd_scan``, ``flash_attention`` — the chunked TAOM GEMM,
the Mamba2 SSD scan and forward flash attention (CUDA C++ in ``csrc/``,
built with nvcc at first use, never at import: ``nvcc``); ``ref`` — the
plain versions and oracles; ``ops`` — the dispatching entry points
``photonic_matmul``, ``ssd_scan`` and ``flash_attention``.
"""
