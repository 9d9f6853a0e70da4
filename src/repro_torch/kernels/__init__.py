"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version: `scan_chunk` (K2, the uncoupled chunk step) and
`coupled_chunk` (K1, the site-coupled chunk step).  Sources are in
`repro_torch/csrc/`; `_build` compiles them with nvcc at first use."""
