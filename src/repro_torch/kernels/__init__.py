"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version: `scan_chunk` (K2, the uncoupled chunk step), `coupled_chunk`
(K1, the site-coupled chunk step), `flash_attention` (K5, attention
forward of the serving prefill and the loss), `decode_attention` (K6,
flash-decoding over a cache of valid prefix `length`), `ssm_scan` (K7,
the diagonal linear recurrence), `selective_scan` (K12c, Mamba-1's
selective scan), `rmsnorm` (K8, every norm of the model),
`moe_gemm` (K9, every routed-expert product) and `xent` (K10, the fused
cross-entropy of the loss).  K6 and K7 are reached, as in the reference,
only through `ops.decode_attention` and `ops.ssm_scan`.  Sources are in
`repro_torch/csrc/`; `_build` compiles them with nvcc at first use."""
