"""CARINA on PyTorch and CUDA: the port of the `repro` package.

The public surface is `repro_torch.carina`, which mirrors `repro.carina`
name for name for what is ported so far: campaign and fleet sessions,
the six Figure-1 policies, schedules and signals, and the trace-grid
sweep engine whose chunk steps run as hand-written CUDA kernels on the
card (`repro_torch.kernels`).
"""
