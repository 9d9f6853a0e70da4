"""The CARINA core on PyTorch: physics, schedules, signals, simulators,
the sweep engines and the session objects (public surface:
`repro_torch.carina`)."""
