"""The port's entry points (`train.py`: the training CLI)."""
