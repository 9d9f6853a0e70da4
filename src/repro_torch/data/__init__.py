"""The port's data pipeline: deterministic synthetic token batches."""
