"""The port's batched decode-serving engine."""
