"""Plain references of the port's models, for the tests and the benchmark:
plain torch, float32, nothing of the port imported."""
