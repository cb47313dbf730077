"""Benchmark harness (counterpart of the JAX package's bench/): sweep,
timing, and CSV/JSONL results with schema guards."""
