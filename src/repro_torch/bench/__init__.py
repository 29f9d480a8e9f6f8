"""Latency profiles and the experiment harness, copied from ``repro.bench``."""
