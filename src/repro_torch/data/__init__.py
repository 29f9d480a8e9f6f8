"""Prompt featurisation for the length predictor, copied from ``repro.data``."""
