"""Prompt featurisation for the length predictor and the synthetic LM data
of the trainer, copied from ``repro.data``."""
