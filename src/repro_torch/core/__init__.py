"""Host-side control logic copied from ``repro.core``."""
