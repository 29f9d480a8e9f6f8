"""The simulated cluster: hardware catalog, workloads, simulator; copied from ``repro.cluster``."""
