"""Flash attention (prefill): CUDA kernel, wrapper and plain version."""
