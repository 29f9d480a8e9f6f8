"""The decode step's elementwise glue (add + RMSNorm, qk_norm + RoPE + K/V
write, act * up): CUDA kernels, wrappers and plain versions."""
