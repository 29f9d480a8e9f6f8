"""Plain PyTorch references of the benchmark's configurations.

Each module is the forward pass of one architecture in float32 (TF32 off),
written from the published description and the configuration file's keys,
with no kernel, cache or batching of the program.  It imports neither JAX,
the JAX package nor anything of ``repro_torch``; it reads only the weights
that the benchmark drew (``pb.weights``) and the tokens it judges.
"""
