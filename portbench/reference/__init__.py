"""Plain PyTorch references of the benchmark's configurations.

Each module is the forward pass of one architecture in float32 (TF32 off),
written from the published description and the configuration file's keys,
with no kernel, cache or batching of the program.  It imports neither JAX,
the JAX package nor anything of ``repro_torch``; it reads only the weights
that the benchmark drew (``pb.weights``) and the tokens it judges.

A module defines ``leaves(conf, vocab_rows)``, the weights to draw as
(name, shape, std, kind) or (name, shape, std, kind, mean); ``logits``,
the forward pass the check runs; and ``reduced(conf)``, the configuration
cut to a size the CPU tests serve.  ``pb.spec.reference`` loads it from
its file by the configuration's ``reference`` key.
"""
