"""The distributed layer of the port (counterpart of ``repro.distributed``)."""
from repro_torch.distributed.context import NULL_CTX, ShardCtx

__all__ = ["NULL_CTX", "ShardCtx"]
