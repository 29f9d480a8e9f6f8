"""Decoders of the port (counterpart of ``repro.models``)."""
from repro_torch.models.model import (Model, decode_step, init_cache,
                                      init_params, lm_head_weight, logits_fn,
                                      model_forward, padded_vocab, prefill,
                                      prefill_chunk)

__all__ = ["Model", "decode_step", "init_cache", "init_params",
           "lm_head_weight", "logits_fn", "model_forward", "padded_vocab",
           "prefill", "prefill_chunk"]
