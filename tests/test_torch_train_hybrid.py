"""The port's train step against the JAX package's on bridged fp32 weights,
on the CPU, for the configs with mamba, MLA and MoE layers: mamba2-1.3b
(the SSD scan through ``ssd_chunked``), deepseek-v2-lite-16b (MLA, the MoE
FFN and its aux loss, shared experts) and jamba-v0.1-52b (mamba, attention
and MoE in one period); and the bf16 step of mamba2-1.3b as the reference
casts.  Tolerances as in ``test_torch_train_step.py``."""
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import test_torch_train_step as P  # noqa: E402
from test_torch_train_step import (B, METRICS, OPT, S,  # noqa: E402,F401
                                  one_thread)
from repro_torch.training import train_step as TTS  # noqa: E402


@pytest.mark.parametrize("arch,lps,partial", [
    ("mamba2-1.3b", 2, True),
    ("deepseek-v2-lite-16b", 1, False),
    ("jamba-v0.1-52b", 1, False),
])
def test_train_step_matches_jax_fp32(monkeypatch, arch, lps, partial):
    P.identity_cast(monkeypatch)
    jcfg, tcfg, params, model = P.bridged(arch, lps)
    jopt_cfg, topt_cfg = P.opt_configs(**OPT)
    toks, labels, mask = P.batch(tcfg.vocab_size, (B, S), seed=2,
                                 partial_mask=partial)
    jp, jo, jm = P.jax_step((arch, lps), jcfg, jopt_cfg)(
        params, P.jax_opt(params), jnp.asarray(toks), jnp.asarray(labels),
        jnp.asarray(mask))
    topt = P.port_opt(model)
    _, _, tm = TTS.make_train_step(tcfg, topt_cfg, ce_chunk=P.CE_CHUNK)(
        model, topt, *map(torch.from_numpy, (toks, labels, mask)))
    P.assert_step_matches(model, topt, tm, jp, jo, jm, METRICS)
    if tcfg.moe is not None:
        assert float(tm["aux_loss"]) > 0


def test_bf16_step_matches_jax_mamba():
    P.bf16_grads_match("mamba2-1.3b", 2)
