"""Training launcher: any ``--arch`` (full or --reduced), synthetic LM
data, AdamW (+WSD where the arch prescribes it), async fault-tolerant
checkpointing with automatic resume.

Counterpart of ``repro/launch/train.py``, with the same flags and the same
last line, plus ``--device`` (``cuda`` by default: without a card it
raises, as every entry point of the port does).  Checkpoints are in the
JAX package's layout, so either package resumes the other's run.  A
failure inside the loop still waits for the pending checkpoint before it
propagates.

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.1-8b \\
      --reduced --steps 100 --ckpt-dir /tmp/ckpt              # on the card
  PYTHONPATH=src python -m repro_torch.launch.train --reduced \\
      --device cpu --steps 60
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, reduce_config
from repro_torch.data.lm_data import SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.models.convert import (from_jax_params, opt_state_from_jax,
                                        opt_state_to_jax, to_numpy_tree)
from repro_torch.models.model import init_params
from repro_torch.training.checkpoint import (AsyncCheckpointer, latest_step,
                                             restore_checkpoint)
from repro_torch.training.optimizer import AdamWConfig, init_opt_state
from repro_torch.training.train_step import make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.1-8b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_config(cfg, layers_per_stage=2, d_model=128, d_ff=256,
                            vocab=512)
    print(f"arch={cfg.name} params~{cfg.param_count() / 1e6:.1f}M "
          f"schedule={cfg.lr_schedule}")

    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 5),
                          total_steps=args.steps,
                          schedule=("wsd" if cfg.lr_schedule == "wsd"
                                    else "cosine"))
    step_fn = make_train_step(cfg, opt_cfg, ce_chunk=64)
    data = SyntheticLM(cfg.vocab_size, seed=0)

    start = 0
    if args.ckpt_dir and latest_step(args.ckpt_dir) is not None:
        start = latest_step(args.ckpt_dir)
        state = restore_checkpoint(args.ckpt_dir, start)
        model = from_jax_params(state["params"], cfg, device=dev)
        opt = opt_state_from_jax(state["opt"], model, device=dev)
        print(f"resumed from step {start}")
    else:
        model = init_params(cfg, seed=0, dtype=torch.float32, device=dev)
        opt = init_opt_state(dict(model.named_parameters()))

    ckpt = AsyncCheckpointer()
    t0 = time.time()
    losses = []
    try:
        for step in range(start, args.steps):
            toks, labels, mask = (torch.from_numpy(a).to(dev) for a in
                                  data.batch(step, args.batch, args.seq))
            model, opt, metrics = step_fn(model, opt, toks, labels, mask)
            losses.append(float(metrics["loss"]))
            if (step + 1) % args.log_every == 0:
                print(f"step {step + 1:5d} loss={losses[-1]:.4f} "
                      f"lr={float(metrics['lr']):.2e} "
                      f"gnorm={float(metrics['grad_norm']):.3f} "
                      f"({(time.time() - t0) / (step - start + 1):.2f}s/step)")
            if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
                ckpt.save(args.ckpt_dir, step + 1,
                          {"params": to_numpy_tree(model),
                           "opt": opt_state_to_jax(model, opt)})
    finally:
        ckpt.wait()
    print(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f}); "
          f"uniform-entropy baseline {np.log(cfg.vocab_size):.3f}")
    return losses


if __name__ == "__main__":
    main()
