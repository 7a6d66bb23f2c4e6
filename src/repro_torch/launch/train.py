"""End-to-end training driver (the reference's ``launch/train.py``).

A training loop over the synthetic-but-learnable data pipeline
(prefetched on a host thread), the train step (microbatched gradient
accumulation, remat), async checkpointing, crash-safe resume
(``--resume`` picks up the latest committed manifest), and optional int8
error-feedback gradient compression.  It runs on ``cuda`` unless
``--device cpu`` is given:

    PYTHONPATH=src python -m repro_torch.launch.train --reduced \\
        --device cpu --steps 40 --ckpt-dir /tmp/ckpt
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import registry
from repro_torch.models.model import Model
from repro_torch.runtime import checkpoint as ckpt
from repro_torch.train import data, optimizer as opt, train_step as ts


def build(arch: str, *, reduced: bool, seq: int, batch: int, steps: int,
          lr: float, microbatches: int, compress: bool, opt_kind: str):
    cfg = registry.get(arch)
    if reduced:
        cfg = registry.reduced_config(cfg, seq_len=seq)
    model = Model(cfg)
    oc = opt.OptConfig(kind=opt_kind, lr=lr, total_steps=steps,
                       warmup_steps=max(steps // 20, 10))
    pipe = data.SyntheticLM(cfg.vocab, seq, batch,
                            frontend_tokens=(cfg.frontend_tokens
                                             if cfg.frontend != "none"
                                             else 0),
                            d_model=cfg.d_model)
    step_fn = ts.make_train_step(model, oc, microbatches=microbatches,
                                 compress=compress)
    return cfg, model, oc, pipe, step_fn


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--reduced", action="store_true",
                    help="shrink to a CPU-trainable config")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--opt", default="adamw", choices=("adamw", "adafactor"))
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compress", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the model trains")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg, model, oc, pipe, step_fn = build(
        args.arch, reduced=args.reduced, seq=args.seq, batch=args.batch,
        steps=args.steps, lr=args.lr, microbatches=args.microbatches,
        compress=args.compress, opt_kind=args.opt)
    print(f"arch={cfg.name} params≈{cfg.param_count()/1e6:.1f}M "
          f"family={cfg.family} device={dev}")

    params, opt_state, err_state = ts.init_train_state(
        model, oc, torch.Generator(device=dev).manual_seed(args.seed),
        device=dev, compress=args.compress)
    start = 0
    cp = None
    if args.ckpt_dir:
        cp = ckpt.AsyncCheckpointer(args.ckpt_dir)
        last = ckpt.latest_step(args.ckpt_dir) if args.resume else None
        if last is not None:
            restored, _ = ckpt.restore(args.ckpt_dir, last,
                                       {"params": params, "opt": opt_state})
            params, opt_state = restored["params"], restored["opt"]
            start = last
            print(f"resumed from step {start}")

    losses = []
    t0 = time.time()
    it = data.PrefetchIterator(pipe.iterate(start))
    for step in range(start, args.steps):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in next(it).items()}
        params, opt_state, err_state, metrics = step_fn(
            params, opt_state, err_state, batch)
        if (step + 1) % args.log_every == 0 or step == start:
            loss = float(metrics["loss"])
            losses.append(loss)
            print(f"step {step + 1:5d}  loss {loss:.4f}  "
                  f"gnorm {float(metrics['grad_norm']):.3f}  "
                  f"lr {float(metrics['lr']):.2e}  {time.time() - t0:.1f}s")
        if cp and ((step + 1) % args.save_every == 0 or
                   step + 1 == args.steps):
            cp.save(step + 1, {"params": params, "opt": opt_state})
    if cp:
        cp.wait()
    if not losses:
        print(f"done: nothing to train from step {start}")
        return {"start_step": start}
    print(f"done: first logged loss {losses[0]:.4f} → last {losses[-1]:.4f}")
    return {"start_step": start, "first_loss": losses[0],
            "last_loss": losses[-1]}


if __name__ == "__main__":
    main()
