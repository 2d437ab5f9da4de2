"""Training launcher: end-to-end driver (data → train_step → checkpoints,
fault-tolerant resume), the reference's src/repro/launch/train.py with
its flags, plus --device.

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \
      --smoke --device cpu --steps 20 --ckpt /tmp/ckpt

trains on the card by default (--device cuda); --smoke takes the tiny
same-family config.  The step is `graphed_step(make_train_step(...))`, as
the reference jits it: on the card one CUDA graph of the whole step,
replayed from the second step on; on the CPU the same step eagerly over
the same static buffers.  Weights are random from --seed, the data
`SyntheticLMData` from the same seed.  Without --ckpt the checkpoints go
to a temporary directory that is removed at the end.
"""
from __future__ import annotations

import argparse
import tempfile
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--d-model", type=int, default=0,
                    help="override width (e.g. ~100M preset: 768)")
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from ..configs import get_config, smoke_config
    from ..data import SyntheticLMData
    from ..models import get_model
    from ..optim.adamw import adamw_init
    from ..runtime import TrainRunner
    from ..train import graphed_step, make_train_step

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.d_model:
        hd = max(16, args.d_model // max(cfg.num_heads, 1))
        cfg = cfg.replace(d_model=args.d_model, d_ff=args.d_model * 4,
                          head_dim=hd)
    if args.layers:
        cfg = cfg.replace(layout=tuple((pat, args.layers)
                                       for pat, _ in cfg.layout[:1]))

    model = get_model(cfg, device=args.device).init(args.seed)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[train] arch={cfg.name} params={n_params/1e6:.1f}M "
          f"layers={cfg.num_layers} d={cfg.d_model} device={model.device}")

    data = SyntheticLMData(cfg.vocab_size, args.global_batch, args.seq,
                           seed=args.seed,
                           with_frames=cfg.enc_seq if cfg.family == "audio"
                           else 0,
                           d_model=cfg.d_model,
                           with_pos_ids=cfg.family == "vlm")
    step_fn = graphed_step(make_train_step(cfg, None, ("data",), lr=args.lr,
                                           compress_grads=False))
    opt = adamw_init(dict(model.named_leaves()))

    with tempfile.TemporaryDirectory() as tmp:
        runner = TrainRunner(step_fn, model, opt, data,
                             ckpt_dir=args.ckpt or tmp,
                             ckpt_every=args.ckpt_every)
        if args.resume and runner.maybe_resume():
            print(f"[train] resumed from step {runner.step}")

        t0 = time.time()
        last = runner.step
        m = None
        while runner.step < args.steps:
            nxt = min(runner.step + args.log_every, args.steps)
            m = runner.run(nxt)
            dt = time.time() - t0
            sps = (runner.step - last) / max(dt, 1e-9)
            t0, last = time.time(), runner.step
            print(f"[train] step {runner.step:5d} loss={float(m['loss']):.4f}"
                  f" gnorm={float(m['grad_norm']):.3f} ({sps:.2f} steps/s)")
        if args.ckpt:
            runner.save()
            runner.mgr.wait()
    return float(m["loss"]) if m is not None else float("nan")


if __name__ == "__main__":
    main()
