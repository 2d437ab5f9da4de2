"""Serving launcher: batched prefill + decode loop with KV/state cache.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \
      --batch 4 --prompt-len 32 --gen 16

runs the full-size config on the card (random weights from --seed);
--smoke takes the tiny same-family config and --device cpu the CPU.  The
audio family (--arch whisper-tiny) gets stub frames [batch, enc_seq,
d_model] from --seed, as the reference's launcher.  As the reference jits
its two steps, the prefill and the decode run through `serve/graph.py`:
the decode as one CUDA graph on the card (over the prefill's cache, its
position staged into the graph's buffer each step), eagerly over the
same buffers on the CPU; the one prefill, a first sight, runs the plain
step.
"""
from __future__ import annotations

import argparse
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    from ..configs import get_config, smoke_config
    from ..models import get_model
    from ..serve import (graphed_decode, graphed_prefill, make_decode_step,
                         make_prefill_step)

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = get_model(cfg, device=args.device)
    model.init(args.seed)
    rng = np.random.default_rng(args.seed)
    max_seq = args.prompt_len + args.gen

    batch = {"tokens": torch.as_tensor(rng.integers(
        0, cfg.vocab_size, (args.batch, args.prompt_len)).astype(np.int32),
        device=model.device)}
    if cfg.family == "audio":
        # the reference launcher's stub frame embeddings
        batch["frames"] = torch.as_tensor(rng.standard_normal(
            (args.batch, cfg.enc_seq, cfg.d_model)).astype(np.float32),
            device=model.device)
    if cfg.family == "vlm":
        # the reference launcher's stub M-RoPE positions: the text stream
        # on all three
        batch["pos_ids"] = torch.as_tensor(np.broadcast_to(
            np.arange(args.prompt_len, dtype=np.int32)[None, :, None],
            (args.batch, args.prompt_len, 3)).copy(), device=model.device)
    prefill = graphed_prefill(make_prefill_step(cfg, max_seq))
    decode = graphed_decode(make_decode_step(cfg))

    t0 = time.time()
    logits, cache = prefill(model, batch)
    tok = torch.argmax(logits, -1)[:, None]
    out = [tok.cpu().numpy()]
    for i in range(args.gen - 1):
        logits, cache = decode(model, cache, tok, args.prompt_len + i)
        tok = torch.argmax(logits, -1)[:, None]
        out.append(tok.cpu().numpy())
    dt = time.time() - t0
    gen = np.concatenate(out, axis=1).astype(np.int32)
    print(f"[serve] arch={cfg.name} device={model.device} "
          f"batch={args.batch} prompt={args.prompt_len} "
          f"generated={gen.shape[1]} tokens in {dt:.2f}s "
          f"({args.batch * gen.shape[1] / dt:.1f} tok/s)")
    print("[serve] sample token ids:", gen[0][:12].tolist())
    return gen


if __name__ == "__main__":
    main()
