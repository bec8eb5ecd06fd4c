"""Batched serving example: prefill a batch of prompts on a reduced
same-family config and decode with sampled continuation — exercises the
``prefill`` / ``decode_step`` public API and the KV ring caches.  The port
of the reference's ``examples/serve_batched.py``::

    PYTHONPATH=src python -m repro_torch.examples.serve_batched \\
        --arch gemma3-12b --kernel

(uses the reduced same-family config; pass ``--gen`` / ``--batch`` to
scale).  The weights are drawn from a seeded ``torch.Generator`` (which
cannot replay ``jax.random``), the prompt from the reference's numpy
generator, and the continuation is sampled with an explicit
``torch.Generator`` seeded 1, the reference's sampling key.
``--kernel`` runs the prefill's attention through the flash kernels (on
the card; their plain version on the CPU), else the reference model's
chunked attention.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch.configs.base import get_config
from repro_torch.device import resolve_device
from repro_torch.models import model as M


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda unless told otherwise)")
    ap.add_argument("--kernel", action="store_true",
                    help="the prefill's attention through the flash "
                         "kernels (their plain version on the CPU)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config(args.arch, smoke=True)
    params = M.init_model(torch.Generator(device=dev).manual_seed(0), cfg,
                          dev)
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len)),
        dtype=torch.int32, device=dev)}
    if cfg.frontend_seq:
        batch["patches"] = torch.zeros(
            args.batch, cfg.frontend_seq, cfg.d_model, device=dev)
    if cfg.n_enc_layers:
        batch["frames"] = torch.zeros(
            args.batch, cfg.enc_seq, cfg.d_model, device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    with torch.inference_mode():
        t0 = time.perf_counter()
        logits, cache = M.prefill(params, cfg, batch,
                                  max_len=args.prompt_len + args.gen,
                                  kernel=args.kernel)
        sync()
        print(f"prefill: {time.perf_counter() - t0:.2f}s "
              f"(batch={args.batch}, prompt={args.prompt_len})")

        tok = logits.argmax(-1, keepdim=True).to(torch.int32)
        outs = []
        gen = torch.Generator(device=dev).manual_seed(1)
        t0 = time.perf_counter()
        for _ in range(args.gen):
            outs.append(tok[:, 0].cpu().numpy())
            logits, cache = M.decode_step(params, cfg, cache, tok)
            probs = torch.softmax(logits.float(), -1)
            tok = torch.multinomial(probs, 1, generator=gen).to(torch.int32)
        sync()
        dt = time.perf_counter() - t0
    print(f"decode: {args.gen} steps, "
          f"{args.batch * args.gen / dt:.1f} tok/s (batched)")
    print("sample:", np.stack(outs, 1)[0][:16].tolist())
    return 0


if __name__ == "__main__":
    sys.exit(main())
