"""Serving launcher: continuous-batching engine over a model of the port.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \\
        --scale 1 --requests 8 --slots 4

Runs on the card by default (``--device cuda``) and raises when there is
none; ``--device cpu`` runs the plain versions of the kernels on the CPU.
``--scale`` below 1 uses the reduced config of the tests, 1 the published
widths and depth.  Weights are random, from ``--seed``.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, scaled_down
from repro_torch.models import model as M
from repro_torch.serve.engine import Engine, Request

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--scale", type=float, default=0.05)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", choices=sorted(DTYPES), default="float32")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    dtype = DTYPES[args.dtype]
    cfg = get_config(args.arch)
    if args.scale < 1.0:
        cfg = scaled_down(cfg)
    params = M.init_params(cfg, args.seed, dtype=dtype, device=device)
    eng = Engine(cfg, params, batch_slots=args.slots,
                 cache_len=args.cache_len, dtype=dtype, device=device)
    rng = np.random.RandomState(args.seed)
    for i in range(args.requests):
        plen = 4 + (i % 5)
        prompt = torch.from_numpy(rng.randint(0, cfg.vocab, size=plen))
        eng.submit(Request(uid=i, prompt=prompt.to(torch.int32),
                           max_new_tokens=args.max_new))
    t0 = time.perf_counter()
    fins = eng.run_to_completion()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    toks = sum(len(f.tokens) for f in fins)
    print(f"served {len(fins)} requests, {toks} tokens in {dt:.2f}s "
          f"({toks / dt:.1f} tok/s, {args.slots} slots, {device})")
    for f in sorted(fins, key=lambda f: f.uid)[:4]:
        print(f"  req {f.uid}: {f.tokens}")
    return fins


if __name__ == "__main__":
    main()
