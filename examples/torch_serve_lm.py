"""Continuous-batching serving example on the PyTorch port's paged
KV/SSM cache.

A mixed-length request stream flows through a fixed pool of decode slots
and a paged cache (repro_torch.serve): requests admit when a slot + pages
free up, decode as one ragged batch, and retire slot-by-slot. Works for
every registry arch family (attention, MLA, SSM/RWKV, hybrid, MoE). The
same CLI and output as ``examples/serve_lm.py``, plus ``--device`` (the
card unless ``--device cpu``); the weights come from a torch generator
seeded with ``--seed`` (the reference draws from ``jax.random``, so the
streams match it only on carried-over weights: ``main(params=)``).

    PYTHONPATH=src python examples/torch_serve_lm.py --arch rwkv6-3b \\
        --requests 6 --device cpu
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs.registry import get_config
from repro_torch.models.model import init_model, tree_to
from repro_torch.serve import PagedCacheConfig, ServeEngine


def main(argv=None, params=None):
    """Runs the example; returns the lines it prints. ``params`` (a
    parameter tree, e.g. ``params_from_jax`` of the reference's) replaces
    the seeded weights."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--page-size", type=int, default=8)
    ap.add_argument("--num-pages", type=int, default=33)
    ap.add_argument("--max-prompt", type=int, default=24)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    lines = []

    def say(line):
        print(line, flush=True)
        lines.append(line)

    cfg = get_config(args.arch).reduced()
    if params is None:
        params = init_model(torch.Generator().manual_seed(args.seed), cfg,
                            device=args.device, max_pos=256)
    else:
        params = tree_to(params, args.device)
    rng = np.random.default_rng(args.seed)

    ccfg = PagedCacheConfig(
        num_slots=args.slots, page_size=args.page_size,
        num_pages=args.num_pages,
        max_pages_per_seq=-(-(args.max_prompt + args.max_new)
                            // args.page_size))
    engine = ServeEngine(params, cfg, ccfg, device=args.device)

    reqs = []
    for _ in range(args.requests):
        s0 = int(rng.integers(4, args.max_prompt + 1))
        new = int(rng.integers(2, args.max_new + 1))
        prompt = rng.integers(0, cfg.vocab_size, s0).astype(np.int32)
        reqs.append((engine.submit(prompt, new), s0, new))

    t0 = time.time()
    out = engine.run()
    dt = time.time() - t0

    total_new = sum(new for _, _, new in reqs)
    say(f"arch={args.arch} served {args.requests} requests "
        f"({total_new} tokens) through {args.slots} slots in {dt:.2f}s "
        f"({total_new / max(dt, 1e-9):.1f} tok/s)")
    say(f"engine stats: {engine.stats}; peak slots in use: "
        f"{engine.sched.peak_active}; pages free at end: "
        f"{engine.kv.alloc.n_free}/{ccfg.num_pages - 1}")
    for rid, s0, new in reqs:
        say(f"  req {rid}: prompt {s0:3d} tokens -> {out[rid].tolist()}")
    return lines


if __name__ == "__main__":
    main()
