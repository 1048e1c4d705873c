"""End-to-end LM training script on the PyTorch port: any ``--arch`` from
the registry trained with Algorithm-1 masked D-SGD (the straggler oracle
drops the r slowest agents per step), async atomic checkpointing,
restart-on-launch. The same CLI and defaults as ``examples/train_lm.py``,
plus ``--device`` (a card unless ``--device cpu``).

Default: the reduced config of the chosen arch on synthetic Markov-chain
tokens (the loss falls in a few hundred steps). ``--full`` presets a
~100M-parameter model.

    PYTHONPATH=src python examples/torch_train_lm.py --arch qwen2-0.5b \\
        --steps 300 --r 2 --agents 8 --ckpt /tmp/ckpt_lm --device cpu
"""
import argparse
import dataclasses

import numpy as np

from repro_torch.configs.registry import get_config
from repro_torch.data.synthetic import lm_batches, markov_tokens
from repro_torch.launch.loop import StragglerOracle, TrainLoop
from repro_torch.launch.train import TrainConfig


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--agents", type=int, default=8)
    ap.add_argument("--r", type=int, default=2)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--mode", default="masked")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--full", action="store_true",
                    help="~100M-param config (accelerator scale)")
    args = ap.parse_args()

    cfg = get_config(args.arch).reduced()
    if args.full:
        cfg = dataclasses.replace(cfg, n_layers=8 * cfg.period, d_model=512,
                                  n_heads=8, n_kv_heads=4, d_ff=2048,
                                  vocab_size=32768, head_dim=64)
    assert args.batch % args.agents == 0, "batch must split across agents"

    tokens = markov_tokens(200_000, vocab=cfg.vocab_size, seed=0)
    data = lm_batches(tokens, args.batch, args.seq, seed=1)

    tc = TrainConfig(mode="masked", lr=args.lr, lr_kind="cosine",
                     lr_total=args.steps, warmup=args.steps // 20,
                     remat_policy="none")
    loop = TrainLoop(cfg, tc, data, n_agents=args.agents, r=args.r,
                     oracle=StragglerOracle(args.agents, args.r, seed=2),
                     ckpt_dir=args.ckpt or None,
                     ckpt_every=args.ckpt_every, max_pos=args.seq + 1,
                     device=args.device)
    hist = loop.run(args.steps, log_every=max(args.steps // 10, 1))

    l0 = np.mean(hist.loss[:10])
    l1 = np.mean(hist.loss[-10:])
    print(f"\nloss {l0:.3f} -> {l1:.3f} over {args.steps} steps "
          f"(r={args.r}/{args.agents} agents dropped per round)")
    print(f"simulated communication saving vs synchronous: "
          f"{100 * hist.comm_saving:.0f}%")


if __name__ == "__main__":
    main()
