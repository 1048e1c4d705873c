#!/usr/bin/env python3
"""Readings that the limits of ``bench/workloads/<cell>.json`` are set
from, on the card, at the cell's own size; not run by the benchmark's
own runs.

    python3 bench/calibrate.py --workload <cell> --seeds 1,2,... \\
        [--control-seeds 1,2,3] [--seconds 8] [--out FILE]

For each of ``--seeds`` the program's sound run is compared with the
plain reference (the lower readings). For each of ``--control-seeds``
the reference computed in the precision below the configuration's
(float8 e4m3 for bfloat16) takes the program's place (the upper
readings); a training cell also reads its faults there: half of the
kept rows left out, the mean over the rest. A serving cell's control
reads, on the program's own served requests, the gap of the token the
control puts first. One JSON line a reading, on standard output and
appended to ``--out``.
"""
import time

T0 = time.monotonic()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent


def _emit(out, rec) -> None:
    line = json.dumps(rec)
    print(line, flush=True)
    if out:
        with open(out, "a") as f:
            f.write(line + "\n")


def _free() -> None:
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def train(cell, seeds, control_seeds, out) -> None:
    import judge
    import tokens
    from reference.model import BELOW, precision
    drv = spec.driver(cell.traffic)
    tr, n_ref = cell.traffic, cell.check["ref_steps"]
    for seed in seeds:
        t = time.monotonic()
        arch, loop, rows, times, step = drv.build(cell, seed, "cuda")
        prog = drv.program_readings(loop, step, seed, n_ref, tr["lr"])
        del loop, step
        _free()
        ref = drv.reference_readings(cell, arch, seed, n_ref, rows, times,
                                     "cuda")
        nums = judge.train_numbers(prog, ref)
        ch = sorted(prog["change"].values())
        _emit(out, {"cell": cell.name, "kind": "program", "seed": seed,
                    "numbers": nums, "loss_prog": prog["loss"],
                    "loss_ref": ref["loss"], "change_median": ch[len(ch) // 2],
                    "change_zero": sum(1 for v in ch if v == 0.0),
                    "leaves": len(ch), "s": time.monotonic() - t})
        _free()
    for seed in control_seeds:
        arch = drv.arch_config(cell.config)
        stream = tokens.stream(seed, tr["seq_len"], arch.vocab_size)
        rows = tokens.TrainRows(seed, stream, tr["agents"], tr["seq_len"])
        times = tokens.AgentTimes(seed, tr["agents"], tr["stragglers"],
                                  tr["straggler_factor"], tr["latency_sigma"])
        ref = drv.reference_readings(cell, arch, seed, n_ref, rows, times,
                                     "cuda")
        _free()
        low = drv.reference_readings(cell, arch, seed, n_ref, rows, times,
                                     "cuda", mm=BELOW[precision(cell.config)])
        _emit(out, {"cell": cell.name, "kind": "control", "seed": seed,
                    "numbers": judge.train_numbers(low, ref)})
        _free()
        half = drv.reference_readings(cell, arch, seed, n_ref, rows,
                                      _Half(times), "cuda")
        _emit(out, {"cell": cell.name, "kind": "fault_half_batch",
                    "seed": seed, "numbers": judge.train_numbers(half, ref)})
        _free()


class _Half:
    """Agent times whose S^t keeps only the first half of its agents."""

    def __init__(self, times):
        self.times = times

    def kept(self, t, r):
        k = self.times.kept(t, r)
        return k[:len(k) // 2]


def serve(cell, seeds, control_seeds, seconds, out) -> None:
    from reference.model import BELOW, precision
    drv = spec.driver(cell.traffic)
    chk = cell.check
    for seed in seeds:
        t = time.monotonic()
        params, eng, loop = drv.build(cell, seed, "cuda")
        drv.warm(loop)
        w = drv.window(loop, seconds, None)
        picked = drv.sample(loop.done, seed, chk["check_requests"])
        del eng, loop.eng
        _free()
        gaps = drv.check(params, cell.config, picked, chk["ref_batch"])
        rec = {"cell": cell.name, "kind": "program", "seed": seed,
               "numbers": drv.gap_numbers(gaps), "done": len(loop.done),
               "tokens": sum(len(q.state.generated) for q in picked),
               "window_tokens": w["tokens"], "s": time.monotonic() - t}
        _emit(out, rec)
        if seed in control_seeds:
            low = drv.check(params, cell.config, picked, chk["ref_batch"],
                            control=BELOW[precision(cell.config)])
            _emit(out, {"cell": cell.name, "kind": "control", "seed": seed,
                        "numbers": drv.gap_numbers(low)})
        del params, loop, picked
        _free()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(BENCH))
    global spec
    import run
    run._environment()
    import spec
    from program import import_port
    import_port()
    import torch
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 3
    torch.set_num_threads(4)
    cell = spec.cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    ctl = [int(s) for s in args.control_seeds.split(",") if s]
    if cell.traffic["driver"] == "train_alg1":
        train(cell, seeds, ctl, args.out)
    else:
        serve(cell, seeds, ctl, args.seconds, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
