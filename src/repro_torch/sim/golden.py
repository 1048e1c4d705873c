"""Golden-trace record/replay (DESIGN.md §10).

Policy: every registered scenario has one committed JSON trace under
``tests/golden/`` covering *both* stacks (train + serve). Floats are
serialized as ``float.hex()`` so the comparison is bit-exact, and a
sha256 digest over every step (not just the stored ones) makes drift
anywhere in the run fail the replay even though only a prefix + stride
of steps is stored verbatim for diagnosis.

Torch port of ``repro.sim.golden``. The committed traces under
``tests/golden/`` belong to the JAX reference (``python -m
repro.sim.golden --record`` writes them); this module only reads them.
Its ``--record`` writes under the directory ``--out`` names, which it
requires. The train stack's float fields (``loss``, ``dist``, the final
iterate) come from an f32 reduction in another order than XLA's, so a
replay of the committed traces may differ from them in the last ulp and
so in the digests; the discrete fields and the serve stack (numpy) are
the reference's exactly. Parity with the reference is held by the tests
against a live JAX run, field by field within a stated tolerance.

CLI::

    python -m repro_torch.sim.golden              # verify all traces
    python -m repro_torch.sim.golden --smoke      # the smoke subset
    python -m repro_torch.sim.golden --device cpu # on the CPU
    python -m repro_torch.sim.golden --record --out DIR   # write traces
"""
from __future__ import annotations

import argparse
import hashlib
import json
import sys
from pathlib import Path
from typing import Dict, List, Optional, Sequence

GOLDEN_DIR = Path(__file__).resolve().parents[3] / "tests" / "golden"
SMOKE_SCENARIOS = ("steady_state", "message_chaos", "e2e_steady")
# stored verbatim: the first STORE_PREFIX steps + every STORE_STRIDE-th;
# the digest still covers every step
STORE_PREFIX = 20
STORE_STRIDE = 25

_FLOAT_KEYS = ("comm", "loss", "dist", "stale", "amax", "lat")


def _enc_step(step: dict) -> dict:
    out = {}
    for k, v in step.items():
        out[k] = float(v).hex() if k in _FLOAT_KEYS else v
    return out


def _digest(steps: List[dict]) -> str:
    h = hashlib.sha256()
    for step in steps:
        h.update(json.dumps(_enc_step(step), sort_keys=True).encode())
    return h.hexdigest()


def _stored(steps: List[dict]) -> List[dict]:
    keep = [s for i, s in enumerate(steps)
            if i < STORE_PREFIX or i % STORE_STRIDE == 0
            or i == len(steps) - 1]
    return [_enc_step(s) for s in keep]


def build_trace(name: str, device="cuda") -> dict:
    """Run one scenario through both stacks and encode the trace; the
    train stack's rule runs on ``device``."""
    from repro_torch.sim.scenario import get_scenario, run_serve, run_train
    sc = get_scenario(name)
    rt = run_train(sc, device=device)
    rs = run_serve(sc)
    x = rt.server.x
    return {
        "scenario": name,
        "seed": sc.seed,
        "iters": sc.iters,
        "train": {
            "digest": _digest(rt.trace),
            "steps": _stored(rt.trace),
            "bytes_tx": int(rt.hist.bytes_tx),
            "final_x_sha": hashlib.sha256(x.tobytes()).hexdigest()[:16],
            "violations": len(rt.violations),
            "drops": int(rt.transport.drops),
            "dups": int(rt.transport.dups),
        },
        "serve": {
            "digest": _digest(rs.trace),
            "steps": _stored(rs.trace),
            "requests": len(rs.trace),
            "violations": len(rs.violations),
        },
    }


def trace_path(name: str) -> Path:
    return GOLDEN_DIR / f"{name}.json"


def save_trace(trace: dict, out_dir: Path) -> Path:
    """Write ``trace`` under ``out_dir``, never into ``GOLDEN_DIR``."""
    out_dir = Path(out_dir)
    if out_dir.resolve() == GOLDEN_DIR:
        raise ValueError(f"{GOLDEN_DIR} holds the reference's traces; "
                         "record elsewhere")
    path = out_dir / f"{trace['scenario']}.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(trace, indent=1, sort_keys=True) + "\n")
    return path


def load_trace(name: str) -> dict:
    return json.loads(trace_path(name).read_text())


def diff_traces(golden: dict, fresh: dict) -> List[str]:
    """Human-readable mismatches, most localized first: stored steps are
    compared field-by-field before falling back to the whole-run digest,
    so drift names the first diverging iteration when it is stored."""
    out: List[str] = []
    for side in ("train", "serve"):
        g, f = golden[side], fresh[side]
        for i, (gs, fs) in enumerate(zip(g["steps"], f["steps"])):
            if gs != fs:
                fields = [k for k in gs if gs.get(k) != fs.get(k)]
                out.append(f"{side} stored step {i} "
                           f"(t={gs.get('t', gs.get('i'))}): "
                           f"fields {fields} differ: "
                           f"{ {k: (gs.get(k), fs.get(k)) for k in fields} }")
                break
        for key in (k for k in g if k != "steps"):
            if g[key] != f[key]:
                out.append(f"{side}.{key}: golden={g[key]} fresh={f[key]}")
    return out


def verify(names: Sequence[str], device="cuda") -> Dict[str, List[str]]:
    """name -> list of mismatches (empty = conformant replay)."""
    results: Dict[str, List[str]] = {}
    for name in names:
        if not trace_path(name).exists():
            results[name] = [f"no committed golden trace at "
                             f"{trace_path(name)}"]
            continue
        results[name] = diff_traces(load_trace(name),
                                    build_trace(name, device))
    return results


def main(argv: Optional[Sequence[str]] = None) -> int:
    from repro_torch.sim.scenario import SCENARIOS
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--record", action="store_true",
                   help="write traces under --out instead of verifying")
    p.add_argument("--out", type=Path,
                   help="directory --record writes to (required with it)")
    p.add_argument("--device", default="cuda",
                   help="where the train stack's rule runs (default cuda)")
    p.add_argument("--smoke", action="store_true",
                   help=f"only the smoke subset {SMOKE_SCENARIOS}")
    p.add_argument("names", nargs="*",
                   help="scenario names (default: all registered)")
    args = p.parse_args(argv)
    if args.record and args.out is None:
        p.error("--record needs --out DIR: tests/golden/ holds the "
                "reference's traces")
    names = args.names or (list(SMOKE_SCENARIOS) if args.smoke
                           else sorted(SCENARIOS))

    if args.record:
        for name in names:
            path = save_trace(build_trace(name, args.device), args.out)
            print(f"recorded {path}")
        return 0

    failed = 0
    for name, mismatches in verify(names, args.device).items():
        if mismatches:
            failed += 1
            print(f"DRIFT {name}:")
            for m in mismatches:
                print(f"  {m}")
        else:
            print(f"ok {name}")
    if failed:
        print(f"{failed}/{len(names)} golden traces drifted", file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
