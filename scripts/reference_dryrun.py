"""The reference's dry run (``repro.launch.dryrun``) on the production
meshes under the installed jax, whose ``jax.make_mesh`` makes
``Explicit`` axes: under them the reference's
``with_sharding_constraint`` refuses to lower. This script replaces
``repro.launch.dryrun.make_production_mesh`` at run time with the same
meshes of ``AxisType.Auto`` axes and runs the reference's own
``run_cell``; nothing of ``src/repro`` changes.

    PYTHONPATH=src python scripts/reference_dryrun.py --out DIR \\
        [--layout dp_all] [--mesh single|multi|both] [--period] \\
        [--mode MODE[,MODE...]] [--tag TAG] [ARCH:SHAPE ...]

With no cell named, every live cell. Records land in DIR as
``<arch>__<shape>__<mesh>[__<tag>].json`` (the reference's names and
keys, beside its ``.hlo.zst``); ``python -m repro_torch.launch.dryrun
--reference DIR`` states the port's FLOPs against them. ``--period``
cuts depth to one period of the layer pattern (tag ``period`` unless
``--tag`` says otherwise). ``--mode`` builds the train cells on each
named step (``masked`` by default; ``cge``, ``stale``, ``trimmed`` and
``quantized`` are the general step's), and a general mode's records
carry the mode in their tag: ``cge``, or ``period_cge`` with
``--period``, ``TAG_cge`` with ``--tag TAG``.
"""
import os

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import argparse  # noqa: E402

import jax  # noqa: E402
from jax.sharding import AxisType  # noqa: E402

import repro.launch.dryrun as D  # noqa: E402
from repro.configs.registry import get_config  # noqa: E402


def auto_mesh(*, multi_pod: bool = False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return jax.make_mesh(shape, axes,
                         axis_types=(AxisType.Auto,) * len(axes))


MODES = ("masked", "cge", "stale", "trimmed", "quantized")


def record_tag(tag, period: bool, mode: str) -> str:
    """A record's tag: ``tag`` (``period`` for one period of depth where
    none is given), and a general mode's name after it."""
    base = tag if tag is not None else ("period" if period else "")
    return "_".join(t for t in (base, "" if mode == "masked" else mode)
                    if t)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("cells", nargs="*", help="ARCH:SHAPE")
    ap.add_argument("--out", required=True)
    ap.add_argument("--layout", default="baseline", choices=sorted(D.LAYOUTS))
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--period", action="store_true")
    ap.add_argument("--mode", default="masked",
                    help="masked, or comma-separated modes among masked, "
                         "cge, stale, trimmed, quantized")
    ap.add_argument("--tag", default=None)
    args = ap.parse_args(argv)
    D.make_production_mesh = auto_mesh
    cells = ([tuple(c.split(":")) for c in args.cells] if args.cells
             else D.live_cells())
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    modes = args.mode.split(",")
    for mode in modes:
        if mode not in MODES:
            ap.error(f"unknown mode {mode!r}: want one of {MODES}")
    for arch, shape in cells:
        patch = ({"n_layers": get_config(arch).period} if args.period
                 else None)
        for mesh, mode in ((m, o) for m in meshes for o in modes):
            tag = record_tag(args.tag, args.period, mode)
            rec = D.run_cell(arch, shape, mesh == "multi", mode=mode,
                             out_dir=args.out, tag=tag, cfg_patch=patch,
                             layout=args.layout)
            jax.clear_caches()
            print(f"[{'OK ' if rec['ok'] else 'FAIL'}] {arch:18s} "
                  f"{shape:12s} {mesh:6s} {mode:9s} "
                  f"flops={rec.get('hlo', {}).get('flops', '-')}"
                  + ("" if rec["ok"] else f"  {rec.get('error')}"),
                  flush=True)


if __name__ == "__main__":
    main()
