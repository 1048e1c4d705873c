"""Configurations and cells of ``BENCHMARK.json`` cut to a size the CPU
runs in seconds: every width of the configuration shrunk, the layer
pattern whole, the traffic cut to a few agents or clients. The limits are
the cell's own."""
import copy

import spec

ARCH = {"d_model": 64, "n_heads": 4, "head_dim": 16, "d_ff": 128,
        "vocab_size": 256}
F32 = {"param_dtype": "float32", "compute_dtype": "float32"}
TRAFFIC = {
    "train_alg1": {"agents": 4, "r": 1, "seq_len": 32, "stragglers": 1},
    "serve_closed": {"clients": 3, "slots": 3,
                     "prompt_len": {"min": 16, "max": 48},
                     "output_len": {"min": 3, "max": 6}},
}


def config(name: str, bf16: bool = False) -> dict:
    """The configuration file ``bench/configs/<name>.json`` cut to size;
    in float32 unless ``bf16`` keeps its own bfloat16."""
    c = spec.load_json(spec.BENCH / "configs" / f"{name}.json")
    a = c["arch"]
    kv = min(a["n_kv_heads"], 2)
    a.update(ARCH, **({} if bf16 else F32))
    a.update(n_kv_heads=kv, n_layers=2 * len(a["layer_pattern"])
             if len(a["layer_pattern"]) == 1 else len(a["layer_pattern"]))
    if a.get("moe"):
        a["moe"].update(num_experts=4, d_ff_expert=64)
    if a.get("ssm"):
        a["ssm"].update(d_state=8, dt_rank=8)
    return c


def cell(name: str, bf16: bool = False, **traffic) -> "spec.Cell":
    """The cell cut to size (see ``config``)."""
    c = copy.deepcopy(spec.cell(name))
    c.config = config(c.config["name"], bf16)
    c.traffic.update(copy.deepcopy(TRAFFIC[c.traffic["driver"]]))
    if c.traffic["driver"] == "serve_closed":
        c.check["check_requests"] = 3
    c.traffic.update(traffic)
    return c
