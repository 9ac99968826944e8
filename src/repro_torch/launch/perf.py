"""§Perf hillclimb: named sharding/config variants for the
selected (arch x shape) pairs, each placed, counted on rank 0 of the
single-pod mesh and roofline-analyzed (``launch/dryrun.py``).

Counterpart of ``repro.launch.perf``, with the same ``PAIRS``.

    PYTHONPATH=src python -m repro_torch.launch.perf --pair smollm  # or qwen/granite/all

What differs from the original: the records go to ``--out`` (default
``build/repro_torch/perf/perf_iterations.json``), where JAX's go to
``benchmarks/results/``, which the port leaves untouched; and a variant
that fails is recorded with status ``"error"`` and the run goes on, as
``dryrun.main`` does.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import traceback
from typing import Any, Dict, List

from ..configs import get_config
from .dryrun import fake_group, lower_one
from .mesh import make_production_mesh
from .shapes import SHAPES

DEFAULT_OUT = os.path.join("build", "repro_torch", "perf")


def _moe_override(arch: str, **moe_kw) -> Dict[str, Any]:
    base = get_config(arch).moe
    return {"moe": dataclasses.replace(base, **moe_kw)}


# variant name -> kwargs for lower_one
PAIRS: Dict[str, List[Dict[str, Any]]] = {
    # Most representative of the paper's technique (small-model HPO sweeps):
    # baseline wastes 16x redundant attention compute (9 heads can't TP-shard).
    "smollm": [
        dict(arch="smollm-135m", shape="train_4k", variant="baseline"),
        dict(arch="smollm-135m", shape="train_4k", variant="dp_only",
             strategy="dp_only"),
        dict(arch="smollm-135m", shape="train_4k", variant="dp_only+noremat",
             strategy="dp_only", cfg_overrides={"remat": False}),
    ],
    # Most collective-bound + over-HBM: the 110B stress case.
    "qwen": [
        dict(arch="qwen1.5-110b", shape="train_4k", variant="baseline(mb8)"),
        dict(arch="qwen1.5-110b", shape="train_4k", variant="mb1",
             cfg_overrides={"train_microbatch": 1}),
        dict(arch="qwen1.5-110b", shape="train_4k", variant="mb16",
             cfg_overrides={"train_microbatch": 16}),
        dict(arch="qwen1.5-110b", shape="train_4k", variant="mb8+seqpar",
             seq_parallel=True),
        dict(arch="qwen1.5-110b", shape="train_4k", variant="mb1+seqpar",
             seq_parallel=True, cfg_overrides={"train_microbatch": 1}),
        # halve optimizer-state memory: AdamW moments in bf16
        dict(arch="qwen1.5-110b", shape="train_4k", variant="mb8+bf16mom",
             cfg_overrides={"opt_moment_dtype": "bfloat16"}),
        dict(arch="qwen1.5-110b", shape="train_4k", variant="mb4",
             cfg_overrides={"train_microbatch": 4}),
    ],
    # Worst useful-flops fraction: fine-grained MoE with E=40 (no clean EP).
    "granite": [
        dict(arch="granite-moe-3b-a800m", shape="train_4k", variant="baseline"),
        dict(arch="granite-moe-3b-a800m", shape="train_4k", variant="scatter",
             cfg_overrides=_moe_override("granite-moe-3b-a800m", impl="scatter")),
        dict(arch="granite-moe-3b-a800m", shape="train_4k", variant="scatter+g1024",
             cfg_overrides=_moe_override("granite-moe-3b-a800m", impl="scatter",
                                         group_size=1024)),
        dict(arch="granite-moe-3b-a800m", shape="train_4k", variant="einsum+g64",
             cfg_overrides=_moe_override("granite-moe-3b-a800m", group_size=64)),
        # vocab 49155 is indivisible by 16 -> logits replicate; pad to 49280
        # (= 16*3080, 128-aligned) so embed/head/logits shard over the TP axis
        dict(arch="granite-moe-3b-a800m", shape="train_4k", variant="padvocab",
             cfg_overrides={"padded_vocab": 49280}),
        dict(arch="granite-moe-3b-a800m", shape="train_4k", variant="padvocab+mb4",
             cfg_overrides={"padded_vocab": 49280, "train_microbatch": 4}),
        dict(arch="granite-moe-3b-a800m", shape="train_4k", variant="dp_only",
             strategy="dp_only"),
    ],
    # Beyond-paper check on the second MoE (EP divisible): does scatter help
    # when expert parallelism IS available?
    "deepseek": [
        dict(arch="deepseek-moe-16b", shape="train_4k", variant="baseline"),
        dict(arch="deepseek-moe-16b", shape="train_4k", variant="scatter",
             cfg_overrides=_moe_override("deepseek-moe-16b", impl="scatter")),
    ],
}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--pair", default="all", choices=["all"] + list(PAIRS))
    ap.add_argument("--variant", default=None, help="run only this variant name")
    ap.add_argument("--out", default=DEFAULT_OUT, help="directory for the JSON records")
    args = ap.parse_args(argv)

    selected = PAIRS if args.pair == "all" else {args.pair: PAIRS[args.pair]}
    path = os.path.join(args.out, "perf_iterations.json")
    records = []
    if os.path.exists(path):
        with open(path) as f:
            records = json.load(f)

    with fake_group(256):
        mesh = make_production_mesh()
        for pair, variants in selected.items():
            for v in variants:
                if args.variant and v["variant"] != args.variant:
                    continue
                v = dict(v)
                shape, arch = SHAPES[v.pop("shape")], v.pop("arch")
                try:
                    rec = lower_one(arch, shape, mesh, "pod16x16", **v)
                except Exception as e:  # noqa: BLE001 — record and continue
                    traceback.print_exc()
                    rec = {"arch": arch, "shape": shape.name, "mesh": "pod16x16",
                           "variant": v["variant"], "status": "error",
                           "error": f"{type(e).__name__}: {e}"}
                rec["pair"] = pair
                records = [r for r in records
                           if not (r.get("pair") == pair
                                   and r.get("variant") == rec.get("variant")
                                   and r.get("shape") == rec.get("shape"))]
                records.append(rec)
                os.makedirs(args.out, exist_ok=True)
                with open(path, "w") as f:
                    json.dump(records, f, indent=1, default=str)


if __name__ == "__main__":
    main()
