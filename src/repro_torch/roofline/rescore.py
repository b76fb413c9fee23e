"""Rescore saved dry-run records: the derived terms recomputed (napkin
memory, the H100 constants), and fresh probes on the ``meta`` device for
the MoE cells (or every cell with ``--reprobe-all``) — port of
``repro.roofline.rescore``. It sets no environment variable: the probes
need no devices.

    PYTHONPATH=src python -m repro_torch.roofline.rescore \\
        experiments/dryrun_torch
"""
import json
import pathlib
import sys

from repro_torch.configs.registry import get_config
from repro_torch.configs.shapes import SHAPES
from repro_torch.roofline import analysis


def main(dirpath: str, reprobe_all: bool = False):
    from repro_torch.launch.dryrun import MESHES, dp_product, probe_counts
    d = pathlib.Path(dirpath)
    probe_cache: dict[tuple, dict] = {}
    for p in sorted(d.glob("*.json")):
        if p.stem.startswith("gp_"):
            continue
        rec = json.load(open(p))
        if rec.get("status") != "ok" or "arch" not in rec:
            continue
        cfg = get_config(rec["arch"])
        shape = SHAPES[rec["shape"]]
        # the data-parallel product: single 16 (of 256 = 16 x 16), multi 32
        mg = dp_product(rec.get("mesh_sizes") or MESHES[rec["mesh"]])
        probe = None
        if reprobe_all or bool(cfg.moe_experts):
            key = (rec["arch"], rec["shape"], mg)
            if key not in probe_cache:
                probe_cache[key] = probe_counts(cfg, shape, shape.kind,
                                          moe_groups=mg)
            probe = probe_cache[key]
        new = analysis.rescore(
            rec, probe_flops_new=probe and probe["flops"],
            probe_bytes_new=probe and probe["bytes"])
        json.dump(new, open(p, "w"), indent=1)
        print(p.stem, f"useful={new['useful_fraction']:.2f}",
              f"bottleneck={new['bottleneck']}",
              f"roofline={new['roofline_fraction']:.3f}", flush=True)


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "experiments/dryrun_torch",
         reprobe_all="--reprobe-all" in sys.argv)
