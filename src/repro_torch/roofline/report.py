"""Render the dry-run JSONs (``launch.dryrun``) into the roofline table —
port of ``repro.roofline.report``.

    PYTHONPATH=src python -m repro_torch.roofline.report \\
        experiments/dryrun_torch single
"""
from __future__ import annotations

import json
import pathlib
import sys

from repro_torch.configs.shapes import SHAPES


def fmt_s(x):
    if x is None:
        return "-"
    if x >= 1:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x * 1e3:.1f}ms"
    return f"{x * 1e6:.0f}us"


def load(dirpath):
    recs = []
    for p in sorted(pathlib.Path(dirpath).glob("*.json")):
        r = json.load(open(p))
        r["_name"] = p.stem
        recs.append(r)
    return recs


def _arch_shape(stem: str) -> tuple[str, str]:
    """(arch, shape) of a record name's "<arch>_<shape>" (shape names hold
    underscores, so the split is at the shape the name ends with)."""
    shape = next(s for s in SHAPES if stem.endswith(f"_{s}"))
    return stem[:-len(shape) - 1], shape


VARIANT_SUFFIXES = ("_gather", "_ring", "_vpad", "_puredp", "_ckv", "_bf16")


def table(dirpath, mesh="single", variants=False):
    rows = []
    hdr = ("| arch | shape | chips | t_compute | t_memory | t_coll | "
           "bottleneck | useful | roofline |")
    sep = "|" + "---|" * 9
    rows.append(hdr)
    rows.append(sep)
    for r in load(dirpath):
        is_variant = any(r["_name"].endswith(v) for v in VARIANT_SUFFIXES)
        if is_variant != variants:
            continue
        if r.get("status") == "skip":
            if r["_name"].endswith(f"_{mesh}"):
                arch, shape = _arch_shape(r["_name"].rsplit(f"_{mesh}", 1)[0])
                rows.append(f"| {arch} | {shape} | - | - | - | - | SKIP "
                            f"(sub-quadratic rule) | - | - |")
            continue
        if r.get("status") != "ok" or r.get("mesh") != mesh \
                or "t_compute" not in r:
            continue
        tag = ""
        for v in VARIANT_SUFFIXES:
            if r["_name"].endswith(v):
                tag = " " + v
        rows.append(
            f"| {r['arch']}{tag} | {r['shape']} | {r['chips']} | "
            f"{fmt_s(r['t_compute'])} | {fmt_s(r['t_memory'])} | "
            f"{fmt_s(r['t_collective'])} | {r['bottleneck']} | "
            f"{r['useful_fraction']:.2f} | {r['roofline_fraction']:.3f} |")
    return "\n".join(rows)


if __name__ == "__main__":
    d = sys.argv[1] if len(sys.argv) > 1 else "experiments/dryrun_torch"
    mesh = sys.argv[2] if len(sys.argv) > 2 else "single"
    print(table(d, mesh))
