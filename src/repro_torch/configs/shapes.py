"""Assigned input shapes (one set, shared by all 10 LM archs) and the
per-arch applicability rules for the 40-cell dry-run matrix — port of
``repro.configs.shapes`` (a copy: the port imports nothing of ``repro``)."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

# long_500k needs sub-quadratic / bounded attention state. Allowed:
#   SSM (mamba2), hybrid (jamba), SWA-dominant (gemma3 5:1 local, mixtral SWA).
# Pure full-attention archs + enc-dec whisper skip it.
LONG_OK = {"mamba2-130m", "jamba-1.5-large-398b", "gemma3-4b",
           "mixtral-8x22b"}


def applicable(arch_name: str, shape: str) -> bool:
    if shape == "long_500k":
        return arch_name in LONG_OK
    return True


def cells(arch_names):
    """All (arch, shape) dry-run cells incl. skip markers."""
    out = []
    for a in arch_names:
        for s in SHAPES:
            out.append((a, s, applicable(a, s)))
    return out
