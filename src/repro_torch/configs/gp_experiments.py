"""The paper's experiment grid (Sec. 6), as config objects.

Values from the text: |D| in {8000, 16000, 24000, 32000}; M in
{4, 8, 12, 16, 20}; P = |S| = R in {256, 512, 1024, 2048} (R doubled for
SARCOS); test fraction 10%; hyperparameters by MLE on a 10000 subset.
``scaled_grid`` shrinks everything by a factor for CPU-container benches
while preserving the ratios the figures sweep.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class GPExperiment:
    domain: str                  # "aimpeak" | "sarcos"
    data_sizes: tuple            # |D| sweep (Fig 1)
    machines: tuple              # M sweep (Fig 2)
    params: tuple                # P = |S| sweep (Fig 3)
    rank_multiplier: int         # R = mult * |S| (SARCOS uses 2, Sec. 6)
    fixed_data: int              # |D| for Figs 2-3
    fixed_machines: int          # M for Figs 1,3
    fixed_param: int             # |S| for Figs 1-2
    input_dim: int
    mle_subset: int = 10000


PAPER_GRID = {
    "aimpeak": GPExperiment(
        domain="aimpeak",
        data_sizes=(8000, 16000, 24000, 32000),
        machines=(4, 8, 12, 16, 20),
        params=(256, 512, 1024, 2048),
        rank_multiplier=1,
        fixed_data=32000, fixed_machines=20, fixed_param=2048,
        input_dim=5),
    "sarcos": GPExperiment(
        domain="sarcos",
        data_sizes=(8000, 16000, 24000, 32000),
        machines=(4, 8, 12, 16, 20),
        params=(256, 512, 1024, 2048),
        rank_multiplier=2,
        fixed_data=32000, fixed_machines=20, fixed_param=2048,
        input_dim=21),
}


def scaled_grid(domain: str, factor: int = 8) -> GPExperiment:
    """CPU-container scale-down preserving sweep ratios (factor 8:
    |D| 1000-4000, P 32-256, M 4-16)."""
    g = PAPER_GRID[domain]
    return dataclasses.replace(
        g,
        data_sizes=tuple(max(n // factor, 512) for n in g.data_sizes),
        machines=tuple(m for m in g.machines if m <= 16),
        params=tuple(max(p // factor, 32) for p in g.params),
        fixed_data=max(g.fixed_data // factor, 2048),
        fixed_machines=8,
        fixed_param=max(g.fixed_param // factor, 128),
        mle_subset=max(g.mle_subset // factor, 512))
