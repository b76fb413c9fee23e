"""Where an LM training step spends its time on the card: one
``torch.profiler`` trace of a step through ``launch.train`` (remat on, bf16
compute), after a warm-up step.

    PYTHONPATH=src python -m repro_torch.launch.train_profile \\
        --model qwen3-1.7b --batch 4 --microbatches 2

It prints the step's wall time, the device's busy share, the kernel time of
the backward kernels (every kernel whose name holds ``bwd``: flash
attention's and the SSD block's) and their share of all kernel time, and
the kernels that took the most time; then the backward kernels' bound at
the step's shapes (``roofline.kernels``: each layer's, times the
microbatches) and the step's model FLOP (``roofline.analysis``) over its
wall time. Random weights and Adam (seed 0) at
the configuration's full width and depth, sequences of 4096 tokens from
``TokenLoader``: ``chip_smoke.py``'s phase 8. Needs a CUDA card and fails
without one. It uses only the entry points a user calls, so it also traces
an earlier tree's step: run it with that tree's ``src`` first on the path
(``runpy.run_path`` of this file leaves the path as it is); the tree must
hold ``repro_torch.roofline``.
"""
from __future__ import annotations

import argparse
import time
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs.shapes import ShapeSpec
from repro_torch.launch.profile import busy_us, kernels
from repro_torch.roofline import analysis, hw
from repro_torch.roofline import kernels as rk

SEQ, LR, TOP = 4096, 1e-5, 10


def backward_bound_ms(cfg, batch: int, microbatches: int) -> float:
    """The least time the step's backward kernels could take: each
    attention layer's flash backward (bf16, causal) and each SSD layer's
    intra-chunk backward (3xTF32) at a microbatch's shape, times the
    microbatches."""
    b, total = batch // microbatches, 0.0
    for desc in cfg.plan():
        if desc.kind == "attn":
            ms, _ = rk.bound_ms(
                rk.flash_bwd_bytes(b, cfg.n_heads, cfg.n_kv_heads, SEQ,
                                   cfg.head_dim),
                rk.flash_bwd_flops(b, cfg.n_heads, SEQ, cfg.head_dim),
                hw.PEAK_FLOPS_BF16)
        else:
            cs = cfg.ssm_chunk
            shape = (b * SEQ // cs, cs,
                     cfg.ssm_expand * cfg.d_model // cfg.ssm_headdim,
                     cfg.ssm_headdim, cfg.ssm_state)
            ms, _ = rk.bound_ms(rk.ssd_bwd_bytes(*shape),
                                3 * rk.ssd_bwd_flops(*shape),
                                hw.PEAK_FLOPS_TF32)
        total += ms * microbatches
    return total


def trace_step(step, state, batch):
    """Run ``state, _ = step(state, batch)`` once under the profiler.
    Returns (the new state, a dict of the step's wall, busy and kernel
    milliseconds, the backward kernels' milliseconds and share, and the
    per-name totals)."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = step(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans = kernels(prof)
    if not spans:
        raise RuntimeError("the profiler recorded no device kernels; time "
                           "with CUDA events instead")
    by_name = defaultdict(lambda: [0, 0.0])
    for name, s, e in spans:
        by_name[name][0] += 1
        by_name[name][1] += (e - s) / 1e3
    kernel_ms = sum(v[1] for v in by_name.values())
    bwd = {n: v for n, v in by_name.items() if "bwd" in n}
    bwd_ms = sum(v[1] for v in bwd.values())
    return state, dict(
        wall_ms=wall_ms, busy_ms=busy_us(spans) / 1e3, kernel_ms=kernel_ms,
        kernels=len(spans), bwd_ms=bwd_ms, bwd_share=bwd_ms / kernel_ms,
        bwd_kernels={n: (c, ms) for n, (c, ms) in bwd.items()},
        top=sorted(((ms, c, n) for n, (c, ms) in by_name.items()),
                   reverse=True)[:TOP])


def report(label: str, r: dict) -> None:
    print(f"{label}: wall {r['wall_ms']:.3f} ms, {r['kernels']} kernels, "
          f"kernel time {r['kernel_ms']:.3f} ms, device busy "
          f"{r['busy_ms']:.3f} ms ({100 * r['busy_ms'] / r['wall_ms']:.1f}% "
          f"of the wall time); backward kernels {r['bwd_ms']:.3f} ms, "
          f"{100 * r['bwd_share']:.1f}% of the kernel time", flush=True)
    for n, (c, ms) in sorted(r["bwd_kernels"].items()):
        print(f"  backward {ms:9.3f} ms x{c:<4d} {n[:80]}", flush=True)
    for ms, c, n in r["top"]:
        print(f"  {ms:9.3f} ms {100 * ms / r['kernel_ms']:5.1f}% x{c:<5d} "
              f"{n[:80]}", flush=True)


def main(argv=None) -> int:
    from repro_torch.configs.registry import get_config
    from repro_torch.data.loader import TokenLoader
    from repro_torch.launch import train
    from repro_torch.optim.adam import Adam

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="qwen3-1.7b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--microbatches", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    cfg = get_config(args.model)
    opt = Adam(lr=LR)
    state = train.init_state(
        cfg, opt, generator=torch.Generator(device="cuda").manual_seed(0))
    step, _ = train.make_train_step(cfg, None, opt,
                                    microbatches=args.microbatches,
                                    remat=True)
    loader = TokenLoader(cfg, batch=args.batch, seq=SEQ, seed=0)
    state, _ = step(state, next(loader))          # warm-up
    _, r = trace_step(step, state, next(loader))
    report(f"{cfg.name} training step, batch {args.batch} x {SEQ} "
           f"({args.microbatches} microbatches), "
           f"{torch.cuda.get_device_name(0)}", r)
    bound = backward_bound_ms(cfg, args.batch, args.microbatches)
    model = analysis.model_flops(cfg, ShapeSpec("train", SEQ, args.batch,
                                                "train"))
    rate = model / r["wall_ms"] / 1e9
    print(f"  backward kernels {r['bwd_ms']:.3f} ms against a bound of "
          f"{bound:.3f} ms ({r['bwd_ms'] / bound:.1f}x); model FLOP "
          f"{model / 1e12:.2f} T, {rate:.1f} TFLOP/s over the wall time, "
          f"{100 * rate * 1e12 / hw.PEAK_FLOPS_BF16:.1f}% of the bf16 peak",
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
