"""Where the LM serving path spends its time on the card: a
``torch.profiler`` trace of one prefill and of a few decode steps.

    PYTHONPATH=src python -m repro_torch.launch.profile --model qwen3-1.7b

For each window it prints the wall time, the device's busy share (the union
of the kernels' intervals over the window) and the kernels that took the
most device time, grouped by name; then the window's model FLOP
(``roofline.analysis.model_flops``) over its wall time, against the card's
bf16 peak (``roofline.hw``). Random weights from ``init_model``
(seed 0) at the configuration's full width and depth; bfloat16 compute;
the prefill and prompt shapes of ``chip_smoke.py``'s LM phases. Needs a
CUDA card and fails without one.
"""
from __future__ import annotations

import argparse
import time
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs.registry import get_config
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.data import synthetic
from repro_torch.models import transformer as tf
from repro_torch.roofline import analysis, hw

# chip_smoke.py's LM shapes: prefill batch x length, prompt length; then a
# few decode steps, and the kernel names printed per window
BATCH, SEQ, PROMPT = 4, 4096, 32
DECODE_STEPS, TOP = 8, 12


def kernels(prof):
    """(name, start_us, end_us) of every device kernel in the trace."""
    out = []
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            out.append((e.name, e.time_range.start, e.time_range.end))
    return out


def busy_us(intervals) -> float:
    total, end = 0.0, float("-inf")
    for s, e in sorted((s, e) for _, s, e in intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def report(label: str, fn, model_flops: float | None = None) -> dict:
    """Profile ``fn`` once (after one untraced warm-up) and print its
    breakdown, and ``model_flops``, where given, over its wall time.
    Returns the trace's wall and busy ms, its kernel count and its kernels
    by name ({name: (count, us)})."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    ks = kernels(prof)
    if not ks:
        raise RuntimeError("the profiler recorded no device kernels; time "
                           "with CUDA events instead")
    by_name = defaultdict(lambda: [0, 0.0])
    for name, s, e in ks:
        by_name[name][0] += 1
        by_name[name][1] += e - s
    busy_ms = busy_us(ks) / 1e3
    kernel_ms = sum(v[1] for v in by_name.values()) / 1e3
    print(f"{label}: wall {wall_ms:.3f} ms, {len(ks)} kernels, kernel time "
          f"{kernel_ms:.3f} ms, device busy {busy_ms:.3f} ms "
          f"({100 * busy_ms / wall_ms:.1f}% of the wall time)", flush=True)
    for name, (n, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1]
                                )[:TOP]:
        print(f"  {us / 1e3:9.3f} ms {100 * us / 1e3 / kernel_ms:5.1f}% "
              f"x{n:<5d} {name[:90]}", flush=True)
    out = dict(wall_ms=wall_ms, busy_ms=busy_ms, n_kernels=len(ks),
               by_name={k: tuple(v) for k, v in by_name.items()})
    if model_flops is None:
        return out
    rate = model_flops / wall_ms / 1e9
    print(f"  model FLOP {model_flops / 1e9:.1f} G: {rate:.1f} TFLOP/s over "
          f"the wall time, {100 * rate * 1e12 / hw.PEAK_FLOPS_BF16:.1f}% of "
          f"the bf16 peak", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="qwen3-1.7b")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    cfg = get_config(args.model)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = tf.init_model(cfg, generator=gen)
    toks = synthetic.lm_tokens(gen, batch=BATCH, seq=SEQ - 1,
                               vocab=cfg.vocab)
    print(f"{args.model} on {torch.cuda.get_device_name(0)}, batch {BATCH}",
          flush=True)
    report(f"prefill {BATCH} x {SEQ}",
           lambda: tf.forward(params, toks, cfg, logits_last_only=True),
           analysis.model_flops(cfg, ShapeSpec("prefill", SEQ, BATCH,
                                               "prefill"), last_logits=True))

    max_len = PROMPT + 2 * DECODE_STEPS + 2
    holder = {}

    def fresh():
        state = tf.init_serve(cfg, BATCH, max_len)
        for t in range(PROMPT):
            _, state = tf.decode_step(params, toks[:, t:t + 1], state, cfg)
        holder["state"] = state

    def steps():
        state = holder["state"]
        tok = toks[:, PROMPT:PROMPT + 1]
        for _ in range(DECODE_STEPS):
            _, state = tf.decode_step(params, tok, state, cfg)
        holder["state"] = state

    fresh()
    report(f"{DECODE_STEPS} decode steps after a {PROMPT}-token prompt",
           steps, sum(analysis.model_flops(cfg, ShapeSpec(
               "decode", PROMPT + i, BATCH, "decode"))
               for i in range(DECODE_STEPS)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
