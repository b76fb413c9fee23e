"""Device time of the float32 ``xcov_diag`` kernel for each k-chunk.

    PYTHONPATH=src python -m repro_torch.launch.xcov_sweep

At |S| = 2048, d = 5, with L2 (the GP serving path's shape), from a
``torch.profiler`` trace of 30 calls each: the device time of each of a
call's kernels (panels, chunk sums, reduction) for k-chunks of 128, 256,
512 and whole panels, at n = 8, 64, 256 and 1024, one JSON line each, with
``chosen`` marking the chunk ``ops._tc_chunk`` picks. This is the table
its thresholds are read from. Each line also carries the call's bound
(``roofline.kernels``: 3xTF32 operations or bytes, whichever is larger).

Inputs are random (seed 0) with well-conditioned factors, as in
``chip_smoke.py``'s timing. Needs a CUDA card and fails without one.
"""
from __future__ import annotations

import json

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.kernels import build
from repro_torch.kernels.rbf import ops
from repro_torch.roofline import hw, kernels as rk

S, D, ITERS = 2048, 5, 30
CHUNK_N, CHUNKS = (8, 64, 256, 1024), (128, 256, 512, S)


def device_us(fn) -> dict:
    """Mean device time per call of ``fn``, by kernel (after a warm-up)."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(ITERS):
            fn()
        torch.cuda.synchronize()
    out: dict = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = ("panels" if "xcov_tc_kernel" in e.name else
                "chunk_sums" if "xcov_tc_sum_chunks" in e.name else
                "reduce" if "xcov_reduce" in e.name else e.name[:40])
        out[name] = out.get(name, 0.0) + (e.time_range.end
                                          - e.time_range.start) / ITERS
    if not out:
        raise RuntimeError("the profiler recorded no device kernels")
    out["total"] = sum(out.values())
    return {k: round(v, 2) for k, v in out.items()}


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    build.build_all()
    gen = torch.Generator(device="cuda").manual_seed(0)
    eye = torch.eye(S, dtype=torch.float64, device="cuda")
    inv = []
    for shift in (S, 2 * S):
        A = torch.randn((S, S), generator=gen, device="cuda",
                        dtype=torch.float64)
        L = torch.linalg.cholesky(A @ A.T + shift * eye).float()
        inv.append(ops._embed_tri_inv(L, S).contiguous())
    alpha = torch.randn((S,), generator=gen, device="cuda")
    s2 = torch.tensor(1.3, device="cuda")
    Xk = (torch.rand((S, D), generator=gen, device="cuda") * 4 - 2) / 1.2
    print(f"xcov_diag f32 on {torch.cuda.get_device_name(0)}, |S| = {S}, "
          f"device us per call", flush=True)
    for n in CHUNK_N:
        Xq = (torch.rand((n, D), generator=gen, device="cuda") * 4 - 2) / 1.2
        bound, by = rk.bound_ms(rk.xcov_bytes(n, S, D, True),
                                3 * rk.xcov_flops(n, S), hw.PEAK_FLOPS_TF32)
        for kc in CHUNKS:
            us = device_us(lambda: ops.xcov_diag_inv(
                Xq, Xk, inv[0], alpha, s2, inv[1], kc=kc))
            print(json.dumps(dict(n=n, kc=kc, chosen=kc == ops._tc_chunk(n, S),
                                  us=us, bound_us=round(bound * 1e3, 2),
                                  bound_by=by)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
