#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
card. Run from the root of a checkout, with one card visible:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the last line:

1. card: name and power limit (nvidia-smi);
2. build: both CUDA kernels from the checkout's sources (nvcc, sm_90a,
   one compiler per source, started together) into build/kernels/;
3. kernel vs plain: each kernel against its plain PyTorch version on the
   card, at the fit and serving shapes, within the tolerances stated below,
   and each timed at the main path's shapes;
4. main path: pPITC at the paper's AIMPEAK configuration (|D| = 32000,
   M = 20, |S| = 2048, d = 5, float32): support selection, fit, plan,
   warm-up, 8 requests through ``plan.diag``; the kernels' launch counts
   are zeroed just before and read just after; outputs must be finite and
   the fused diag must agree with the compose path;
5. one JSON line listing each kernel's launches, error, times and bound.

The last line is ``{"ok": true, "device": {"platform": "gpu", ...}}``.
Imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Published peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

# Kernel-vs-plain tolerances (max abs error):
#  rbf f32 1e-5 and bf16 3e-2 are the reference's own (tests/test_kernels.py).
#  xcov_diag f64 1e-10 is the reference's fused-vs-compose gate.
#  xcov_diag f32 at s = 2048 is 1e-4, not the reference's 1e-5 (which it set
#  at s <= 130): the kernel multiplies by an explicit triangular inverse where
#  the plain version solves, and both sum 2048 products per entry in
#  different orders, so the float32 rounding differences grow with s.
TOL_RBF = {"float32": 1e-5, "bfloat16": 3e-2}
TOL_XCOV_F64 = 1e-10
TOL_XCOV_F32_S2048 = 1e-4

M, N_TRAIN, N_TEST, S_SIZE, D = 20, 32000, 3200, 2048, 5
REQUEST_SIZES = (1, 7, 64, 200, 256, 256, 1000, 3200)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def max_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def check_rbf(torch, ops, ref, gen):
    """rbf vs plain at the fit shapes; times at K_{S,D_m} over M machines."""
    cases = [("K_SDm", (S_SIZE, D), (M, N_TRAIN // M, D)),
             ("K_DmDm", (M, N_TRAIN // M, D), (M, N_TRAIN // M, D)),
             ("K_SS", (S_SIZE, D), (S_SIZE, D)),
             ("ragged", (33, 7), (17, 7))]
    worst = {}
    for name, sq, sk in cases:
        for dt in (torch.float32, torch.bfloat16):
            Xq = (torch.rand(sq, generator=gen, device="cuda") * 4 - 2) / 1.2
            Xk = (torch.rand(sk, generator=gen, device="cuda") * 4 - 2) / 1.2
            Xq, Xk = Xq.to(dt), Xk.to(dt)
            got = ops.rbf_covariance(Xq, Xk, 1.3)
            want = ref.rbf_covariance(Xq, Xk, 1.3)
            torch.cuda.synchronize()
            key = str(dt).split(".")[1]
            err = max_err(got, want)
            print(f"  rbf {name} {tuple(sq)}x{tuple(sk)} {key}: "
                  f"max|err| {err:.3e} (tol {TOL_RBF[key]})", flush=True)
            if not err <= TOL_RBF[key]:
                fail(f"rbf {name} {key} error {err} > {TOL_RBF[key]}")
            if name == "K_SDm" and key == "float32":
                worst["err"] = err
    # timing at the main path's largest launch: K_{S,D_m} for all machines
    S = (torch.rand((S_SIZE, D), generator=gen, device="cuda") * 4 - 2) / 1.2
    Xb = (torch.rand((M, N_TRAIN // M, D), generator=gen, device="cuda")
          * 4 - 2) / 1.2
    ms = time_ms(lambda: ops.rbf_covariance(S, Xb, 1.3), 20)
    plain = time_ms(lambda: ref.rbf_covariance(S, Xb, 1.3), 5)
    n_out = M * S_SIZE * (N_TRAIN // M)
    b_ms, b_by = bound_ms((S.numel() + Xb.numel()) * 4 + n_out * 4,
                          n_out * (2 * D + 6))
    return dict(name="rbf", route="cuda",
                source="src/repro_torch/kernels/rbf/csrc/rbf.cu",
                replaces="src/repro/kernels/rbf/rbf.py:55",
                max_abs_err=worst["err"], tol=TOL_RBF["float32"], ms=ms,
                plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                library_ms=None,
                shape=f"K_SDm: ({S_SIZE},{D}) x ({M},{N_TRAIN // M},{D}) "
                      f"f32")


def _factors(torch, s, gen, dtype):
    """The well-conditioned factors of the reference's fused-kernel tests."""
    A1 = torch.randn((s, s), generator=gen, device="cuda", dtype=torch.float64)
    A2 = torch.randn((s, s), generator=gen, device="cuda", dtype=torch.float64)
    eye = torch.eye(s, dtype=torch.float64, device="cuda")
    L1 = torch.linalg.cholesky(A1 @ A1.T + s * eye)
    L2 = torch.linalg.cholesky(A2 @ A2.T + 2 * s * eye)
    alpha = torch.randn((s,), generator=gen, device="cuda",
                        dtype=torch.float64)
    return L1.to(dtype), L2.to(dtype), alpha.to(dtype)


def check_xcov(torch, ops, ref, gen):
    """xcov_diag vs plain, f64 small and f32 at |S| = 2048; timed at the
    main path's serving bucket (256 queries, |S| = 2048, with L2)."""
    worst_f32 = 0.0
    for dtype, cases in ((torch.float64, [(s, n, d) for s, d in
                                          ((12, 3), (130, 21))
                                          for n in (1, 16, 33, 256)]),
                         (torch.float32, [(S_SIZE, n, D)
                                          for n in (8, 256, 1024)])):
        for s, n, d in cases:
            Xq = torch.randn((n, d), generator=gen, device="cuda",
                             dtype=torch.float64).to(dtype)
            Xk = torch.randn((s, d), generator=gen, device="cuda",
                             dtype=torch.float64).to(dtype)
            L1, L2, alpha = _factors(torch, s, gen, dtype)
            tol = TOL_XCOV_F64 if dtype == torch.float64 else \
                TOL_XCOV_F32_S2048
            for L2_ in (L2, None):
                m_k, v_k = ops.xcov_diag(Xq, Xk, L1, alpha, 1.3, L2_)
                m_r, v_r = ref.xcov_diag(Xq, Xk, L1, alpha, 1.3, L2_)
                torch.cuda.synchronize()
                err = max(max_err(m_k, m_r), max_err(v_k, v_r))
                tag = "L1+L2" if L2_ is not None else "L1"
                print(f"  xcov_diag s={s} n={n} d={d} {str(dtype)[6:]} "
                      f"{tag}: max|err| {err:.3e} (tol {tol})", flush=True)
                if not err <= tol:
                    fail(f"xcov_diag s={s} n={n} {dtype} {tag} error {err} "
                         f"> {tol}")
                if dtype == torch.float32:
                    worst_f32 = max(worst_f32, err)
    # timing at the main path's serving shape, on the fit's kind of inputs
    n, s = 256, S_SIZE
    Xq = (torch.rand((n, D), generator=gen, device="cuda") * 4 - 2) / 1.2
    Xk = (torch.rand((s, D), generator=gen, device="cuda") * 4 - 2) / 1.2
    L1, L2, alpha = _factors(torch, s, gen, torch.float32)
    L1inv = ops._embed_tri_inv(L1, s)
    L2inv = ops._embed_tri_inv(L2, s)
    ms = time_ms(lambda: ops.xcov_diag_inv(Xq, Xk, L1inv, alpha, 1.3, L2inv),
                 50)
    plain = time_ms(lambda: ref.xcov_diag(Xq, Xk, L1, alpha, 1.3, L2), 10)
    embed = time_ms(lambda: (ops._embed_tri_inv(L1, s),
                             ops._embed_tri_inv(L2, s)), 10)
    b_ms, b_by = bound_ms(2 * s * s * 4 + (n + s) * D * 4 + s * 4 + 2 * n * 4,
                          2 * n * s * s)
    return dict(name="xcov_diag", route="cuda",
                source="src/repro_torch/kernels/rbf/csrc/xcov_diag.cu",
                replaces="src/repro/kernels/rbf/xcov.py:103",
                max_abs_err=worst_f32, tol=TOL_XCOV_F32_S2048, ms=ms,
                plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                library_ms=None, embed_tri_inv_ms=embed,
                shape=f"n={n}, |S|={s}, d={D}, with L2, f32")


def main_path(torch, card: str):
    """Fit pPITC at the paper's AIMPEAK configuration and serve through the
    plan API; returns the kernels' launch counts during the run."""
    from repro_torch.core import api, covariance as cov, support
    from repro_torch.data import synthetic
    from repro_torch.kernels.rbf import ops
    from repro_torch.parallel.runner import VmapRunner

    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    t0 = time.perf_counter()
    ds = synthetic.standardize(
        synthetic.aimpeak_like(n=N_TRAIN, n_test=N_TEST, seed=0))
    spec = cov.make_spec("se")
    params = cov.init_params(D, signal=1.0, noise=0.3, lengthscale=1.2)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    S = support.select_support(spec, params, ds.X[:8192], S_SIZE)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    model = api.fit("ppitc", spec, params, ds.X, ds.y, S=S,
                    runner=VmapRunner(M=M))
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    plan = model.plan(api.ServeSpec(max_batch=256)).warmup(D)
    t4 = time.perf_counter()
    outs, lat_ms, off = [], [], 0
    for size in REQUEST_SIZES:
        idx = torch.arange(off, off + size, device="cuda") % N_TEST
        U = ds.X_test.index_select(0, idx)
        torch.cuda.synchronize()
        ts = time.perf_counter()
        mean, var = plan.diag(U)
        torch.cuda.synchronize()
        lat_ms.append((time.perf_counter() - ts) * 1e3)
        outs.append((idx, mean, var))
        off = (off + size) % N_TEST
    launches = {"rbf": ops.rbf_launches, "xcov_diag": ops.xcov_launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    print(f"  counts during the main path: {launches}", flush=True)
    for name, n in launches.items():
        if n <= 0:
            fail(f"kernel {name} was not launched on the main path")
    for idx, mean, var in outs:
        if mean.shape != idx.shape or var.shape != idx.shape:
            fail(f"plan.diag shapes {tuple(mean.shape)}/{tuple(var.shape)} "
                 f"for {idx.numel()} queries")
        if not (torch.isfinite(mean).all() and torch.isfinite(var).all()):
            fail(f"non-finite plan.diag output at batch {idx.numel()}")
    idx_all, mean_all, var_all = outs[-1]     # the 3200-row request
    y_all = ds.y_test.index_select(0, idx_all)
    rmse = float(torch.sqrt(torch.mean((mean_all - y_all) ** 2)))
    neg = float((var_all < 0).double().mean())

    # fused (kernel) vs compose (plain solves) on the same state, with a
    # float64 evaluation of the same state as the yardstick
    U = ds.X_test[:1024]
    compose = model.plan(api.ServeSpec(kernel=cov.make_spec("se",
                                                            fused=False)))
    m_f, v_f = plan.diag(U)
    m_c, v_c = compose.diag(U)
    p64 = {k: v.double() for k, v in model.params.items()}
    st64 = api.PITCState(*(t.double() for t in model.state))
    truth = model.method.plan(cov.make_spec("se", impl="torch"), p64, st64)
    m_t, v_t = truth.diag(U.double())
    torch.cuda.synchronize()
    d_mean, d_var = max_err(m_f, m_c), max_err(v_f, v_c)
    e_f = max(max_err(m_f, m_t), max_err(v_f, v_t))
    e_c = max(max_err(m_c, m_t), max_err(v_c, v_t))
    # Both paths evaluate the same state in float32: they cannot agree more
    # closely than the compose path's own error against float64, and a
    # kernel defect (a panel, mask or term wrong) errs by O(sig2) = O(1).
    agree_tol = 10 * e_c + 1e-4
    print(f"  fused vs compose (1024 queries): max|dmean| {d_mean:.3e}, "
          f"max|dvar| {d_var:.3e} (tol {agree_tol:.3e} = 10 x compose's "
          f"error vs f64 + 1e-4); vs f64: fused {e_f:.3e}, compose "
          f"{e_c:.3e}", flush=True)
    if not max(d_mean, d_var) <= agree_tol:
        fail(f"fused plan.diag disagrees with the compose path: "
             f"{max(d_mean, d_var)} > {agree_tol}")

    # why the fit factors Sdd from its square root (online._sdd_chol): its
    # conditioning, and the reference's way (form Sdd, then Cholesky) in f32
    L = model.state.Sdd_L
    ev = torch.linalg.eigvalsh(L.double() @ L.double().T)
    info = int(torch.linalg.cholesky_ex(L @ L.T)[1])
    verdict = f"fails (info {info})" if info else "succeeds"
    print(f"  Sdd + jitter (float64, from the fitted factor): eigenvalues "
          f"{float(ev.min()):.3e} .. {float(ev.max()):.3e}, cond "
          f"{float(ev.max() / ev.min()):.3e}; formed in float32, its "
          f"Cholesky {verdict}", flush=True)

    p50 = sorted(lat_ms)[len(lat_ms) // 2]
    print(f"  [{card}] data {t1 - t0:.3f} s, select_support {t2 - t1:.3f} "
          f"s, fit {t3 - t2:.3f} s, plan+warmup {t4 - t3:.3f} s, peak "
          f"{peak_gb:.2f} GB", flush=True)
    print(f"  [{card}] requests {list(REQUEST_SIZES)}: latency ms "
          f"{[round(x, 3) for x in lat_ms]}, p50 {p50:.3f} ms", flush=True)
    print(f"  [{card}] test RMSE {rmse:.4f} (standardized; "
          f"{rmse * float(ds.std_y):.3f} km/h), negative-variance share "
          f"{neg:.4f} of {N_TEST}", flush=True)
    return launches


def main() -> int:
    try:
        import torch
    except ImportError:
        print("FAIL: PyTorch is not installed", flush=True)
        return 2
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False; this smoke run "
              "needs one CUDA card", flush=True)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"FAIL: {ROOT} is not a checkout of the repository "
              f"(src/repro_torch is missing)", flush=True)
        return 3
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (turns TF32 off)
    from repro_torch.kernels import build
    from repro_torch.kernels.rbf import ops, ref

    print("phase 1: card", flush=True)
    card = card_line()
    print(card, flush=True)
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}", flush=True)

    print("phase 2: build", flush=True)
    t0 = time.perf_counter()
    built = build.build_all()
    print(f"  built {built or 'nothing (up to date)'} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name in build.sources():
        log = build.target(name).with_suffix(".log")
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  {name}: {line.strip()}", flush=True)

    print("phase 3: kernel vs plain", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = [check_rbf(torch, ops, ref, gen), check_xcov(torch, ops, ref, gen)]

    print("phase 4: main path", flush=True)
    launches = main_path(torch, card)
    for row in rows:
        row["launches"] = launches[row["name"]]

    print("phase 5: kernels", flush=True)
    for row in rows:
        if not all(math.isfinite(row[k]) for k in ("ms", "plain_ms",
                                                   "bound_ms")):
            fail(f"non-finite timing for {row['name']}")
    print(card, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
