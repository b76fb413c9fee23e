"""Where a routed pPIC request's time goes on the card, at the paper's
AIMPEAK configuration (|D| = 32000, M = 20, |S| = 2048, d = 5, float32):

    PYTHONPATH=src python -m repro_torch.launch.routed_profile --repeat 3

It builds the data, the support set and the co-clustered pPIC fit as
``chip_smoke.py``'s phases 4 and 4b do (seed 0), warms a routed plan
(``ServeSpec(routed=True, max_batch=256)``), serves the request ladder
{1, 7, 64, 200, 256, 256, 1000, 3200} ``--repeat`` times (host clock
around synchronized requests) and prints each pass's latencies, their p50
and the 3200-row request's time, and the test RMSE of the last 3200-row
request; then it traces one 256-row request and one 3200-row request (its
main bucket 20 blocks of 336 rows, 6720 rows through the six row-product
stages) through ``launch.profile.report``: wall, kernels, the device's busy
share, the kernels by device time, and ``rows_mm``'s device time. It uses
the package's public entry points only, so it also runs against an
earlier checkout (from that checkout's root:
``PYTHONPATH=src python3 -c "import runpy, sys; sys.argv = ['rp'];
runpy.run_path('<this file>', run_name='__main__')"``). Needs a CUDA card
and fails without one.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core import api, clustering, covariance as cov, support
from repro_torch.data import synthetic
from repro_torch.launch.profile import report
from repro_torch.parallel.runner import VmapRunner

M, N_TRAIN, N_TEST, S_SIZE, D = 20, 32000, 3200, 2048, 5
ICF_CANDIDATES = 8192
REQUEST_SIZES = (1, 7, 64, 200, 256, 256, 1000, 3200)


def fitted_plan():
    """The co-clustered pPIC fit's warmed routed plan, and the test data."""
    ds = synthetic.standardize(
        synthetic.aimpeak_like(n=N_TRAIN, n_test=N_TEST, seed=0))
    spec = cov.make_spec("se")
    params = cov.init_params(D, signal=1.0, noise=0.3, lengthscale=1.2)
    S = support.select_support(spec, params, ds.X[:ICF_CANDIDATES], S_SIZE)
    Xc, yc, _, _, _ = clustering.cocluster(
        ds.X.cpu().numpy(), ds.y.cpu().numpy(), ds.X_test.cpu().numpy(), M,
        np.random.default_rng(0))
    dev = ds.X.device
    model = api.fit("ppic", spec, params, torch.as_tensor(Xc).to(dev),
                    torch.as_tensor(yc).to(dev), S=S, runner=VmapRunner(M=M))
    plan = model.plan(api.ServeSpec(routed=True, max_batch=256)).warmup(D)
    torch.cuda.synchronize()
    return plan, ds


def ladder(plan, ds) -> tuple[list, float]:
    """One pass over REQUEST_SIZES: each request's ms, and the test RMSE of
    the 3200-row request."""
    lat, off = [], 0
    for size in REQUEST_SIZES:
        idx = torch.arange(off, off + size, device=ds.X.device) % N_TEST
        U = ds.X_test.index_select(0, idx)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mean, _ = plan.routed_diag(U)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
        off = (off + size) % N_TEST
    y = ds.y_test.index_select(0, idx)
    return lat, float(torch.sqrt(torch.mean((mean - y) ** 2)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeat", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    plan, ds = fitted_plan()
    print(f"routed pPIC at AIMPEAK on {torch.cuda.get_device_name(0)}; "
          f"requests {list(REQUEST_SIZES)}", flush=True)
    for r in range(args.repeat):
        lat, rmse = ladder(plan, ds)
        print(f"  pass {r}: latency ms {[round(x, 3) for x in lat]}, p50 "
              f"{sorted(lat)[len(lat) // 2]:.3f} ms, 3200-row request "
              f"{lat[-1]:.3f} ms; test RMSE {rmse:.4f}", flush=True)
    for size in (256, N_TEST):
        U = ds.X_test[:size]
        out = report(f"  one {size}-row request traced",
                     lambda U=U: plan.routed_diag(U))
        mm = [v for k, v in out["by_name"].items() if "rows_mm" in k]
        print(f"  {size}-row request: rows_mm {sum(n for n, _ in mm)} "
              f"launches, {sum(us for _, us in mm) / 1e3:.4f} ms device",
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
