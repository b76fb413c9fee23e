"""Static analysis and the contract audit of the port's serving stack —
counterpart of ``repro.analysis``.

The runtime guarantees the port leans on — no serving callable built
after warm-up across rebinds and tenants, no host sync inside a serving
call, a single serving dtype, seeded determinism — are enforced
dynamically by the test suites; this package is the static half and the
structural audit:

* :mod:`repro_torch.analysis.engine` — the dependency-free AST lint engine
  (per-rule visitors, ``# analysis: ignore[RULE]`` suppressions, text/JSON
  reporters, a checked-in baseline file), the port's own copy;
* :mod:`repro_torch.analysis.rules` — the port's rules (SYN001, DTY001,
  DET001, FRZ001);
* :mod:`repro_torch.analysis.contracts` — the contract auditor: a
  fingerprint of the aten ops (and kernel launches) each serving callable
  dispatches, a ``@no_retrace`` registry, and rebind/tenant interleaving
  audits that prove the no-new-callable claim structurally;
* ``python -m repro_torch.analysis`` — the CLI that lints
  ``src/repro_torch`` against ``analysis_baseline_torch.json`` (and, with
  ``--contracts``, runs the auditor) and exits nonzero on new findings.

``engine`` and ``rules`` are stdlib-only: the lint runs without torch.
``contracts`` imports torch lazily.
"""
from repro_torch.analysis.engine import (  # noqa: F401
    Finding,
    ModuleInfo,
    load_baseline,
    run_rules,
    to_json,
    to_text,
    write_baseline,
)
