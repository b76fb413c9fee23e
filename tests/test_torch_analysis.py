"""The port's static analysis and contract audit (``repro_torch.analysis``)
on the CPU: its engine against the reference's, each of its rules on a bad
and a good fixture, the port's own tree against its baseline, the CLI's
exit codes, and the contract audit (``run_audit(device="cpu")``, the
``no_retrace`` registry, fingerprints)."""
import ast
import json
import pathlib
import textwrap

import numpy as np
import pytest
import torch

from repro.analysis import engine as jengine
from repro_torch.analysis import contracts, engine
from repro_torch.analysis import rules as R
from repro_torch.analysis.__main__ import main as cli_main
from repro_torch.core import api
from repro_torch.core import covariance as cov
from repro_torch.parallel.runner import VmapRunner

ROOT = pathlib.Path(__file__).resolve().parent.parent


def run_rule(src, rule, path="src/repro_torch/core/fixture.py"):
    """All unsuppressed findings of one rule over a source snippet."""
    src = textwrap.dedent(src)
    mod = engine.ModuleInfo(path=path, source=src, tree=ast.parse(src))
    return [f for f in rule.check(mod)
            if not engine.is_suppressed(f, mod.lines)]


# ---------------------------------------------------------------------------
# engine: the reference's behaviour
# ---------------------------------------------------------------------------

LINES = ["def f(x):",
         "    return x.item()  # analysis: ignore[SYN001]",
         "    # analysis: ignore",
         "    y = x.cpu()",
         "    z = x.numpy()  # analysis: ignore[DTY001]"]


def _findings(mod):
    return [mod.Finding(rule, "src/m.py", line, 4, "msg", LINES[line - 1])
            for rule, line in (("SYN001", 2), ("SYN001", 4), ("SYN001", 5),
                               ("DTY001", 5))]


def test_engine_reports_as_the_references():
    ours, theirs = _findings(engine), _findings(jengine)
    assert engine.to_text(ours) == jengine.to_text(theirs)
    assert engine.to_json(ours) == jengine.to_json(theirs)
    assert engine.to_text([]) == jengine.to_text([])
    assert [engine.is_suppressed(f, LINES) for f in ours] == \
        [jengine.is_suppressed(f, LINES) for f in theirs] == \
        [True, True, False, True]
    assert [f.fingerprint for f in ours] == [f.fingerprint for f in theirs]


def test_baseline_behaves_as_the_references(tmp_path):
    ours, theirs = _findings(engine), _findings(jengine)
    engine.write_baseline(tmp_path / "a.json", ours[:2])
    jengine.write_baseline(tmp_path / "b.json", theirs[:2])
    a, b = (json.loads((tmp_path / n).read_text())["findings"]
            for n in ("a.json", "b.json"))
    assert a == b
    assert engine.load_baseline(tmp_path / "b.json") == \
        jengine.load_baseline(tmp_path / "a.json")
    base = engine.load_baseline(tmp_path / "a.json")
    assert engine.new_findings(ours, base) == ours[2:]
    assert engine.load_baseline(tmp_path / "missing.json") == set()


# ---------------------------------------------------------------------------
# rules
# ---------------------------------------------------------------------------

SYN_BAD = """
class Plan:
    def routed_diag(self, U):
        assign = self._route(U.cpu().numpy())
        n = int(U.sum())
        return U.tolist(), float(U[0]), assign, n

def predict_batch_diag(kfn, params, state, U):
    return U.item()

api.register(api.GPMethod("x", fit, predict_diag_fn=predict_batch_diag))
"""
SYN_GOOD = """
class Plan:
    def diag(self, U):
        n = int(U.shape[0])
        b = int(len(U)) + int(U.numel()) + int(8)
        return U[:n], b

def helper(U):
    return U.cpu()          # not a serving callable
"""


def test_syn001_flags_host_syncs_in_serving_callables():
    found = run_rule(SYN_BAD, R.SYN001())
    assert len(found) == 6
    assert run_rule(SYN_GOOD, R.SYN001()) == []
    suppressed = SYN_BAD.replace(
        "        assign = self._route",
        "        # analysis: ignore[SYN001]\n        assign = self._route")
    assert len(run_rule(suppressed, R.SYN001())) == 4
    assert run_rule(SYN_BAD, R.SYN001(), path="src/repro/core/x.py") == []


def test_dty001_flags_forced_float64_on_the_serving_path():
    bad = """
    def stage(U, L):
        a = U.double()
        b = torch.zeros(3, dtype=torch.float64)
        c = L.to(torch.float64)
        return torch.promote_types(L.dtype, torch.float64), a, b, c
    """
    assert len(run_rule(bad, R.DTY001())) == 4
    good = """
    def stage(Xq, L):
        acc = torch.float64 if Xq.dtype == torch.float64 else torch.float32
        ok = L.dtype in (torch.float32, torch.float64)
        return Xq.to(acc), L.to(Xq.dtype), ok
    """
    assert run_rule(good, R.DTY001()) == []
    assert run_rule(bad, R.DTY001(),
                    path="src/repro_torch/launch/train.py") == []


def test_det001_flags_unseeded_rng_and_clocks_in_replay_modules():
    path = "src/repro_torch/serving/chaos.py"
    bad = """
    def schedule(self):
        t = time.time()
        rng = np.random.RandomState()
        x = torch.randn(3)
        i = torch.randint(0, 5, (2,))
        return t, rng, x, i, random.random()
    """
    assert len(run_rule(bad, R.DET001(), path=path)) == 5
    good = """
    def __init__(self, plan, sleep=time.sleep):
        self._rng = np.random.RandomState(plan.seed)
        self._gen = torch.Generator().manual_seed(plan.seed)
        self._x = torch.randn(3, generator=self._gen)
    """
    assert run_rule(good, R.DET001(), path=path) == []
    assert run_rule(bad, R.DET001(),
                    path="src/repro_torch/core/gp.py") == []


def test_frz001_flags_frozen_mutation():
    bad = """
    @dataclasses.dataclass(frozen=True)
    class Plan:
        n: int
        def bump(self):
            self.n = self.n + 1

    def tweak(spec: ServeSpec):
        spec.max_batch = 32
    """
    assert len(run_rule(bad, R.FRZ001())) == 2
    good = """
    @dataclasses.dataclass(frozen=True)
    class Plan:
        n: int
        def __post_init__(self):
            object.__setattr__(self, "n", int(self.n))

    def tweak(spec: ServeSpec):
        return dataclasses.replace(spec, max_batch=32)
    """
    assert run_rule(good, R.FRZ001()) == []


def test_the_ports_tree_is_clean_against_its_baseline():
    findings = engine.run_rules([ROOT / "src" / "repro_torch"],
                                R.default_rules(), root=ROOT)
    base = engine.load_baseline(ROOT / "analysis_baseline_torch.json")
    assert engine.new_findings(findings, base) == []
    assert findings == [] and base == set()


def test_cli_exit_codes(tmp_path, monkeypatch, capsys):
    serving = tmp_path / "src" / "repro_torch" / "serving"
    serving.mkdir(parents=True)
    bad = serving / "chaos.py"
    bad.write_text("def f():\n    return time.time()\n")
    monkeypatch.chdir(tmp_path)
    assert cli_main([]) == 1                              # a finding
    assert cli_main(["--write-baseline"]) == 0            # burned in
    assert cli_main(["--baseline"]) == 0                  # now known
    bad.write_text("def f():\n    return time.monotonic()\n")
    assert cli_main(["--baseline"]) == 1                  # edited
    assert cli_main(["nonexistent-dir"]) == 2
    bad.write_text("def f(clock):\n    return clock()\n")
    assert cli_main([]) == 0
    assert "clean" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# contracts
# ---------------------------------------------------------------------------

@pytest.fixture
def clean_registry():
    contracts.reset_registry()
    yield
    contracts.reset_registry()


def test_run_audit_on_the_cpu_is_ok(clean_registry):
    report = contracts.run_audit(device="cpu")
    assert report["ok"], {k: v for k, v in report.items()
                          if k not in ("generations", "fingerprints")}
    assert report["n_rebind_generations"] == 3
    assert report["rebind_new_traces"] == 0
    assert report["n_audited"] >= 2 and report["n_lineages"] == 1
    assert report["no_retrace"]["ppic.cinv_blocks"]["n_signatures"] == 1
    assert len(set(map(json.dumps, report["generations"]))) == 1


def test_a_new_signature_after_freeze_is_a_violation(clean_registry):
    @contracts.no_retrace("test.double")
    def double(x, k=2):
        return x * k

    double(torch.zeros(2))
    contracts.freeze()
    double(torch.ones(2))                        # same signature
    assert contracts.violations() == {}
    double(torch.zeros(3))                       # a new shape
    double(torch.zeros(2, dtype=torch.float64))  # a new dtype
    assert contracts.violations() == {"test.double": 2}
    assert contracts.registry_report()["test.double"]["n_calls"] == 4


def _plan(s: int):
    rng = np.random.RandomState(0)
    X = torch.as_tensor(rng.standard_normal((32, 2)), dtype=torch.float64)
    y = torch.sin(X[:, 0])
    params = cov.init_params(2, dtype=torch.float64, device="cpu")
    model = api.fit("ppitc", cov.make_kernel("se"), params, X, y, S=X[:s],
                    runner=VmapRunner(M=4), device="cpu")
    return model.plan(api.ServeSpec(max_batch=8))


def test_a_rebind_to_another_shape_changes_the_fingerprint():
    U = np.random.RandomState(1).standard_normal((5, 2))
    drive = lambda p: p.diag(U)
    plan = _plan(8)
    base = contracts.audit_plan(plan, drive)["fingerprints"]
    same = contracts.audit_plan(
        plan.rebind(contracts._perturbed(plan.state, 1e-3)), drive)
    assert same["fingerprints"] == base
    other = _plan(6).state
    grown = contracts.audit_plan(plan.rebind(other), drive)["fingerprints"]
    assert grown.keys() == base.keys() and grown != base
    f = lambda t: (t * 2).sum()
    assert contracts.fingerprint(f, (torch.zeros(3),)) == \
        contracts.fingerprint(f, (torch.ones(3),)) != \
        contracts.fingerprint(f, (torch.zeros(4),))
