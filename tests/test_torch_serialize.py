"""The port's checkpoints (``core/serialize.py``) against the JAX package's,
on the CPU.

Both packages read and write one file format. A state or store written by
either loads in the other with its arrays bitwise equal, and the loaded
posterior serves within 1e-10 of the writer's in float64 (ROADMAP's
runner-and-state tolerance). The port's own round trip is bitwise in
float32 and float64, and the reference's failure cases raise
``CheckpointError`` with the reference's reasons. Inputs are made with
numpy from a seed and fed to both packages.
"""
import dataclasses
import json
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import api as japi, covariance as jcov, serialize as jser
from repro.parallel.runner import VmapRunner as JVmapRunner
from repro.serving.chaos import FaultInjector as JFaultInjector, \
    FaultPlan as JFaultPlan
from repro_torch import convert
from repro_torch.core import api, covariance as cov, serialize as ser
from repro_torch.parallel.runner import VmapRunner
from repro_torch.serving.chaos import FaultInjector, FaultPlan

STATE_TOL = 1e-10
R = 48
STATES = ("FGPState", "PITCState", "PICState", "PICFState")
STORES = ("PITCStore", "PICStore", "PICFStore")
METHOD = {"FGPState": "fgp", "PITCState": "ppitc", "PICState": "ppic",
          "PICFState": "picf", "PITCStore": "ppitc", "PICStore": "ppic",
          "PICFStore": "picf"}


def _t(a):
    return torch.tensor(np.asarray(a))


def _np(a) -> np.ndarray:
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _err(got, want) -> float:
    return float(np.abs(_np(got).astype(np.float64)
                        - _np(want).astype(np.float64)).max())


def _bitwise(a, b) -> bool:
    a, b = _np(a), _np(b)
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


def _make(dtype):
    """tests/helpers.make_problem's shapes (n=96, u=24, |S|=12, d=3, M=4),
    drawn with numpy; a second wave of the same size for streaming."""
    rng = np.random.default_rng(0)
    n, u, s, d, M = 96, 24, 12, 3, 4
    X, S, U, X2 = (rng.normal(size=(k, d)).astype(dtype)
                   for k in (n, s, u, n))
    y = (np.sin(X[:, 0]) * 2.0 + X[:, 1] - 0.5 * X[:, 2] ** 2
         + 0.3 * rng.normal(size=n)).astype(dtype)
    y2 = (np.cos(X2[:, 0]) + 0.3 * rng.normal(size=n)).astype(dtype)
    jparams = jcov.init_params(d, signal=1.3, noise=0.3, lengthscale=1.5,
                               dtype=jnp.dtype(dtype))
    return dict(X=X, y=y, S=S, U=U, X2=X2, y2=y2, M=M, jparams=jparams,
                params=convert.params_from_arrays(jparams, device="cpu"))


@pytest.fixture(scope="module")
def prob():
    return _make(np.float64)


@pytest.fixture(scope="module")
def prob32():
    return _make(np.float32)


def _kw(p, method, port: bool):
    M = p["M"]
    runner = VmapRunner(M=M) if port else JVmapRunner(M=M)
    if method == "fgp":
        return {}
    if method == "picf":
        return dict(rank=R, runner=runner)
    S = _t(p["S"]) if port else jnp.asarray(p["S"])
    return dict(S=S, runner=runner)


def _port_state(p, name, kfn=None):
    m = METHOD[name]
    return api.fit(m, kfn or cov.make_kernel("se"), p["params"], _t(p["X"]),
                   _t(p["y"]), device="cpu", **_kw(p, m, True)).state


def _jax_state(p, name, kfn=None):
    m = METHOD[name]
    return japi.fit(m, kfn or jcov.make_kernel("se"), p["jparams"],
                    jnp.asarray(p["X"]), jnp.asarray(p["y"]),
                    **_kw(p, m, False)).state


def _port_store(p, name, kfn=None, n1=None):
    """A store streamed in two waves with machine 1 retired (an alive mask
    that is not all true), so every array carries history."""
    m = METHOD[name]
    st = api.init_store(m, kfn or cov.make_kernel("se"), p["params"],
                        _t(p["X"]), _t(p["y"]), device="cpu",
                        **_kw(p, m, True))
    return st.assimilate(_t(p["X2"]), _t(p["y2"])).retire(1)


def _jax_store(p, name, kfn=None):
    m = METHOD[name]
    st = japi.init_store(m, kfn or jcov.make_kernel("se"), p["jparams"],
                         jnp.asarray(p["X"]), jnp.asarray(p["y"]),
                         **_kw(p, m, False))
    return st.assimilate(jnp.asarray(p["X2"]), jnp.asarray(p["y2"])
                         ).retire(1)


def _store_leaves(store) -> dict:
    flatten = ser.STORE_TYPES[type(store).__name__][0]
    out = dict(flatten(store))
    out.update({"param:" + k: v for k, v in store.params.items()})
    return out


def _jstore_leaves(store) -> dict:
    flatten = jser.STORE_TYPES[type(store).__name__][0]
    out = dict(flatten(store))
    out.update({"param:" + k: v for k, v in store.params.items()})
    return out


def _port_diag(name, kfn, params, state, U):
    plan = api.get(METHOD[name]).plan(kfn, params, state)
    return plan.diag(_t(U))


def _jax_diag(name, kfn, params, state, U):
    plan = japi.get(METHOD[name]).plan(kfn, params, state)
    return plan.diag(jnp.asarray(U))


# ---------------------------------------------------------------------------
# The port's own round trip: bitwise, float32 and float64
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name", STATES)
def test_state_roundtrip_bitwise(prob, prob32, tmp_path, name, dtype):
    p = prob if dtype == np.float64 else prob32
    state = _port_state(p, name)
    path = ser.save_state(tmp_path / f"{name}.npz", state)
    assert path == tmp_path / f"{name}.npz"
    back = ser.load_state(path, device="cpu")
    assert type(back) is type(state)
    for f, a, b in zip(state._fields, state, back):
        assert a.dtype == b.dtype and torch.equal(a, b), f
    meta = ser.peek(path)
    assert meta["state"] == name and meta["schema"] == ser.SCHEMA_VERSION
    assert set(meta["fields"]) == set(state._fields)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name", STORES)
def test_store_roundtrip_bitwise(prob, prob32, tmp_path, name, dtype):
    p = prob if dtype == np.float64 else prob32
    store = _port_store(p, name)
    spec = api.ServeSpec(max_batch=8, routed=name == "PICStore")
    path = ser.save_store(tmp_path / f"{name}.npz", store, spec=spec)
    back, spec_back = ser.load_store(path, with_spec=True, device="cpu")
    assert type(back) is type(store) and spec_back == spec
    assert back.kfn is store.kfn and back.runner == store.runner
    a, b = _store_leaves(store), _store_leaves(back)
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
    for f, x, z in zip(store.to_state()._fields, store.to_state(),
                       back.to_state()):
        assert torch.equal(x, z), f
    # the restored store keeps streaming: revive the retired machine
    for f, x, z in zip(store.revive(1).to_state()._fields,
                       store.revive(1).to_state(),
                       back.revive(1).to_state()):
        assert torch.equal(x, z), f


def test_float64_picf_r_space_kept_for_float32_data(prob32, tmp_path):
    """The port's float32 pICF store keeps its float64 R-space through a
    round trip; the loader changes no dtype."""
    store = _port_store(prob32, "PICFStore")
    assert store.Xb.dtype == torch.float32 and \
        store.Phi_L.dtype == torch.float64
    back = ser.load_store(ser.save_store(tmp_path / "f.npz", store),
                          device="cpu")
    assert back.Xb.dtype == torch.float32
    assert back.Phi_L.dtype == torch.float64 and back.yF.dtype == \
        torch.float64


# ---------------------------------------------------------------------------
# Cross-load, both directions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", STATES)
def test_jax_state_loads_in_the_port(prob, tmp_path, name):
    jstate = _jax_state(prob, name)
    path = jser.save_state(tmp_path / "j.npz", jstate)
    st = ser.load_state(path, device="cpu")
    assert type(st).__name__ == name and st._fields == jstate._fields
    for f, a, b in zip(st._fields, st, jstate):
        assert _bitwise(a, b), f
    m, v = _port_diag(name, cov.make_kernel("se"), prob["params"], st,
                      prob["U"])
    jm, jv = _jax_diag(name, jcov.make_kernel("se"), prob["jparams"],
                       jstate, prob["U"])
    assert max(_err(m, jm), _err(v, jv)) <= STATE_TOL


@pytest.mark.parametrize("name", STATES)
def test_port_state_loads_in_jax(prob, tmp_path, name):
    st = _port_state(prob, name)
    path = ser.save_state(tmp_path / "p.npz", st)
    jstate = jser.load_state(path)
    assert type(jstate).__name__ == name
    for f, a, b in zip(st._fields, st, jstate):
        assert _bitwise(a, b), f
    m, v = _port_diag(name, cov.make_kernel("se"), prob["params"], st,
                      prob["U"])
    jm, jv = _jax_diag(name, jcov.make_kernel("se"), prob["jparams"],
                       jstate, prob["U"])
    assert max(_err(m, jm), _err(v, jv)) <= STATE_TOL


def _kernels(kind):
    """The same kernel in both packages: a registry name, or a KernelSpec
    whose impl the port calls ``torch`` and the reference ``jnp``."""
    if kind == "named":
        return cov.make_kernel("se"), jcov.make_kernel("se")
    return (cov.make_spec("se", impl="torch", fused=False, block_q=8),
            jcov.make_spec("se", impl="jnp", fused=False, block_q=8))


@pytest.mark.parametrize("kind", ["named", "spec"])
@pytest.mark.parametrize("name", STORES)
def test_jax_store_loads_in_the_port(prob, tmp_path, name, kind):
    kfn, jkfn = _kernels(kind)
    jstore = _jax_store(prob, name, jkfn)
    routed = name == "PICStore"
    jspec = japi.ServeSpec(kernel=jkfn if kind == "spec" else None,
                           max_batch=8, routed=routed)
    path = jser.save_store(tmp_path / "j.npz", jstore, spec=jspec)
    store, spec = ser.load_store(path, with_spec=True, device="cpu")
    assert spec == api.ServeSpec(kernel=kfn if kind == "spec" else None,
                                 max_batch=8, routed=routed)
    assert store.kfn == kfn and store.runner == VmapRunner(M=prob["M"])
    a, b = _store_leaves(store), _jstore_leaves(jstore)
    assert set(a) == set(b)
    for k in a:
        assert _bitwise(a[k], b[k]), k
    st, jst = store.to_state(), jstore.to_state()
    assert max(_err(x, z) for x, z in zip(st, jst)) <= STATE_TOL
    m, v = _port_diag(name, kfn, store.params, st, prob["U"])
    jm, jv = _jax_diag(name, jkfn, jstore.params, jst, prob["U"])
    assert max(_err(m, jm), _err(v, jv)) <= STATE_TOL


@pytest.mark.parametrize("kind", ["named", "spec"])
@pytest.mark.parametrize("name", STORES)
def test_port_store_loads_in_jax(prob, tmp_path, name, kind):
    kfn, jkfn = _kernels(kind)
    store = _port_store(prob, name, kfn)
    spec = api.ServeSpec(kernel=kfn if kind == "spec" else None,
                         max_batch=8, routed=name == "PICStore")
    path = ser.save_store(tmp_path / "p.npz", store, spec=spec)
    jstore, jspec = jser.load_store(path, with_spec=True)
    assert jspec == japi.ServeSpec(
        kernel=jkfn if kind == "spec" else None, max_batch=8,
        routed=name == "PICStore")
    assert jstore.kfn == jkfn and jstore.runner.M == prob["M"]
    a, b = _store_leaves(store), _jstore_leaves(jstore)
    for k in a:
        assert _bitwise(a[k], b[k]), k
    st, jst = store.to_state(), jstore.to_state()
    assert max(_err(x, z) for x, z in zip(st, jst)) <= STATE_TOL
    m, v = _port_diag(name, kfn, store.params, st, prob["U"])
    jm, jv = _jax_diag(name, jkfn, jstore.params, jst, prob["U"])
    assert max(_err(m, jm), _err(v, jv)) <= STATE_TOL


def test_jax_float32_picf_store_served_in_float32(prob32, tmp_path):
    """The reference's float32 pICF store carries a float32 R-space; the
    port loads it as it is and serves it in float32."""
    jstore = _jax_store(prob32, "PICFStore")
    path = jser.save_store(tmp_path / "j32.npz", jstore)
    store = ser.load_store(path, device="cpu")
    assert store.Phi_L.dtype == torch.float32 and \
        store.yF.dtype == torch.float32
    st = store.to_state()
    assert st.Phi_L.dtype == torch.float32
    m, v = _port_diag("PICFStore", store.kfn, store.params, st, prob32["U"])
    jm, jv = _jax_diag("PICFStore", jstore.kfn, jstore.params,
                       jstore.to_state(), prob32["U"])
    assert m.dtype == torch.float32
    assert max(_err(m, jm), _err(v, jv)) <= 1e-3


# ---------------------------------------------------------------------------
# Metadata: impl names, runner axis name, ServeSpec, peek
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl,on_file,back", [
    ("auto", "auto", "auto"), ("cuda", "pallas", "cuda"),
    ("torch", "jnp", "torch")])
def test_kernel_impl_written_under_the_references_names(impl, on_file,
                                                        back):
    meta = ser._kernel_meta(cov.KernelSpec("se", impl, False, 16))
    assert meta == {"kind": "spec", "name": "se", "impl": on_file,
                    "fused": False, "block_q": 16}
    # the reference builds its KernelSpec from the same record
    assert jser._kernel_from_meta(meta, None) == \
        jcov.KernelSpec("se", on_file, False, 16)
    assert ser._kernel_from_meta(meta, None) == \
        cov.KernelSpec("se", back, False, 16)


@pytest.mark.parametrize("ref_impl,port_impl", [
    ("auto", "auto"), ("pallas", "cuda"), ("pallas_interpret", "torch"),
    ("jnp", "torch")])
def test_reference_impl_names_read_through_the_alias_map(ref_impl,
                                                         port_impl):
    meta = jser._kernel_meta(jcov.KernelSpec("se", ref_impl, True, None))
    assert ser._kernel_from_meta(meta, None) == \
        cov.KernelSpec("se", port_impl, True, None)


def test_runner_meta_carries_the_references_axis_name():
    meta = ser._runner_meta(VmapRunner(M=5))
    assert meta == jser._runner_meta(JVmapRunner(M=5))
    assert jser._runner_from_meta(meta, None).M == 5
    # the reference may record any axis name: accepted and ignored
    assert ser._runner_from_meta({"kind": "vmap", "M": 3,
                                  "axis_name": ["a", "b"]}, None) == \
        VmapRunner(M=3)


def test_serve_spec_roundtrips_in_both_packages(tmp_path):
    spec = api.ServeSpec(kernel=cov.KernelSpec("se", "torch", False, 16),
                         buckets=(8, 32), routed=True, alpha=3,
                         max_overflow_groups=2, cached_cinv=True,
                         dtype="state")
    jspec = japi.ServeSpec(kernel=jcov.KernelSpec("se", "jnp", False, 16),
                           buckets=(8, 32), routed=True, alpha=3,
                           max_overflow_groups=2, cached_cinv=True,
                           dtype="state")
    meta = ser._spec_meta(spec)
    assert meta == jser._spec_meta(jspec)
    assert ser._spec_from_meta(meta) == spec
    assert jser._spec_from_meta(meta) == jspec
    # the reference's own record, read by the port
    assert ser._spec_from_meta(jser._spec_meta(jspec)) == spec
    plain = api.ServeSpec(max_batch=64)
    assert ser._spec_from_meta(ser._spec_meta(plain)) == plain


def _peek_kernel(meta: dict) -> dict:
    out = dict(meta)
    if "impl" in out:
        out["impl"] = cov._IMPL_ALIASES.get(out["impl"], out["impl"])
    return out


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_peek_agrees_with_the_reference(prob, tmp_path, writer):
    if writer == "jax":
        path = jser.save_state(tmp_path / "s.npz",
                               _jax_state(prob, "PICState"))
    else:
        path = ser.save_state(tmp_path / "s.npz",
                              _port_state(prob, "PICState"))
    assert ser.peek(path) == jser.peek(path)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_peek_store_agrees_with_the_reference(prob, tmp_path, writer):
    kfn, jkfn = _kernels("spec")
    if writer == "jax":
        path = jser.save_store(tmp_path / "s.npz",
                               _jax_store(prob, "PICStore", jkfn),
                               spec=japi.ServeSpec(max_batch=8, routed=True))
    else:
        path = ser.save_store(tmp_path / "s.npz",
                              _port_store(prob, "PICStore", kfn),
                              spec=api.ServeSpec(max_batch=8, routed=True))
    got, want = ser.peek_store(path), jser.peek_store(path)
    assert _peek_kernel(got.pop("kernel")) == _peek_kernel(
        want.pop("kernel"))
    assert got == want


# ---------------------------------------------------------------------------
# Failure cases: CheckpointError with the reference's reasons
# ---------------------------------------------------------------------------

def _reason(exc) -> str:
    """The reason up to its first parenthesis (a wrapped exception's text
    after it names the package's own internals)."""
    return exc.reason.split(" (")[0]


def _both(load, jload, path):
    with pytest.raises(ser.CheckpointError) as got:
        load(path)
    with pytest.raises(jser.CheckpointError) as want:
        jload(path)
    assert got.value.path == str(path) == want.value.path
    assert _reason(got.value) == _reason(want.value)
    return got.value


def _rewrite(path, drop=(), **repl):
    with np.load(path) as z:
        payload = {k: z[k] for k in z.files if k not in drop}
    payload.update(repl)
    with open(path, "wb") as fh:
        np.savez(fh, **payload)


def _port_loaders(kind):
    if kind == "state":
        return (lambda p: ser.load_state(p, device="cpu"), jser.load_state)
    return (lambda p: ser.load_store(p, device="cpu"), jser.load_store)


@pytest.mark.parametrize("kind", ["state", "store"])
@pytest.mark.parametrize("case", [
    "missing", "truncated", "flipped", "schema", "drift", "unknown_type",
    "not_a_checkpoint", "checksum"])
def test_failure_cases_match_the_reference(prob, tmp_path, kind, case):
    path = tmp_path / "c.npz"
    if kind == "state":
        ser.save_state(path, _port_state(prob, "PITCState"))
        schema_key, type_key, drop = "__schema__", "__state__", \
            "field:alpha"
    else:
        ser.save_store(path, _port_store(prob, "PITCStore"))
        schema_key, type_key, drop = "__store_schema__", "__store__", \
            "sum:ydd"
    load, jload = _port_loaders(kind)
    if case == "missing":
        path = tmp_path / "nope.npz"
    elif case == "truncated":
        raw = path.read_bytes()
        path.write_bytes(raw[:len(raw) // 2])
    elif case == "flipped":
        FaultInjector(FaultPlan(seed=1)).corrupt(path)
    elif case == "schema":
        _rewrite(path, **{schema_key: np.int64(2)})
    elif case == "drift":
        _rewrite(path, drop=(drop,))
    elif case == "unknown_type":
        _rewrite(path, **{type_key: np.str_("BogusState")})
    elif case == "not_a_checkpoint":
        with open(path, "wb") as fh:
            np.savez(fh, a=np.zeros(3))
    elif case == "checksum":
        # a payload rewritten with valid zip entries but other bits: only
        # the embedded crc32 map can tell
        with np.load(path) as z:
            key = next(k for k in z.files if k.startswith(
                ("field:", "arr:")))
            bad = z[key].copy()
        bad.flat[0] += 1.0
        _rewrite(path, **{key: bad})
    err = _both(load, jload, path)
    want = {"missing": "no such", "truncated": "truncated or corrupt",
            "flipped": None, "schema": "schema v2 != supported v1",
            "drift": "field mismatch", "unknown_type": "unknown",
            "not_a_checkpoint": "not a repro", "checksum": "checksum "
            "mismatch"}[case]
    if want is not None:
        assert want in err.reason


def test_corrupt_bytes_match_the_references_picks(prob, tmp_path):
    """The port's FaultInjector flips the reference's bytes: one seed, one
    torn file, in both packages."""
    path = ser.save_state(tmp_path / "a.npz", _port_state(prob, "PICState"))
    twin = tmp_path / "b.npz"
    shutil.copy(path, twin)
    FaultInjector(FaultPlan(seed=5)).corrupt(path)
    JFaultInjector(JFaultPlan(seed=5)).corrupt(twin)
    assert path.read_bytes() == twin.read_bytes()


@pytest.mark.parametrize("what", ["kernel", "runner", "spec_kernel"])
def test_opaque_members_fail_loudly_as_the_reference(prob, tmp_path, what):
    store = _port_store(prob, "PITCStore")
    jstore = _jax_store(prob, "PITCStore")
    closure = lambda params, X1, X2: cov.se_ard(params, X1, X2)  # noqa: E731
    jclosure = lambda params, X1, X2: jcov.se_ard(params, X1, X2)  # noqa
    if what == "kernel":
        store = dataclasses.replace(store, kfn=closure)
        jstore = dataclasses.replace(jstore, kfn=jclosure)
    elif what == "runner":
        store = dataclasses.replace(store, runner=object())
        jstore = dataclasses.replace(jstore, runner=object())
    path, jpath = tmp_path / "p.npz", tmp_path / "j.npz"
    spec = api.ServeSpec(max_batch=8, kernel=closure) \
        if what == "spec_kernel" else None
    jspec = japi.ServeSpec(max_batch=8, kernel=jclosure) \
        if what == "spec_kernel" else None
    ser.save_store(path, store, spec=spec)
    jser.save_store(jpath, jstore, spec=jspec)
    assert ser.peek_store(path)[
        "serve_spec" if what == "spec_kernel" else what]
    with pytest.raises(ser.CheckpointError, match="opaque") as got:
        ser.load_store(path, with_spec=True, device="cpu")
    with pytest.raises(jser.CheckpointError, match="opaque") as want:
        jser.load_store(jpath, with_spec=True)
    assert _reason(got.value) == _reason(want.value)
    # an explicit override restores
    if what == "kernel":
        back = ser.load_store(path, kfn=closure, device="cpu")
        assert back.kfn is closure
    elif what == "runner":
        back = ser.load_store(path, runner=VmapRunner(M=prob["M"]),
                              device="cpu")
        assert back.runner == VmapRunner(M=prob["M"])


# ---------------------------------------------------------------------------
# What the port refuses, and where it puts tensors
# ---------------------------------------------------------------------------

def test_unregistered_state_type_rejected(tmp_path):
    from repro_torch.core.ppitc import GlobalSummary
    bogus = GlobalSummary(torch.zeros(2), torch.eye(2))
    with pytest.raises(ValueError, match="unregistered"):
        ser.save_state(tmp_path / "x.npz", bogus)
    with pytest.raises(ValueError, match="cannot serialize store type"):
        ser.save_store(tmp_path / "x.npz", object())


def test_bfloat16_refused_on_save(prob, tmp_path):
    st = _port_state(prob, "PITCState")
    st = st._replace(alpha=st.alpha.to(torch.bfloat16))
    with pytest.raises(TypeError, match="numpy has no torch.bfloat16"):
        ser.save_state(tmp_path / "b.npz", st)


def test_a_dtype_torch_cannot_hold_refused_on_load(prob, tmp_path):
    path = ser.save_state(tmp_path / "u.npz", _port_state(prob, "PITCState"))
    with np.load(path) as z:
        payload = {k: z[k] for k in z.files}
    # raw 2-byte records, as a reader without bfloat16 sees one
    payload["field:alpha"] = np.zeros(3, dtype="V2")
    payload["__checksums__"] = np.str_(json.dumps({}))
    with open(path, "wb") as fh:
        np.savez(fh, **payload)
    with pytest.raises(ser.CheckpointError, match="torch cannot hold"):
        ser.load_state(path, device="cpu")


def test_tensors_that_cannot_be_materialized_refused(prob, tmp_path):
    st = _port_state(prob, "PITCState")
    meta = st._replace(alpha=torch.empty(st.alpha.shape, device="meta"))
    with pytest.raises(TypeError, match="traced fields: \\['alpha'\\]"):
        ser.save_state(tmp_path / "m.npz", meta)

    def inside(a):
        ser.save_state(tmp_path / "v.npz", st._replace(alpha=a))
        return a

    with pytest.raises(TypeError, match="torch.func"):
        torch.func.vmap(inside)(st.alpha[None])
    store = _port_store(prob, "PITCStore")
    with pytest.raises(TypeError, match="traced leafs: \\['arr:S'\\]"):
        ser.save_store(tmp_path / "s.npz", dataclasses.replace(
            store, S=torch.empty(store.S.shape, device="meta")))
    assert not os.path.exists(tmp_path / "m.npz")


def test_a_graph_is_detached_on_save(prob, tmp_path):
    st = _port_state(prob, "PITCState")
    st = st._replace(alpha=st.alpha.clone().requires_grad_(True))
    back = ser.load_state(ser.save_state(tmp_path / "g.npz", st),
                          device="cpu")
    assert not back.alpha.requires_grad
    assert torch.equal(back.alpha, st.alpha.detach())


def test_loaders_default_to_the_card(prob, tmp_path, monkeypatch):
    path = ser.save_state(tmp_path / "s.npz", _port_state(prob, "PITCState"))
    spath = ser.save_store(tmp_path / "t.npz",
                           _port_store(prob, "PITCStore"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ser.load_state(path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ser.load_store(spath)
