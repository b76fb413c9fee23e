"""The port's streaming stores (``api.StateStore``: pPITC, pPIC, PITC, PIC
and pICF) and ``linalg``'s rank-b Cholesky updates against the JAX package,
in float64 on the CPU.

Mirrors ``tests/test_state_store.py``'s ``TestCholUpdate``,
``TestIncrementalToState``, ``TestWithAliveHamming``, ``TestStoreLifecycle``
and ``TestPICFStore`` at the reference's sizes and with its own limits
(1e-12 / 1e-11 for the updates, 1e-5 streamed against cold), and holds every
store's ``to_state()`` after each mutation against the reference's within
1e-10 (ROADMAP's runner-and-state tolerance). Where the port computes by
another route the test says so and compares values, not bits: an update is
the QR of the stacked square root, not the reference's sweeps, and
``with_alive``'s refold factors Sdd from its square root, not from the
formed sum. The downdate on CPU tensors is the reference's sweeps
(``kernels/linalg/ref.py``). Inputs are made with numpy from a seed and fed
to both packages.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import api as japi, covariance as jcov, linalg as jlinalg, \
    online as jonline, picf as jpicf
from repro.parallel.runner import VmapRunner as JVmapRunner
from repro_torch import convert
from repro_torch.core import api, covariance as cov, linalg, online, picf, \
    ppitc
from repro_torch.kernels import build
from repro_torch.kernels.attention import ops as attn_ops
from repro_torch.kernels.linalg import ops as linalg_ops, ref as linalg_ref
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.parallel.runner import VmapRunner

STATE_TOL = 1e-10
R = 48


def _t(a):
    return torch.tensor(np.asarray(a))


def _err(got, want) -> float:
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    return float(np.abs(got - np.asarray(want)).max()) if got.size else 0.0


def _state_err(st, jst) -> float:
    assert type(st).__name__ == type(jst).__name__
    assert st._fields == jst._fields
    for f, a, b in zip(st._fields, st, jst):
        assert tuple(a.shape) == tuple(b.shape), f
    return max(_err(a, b) for a, b in zip(st, jst))


@pytest.fixture(scope="module")
def prob():
    """tests/helpers.make_problem's shapes (n=96, u=24, s=12, d=3, M=4),
    drawn with numpy; a second wave of the same size for streaming."""
    rng = np.random.default_rng(0)
    n, u, s, d, M = 96, 24, 12, 3, 4
    X, S, U = (rng.normal(size=(k, d)) for k in (n, s, u))
    y = np.sin(X[:, 0]) * 2.0 + X[:, 1] - 0.5 * X[:, 2] ** 2 \
        + 0.3 * rng.normal(size=n)
    X2 = rng.normal(size=(n, d))
    y2 = np.cos(X2[:, 0]) + 0.3 * rng.normal(size=n)
    jparams = jcov.init_params(d, signal=1.3, noise=0.3, lengthscale=1.5,
                               dtype=jnp.float64)
    return dict(X=X, y=y, S=S, U=U, X2=X2, y2=y2, M=M, jparams=jparams,
                params=convert.params_from_arrays(jparams, device="cpu"),
                kfn=cov.make_kernel("se"), jkfn=jcov.make_kernel("se"))


def _kw(p, name, M=None):
    """init_store keywords of both packages for method ``name``."""
    M = M or p["M"]
    if name == "picf":
        return (dict(rank=R, runner=VmapRunner(M=M)),
                dict(rank=R, runner=JVmapRunner(M=M)))
    if name in ("pitc", "pic"):
        return (dict(S=_t(p["S"]), M=M), dict(S=jnp.asarray(p["S"]), M=M))
    return (dict(S=_t(p["S"]), runner=VmapRunner(M=M)),
            dict(S=jnp.asarray(p["S"]), runner=JVmapRunner(M=M)))


def _stores(p, name, X=None, y=None, M=None):
    """The same store in both packages."""
    X = p["X"] if X is None else X
    y = p["y"] if y is None else y
    kw, jkw = _kw(p, name, M)
    st = api.init_store(name, p["kfn"], p["params"], _t(X), _t(y),
                        device="cpu", **kw)
    jst = japi.init_store(name, p["jkfn"], p["jparams"], jnp.asarray(X),
                          jnp.asarray(y), **jkw)
    return st, jst


def _store(p, name, M=None, X=None, y=None):
    kw, _ = _kw(p, name, M)
    X = p["X"] if X is None else X
    y = p["y"] if y is None else y
    return api.init_store(name, p["kfn"], p["params"], _t(X), _t(y),
                          device="cpu", **kw)


# ---------------------------------------------------------------------------
# linalg: rank-1 / rank-b Cholesky update and downdate
# ---------------------------------------------------------------------------

def _psd(n, seed=0):
    A0 = np.random.RandomState(seed).randn(n, 2 * n)
    return A0 @ A0.T + n * np.eye(n)


class TestCholUpdate:
    """The reference's own limits. The update is the QR of [Lᵀ; Wᵀ]
    (``chol_from_root``), not the reference's sweeps: values, not bits."""

    def test_rank1_update_matches_refactorization(self):
        A = _psd(16)
        L = torch.linalg.cholesky(_t(A))
        w = np.random.RandomState(1).randn(16)
        ref = np.linalg.cholesky(A + np.outer(w, w))
        assert _err(linalg.cholupdate(L, _t(w)), ref) < 1e-12
        jL = jnp.asarray(L.numpy())
        assert _err(linalg.cholupdate(L, _t(w)),
                    jlinalg.cholupdate(jL, jnp.asarray(w))) < 1e-12

    def test_rank1_downdate_inverts_update(self):
        A = _psd(16)
        L = torch.linalg.cholesky(_t(A))
        w = _t(np.random.RandomState(2).randn(16))
        assert _err(linalg.choldowndate(linalg.cholupdate(L, w), w),
                    L.numpy()) < 1e-12

    def test_rank_b_update_matches_refactorization(self):
        A = _psd(20)
        L = torch.linalg.cholesky(_t(A))
        W = np.random.RandomState(3).randn(20, 7)
        ref = np.linalg.cholesky(A + W @ W.T)
        assert _err(linalg.chol_update_rank(L, _t(W)), ref) < 1e-11
        assert _err(linalg.chol_update_rank(_t(ref), _t(W), sign=-1.0),
                    L.numpy()) < 1e-11

    @pytest.mark.parametrize("sign", [1.0, -1.0])
    def test_zero_columns_are_inert(self, sign):
        """Zero update vectors (the factor-padding convention) are no-ops,
        bit for bit, on either route."""
        L = torch.linalg.cholesky(_t(_psd(10)))
        W = torch.zeros((10, 4), dtype=L.dtype)
        assert torch.equal(linalg.chol_update_rank(L, W, sign=sign), L)

    @pytest.mark.parametrize("sign", [1.0, -1.0])
    @pytest.mark.parametrize("n,b", [(20, 7), (12, 1), (6, 15)])
    def test_rank_b_matches_the_reference(self, sign, n, b):
        """Both signs against the reference's chained sweeps (b > n too)."""
        A = _psd(n, seed=n)
        W = np.random.RandomState(b).randn(n, b) * 0.5
        L = np.linalg.cholesky(A + W @ W.T if sign < 0 else A)
        got = linalg.chol_update_rank(_t(L), _t(W), sign=sign)
        want = jlinalg.chol_update_rank(jnp.asarray(L), jnp.asarray(W),
                                        sign=sign)
        assert _err(got, want) < 1e-11

    def test_routes(self):
        """Update: the QR of the stacked root, bitwise. Downdate on CPU
        tensors: the plain sweeps (``ref.py``), bitwise, with no kernel
        launch counted. A sign other than ±1 is refused."""
        A = _psd(12)
        L = torch.linalg.cholesky(_t(A))
        W = _t(np.random.RandomState(4).randn(12, 5) * 0.3)
        assert torch.equal(linalg.chol_update_rank(L, W),
                           linalg.chol_from_root(L, W))
        L1 = linalg.chol_from_root(L, W)
        n0 = linalg_ops.chol_downdate_launches
        assert torch.equal(linalg.chol_update_rank(L1, W, sign=-1.0),
                           linalg_ref.chol_downdate(L1, W))
        assert linalg_ops.chol_downdate_launches == n0
        with pytest.raises(ValueError, match="sign"):
            linalg.chol_update_rank(L, W, sign=2.0)

    @pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
    def test_plain_downdate_is_the_reference_sweep_order(self, dtype):
        """The wavefront order of ``ref.chol_downdate`` does the sequential
        sweeps' arithmetic on the same values: bitwise equal to them,
        written out here as the reference's ``_chol_rank1`` loop."""
        n, b = 9, 5
        L0 = torch.linalg.cholesky(_t(_psd(n, seed=7))).to(dtype)
        W = (_t(np.random.RandomState(8).randn(n, b)) * 0.5).to(dtype)
        L1 = linalg.chol_from_root(L0, W)
        want, idx = L1.clone(), torch.arange(n)
        tiny = torch.finfo(dtype).tiny
        for w in W.T.clone():
            for k in range(n):
                lk, wk = want[k, k].clone(), w[k].clone()
                r = torch.sqrt(torch.clamp(lk * lk + -1.0 * wk * wk,
                                           min=tiny))
                c, s = r / lk, wk / lk
                below = idx > k
                col = torch.where(below, (want[:, k] + -1.0 * s * w) / c,
                                  want[:, k])
                col[k] = r
                w = torch.where(below, c * w - s * col, w)
                want[:, k] = col
        assert torch.equal(linalg_ref.chol_downdate(L1, W), want)

    def test_downdate_leaves_its_inputs(self):
        L = torch.linalg.cholesky(_t(_psd(8)))
        W = _t(np.random.RandomState(5).randn(8, 3) * 0.2)
        L1 = linalg.chol_from_root(L, W)
        L1c, Wc = L1.clone(), W.clone()
        linalg.chol_update_rank(L1, W, sign=-1.0)
        assert torch.equal(L1, L1c) and torch.equal(W, Wc)


# ---------------------------------------------------------------------------
# The CUDA wrappers refuse a graph before they launch (ROADMAP §3 item 4),
# unless a backward kernel records it (flash and SSD)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("call", [
    lambda x: linalg_ops.chol_downdate(torch.eye(8), x),
], ids=["<lambda>0"])
def test_kernel_wrappers_refuse_a_graph_before_launching(monkeypatch, call):
    """The downdate wrapper, which has no backward kernel, checks before it
    touches a card: with its tensors taken for CUDA ones (no card here), an
    input that requires grad is refused in grad mode, where the kernel
    would return a tensor cut from the graph."""
    monkeypatch.setattr(build, "on_cpu", lambda *t: False)
    x = torch.zeros(8, 8, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        call(x)


class _Launched(Exception):
    """Raised where a wrapper fetches its kernel's entry point."""


def _lm_wrapper(name: str):
    """(module, call, its backward's name) of the flash or SSD wrapper on
    an 8 x 8 input that requires grad."""
    if name == "flash":
        return (attn_ops, lambda x: attn_ops.attention(
            x[None, None], x[None, None], x[None, None]),
            "attention_backward")
    return (ssd_ops, lambda x: ssd_ops.intra_chunk(
        x[None, :, None, :], x[None, None, :, 0], x[None], x[None])[0],
        "intra_chunk_backward")


@pytest.mark.parametrize("name", ["flash", "ssd"])
def test_lm_wrappers_under_grad_go_to_their_kernels(monkeypatch, name):
    """With their tensors taken for CUDA ones and an input that requires
    grad, in grad mode, the flash and SSD wrappers do not refuse and do not
    take the plain version: they go on to fetch their forward kernel
    (stubbed here to raise, whatever toolchain the machine has)."""
    mod, call, _ = _lm_wrapper(name)
    monkeypatch.setattr(build, "on_cpu", lambda *t: False)

    def entry():
        raise _Launched

    monkeypatch.setattr(mod, "_entry", entry)
    with pytest.raises(_Launched):
        call(torch.zeros(8, 8, requires_grad=True))


@pytest.mark.parametrize("name", ["flash", "ssd"])
def test_lm_wrappers_record_their_backward(monkeypatch, name):
    """In grad mode, with an input that requires grad, the flash and SSD
    wrappers' outputs carry a ``grad_fn``, and ``backward`` calls the
    backward wrapper (which launches the backward kernel on the card) once
    with the saved inputs; under no_grad there is no graph. The forward
    kernel and the backward wrapper are stubbed by the plain versions."""
    mod, call, bwd = _lm_wrapper(name)
    plain_fwd = (lambda q, k, v, causal, window, scale, q_offset:
                 attn_ops._plain(q, k, v, causal, window, scale, q_offset)) \
        if name == "flash" else (lambda *a: ssd_ops.ref.intra_chunk(*a))
    plain_bwd = getattr(mod, bwd)
    calls = []

    def backward(*args, **kw):
        calls.append(args)
        return plain_bwd(*args, **kw)

    monkeypatch.setattr(mod, "_forward", plain_fwd)
    monkeypatch.setattr(mod, bwd, backward)
    x = torch.randn(8, 8, generator=torch.Generator().manual_seed(3),
                    requires_grad=True)
    monkeypatch.setattr(build, "on_cpu", lambda *t: False)
    with torch.no_grad():
        assert call(x).grad_fn is None
    out = call(x)
    assert out.grad_fn is not None and not calls
    monkeypatch.setattr(build, "on_cpu", lambda *t: True)
    out.square().sum().backward()
    assert len(calls) == 1 and calls[0][0] is not None
    assert x.grad is not None and float(x.grad.abs().max()) > 0


def test_refuse_grad_is_shared_and_keeps_its_old_name():
    from repro_torch.kernels.rbf import ops as rbf_ops
    assert rbf_ops.refuse_grad is build.refuse_grad
    x = torch.zeros(3, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        build.refuse_grad("attention", x)
    with torch.no_grad():
        build.refuse_grad("attention", x)


# ---------------------------------------------------------------------------
# Incremental to_state (the update path) against full recomputation
# ---------------------------------------------------------------------------

class TestIncrementalToState:
    def test_assimilate_matches_full_recompute_1e5(self, prob):
        """Streaming half the data through the rank-b update path gives
        (Sdd_L, alpha) within 1e-5 of a refold of the same summaries and of
        a cold fit of the concatenated data; and within 1e-10 of the
        reference's streamed store."""
        p = prob
        n1 = p["X"].shape[0] // 2
        store, jstore = _stores(p, "ppitc", p["X"][:n1], p["y"][:n1])
        store = store.assimilate(_t(p["X"][n1:]), _t(p["y"][n1:]))
        jstore = jstore.assimilate(jnp.asarray(p["X"][n1:]),
                                   jnp.asarray(p["y"][n1:]))
        ref = online.with_alive(store.store, store.store.alive,
                                mode="refold")
        assert _err(store.store.Sdd_L, ref.Sdd_L.numpy()) < 1e-5
        st_inc, st_ref = store.to_state(), online.to_state(ref, _t(p["S"]))
        assert _err(st_inc.alpha, st_ref.alpha.numpy()) < 1e-5
        cold = ppitc.fit(p["kfn"], p["params"], _t(p["X"]), _t(p["y"]),
                         S=_t(p["S"]), runner=VmapRunner(M=2 * p["M"]))
        assert _err(st_inc.Sdd_L, cold.Sdd_L.numpy()) < 1e-5
        assert _err(st_inc.alpha, cold.alpha.numpy()) < 1e-5
        assert _state_err(st_inc, jstore.to_state()) < STATE_TOL

    def test_retire_downdate_matches_survivor_refold(self, prob):
        store = _store(prob, "ppitc").retire(1)
        ref = online.with_alive(store.store, store.store.alive,
                                mode="refold")
        assert _err(store.store.Sdd_L, ref.Sdd_L.numpy()) < 1e-5

    def test_to_state_has_no_cubic_refactorization(self, prob):
        """to_state after retire reuses the cached (downdated) factor: it
        equals the port's own ``chol_update_rank`` downdate of the cold
        factor bit for bit (not a refactorization of the alive Sdd)."""
        store = _store(prob, "ppitc")
        expected = linalg.chol_update_rank(store.store.Sdd_L,
                                           store.store.F[2], sign=-1.0)
        assert torch.equal(store.retire(2).to_state().Sdd_L, expected)


# ---------------------------------------------------------------------------
# with_alive: incremental chain against the refold, by Hamming distance
# ---------------------------------------------------------------------------

class TestWithAliveHamming:
    """``online.with_alive`` picks retire/revive chains or the refold by
    the Hamming distance of the mask, with the reference's crossover.
    M = 12 gives b = 8 < |S|: the regime where the chain is chosen."""

    @pytest.fixture(scope="class")
    def stores(self, prob):
        return _stores(prob, "ppitc", M=12)

    def test_small_flip_is_incremental(self, stores):
        """A single-machine flip follows the retire path bit for bit."""
        store, _ = stores
        mask = store.alive.clone()
        mask[1] = False
        flipped = store.with_alive(mask)
        assert torch.equal(flipped.store.Sdd_L, store.retire(1).store.Sdd_L)

    def test_incremental_matches_refold(self, stores):
        store, _ = stores
        mask = store.alive.clone()
        mask[0] = mask[3] = False
        inc = online.with_alive(store.store, mask, mode="incremental")
        ref = online.with_alive(store.store, mask, mode="refold")
        assert torch.equal(inc.alive, ref.alive)
        assert _err(inc.Sdd_L, ref.Sdd_L.numpy()) < 1e-10
        assert _err(inc.ydd, ref.ydd.numpy()) < 1e-10

    def test_wholesale_flip_refolds(self, stores):
        """Flipping every machine but one exceeds the h·b crossover: auto
        takes the refold, bit for bit equal to mode='refold'."""
        store, _ = stores
        mask = ~store.alive
        mask[0] = True
        auto = online.with_alive(store.store, mask)
        ref = online.with_alive(store.store, mask, mode="refold")
        assert torch.equal(auto.Sdd_L, ref.Sdd_L)

    def test_noop_mask_returns_store_unchanged(self, stores):
        store, _ = stores
        assert online.with_alive(store.store, store.store.alive) \
            is store.store
        assert store.with_alive(store.alive.numpy()) is store
        assert online.with_alive(store.store, store.store.alive,
                                 mode="incremental") is store.store

    def test_bad_mode_and_mask_rejected(self, stores):
        store, _ = stores
        with pytest.raises(ValueError, match="with_alive mode"):
            online.with_alive(store.store, store.store.alive, mode="nope")
        with pytest.raises(ValueError, match="mask"):
            online.with_alive(store.store, store.store.alive[:3])

    @pytest.mark.parametrize("mode", ["incremental", "refold", "auto"])
    @pytest.mark.parametrize("dead", [(1,), (0, 3), (0, 2, 4, 5, 7, 8, 11)])
    def test_matches_the_reference(self, stores, mode, dead):
        """Each mode and Hamming distance against the reference's
        ``with_alive`` (its refold factors the formed Sdd; the port's
        refold the square root): the states within 1e-10."""
        store, jstore = stores
        mask = np.ones(12, bool)
        mask[list(dead)] = False
        got = store.with_alive(mask, mode=mode).to_state()
        want = jstore.with_alive(jnp.asarray(mask), mode=mode).to_state()
        assert _state_err(got, want) < STATE_TOL


# ---------------------------------------------------------------------------
# Store lifecycle
# ---------------------------------------------------------------------------

class TestStoreLifecycle:
    def test_protocol_membership(self, prob):
        for name in ("ppitc", "ppic", "picf", "pitc", "pic"):
            assert isinstance(_store(prob, name), api.StateStore), name
            assert api.get(name).init_store is not None

    def test_fgp_has_no_store(self, prob):
        with pytest.raises(ValueError, match="no incremental StateStore"):
            api.init_store("fgp", prob["kfn"], prob["params"],
                           _t(prob["X"]), _t(prob["y"]), device="cpu")
        assert api.get("fgp").init_store is None

    def test_init_store_refuses_the_cpu_unasked(self, prob, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            api.init_store("ppitc", prob["kfn"], prob["params"],
                           _t(prob["X"]), _t(prob["y"]), S=_t(prob["S"]),
                           runner=VmapRunner(M=4))

    @pytest.mark.parametrize("name", ["ppitc", "ppic", "picf"])
    def test_retire_revive_to_state_roundtrip(self, prob, name):
        """retire -> revive -> to_state reproduces the original state for
        every store-backed method (downdate and update cancel)."""
        store = _store(prob, name)
        s0 = store.to_state()
        s1 = store.retire(2).revive(2).to_state()
        for f, a, b in zip(s0._fields, s0, s1):
            assert _err(a, b.numpy()) < 1e-10, f"{name}.{f}"

    @pytest.mark.parametrize("name", ["ppitc", "ppic", "picf"])
    def test_retire_is_idempotent_and_revive_noop_when_alive(self, prob,
                                                             name):
        store = _store(prob, name)
        assert store.revive(1) is store           # already alive
        dead = store.retire(1)
        assert dead is not store
        assert dead.retire(1) is dead             # already retired

    @pytest.mark.parametrize("name", ["ppitc", "ppic", "picf"])
    def test_out_of_range_machine_rejected(self, prob, name):
        """A bad id raises (a negative one would otherwise address a
        machine from the end)."""
        store = _store(prob, name)
        for machine in (prob["M"], -1, 10 ** 6):
            with pytest.raises(IndexError, match="out of range"):
                store.retire(machine)
            with pytest.raises(IndexError, match="out of range"):
                store.revive(machine)

    def test_all_alive_to_state_shares_block_buffers(self, prob):
        """Nothing retired: the emitted state holds the store's own block
        tensors, no copy."""
        store = _store(prob, "ppic")
        assert store.to_state().Xb is store.blocks.Xb
        picf_store = _store(prob, "picf")
        assert picf_store.to_state().Xb is picf_store.Xb

    @pytest.mark.parametrize("name", ["ppitc", "ppic"])
    def test_assimilate_equals_recompute(self, prob, name):
        """Stream half the data in: the state equals a cold fit of the
        concatenated data (the reference also round-trips it through its
        checkpoint format, ROADMAP item 7)."""
        p = prob
        n1 = p["X"].shape[0] // 2
        store = _store(p, name, X=p["X"][:n1], y=p["y"][:n1])
        state = store.assimilate(_t(p["X"][n1:]), _t(p["y"][n1:])).to_state()
        cold = api.get(name).fit(p["kfn"], p["params"], _t(p["X"]),
                                 _t(p["y"]), S=_t(p["S"]),
                                 runner=VmapRunner(M=2 * p["M"]))
        for f, a, b in zip(state._fields, state, cold):
            assert _err(a, b.numpy()) < 1e-9, f"{name}.{f}"

    def test_pic_centroids_refresh_on_stream_and_retire(self, prob):
        p = prob
        n1 = p["X"].shape[0] // 2
        store = _store(p, "ppic", X=p["X"][:n1], y=p["y"][:n1])
        M0 = store.to_state().centroids.shape[0]
        grown = store.assimilate(_t(p["X"][n1:]), _t(p["y"][n1:]))
        assert grown.to_state().centroids.shape[0] == 2 * M0
        shrunk = grown.retire(0).to_state()
        assert shrunk.centroids.shape[0] == 2 * M0 - 1
        assert torch.equal(shrunk.centroids, shrunk.Xb.mean(1))

    @pytest.mark.parametrize("name", ["ppic", "picf"])
    def test_wave_block_size_enforced(self, prob, name):
        p = prob
        store = _store(p, name)
        with pytest.raises(ValueError, match="block size"):
            store.assimilate(_t(p["X"][:12]), _t(p["y"][:12]))

    def test_pitc_waves_of_any_block_size(self, prob):
        """pPITC summaries are block-size-agnostic: a wave with another b
        pads the factor store and still matches the refold, and the
        reference's store."""
        p = prob
        store, jstore = _stores(p, "ppitc")
        X2 = np.random.default_rng(5).normal(size=(6, 3))
        y2 = np.sin(X2[:, 0])
        grown = store.assimilate(_t(X2), _t(y2), runner=VmapRunner(M=2))
        jgrown = jstore.assimilate(jnp.asarray(X2), jnp.asarray(y2),
                                   runner=JVmapRunner(M=2))
        assert grown.store.F.shape == (p["M"] + 2, 12, 24)
        ref = online.with_alive(grown.store, grown.store.alive,
                                mode="refold")
        assert _err(grown.store.Sdd_L, ref.Sdd_L.numpy()) < 1e-10
        assert _state_err(grown.to_state(), jgrown.to_state()) < STATE_TOL
        # a retire of the narrow wave's machine downdates by padded columns
        assert _state_err(grown.retire(p["M"]).to_state(),
                          jgrown.retire(p["M"]).to_state()) < STATE_TOL


# ---------------------------------------------------------------------------
# Every store against the reference's after each mutation
# ---------------------------------------------------------------------------

_PITC_STEPS = ("assimilate", "retire 2", "retire 5", "revive 2",
               "with_alive incremental", "with_alive refold", "reassign 5")
_OTHER_STEPS = ("assimilate", "retire 2", "retire 5", "revive 2",
                "revive 5")


def _mutate(p, store, step: str, jax_side: bool):
    arr = jnp.asarray if jax_side else _t
    kind, _, arg = step.partition(" ")
    if kind == "assimilate":
        return store.assimilate(arr(p["X2"]), arr(p["y2"]))
    if kind == "retire":
        return store.retire(int(arg))
    if kind == "revive":
        return store.revive(int(arg))
    if kind == "with_alive":
        mask = np.ones(2 * p["M"], bool)
        mask[[0, 5, 6]] = False
        if arg == "incremental":
            mask[0] = True                # one flip from the current mask
        return store.with_alive(arr(mask), mode=arg)
    b = p["X"].shape[0] // p["M"]           # reassign: a re-read block
    Xm = np.random.default_rng(9).normal(size=(b, 3))
    return store.reassign(int(arg), arr(Xm), arr(np.sin(Xm[:, 0])))


@pytest.mark.parametrize("name,steps", [
    ("ppitc", _PITC_STEPS), ("pitc", _PITC_STEPS), ("ppic", _OTHER_STEPS),
    ("pic", _OTHER_STEPS), ("picf", _OTHER_STEPS)])
def test_store_states_match_the_reference_after_each_mutation(prob, name,
                                                              steps):
    p = prob
    store, jstore = _stores(p, name)
    assert _state_err(store.to_state(), jstore.to_state()) < STATE_TOL
    for step in steps:
        store = _mutate(p, store, step, False)
        jstore = _mutate(p, jstore, step, True)
        assert _state_err(store.to_state(), jstore.to_state()) < STATE_TOL, \
            step
        alive = getattr(store, "store", store).alive
        jalive = np.array(getattr(jstore, "store", jstore).alive)
        assert np.array_equal(alive.numpy(), jalive), step


def test_pitc_store_surface_matches_the_reference(prob):
    """``global_summary`` and ``predict`` of a streamed, retired store."""
    p = prob
    store, jstore = _stores(p, "ppitc")
    store = store.assimilate(_t(p["X2"]), _t(p["y2"])).retire(3)
    jstore = jstore.assimilate(jnp.asarray(p["X2"]),
                               jnp.asarray(p["y2"])).retire(3)
    assert store.num_machines == jstore.num_machines == 2 * p["M"]
    for a, b in zip(store.global_summary(), jstore.global_summary()):
        assert _err(a, b) < STATE_TOL
    for a, b in zip(store.predict(_t(p["U"])),
                    jstore.predict(jnp.asarray(p["U"]))):
        assert _err(a, b) < STATE_TOL
    mean, covm = online.predict_ppitc(store.store, p["kfn"], p["params"],
                                      _t(p["S"]), _t(p["U"]))
    jmean, _ = jonline.predict_ppitc(jstore.store, p["jkfn"], p["jparams"],
                                     jnp.asarray(p["S"]), jnp.asarray(p["U"]))
    assert _err(mean, jmean) < STATE_TOL and covm.shape == (24, 24)


# ---------------------------------------------------------------------------
# pICF row-append / retire on the distributed factor
# ---------------------------------------------------------------------------

class TestPICFStore:
    def test_append_extends_factor_in_pivot_basis(self, prob):
        """Streamed factor columns are the forward solve Lp f = k(P, x),
        bit for bit as the port computes it and within 1e-10 of the
        reference's; the streamed Phi_L matches a refactorization of the
        extended factor to 1e-5."""
        p = prob
        store, jstore = _stores(p, "picf")
        grown = store.assimilate(_t(p["X2"]), _t(p["y2"]))
        jgrown = jstore.assimilate(jnp.asarray(p["X2"]), jnp.asarray(p["y2"]))
        Xb2 = VmapRunner(M=p["M"]).shard_blocks(_t(p["X2"]))
        F_ref = linalg.tri_solve(store.Lp, p["kfn"](p["params"], store.Xp,
                                                    Xb2))
        assert torch.equal(grown.F[p["M"]:], F_ref)
        assert _err(grown.F, jgrown.F) < STATE_TOL
        s2 = cov.noise_var(p["params"])
        Phi = torch.eye(R, dtype=torch.float64) + torch.einsum(
            "mrb,msb->rs", grown.F, grown.F) / s2
        assert _err(grown.Phi_L, torch.linalg.cholesky(Phi).numpy()) < 1e-5
        assert _state_err(grown.to_state(), jgrown.to_state()) < STATE_TOL

    def test_retire_appended_restores_original(self, prob):
        p = prob
        store = _store(p, "picf")
        grown = store.assimilate(_t(p["X2"]), _t(np.sin(p["X2"][:, 1])))
        for m in range(p["M"], 2 * p["M"]):
            grown = grown.retire(m)
        s0, s1 = store.to_state(), grown.to_state()
        assert _err(s1.Phi_L, s0.Phi_L.numpy()) < 1e-10
        assert _err(s1.ydd, s0.ydd.numpy()) < 1e-10
        assert torch.equal(s1.Xb, s0.Xb)

    def test_streamed_predictions_finite_and_match_the_reference(self,
                                                                  prob):
        p = prob
        store, jstore = _stores(p, "picf")
        Xs = p["X"] + 0.01 * np.random.default_rng(9).normal(
            size=p["X"].shape)
        grown = store.assimilate(_t(Xs), _t(p["y"])).retire(1)
        jgrown = jstore.assimilate(jnp.asarray(Xs),
                                   jnp.asarray(p["y"])).retire(1)
        mean, var = picf.predict_batch_diag(p["kfn"], p["params"],
                                            grown.to_state(), _t(p["U"]))
        jmean, jvar = jpicf.predict_batch_diag(
            p["jkfn"], p["jparams"], jgrown.to_state(), jnp.asarray(p["U"]))
        assert bool(torch.isfinite(mean).all() and torch.isfinite(var).all())
        assert _err(mean, jmean) < STATE_TOL and _err(var, jvar) < STATE_TOL


# ---------------------------------------------------------------------------
# float32: where the port leaves the reference's form (ROADMAP §3)
# ---------------------------------------------------------------------------

def _f32(p):
    return {k: v.to(torch.float32) for k, v in p["params"].items()}


def _store_f32(p, name="ppitc"):
    return api.init_store(name, p["kfn"], _f32(p), _t(p["X"]).float(),
                          _t(p["y"]).float(), S=_t(p["S"]).float(),
                          runner=VmapRunner(M=4), device="cpu")


def _spy_downdates(monkeypatch):
    """Record the dtype of every downdate the stores run, and count the
    refolds of the alive root (``online._sdd_chol``)."""
    seen = {"downdates": [], "refolds": 0}
    downdate, sdd_chol = linalg_ops.chol_downdate, online._sdd_chol

    def spy_downdate(L, W):
        seen["downdates"].append(L.dtype)
        return downdate(L, W)

    def spy_sdd_chol(Kss_L, F, axis=None):
        seen["refolds"] += 1
        return sdd_chol(Kss_L, F, axis)

    monkeypatch.setattr(linalg_ops, "chol_downdate", spy_downdate)
    monkeypatch.setattr(online, "_sdd_chol", spy_sdd_chol)
    return seen


@pytest.mark.parametrize("name", ["ppitc", "ppic"])
def test_float32_retire_downdates_in_float64(prob, monkeypatch, name):
    """A float32 store retires by one downdate run in float64 (the
    reference's float32 downdate drifts at the paper's scale, ROADMAP §3)
    and keeps its factor in float32: equal to the float64 downdate of the
    same factor rounded to float32, bit for bit; no refold."""
    p = prob
    store = _store_f32(p, name)
    seen = _spy_downdates(monkeypatch)
    dead = store.retire(2)
    assert seen == {"downdates": [torch.float64], "refolds": 0}
    assert dead.store.Sdd_L.dtype == torch.float32
    want = linalg_ref.chol_downdate(store.store.Sdd_L.double(),
                                    store.store.F[2].double()).float()
    assert torch.equal(dead.store.Sdd_L, want)
    # the global factors the retire touched: the float64 store's, to
    # float32's digits
    dead64 = _store(p, name).retire(2)
    for a, b in zip(online.to_state(dead.store, dead.S),
                    online.to_state(dead64.store, dead64.S)):
        assert _err(a.double(), b.numpy()) < 1e-4 * (1 + float(b.abs().max()))


def test_float32_with_alive_incremental_takes_no_refold(prob, monkeypatch):
    """``with_alive(mode="incremental")`` of a float32 store missing
    several machines is one float64 downdate a retired machine and one
    update a revived one, never a refold of the root; it agrees with the
    refold to float32's digits."""
    p = prob
    store = _store_f32(p).assimilate(_t(p["X2"]).float(),
                                     _t(p["y2"]).float())
    store = store.retire(6)
    mask = torch.ones(8, dtype=torch.bool)
    mask[[1, 2, 5]] = False                 # retire 1, 2, 5; revive 6
    seen = _spy_downdates(monkeypatch)
    view = store.with_alive(mask, mode="incremental")
    assert seen == {"downdates": [torch.float64] * 3, "refolds": 0}
    ref = store.with_alive(mask, mode="refold")
    assert seen["refolds"] == 1
    assert torch.equal(view.alive, ref.alive)
    for a, b in zip(view.to_state(), ref.to_state()):
        assert _err(a, b.numpy()) < 1e-4 * (1 + float(b.abs().max()))


def test_picf_rspace_is_float64_for_float32_data(prob):
    """pICF keeps Phi_L, yF and ydd in float64 for float32 data, serves
    its sums in float64 and returns the queries' dtype; the float32 factor
    is that of a float32 ICF. A state whose Phi_L is float32 (the
    reference's) is served in float32."""
    p = prob
    store = api.init_store("picf", p["kfn"], _f32(p), _t(p["X"]).float(),
                           _t(p["y"]).float(), rank=R,
                           runner=VmapRunner(M=4), device="cpu")
    assert store.F.dtype == torch.float32
    assert store.Phi_L.dtype == store.yF.dtype == torch.float64
    grown = store.assimilate(_t(p["X2"]).float(), _t(p["y2"]).float())
    dead = grown.retire(1)
    assert dead.Phi_L.dtype == torch.float64
    st = dead.to_state()
    assert st.F.dtype == st.Phi_L.dtype == st.ydd.dtype == torch.float64
    U = _t(p["U"]).float()
    mean, var = picf.predict_batch_diag(p["kfn"], _f32(p), st, U)
    assert mean.dtype == var.dtype == torch.float32
    # the same state, everything in float64: only K_UD's rounding apart
    st64 = type(st)(st.Xb.double(), st.yb.double(), st.F, st.Phi_L, st.ydd)
    m64, v64 = picf.predict_batch_diag(p["kfn"], p["params"], st64,
                                       U.double())
    assert _err(mean.double(), m64.numpy()) < 1e-4
    assert _err(var.double(), v64.numpy()) < 1e-4
    # Phi_L against the refold of the survivors' root, in float64
    keep = [0, 2, 3, 4, 5, 6, 7]
    eye = torch.eye(R, dtype=torch.float64)
    ref = linalg.chol_from_root(eye, grown.F[keep].double()
                                / cov.noise_var(_f32(p)).double().sqrt())
    assert _err(dead.Phi_L, ref.numpy()) < 1e-10
    # a float32 R-space (the reference's form) is served in float32
    st32 = type(st)(st.Xb, st.yb, st.F.float(), st.Phi_L.float(),
                    st.ydd.float())
    m32, _ = picf.predict_batch_diag(p["kfn"], _f32(p), st32, U)
    assert m32.dtype == torch.float32
    assert _err(m32.double(), m64.numpy()) < 1e-2
