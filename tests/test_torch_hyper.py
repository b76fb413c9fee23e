"""The port's hyperparameter MLE (``core/hyper.py``) and its optimizer
(``optim/adam.py``) against the JAX package, in float64 on the CPU.

Likelihood values are held to rtol 1e-8: the reference's own
``test_pitc_nlml_equals_literal_centralized_float64`` holds its PITC
likelihood to the dense Gaussian log-density at 1e-9 and flakes at 8.8e-9
(ROADMAP §3, reference-side caveats), so 1e-9 is below what the float64
sums of either package reproduce. Gradients are held to ``jax.grad`` at
rtol 1e-8, Adam's updates at 1e-12. Inputs are made with numpy from a
seed and fed to both packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import covariance as jcov, gp as jgp, hyper as jhyper, \
    linalg as jlinalg
from repro.optim import adam as jadam
from repro.parallel.runner import VmapRunner as JVmapRunner
from repro_torch import convert
from repro_torch.core import covariance as cov, gp, hyper, linalg
from repro_torch.kernels import build
from repro_torch.kernels.rbf import ops
from repro_torch.optim import adam
from repro_torch.parallel.runner import VmapRunner

RTOL = 1e-8


def _t(a):
    return torch.tensor(np.asarray(a))


def _problem(n=96, s=12, d=3, M=4, seed=0):
    rng = np.random.default_rng(seed)
    X, S = rng.normal(size=(n, d)), rng.normal(size=(s, d))
    y = np.sin(X[:, 0]) * 2.0 + X[:, 1] - 0.5 * X[:, 2] ** 2 \
        + 0.3 * rng.normal(size=n)
    jparams = jcov.init_params(d, signal=1.3, noise=0.3, lengthscale=1.5,
                               dtype=jnp.float64)
    params = convert.params_from_arrays(jparams, device="cpu")
    return dict(X=X, y=y, S=S, M=M, jparams=jparams, params=params)


@pytest.fixture(scope="module")
def prob():
    return _problem()


def _pitc(p, params=None):
    return hyper.pitc_nlml(cov.make_kernel("se"), params or p["params"],
                           _t(p["S"]), _t(p["X"]), _t(p["y"]),
                           VmapRunner(M=p["M"]))


def _jpitc(p, jparams=None):
    return jhyper.pitc_nlml(jcov.make_kernel("se"), jparams or p["jparams"],
                            jnp.asarray(p["S"]), jnp.asarray(p["X"]),
                            jnp.asarray(p["y"]), JVmapRunner(M=p["M"]))


def test_pitc_nlml_matches_reference(prob):
    got, want = float(_pitc(prob)), float(_jpitc(prob))
    np.testing.assert_allclose(got, want, rtol=RTOL)


def test_pitc_nlml_equals_the_dense_gaussian_log_density():
    """-log N(y; 0, Gamma + Lambda) formed literally: Gamma = K_DS K_SS⁻¹
    K_SD, Lambda the block-diagonal of K_DD + noise - Gamma."""
    p = _problem(n=24, s=6, M=3)
    X, S, y = _t(p["X"]), _t(p["S"]), _t(p["y"])
    kfn, params = cov.make_kernel("se"), p["params"]
    Kss_L = linalg.chol(kfn(params, S, S))
    Kds = kfn(params, X, S)
    Gamma = Kds @ linalg.chol_solve(Kss_L, Kds.T)
    Sig = cov.add_noise(kfn(params, X, X), params) - Gamma
    n, b = X.shape[0], X.shape[0] // p["M"]
    Cov = Gamma.clone()
    for m in range(p["M"]):
        sl = slice(m * b, (m + 1) * b)
        Cov[sl, sl] += Sig[sl, sl]
    dense = -torch.distributions.MultivariateNormal(
        torch.zeros(n, dtype=torch.float64), Cov).log_prob(y)
    np.testing.assert_allclose(float(_pitc(p)), float(dense), rtol=RTOL)


def _grads_torch(fn, params):
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    g = torch.autograd.grad(fn(leaves), list(leaves.values()))
    return dict(zip(leaves, g))


@pytest.mark.parametrize("objective", ["nlml", "pitc_nlml"])
def test_gradients_match_jax_grad(prob, objective):
    X, y = prob["X"], prob["y"]
    if objective == "nlml":
        fn = lambda p: gp.nlml(cov.make_kernel("se"), p, _t(X), _t(y))
        jfn = lambda p: jgp.nlml(jcov.make_kernel("se"), p, jnp.asarray(X),
                                 jnp.asarray(y))
    else:
        fn = lambda p: _pitc(prob, p)
        jfn = lambda p: _jpitc(prob, p)
    got = _grads_torch(fn, prob["params"])
    want = jax.grad(jfn)(prob["jparams"])
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=RTOL, atol=1e-12)


def test_fit_loss_trajectory_matches_reference(prob):
    p0 = jcov.init_params(3, signal=0.5, noise=0.5, lengthscale=3.0,
                          dtype=jnp.float64)
    jfinal, jlosses = jhyper.fit(jcov.make_kernel("se"), p0,
                                 jnp.asarray(prob["X"]),
                                 jnp.asarray(prob["y"]), steps=10, lr=0.08)
    final, losses = hyper.fit(cov.make_kernel("se"),
                              convert.params_from_arrays(p0, device="cpu"),
                              _t(prob["X"]), _t(prob["y"]), steps=10,
                              lr=0.08)
    assert losses.shape == (10,) and float(losses[-1]) < float(losses[0])
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses),
                               rtol=RTOL)
    for k in final:
        np.testing.assert_allclose(final[k].numpy(), np.asarray(jfinal[k]),
                                   rtol=RTOL)
        assert not final[k].requires_grad


def test_fit_parallel_loss_trajectory_matches_reference(prob):
    p0 = jcov.init_params(3, signal=0.5, noise=0.5, lengthscale=3.0,
                          dtype=jnp.float64)
    _, jlosses = jhyper.fit_parallel(
        jcov.make_kernel("se"), p0, jnp.asarray(prob["S"]),
        jnp.asarray(prob["X"]), jnp.asarray(prob["y"]),
        JVmapRunner(M=prob["M"]), steps=10, lr=0.08)
    _, losses = hyper.fit_parallel(
        cov.make_kernel("se"), convert.params_from_arrays(p0, device="cpu"),
        _t(prob["S"]), _t(prob["X"]), _t(prob["y"]),
        VmapRunner(M=prob["M"]), steps=10, lr=0.08)
    assert float(losses[-1]) < float(losses[0])
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses),
                               rtol=RTOL)


def test_fit_without_data_or_objective_raises():
    params = cov.init_params(2, device="cpu")
    with pytest.raises(ValueError, match="needs \\(X, y\\)"):
        hyper.fit(cov.make_kernel("se"), params, steps=1)


def test_refuse_grad_rule():
    """The rule the CUDA wrappers apply before a launch: raise in grad mode
    when an input requires grad (the kernels have no backward), naming the
    plain kernel; nothing under no_grad or with no such input; non-tensor
    arguments (a Python-float sig2) are ignored."""
    x = torch.zeros(3, requires_grad=True)
    with pytest.raises(RuntimeError, match="make_kernel\\('se'\\)"):
        ops.refuse_grad("rbf_covariance", torch.zeros(3), x, 1.3)
    with torch.no_grad():
        ops.refuse_grad("rbf_covariance", x)
    ops.refuse_grad("rbf_covariance", torch.zeros(3), 1.3)


@pytest.mark.parametrize("call", [
    lambda x, s2: ops.rbf_covariance(x, x, s2),
    lambda x, s2: ops.icf_factor(x, s2, 4),
    lambda x, s2: ops.xcov_diag(x, x, torch.eye(8), torch.zeros(8), s2),
])
def test_kernel_path_refuses_a_graph_before_launching(monkeypatch, call):
    """Each wrapper checks before it touches a card: with its tensors taken
    for CUDA ones (no card here), a signal variance that requires grad is
    refused, where the kernel would return a tensor cut from the graph."""
    monkeypatch.setattr(build, "on_cpu", lambda *t: False)
    x = torch.zeros(8, 2)
    s2 = torch.tensor(1.3, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        call(x, s2)


def test_mle_objectives_keep_every_gradient_on_the_plain_kernel(prob):
    """The plain "se" kernel carries dK/dθ: every hyperparameter of the
    PITC likelihood gets a nonzero gradient."""
    g = _grads_torch(lambda p: _pitc(prob, p), prob["params"])
    assert all(bool((v != 0).all()) for v in g.values())


def _ill_conditioned():
    """K_SS with eigenvalues 1e-3..1 and G_m of entries ~1e3 along one
    direction: Sdd = K_SS + Σ G_mᵀ G_m, even with the reference's jitter
    of 1e-6 x its mean diagonal, has cond ~6e7, past what a float32
    Cholesky survives (as Sdd is at the paper's |S| = 2048)."""
    rng = np.random.default_rng(0)
    s, M, b = 64, 2, 8
    Q, _ = np.linalg.qr(rng.normal(size=(s, s)))
    Kss = (Q * np.logspace(-3, 0, s)) @ Q.T
    v = rng.normal(size=s)
    v /= np.linalg.norm(v)
    G = rng.normal(size=(M, b, 1)) * 1e3 * v + rng.normal(size=(M, b, s))
    return Kss, G


def test_square_root_factor_is_the_references_cholesky():
    """The factor from the stacked square root's QR is chol(Kss + Sdot)
    with the reference's jitter (default_jitter x mean diag of the sum),
    in float64."""
    Kss, G = _ill_conditioned()
    Sdd = Kss + np.einsum("mbs,mbt->st", G, G)
    L = hyper._sdd_chol(_t(Kss), _t(G))
    want = np.asarray(jlinalg.chol(jnp.asarray(Sdd)))
    assert np.abs(L.numpy() - want).max() < 1e-10 * np.abs(want).max()
    assert torch.equal(L, L.tril())


def test_square_root_factor_survives_float32():
    """Where the reference's float32 Cholesky of the formed Sdd gives NaN,
    the square root's factor stays finite and factors the same matrix:
    L Lᵀ reproduces Sdd + jI (the reference's jitter) to float32 rounding
    of its largest entry. Its trailing entries, those of Sdd's smallest
    eigenvalues, carry cond(A) x eps x |A| of error, as any float32
    factor of this matrix does."""
    Kss, G = _ill_conditioned()
    Sdd = Kss + np.einsum("mbs,mbt->st", G, G)
    jL = jlinalg.chol(jnp.asarray(Sdd, jnp.float32))
    assert not np.isfinite(np.asarray(jL)).all()
    L = hyper._sdd_chol(_t(Kss).float(), _t(G).float())
    assert bool(torch.isfinite(L).all())
    want = Sdd + 1e-6 * np.diag(Sdd).mean() * np.eye(Sdd.shape[0])
    L64 = L.double().numpy()
    assert np.abs(L64 @ L64.T - want).max() < 1e-5 * np.abs(want).max()


# ---------------------------------------------------------------------------
# optim/adam.py
# ---------------------------------------------------------------------------

def _adam_inputs(seed=0):
    rng = np.random.default_rng(seed)
    params = {"a": rng.normal(size=(3,)), "b": {"c": rng.normal(size=())}}
    grads = [{"a": rng.normal(size=(3,)), "b": {"c": rng.normal(size=())}}
             for _ in range(5)]
    return params, grads


def _tt(tree):
    return adam.tree_map(lambda a: _t(a), tree)


@pytest.mark.parametrize("kw", [dict(lr=0.05), dict(lr=0.01, clip_norm=0.5),
                                dict(lr=0.02, weight_decay=0.1)])
def test_adam_updates_match_reference(kw):
    params, grads = _adam_inputs()
    jopt, opt = jadam.Adam(**kw), adam.Adam(**kw)
    jp = jax.tree.map(jnp.asarray, params)
    p = _tt(params)
    jst, st = jopt.init(jp), opt.init(p)
    for g in grads:
        jp, jst = jopt.update(jax.tree.map(jnp.asarray, g), jst, jp)
        p, st = opt.update(_tt(g), st, p)
    assert int(st.step) == int(jst.step) == len(grads)
    assert st.step.dtype == torch.int32
    for got, want in zip(adam.tree_leaves(p), jax.tree.leaves(jp)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12)
    for got, want in zip(adam.tree_leaves(st.nu), jax.tree.leaves(jst.nu)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12)


def test_adam_state_carried_across_continues_alike():
    params, grads = _adam_inputs(1)
    jopt, opt = jadam.Adam(lr=0.05), adam.Adam(lr=0.05)
    jp = jax.tree.map(jnp.asarray, params)
    jst = jopt.init(jp)
    for g in grads[:3]:
        jp, jst = jopt.update(jax.tree.map(jnp.asarray, g), jst, jp)
    st = convert.adam_state_from_arrays(
        jax.tree.map(np.asarray, jst), device="cpu")
    p = adam.tree_map(lambda a: _t(a), jax.tree.map(np.asarray, jp))
    for g in grads[3:]:
        jp, jst = jopt.update(jax.tree.map(jnp.asarray, g), jst, jp)
        p, st = opt.update(_tt(g), st, p)
    for got, want in zip(adam.tree_leaves(p), jax.tree.leaves(jp)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12)
    with pytest.raises(TypeError, match="AdamState"):
        convert.adam_state_from_arrays(params, device="cpu")


def test_global_norm_and_cosine_schedule_match_reference():
    params, _ = _adam_inputs(2)
    got = adam.global_norm(_tt(params))
    want = jadam.global_norm(jax.tree.map(jnp.asarray, params))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    lr, jlr = adam.cosine_schedule(0.1, 10, 100, 0.01), \
        jadam.cosine_schedule(0.1, 10, 100, 0.01)
    for step in (0, 5, 10, 55, 100, 150):
        np.testing.assert_allclose(
            float(lr(torch.tensor(step, dtype=torch.int32))),
            float(jlr(jnp.asarray(step, jnp.int32))), rtol=1e-6)
