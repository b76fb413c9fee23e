"""The end-to-end entry points that the reference's examples and benchmarks
call (``linalg.psd_inv``, ``gp.predict`` with and without a prior mean,
``ppitc.predict`` and ``ppitc.predict_from_summary``) against the JAX
package, in float64 on the CPU, within ROADMAP's 1e-10. Inputs are made
with numpy from a seed and fed to both packages."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import covariance as jcov, gp as jgp, linalg as jlinalg, \
    ppitc as jppitc
from repro.parallel.runner import VmapRunner as JVmapRunner
from repro_torch import convert
from repro_torch.core import covariance as cov, gp, linalg, ppitc
from repro_torch.parallel.runner import VmapRunner

TOL = 1e-10


def _t(a):
    return torch.tensor(np.asarray(a))


def _err(got, want) -> float:
    return float(np.abs(got.numpy() - np.asarray(want)).max())


@pytest.fixture(scope="module")
def prob():
    rng = np.random.default_rng(5)
    n, u, s, d, M = 96, 24, 12, 3, 4
    X, S, U = (rng.normal(size=(k, d)) for k in (n, s, u))
    y = np.sin(X[:, 0]) * 2.0 + X[:, 1] - 0.5 * X[:, 2] ** 2 \
        + 0.3 * rng.normal(size=n)
    jparams = jcov.init_params(d, signal=1.3, noise=0.3, lengthscale=1.5,
                               dtype=jnp.float64)
    return dict(X=X, y=y, S=S, U=U, M=M, jparams=jparams,
                params=convert.params_from_arrays(jparams, device="cpu"))


@pytest.mark.parametrize("batch", [(), (3,)])
@pytest.mark.parametrize("jitter", [None, 1e-3])
def test_psd_inv_matches_reference(batch, jitter):
    rng = np.random.default_rng(1)
    A = rng.normal(size=batch + (10, 10))
    K = A @ np.swapaxes(A, -1, -2) + 0.1 * np.eye(10)
    got = linalg.psd_inv(_t(K), jitter)
    if batch:
        want = np.stack([np.asarray(jlinalg.psd_inv(jnp.asarray(k), jitter))
                         for k in K])
    else:
        want = jlinalg.psd_inv(jnp.asarray(K), jitter)
    assert got.shape == K.shape
    assert _err(got, want) < TOL * float(np.abs(np.asarray(want)).max())


@pytest.mark.parametrize("diag_only", [False, True])
@pytest.mark.parametrize("with_mean", [False, True])
def test_gp_predict_matches_reference(prob, diag_only, with_mean):
    """Without a prior mean: fit + predict_batch; with one: the inline
    path, mean_fn evaluated at the training and the test inputs."""
    X, y, U = prob["X"], prob["y"], prob["U"]
    w = np.array([0.5, -1.0, 0.25])
    mean_fn = (lambda Z: Z @ _t(w) + 0.3) if with_mean else None
    jmean_fn = (lambda Z: Z @ jnp.asarray(w) + 0.3) if with_mean else None
    got = gp.predict(cov.make_kernel("se"), prob["params"], _t(X), _t(y),
                     _t(U), mean_fn, diag_only=diag_only)
    want = jgp.predict(jcov.make_kernel("se"), prob["jparams"],
                       jnp.asarray(X), jnp.asarray(y), jnp.asarray(U),
                       jmean_fn, diag_only=diag_only)
    assert _err(got.mean, want.mean) < TOL
    assert _err(got.cov, want.cov) < TOL
    assert _err(got.var, want.var) < TOL


def test_gp_nlml_takes_a_prior_mean(prob):
    X, y = prob["X"], prob["y"]
    got = gp.nlml(cov.make_kernel("se"), prob["params"], _t(X), _t(y),
                  mean_fn=lambda Z: Z[:, 0])
    want = jgp.nlml(jcov.make_kernel("se"), prob["jparams"], jnp.asarray(X),
                    jnp.asarray(y), mean_fn=lambda Z: Z[:, 0])
    np.testing.assert_allclose(float(got), float(want), rtol=1e-12)


def test_ppitc_predict_matches_reference(prob):
    post = ppitc.predict(cov.make_kernel("se"), prob["params"], _t(prob["S"]),
                         _t(prob["X"]), _t(prob["y"]), _t(prob["U"]),
                         VmapRunner(M=prob["M"]))
    want = jppitc.predict(jcov.make_kernel("se"), prob["jparams"],
                          jnp.asarray(prob["S"]), jnp.asarray(prob["X"]),
                          jnp.asarray(prob["y"]), jnp.asarray(prob["U"]),
                          JVmapRunner(M=prob["M"]))
    assert post.blocks.shape == (prob["M"], 6, 6)
    for a, b in ((post.mean, want.mean), (post.blocks, want.blocks),
                 (post.var, want.var)):
        assert _err(a, b) < TOL


def test_ppitc_predict_from_summary_matches_reference(prob):
    """The global summary's posterior (the reference's form: Sdd formed
    and factored by Cholesky) over one machine's queries."""
    kfn, jkfn = cov.make_kernel("se"), jcov.make_kernel("se")
    S, X, y, U = (_t(prob[k]) for k in ("S", "X", "y", "U"))
    _, glob = ppitc.summaries(kfn, prob["params"], S, X, y,
                              VmapRunner(M=prob["M"]))
    _, jglob = jppitc.summaries(jkfn, prob["jparams"], jnp.asarray(prob["S"]),
                                jnp.asarray(prob["X"]),
                                jnp.asarray(prob["y"]),
                                JVmapRunner(M=prob["M"]))
    Kss_L = linalg.chol(kfn(prob["params"], S, S))
    jKss_L = jlinalg.chol(jkfn(prob["jparams"], jnp.asarray(prob["S"]),
                               jnp.asarray(prob["S"])))
    mean, covm = ppitc.predict_from_summary(kfn, prob["params"], S, Kss_L,
                                            glob, U[:6])
    jmean, jcovm = jppitc.predict_from_summary(
        jkfn, prob["jparams"], jnp.asarray(prob["S"]), jKss_L, jglob,
        jnp.asarray(prob["U"][:6]))
    assert _err(mean, jmean) < TOL and _err(covm, jcovm) < TOL
