"""The ICF pivot loop of ``select_support`` on the CPU: the plain version
of the ICF kernel (``repro_torch.kernels.rbf.ref.icf_factor``) against the
JAX package's ``icf_factor`` in float64, the rule that sends a call to the
kernel (``icf.uses_kernel``), and the wrapper's plain path. Inputs are made
with numpy from a seed and fed to both packages. The kernel itself is held
against the plain version on the card (``tests/test_torch_cuda.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import covariance as jcov, icf as jicf
from repro_torch import convert
from repro_torch.core import covariance as cov, icf
from repro_torch.kernels.rbf import ops, ref

# (n, R, d): a small case, a ragged one (n and d off any tile), and 40
# distinct points each present twice (rows j and j + 40), whose exact ties
# test the first-max rule
ICF_CASES = [(64, 20, 3), (1000, 120, 7), ("duplicates", 30, 3)]


def _inputs(n, d, seed):
    rng = np.random.default_rng(seed)
    if n == "duplicates":
        P = rng.normal(size=(40, d))
        return np.concatenate([P, P])
    return rng.uniform(-2.0, 2.0, size=(n, d))


def _problem(n, d, seed=0):
    """Candidates, the JAX params, and the port's scaled inputs and sig2."""
    X = _inputs(n, d, seed)
    jparams = jcov.init_params(d, signal=1.3, noise=0.3, lengthscale=1.5,
                               dtype=jnp.float64)
    params = convert.params_from_arrays(jparams, device="cpu")
    Xs = cov._scale(params, torch.tensor(X))
    return X, jparams, params, Xs, cov.signal_var(params)


@pytest.mark.parametrize("n,R,d", ICF_CASES)
def test_plain_icf_matches_the_reference(n, R, d):
    X, jparams, _, Xs, sig2 = _problem(n, d)
    F, piv, resid = ref.icf_factor(Xs, sig2, R)
    want = jicf.icf_factor(jcov.make_spec("se"), jparams, jnp.asarray(X), R)
    assert F.dtype == torch.float64 and F.shape == (R, X.shape[0])
    assert piv.dtype == torch.long
    assert piv.tolist() == np.asarray(want.pivots).tolist()
    assert np.abs(F.numpy() - np.asarray(want.F)).max() < 1e-10
    assert np.abs(resid.numpy() - np.asarray(want.residual)).max() < 1e-10


def test_duplicates_take_the_first_of_a_tie():
    """Of two equal candidates the lower index is chosen, and its twin's
    residual drops to (nearly) zero, so it is never chosen after it."""
    _, _, _, Xs, sig2 = _problem("duplicates", 3)
    _, piv, resid = ref.icf_factor(Xs, sig2, 30)
    assert piv[0] == 0
    assert all(p < 40 for p in piv.tolist())
    assert float(resid[piv + 40].abs().max()) < 1e-10


@pytest.mark.parametrize("n,R,d", ICF_CASES[:2])
def test_step_loop_matches_the_plain_icf(n, R, d):
    """``icf.icf_factor``'s generic loop (CPU tensors, a KernelSpec) and the
    kernel's plain version agree: same pivots, factors to rounding."""
    X, _, params, Xs, sig2 = _problem(n, d, seed=1)
    got = icf.icf_factor(cov.make_spec("se"), params, torch.tensor(X), R)
    F, piv, resid = ref.icf_factor(Xs, sig2, R)
    assert torch.equal(got.pivots, piv)
    assert float((got.F - F).abs().max()) < 1e-10
    assert float((got.residual - resid).abs().max()) < 1e-10


def test_replay_along_given_pivots_and_its_slack():
    """``pivots=`` replays a pivot order: along the loop's own it gives the
    same bits and zero slack; along another order, each step's slack is
    how far its pivot's residual fell below the largest."""
    _, _, _, Xs, sig2 = _problem(1000, 7)
    F, piv, resid = ref.icf_factor(Xs, sig2, 40)
    again = ref.icf_factor(Xs, sig2, 40, pivots=piv)
    assert all(torch.equal(a, b) for a, b in zip(again, (F, piv, resid)))
    assert float(ref.icf_slack(F, piv, sig2).abs().max()) == 0.0
    other = piv.clone()
    other[5] = int(torch.argsort(resid)[-1])    # not the largest at step 5
    Fo, _, _ = ref.icf_factor(Xs, sig2, 40, pivots=other)
    slack = ref.icf_slack(Fo, other, sig2)
    assert float(slack[:5].abs().max()) == 0.0 and float(slack[5]) > 0.0


_CUDA = torch.device("cuda")
_CPU = torch.device("cpu")


@pytest.mark.parametrize("kfn,device,dtype,want", [
    (cov.make_spec("se"), _CUDA, torch.float32, True),
    (cov.make_spec("se"), _CUDA, torch.float64, True),
    (cov.make_spec("se_pallas"), _CUDA, torch.float32, True),
    (cov.make_spec("se", impl="cuda"), _CUDA, torch.float32, True),
    (cov.make_spec("se", impl="pallas"), _CUDA, torch.float64, True),
    (cov.se_ard_kernel, _CUDA, torch.float32, True),
    (cov.make_kernel("se_pallas"), _CUDA, torch.float64, True),
    (cov.make_spec("se"), _CPU, torch.float32, False),
    (cov.make_spec("se"), _CPU, torch.float64, False),
    (cov.se_ard_kernel, _CPU, torch.float64, False),
    (cov.make_spec("se", impl="torch"), _CUDA, torch.float32, False),
    (cov.make_spec("se", impl="jnp"), _CUDA, torch.float32, False),
    (cov.make_spec("matern52"), _CUDA, torch.float32, False),
    (cov.make_spec("rq"), _CUDA, torch.float32, False),
    (cov.make_kernel("matern52"), _CUDA, torch.float32, False),
    (cov.make_kernel("se"), _CUDA, torch.float32, False),
    (cov.make_spec("se"), _CUDA, torch.bfloat16, False),
    (cov.se_ard_kernel, _CUDA, torch.bfloat16, False),
    (cov.make_spec("se"), _CUDA, torch.float16, False),
])
def test_uses_kernel_only_for_the_se_family_on_the_card(kfn, device, dtype,
                                                        want):
    """Decided from the spec, the device and the dtype alone: nothing is
    allocated on a card (there is none here)."""
    assert icf.uses_kernel(kfn, device, dtype) is want


@pytest.mark.parametrize("n,R,d", ICF_CASES[:2])
def test_pivot_values_are_each_steps_largest_residual(n, R, d):
    """``pivot_values``: d_p of step i is the largest residual before the
    step (the loop's d replayed with its own operations, bit for bit), the
    same from the kernel's plain version and the generic loop, and
    F[i, p_i] = sqrt(d_p) to rounding."""
    X, _, params, Xs, sig2 = _problem(n, d, seed=4)
    F, piv, resid, dp = ref.icf_factor(Xs, sig2, R, pivot_values=True)
    assert all(torch.equal(a, b) for a, b in
               zip((F, piv, resid), ref.icf_factor(Xs, sig2, R)))
    dd = torch.as_tensor(sig2, dtype=F.dtype).expand(F.shape[1]).clone()
    for i in range(R):
        assert dp[i] == dd.max() == dd[piv[i]]
        dd = torch.clamp(dd - F[i] * F[i], min=0.0)
        dd[piv[i]] = 0.0
    fac, dp2 = icf.icf_factor(cov.make_spec("se"), params, torch.tensor(X),
                              R, pivot_values=True)
    assert torch.equal(fac.pivots, piv)
    assert float((dp2 - dp).abs().max()) < 1e-10
    fpp = F[torch.arange(R), piv]
    assert float((fpp * fpp - dp).abs().max()) < 1e-10
    got = ops.icf_factor(Xs, sig2, R, pivot_values=True)
    assert len(got) == 4 and torch.equal(got[3], dp)


def test_cpu_wrapper_takes_the_plain_path_and_counts_nothing():
    _, _, _, Xs, sig2 = _problem(64, 3)
    ops.icf_launches = 5
    ops.reset_counts()
    assert ops.icf_launches == 0
    F, piv, resid = ops.icf_factor(Xs, sig2, 12)
    want = ref.icf_factor(Xs, sig2, 12)
    assert torch.equal(F, want[0]) and torch.equal(piv, want[1])
    assert torch.equal(resid, want[2])
    assert (ops.icf_launches, ops.rbf_launches) == (0, 0)


def test_select_support_on_the_cpu_launches_no_kernel():
    X, _, params, _, _ = _problem(64, 3, seed=2)
    from repro_torch.core import support
    ops.reset_counts()
    S = support.select_support(cov.make_spec("se"), params, torch.tensor(X),
                               10, device="cpu")
    assert S.shape == (10, 3)
    assert (ops.icf_launches, ops.rbf_launches) == (0, 0)
