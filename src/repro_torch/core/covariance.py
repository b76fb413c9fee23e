"""Covariance (kernel) functions for GP regression — port of
``repro.core.covariance``.

A kernel is a function ``k(params, X1, X2) -> (..., n1, n2)`` over the
*signal* part only; observation noise sigma_n^2 * I is added explicitly where
the paper's equations call for it, so cross-covariances K_SD, K_UD never
carry noise. Inputs may carry leading batch dimensions (the machine axis of
``parallel.runner.VmapRunner``); they broadcast like ``torch.matmul``.

Params are stored in log-space: ``{"log_signal": (), "log_noise": (),
"log_lengthscale": (d,)}``.

``KernelSpec`` is the serving-side kernel abstraction: a callable drop-in for
a bare kernel function that also declares how cross-covariances are built
(the hand-written CUDA ``rbf`` kernel or plain PyTorch) and whether the
S-space diag predict may collapse into the fused ``xcov_diag`` CUDA kernel.
"""
from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import Callable

import torch

from repro_torch import device as _device

KernelFn = Callable[[dict, torch.Tensor, torch.Tensor], torch.Tensor]


def init_params(d: int, *, signal: float = 1.0, noise: float = 0.1,
                lengthscale: float | torch.Tensor = 1.0,
                dtype=torch.float32, device=None) -> dict:
    """Log-space hyperparameters on ``device`` (the CUDA card by default)."""
    dev = _device.resolve(device)
    ls = torch.as_tensor(lengthscale, dtype=dtype).to(dev)
    return {
        "log_signal": torch.tensor(math.log(signal), dtype=dtype, device=dev),
        "log_noise": torch.tensor(math.log(noise), dtype=dtype, device=dev),
        "log_lengthscale": torch.log(ls.expand(d).clone()),
    }


def signal_var(params: dict) -> torch.Tensor:
    return torch.exp(2.0 * params["log_signal"])


def noise_var(params: dict) -> torch.Tensor:
    return torch.exp(2.0 * params["log_noise"])


def _scale(params: dict, X: torch.Tensor) -> torch.Tensor:
    return X / torch.exp(params["log_lengthscale"])


def _sqdist(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Pairwise squared distances, clamped at 0 against roundoff."""
    a2 = torch.sum(A * A, dim=-1)[..., :, None]
    b2 = torch.sum(B * B, dim=-1)[..., None, :]
    d2 = a2 + b2 - 2.0 * (A @ B.mT)
    return torch.clamp(d2, min=0.0)


def se_ard(params: dict, X1: torch.Tensor, X2: torch.Tensor) -> torch.Tensor:
    """Squared-exponential ARD kernel (paper Sec. 6, signal part)."""
    d2 = _sqdist(_scale(params, X1), _scale(params, X2))
    return signal_var(params) * torch.exp(-0.5 * d2)


def matern52(params: dict, X1: torch.Tensor, X2: torch.Tensor) -> torch.Tensor:
    d2 = _sqdist(_scale(params, X1), _scale(params, X2))
    r = torch.sqrt(d2 + 1e-12) * math.sqrt(5.0)
    return signal_var(params) * (1.0 + r + r * r / 3.0) * torch.exp(-r)


def rational_quadratic(params: dict, X1: torch.Tensor, X2: torch.Tensor,
                       alpha: float = 1.0) -> torch.Tensor:
    d2 = _sqdist(_scale(params, X1), _scale(params, X2))
    return signal_var(params) * (1.0 + d2 / (2.0 * alpha)) ** (-alpha)


def se_ard_kernel(params: dict, X1: torch.Tensor,
                  X2: torch.Tensor) -> torch.Tensor:
    """SE-ARD through ``rbf_covariance``: the CUDA ``rbf`` kernel for CUDA
    tensors, its plain version for CPU tensors (the reference's
    ``se_ard_pallas``)."""
    from repro_torch.kernels.rbf import ops as rbf_ops
    return rbf_ops.rbf_covariance(
        _scale(params, X1), _scale(params, X2), signal_var(params))


# the reference's name for the same function
se_ard_pallas = se_ard_kernel


KERNELS: dict[str, KernelFn] = {
    "se": se_ard,
    "se_pallas": se_ard_kernel,
    "matern52": matern52,
    "rq": partial(rational_quadratic, alpha=1.0),
}


def make_kernel(name: str) -> KernelFn:
    try:
        return KERNELS[name]
    except KeyError:
        raise ValueError(f"unknown kernel {name!r}; have {sorted(KERNELS)}")


# ---------------------------------------------------------------------------
# KernelSpec — the serving-side kernel abstraction (hot-path declaration).
# ---------------------------------------------------------------------------

_SE_FAMILY = ("se", "se_pallas")


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """A kernel plus its declared cross-covariance/serving implementation.

    Callable with the ``KernelFn`` signature, so it drops into every fit and
    predict path unchanged. What it adds over a bare function:

    * ``impl`` — how SE cross-covariances are built: ``"auto"`` (the CUDA
      ``rbf`` kernel for CUDA tensors, plain ``se_ard`` in the native dtype
      for CPU tensors), ``"cuda"`` (always the kernel; a CPU tensor raises)
      or ``"torch"`` (always plain ``se_ard``). Other kernels always run
      their plain function. The reference's names are accepted as well:
      ``"pallas"`` resolves as ``"cuda"``, ``"pallas_interpret"`` and
      ``"jnp"`` as ``"torch"``.
    * ``fused`` — allow the S-space diag predicts (ppitc eqs. 7-8, fgp eqs.
      1-2) to dispatch the fused ``xcov_diag`` CUDA kernel. Honoured when
      ``impl`` resolves to ``"cuda"``. Unlike the TPU reference, whose VMEM
      caps the fused factor at 1024, there is no size cap: the kernel
      streams the inverse factors from device memory panel by panel.
    * ``block_q`` — serving query tile; ``api.ServeSpec`` aligns bucket
      ladders to it and the fused kernel's query tile follows it.
    """
    name: str = "se"
    impl: str = "auto"
    fused: bool = True
    block_q: int | None = None

    @property
    def kfn(self) -> KernelFn:
        return make_kernel(self.name)

    def resolved_impl(self, device: torch.device) -> str:
        """``"cuda"`` or ``"torch"`` for tensors on ``device``. The
        reference's names resolve too: ``pallas`` as ``cuda``,
        ``pallas_interpret`` and ``jnp`` as ``torch``."""
        impl = _IMPL_ALIASES.get(self.impl, self.impl)
        if impl == "auto":
            return "cuda" if device.type == "cuda" else "torch"
        if impl == "cuda" and device.type != "cuda":
            raise ValueError(
                f"KernelSpec(impl={self.impl!r}) was given tensors on "
                f"{device}; the CUDA kernels take CUDA tensors only (use "
                f"impl='auto' or 'torch' for the plain PyTorch path)")
        return impl

    def __call__(self, params: dict, X1: torch.Tensor, X2: torch.Tensor):
        impl = self.resolved_impl(X1.device)
        if self.name not in _SE_FAMILY or impl == "torch":
            # the plain path in the native dtype, as the reference's "jnp"
            return (se_ard if self.name in _SE_FAMILY else self.kfn)(
                params, X1, X2)
        return se_ard_kernel(params, X1, X2)

    def diag(self, params: dict, X: torch.Tensor) -> torch.Tensor:
        """diag k(X, X) — constant sig2 for the stationary kernels this
        registry carries (no per-row kernel dispatch, no host sync)."""
        return signal_var(params).to(X.dtype).expand(X.shape[:-1])

    def fuse(self, device: torch.device) -> bool:
        """May the S-space diag predict over a cached factor on ``device``
        collapse into ``xcov_diag``? At any factor size: the kernel has no
        residency cap (see the class docstring)."""
        return (self.fused and self.name in _SE_FAMILY
                and self.resolved_impl(device) == "cuda")

    def fused_diag(self, params: dict, U: torch.Tensor, Xk: torch.Tensor,
                   L1: torch.Tensor, alpha: torch.Tensor,
                   L2: torch.Tensor | None = None):
        """(mean, var) with var = sig2 - q(L1) [+ q(L2)] over
        lengthscale-scaled inputs: the fused kernel for CUDA tensors, its
        plain version under ``impl="torch"``."""
        from repro_torch.kernels.rbf import ops as rbf_ops, ref as rbf_ref
        args = (_scale(params, U), _scale(params, Xk), L1, alpha,
                signal_var(params), L2)
        if self.resolved_impl(U.device) == "cuda":
            return rbf_ops.xcov_diag(*args, block_q=self.block_q)
        return rbf_ref.xcov_diag(*args)


# the reference's impl names (checkpoint metadata) and what they resolve to
_IMPL_ALIASES = {"pallas": "cuda", "pallas_interpret": "torch",
                 "jnp": "torch"}
_IMPLS = ("auto", "cuda", "torch", *_IMPL_ALIASES)


def make_spec(name: str = "se", *, impl: str = "auto", fused: bool = True,
              block_q: int | None = None) -> KernelSpec:
    """Front door for the serving kernel spec; validates eagerly."""
    make_kernel(name)
    if impl not in _IMPLS:
        raise ValueError(f"unknown kernel impl {impl!r}; have {_IMPLS}")
    if block_q is not None and block_q < 1:
        raise ValueError(f"block_q must be a positive tile size; got "
                         f"{block_q}")
    return KernelSpec(name, impl, fused, block_q)


def kdiag(kfn: KernelFn, params: dict, X: torch.Tensor) -> torch.Tensor:
    """diag k(X, X) without forming the matrix (O(n·d))."""
    if isinstance(kfn, KernelSpec):
        return kfn.diag(params, X)
    return torch.func.vmap(
        lambda x: kfn(params, x[None], x[None])[0, 0])(X)


def add_noise(K: torch.Tensor, params: dict) -> torch.Tensor:
    """K + sigma_n^2 I — the paper's delta_xx' noise term (square K only)."""
    eye = torch.eye(K.shape[-1], dtype=K.dtype, device=K.device)
    return K + noise_var(params) * eye
