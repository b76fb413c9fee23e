"""Hyperparameters and fitted states of the JAX package, as the port's
tensors.

Both take arrays (numpy, or anything ``numpy.asarray`` reads) so that this
module needs nothing of the JAX package: the caller hands over
``{"log_signal", "log_noise", "log_lengthscale"}`` or a fitted
``PITCState``/``FGPState`` (any object with those fields, such as the JAX
NamedTuple itself), and gets the same model on ``device`` in ``dtype``.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.core import api

_PARAM_KEYS = ("log_signal", "log_noise", "log_lengthscale")
_STATES = (api.PITCState, api.FGPState)


def _tensor(a, device, dtype) -> torch.Tensor:
    return torch.tensor(np.asarray(a)).to(device=device, dtype=dtype)


def params_from_arrays(params: Mapping, *, device, dtype=None) -> dict:
    """Log-space hyperparameters as tensors on ``device`` (``dtype`` None
    keeps the arrays' own)."""
    missing = set(_PARAM_KEYS) - set(params)
    if missing:
        raise KeyError(f"hyperparameters lack {sorted(missing)}")
    return {k: _tensor(params[k], device, dtype) for k in _PARAM_KEYS}


def state_from_arrays(state, *, device, dtype=None):
    """A fitted ``PITCState`` or ``FGPState`` (matched by its field names)
    as the port's state of the same name on ``device``."""
    fields = tuple(getattr(state, "_fields", ()))
    for cls in _STATES:
        if fields == cls._fields:
            return cls(*(_tensor(getattr(state, f), device, dtype)
                         for f in cls._fields))
    raise TypeError(f"no port state has the fields {fields}; have "
                    f"{[c._fields for c in _STATES]}")
