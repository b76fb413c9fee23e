"""Hyperparameters, fitted states and LM parameters of the JAX package, as
the port's tensors.

All take arrays (numpy, or anything ``numpy.asarray`` reads) so that this
module needs nothing of the JAX package: the caller hands over
``{"log_signal", "log_noise", "log_lengthscale"}``, a fitted
``PITCState``/``PICState``/``FGPState``/``PICFState`` or pICF's
``ICFLocal`` factor (any object with those fields, such as the JAX
NamedTuple itself), or an ``AdamState``, and gets the same on ``device``
in ``dtype``.
``lm_params_from_arrays`` takes an LM's parameter tree with numpy leaves
(``jax.tree.map(np.asarray, params)`` on the caller's side), and
``train_state_from_arrays`` a whole training state: the reference's
``TrainState`` with numpy leaves, or the nested dicts of a checkpoint file
the JAX package wrote (``checkpoint.io.nest(io.read(path))``).
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.core import api, picf
from repro_torch.optim.adam import AdamState, TrainState
from repro_torch.optim.compression import EFState

_PARAM_KEYS = ("log_signal", "log_noise", "log_lengthscale")
_STATES = (api.PITCState, api.PICState, api.FGPState, api.PICFState,
           picf.ICFLocal)


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
    """A fitted ``PITCState``, ``PICState``, ``FGPState`` or ``PICFState``,
    or an ``ICFLocal`` (matched by its field names), as the port's tuple
    of the same name on ``device``."""
    fields = tuple(getattr(state, "_fields", ()))
    for cls in _STATES:
        if fields == cls._fields:
            return cls(*(_tensor(getattr(state, f), device, dtype)
                         for f in cls._fields))
    raise TypeError(f"no port state has the fields {fields}; have "
                    f"{[c._fields for c in _STATES]}")


def adam_state_from_arrays(state, *, device, dtype=None) -> AdamState:
    """The reference's ``AdamState`` (step, mu, nu; mu and nu dicts of
    arrays keyed like the parameters) as the port's on ``device``; the
    step stays int32, the moments take ``dtype`` (None keeps theirs)."""
    if tuple(getattr(state, "_fields", ())) != AdamState._fields:
        raise TypeError(f"need an AdamState {AdamState._fields}; got "
                        f"{type(state).__name__}")
    return AdamState(_tensor(state.step, device, torch.int32),
                     _tree(state.mu, device, dtype),
                     _tree(state.nu, device, dtype))


_NORM_KEYS = ("ln1", "ln2", "ln_x", "norm", "q_norm", "k_norm")


def _tree(node, device, dtype, index=None):
    """Nested dicts of arrays -> dicts of tensors, taking entry ``index`` of
    the leading (stacked) axis of every leaf when it is given. Float leaves
    are cast to ``dtype`` (None keeps theirs), except the norm weights,
    which the reference keeps in float32 whatever the parameter dtype."""
    if node is None:
        return None
    if isinstance(node, Mapping):
        return {k: _tree(v, device, None if k in _NORM_KEYS else dtype,
                         index)
                for k, v in node.items()}
    a = np.asarray(node)
    if index is not None:
        a = a[index]
    return _tensor(a, device, dtype if a.dtype.kind == "f" else None)


def lm_params_from_arrays(tree: Mapping, cfg, *, device, dtype=None) -> dict:
    """The JAX package's LM parameters (``transformer.init_model``'s tree,
    numpy leaves) as the port's flat-layer parameters on ``device``.

    JAX stacks layer parameters per pattern position (``tree["stack"][pos]``
    with a leading axis over the n_full periods) and keeps the remainder in
    ``tree["rest"]``. The port's ``params["layers"][i * period + pos]`` is
    stacked entry ``i`` of position ``pos``; the remainder layers follow.
    Leaves keep their layouts (``conv_w`` stays (K, conv_dim): the port's
    causal conv is the same sum of shifted products). A layer's
    ``ln_x``/``cross`` (enc-dec) and ``moe`` come across with it; an
    enc-dec model's ``encoder`` stack (leading axis ``enc_layers``) becomes
    the list ``params["encoder"]``, beside ``enc_norm``.
    """
    period = cfg.period
    n_full = cfg.n_layers // period
    stack = tree.get("stack", ())
    rest = tree.get("rest", ())
    if len(stack) != (period if n_full else 0) or \
            len(rest) != cfg.n_layers - n_full * period:
        raise ValueError(f"tree has {len(stack)} stacked positions and "
                         f"{len(rest)} remainder layers; {cfg.name} needs "
                         f"{period if n_full else 0} and "
                         f"{cfg.n_layers - n_full * period}")
    layer_list = [_tree(stack[pos], device, dtype, index=i)
                  for i in range(n_full) for pos in range(period)]
    layer_list += [_tree(r, device, dtype) for r in rest]
    params = {"embed": _tree(tree["embed"], device, dtype),
              "layers": layer_list,
              "final_norm": _tree(tree.get("final_norm"), device, None)}
    if cfg.enc_dec:
        params["encoder"] = [_tree(tree["encoder"], device, dtype, index=i)
                             for i in range(cfg.enc_layers)]
        params["enc_norm"] = _tree(tree.get("enc_norm"), device, None)
    if cfg.nonparametric_ln:
        # a checkpoint file has no leaf for a None norm weight: put it back
        for layer in layer_list + params.get("encoder", []):
            for key, there in (("ln1", True),
                               ("ln2", "mlp" in layer or "moe" in layer),
                               ("ln_x", "cross" in layer)):
                if there:
                    layer.setdefault(key, None)
    return params


def _field(obj, name: str):
    """``obj.name`` of a NamedTuple, ``obj[name]`` of a mapping; None when
    absent (a checkpoint file has no leaf for a None field)."""
    if isinstance(obj, Mapping):
        return obj.get(name)
    return getattr(obj, name)


def train_state_from_arrays(state, cfg, *, device, dtype=None):
    """The JAX package's LM ``TrainState`` (params, Adam's (step, mu, nu),
    the error feedback or None, step) as the port's ``TrainState``
    (``optim.adam``) on ``device``: parameters and both moments through
    ``lm_params_from_arrays``, the steps int32. ``state`` is the
    NamedTuple with numpy leaves or a checkpoint file's nested dicts."""
    opt = _field(state, "opt")
    ef = _field(state, "ef")
    err = None if ef is None else _field(ef, "error")
    return TrainState(
        lm_params_from_arrays(_field(state, "params"), cfg, device=device,
                              dtype=dtype),
        AdamState(_tensor(_field(opt, "step"), device, torch.int32),
                  lm_params_from_arrays(_field(opt, "mu"), cfg,
                                        device=device, dtype=dtype),
                  lm_params_from_arrays(_field(opt, "nu"), cfg,
                                        device=device, dtype=dtype)),
        None if err is None else EFState(lm_params_from_arrays(
            err, cfg, device=device, dtype=dtype)),
        _tensor(_field(state, "step"), device, torch.int32))
