"""Sharding rules: DP/FSDP over ("pod", "data"), TP/EP over "model", SP for
long-context KV caches — port of ``repro.parallel.sharding``'s rules.

These are pure functions of parameter names, shapes and a mesh's axis
sizes. A spec is a plain tuple with one entry a tensor axis: ``None``
(replicated), an axis name, or a tuple of axis names (the entries of the
reference's ``PartitionSpec``). ``mesh`` is a mapping {axis: size} or an
object whose ``shape`` is one (as the reference's ``Mesh``).

Rules are size-aware: an axis is sharded only if its size divides the mesh
axes' product, else it is replicated. The port keeps an LM's layers as the
flat list ``params["layers"]`` (and ``params["encoder"]``) where the
reference stacks them per pattern position with a leading scan axis that
is never sharded; a port layer's leaf takes the reference's stacked rule
without that axis. Placing tensors over a mesh by these specs (a step run
over a ``DeviceMesh``) is ROADMAP item 12b.
"""
from __future__ import annotations

from typing import Any, Mapping

DP = ("pod", "data")     # data/FSDP axes (pod may be absent on 1-pod meshes)
TP = "model"
PURE_DP_THRESHOLD_BYTES = 4e9   # below this, replicate params: no TP/FSDP


def axis_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of ``mesh`` (see the module docstring)."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    shape = getattr(mesh, "shape", None)
    if isinstance(shape, Mapping):
        return dict(shape)
    raise TypeError(f"cannot read axis sizes from {type(mesh).__name__}")


def dp_axes(mesh) -> tuple[str, ...]:
    shape = axis_sizes(mesh)
    return tuple(a for a in DP if a in shape)


def _size(shape: dict, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        return shape[axes]
    out = 1
    for a in axes:
        out *= shape[a]
    return out


def _fit(dim: int, shape: dict, axes):
    """axes if dim divides their product else None."""
    return axes if (axes and dim % _size(shape, axes) == 0) else None


def _dpx(mesh):
    dp = dp_axes(mesh)
    return dp if len(dp) > 1 else (dp[0] if dp else None)


def spec_for(path: str, shape: tuple[int, ...], mesh) -> tuple:
    """The spec of one parameter, by its name (the path's last part)."""
    sizes = axis_sizes(mesh)
    dp = _dpx(mesh)

    def fit(i, axes):
        return _fit(shape[i], sizes, axes)

    last = path.rsplit("/", 1)[-1]
    # MoE expert weights (E, d, ff)/(E, ff, d), before the 2-D name rules
    if len(shape) == 3 and last in ("w_gate", "w_in", "w_out"):
        if shape[0] % _size(sizes, TP) == 0:
            return (TP, fit(1, dp), None)         # EP: experts on model
        return (None, fit(1, dp), fit(2, TP))     # TP inside experts
    if last == "tok":                             # (V, d) embed
        small = shape[0] * shape[1] * 4 <= 2 ** 31
        return (fit(0, TP), None if small else fit(1, dp))
    if last == "unembed":                         # (d, V)
        small = shape[0] * shape[1] * 4 <= 2 ** 31
        return (None if small else fit(0, dp), fit(1, TP))
    if last in ("wq", "wk", "wv", "w_gate", "w_in", "in_proj"):
        return (fit(0, dp), fit(1, TP))           # (d, out): TP on out
    if last in ("wo", "w_out", "out_proj"):
        return (fit(0, TP), fit(1, dp))           # (in, d): TP on in
    if last == "router":                          # (d, E): small, replicated
        return (None, None)
    if last == "conv_w":                          # (K, conv_dim)
        return (None, fit(1, TP))
    if len(shape) == 3:
        return (None, fit(1, dp), fit(2, TP))
    if len(shape) == 1:
        return (fit(0, TP),)                      # per-channel vectors
    if len(shape) == 2:
        return (fit(0, dp), fit(1, TP))
    return ()


def _leaves(tree, prefix: str = ""):
    """(path, tensor) pairs of a tree of dicts, lists and tuples; ``None``
    leaves are skipped."""
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}" if prefix else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}" if prefix else str(i))
    elif tree is not None:
        yield prefix, tree


def use_tp_policy(params) -> bool:
    """Size-aware policy: models of at most 4 GB of parameters (e.g.
    mamba2-130m) are replicated and spend every mesh axis on data
    parallelism."""
    total = sum(t.numel() * t.element_size() for _, t in _leaves(params))
    return total > PURE_DP_THRESHOLD_BYTES


def param_specs(params: Any, mesh, use_tp: bool | None = None):
    """A tree like ``params`` (the port's flat-layer tree) of specs: each
    layer's leaf gets the reference's stacked rule for its (unstacked)
    shape; ``use_tp=False`` (auto for small models) replicates all."""
    if use_tp is None:
        use_tp = use_tp_policy(params)

    def walk(tree, prefix):
        if isinstance(tree, Mapping):
            return {k: walk(v, f"{prefix}/{k}" if prefix else str(k))
                    for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v, f"{prefix}/{i}" if prefix else str(i))
                              for i, v in enumerate(tree))
        if tree is None:
            return None
        if not use_tp:
            return (None,) * tree.ndim
        return spec_for(prefix, tuple(tree.shape), mesh)

    return walk(params, "")


def batch_spec(mesh, use_tp: bool = True, batch: int | None = None) -> tuple:
    sizes = axis_sizes(mesh)
    dp = dp_axes(mesh)
    if not use_tp and TP in sizes:
        dp = dp + (TP,)          # pure DP: batch over every axis
    if batch is not None:        # drop axes until the batch divides
        while dp and batch % _size(sizes, dp):
            dp = dp[:-1]
    return (dp if len(dp) > 1 else (dp[0] if dp else None),)


def logits_spec(mesh, *, batch: int | None = None,
                vocab: int | None = None) -> tuple:
    sizes = axis_sizes(mesh)
    dpx = _dpx(mesh)
    if batch is not None and (batch % max(_size(sizes, dpx), 1)
                              or batch == 1):
        dpx = None
    tp = TP
    if vocab is not None and vocab % _size(sizes, TP):
        tp = None
    return (dpx, None, tp)


def cache_spec(mesh, *, batch: int, n_kv: int, seq: int,
               stacked: bool) -> tuple:
    """KV cache (B, Hkv, T, hd): batch on DP and heads on TP where they
    divide; batch 1 (long context) puts T on DP (sequence parallel)."""
    sizes = axis_sizes(mesh)
    dpx = _dpx(mesh)
    tp_heads = TP if (n_kv % _size(sizes, TP) == 0) else None
    if batch % max(_size(sizes, dpx), 1) == 0 and batch > 1:
        spec = (dpx, tp_heads, None, None)
    else:
        spec = (None, tp_heads, dpx, None)
    return (None, *spec) if stacked else spec


def ssm_state_spec(mesh, *, batch: int, n_heads: int,
                   stacked: bool) -> tuple:
    sizes = axis_sizes(mesh)
    dpx = _dpx(mesh)
    tp_heads = TP if (n_heads % _size(sizes, TP) == 0) else None
    if batch % max(_size(sizes, dpx), 1) == 0 and batch > 1:
        spec = (dpx, tp_heads, None, None)
    else:
        spec = (None, tp_heads, None, None)
    return (None, *spec) if stacked else spec
