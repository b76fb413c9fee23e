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
without that axis.

Placement over a ``torch.distributed`` ``DeviceMesh``
(``launch.mesh.make_mesh``) is below the rules. An axis of a tensor whose
spec entry names mesh axes is split into contiguous chunks, one for each
index over those axes, counted row-major in the entry's order as
``NamedSharding`` counts it (("pod", "data") gives chunk pod * |data| +
data); ``None`` replicates it. ``shardings`` gives each spec's
``Placement``; ``local_shards`` takes a full tree to this rank's chunks,
``gather_shards`` all-gathers them back. ``MeshAxes`` holds the mesh's
axes on this rank and their collectives (``runner.DistAxis``, realized as
``runner.BACKEND_TABLE`` says; all-gathers and all-reduces only). A sum
over ranks all-gathers the terms and adds them in rank order, so it is the
same on every rank and in every run. ``gather_on_use`` gives a tree whose
leaves are all-gathered where a step reads them, with a backward that sums
each gradient over the batch's axes and keeps this rank's chunk: the
train and serve steps over a mesh (``launch.train``, ``launch.serve``)
store the state sharded and compute on gathered parameters.
"""
from __future__ import annotations

from collections.abc import Sequence
from typing import Any, Mapping, NamedTuple

import torch

DP = ("pod", "data")     # data/FSDP axes (pod may be absent on 1-pod meshes)
TP = "model"
PURE_DP_THRESHOLD_BYTES = 4e9   # below this, replicate params: no TP/FSDP


def axis_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of ``mesh`` (see the module docstring), or of a
    ``DeviceMesh``."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    if isinstance(mesh, MeshAxes):
        return dict(mesh.sizes)
    names = getattr(mesh, "mesh_dim_names", None)
    if names:
        return dict(zip(names, (int(n) for n in mesh.mesh.shape)))
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


def batch_axes(mesh) -> tuple[str, ...]:
    """The mesh axes ``batch_spec(mesh)`` splits the batch rows over."""
    return entry_axes(batch_spec(mesh)[0])


# ---------------------------------------------------------------------------
# placement over a DeviceMesh
# ---------------------------------------------------------------------------

def entry_axes(entry) -> tuple[str, ...]:
    """The mesh axes one spec entry names, in order."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def is_spec(x) -> bool:
    """A spec: a plain tuple of ``None``, axis names and tuples of names
    (not a NamedTuple, not a pair of specs)."""
    return type(x) is tuple and all(
        e is None or isinstance(e, str)
        or (type(e) is tuple and all(isinstance(a, str) for a in e))
        for e in x)


def _chunk(entry, sizes: dict, coords: dict) -> tuple[int, int]:
    """(this rank's chunk, the chunk count) of an axis split by ``entry``:
    the row-major index over the entry's mesh axes."""
    index, count = 0, 1
    for a in entry_axes(entry):
        index, count = index * sizes[a] + coords[a], count * sizes[a]
    return index, count


class Placement(NamedTuple):
    """A tensor's layout over a mesh (the reference's ``NamedSharding``):
    its spec and the mesh's axis sizes."""
    spec: tuple
    sizes: dict

    def local_shape(self, shape) -> tuple[int, ...]:
        shape = tuple(shape)
        for dim, entry in enumerate(self.spec):
            n = _chunk(entry, self.sizes, {a: 0 for a in self.sizes})[1]
            if shape[dim] % n:
                raise ValueError(f"axis {dim} of {shape} does not split "
                                 f"into {n} chunks ({self.spec})")
            shape = shape[:dim] + (shape[dim] // n,) + shape[dim + 1:]
        return shape

    def shard(self, t: torch.Tensor, coords: dict) -> torch.Tensor:
        """The chunk of the full ``t`` at mesh coordinates ``coords`` (a
        view)."""
        self.local_shape(t.shape)
        for dim, entry in enumerate(self.spec):
            i, n = _chunk(entry, self.sizes, coords)
            if n > 1:
                size = t.shape[dim] // n
                t = t.narrow(dim, i * size, size)
        return t


def shardings(tree_specs, mesh):
    """The ``Placement`` of each spec of ``tree_specs`` over ``mesh``."""
    sizes = axis_sizes(mesh)
    return map_specs(lambda spec: Placement(spec, sizes), tree_specs)


def map_specs(fn, specs, *trees):
    """``fn(spec, *leaves)`` over a tree of specs (dicts, lists, tuples and
    NamedTuples of ``is_spec`` leaves) and the matching leaves of
    ``trees``. A ``None`` spec, or a leaf that is not a tensor (a cache's
    host-int length), stays as it is in the first tree."""
    if specs is None:
        return trees[0] if trees else None
    if is_spec(specs):
        if trees and not isinstance(trees[0], torch.Tensor):
            return trees[0]
        return fn(specs, *trees)
    if isinstance(specs, Mapping):
        return {k: map_specs(fn, v, *(t[k] for t in trees))
                for k, v in specs.items()}
    if isinstance(specs, tuple) and hasattr(specs, "_fields"):
        return type(specs)(*(map_specs(fn, v, *(t[i] for t in trees))
                             for i, v in enumerate(specs)))
    if isinstance(specs, (list, tuple)):
        return type(specs)(map_specs(fn, v, *(t[i] for t in trees))
                           for i, v in enumerate(specs))
    raise TypeError(f"not a spec tree: {specs!r}")


def _coords(mesh, coords) -> dict:
    if coords is not None:
        return dict(coords)
    if isinstance(mesh, MeshAxes):
        return dict(mesh.coords)
    return dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))


def local_shards(tree, specs, mesh, coords=None):
    """This rank's chunks of the full ``tree`` laid out by ``specs``, each a
    contiguous copy. ``mesh``: a ``DeviceMesh`` or ``MeshAxes``, or a
    mapping of axis sizes with the ``coords`` to take."""
    sizes, where = axis_sizes(mesh), _coords(mesh, coords)
    return map_specs(lambda spec, t: Placement(spec, sizes).shard(
        t, where).clone(memory_format=torch.contiguous_format), specs, tree)


def gather_shards(tree, specs, mesh):
    """The full tree from every rank's ``local_shards`` (a collective call:
    every rank of ``mesh`` makes it). ``mesh``: a ``DeviceMesh`` or
    ``MeshAxes``."""
    axes = mesh if isinstance(mesh, MeshAxes) else MeshAxes(mesh)
    return map_specs(lambda spec, t: axes.gather(t, spec), specs, tree)


class MeshAxes:
    """The named axes of a ``DeviceMesh`` on this rank: sizes, this rank's
    coordinates, and a ``runner.DistAxis`` over the process group of each
    axis longer than 1 (``device``: where the collectives' tensors live; by
    default the mesh's device type at the current CUDA device, or the
    CPU). A collective over an axis of length 1 is the identity, and none
    is made."""

    def __init__(self, mesh, device=None):
        import torch.distributed as dist
        from repro_torch.parallel.runner import DistAxis
        self.sizes = axis_sizes(mesh)
        self.coords = _coords(mesh, None)
        if device is None:
            device = (torch.device("cuda", torch.cuda.current_device())
                      if mesh.device_type == "cuda"
                      else torch.device(mesh.device_type))
        self.device = torch.device(device)
        self.axes = {}
        for name, n in self.sizes.items():
            if n > 1:
                group = mesh.get_group(name)
                self.axes[name] = DistAxis(
                    group, dist.get_process_group_ranks(group), 1,
                    self.device)

    def live(self, names) -> tuple[str, ...]:
        """``names`` without the axes of length 1."""
        return tuple(a for a in names if self.sizes[a] > 1)

    def group(self, names) -> "AxisGroup":
        return AxisGroup(self, tuple(names))

    def _cat(self, t: torch.Tensor, name: str, dim: int) -> torch.Tensor:
        """Every rank's ``t`` along axis ``name``, concatenated along
        ``dim`` in coordinate order."""
        parts = self.axes[name]._all_gather(t.contiguous())   # (P, ...)
        parts = parts.movedim(0, dim)
        shape = list(t.shape)
        shape[dim] *= parts.shape[dim]
        return parts.reshape(shape)

    def gather(self, t: torch.Tensor, spec: tuple) -> torch.Tensor:
        """The full tensor from this rank's chunk ``t`` (every rank of the
        axes ``spec`` names takes part)."""
        for dim, entry in enumerate(spec):
            for a in reversed(self.live(entry_axes(entry))):
                t = self._cat(t, a, dim)
        return t

    def shard(self, t: torch.Tensor, spec: tuple) -> torch.Tensor:
        return Placement(spec, self.sizes).shard(t, self.coords)

    def sum(self, t: torch.Tensor, names) -> torch.Tensor:
        """The sum of every rank's ``t`` over the axes ``names``: each
        axis's terms all-gathered and added in coordinate order."""
        for a in self.live(names):
            parts = self.axes[a]._all_gather(t.contiguous())
            t = parts[0]
            for p in parts[1:]:
                t = t + p
        return t

    def max(self, t: torch.Tensor) -> torch.Tensor:
        """The largest of every rank's ``t`` over every axis."""
        import torch.distributed as dist
        for a in self.live(self.sizes):
            t = self.axes[a]._all_reduce(t.contiguous().clone(),
                                         dist.ReduceOp.MAX)
        return t

    def reduce_to_shard(self, g: torch.Tensor, spec: tuple,
                        names) -> torch.Tensor:
        """The gradient of a gathered tensor back to this rank's chunk:
        ``g`` summed over the axes ``names`` (the ranks that computed on
        other rows), then cut by ``spec``. The spec's entries that name
        none of ``names`` are cut first: the ranks of a sum share those
        coordinates, and each sends only the chunk it keeps."""
        names = set(self.live(names))
        early = tuple(None if names & set(entry_axes(e)) else e
                      for e in spec)
        late = tuple(e if names & set(entry_axes(e)) else None
                     for e in spec)
        g = self.sum(self.shard(g, early), [a for a in self.sizes
                                            if a in names])
        return self.shard(g, late)

    def needs(self, spec: tuple, names=()) -> bool:
        """Whether a tensor laid out by ``spec``, with a gradient summed
        over ``names``, needs a collective at all."""
        return bool(self.live(names)) or any(
            self.live(entry_axes(e)) for e in spec)


def mesh_axes(mesh) -> MeshAxes:
    """``mesh``'s axes on this rank: ``MeshAxes(mesh)`` of a
    ``DeviceMesh``, or ``mesh`` itself when it is a ``MeshAxes`` already
    (``launch.dryrun``'s recording axes, which trace one rank's step with no
    process group)."""
    return mesh if isinstance(mesh, MeshAxes) else MeshAxes(mesh)


class _Gather(torch.autograd.Function):
    """``MeshAxes.gather`` with the backward ``MeshAxes.reduce_to_shard``
    (the gradient summed over the axes ``names``, in rank order)."""

    @staticmethod
    def forward(ctx, t, axes, spec, names):
        ctx.args = (axes, spec, names)
        return axes.gather(t, spec)

    @staticmethod
    def backward(ctx, g):
        axes, spec, names = ctx.args
        return axes.reduce_to_shard(g, spec, names), None, None, None


def gather_grad(t: torch.Tensor, axes: MeshAxes, spec: tuple,
                names=()) -> torch.Tensor:
    """``t`` gathered by ``spec``, differentiable: its gradient is summed
    over the axes ``names`` and cut back to this rank's chunk. ``t``
    itself where no collective is needed."""
    if not axes.needs(spec, names):
        return t
    return _Gather.apply(t, axes, spec, tuple(names))


class AxisGroup:
    """Some axes of a mesh taken as one (the axes a batch's rows are split
    over): ``size`` ranks, this rank's row-major ``index`` among them."""

    def __init__(self, axes: MeshAxes, names: tuple[str, ...]):
        self.axes, self.names = axes, tuple(names)
        self.index, self.size = _chunk(self.names, axes.sizes, axes.coords)

    def gather(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every rank's ``x`` concatenated along ``dim`` in rank order;
        differentiable (the gradient summed over the group, this rank's
        rows kept)."""
        spec = (None,) * dim + (self.names,)
        return gather_grad(x, self.axes, spec, self.names)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the group of every rank's ``x``, in rank order;
        differentiable."""
        parts = self.gather(x[None], 0)
        out = parts[0]
        for p in parts[1:]:
            out = out + p
        return out


class _OnUse(Mapping):
    def __init__(self, local, specs, gather):
        self._local, self._specs, self._gather = local, specs, gather

    def __getitem__(self, key):
        return _on_use(self._local[key], self._specs[key], self._gather)

    def __iter__(self):
        return iter(self._local)

    def __len__(self):
        return len(self._local)

    def __contains__(self, key):         # without gathering the leaf
        return key in self._local


class _OnUseSeq(Sequence):
    def __init__(self, local, specs, gather):
        self._local, self._specs, self._gather = local, specs, gather

    def __getitem__(self, i):
        return _on_use(self._local[i], self._specs[i], self._gather)

    def __len__(self):
        return len(self._local)


def _on_use(local, specs, gather):
    if local is None:
        return None
    if isinstance(local, Mapping):
        return _OnUse(local, specs, gather)
    if isinstance(local, (list, tuple)):
        return _OnUseSeq(local, specs, gather)
    return gather(local, specs)


def gather_on_use(local, specs, axes: MeshAxes, names=()):
    """A read-only view of the local tree ``local`` (dicts and lists) whose
    every leaf is all-gathered by its spec each time it is read
    (``gather_grad``: differentiable, the gradient summed over the axes
    ``names``). A step reads a layer's parameters inside that layer, so
    they are gathered there, and again where remat recomputes it."""
    return _on_use(local, specs,
                   lambda t, spec: gather_grad(t, axes, spec, names))
