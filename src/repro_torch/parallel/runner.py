"""The machine axis of the per-machine GP programs — port of
``repro.parallel.runner``.

The reference writes each algorithm once as a per-machine function and lets
``jax.vmap``/``shard_map`` realize the machine axis, with ``jax.lax``
collectives (psum, all_gather, psum_scatter, ppermute) as the paper's MPI
reduce and broadcast. The port keeps its own idiom: a per-machine program
is written batched over a leading dimension of the L machines one process
holds (the covariance kernel builds all L blocks in one launch), and it
calls a machine-axis object where the reference calls ``jax.lax``. A Runner
decides how the axis is realized:

* ``VmapRunner(M)`` — all M machines in one process (L = M), on one
  device. Its ``StackedAxis`` sums over dim 0 in machine order; gathers are
  the identity.
* ``ShardMapRunner(mesh, axis_name, local_machines=L)`` — the P ranks of a
  ``torch.distributed`` ``DeviceMesh``'s named axes (``launch/mesh.py``),
  L machines each (M = P L; L = 1 is the reference's one machine a device).
  Its ``DistAxis`` reduces its L machines in machine order first, then
  across ranks, through the collectives ``BACKEND_TABLE`` names for the
  group's backend and device.

``Runner.map`` runs ``fn(*sharded, *replicated)`` on the rank's own (L, ...)
stacks and returns its (L, ...) outputs; ``Runner.gather`` all-gathers a
stack to (M, ...) (the identity on a ``VmapRunner``). ``shard_blocks`` and
``pad_blocks`` take the rank's rows of the (M, b, ...) block layout.

The routed scatters of pPIC serving (``scatter_by_block`` and the
two-bucket ``scatter_two_bucket``) are here too. The reference drops a
row that no slot takes (``.at[...].set(mode="drop")``); the port writes it
into a spare trash row of a buffer one larger and slices that off, so every
shape depends on the batch size alone and nothing syncs with the host.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from collections import Counter
from typing import Callable, NamedTuple, Sequence

import torch

ROUTED_ALPHA = 2   # main-bucket capacity multiplier alpha (headroom vs skew)


# ---------------------------------------------------------------------------
# How each backend carries the axis's collectives, keyed by (backend, device
# type), read once when a DistAxis is built. Four kinds of collective; each
# entry names its realization and, where it is not the backend's own
# collective, what it costs. A (backend, device) pair missing here raises:
# nothing falls back, and nothing moves to another device to compute.
#
# ("gloo", "cuda") is what torch 2.11's gloo carries for CUDA tensors, read
# on an H100 by ``python -m repro_torch.launch.backend_probe``: all-reduce
# (sum, max, int32), all-gather and reduce-scatter (list and tensor forms)
# run; point-to-point does not (``send`` fails on the device pointer,
# "Bad address", and ``batch_isend_irecv`` aborts the process). So a
# ppermute there is staged through an all-gather.
# ---------------------------------------------------------------------------

# where the ("gloo", "cuda") row was read (a constant: the probe is not run
# again when the table is used)
GLOO_CUDA_READ_ON = "torch 2.11.0+cu128 on an NVIDIA H100 80GB HBM3"

ALL_REDUCE = "all_reduce"                       # dist.all_reduce
ALL_GATHER = "all_gather"                       # list form
ALL_GATHER_TENSOR = "all_gather_into_tensor"
REDUCE_SCATTER = "reduce_scatter"               # list form
REDUCE_SCATTER_TENSOR = "reduce_scatter_tensor"
P2P = "batch_isend_irecv"
P2P_BY_GATHER = "all_gather of every rank's payload, then select"

_NOTES = {
    P2P_BY_GATHER: "every rank receives every rank's messages: P^2 x the "
                   "bytes of one message, against P point to point",
}

BACKEND_TABLE: dict[tuple[str, str], dict[str, str]] = {
    ("nccl", "cuda"): {"all_reduce": ALL_REDUCE,
                       "all_gather": ALL_GATHER_TENSOR,
                       "reduce_scatter": REDUCE_SCATTER_TENSOR,
                       "p2p": P2P},
    ("gloo", "cpu"): {"all_reduce": ALL_REDUCE,
                      "all_gather": ALL_GATHER,
                      "reduce_scatter": REDUCE_SCATTER,
                      "p2p": P2P},
    ("gloo", "cuda"): {"all_reduce": ALL_REDUCE,
                       "all_gather": ALL_GATHER,
                       "reduce_scatter": REDUCE_SCATTER,
                       "p2p": P2P_BY_GATHER},
}


def backend_table() -> list[dict]:
    """``BACKEND_TABLE`` as rows (what ``chip_smoke.py`` prints)."""
    return [{"backend": b, "device": d, "op": op, "realization": how,
             **({"note": _NOTES[how]} if how in _NOTES else {})}
            for (b, d), ops in BACKEND_TABLE.items()
            for op, how in ops.items()]


def _sum0(x: torch.Tensor) -> torch.Tensor:
    """The sum over dim 0 in x's dtype (an int32 payload stays int32)."""
    return x.sum(0) if x.is_floating_point() else x.sum(0, dtype=x.dtype)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _Axis:
    """What both realizations share: the per-op call and byte counts.

    ``stats["<op>:calls"]`` and ``stats["<op>:bytes"]``, bytes being what
    one machine of the axis receives from the collective (the reduced tensor for a psum, every
    machine's rows for an all-gather, its own chunk for a psum_scatter, its
    payload for a ppermute), computed from the tensors' shapes. A
    collective program (one written against the axis) makes the same calls
    on either axis; the fits' steps across processes (a TSQR) run only on a
    ``DistAxis`` (``distributed``), of one rank or more."""

    size: int           # M, the machines of the axis
    ranks: int          # P, the processes over which they are spread
    distributed: bool   # across processes (a DistAxis), even of one rank
    local: int          # L, the machines this process holds (M = P L)
    start: int          # the first machine of this process

    def __init__(self):
        self.stats: Counter = Counter()

    def _count(self, op: str, nbytes: int) -> None:
        self.stats[op + ":calls"] += 1
        self.stats[op + ":bytes"] += int(nbytes)

    def reset_stats(self) -> None:
        self.stats.clear()

    def index(self, device=None) -> torch.Tensor:
        """(L,) the machine ids of this process's stack (``axis_index``)."""
        return torch.arange(self.start, self.start + self.local,
                            device=device)

    def _local(self, x: torch.Tensor, what: str) -> None:
        if x.shape[0] != self.local:
            raise ValueError(f"{what} takes a stack of this process's "
                             f"{self.local} machines on dim 0; got shape "
                             f"{tuple(x.shape)}")


class StackedAxis(_Axis):
    """All M machines in one process (``VmapRunner``): every collective is
    a reduction or a reindexing of dim 0, in machine order."""

    distributed = False

    def __init__(self, size: int):
        super().__init__()
        self.size = self.local = size
        self.ranks, self.start = 1, 0

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """(M, ...) -> (...): the sum over machines, in machine order."""
        self._local(x, "psum")
        out = _sum0(x)
        self._count("psum", _nbytes(out))
        return out

    def psum_start(self, x: torch.Tensor):
        """``psum`` as a handle whose ``wait()`` returns the sum."""
        return _Done(self.psum(x))

    def psum_ranks(self, x: torch.Tensor) -> torch.Tensor:
        """A partial already summed over the process's machines: the sum
        (one process)."""
        return x

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        """(M, ...) -> (...): the largest over machines."""
        self._local(x, "pmax")
        out = x.amax(0)
        self._count("pmax", _nbytes(out))
        return out

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """(M, ...) -> (M, ...): every machine's rows (the identity)."""
        self._local(x, "all_gather")
        self._count("all_gather", _nbytes(x))
        return x

    def psum_scatter(self, x: torch.Tensor) -> torch.Tensor:
        """(M, M, ...) -> (M, ...): machine i receives the sum over machines
        m of x[m, i] (``psum_scatter(..., tiled=False)``)."""
        self._local(x, "psum_scatter")
        out = _sum0(x)
        self._count("psum_scatter", _nbytes(out) // self.local)
        return out

    def ppermute(self, x: torch.Tensor, perm) -> torch.Tensor:
        """(M, ...) -> (M, ...): machine d receives machine s's rows for each
        (s, d) in ``perm``, zeros where none is sent (as ``lax.ppermute``).
        A ring's permutation is a roll over dim 0."""
        self._local(x, "ppermute")
        src, dst = (list(v) for v in zip(*perm))
        out = torch.zeros_like(x)
        out[dst] = x[src]
        self._count("ppermute", _nbytes(out) // self.local)
        return out


class _Done:
    def __init__(self, value):
        self.value = value

    def wait(self):
        return self.value


class _AllReduceSum(torch.autograd.Function):
    """A differentiable sum over processes: the backward sums the
    gradients over processes too (each process's loss counted once), so a
    replicated objective's gradient is the mean over processes of theirs
    (``ShardMapRunner.reduce_grads``)."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return axis._all_reduce(x.contiguous().clone())

    @staticmethod
    def backward(ctx, g):
        return ctx.axis._all_reduce(g.contiguous().clone()), None


class _GatherRanks(torch.autograd.Function):
    """(...) a process -> (P, ...) in process order; the backward sums each
    process's slot of the gradient over processes."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return axis._all_gather(x.contiguous())

    @staticmethod
    def backward(ctx, g):
        axis = ctx.axis
        return axis._all_reduce(g.contiguous().clone())[axis.rank], None


class DistAxis(_Axis):
    """The machine axis over the processes of a ``torch.distributed``
    group: P ranks in machine order, L machines each. Built collectively
    (every rank of the group builds its own, as ``ShardMapRunner`` does).

    Every collective first reduces (or lays out) the rank's L machines in
    machine order, then moves one message over the group, through
    ``BACKEND_TABLE[(backend, device type)]``, one rank or more."""

    distributed = True

    def __init__(self, group, peers: Sequence[int], local: int,
                 device: torch.device):
        import torch.distributed as dist
        super().__init__()
        self.group, self.peers = group, list(peers)
        if self.peers != sorted(self.peers):
            raise ValueError(f"the machine order of the mesh axes must follow "
                             f"the group's rank order; got ranks "
                             f"{self.peers}")
        self.ranks, self.local = len(self.peers), int(local)
        self.rank = self.peers.index(dist.get_rank())
        self.size, self.start = self.ranks * self.local, self.rank * self.local
        self.device = torch.device(device)
        self.backend = str(dist.get_backend(group)).lower()
        key = (self.backend, self.device.type)
        if key not in BACKEND_TABLE:
            raise ValueError(
                f"no realization of the machine axis's collectives for "
                f"backend {self.backend!r} on {self.device.type} tensors; "
                f"BACKEND_TABLE has {sorted(BACKEND_TABLE)}")
        self.table = BACKEND_TABLE[key]

    def index(self, device=None) -> torch.Tensor:
        return super().index(self.device if device is None else device)

    # -- the group's collectives, as the table realizes them ----------------

    def _all_reduce(self, x, op=None):
        import torch.distributed as dist
        dist.all_reduce(x, op=dist.ReduceOp.SUM if op is None else op,
                        group=self.group)
        return x

    def _all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """(...) a rank -> (P, ...) in rank order."""
        import torch.distributed as dist
        how = self.table["all_gather"]
        x = x.contiguous()
        if how == ALL_GATHER:
            outs = [torch.empty_like(x) for _ in range(self.ranks)]
            dist.all_gather(outs, x, group=self.group)
            return torch.stack(outs)
        if how == ALL_GATHER_TENSOR:
            out = x.new_empty((self.ranks,) + tuple(x.shape))
            dist.all_gather_into_tensor(out, x, group=self.group)
            return out
        raise ValueError(f"unknown all_gather realization {how!r}")

    def _reduce_scatter(self, x: torch.Tensor) -> torch.Tensor:
        """(P, ...) a rank -> (...): slot p summed over ranks, to rank p."""
        import torch.distributed as dist
        how = self.table["reduce_scatter"]
        x = x.contiguous()
        if how == REDUCE_SCATTER:
            out = x.new_empty(tuple(x.shape[1:]))
            dist.reduce_scatter(out, list(x.unbind(0)), group=self.group)
            return out
        if how == REDUCE_SCATTER_TENSOR:
            out = x.new_empty(tuple(x.shape[1:]))
            dist.reduce_scatter_tensor(out, x, group=self.group)
            return out
        raise ValueError(f"unknown reduce_scatter realization {how!r}")

    def _exchange(self, sends: dict, recv_like: torch.Tensor,
                  recvs: Sequence[int]) -> dict:
        """Point-to-point: ``sends[q]`` to rank q for each q, one tensor
        shaped like ``recv_like`` from each rank in ``recvs``."""
        import torch.distributed as dist
        how = self.table["p2p"]
        if how == P2P:
            ops, out = [], {}
            for q, t in sends.items():
                ops.append(dist.P2POp(dist.isend, t.contiguous(),
                                      self.peers[q], group=self.group))
            for q in recvs:
                out[q] = torch.empty_like(recv_like)
                ops.append(dist.P2POp(dist.irecv, out[q], self.peers[q],
                                      group=self.group))
            if ops:
                for req in dist.batch_isend_irecv(ops):
                    req.wait()
            return out
        if how == P2P_BY_GATHER:
            # one slot a (sender, receiver) pair, every pair in one gather
            slots = recv_like.new_zeros((self.ranks,) + tuple(recv_like.shape))
            for q, t in sends.items():
                slots[q] = t
            every = self._all_gather(slots)         # (P senders, P, ...)
            return {q: every[q, self.rank] for q in recvs}
        raise ValueError(f"unknown p2p realization {how!r}")

    # -- the axis ------------------------------------------------------------

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """(L, ...) -> (...): the sum over all M machines (this rank's L in
        machine order, then over ranks); differentiable."""
        self._local(x, "psum")
        out = _AllReduceSum.apply(_sum0(x), self)
        self._count("psum", _nbytes(out))
        return out

    def psum_start(self, x: torch.Tensor):
        """``psum`` started asynchronously (``all_reduce(async_op=True)``):
        a handle whose ``wait()`` returns the sum."""
        import torch.distributed as dist
        self._local(x, "psum")
        out = _sum0(x).contiguous()
        self._count("psum", _nbytes(out))
        work = dist.all_reduce(out, group=self.group, async_op=True)
        return _Pending(work, out)

    def psum_ranks(self, x: torch.Tensor) -> torch.Tensor:
        """A partial already summed over this rank's machines, summed over
        ranks; differentiable."""
        out = _AllReduceSum.apply(x, self)
        self._count("psum", _nbytes(out))
        return out

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        """(L, ...) -> (...): the largest over all M machines."""
        import torch.distributed as dist
        self._local(x, "pmax")
        out = self._all_reduce(x.amax(0).contiguous(), dist.ReduceOp.MAX)
        self._count("pmax", _nbytes(out))
        return out

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """(L, ...) -> (M, ...): every machine's rows, in machine order;
        differentiable."""
        self._local(x, "all_gather")
        out = _GatherRanks.apply(x, self)
        out = out.reshape((self.size,) + tuple(x.shape[1:]))
        self._count("all_gather", _nbytes(out))
        return out

    def gather_ranks(self, x: torch.Tensor) -> torch.Tensor:
        """One tensor a rank -> (P, ...) in rank order; differentiable."""
        out = _GatherRanks.apply(x, self)
        self._count("all_gather", _nbytes(out))
        return out

    def psum_scatter(self, x: torch.Tensor) -> torch.Tensor:
        """(L, M, ...) -> (L, ...): machine i receives the sum over machines
        m of x[m, i] (``psum_scatter(..., tiled=False)``): this rank's L
        summed first, then a reduce-scatter of the (M, ...) partial."""
        self._local(x, "psum_scatter")
        part = _sum0(x)
        part = part.reshape((self.ranks, self.local) + tuple(part.shape[1:]))
        out = self._reduce_scatter(part)
        self._count("psum_scatter", _nbytes(out) // self.local)
        return out

    def ppermute(self, x: torch.Tensor, perm) -> torch.Tensor:
        """(L, ...) -> (L, ...): machine d receives machine s's rows for each
        (s, d) in ``perm``, zeros where none is sent. Pairs within this rank
        are copied; the rest go point to point, one message a peer rank."""
        self._local(x, "ppermute")
        out = torch.zeros_like(x)
        lo, hi = self.start, self.start + self.local
        sends: dict[int, list] = {}
        recvs: dict[int, list] = {}
        for s, d in perm:
            mine_s, mine_d = lo <= s < hi, lo <= d < hi
            if mine_s and mine_d:
                out[d - lo] = x[s - lo]
            elif mine_s:
                sends.setdefault(d // self.local, []).append((s, d))
            elif mine_d:
                recvs.setdefault(s // self.local, []).append((s, d))
        # the same message shape for every pair of ranks: all L rows, with
        # the rows not sent left zero (a ring sends one)
        msgs = {}
        for q, pairs in sends.items():
            m = torch.zeros_like(x)
            for s, d in pairs:
                m[d - q * self.local] = x[s - lo]
            msgs[q] = m
        got = self._exchange(msgs, x, sorted(recvs))
        for q, pairs in recvs.items():
            for s, d in pairs:
                out[d - lo] = got[q][d - lo]
        self._count("ppermute", _nbytes(out) // self.local)
        return out


class _Pending:
    def __init__(self, work, out):
        self.work, self.out = work, out

    def wait(self):
        self.work.wait()
        return self.out


def _tree_map(fn, tree):
    """``fn`` over the tensors of a tensor, tuple, list, dict or
    NamedTuple; other leaves pass through."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return tree


@dataclasses.dataclass(frozen=True)
class Runner:
    """Machine-axis executor."""

    @property
    def num_machines(self) -> int:
        raise NotImplementedError

    @property
    def axis(self):
        """The machine-axis object the per-machine programs take as
        ``axis_name``."""
        raise NotImplementedError

    def map(self, fn: Callable, sharded: Sequence, replicated: Sequence = ()):
        """Run ``fn(*sharded, *replicated)``, where every ``sharded`` tensor
        carries this process's (L, ...) machine stack and ``fn`` is written
        batched over it. Returns ``fn``'s (L, ...) outputs."""
        return fn(*sharded, *replicated)

    def gather(self, tree):
        """Every (L, ...) stack of ``tree`` all-gathered to (M, ...), in
        machine order (the identity on a ``StackedAxis``)."""
        return _tree_map(self.axis.all_gather, tree)

    def reduce_grads(self, grads):
        """Gradients of a replicated objective, one set a process, as the
        gradient of the objective: the mean over processes (each process's
        backward already summed the collectives' gradients over processes;
        one process's are the objective's)."""
        ax = self.axis
        return _tree_map(lambda g: ax.psum_ranks(g) / ax.ranks, grads)

    def shard_blocks(self, X: torch.Tensor) -> torch.Tensor:
        """(n, ...) -> this process's (L, n/M, ...) rows of the (M, n/M,
        ...) block layout (paper Def. 1).

        Training data must divide exactly — zero-padding data rows would
        corrupt the local summaries (a padded row adds a spurious noise-only
        observation to Sigma_{DmDm|S}). Query batches are row-independent and
        go through ``pad_blocks`` instead.
        """
        return self._mine(self.block_layout(X))

    def block_layout(self, X: torch.Tensor) -> torch.Tensor:
        """(n, ...) -> the whole (M, n/M, ...) block layout, every machine's
        rows (what ``shard_blocks`` takes this process's rows of)."""
        M = self.num_machines
        n = X.shape[0]
        if n % M != 0:
            raise ValueError(
                f"n={n} does not divide among M={M} machines (Def. 1). "
                f"Either trim/re-block the data so M | n, or — for query "
                f"batches — use parallel.runner.pad_blocks(X, M), which "
                f"zero-pads and returns the valid count for trimming.")
        return X.reshape((M, n // M) + tuple(X.shape[1:]))

    def pad_blocks(self, X: torch.Tensor) -> tuple[torch.Tensor, int]:
        """This process's rows of the zero-padded (M, ceil(n/M), ...) block
        layout; see ``pad_blocks``."""
        Xb, n = pad_blocks(X, self.num_machines)
        return self._mine(Xb), n

    def _mine(self, Xb: torch.Tensor) -> torch.Tensor:
        ax = self.axis
        return Xb[ax.start:ax.start + ax.local]

    def unshard(self, Xb: torch.Tensor) -> torch.Tensor:
        return Xb.reshape((-1,) + tuple(Xb.shape[2:]))


@dataclasses.dataclass(frozen=True)
class VmapRunner(Runner):
    """All M machines on one device, as one batched program."""
    M: int = 4

    @property
    def num_machines(self) -> int:
        return self.M

    @functools.cached_property
    def axis(self) -> StackedAxis:
        return StackedAxis(self.M)


@dataclasses.dataclass(frozen=True)
class ShardMapRunner(Runner):
    """The machines spread over processes: the ranks of ``mesh``'s axes
    ``axis_name`` (one mesh dimension, or a tuple of them as in the
    reference's ("pod", "data")), ``local_machines`` machines each, in
    machine order: rank order over the named axes, row-major.

    Building one is a collective call: every rank of the mesh builds it,
    with the same arguments, in the same order (a tuple of axes creates a
    process group for each coordinate of the other axes). ``device`` is
    where this rank's tensors live; by default the mesh's device type at
    the current CUDA device (or the CPU)."""
    mesh: object = None
    axis_name: object = "data"
    local_machines: int = 1
    device: object = None

    def __post_init__(self):
        if self.mesh is None:
            raise ValueError("ShardMapRunner needs a DeviceMesh "
                             "(launch.mesh.make_mesh)")
        object.__setattr__(self, "_axis", self._build_axis())

    @property
    def axes(self) -> tuple[str, ...]:
        a = self.axis_name
        return (a,) if isinstance(a, str) else tuple(a)

    @property
    def num_machines(self) -> int:
        return self.axis.size

    @property
    def axis(self) -> DistAxis:
        return self._axis

    def _build_axis(self) -> DistAxis:
        import torch.distributed as dist
        names = tuple(self.mesh.mesh_dim_names or ())
        missing = [a for a in self.axes if a not in names]
        if missing:
            raise ValueError(f"mesh axes {names} have no {missing}")
        grid = self.mesh.mesh
        dims = [names.index(a) for a in self.axes]
        rest = [i for i in range(grid.dim()) if i not in dims]
        groups = grid.permute(*rest, *dims).reshape(
            -1, math.prod(grid.shape[i] for i in dims))
        lists = [[int(r) for r in g] for g in groups]
        me = dist.get_rank()
        mine = next(g for g in lists if me in g)
        if len(self.axes) == 1:
            group = self.mesh.get_group(self.axes[0])
        else:
            group, _ = dist.new_subgroups_by_enumeration(lists)
        dev = self.device
        if dev is None:
            dev = (torch.device("cuda", torch.cuda.current_device())
                   if self.mesh.device_type == "cuda" else
                   torch.device(self.mesh.device_type))
        return DistAxis(group, mine, self.local_machines, dev)


def make_runner(mode: str, *, M: int | None = None, mesh=None,
                axis_name="machines", local_machines: int = 1,
                device=None) -> Runner:
    """``VmapRunner(M)`` for ``"vmap"``; for ``"shard_map"`` a
    ``ShardMapRunner`` over ``mesh``'s axes ``axis_name`` with
    ``local_machines`` machines a rank."""
    if mode == "vmap":
        return VmapRunner(M=M)
    if mode == "shard_map":
        return ShardMapRunner(mesh=mesh, axis_name=axis_name,
                              local_machines=local_machines, device=device)
    raise ValueError(f"unknown runner mode {mode!r}")


def pad_blocks(X: torch.Tensor, M: int) -> tuple[torch.Tensor, int]:
    """(n, ...) -> ((M, ceil(n/M), ...), n): zero-pad to the block layout.

    For *query* batches only: query rows are independent in every predictive
    equation, so padded rows produce garbage predictions for themselves and
    affect nothing else — callers slice outputs back to the returned valid
    count ``n``. (Training data must not be padded; see Runner.shard_blocks.)
    """
    n = X.shape[0]
    b = -(-n // M)
    pad = M * b - n
    if pad:
        X = torch.cat([X, X.new_zeros((pad,) + tuple(X.shape[1:]))])
    return X.reshape((M, b) + tuple(X.shape[1:])), n


def scatter_by_block(X: torch.Tensor, assign: torch.Tensor, M: int):
    """Scatter (n, ...) rows into an (M, n, ...) block layout by assignment.

    The routed-serving counterpart of ``pad_blocks``: row i lands in block
    ``assign[i]`` at the next free slot (original order preserved within a
    block — stable sort). Capacity is ``n`` per block, so the output shape
    depends only on (n, M), and a fully-skewed batch (all rows on one block)
    still fits. Unoccupied slots stay zero; per-row independence of the
    predictive equations makes them inert (see ``pad_blocks``).

    Returns ``(Xb, order, block_of, slot)`` where ``Xb[block_of[j], slot[j]]
    == X[order[j]]``; pass the triple to ``gather_by_block`` to restore
    caller order.
    """
    n = X.shape[0]
    order = torch.argsort(assign, stable=True)             # group by block
    block_of = assign[order]                               # (n,) sorted ids
    starts = torch.searchsorted(
        block_of, torch.arange(M, dtype=block_of.dtype, device=X.device))
    slot = torch.arange(n, device=X.device) - starts[block_of]
    Xb = X.new_zeros((M, n) + tuple(X.shape[1:]))
    Xb[block_of, slot] = X[order]
    return Xb, order, block_of, slot


def _unsort(picked: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """``out[order] = picked``: sorted order back to caller order."""
    out = torch.zeros_like(picked)
    out[order] = picked
    return out


def gather_by_block(vals: torch.Tensor, order: torch.Tensor,
                    block_of: torch.Tensor,
                    slot: torch.Tensor) -> torch.Tensor:
    """Invert ``scatter_by_block`` on per-row outputs: (M, n, ...) -> (n, ...)
    in the original caller order."""
    return _unsort(vals[block_of, slot], order)


# ---------------------------------------------------------------------------
# Two-bucket routed scatter: capacity-bounded main bucket + skew overflow.
#
# ``scatter_by_block``'s capacity-n layout is shape-stable and skew-proof but
# computes M*n rows to serve n queries. The two-bucket scheme keeps both
# properties at ~(1 + 1/alpha) x:
#
#   * main bucket    — (M, cap) per-block layout with cap = alpha*ceil(n/M):
#     each block keeps its first cap routed rows (stable order);
#   * overflow bucket — (G, cap) groups for the rows a skewed batch pushes
#     past a block's capacity, one BLOCK per group; each group records the
#     block whose cached factors serve it, so an overflow row computes the
#     same per-row program as in the capacity-n layout.
#
# G is static: at most n/cap <= M/alpha blocks overflow, so G =
# ceil(M/alpha). When cap >= n no row can overflow and G = 0.
# ---------------------------------------------------------------------------


class RoutedLayout(NamedTuple):
    """Two-bucket scatter result + the bookkeeping to invert it.

    ``Xb[block_of[j], rank[j]] == X[order[j]]`` for main rows
    (``in_main[j]``); overflow row j sits at ``Xo[group[j], slot_o[j]]`` and
    must be served with block ``block_of[j]``'s factors (= ``o_blk`` of its
    group). Pass per-row outputs to ``gather_two_bucket``.
    """
    Xb: torch.Tensor               # (M, cap, ...) main routed bucket
    Xo: torch.Tensor | None        # (G, cap, ...) overflow (None: G == 0)
    o_blk: torch.Tensor | None     # (G,) block id served by each group
    order: torch.Tensor            # (n,) argsort(assign), stable
    block_of: torch.Tensor         # (n,) assignment in sorted order
    rank: torch.Tensor             # (n,) intra-block arrival rank
    group: torch.Tensor            # (n,) overflow group (junk if in_main)
    slot_o: torch.Tensor           # (n,) slot within the overflow group
    in_main: torch.Tensor          # (n,) bool: row landed in the main bucket

    @property
    def padded_rows(self) -> int:
        """Total computed rows (both buckets) — the compute the layout pays."""
        go = 0 if self.Xo is None else self.Xo.shape[0]
        return (self.Xb.shape[0] + go) * self.Xb.shape[1]


def routed_capacity(n: int, M: int, *, alpha: int = ROUTED_ALPHA,
                    tile: int = 1,
                    max_groups: int | None = None) -> tuple[int, int]:
    """(cap, G) of the two-bucket layout — static given (n, M, alpha).

    ``tile`` rounds cap up to a multiple of the serving query tile.
    ``max_groups`` selects a SMALLER overflow program (lazy overflow
    dispatch): the routed ServePlan counts the per-block occupancy on the
    host and runs the G=0 program on balanced traffic. The caller owns the
    sufficiency contract: rows past the declared groups' capacity are
    dropped by the scatter, so the count and the assignment driving the
    scatter must come from one float path (``ppic.PICServePlan`` passes its
    host assignment into the program). Values above the worst case are
    clamped."""
    cap = min(alpha * (-(-n // M)), n)
    cap = -(-cap // tile) * tile
    G = 0 if cap >= n else -(-M // alpha)
    if max_groups is not None:
        G = min(G, max_groups)
    return cap, G


def scatter_two_bucket(X: torch.Tensor, assign: torch.Tensor, M: int, *,
                       alpha: int = ROUTED_ALPHA, tile: int = 1,
                       max_groups: int | None = None) -> RoutedLayout:
    """Scatter (n, ...) rows into the two-bucket routed layout by assignment.

    Shape-stable: every tensor depends only on (n, M, alpha, tile,
    max_groups). Unoccupied slots stay zero (inert, see ``pad_blocks``). A
    row that no slot takes (past ``max_groups``' capacity) goes to the trash
    row of a buffer one larger, which is sliced off: the reference's drop.
    """
    n = X.shape[0]
    dev = X.device
    cap, G = routed_capacity(n, M, alpha=alpha, tile=tile,
                             max_groups=max_groups)
    order = torch.argsort(assign, stable=True)             # group by block
    block_of = assign[order]                               # (n,) sorted ids
    starts = torch.searchsorted(
        block_of, torch.arange(M + 1, dtype=block_of.dtype, device=dev))
    counts = torch.diff(starts)                            # (M,) block loads
    rank = torch.arange(n, device=dev) - starts[block_of]  # intra-block rank
    in_main = rank < cap
    rows = X[order]

    Xb = X.new_zeros((M + 1, cap) + tuple(X.shape[1:]))    # row M: trash
    Xb[torch.where(in_main, block_of, M),
       torch.where(in_main, rank, 0)] = rows
    Xb = Xb[:M]

    if G == 0:
        zero = torch.zeros((n,), dtype=rank.dtype, device=dev)
        return RoutedLayout(Xb, None, None, order, block_of, rank,
                            zero, zero, in_main)

    # overflow: block m's surplus o_m fills ceil(o_m/cap) exclusive groups
    om = torch.clamp(counts - cap, min=0)
    gm = -(-om // cap)                                     # groups per block
    gstart = torch.cumsum(gm, 0) - gm                      # exclusive prefix
    orank = torch.clamp(rank - cap, min=0)                 # > 0 iff overflow
    group = gstart[block_of] + orank // cap
    slot_o = orank % cap
    gi = torch.where(in_main | (group >= G), G, group)     # group G: trash
    Xo = X.new_zeros((G + 1, cap) + tuple(X.shape[1:]))
    Xo[gi, torch.where(gi == G, 0, slot_o)] = rows
    o_blk = block_of.new_zeros((G + 1,))
    o_blk[gi] = block_of                  # one block a group: same values
    return RoutedLayout(Xb, Xo[:G], o_blk[:G], order, block_of, rank,
                        group, slot_o, in_main)


def gather_two_bucket(vals_main: torch.Tensor,
                      vals_over: torch.Tensor | None,
                      lay: RoutedLayout) -> torch.Tensor:
    """Invert ``scatter_two_bucket`` on per-row outputs: (M, cap, ...) +
    (G, cap, ...) -> (n, ...) in the original caller order."""
    picked = vals_main[lay.block_of,
                       torch.clamp(lay.rank, max=vals_main.shape[1] - 1)]
    if vals_over is not None:
        over = vals_over[torch.clamp(lay.group, max=vals_over.shape[0] - 1),
                         lay.slot_o]
        cond = lay.in_main.reshape((-1,) + (1,) * (picked.ndim - 1))
        picked = torch.where(cond, picked, over)
    return _unsort(picked, lay.order)
