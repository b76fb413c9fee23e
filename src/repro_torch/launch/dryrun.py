"""Dry-run of every (architecture x input shape x mesh) cell on the ``meta``
device, then the roofline terms — port of ``repro.launch.dryrun``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b \\
        --shape train_4k --mesh multi
    PYTHONPATH=src python -m repro_torch.launch.dryrun --gp   # the GP cells

The reference lowers and compiles each cell on 512 placeholder CPU devices
and reads XLA's cost and memory analyses. The port has no compiler; what it
runs is what it executes. So a cell runs rank 0's step itself, on tensors
of the ``meta`` device (shapes and dtypes, no data, no allocation; every
kernel wrapper takes its plain version there, ``kernels/build.py``):

- the mesh is a mapping of axis sizes, ``MESHES["single"]`` =
  {"data": 16, "model": 16} (256 cards) or ``MESHES["multi"]`` = {"pod": 2,
  "data": 16, "model": 16} (512); any small mapping can be passed to
  ``run_cell``. No process group is made;
- the step is the port's own: ``launch.train.make_train_step``'s
  ``on_mesh`` for a train cell, ``launch.serve.make_serve_step`` for a
  decode cell, and for a prefill cell the loss forward (or, with
  ``--prefill-last``, ``forward(logits_last_only=True)``) over the
  parameters gathered as ``on_mesh`` gathers them. It runs over
  ``RecordingAxes``, a ``sharding.MeshAxes`` whose collectives give each
  output its shape (every rank's chunk taken to be rank 0's) and add up
  calls and bytes received, by collective and by axis: the job of the
  reference's ``roofline/hlo_parse``, with every loop trip counted because
  eager code runs them all;
- per-rank bytes come from the specs the state is placed by
  (``train.state_specs``, ``serve.serve_state_specs``) through
  ``sharding.Placement.local_shape``: a train cell holds the parameters and
  Adam's two moments (3x the parameters, as the reference counts it; the
  two int32 step counters are not counted), a decode cell the parameters
  and the serve state (a KV cache's filled length is a host int in the
  port, 4 bytes of int32 a cache in the reference), a prefill cell the
  parameters;
- ``probe_flops`` runs the cell's function once at the global batch on
  one device, the whole depth, under ``torch.utils.flop_counter
  .FlopCounterMode`` (the reference solves for the layers from three
  lowerings because XLA counts a while body once; eager code needs none of
  that). It also counts the bytes of the traced ops (each op reads its
  tensor inputs and writes its outputs; views move nothing): the
  unfused-traffic upper bound, ``hlo_bytes``.

A record has the reference's keys (``roofline.analysis.Roofline``'s, then
``memory_analysis``, ``lower_s``, ``compile_s``, ``cost_analysis``,
``status``, ``wall_s``). Where the port has no XLA counterpart the key
holds the port's nearest reading, and the module says which:
``cost_analysis`` is rank 0's traced step (``flops``, ``bytes accessed``);
``memory_analysis`` its argument and output bytes (temporaries are not
traced: None); ``lower_s`` the seconds to build rank 0's state and step on
meta, ``compile_s`` the seconds its traced run took. ``host_values`` lists
the host readings the step made that meta cannot give (``_HostValues``)
and the value the dry-run supplied for each; nothing else changes path.
The LM steps make none; pPIC's fit reads its alive mask (all alive) and
pICF's pivot loop its owner (machine 0). One JSON per cell goes under
``experiments/dryrun_torch/``.

The GP cells (``--gp``) run ``ppitc``, ``ppic`` and ``picf`` ``predict``
through a ``parallel.runner.ShardMapRunner`` whose machine axis records its
collectives the same way (``RecordingDistAxis``; M = the mesh's cards, one
machine a rank), at n = 2^20, |S| = 2048, |U| = 2^15, R = 2048, d = 8.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import pathlib
import time
import traceback

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as _pytree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import ARCH_NAMES, get_config
from repro_torch.configs.shapes import SHAPES, ShapeSpec, applicable
from repro_torch.launch import serve as serve_lib
from repro_torch.launch import specs as specs_lib
from repro_torch.launch import train as train_lib
from repro_torch.models import transformer as tf
from repro_torch.optim.adam import Adam
from repro_torch.parallel import runner as runner_lib
from repro_torch.parallel import sharding as shd
from repro_torch.roofline import analysis

OUT_DIR = (pathlib.Path(__file__).resolve().parents[3] / "experiments"
           / "dryrun_torch")
MESHES = {"single": {"data": 16, "model": 16},
          "multi": {"pod": 2, "data": 16, "model": 16}}
META = torch.device("meta")


# ---------------------------------------------------------------------------
# counting: FLOP, the traced ops' bytes, collectives
# ---------------------------------------------------------------------------

def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _pytree_leaves(tree)
               if isinstance(t, torch.Tensor))


class _OpBytes(TorchDispatchMode):
    """Bytes of every op dispatched: its tensor inputs read and its outputs
    written (an output that is one of its inputs, as an in-place op's, is
    counted once); views move nothing."""

    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not func.is_view:
            ins = [t for t in _pytree_leaves((args, kwargs))
                   if isinstance(t, torch.Tensor)]
            seen = {id(t) for t in ins}
            outs = [t for t in _pytree_leaves(out)
                    if isinstance(t, torch.Tensor) and id(t) not in seen]
            self.total += _nbytes(ins) + _nbytes(outs)
        return out


class _HostValues(TorchDispatchMode):
    """Supplies the host readings a step makes of a meta tensor, which has
    no data: ``.item()`` (also a 0-dim tensor used as an index) and a copy
    to the CPU (``.cpu()``, then ``.numpy()``). A boolean reads as True
    (an alive mask: every machine alive), anything else as 0 (pICF's pivot
    owner: machine 0, so the r pivots are rows 0..r-1 of its block). Each
    kind of reading is listed in ``seen`` with how often it was made; the
    shapes that follow are those of any other value."""

    def __init__(self):
        super().__init__()
        self.seen: dict[tuple, int] = {}

    def _note(self, what: str, t: torch.Tensor, value) -> None:
        key = (what, str(t.dtype), tuple(t.shape), value)
        self.seen[key] = self.seen.get(key, 0) + 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        t = args[0] if args else None
        if isinstance(t, torch.Tensor) and t.device.type == "meta":
            if func is torch.ops.aten._local_scalar_dense.default:
                value = True if t.dtype == torch.bool else 0
                self._note("item", t, value)
                return value
            dev = kwargs.get("device")
            if func is torch.ops.aten._to_copy.default and dev is not None \
                    and torch.device(dev).type == "cpu":
                fill = t.dtype == torch.bool
                self._note("copy to the host", t, fill)
                return torch.full(t.shape, fill,
                                  dtype=kwargs.get("dtype") or t.dtype)
        return func(*args, **kwargs)

    def report(self) -> list:
        return [{"read": what, "dtype": dt, "shape": list(shape),
                 "supplied": value, "times": n}
                for (what, dt, shape, value), n in self.seen.items()]


class Counts:
    """FLOP (``FlopCounterMode``) and traced bytes (``_OpBytes``) of the
    ops run inside ``with counts():``, and the host readings of meta
    tensors supplied there (``_HostValues``)."""

    def __init__(self):
        self.flops, self.bytes = 0, 0
        self.host = _HostValues()

    @contextlib.contextmanager
    def __call__(self):
        fc, ob = FlopCounterMode(display=False), _OpBytes()
        with self.host, fc, ob:
            yield self
        self.flops += fc.get_total_flops()
        self.bytes += ob.total


class RecordingAxes(shd.MeshAxes):
    """``sharding.MeshAxes`` of rank 0 of a mesh given by its axis sizes,
    with no process group: each collective returns its output's shape
    (every rank's chunk taken to be this rank's, so a sum is this rank's
    value times the ranks and a max is this rank's value) and records it.

    ``calls[name] = [calls, bytes]`` for each of the three collectives a
    step calls (``_cat``, ``sum``, ``max``), bytes being the output's, as
    ``chip_smoke.py`` phase 10b counts them on the card; ``by_axis[axis] =
    [calls, bytes]`` the all-gathers and all-reduces under them, axis by
    axis (an all-gather over P ranks receives P chunks)."""

    def __init__(self, sizes):
        self.sizes = shd.axis_sizes(sizes)
        self.coords = {a: 0 for a in self.sizes}
        self.device = META
        self.axes = {}
        self.calls: dict[str, list] = {}
        self.by_axis: dict[str, list] = {}

    def _note(self, name: str, out: torch.Tensor, per_axis) -> None:
        row = self.calls.setdefault(name, [0, 0])
        row[0] += 1
        row[1] += _nbytes(out)
        for a, nb in per_axis:
            row = self.by_axis.setdefault(a, [0, 0])
            row[0] += 1
            row[1] += nb

    def _cat(self, t: torch.Tensor, name: str, dim: int) -> torch.Tensor:
        out = torch.cat([t] * self.sizes[name], dim)
        self._note("_cat", out, [(name, _nbytes(out))])
        return out

    def sum(self, t: torch.Tensor, names) -> torch.Tensor:
        live = self.live(names)
        for a in live:
            t = t * self.sizes[a]
        self._note("sum", t, [(a, self.sizes[a] * _nbytes(t))
                              for a in live])
        return t

    def max(self, t: torch.Tensor) -> torch.Tensor:
        live = self.live(self.sizes)
        if live:
            t = t.clone()
        self._note("max", t, [(a, _nbytes(t)) for a in live])
        return t

    def report(self, chips: int) -> dict:
        """The record's ``collective``: by collective and by axis, calls
        and bytes one rank receives; ``rank_bytes`` their sum over the
        collectives, ``total`` that times the ranks (every rank receives
        as much)."""
        rank = sum(b for _, b in self.calls.values())
        return {"collectives": {k: {"calls": c, "bytes": b}
                                for k, (c, b) in sorted(self.calls.items())},
                "by_axis": {k: {"calls": c, "bytes": b}
                            for k, (c, b) in sorted(self.by_axis.items())},
                "rank_bytes": rank, "total": rank * chips}


class RecordingDistAxis(runner_lib.DistAxis):
    """The GP machine axis of rank 0 of ``names`` of a mesh of axis sizes,
    L machines a rank, with no process group: the collectives give their
    outputs' shapes, and ``stats`` counts calls and bytes as every
    ``DistAxis`` does (bytes one machine receives)."""

    def __init__(self, sizes, names, local: int = 1):
        runner_lib._Axis.__init__(self)
        sizes = shd.axis_sizes(sizes)
        self.group, self.backend, self.table = None, "recording", {}
        self.ranks = math.prod(sizes[a] for a in names)
        self.peers, self.local, self.rank = list(range(self.ranks)), \
            int(local), 0
        self.size, self.start = self.ranks * self.local, 0
        self.device = META

    def _all_reduce(self, x, op=None):
        return x

    def _all_gather(self, x: torch.Tensor) -> torch.Tensor:
        return x.contiguous()[None].expand(
            (self.ranks,) + tuple(x.shape)).contiguous()

    def _reduce_scatter(self, x: torch.Tensor) -> torch.Tensor:
        return x[0].clone()

    def _exchange(self, sends: dict, recv_like: torch.Tensor,
                  recvs) -> dict:
        return {q: torch.empty_like(recv_like) for q in recvs}

    def psum_start(self, x: torch.Tensor):
        self._local(x, "psum")
        out = runner_lib._sum0(x).contiguous()
        self._count("psum", out.numel() * out.element_size())
        return runner_lib._Done(out)


@dataclasses.dataclass(frozen=True)
class RecordingRunner(runner_lib.ShardMapRunner):
    """``ShardMapRunner`` over a ``RecordingDistAxis``: ``mesh`` is a
    mapping of axis sizes, ``axis_name`` the machine axes."""

    def _build_axis(self):
        return RecordingDistAxis(self.mesh, self.axes, self.local_machines)


# ---------------------------------------------------------------------------
# abstract inputs and per-rank bytes
# ---------------------------------------------------------------------------

def batch_meta(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """The global batch of a train or prefill cell on meta (the reference's
    ``batch_sds``; dtypes as ``launch.specs`` maps them)."""
    return specs_lib.train_input_specs(cfg, shape)


def sharded_param_bytes(tree, specs, mesh) -> float:
    """Per-rank bytes of ``tree`` laid out by ``specs`` over ``mesh`` (axis
    sizes): each leaf's ``Placement.local_shape``. A leaf that is not a
    tensor (a cache's host-int length) holds no device bytes."""
    sizes, total = shd.axis_sizes(mesh), [0]

    def add(spec, t):
        total[0] += math.prod(shd.Placement(spec, sizes).local_shape(
            t.shape)) * t.element_size()
        return t
    shd.map_specs(add, specs, tree)
    return float(total[0])


def train_state(cfg: ModelConfig, mesh, opt: Adam | None = None):
    """(a train state on meta, its specs over ``mesh``, its per-rank
    bytes): the parameters and Adam's two moments, each laid out by the
    parameter rules (``train.state_specs``)."""
    opt = opt if opt is not None else Adam(lr=1e-4)
    state = train_lib.init_state(cfg, opt,
                                 generator=_generator(), device=META)
    specs = train_lib.state_specs(state, mesh)
    nbytes = sum(sharded_param_bytes(t, s, mesh) for t, s in (
        (state.params, specs.params), (state.opt.mu, specs.opt.mu),
        (state.opt.nu, specs.opt.nu)))
    return state, specs, nbytes


def serve_state(cfg: ModelConfig, mesh, *, batch: int, max_len: int,
                param_dtype=torch.float32, cache_dtype=torch.bfloat16,
                ring_cache: bool = False):
    """(parameters, serve state, their specs over ``mesh``, per-rank
    bytes) on meta: ``init_serve``'s caches of ``max_len`` positions, an
    enc-dec model's cross K/V precomputed (bfloat16), as the step over a
    mesh takes them."""
    params = tf.init_model(cfg, generator=_generator(), device=META,
                           dtype=param_dtype)
    state = tf.init_serve(cfg, batch, max_len, device=META,
                          cache_dtype=cache_dtype, ring_cache=ring_cache)
    if cfg.enc_dec:
        enc = torch.zeros((batch, cfg.enc_seq, cfg.d_model),
                          dtype=torch.bfloat16, device=META)
        state = state._replace(cross_kv=tf.precompute_cross_kv(params, enc,
                                                               cfg))
    pspec = shd.param_specs(params, mesh)
    sspec = serve_lib.serve_state_specs(cfg, mesh, batch=batch)
    nbytes = (sharded_param_bytes(params, pspec, mesh)
              + sharded_param_bytes(state, sspec, mesh))
    return params, state, pspec, sspec, nbytes


def dp_product(sizes: dict) -> int:
    return math.prod(sizes[a] for a in shd.dp_axes(sizes))


def _rows(t: torch.Tensor, spec_entry, axes: RecordingAxes) -> torch.Tensor:
    """This rank's rows of a global batch tensor split on dim 0 by
    ``spec_entry``."""
    return axes.shard(t, (spec_entry,))


def _generator():
    return torch.Generator().manual_seed(0)


# ---------------------------------------------------------------------------
# FLOP probe: the whole depth at the global batch, on one device
# ---------------------------------------------------------------------------

def probe_counts(cfg: ModelConfig, shape: ShapeSpec, kind: str,
                 moe_groups=1, ring_cache=False, last_logits=False) -> dict:
    """{"flops", "bytes"} of the cell's function run once at the global
    batch on one device (meta): the train step's loss and gradients (no
    remat, as the reference's probe) and its Adam update, the prefill's
    loss forward (or last-position logits), or one decode step."""
    B, T = shape.global_batch, shape.seq_len
    counts = Counts()
    if kind == "decode":
        params = tf.init_model(cfg, generator=_generator(), device=META)
        state = tf.init_serve(cfg, B, T + 8, device=META,
                              ring_cache=ring_cache)
        if cfg.enc_dec:
            enc = torch.zeros((B, cfg.enc_seq, cfg.d_model),
                              dtype=torch.bfloat16, device=META)
            state = state._replace(cross_kv=tf.precompute_cross_kv(
                params, enc, cfg))
        tok = specs_lib.decode_input_specs(cfg, shape)["token"]
        with counts():
            tf.decode_step(params, tok, state, cfg,
                           moe_groups=min(moe_groups, B) or 1)
        return {"flops": counts.flops, "bytes": counts.bytes}
    batch = batch_meta(cfg, shape)
    if kind == "train":
        opt = Adam(lr=1e-4)
        state = train_lib.init_state(cfg, opt, generator=_generator(),
                                     device=META)
        step, _ = train_lib.make_train_step(cfg, None, opt, remat=False,
                                            moe_groups=moe_groups)
        with counts():
            step(state, batch)
        return {"flops": counts.flops, "bytes": counts.bytes}
    params = tf.init_model(cfg, generator=_generator(), device=META)
    with counts(), torch.no_grad():
        _prefill(params, batch, cfg, moe_groups=moe_groups,
                 last_logits=last_logits)
    return {"flops": counts.flops, "bytes": counts.bytes}


def probe_flops(cfg: ModelConfig, shape, kind, moe_groups=1,
                ring_cache=False, last_logits=False) -> float:
    """FLOP of the cell's function at the global batch, the whole depth
    traced once (``probe_counts``)."""
    return float(probe_counts(cfg, shape, kind, moe_groups, ring_cache,
                        last_logits)["flops"])


def _prefill(params, batch: dict, cfg: ModelConfig, *, moe_groups: int,
             last_logits: bool, rows=None,
             compute_dtype=torch.bfloat16):
    """The prefill cell's function: the loss forward with remat, as the
    reference's prefill cell, or the last position's logits."""
    enc_kv = None
    if cfg.enc_dec:
        enc_kv = tf.encode(params, batch["frames"], cfg,
                           compute_dtype=compute_dtype)
    if last_logits:
        return tf.forward(params, batch.get("tokens"), cfg, enc_kv=enc_kv,
                          inputs_embeds=batch.get("inputs_embeds"),
                          moe_groups=moe_groups, rows=rows,
                          logits_last_only=True,
                          compute_dtype=compute_dtype)[0]
    return tf.lm_loss(params, batch.get("tokens"), batch["labels"], cfg,
                      enc_kv=enc_kv, inputs_embeds=batch.get("inputs_embeds"),
                      remat=True, moe_groups=moe_groups, rows=rows,
                      compute_dtype=compute_dtype)[0]


# ---------------------------------------------------------------------------
# rank 0's step over the recording axes
# ---------------------------------------------------------------------------

def _traced(axes: RecordingAxes, chips: int, nbytes: float, counts: Counts,
            t_lower: float, t_run: float, arg_bytes: int,
            out_bytes: int) -> dict:
    return {"bytes_per_device": nbytes, "flops": counts.flops,
            "bytes": counts.bytes, "collective": axes.report(chips),
            "lower_s": t_lower, "compile_s": t_run,
            "memory_analysis": {"argument_size_in_bytes": arg_bytes,
                                "output_size_in_bytes": out_bytes,
                                "temp_size_in_bytes": None,
                                "generated_code_size_in_bytes": None},
            "host_values": counts.host.report()}


def trace_train(cfg: ModelConfig, mesh, *, batch: int, seq: int,
                microbatches: int = 1, moe_groups: int = 1,
                compute_dtype=torch.bfloat16) -> dict:
    """Rank 0's train step (``make_train_step``'s ``on_mesh``, remat on)
    over ``RecordingAxes(mesh)`` on meta, a global batch of ``batch`` x
    ``seq`` in ``microbatches``: its per-rank state bytes (parameters and
    Adam's moments), FLOP, traced bytes and collectives."""
    t0 = time.perf_counter()
    axes = RecordingAxes(mesh)
    chips = math.prod(axes.sizes.values())
    opt = Adam(lr=1e-4)
    state, specs, nbytes = train_state(cfg, axes, opt)
    local = shd.local_shards(state, specs, axes)
    shape = ShapeSpec("cell", seq, batch, "train")
    entry = shd.batch_spec(axes)[0]
    rows = {k: _rows(v, entry, axes)
            for k, v in batch_meta(cfg, shape).items()}
    _, on_mesh = train_lib.make_train_step(
        cfg, axes, opt, microbatches=microbatches, remat=True,
        moe_groups=moe_groups, compute_dtype=compute_dtype)
    step = on_mesh(state)
    del state
    t_lower = time.perf_counter() - t0
    counts, t0 = Counts(), time.perf_counter()
    with counts():
        new, metrics = step(local, rows)
    return _traced(axes, chips, nbytes, counts, t_lower,
                   time.perf_counter() - t0, _nbytes((local, rows)),
                   _nbytes((new, metrics)))


def trace_prefill(cfg: ModelConfig, mesh, *, batch: int, seq: int,
                  moe_groups: int = 1, last_logits: bool = False,
                  compute_dtype=torch.bfloat16) -> dict:
    """Rank 0's prefill forward over ``RecordingAxes(mesh)``: the
    parameters gathered where they are read, as ``on_mesh`` gathers them
    (a layer's inside the layer, the rest once), then ``_prefill`` on this
    rank's rows."""
    t0 = time.perf_counter()
    axes = RecordingAxes(mesh)
    chips = math.prod(axes.sizes.values())
    params = tf.init_model(cfg, generator=_generator(), device=META)
    pspec = shd.param_specs(params, axes)
    nbytes = sharded_param_bytes(params, pspec, axes)
    local = shd.local_shards(params, pspec, axes)
    del params
    group = axes.group(shd.batch_axes(axes))
    shape = ShapeSpec("cell", seq, batch, "prefill")
    rows = {k: _rows(v, shd.batch_spec(axes)[0], axes)
            for k, v in batch_meta(cfg, shape).items()}
    t_lower = time.perf_counter() - t0
    counts, t0 = Counts(), time.perf_counter()
    with counts(), torch.no_grad():
        view = shd.gather_on_use(local, pspec, axes, group.names)
        gathered = {k: view[k] if k in ("layers", "encoder") else
                    shd.map_specs(lambda s, t: shd.gather_grad(
                        t, axes, s, group.names), pspec[k], v)
                    for k, v in local.items()}
        out = _prefill(gathered, rows, cfg, moe_groups=moe_groups,
                       last_logits=last_logits,
                       rows=group if group.size > 1 else None,
                       compute_dtype=compute_dtype)
    return _traced(axes, chips, nbytes, counts, t_lower,
                   time.perf_counter() - t0, _nbytes((local, rows)),
                   _nbytes(out))


def trace_decode(cfg: ModelConfig, mesh, *, batch: int, max_len: int,
                 steps: int = 1, param_dtype=torch.float32,
                 cache_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
                 ring_cache: bool = False) -> dict:
    """Rank 0's ``steps`` decode steps (``make_serve_step``) over
    ``RecordingAxes(mesh)``, from an empty cache of ``max_len`` positions
    (an enc-dec model's cross K/V precomputed, as the step over a mesh
    takes them): per-rank bytes of the parameters and the serve state,
    FLOP, traced bytes and collectives."""
    t0 = time.perf_counter()
    axes = RecordingAxes(mesh)
    chips = math.prod(axes.sizes.values())
    params, state, pspec, sspec, nbytes = serve_state(
        cfg, axes, batch=batch, max_len=max_len, param_dtype=param_dtype,
        cache_dtype=cache_dtype, ring_cache=ring_cache)
    local_p = shd.local_shards(params, pspec, axes)
    local_s = shd.local_shards(state, sspec, axes)
    _, built = serve_lib.make_serve_step(cfg, axes, batch=batch,
                                         compute_dtype=compute_dtype)
    sharded = built(params)
    del params, state
    lspec = shd.logits_spec(axes, batch=batch, vocab=cfg.vocab_padded)
    tok = _rows(torch.zeros((batch, 1), dtype=specs_lib.TOKEN_DTYPE,
                            device=META), lspec[0], axes)
    t_lower = time.perf_counter() - t0
    counts, t0 = Counts(), time.perf_counter()
    arg_bytes = _nbytes((local_p, local_s, tok))
    with counts(), torch.no_grad():
        for _ in range(steps):
            logits, local_s = sharded(local_p, tok, local_s)
    return _traced(axes, chips, nbytes, counts, t_lower,
                   time.perf_counter() - t0, arg_bytes,
                   _nbytes((logits, local_s)))


def trace_cell(cfg: ModelConfig, shape: ShapeSpec, mesh, *,
               ring_cache: bool = False, serve_bf16: bool = False,
               last_logits: bool = False) -> tuple[dict, int]:
    """Rank 0's step of a cell (the reference's ``lower_cell``), with the
    reference's settings: a train step in one microbatch, remat on; a
    prefill's loss forward; a decode step over a cache of T + 512
    positions (float32 parameters, bfloat16 with ``serve_bf16``). Returns
    (the trace, the cell's MoE routing groups)."""
    sizes = shd.axis_sizes(mesh)
    moe_groups = dp_product(sizes)
    B, T = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        return trace_decode(cfg, sizes, batch=B, max_len=T + 512,
                            param_dtype=(torch.bfloat16 if serve_bf16
                                         else torch.float32),
                            ring_cache=ring_cache), 1
    params = tf.init_model(cfg, generator=_generator(), device=META)
    if not shd.use_tp_policy(params) and \
            B % (moe_groups * sizes.get("model", 1)) == 0:
        moe_groups *= sizes.get("model", 1)
    del params
    if shape.kind == "train":
        return trace_train(cfg, sizes, batch=B, seq=T,
                           moe_groups=moe_groups), moe_groups
    return trace_prefill(cfg, sizes, batch=B, seq=T, moe_groups=moe_groups,
                         last_logits=last_logits), moe_groups


def _mesh(mesh) -> tuple[str, dict]:
    """(the record's mesh name, the axis sizes) of a name in ``MESHES`` or
    a mapping."""
    if isinstance(mesh, str):
        return mesh, dict(MESHES[mesh])
    sizes = shd.axis_sizes(mesh)
    return "_".join(f"{a}{n}" for a, n in sizes.items()), sizes


def run_cell(arch: str, shape_name: str, mesh_name="single", *,
             skip_probe=False, overrides=None, ring_cache: bool = False,
             serve_bf16: bool = False, last_logits: bool = False) -> dict:
    """One cell's record: rank 0's traced step, the probe and the roofline
    terms. ``mesh_name``: "single", "multi" or a mapping of axis sizes."""
    cfg = get_config(arch)
    if overrides:
        cfg = cfg.scaled(**overrides)
    shape = SHAPES[shape_name]
    name, sizes = _mesh(mesh_name)
    chips = math.prod(sizes.values())
    traced, moe_groups = trace_cell(cfg, shape, sizes, ring_cache=ring_cache,
                                    serve_bf16=serve_bf16,
                                    last_logits=last_logits)
    t0 = time.perf_counter()
    probe = ({"flops": 0, "bytes": 0} if skip_probe else
             probe_counts(cfg, shape, shape.kind,
                          moe_groups=dp_product(sizes), ring_cache=ring_cache,
                          last_logits=last_logits))
    roof = analysis.analyze(
        arch, shape_name, name, chips=chips,
        traced={"flops": probe["flops"], "bytes": probe["bytes"],
                "collective": traced["collective"]},
        cfg=cfg, shape=shape, bytes_per_device=traced["bytes_per_device"],
        ring_cache=ring_cache, param_bytes_each=2.0 if serve_bf16 else 4.0,
        last_logits=last_logits)
    rec = roof.to_json()
    rec.update({"memory_analysis": traced["memory_analysis"],
                "lower_s": traced["lower_s"],
                "compile_s": traced["compile_s"],
                "cost_analysis": {"flops": traced["flops"],
                                  "bytes accessed": traced["bytes"]},
                "probe_s": time.perf_counter() - t0,
                "mesh_sizes": sizes, "moe_groups": moe_groups,
                "host_values": traced["host_values"]})
    return rec


# ---------------------------------------------------------------------------
# GP (paper technique) dry-run cells
# ---------------------------------------------------------------------------

def run_gp_cell(method: str, mesh_name="single", *, n=1 << 20, s=2048,
                u=1 << 15, r=2048, d=8) -> dict:
    """``method``'s ``predict`` (ppitc, ppic, picf with U sharded) through a
    ``RecordingRunner`` over all the mesh's axes (M = its cards, one
    machine a rank), rank 0 on meta, float32: FLOP, traced bytes and the
    machine axis's collectives (calls and bytes a machine receives)."""
    from repro_torch.core import covariance as cov, picf, ppic, ppitc

    name, sizes = _mesh(mesh_name)
    chips = math.prod(sizes.values())
    runner = RecordingRunner(mesh=sizes, axis_name=tuple(sizes))
    M = runner.num_machines
    kfn = cov.make_kernel("se")
    params = cov.init_params(d, device=META)
    f32 = dict(dtype=torch.float32, device=META)
    X, y = torch.empty((n, d), **f32), torch.empty((n,), **f32)
    S, U = torch.empty((s, d), **f32), torch.empty((u, d), **f32)
    counts, t0 = Counts(), time.perf_counter()
    with counts(), torch.no_grad():
        if method == "ppitc":
            ppitc.predict(kfn, params, S, X, y, U, runner)
        elif method == "ppic":
            ppic.predict(kfn, params, S, X, y, U, runner)
        else:
            picf.predict(kfn, params, X, y, U, r, runner, shard_u=True)
    st = runner.axis.stats
    ops = sorted({k.split(":")[0] for k in st})
    rank = sum(st[f"{op}:bytes"] for op in ops)
    return {"method": method, "mesh": name, "chips": chips, "M": M,
            "n": n, "s": s, "u": u, "r": r,
            "flops": counts.flops, "bytes": counts.bytes,
            "collective": {**{op: st[f"{op}:bytes"] for op in ops},
                           "calls": {op: st[f"{op}:calls"] for op in ops},
                           "rank_bytes": rank, "total": rank * chips},
            "compile_s": time.perf_counter() - t0,
            "host_values": counts.host.report()}


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--gp", action="store_true")
    ap.add_argument("--skip-probe", action="store_true")
    ap.add_argument("--moe-dispatch", default=None,
                    help="override cfg.moe_dispatch (perf variants)")
    ap.add_argument("--ring-cache", action="store_true",
                    help="ring-buffer windowed KV caches (perf variant)")
    ap.add_argument("--serve-bf16", action="store_true",
                    help="bf16 weights for decode cells (perf variant)")
    ap.add_argument("--prefill-last", action="store_true",
                    help="last-position-only prefill logits (perf variant)")
    ap.add_argument("--suffix", default="",
                    help="output-name suffix for variant cells")
    ap.add_argument("--out", default=str(OUT_DIR))
    args = ap.parse_args(argv)
    overrides = ({"moe_dispatch": args.moe_dispatch}
                 if args.moe_dispatch else None)
    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)

    def write(name, rec):
        with open(out / f"{name}.json", "w") as f:
            json.dump(rec, f, indent=1)

    if args.gp:
        for method in ("ppitc", "ppic", "picf"):
            for mesh_name in ("single", "multi"):
                name = f"gp_{method}_{mesh_name}"
                t0 = time.time()
                try:
                    rec = run_gp_cell(method, mesh_name)
                    rec["status"] = "ok"
                except Exception as e:
                    rec = {"status": "fail", "error": str(e)[-4000:],
                           "trace": traceback.format_exc()[-8000:]}
                rec["wall_s"] = time.time() - t0
                print(name, rec.get("status"), f"{rec['wall_s']:.1f}s",
                      flush=True)
                write(name, rec)
        return 0

    cells = []
    if args.all:
        for a in ARCH_NAMES:
            for sname in SHAPES:
                for mesh_name in ("single", "multi"):
                    cells.append((a, sname, mesh_name))
    else:
        if args.arch is None or args.shape is None:
            ap.error("give --arch and --shape, or --all, or --gp")
        cells.append((args.arch, args.shape, args.mesh))

    for arch, sname, mesh_name in cells:
        name = f"{arch}_{sname}_{mesh_name}{args.suffix}"
        if not applicable(arch, sname):
            write(name, {"status": "skip",
                         "reason": "long_500k needs sub-quadratic attention "
                                   "(configs/shapes.py LONG_OK)"})
            print(name, "SKIP", flush=True)
            continue
        if (out / f"{name}.json").exists():
            rec = json.load(open(out / f"{name}.json"))
            if rec.get("status") == "ok":
                print(name, "CACHED", flush=True)
                continue
        t0 = time.time()
        try:
            rec = run_cell(arch, sname, mesh_name,
                           skip_probe=args.skip_probe, overrides=overrides,
                           ring_cache=args.ring_cache,
                           serve_bf16=args.serve_bf16,
                           last_logits=args.prefill_last)
            rec["status"] = "ok"
            print(f"{name} OK trace={rec['compile_s']:.1f}s "
                  f"probe={rec['probe_s']:.1f}s "
                  f"bottleneck={rec['bottleneck']} "
                  f"roofline={rec['roofline_fraction']:.3f}", flush=True)
        except Exception as e:
            rec = {"status": "fail", "error": str(e)[-4000:],
                   "trace": traceback.format_exc()[-8000:]}
            print(name, "FAIL", str(e)[:300], flush=True)
        rec["wall_s"] = time.time() - t0
        write(name, rec)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
