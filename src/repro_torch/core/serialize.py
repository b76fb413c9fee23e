"""Versioned posterior-state and incremental-store persistence (npz) —
port of ``repro.core.serialize``.

The port reads and writes exactly the reference's files: the same keys
(``__schema__``, ``__state__``, ``field:<name>``; ``__store_schema__``,
``__store__``, ``arr:``/``sum:``/``blk:``/``param:`` arrays), the same JSON
metadata (``__kernel__``, ``__runner__``, ``__serve_spec__``) and the same
``__checksums__`` map of a crc32 over each array's bytes. A state or store
written by either package loads in the other, its arrays bitwise.

What differs is only what the two packages name differently:

* **Kernel metadata.** The port's ``KernelSpec.impl`` names are ``auto`` /
  ``cuda`` / ``torch``; the reference knows ``auto`` / ``pallas`` /
  ``pallas_interpret`` / ``jnp`` and builds its ``KernelSpec`` without
  checking the name. So the port WRITES the reference's names (``cuda`` ->
  ``pallas``, ``torch`` -> ``jnp``) and reads any of them back through
  ``covariance._IMPL_ALIASES`` into its own (``pallas`` -> ``cuda``,
  ``pallas_interpret`` and ``jnp`` -> ``torch``), so a spec round-trips to
  an equal ``ServeSpec`` in both packages.
* **Runner metadata.** The reference's ``VmapRunner`` carries an
  ``axis_name``, which its loader requires; the port's has none. The port
  writes the reference's default, ``"machines"``, and ignores the name on
  load.
* **Dtypes.** The loader never changes one: a float32 ``PICFStore`` the
  reference wrote keeps its float32 ``Phi_L``/``yF`` (and is served in
  float32, as the reference serves it); a store the port wrote keeps its
  float64 R-space. A tensor numpy cannot hold (bfloat16, float8) is
  refused on save, and a field torch cannot hold is refused on load.
* **Devices.** ``load_state``/``load_store`` put the tensors on ``device``,
  the CUDA card unless named (``repro_torch/device.py``). Saving copies
  each field to the host once (a CPU tensor is not copied at all) and
  computes its crc on that copy, so a large store (a float32 ``PICStore``
  at AIMPEAK writes 1.45 GB; ``chip_smoke.py`` phase 4f) never holds a
  second copy in memory.
* **Traced values.** The reference refuses tracers; the port refuses the
  tensors it cannot materialize — meta tensors and tensors wrapped by a
  ``torch.func`` transform — and detaches the rest.

Anything unencodable (a bespoke kernel closure, a runner of another kind,
such as a ``ShardMapRunner``, whose mesh and process group belong to one
process) is recorded as opaque and must be re-supplied through
``kfn=``/``runner=`` at load time, failing loudly otherwise. A store
fitted over ranks holds every machine's blocks, so it saves as a whole on
any rank.
"""
from __future__ import annotations

import contextlib
import json
import pathlib
import zipfile
import zlib

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.core import api
from repro_torch.core import covariance as cov

SCHEMA_VERSION = 1
STORE_SCHEMA_VERSION = 1

_FIELD = "field:"
_PARAM = "param:"

# the port's KernelSpec.impl names as the reference writes them
_IMPL_TO_FILE = {"cuda": "pallas", "torch": "jnp"}
# the runner axis name the reference's loader needs (its VmapRunner default)
_AXIS_NAME = "machines"


class CheckpointError(ValueError):
    """A checkpoint file cannot be trusted: missing, truncated, corrupt, or
    failing its embedded per-field checksums. Carries the offending ``path``
    and a human ``reason`` — the serving runtime's revive path keys on this
    (a corrupt artifact must be DETECTED, never loaded into a tenant)."""

    def __init__(self, path, reason: str):
        self.path = str(path)
        self.reason = reason
        super().__init__(f"{self.path}: {reason}")


@contextlib.contextmanager
def _checkpoint_io(path, kind: str):
    """Translate the raw failure modes of reading an npz — zipfile CRC or
    central-directory errors on truncated or bit-flipped files, ``KeyError``
    on missing entries, NumPy header ``ValueError``s — into one
    CheckpointError with the path attached. Our own CheckpointErrors pass
    through."""
    try:
        yield
    except CheckpointError:
        raise
    except FileNotFoundError as e:
        raise CheckpointError(path, f"no such {kind}") from e
    except (zipfile.BadZipFile, EOFError, KeyError, OSError, ValueError) as e:
        raise CheckpointError(
            path, f"truncated or corrupt {kind} "
                  f"({type(e).__name__}: {e})") from e


def _crc(a: np.ndarray) -> int:
    """crc32 of the array's C-order bytes, read through the buffer protocol
    (no copy for a C-contiguous array)."""
    return zlib.crc32(np.ascontiguousarray(a))


def _checksum_meta(payload: dict) -> np.str_:
    return np.str_(json.dumps({k: _crc(v) for k, v in payload.items()}))


def _verify_checksums(path, z, arrays: dict) -> None:
    """Check materialized arrays against the embedded ``__checksums__`` map
    (absent on pre-checksum checkpoints: nothing to verify). The zip layer
    already CRCs each entry's bytes; this pins the DECODED array content
    too, so a file that unzips cleanly but decodes to other bits (header
    tampering, a partial rewrite) still fails loudly."""
    if "__checksums__" not in z.files:
        return
    want = json.loads(str(z["__checksums__"]))
    for k, a in arrays.items():
        if k in want and _crc(a) != want[k]:
            raise CheckpointError(
                path, f"checksum mismatch for {k!r} (file is corrupt — "
                      f"expected crc {want[k]}, got {_crc(a)})")


def _unmaterializable(v) -> bool:
    """A tensor with no data to copy: on the meta device, or wrapped by a
    ``torch.func`` transform (vmap, grad) — the port's tracers."""
    return isinstance(v, torch.Tensor) and (
        v.is_meta or torch._C._functorch.is_functorch_wrapped_tensor(v))


def _refuse_traced(what: str, leaves: dict, kind: str) -> None:
    traced = [k for k, v in leaves.items() if _unmaterializable(v)]
    if traced:
        raise TypeError(
            f"{what} materializes every {kind} on the host and cannot run "
            f"under a torch.func transform or on the meta device (traced "
            f"{kind}s: {traced}); checkpoint from the serving loop, not "
            f"inside a transformed function")


def _host(what: str, key: str, v: torch.Tensor) -> np.ndarray:
    """``v`` as a numpy array: one host copy of a device tensor, none of a
    CPU tensor; a dtype numpy cannot hold is refused."""
    try:
        return v.detach().cpu().numpy()
    except TypeError as e:
        raise TypeError(
            f"{what} cannot write {key!r}: numpy has no {v.dtype} "
            f"(the npz format holds numpy dtypes only; cast the field "
            f"first)") from e


def _tensor(path, key: str, a: np.ndarray, dev: torch.device):
    """An array read from the file as a tensor on ``dev``, its dtype kept;
    a dtype torch cannot hold is refused."""
    try:
        t = torch.from_numpy(a)
    except TypeError as e:
        raise CheckpointError(
            path, f"field {key!r} has dtype {a.dtype}, which torch cannot "
                  f"hold") from e
    return t.to(dev)


STATE_TYPES: dict[str, type] = {}


def register_state(cls: type) -> type:
    """Register a NamedTuple state type for save/load by name."""
    if not hasattr(cls, "_fields"):
        raise TypeError(f"{cls!r} is not a NamedTuple state type")
    STATE_TYPES[cls.__name__] = cls
    return cls


for _cls in (api.FGPState, api.PITCState, api.PICState, api.PICFState):
    register_state(_cls)


def save_state(path, state) -> pathlib.Path:
    """Write a registered PosteriorState to ``path`` (npz). Returns the
    path actually written (always exactly ``path`` — no implicit .npz
    suffix)."""
    name = type(state).__name__
    if name not in STATE_TYPES:
        raise ValueError(
            f"cannot serialize unregistered state type {name!r}; "
            f"registered: {sorted(STATE_TYPES)} (register_state to extend)")
    path = pathlib.Path(path)
    fields = dict(zip(state._fields, state))
    what = f"save_state({name})"
    _refuse_traced(what, fields, "field")
    payload = {_FIELD + f: _host(what, f, v) for f, v in fields.items()}
    with open(path, "wb") as fh:
        np.savez(fh, __schema__=np.int64(SCHEMA_VERSION),
                 __state__=np.str_(name),
                 __checksums__=_checksum_meta(payload), **payload)
    return path


def load_state(path, *, device=None):
    """Reconstruct the state saved at ``path`` on ``device`` (the CUDA card
    unless named); bitwise-identical fields, dtypes kept. Truncated or
    corrupt files (and checksum failures) raise ``CheckpointError``."""
    dev = _device.resolve(device)
    with _checkpoint_io(path, "state checkpoint"), \
            np.load(pathlib.Path(path), allow_pickle=False) as z:
        if "__schema__" not in z or "__state__" not in z:
            raise CheckpointError(path, "not a repro state checkpoint")
        schema = int(z["__schema__"])
        if schema != SCHEMA_VERSION:
            raise CheckpointError(
                path, f"schema v{schema} != supported v{SCHEMA_VERSION}")
        name = str(z["__state__"])
        if name not in STATE_TYPES:
            raise CheckpointError(
                path, f"unknown state type {name!r}; registered: "
                      f"{sorted(STATE_TYPES)}")
        cls = STATE_TYPES[name]
        saved = {k[len(_FIELD):] for k in z.files if k.startswith(_FIELD)}
        if saved != set(cls._fields):
            raise CheckpointError(
                path, f"field mismatch for {name}: file has "
                      f"{sorted(saved)}, {name} expects "
                      f"{sorted(cls._fields)} (state schema drifted — "
                      f"migrate the checkpoint)")
        arrays = {_FIELD + f: z[_FIELD + f] for f in cls._fields}
        _verify_checksums(path, z, arrays)
        return cls(*(_tensor(path, _FIELD + f, arrays[_FIELD + f], dev)
                     for f in cls._fields))


def peek(path) -> dict:
    """Cheap metadata read: {'state': type name, 'schema': int, 'fields':
    {name: (shape, dtype)}} without making tensors."""
    with _checkpoint_io(path, "state checkpoint"), \
            np.load(pathlib.Path(path), allow_pickle=False) as z:
        return {
            "state": str(z["__state__"]),
            "schema": int(z["__schema__"]),
            "fields": {k[len(_FIELD):]: (z[k].shape, str(z[k].dtype))
                       for k in z.files if k.startswith(_FIELD)},
        }


# ---------------------------------------------------------------------------
# Store checkpointing: persist the Sec. 5.2 algebra, not just its output.
# ---------------------------------------------------------------------------

def _kernel_meta(kfn) -> dict:
    """Encode a kernel by value where possible: a ``KernelSpec`` by its
    fields (its impl under the reference's name), a registry kernel by
    name. Anything else is opaque — recorded for the error message,
    re-supplied at load."""
    if isinstance(kfn, cov.KernelSpec):
        return {"kind": "spec", "name": kfn.name,
                "impl": _IMPL_TO_FILE.get(kfn.impl, kfn.impl),
                "fused": kfn.fused, "block_q": kfn.block_q}
    for name, fn in cov.KERNELS.items():
        if fn is kfn:
            return {"kind": "named", "name": name}
    return {"kind": "opaque", "repr": repr(kfn)}


def _kernel_from_meta(meta: dict, override):
    if override is not None:
        return override
    if meta["kind"] == "named":
        return cov.make_kernel(meta["name"])
    if meta["kind"] == "spec":
        impl = cov._IMPL_ALIASES.get(meta["impl"], meta["impl"])
        return cov.KernelSpec(meta["name"], impl, meta["fused"],
                              meta["block_q"])
    raise ValueError(
        f"store checkpoint carries an opaque kernel ({meta.get('repr')}); "
        f"pass load_store(..., kfn=<the fit-time kernel>) to restore")


def _spec_meta(spec: api.ServeSpec) -> dict:
    """Encode a ``ServeSpec`` as JSON metadata. Every field but the kernel
    is a plain scalar or tuple; the kernel reuses the kernel encoding (an
    opaque kernel is recorded and fails loudly at DECODE time, so a
    checkpoint is always writable and re-admission with an explicit
    ``spec=`` still works)."""
    return {
        "kernel": None if spec.kernel is None else _kernel_meta(spec.kernel),
        "block_q": spec.block_q, "max_batch": spec.max_batch,
        "buckets": None if spec.buckets is None else list(spec.buckets),
        "min_bucket": spec.min_bucket, "routed": spec.routed,
        "alpha": spec.alpha, "max_overflow_groups": spec.max_overflow_groups,
        "cached_cinv": spec.cached_cinv, "dtype": spec.dtype,
    }


def _spec_from_meta(meta: dict) -> api.ServeSpec:
    kernel = meta["kernel"]
    if kernel is not None and kernel["kind"] == "opaque":
        raise ValueError(
            f"store checkpoint's ServeSpec carries an opaque kernel "
            f"({kernel.get('repr')}); the serving policy cannot be "
            f"reconstructed from the artifact alone — pass an explicit "
            f"spec (e.g. TenantRegistry.admit_from_checkpoint(..., "
            f"spec=...))")
    kw = dict(meta, kernel=(None if kernel is None
                            else _kernel_from_meta(kernel, None)))
    buckets = kw["buckets"]
    kw["buckets"] = None if buckets is None else tuple(buckets)
    return api.ServeSpec(**kw)


def _runner_meta(runner) -> dict:
    from repro_torch.parallel.runner import VmapRunner
    if isinstance(runner, VmapRunner):
        return {"kind": "vmap", "M": int(runner.M), "axis_name": _AXIS_NAME}
    return {"kind": "opaque", "repr": repr(runner)}


def _runner_from_meta(meta: dict, override):
    from repro_torch.parallel.runner import VmapRunner
    if override is not None:
        return override
    if meta["kind"] == "vmap":      # the reference's axis_name: ignored
        return VmapRunner(M=meta["M"])
    raise ValueError(
        f"store checkpoint carries an opaque runner ({meta.get('repr')} — "
        f"e.g. a ShardMapRunner, whose mesh is process-local); pass "
        f"load_store(..., runner=<a runner for this process>) to restore")


def _summary_arrays(s) -> dict:
    return {"sum:ydot": s.locals_.ydot, "sum:Sdot": s.locals_.Sdot,
            "sum:F": s.F, "sum:alive": s.alive, "sum:Kss": s.Kss,
            "sum:Kss_L": s.Kss_L, "sum:Sdd_L": s.Sdd_L, "sum:ydd": s.ydd}


def _summary_from(arr):
    from repro_torch.core.online import SummaryStore
    from repro_torch.core.ppitc import LocalSummary
    return SummaryStore(LocalSummary(arr["sum:ydot"], arr["sum:Sdot"]),
                        arr["sum:F"], arr["sum:alive"], arr["sum:Kss"],
                        arr["sum:Kss_L"], arr["sum:Sdd_L"], arr["sum:ydd"])


def _pitc_store_arrays(store) -> dict:
    return {"arr:S": store.S, **_summary_arrays(store.store)}


def _pitc_store_from(kfn, params, runner, arr):
    from repro_torch.core.online import PITCStore
    return PITCStore(kfn, params, arr["arr:S"], runner, _summary_from(arr))


_PIC_BLOCK_FIELDS = ("Xb", "yb", "Ksd", "C_L", "Wy", "beta", "B")


def _pic_store_arrays(store) -> dict:
    out = {"arr:S": store.S, **_summary_arrays(store.store)}
    out.update({f"blk:{f}": getattr(store.blocks, f)
                for f in _PIC_BLOCK_FIELDS})
    return out


def _pic_store_from(kfn, params, runner, arr):
    from repro_torch.core.online import PICBlocks, PICStore
    blocks = PICBlocks(*(arr[f"blk:{f}"] for f in _PIC_BLOCK_FIELDS))
    return PICStore(kfn, params, arr["arr:S"], runner, _summary_from(arr),
                    blocks)


_PICF_FIELDS = ("Xb", "yb", "F", "Xp", "Lp", "alive", "Phi_L", "yF")


def _picf_store_arrays(store) -> dict:
    return {f"arr:{f}": getattr(store, f) for f in _PICF_FIELDS}


def _picf_store_from(kfn, params, runner, arr):
    from repro_torch.core.picf import PICFStore
    return PICFStore(kfn, params, runner,
                     *(arr[f"arr:{f}"] for f in _PICF_FIELDS))


_SUM_KEYS = ("sum:ydot", "sum:Sdot", "sum:F", "sum:alive", "sum:Kss",
             "sum:Kss_L", "sum:Sdd_L", "sum:ydd")

# name -> (flatten, rebuild(kfn, params, runner, arrays), expected keys)
STORE_TYPES: dict[str, tuple] = {
    "PITCStore": (_pitc_store_arrays, _pitc_store_from,
                  frozenset(("arr:S",) + _SUM_KEYS)),
    "PICStore": (_pic_store_arrays, _pic_store_from,
                 frozenset(("arr:S",) + _SUM_KEYS
                           + tuple(f"blk:{f}" for f in _PIC_BLOCK_FIELDS))),
    "PICFStore": (_picf_store_arrays, _picf_store_from,
                  frozenset(f"arr:{f}" for f in _PICF_FIELDS)),
}


def save_store(path, store, *, spec: api.ServeSpec | None = None
               ) -> pathlib.Path:
    """Write an incremental ``StateStore`` to ``path`` (npz). Arrays —
    summaries, factors, block caches, pivot basis, hyperparameters —
    round-trip bitwise; the kernel and runner are encoded as metadata (see
    the module docstring). ``spec=`` embeds the deployment's ``ServeSpec``
    too, making the file a complete serving artifact: a restarted fleet
    member re-admits the tenant — posterior, streaming algebra and serving
    policy — from it alone
    (``serving.TenantRegistry.admit_from_checkpoint``). Each field is
    copied to the host once. Returns the path written."""
    name = type(store).__name__
    if name not in STORE_TYPES:
        raise ValueError(
            f"cannot serialize store type {name!r}; "
            f"supported: {sorted(STORE_TYPES)}")
    flatten, _, _ = STORE_TYPES[name]
    leaves = flatten(store)
    leaves.update({_PARAM + k: v for k, v in store.params.items()})
    what = f"save_store({name})"
    _refuse_traced(what, leaves, "leaf")
    payload = {k: _host(what, k, v) for k, v in leaves.items()}
    payload["__checksums__"] = _checksum_meta(payload)
    if spec is not None:
        payload["__serve_spec__"] = np.str_(json.dumps(_spec_meta(spec)))
    path = pathlib.Path(path)
    with open(path, "wb") as fh:
        np.savez(fh, __store_schema__=np.int64(STORE_SCHEMA_VERSION),
                 __store__=np.str_(name),
                 __kernel__=np.str_(json.dumps(_kernel_meta(store.kfn))),
                 __runner__=np.str_(json.dumps(_runner_meta(store.runner))),
                 **payload)
    return path


def load_store(path, *, kfn=None, runner=None, with_spec: bool = False,
               device=None):
    """Reconstruct the store saved at ``path`` on ``device`` (the CUDA card
    unless named); arrays bitwise-identical and dtypes kept, so a restarted
    fleet resumes assimilating exactly where the checkpoint left off.
    ``kfn``/``runner`` override the encoded members (REQUIRED when the
    checkpoint recorded them as opaque).

    ``with_spec=True`` returns ``(store, spec)`` where ``spec`` is the
    embedded ``ServeSpec`` (``None`` when the file was saved without
    ``spec=``).

    Truncated or corrupt files — and files whose arrays fail the embedded
    ``__checksums__`` — raise ``CheckpointError`` (path + reason): the
    serving revive path must tell 'artifact is bad' from 'loader is
    broken'."""
    dev = _device.resolve(device)
    with _checkpoint_io(path, "store checkpoint"), \
            np.load(pathlib.Path(path), allow_pickle=False) as z:
        if "__store_schema__" not in z or "__store__" not in z:
            raise CheckpointError(
                path, "not a repro store checkpoint (state checkpoints "
                      "load via load_state)")
        schema = int(z["__store_schema__"])
        if schema != STORE_SCHEMA_VERSION:
            raise CheckpointError(
                path, f"store schema v{schema} != supported "
                      f"v{STORE_SCHEMA_VERSION}")
        name = str(z["__store__"])
        if name not in STORE_TYPES:
            raise CheckpointError(
                path, f"unknown store type {name!r}; "
                      f"supported: {sorted(STORE_TYPES)}")
        _, rebuild, expect = STORE_TYPES[name]
        raw = {k: z[k] for k in z.files
               if k.startswith(("arr:", "sum:", "blk:", _PARAM))}
        _verify_checksums(path, z, raw)
        keys = {k for k in raw if not k.startswith(_PARAM)}
        if keys != set(expect):
            raise CheckpointError(
                path, f"field mismatch for {name}: file has "
                      f"{sorted(keys)}, expected {sorted(expect)} "
                      f"(store schema drifted — migrate the checkpoint)")
        kfn = _kernel_from_meta(json.loads(str(z["__kernel__"])), kfn)
        runner = _runner_from_meta(json.loads(str(z["__runner__"])), runner)
        spec = (None if not with_spec or "__serve_spec__" not in z.files
                else _spec_from_meta(json.loads(str(z["__serve_spec__"]))))
        arr = {k: _tensor(path, k, raw.pop(k), dev) for k in sorted(keys)}
        params = {k[len(_PARAM):]: _tensor(path, k, v, dev)
                  for k, v in raw.items()}
        store = rebuild(kfn, params, runner, arr)
        return (store, spec) if with_spec else store


def peek_store(path) -> dict:
    """Cheap metadata read for a store checkpoint: type, schema, kernel and
    runner encodings (as the file holds them: the reference's impl names),
    and array shapes/dtypes."""
    with _checkpoint_io(path, "store checkpoint"), \
            np.load(pathlib.Path(path), allow_pickle=False) as z:
        return {
            "store": str(z["__store__"]),
            "schema": int(z["__store_schema__"]),
            "kernel": json.loads(str(z["__kernel__"])),
            "runner": json.loads(str(z["__runner__"])),
            "serve_spec": (json.loads(str(z["__serve_spec__"]))
                           if "__serve_spec__" in z.files else None),
            "fields": {k: (z[k].shape, str(z[k].dtype)) for k in z.files
                       if k.startswith(("arr:", "sum:", "blk:", _PARAM))},
        }
