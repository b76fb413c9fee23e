"""Builds the port's CUDA kernels and loads them with ``ctypes``.

Each source ``repro_torch/kernels/**/csrc/<name>.cu`` compiles, at first use,
into its own shared library with a plain C interface:
``build/kernels/<name>-<hash>.so`` at the root of the checkout, where the
hash covers the source and the flags. An edited source therefore rebuilds
and an unchanged one loads as it is. ``build_all`` starts one ``nvcc`` per
missing library, all at once, and keeps each compiler's output (``-Xptxas
-v``: registers, shared memory, spills) beside the library as ``.log``.

Pointers cross the C boundary as ``ctypes.c_void_p`` and the stream as
``torch.cuda.current_stream().cuda_stream``; each C entry point returns
``cudaGetLastError()`` and the wrapper raises when it is not 0.

The flash-attention and SSD kernels have backward kernels
(``flash_attention_bwd.cu``, ``ssd_intra_chunk_bwd.cu``) that their wrappers
record through ``torch.autograd.Function``s. The others (rbf, its ICF and
exact instances, ``xcov_diag``, the downdate) have none, so their wrappers
call ``refuse_grad`` before they launch: a kernel's fresh output has no
``grad_fn``, and a graph through it would otherwise be cut without a word.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_KERNELS = Path(__file__).resolve().parent
BUILD_DIR = _KERNELS.parents[2] / "build" / "kernels"
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def sources() -> dict[str, Path]:
    """Kernel name (the source's stem) -> CUDA source."""
    return {p.stem: p for p in sorted(_KERNELS.glob("**/csrc/*.cu"))}


def target(name: str) -> Path:
    """The shared library ``name`` builds into."""
    src = sources()[name]
    digest = hashlib.sha256(src.read_bytes() + " ".join(FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    if (home / "bin" / "nvcc").exists():
        return str(home / "bin" / "nvcc")
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the CUDA "
                       "kernels are built on a machine with the CUDA toolkit")


def build_all() -> list[str]:
    """Compile every kernel library not built yet, one ``nvcc`` per source,
    all started together. Returns the names it built."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, src in sources().items():
        so = target(name)
        if so.exists():
            continue
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen([_nvcc(), *FLAGS, "-o", str(tmp), str(src)],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, tmp, so)
    failed = []
    for name, (proc, tmp, so) in jobs.items():
        out, _ = proc.communicate()
        so.with_suffix(".log").write_text(out)
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{out}")
        else:
            os.replace(tmp, so)   # atomic: a concurrent loader sees all or none
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return list(jobs)


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if need be."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            so = target(name)
            if not so.exists():
                build_all()
            lib = _LIBS[name] = ctypes.CDLL(str(so))
            lib.cuda_error_string.argtypes = [ctypes.c_int]
            lib.cuda_error_string.restype = ctypes.c_char_p
        return lib


def on_cpu(*tensors) -> bool:
    """True for all-CPU inputs (a wrapper's plain path), False for all
    inputs on one CUDA device (its kernel path); anything else raises."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"} and len({t.device for t in tensors}) == 1:
        return False
    raise ValueError(f"inputs must all lie on the CPU or all on one CUDA "
                     f"device; got {sorted(str(t.device) for t in tensors)}")


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        msg = lib.cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def refuse_grad(what: str, *tensors) -> None:
    """Raise where autograd would record ``what`` on these tensors (other
    arguments, such as a Python-float scale, are ignored): grad mode is on
    and one of them requires grad. The GP kernels (rbf, ICF, ``xcov_diag``)
    and the downdate return fresh tensors with no ``grad_fn`` (none has a
    backward kernel, as none of the reference's Pallas kernels has one), so
    a graph through them would be cut without a word: an MLE objective
    would lose dK/dθ and keep the noise term's gradient. The plain versions
    (``ref.py``; for the GP covariance ``covariance.make_kernel("se")``,
    what ``core.hyper`` takes) are differentiable."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what}: the CUDA kernel has no backward, and an input "
            f"requires grad; differentiate through the plain version "
            f"(ref.py; covariance.make_kernel('se') for the GP covariance, "
            f"as core.hyper does) or run under torch.no_grad()")
