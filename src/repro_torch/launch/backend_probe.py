"""Which collectives a ``torch.distributed`` backend carries for CUDA tensors.

    PYTHONPATH=src python -m repro_torch.launch.backend_probe [--backend gloo]

Tries each collective the machine axis (``parallel.runner``) could use on
two ranks that share ``cuda:0``: sum, max and int32 all-reduce, the list
and tensor forms of all-gather and reduce-scatter, ``batch_isend_irecv``
and a plain send/recv. Each op runs in its own pair of processes, all
pairs at once, so an op that kills its process (gloo reading a device
pointer from the host, say) takes no other reading with it. One JSON line
an op: ``carried`` (the result was right), ``wrong`` (it ran and gave
another value), ``raised`` (with the message) or ``died`` (exit code).
The last line is the table as one JSON object.

This is what ``runner.BACKEND_TABLE``'s ``("gloo", "cuda")`` entry is
read from; it is a probe, run by hand or by ``chip_smoke.py``, and no
code path consults it. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

OPS = ("all_reduce_sum", "all_reduce_max", "all_reduce_int32", "all_gather",
       "all_gather_into_tensor", "reduce_scatter", "reduce_scatter_tensor",
       "batch_isend_irecv", "send_recv")
WORLD = 2


def _run(op: str, rank: int, dev: torch.device):
    """(got, want) of ``op`` on this rank, as lists."""
    x = torch.arange(4, dtype=torch.float32, device=dev) + 10 * rank
    other = torch.arange(4, dtype=torch.float32) + 10 * (1 - rank)
    if op == "all_reduce_sum":
        y = x.clone()
        dist.all_reduce(y)
        return y, x.cpu() + other
    if op == "all_reduce_max":
        y = x.clone()
        dist.all_reduce(y, op=dist.ReduceOp.MAX)
        return y, torch.maximum(x.cpu(), other)
    if op == "all_reduce_int32":
        y = x.to(torch.int32)
        dist.all_reduce(y)
        return y, (x.cpu() + other).to(torch.int32)
    both = [torch.arange(4, dtype=torch.float32) + 10 * r
            for r in range(WORLD)]
    if op == "all_gather":
        outs = [torch.empty_like(x) for _ in range(WORLD)]
        dist.all_gather(outs, x)
        return torch.cat(outs), torch.cat(both)
    if op == "all_gather_into_tensor":
        out = torch.empty(WORLD * 4, dtype=x.dtype, device=dev)
        dist.all_gather_into_tensor(out, x)
        return out, torch.cat(both)
    chunks = torch.arange(WORLD * 2, dtype=torch.float32, device=dev) + rank
    want = (torch.arange(WORLD * 2, dtype=torch.float32) * WORLD
            + sum(range(WORLD)))[rank * 2:(rank + 1) * 2]
    if op == "reduce_scatter":
        out = torch.empty(2, dtype=x.dtype, device=dev)
        dist.reduce_scatter(out, list(chunks.chunk(WORLD)))
        return out, want
    if op == "reduce_scatter_tensor":
        out = torch.empty(2, dtype=x.dtype, device=dev)
        dist.reduce_scatter_tensor(out, chunks)
        return out, want
    recv = torch.empty_like(x)
    if op == "batch_isend_irecv":
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, x, 1 - rank),
            dist.P2POp(dist.irecv, recv, 1 - rank)])
        for r in reqs:
            r.wait()
        return recv, other
    if op == "send_recv":
        if rank == 0:
            dist.send(x, 1)
            dist.recv(recv, 1)
        else:
            dist.recv(recv, 0)
            dist.send(x, 0)
        return recv, other
    raise ValueError(op)


def _child(rank: int, op: str, backend: str, rdv: str, out: str) -> None:
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"file://{rdv}", rank=rank,
                            world_size=WORLD)
    try:
        got, want = _run(op, rank, dev)
        torch.cuda.synchronize()
        ok = torch.equal(got.cpu(), want)
        res = {"status": "carried" if ok else "wrong",
               "device_out": got.device.type}
    except Exception as e:                # the probe's reading, not a path
        res = {"status": "raised", "error": repr(e)[:300]}
    with open(f"{out}.{rank}", "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()


def probe(backend: str = "gloo", timeout: float = 120.0) -> dict:
    """op -> reading, for ``backend`` with CUDA tensors on two ranks."""
    if not torch.cuda.is_available():
        raise RuntimeError("the backend probe needs a CUDA card")
    ctx = mp.get_context("spawn")
    table = {}
    with tempfile.TemporaryDirectory() as tmp:
        procs = {}
        for op in OPS:
            out = os.path.join(tmp, op)
            procs[op] = [ctx.Process(target=_child, args=(
                r, op, backend, os.path.join(tmp, f"{op}.rdv"), out))
                for r in range(WORLD)]
            for p in procs[op]:
                p.start()
        for op, ps in procs.items():
            for p in ps:
                p.join(timeout)
                if p.is_alive():
                    p.kill()
                    p.join()
            codes = [p.exitcode for p in ps]
            reads = []
            for r in range(WORLD):
                path = os.path.join(tmp, f"{op}.{r}")
                if os.path.exists(path):
                    with open(path) as f:
                        reads.append(json.load(f))
            if len(reads) < WORLD or any(codes):
                table[op] = {"status": "died", "exit_codes": codes,
                             "reads": reads}
            elif any(r["status"] == "raised" for r in reads):
                table[op] = next(r for r in reads if r["status"] == "raised")
            elif all(r["status"] == "carried" for r in reads):
                table[op] = {"status": "carried"}
            else:
                table[op] = {"status": "wrong"}
    return table


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", default="gloo")
    args = ap.parse_args()
    table = probe(args.backend)
    for op, reading in table.items():
        print(json.dumps({"op": op, **reading}), flush=True)
    print(json.dumps({"backend": args.backend, "device": "cuda",
                      "torch": torch.__version__,
                      "table": {op: r["status"] for op, r in table.items()}}),
          flush=True)


if __name__ == "__main__":
    main()
