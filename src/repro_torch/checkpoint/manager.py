"""Checkpoint manager: rotation, async save, restore — port of
``repro.checkpoint.manager``, writing the same ``ckpt_<step>.msgpack``
files (``checkpoint/io.py``'s format).

An async save takes a host snapshot of the tree on the caller's thread (a
copy of every tensor, so the training loop may go on updating its state)
and writes it on a background thread; ``wait`` joins it, and the next save
waits for the previous one first. Restores come back on the devices of
``tree_like``'s tensors (or ``device``).
"""
from __future__ import annotations

import pathlib
import re
import threading

from repro_torch.checkpoint import io


class CheckpointManager:
    def __init__(self, directory: str | pathlib.Path, *, keep: int = 3):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def _path(self, step: int) -> pathlib.Path:
        return self.dir / f"ckpt_{step:010d}.msgpack"

    def steps(self) -> list[int]:
        out = []
        for p in self.dir.glob("ckpt_*.msgpack"):
            m = re.fullmatch(r"ckpt_(\d+)\.msgpack", p.name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> int | None:
        s = self.steps()
        return s[-1] if s else None

    def save(self, step: int, tree, *, sync: bool = True) -> None:
        if sync:
            self.wait()
            io.save(self._path(step), tree)
            self._rotate()
            return
        self.wait()
        snapshot = io.map_leaves(lambda _, leaf: io.to_numpy(leaf), tree)

        def work():
            try:
                io.save(self._path(step), snapshot)
                self._rotate()
            except BaseException as e:   # re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Join the pending async save; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def restore(self, step: int, tree_like, *, device=None):
        self.wait()
        return io.load(self._path(step), tree_like, device=device)

    def restore_latest(self, tree_like, *, device=None):
        self.wait()
        step = self.latest_step()
        if step is None:
            return None, None
        return step, self.restore(step, tree_like, device=device)

    def _rotate(self) -> None:
        steps = self.steps()
        for s in steps[:-self.keep]:
            self._path(s).unlink(missing_ok=True)
