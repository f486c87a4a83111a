"""Async, restart-safe checkpointing of the port's state trees.

Layout (one directory per step), as the JAX package's checkpointer writes
it:
    <dir>/step_000100/
        manifest.json      keys, shapes, dtypes, step, extras
        arrays.npz         one entry per leaf (path-encoded keys)
        mind_state.json    MIND control-plane snapshot (optional) — the
                           paper's backup-switch failover state (§3.2)

A key is the leaf's path in the tree (nested dicts and lists of tensors),
its dict keys and list indices joined by ``|``.  NumPy has no bfloat16: a
bf16 leaf is stored bit for bit as a ``uint16`` array, its dtype in the
manifest.  Writes go to ``<name>.tmp`` then rename — a crash mid-write never
corrupts the latest checkpoint (the launcher restores the newest COMPLETE
step).  ``save`` copies every leaf to the host before it returns, also with
``blocking=False``, so the in-place optimizer step that follows cannot
change what is written.  Restore puts each leaf on the template's device in
the template's dtype.
"""

from __future__ import annotations

import json
import shutil
import threading
from pathlib import Path

import numpy as np
import torch

_SEP = "|"


def _flatten(tree, path=()):
    """``{key: leaf}`` in tree order."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return {_SEP.join(map(str, path)): tree}
    out = {}
    for k, v in items:
        out.update(_flatten(v, (*path, k)))
    return out


def _unflatten(template, values, path=()):
    if isinstance(template, dict):
        return {k: _unflatten(v, values, (*path, k))
                for k, v in template.items()}
    if isinstance(template, list):
        return [_unflatten(v, values, (*path, i))
                for i, v in enumerate(template)]
    return values[_SEP.join(map(str, path))]


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A NumPy copy of ``t`` (bf16 as its uint16 bits; a DTensor whole,
    gathered from its shards)."""
    from torch.distributed.tensor import DTensor

    if isinstance(t, DTensor):
        t = t.full_tensor()
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _from_host(a: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


class Checkpointer:
    def __init__(self, directory: str | Path, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None

    # ------------------------------------------------------------------ #
    def save(self, step: int, state: dict, extras: dict | None = None,
             mind_snapshot: str | None = None, blocking: bool = True) -> Path:
        """state: tree of tensors (params/opt_state/...); extras:
        JSON-able."""
        leaves = _flatten(state)
        host = {k: _to_host(v) for k, v in leaves.items()}
        dtypes = {k: _dtype_name(v) for k, v in leaves.items()}

        def _write():
            final = self.dir / f"step_{step:08d}"
            tmp = self.dir / f"step_{step:08d}.tmp"
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
            np.savez(tmp / "arrays.npz", **host)
            manifest = {
                "step": step,
                "keys": sorted(host.keys()),
                "shapes": {k: list(v.shape) for k, v in host.items()},
                "dtypes": dtypes,
                "extras": extras or {},
            }
            (tmp / "manifest.json").write_text(json.dumps(manifest))
            if mind_snapshot is not None:
                (tmp / "mind_state.json").write_text(mind_snapshot)
            if final.exists():
                shutil.rmtree(final)
            tmp.rename(final)
            self._gc()

        def _write_async():
            try:
                _write()
            except Exception as e:  # re-raised by wait()
                self._error = e

        if blocking:
            _write()
        else:
            self.wait()
            self._thread = threading.Thread(target=_write_async, daemon=True)
            self._thread.start()
        return self.dir / f"step_{step:08d}"

    def wait(self) -> None:
        """Join the pending async save; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        steps = sorted(self.list_steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    # ------------------------------------------------------------------ #
    def list_steps(self) -> list[int]:
        out = []
        for p in self.dir.glob("step_*"):
            if p.suffix == ".tmp" or not (p / "manifest.json").exists():
                continue
            out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.list_steps()
        return steps[-1] if steps else None

    def restore(self, state_template, step: int | None = None,
                shardings=None):
        """Restore into the structure of ``state_template`` (a tree of
        tensors), each leaf on its template's device in its dtype.  With
        ``shardings`` (a tree of
        :class:`repro_torch.distributed.sharding.NamedSharding` laid out as
        the template), each leaf is then placed as a DTensor on its mesh,
        every rank keeping its own shard of what it read (the port's
        ``device_put``; a restore onto a resized mesh is the elastic
        re-mesh).  Returns (state, step, extras, mind_snapshot)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        d = self.dir / f"step_{step:08d}"
        manifest = json.loads((d / "manifest.json").read_text())
        values = {}
        with np.load(d / "arrays.npz") as data:
            for key, t in _flatten(state_template).items():
                a = _from_host(data[key], manifest["dtypes"][key])
                if tuple(a.shape) != tuple(t.shape):
                    raise ValueError(f"checkpoint leaf {key!r} has shape "
                                     f"{tuple(a.shape)}, the template "
                                     f"{tuple(t.shape)}")
                values[key] = a.to(device=t.device, dtype=t.dtype)
        state = _unflatten(state_template, values)
        if shardings is not None:
            from repro_torch.distributed.sharding import device_put

            state = device_put(state, shardings, src_data_rank=None)
        mind = None
        if (d / "mind_state.json").exists():
            mind = (d / "mind_state.json").read_text()
        return state, step, manifest["extras"], mind
