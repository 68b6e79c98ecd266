"""Checkpointing: atomic, keep-last-k, async.

Layout:  <dir>/step_<n>/   <tree>.pt   (leaf path -> tensor, torch.save)
                           meta.json   (step, tree names, extra)
         <dir>/step_<n>.tmp.*          (staging; atomic rename commits)

A tree is a dict of named tensors (a module's ``state_dict``), possibly
nested in dicts, lists, tuples and named tuples (the optimizer's
``AdamWState``); ``None`` leaves are kept as ``None``.

- *Atomic*: a checkpoint directory appears only via os.replace of a fully
  written staging dir — a crash mid-write never leaves a half checkpoint
  visible.
- *Keep-k*: older step dirs are pruned after a successful commit.
- *Async*: ``save(..., blocking=False)`` snapshots to host memory
  synchronously and writes in a daemon thread, overlapping I/O with the
  next training steps (which update the device tensors in place).
- ``restore`` returns trees shaped like its templates, each leaf on its
  template's device and dtype; a shape mismatch raises.  Re-sharding on
  restore comes with the sharding slice.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
from pathlib import Path
from typing import Any

import torch

from repro_torch.utils import get_logger

log = get_logger("train.checkpoint")

_SEP = "|"


def _items(tree: Any):
    """``(path part, child)`` of a dict, named tuple, list or tuple."""
    if isinstance(tree, dict):
        return [(f"k:{k}", v) for k, v in tree.items()]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [(f"n:{f}", getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (list, tuple)):
        return [(f"i:{i}", v) for i, v in enumerate(tree)]
    return None


def _flatten(tree: Any, prefix: str = "") -> dict[str, torch.Tensor]:
    """Leaf path -> a host copy of the tensor."""
    items = _items(tree)
    if items is None:
        if tree is None:
            return {}
        leaf = torch.as_tensor(tree).detach()
        return {prefix: leaf.to("cpu", copy=True)}
    flat = {}
    for part, child in items:
        flat.update(_flatten(child, f"{prefix}{_SEP}{part}" if prefix
                             else part))
    return flat


def _unflatten(template: Any, flat: dict, prefix: str = ""):
    items = _items(template)
    if items is None:
        if template is None:
            return None
        arr = flat[prefix]
        tmpl = torch.as_tensor(template)
        if tuple(arr.shape) != tuple(tmpl.shape):
            raise ValueError(f"checkpoint leaf {prefix}: shape "
                             f"{tuple(arr.shape)} != template "
                             f"{tuple(tmpl.shape)}")
        return arr.to(device=tmpl.device, dtype=tmpl.dtype, copy=True)
    kids = [_unflatten(child, flat, f"{prefix}{_SEP}{part}" if prefix
                       else part) for part, child in items]
    if isinstance(template, dict):
        return dict(zip(template, kids))
    if hasattr(template, "_fields"):
        return type(template)(*kids)
    return type(template)(kids)


class Checkpointer:
    def __init__(self, directory: str | os.PathLike, keep: int = 3):
        self.dir = Path(directory)
        self.keep = keep
        self.dir.mkdir(parents=True, exist_ok=True)
        self._thread: threading.Thread | None = None

    # ----------------------------------------------------------------- save
    def save(self, step: int, trees: dict[str, Any], extra: dict | None = None,
             blocking: bool = True) -> None:
        # snapshot to host NOW (the step updates the device tensors in place)
        host = {name: _flatten(tree) for name, tree in trees.items()}
        meta = {"step": int(step), "names": sorted(host),
                "extra": extra or {}}
        self.wait()
        if blocking:
            self._write(step, host, meta)
        else:
            self._thread = threading.Thread(
                target=self._write, args=(step, host, meta), daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, host: dict, meta: dict) -> None:
        final = self.dir / f"step_{step:012d}"
        staging = Path(tempfile.mkdtemp(prefix=f"step_{step:012d}.tmp.",
                                        dir=self.dir))
        try:
            for name, flat in host.items():
                torch.save(flat, staging / f"{name}.pt")
            (staging / "meta.json").write_text(json.dumps(meta))
            if final.exists():
                shutil.rmtree(final)
            os.replace(staging, final)
            log.info("checkpoint step %d committed (%s)", step, final)
            self._prune()
        except Exception:
            shutil.rmtree(staging, ignore_errors=True)
            raise

    def _prune(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep > 0 else []:
            shutil.rmtree(self.dir / f"step_{s:012d}", ignore_errors=True)

    # -------------------------------------------------------------- restore
    def all_steps(self) -> list[int]:
        out = []
        for p in self.dir.iterdir():
            if p.is_dir() and p.name.startswith("step_") and "tmp" not in p.name:
                if (p / "meta.json").exists():  # committed only
                    out.append(int(p.name[5:]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, templates: dict[str, Any], step: int | None = None):
        """Restore trees shaped like ``templates``: ``(step, trees,
        extra)``, or None when there is no checkpoint."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        d = self.dir / f"step_{step:012d}"
        meta = json.loads((d / "meta.json").read_text())
        out = {name: _unflatten(template, torch.load(
                   d / f"{name}.pt", map_location="cpu", weights_only=True,
                   mmap=True))
               for name, template in templates.items()}
        return int(meta["step"]), out, meta.get("extra", {})
