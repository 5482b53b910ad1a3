"""Checkpoint and restore of training state, in the JAX package's layout.

A port of ``train/checkpoint.py``: one ``step_XXXXXXXX/`` directory per
save, holding ``shard_00000.npz`` (one process) and ``manifest.json``; keys
are the ``/``-joined paths of the state's nested dicts (``p/emb/embed``,
``o/m/layers/attn/wq``, ``o/step``), as its ``_flatten`` writes them. Saves
run on a background thread (the caller copies the state to host memory
first, so training may go on updating it in place); ``wait()`` joins.
Old steps are removed past ``keep``. Checkpoints cross-load both ways:

- bf16: the JAX package writes a bf16 leaf as a 2-byte void array (its
  ``ml_dtypes`` bfloat16 has no numpy descriptor); ``restore`` reads such an
  array as raw bf16 bits. The port writes a bf16 leaf as its exact fp32
  values, which the JAX package's ``restore`` casts back (it cannot cast the
  void arrays it writes itself).
- every other dtype is written as it is, and restored into the dtype of
  the matching leaf of ``like``.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.models import common as cm


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t``; bf16 as its exact fp32 values."""
    t = t.detach().to("cpu", copy=True)
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _from_numpy(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """``a`` as a tensor of ``like``'s dtype on its device; a 2-byte void
    array is raw bf16 bits."""
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(device=like.device, dtype=like.dtype).reshape(like.shape)


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(directory, exist_ok=True)

    def wait(self):
        """Join the save in flight; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save(self, step: int, state: Dict[str, Any], blocking: bool = False):
        """state: nested dicts of tensors (params, opt_state, ...)."""
        self.wait()
        flat = {k: _to_numpy(v) for k, v in cm.flatten(state).items()}   # on the caller's thread

        def _write():
            try:
                path = os.path.join(self.dir, f"step_{step:08d}")
                tmp = path + ".tmp"
                os.makedirs(tmp, exist_ok=True)
                np.savez(os.path.join(tmp, "shard_00000.npz"), **flat)
                manifest = {"step": step, "time": time.time(), "n_processes": 1,
                            "treedef": "nested dicts of " + ", ".join(sorted(state)),
                            "keys": sorted(flat)}
                with open(os.path.join(tmp, "manifest.json"), "w") as f:
                    json.dump(manifest, f)
                os.replace(tmp, path)       # atomic publish
                self._gc()
            except BaseException as e:      # noqa: BLE001 - re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()
        if blocking:
            self.wait()

    def _gc(self):
        for s in self.all_steps()[:-self.keep]:
            p = os.path.join(self.dir, f"step_{s:08d}")
            for fn in os.listdir(p):
                os.unlink(os.path.join(p, fn))
            os.rmdir(p)

    def all_steps(self):
        return sorted(int(d.split("_")[1]) for d in os.listdir(self.dir)
                      if d.startswith("step_") and not d.endswith(".tmp"))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, like: Dict[str, Any], step: Optional[int] = None):
        """(state shaped like ``like``, on its devices and in its dtypes,
        step); the latest step unless one is given. Raises on a missing
        checkpoint, other keys or other shapes."""
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = os.path.join(self.dir, f"step_{step:08d}", "shard_00000.npz")
        flat_like = cm.flatten(like)
        with np.load(path) as data:
            if set(data.files) != set(flat_like):
                raise KeyError(f"checkpoint/tree mismatch: missing "
                               f"{sorted(set(flat_like) - set(data.files))}, unexpected "
                               f"{sorted(set(data.files) - set(flat_like))}")
            out = {}
            for key, leaf in flat_like.items():
                a = data[key]
                if a.shape != tuple(leaf.shape):
                    raise ValueError(f"{key}: checkpoint shape {a.shape}, "
                                     f"expected {tuple(leaf.shape)}")
                out[key] = _from_numpy(a, leaf)
        return cm.nest(out), step
