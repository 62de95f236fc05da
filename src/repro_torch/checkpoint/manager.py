"""Fault-tolerant checkpointing: atomic, async, content-verified
(counterpart of ``repro.checkpoint.manager``, on the same disk format).

Layout (one directory per step)::

    <dir>/step_00000100/
        manifest.json       # leaves: shape, dtype, sha256 per leaf
        <flat.key>.npy      # one file per leaf
    <dir>/step_00000100.COMMITTED   # empty marker written LAST (atomicity)

The leaf keys are the JAX package's tree paths (``params/cells/0/w``,
``opt/mu/head/b``, ``step`` as an int32 scalar), each leaf one ``.npy``
of its whole (unsharded) array, so a checkpoint written by either package
restores in the other. ``manifest.json``'s ``treedef`` is a description
only; restore reads the ``leaves`` table.

* Writes go to ``step_k.tmp-<pid>`` then ``os.rename`` (atomic on POSIX);
  the COMMITTED marker makes partially written checkpoints invisible to
  restore even across the rename.
* ``save_async`` copies the state to host memory synchronously and writes
  in a background thread: the training loop never waits on the disk.
* keep-last-k garbage collection, checksum verification on restore.

bfloat16 leaves are written as numpy's ``bfloat16`` extension type (from
``ml_dtypes``, which the JAX package writes and reads); where that module
is missing, such a leaf raises instead of being stored in another dtype.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from typing import Optional

import numpy as np
import torch

from repro_torch.core.params import flatten, unflatten


def _bf16():
    try:
        import ml_dtypes
    except ImportError as e:
        raise TypeError("a bfloat16 leaf needs the ml_dtypes module to be "
                        "written or read as numpy") from e
    return ml_dtypes.bfloat16


def _to_numpy(x) -> np.ndarray:
    """A leaf as a host numpy array (bfloat16 bit for bit)."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(_bf16())
        return t.numpy()
    return np.asarray(x)


def _from_numpy(a: np.ndarray, device) -> torch.Tensor:
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(a).to(device)


def _sha(arr: np.ndarray) -> str:
    return hashlib.sha256(arr.tobytes()).hexdigest()[:16]


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = str(directory)
        self.keep = keep
        os.makedirs(self.dir, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    # -- save -----------------------------------------------------------------

    def _snapshot(self, state) -> dict:
        return {k: np.array(_to_numpy(v)) for k, v in flatten(state).items()}

    def save(self, state, step: int):
        host = self._snapshot(state)
        # serialize with any in-flight async write: both would share the
        # per-pid tmp dir when saving the same step and race the rename
        self.wait()
        self._write(host, step)

    def save_async(self, state, step: int):
        """Snapshot now, write in the background."""
        host = self._snapshot(state)
        self.wait()
        self._thread = threading.Thread(target=self._write, args=(host, step),
                                        daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, flat: dict, step: int):
        name = f"step_{step:08d}"
        tmp = os.path.join(self.dir, f"{name}.tmp-{os.getpid()}")
        final = os.path.join(self.dir, name)
        os.makedirs(tmp, exist_ok=True)
        manifest = {"step": step, "leaves": {},
                    "treedef": "repro_torch: " + ", ".join(flat)}
        for key, arr in flat.items():
            fn = key.replace("/", ".") + ".npy"
            np.save(os.path.join(tmp, fn), arr, allow_pickle=False)
            manifest["leaves"][key] = {
                "file": fn, "shape": list(arr.shape), "dtype": str(arr.dtype),
                "sha256": _sha(arr)}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        # commit marker LAST: restore only trusts marked checkpoints
        open(final + ".COMMITTED", "w").close()
        self._gc()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            name = os.path.join(self.dir, f"step_{s:08d}")
            if os.path.exists(name + ".COMMITTED"):
                os.remove(name + ".COMMITTED")
            if os.path.exists(name):
                shutil.rmtree(name)

    # -- restore --------------------------------------------------------------

    def all_steps(self):
        out = []
        for f in os.listdir(self.dir):
            if f.endswith(".COMMITTED"):
                out.append(int(f[len("step_"):-len(".COMMITTED")]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, like_state, step: Optional[int] = None, *,
                device=None, verify: bool = True):
        """Rebuild ``like_state``'s tree from disk (its values unused).
        Each leaf lands on ``device``, or where ``like_state``'s leaf
        lives; a leaf that requires grad there comes back as a leaf that
        requires grad (the trainer's params)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no committed checkpoints in {self.dir}")
        path = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        out = {}
        for key, like in flatten(like_state).items():
            meta = manifest["leaves"][key]
            arr = np.load(os.path.join(path, meta["file"]), allow_pickle=False)
            if verify and _sha(arr) != meta["sha256"]:
                raise IOError(f"checksum mismatch for {key} at step {step}")
            dev = device if device is not None else (
                like.device if isinstance(like, torch.Tensor) else "cpu")
            t = _from_numpy(arr, dev)
            if isinstance(like, torch.Tensor) and like.requires_grad:
                t.requires_grad_(True)
            out[key] = t
        return unflatten(like_state, out)

