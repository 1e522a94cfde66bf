"""Fault-tolerant checkpointing, in the reference's on-disk format.

The reference's manager, kept piece for piece:
  * **async**: the write happens on a background thread; a save blocks
    only on the *previous* save (one-deep pipeline);
  * **atomic**: written to ``<dir>/tmp.<step>`` then ``os.replace``d into
    ``step_<step:010d>``: a preempted save never corrupts the latest good
    checkpoint;
  * **manifest**: ``manifest.json`` records the step, the leaf names and
    dtypes, and ``extra`` (the data cursor); restore checks the names and
    raises ``ValueError`` on a tree mismatch;
  * **keep-N** garbage collection;
  * **preemption**: ``install_sigterm_handler`` checkpoints and exits.

Format: ``arrays.npz`` holds ``leaf_<i>`` in the reference's flatten order
(dict keys sorted, dataclass fields in order, ``a/b/c`` names:
``train.pytree``), bfloat16 stored as a ``uint16`` view with its true
dtype in the manifest. So each package restores the other's checkpoints.
bfloat16 is read back through ``torch.int16`` and ``.view(torch.bfloat16)``.

**Elastic restore**: arrays are saved unsharded (gathered), so a
checkpoint restores onto whatever layout the relaunch defines.
``restore(like, step, device=)`` puts the leaves on one device (the device
of ``like``'s leaves when None); ``restore(..., shardings=)`` takes a
matching tree of ``distributed.sharding.NamedSharding`` (a ``DeviceMesh``
and placements, ``sharding.named_shardings``) and returns each leaf as a
DTensor with those placements on that mesh's device type, the same bits.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import signal
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.models.model import ParamTree
from repro_torch.train import pytree

_TORCH_DTYPES = {"float32": torch.float32, "float64": torch.float64,
                 "float16": torch.float16, "bfloat16": torch.bfloat16,
                 "int32": torch.int32, "int64": torch.int64,
                 "int16": torch.int16, "int8": torch.int8,
                 "uint8": torch.uint8, "bool": torch.bool}


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _to_host(leaf) -> np.ndarray:
    """A snapshot of a leaf as a host array for ``np.savez`` (bfloat16 as
    uint16 bits). It never shares storage with ``leaf``: the writer thread
    reads it while the next step updates the state in place."""
    if isinstance(leaf, np.ndarray):
        return np.array(leaf, copy=True)
    t = leaf.detach()
    # .cpu() copies a device tensor; a CPU tensor must be cloned
    t = t.clone() if t.device.type == "cpu" else t.cpu()
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _from_host(a: np.ndarray, dtype_name: Optional[str]) -> torch.Tensor:
    if dtype_name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # -- save ---------------------------------------------------------------

    def save(self, step: int, state, blocking: bool = False,
             extra: Optional[Dict] = None):
        """Checkpoint ``state`` (a ``TrainState``, ``ParamTree`` or nested
        dict of tensors). Non-blocking by default."""
        self.wait()  # one-deep pipeline: block on the previous save only
        # the device -> host copies happen on the caller's thread
        named, dtypes = [], []
        for n, x in pytree.named_leaves(state):
            dtypes.append(_dtype_name(x.dtype))
            named.append((n, _to_host(x)))
        meta = {
            "step": int(step),
            "time": time.time(),
            "n_leaves": len(named),
            "names": [n for n, _ in named],
            "dtypes": dtypes,
            "extra": extra or {},
        }

        def work():
            try:
                tmp = os.path.join(self.dir, f"tmp.{step}")
                final = os.path.join(self.dir, f"step_{step:010d}")
                os.makedirs(tmp, exist_ok=True)
                np.savez(os.path.join(tmp, "arrays.npz"),
                         **{f"leaf_{i}": a for i, (_, a) in enumerate(named)})
                with open(os.path.join(tmp, "manifest.json"), "w") as f:
                    json.dump(meta, f)
                if os.path.exists(final):
                    shutil.rmtree(final)
                os.replace(tmp, final)  # atomic publish
                self._gc()
            except BaseException as e:  # surfaced on the next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()
        if blocking:
            self.wait()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            e, self._error = self._error, None
            raise RuntimeError(f"async checkpoint failed: {e!r}") from e

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:010d}"),
                          ignore_errors=True)

    # -- restore --------------------------------------------------------------

    def all_steps(self) -> List[int]:
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step_"):
                out.append(int(d[len("step_"):]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, like, step: Optional[int] = None, device=None,
                shardings=None):
        """Restore into the structure of ``like`` (its leaves give the
        shapes and dtypes; meta tensors do). Returns (tree, manifest), or
        None when there is no checkpoint. The leaves land on ``device``, or
        each on its ``like`` leaf's device (a meta leaf: the CPU); with
        ``shardings`` (a tree of ``NamedSharding`` matching ``like``) each
        leaf is a DTensor laid out by its ``NamedSharding`` (the elastic
        re-shard path). A ``ParamTree`` comes back a ``ParamTree`` whose
        leaves require grad as ``like``'s do."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        final = os.path.join(self.dir, f"step_{step:010d}")
        with open(os.path.join(final, "manifest.json")) as f:
            meta = json.load(f)
        data = np.load(os.path.join(final, "arrays.npz"))
        named = pytree.named_leaves(like)
        names = [n for n, _ in named]
        if names != meta["names"]:
            raise ValueError(
                f"checkpoint tree mismatch: ckpt has {len(meta['names'])} "
                f"leaves, target has {len(names)}; first diff: "
                f"{next((a, b) for a, b in zip(meta['names'] + ['<end>'], names + ['<end>']) if a != b)}")
        saved_dtypes = meta.get("dtypes", [None] * len(named))
        layout = {}
        if shardings is not None:
            from repro_torch.distributed.sharding import NamedSharding
            layout = dict(pytree.named_leaves(
                shardings, leaf_types=(NamedSharding,)))
            if sorted(layout) != sorted(names):
                raise ValueError("shardings do not match the restore target")
        loaded = {}
        for i, (name, lk) in enumerate(named):
            t = _from_host(data[f"leaf_{i}"], saved_dtypes[i])
            if tuple(t.shape) != tuple(lk.shape):
                raise ValueError(f"leaf {name}: shape {tuple(t.shape)} != "
                                 f"{tuple(lk.shape)}")
            want = lk.dtype if isinstance(lk, torch.Tensor) else \
                _TORCH_DTYPES[str(lk.dtype)]
            sh = layout.get(name)
            dev = device
            if sh is not None:
                dev = sh.mesh.device_type
            elif dev is None:
                dev = lk.device if isinstance(lk, torch.Tensor) \
                    and lk.device.type != "meta" else "cpu"
            t = t.to(device=dev, dtype=want)
            if sh is not None:
                from torch.distributed.tensor import distribute_tensor
                t = distribute_tensor(t, sh.mesh, sh.placements)
            loaded[name] = t
        return _rebuild(like, loaded, ()), meta


def _rebuild(node, loaded: Dict[str, torch.Tensor], path):
    """``like``'s structure with the loaded leaves in place."""
    if node is None:
        return None
    if isinstance(node, (torch.Tensor, np.ndarray)):
        return loaded["/".join(path)]
    if isinstance(node, ParamTree):
        trainable = any(p.requires_grad for p in node.parameters())
        out = ParamTree(_rebuild(node.tree(), loaded, path))
        return out.requires_grad_(trainable)
    if dataclasses.is_dataclass(node):
        return dataclasses.replace(node, **{
            f.name: _rebuild(getattr(node, f.name), loaded,
                             path + ("." + f.name,))
            for f in dataclasses.fields(node)})
    return {k: _rebuild(v, loaded, path + (str(k),)) for k, v in node.items()}


def install_sigterm_handler(save_fn: Callable[[], None]):
    """On SIGTERM (preemption notice): checkpoint, then exit 0."""
    def handler(signum, frame):
        save_fn()
        os._exit(0)
    signal.signal(signal.SIGTERM, handler)
