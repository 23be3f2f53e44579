"""Async checkpointing with atomic commit and re-placement on restore.

The port of ``repro.checkpoint.manager``, on the reference's on-disk
format, so either package restores the other's checkpoints of the same
tree (the same leaf keys):

- one ``.npy`` per leaf holding its raw bytes as uint8 (the key's ``/``
  written ``__``), and ``metadata.json`` with ``step``, ``extra`` and each
  leaf's key, shape and dtype name (``"float32"``, ``"bfloat16"``, ...);
  bfloat16 needs no ml_dtypes here: its bytes go through a ``torch.uint8``
  view and come back through a ``torch.bfloat16`` one;
- a checkpoint directory becomes visible ONLY via atomic rename from
  ``step_########.tmp`` — a host dying mid-write leaves a ``*.tmp`` dir
  that restore ignores — and ``keep_last`` bounds how many stay;
- ``save`` is asynchronous: the device→host snapshot is taken
  synchronously (consistent), the disk write happens on a background
  thread so the train loop resumes immediately; a write's error surfaces
  on the next ``save``/``wait``;
- ``restore(device=...)`` places every leaf on ``device``, and a missing
  leaf or a shape mismatch fails loudly;
- sharded trees (DTensor leaves, ``launch/steps.py::sharded``): ``save``
  gathers each leaf whole on every rank (a collective: every rank calls
  ``save``), rank 0 alone copies them to the host and writes the one
  checkpoint (the others' ``last_save`` counts 0 bytes), and the next
  ``wait`` (a blocking save's own) is a barrier, so every rank then sees
  the commit; ``restore(shardings=...)`` places each leaf on its mesh by
  its placements (``sharding/rules.py::to_placed``), whatever mesh saved
  it — the reference's ``shardings=``, its elastic re-placement.

Trees are nested dicts, lists and tuples of tensors and ``nn.Module``s.
A leaf's key is its path joined by ``/`` (dict keys, sequence indices,
and a module's parameter names with their dots as ``/``), as the
reference keys a pytree path.  ``restore`` returns a tree of the same
structure with new tensors, except that a module's parameters are loaded
into the module in place.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor

from repro_torch.sharding import rules


def _flatten(tree, prefix=()):
    """(path tuple, leaf) pairs of a tree, dict keys sorted as a pytree's."""
    if isinstance(tree, nn.Module):
        for n, p in tree.named_parameters():
            yield prefix + tuple(n.split(".")), p
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, prefix + (str(i),))
    else:
        yield prefix, tree


def _rebuild(tree, leaves: dict, prefix=()):
    """``tree``'s structure with its tensors replaced from ``leaves``
    (path -> tensor); a module's parameters are copied into it (a DTensor
    leaf replaces a parameter of other placements)."""
    if isinstance(tree, nn.Module):
        with torch.no_grad():
            for n, p in list(tree.named_parameters()):
                new = leaves[prefix + tuple(n.split("."))]
                if isinstance(new, DTensor) and not (
                        isinstance(p, DTensor)
                        and p.device_mesh == new.device_mesh
                        and p.placements == new.placements):
                    owner, _, leaf = n.rpartition(".")
                    mod = tree.get_submodule(owner) if owner else tree
                    par = nn.Parameter(new, requires_grad=p.requires_grad)
                    if isinstance(mod, nn.ParameterDict):
                        mod[leaf] = par
                    else:
                        setattr(mod, leaf, par)
                else:
                    p.copy_(new)
        return tree
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves, prefix + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, leaves, prefix + (str(i),))
                          for i, v in enumerate(tree))
    return leaves[prefix]


def _to_bytes(t: torch.Tensor) -> np.ndarray:
    """A tensor's raw bytes as a flat uint8 array (on the host)."""
    t = t.detach().contiguous().reshape(-1)
    return t.view(torch.uint8).cpu().numpy()


def _from_bytes(raw: np.ndarray, dtype: str, shape) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(raw)).view(
        getattr(torch, dtype)).reshape(shape)


def _whole(x) -> torch.Tensor:
    """The whole tensor of a DTensor leaf (gathered), a tensor as it is."""
    return x.full_tensor() if isinstance(x, DTensor) else x


def _placed_for(shardings, path):
    """The placement (``rules.Placed``) ``shardings`` gives the leaf at
    ``path``: nested dicts, lists and tuples followed key by key, a
    module's dict by the dotted parameter name of the rest of the path."""
    node = shardings
    for i, k in enumerate(path):
        if isinstance(node, rules.Placed):
            break
        if isinstance(node, dict):
            rest = ".".join(path[i:])
            if rest in node:
                return node[rest]
            node = node[k]
        else:
            node = node[int(k)]
    return node


def _device_of(like) -> torch.device:
    """Where a restored leaf goes by default: where ``like`` lies (the
    CPU for a meta tensor or a non-tensor)."""
    dev = getattr(like, "device", None)
    return dev if isinstance(dev, torch.device) and dev.type != "meta" \
        else torch.device("cpu")


class CheckpointManager:
    def __init__(self, directory: str, *, keep_last: int = 3):
        self.dir = directory
        self.keep_last = keep_last
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None
        self._barrier = False  # a sharded save's commit not yet awaited
        #: the last save's bytes, device->host snapshot and disk write (s)
        self.last_save = {"bytes": 0, "snapshot_s": 0.0, "write_s": 0.0}

    # -- save -------------------------------------------------------------------

    def save(self, step: int, tree, *, extra: dict | None = None,
             blocking: bool = False) -> None:
        self.wait()  # one in-flight write at a time; surfaces prior errors
        t0 = time.perf_counter()
        leaves = list(_flatten(tree))
        self._barrier = any(isinstance(x, DTensor) for _, x in leaves)
        # of a sharded tree, rank 0 writes the one checkpoint; every rank
        # meets the others at its next wait()
        writes = not self._barrier or dist.get_rank() == 0

        def snapshot(x):
            x = _whole(x)  # a collective: every rank gathers
            return _to_bytes(x) if writes else None
        # synchronous, consistent device->host snapshot, where it is written
        host = [("/".join(p), str(x.dtype).removeprefix("torch."),
                 list(x.shape), snapshot(x)) for p, x in leaves]
        stats = {"bytes": sum(a.nbytes for *_, a in host if a is not None),
                 "snapshot_s": time.perf_counter() - t0, "write_s": 0.0}
        self.last_save = stats
        meta = {
            "step": step,
            "extra": extra or {},
            "leaves": [{"key": k, "shape": s, "dtype": d}
                       for k, d, s, _ in host],
        }

        def write():
            try:
                t1 = time.perf_counter()
                tmp = os.path.join(self.dir, f"step_{step:08d}.tmp")
                final = os.path.join(self.dir, f"step_{step:08d}")
                shutil.rmtree(tmp, ignore_errors=True)
                os.makedirs(tmp)
                for k, _, _, raw in host:
                    np.save(os.path.join(tmp, k.replace("/", "__") + ".npy"),
                            raw)
                with open(os.path.join(tmp, "metadata.json"), "w") as f:
                    json.dump(meta, f)
                if os.path.exists(final):  # re-save of the same step: replace
                    old = final + ".old"
                    shutil.rmtree(old, ignore_errors=True)
                    os.rename(final, old)
                    shutil.rmtree(old, ignore_errors=True)
                os.rename(tmp, final)  # atomic commit
                self._gc()
                stats["write_s"] = time.perf_counter() - t1
            except Exception as e:  # surfaced on next save()/wait()
                self._error = e

        if blocking:
            if writes:
                write()
            self.wait()
        elif writes:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._barrier:  # every rank sees rank 0's commit
            self._barrier = False
            dist.barrier()
        if self._error is not None:
            e, self._error = self._error, None
            raise e

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep_last] if self.keep_last else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # -- restore -----------------------------------------------------------------

    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                if os.path.exists(os.path.join(self.dir, name, "metadata.json")):
                    out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, tree_like, step: int | None = None, *,
                device=None, shardings=None) -> tuple:
        """Restore into the structure of ``tree_like`` (its leaves give the
        expected shapes).  Each leaf goes to ``device``, or where
        ``tree_like``'s leaf lies; with ``shardings`` (a tree like
        ``tree_like``'s of ``rules.Placed``, a module's a dict by parameter
        name) it becomes a DTensor with those placements.  Returns (tree,
        step, extra)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        d = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(d, "metadata.json")) as f:
            meta = json.load(f)
        by_key = {l["key"]: l for l in meta["leaves"]}
        leaves = {}
        for path, like in _flatten(tree_like):
            k = "/".join(path)
            f = os.path.join(d, k.replace("/", "__") + ".npy")
            if not os.path.exists(f) or k not in by_key:
                raise KeyError(f"checkpoint {d} missing leaf {k!r}")
            info = by_key[k]
            arr = _from_bytes(np.load(f), info["dtype"], info["shape"])
            exp = tuple(like.shape)
            if tuple(arr.shape) != exp:
                raise ValueError(f"{k}: shape {tuple(arr.shape)} != expected {exp}")
            if shardings is not None:
                placed = _placed_for(shardings, path)
                leaves[path] = rules.place(arr, placed.mesh,
                                           placed.placements)
            else:
                leaves[path] = arr.to(device if device is not None
                                      else _device_of(like))
        return _rebuild(tree_like, leaves), step, meta["extra"]
