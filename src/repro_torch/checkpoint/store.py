"""Parameter-tree and plane checkpoints: an npz payload plus a JSON
manifest, in the JAX package's layout (``repro/checkpoint/store.py``),
so a file either package writes loads in the other bit for bit:

  * ``__manifest__``: a JSON string — for a tree its sorted ``keys``,
    ``dtypes`` and ``shapes`` and the caller's ``extra``; for a plane
    its ``dtype``, ``shape`` and ``PlaneSpec`` manifest;
  * one array per leaf under its ``/``-joined path with ``/`` written as
    ``§`` (the JAX package's ``"/".join`` of the dict keys and list
    indices, e.g. ``3/stages/s0/c0/w`` for client 3 of a loop run's
    per-client state; the port's trees flatten in the same order,
    ``repro_torch.tree``), or one ``__plane__`` array;
  * a bf16 array is stored as its raw ``uint16`` view and its dtype
    recorded as ``"bfloat16"``;
  * the file is written to a temporary name and renamed into place, so a
    reader never sees half a checkpoint.

Loading gives a nested dict of CPU tensors, or, with ``like``, tensors
arranged as the template tree (dicts and lists) with its leaves' dtypes
and devices.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Dict

import numpy as np
import torch

from repro_torch import tree as tu

# torch dtypes numpy has no type for, stored as a raw unsigned view
_RAW = {torch.bfloat16: np.uint16}


def _to_native(t: torch.Tensor):
    """(numpy array to store, dtype string for the manifest)."""
    t = t.detach().cpu().contiguous()
    if t.dtype in _RAW:
        raw = t.view(torch.int16).numpy().view(_RAW[t.dtype])
        return raw, str(t.dtype).replace("torch.", "")
    arr = t.numpy()
    return arr, str(arr.dtype)


def _from_native(arr: np.ndarray, dtype_str: str) -> torch.Tensor:
    """The stored array back as a CPU tensor of ``dtype_str``."""
    want = getattr(torch, dtype_str, None)
    if want in _RAW:
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)
                                ).view(want)
    if arr.dtype != np.dtype(dtype_str):
        arr = arr.astype(np.dtype(dtype_str))
    return torch.from_numpy(np.array(arr, copy=True))


def _atomic_savez(path: str, **arrays) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                               suffix=".npz")
    os.close(fd)
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


def save_pytree(path: str, tree, *, extra: Dict[str, Any] | None = None):
    """Persist a nested dict (or list of dicts) of tensors or arrays with
    ``extra`` in the manifest."""
    flat = {"/".join(p): _to_native(torch.as_tensor(leaf))
            for p, leaf in tu.flatten(tree)}
    manifest = {
        "keys": sorted(flat),
        "dtypes": {k: d for k, (_, d) in flat.items()},
        "shapes": {k: list(a.shape) for k, (a, _) in flat.items()},
        "extra": extra or {},
    }
    _atomic_savez(path, __manifest__=json.dumps(manifest),
                  **{k.replace("/", "§"): a for k, (a, _) in flat.items()})


def load_pytree(path: str, like=None):
    """Load a checkpoint -> ``(tree, extra)``: a nested dict of CPU
    tensors, or with ``like`` (a template tree) the template's structure,
    leaf dtypes and devices."""
    data = np.load(path, allow_pickle=False)
    manifest = json.loads(str(data["__manifest__"]))
    flat = {k: _from_native(data[k.replace("/", "§")],
                            manifest["dtypes"][k])
            for k in manifest["keys"]}
    if like is None:
        return (tu.unflatten([tuple(k.split("/")) for k in flat],
                             list(flat.values())), manifest["extra"])

    def place(p, leaf):
        key = "/".join(p)
        t = flat[key]
        assert tuple(t.shape) == tuple(leaf.shape), \
            (key, tuple(t.shape), tuple(leaf.shape))
        return t.to(device=leaf.device, dtype=leaf.dtype)

    return tu.map_with_path(place, like), manifest["extra"]


def save_plane(path: str, plane, spec, *,
               extra: Dict[str, Any] | None = None):
    """Persist a packed ``(P,)`` or ``(K, P)`` plane + its ``PlaneSpec``:
    one payload array, the layout in the JSON manifest. Round-trips bit
    for bit (``load_plane``)."""
    arr, dtype = _to_native(torch.as_tensor(plane))
    manifest = {
        "plane": {"dtype": dtype, "shape": list(arr.shape),
                  "spec": spec.to_manifest()},
        "extra": extra or {},
    }
    _atomic_savez(path, __manifest__=json.dumps(manifest), __plane__=arr)


def load_plane(path: str):
    """Load a plane checkpoint -> ``(plane, PlaneSpec, extra)``; the CPU
    tensor is bit-identical to what ``save_plane`` was given."""
    from repro_torch.core.plane import PlaneSpec
    data = np.load(path, allow_pickle=False)
    manifest = json.loads(str(data["__manifest__"]))
    meta = manifest["plane"]
    t = _from_native(data["__plane__"], meta["dtype"])
    assert list(t.shape) == meta["shape"], (tuple(t.shape), meta["shape"])
    return t, PlaneSpec.from_manifest(meta["spec"]), manifest["extra"]
