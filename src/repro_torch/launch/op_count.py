"""Per-rank counts of one step of the port, taken on ``meta`` tensors
(the counterpart of the JAX package's ``launch/hlo_analysis.py``, which
reads them from XLA's compiled HLO text).

The HLO text and XLA's fusion have no counterpart here: the port runs
eager ops, so the counts are those ops'. Inside ``count()``:

  * dot and convolution FLOPs — the formulas of ``torch.utils.
    flop_counter``'s registry (``FlopCounterMode``'s) on every op the
    step dispatches (``mm``, ``bmm``, ``addmm``, ``baddbmm``,
    ``convolution`` and their backward; the forward again where remat
    recomputes it). Per rank: the shapes are the rank's.
  * collectives — every ``torch.distributed.all_reduce`` (the only
    collective the port's model code calls: gloo has no reduce-scatter
    and no all-gather of CUDA tensors), tallied by the mesh axis of its
    group and by what issued it: the ``sharding/collectives.py``
    Function (``_GatherUnit.forward``, ``_ReduceFromModel.forward``,
    ...) or function (``combine_seq``) on the call stack, else
    ``sharding/ctx.py``'s ``all_reduce_sum``. The data axis's
    Functions carry the labels the card runs give them (``LABELS``:
    "gather", "reduce_scatter", "loss_sum", "combine"). Bytes are the
    buffer's; ``coll_total`` counts an all_reduce twice (a
    reduce-scatter then an all-gather of the buffer: ``COLL_FACTOR``,
    the reference's).
  * live bytes — the largest sum of the bytes of the live storages the
    step made (its activations, gradients, caches and optimizer
    temporaries; the inputs made before ``count()`` are not counted),
    read from weak references to the storages, so a tensor autograd
    saves for the backward counts until it is freed. A reading sweeps
    every live storage, so it is taken when the running sum passes the
    peak, at most once per 1/16 of the live storages in ops: the peak
    is the largest reading, within the bytes a few ops make of the
    exact one.

On ``meta`` tensors nothing is computed and no memory is taken, so a
full-width step of any registry architecture counts on the CPU in
seconds. Under a fake process group (``launch.dryrun``) the collectives
return at once.
"""
from __future__ import annotations

import contextlib
import sys
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import torch
import torch.distributed as dist
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

COLL_FACTOR = {"all_reduce": 2.0}
# the labels of chip_smoke.py's data-axis tally
LABELS = {"_GatherUnit.forward": "gather",
          "_GatherUnit.backward": "reduce_scatter",
          "_ReduceFromData.forward": "loss_sum",
          "combine_seq": "combine"}
_SHARDING = ("sharding/collectives.py", "sharding/ctx.py",
             "sharding/rules.py")


@dataclass
class Counts:
    """What ``count()`` saw: ``dot_flops``; ``collectives[axis][label] =
    [calls, bytes]``; ``peak_bytes`` (live bytes at their largest);
    ``ops`` dispatched."""
    dot_flops: int = 0
    collectives: Dict[str, Dict[str, List[int]]] = field(default_factory=dict)
    peak_bytes: int = 0
    ops: int = 0

    @property
    def coll_bytes(self) -> int:
        return sum(b for axis in self.collectives.values()
                   for _, b in axis.values())

    @property
    def coll_calls(self) -> int:
        return sum(n for axis in self.collectives.values()
                   for n, _ in axis.values())

    def to_dict(self) -> Dict[str, Any]:
        """The reference's keys (``dot_flops``, ``coll_total``) and the
        tallies."""
        return {"dot_flops": float(self.dot_flops),
                "coll_total": COLL_FACTOR["all_reduce"] * self.coll_bytes,
                "coll_calls": self.coll_calls,
                "collectives": {a: {k: list(v) for k, v in t.items()}
                                for a, t in self.collectives.items()},
                "peak_bytes": self.peak_bytes, "ops": self.ops}


def issuer() -> str:
    """What issued the collective being called: walking out from the
    caller, the first ``sharding/collectives.py`` autograd Function's
    ``forward`` / ``backward``, else the outermost frame of the
    contiguous run of ``sharding/`` frames (a function such as
    ``combine_seq`` or ``all_reduce_sum``); "other" outside them."""
    f = sys._getframe(2)
    last = None
    while f is not None:
        path = f.f_code.co_filename.replace("\\", "/")
        inside = path.endswith(_SHARDING)
        if not inside and last is not None and "/torch/" in path \
                and "repro_torch" not in path:
            f = f.f_back            # torch's Function.apply between frames
            continue
        if not inside:
            break
        q = f.f_code.co_qualname
        if path.endswith("sharding/collectives.py") and \
                q.endswith((".forward", ".backward")):
            return q
        last = q
        f = f.f_back
    return (last or "other").split(".<locals>")[0]


class _Counter(TorchDispatchMode):
    """Counts the dot and convolution FLOPs of the dispatched ops (the
    formulas of ``torch.utils.flop_counter``'s registry) and tracks the
    bytes of the storages they make and the largest sum alive at once."""

    def __init__(self, counts: Counts):
        super().__init__()
        self.counts = counts
        self.live: Dict[int, tuple] = {}      # storage key -> (ref, bytes)
        self.total = 0
        self.next_sweep = 0
        self.composite: Dict[Any, bool] = {}

    def _sweep(self) -> None:
        dead = [k for k, (ref, _) in self.live.items() if ref.expired()]
        for k in dead:
            self.total -= self.live.pop(k)[1]
        # a sweep reads every live storage: at most one per 1/16 of them
        # in ops, so a long step (the xLSTM's loop over time) stays linear
        self.next_sweep = self.counts.ops + len(self.live) // 16

    def _is_composite(self, func) -> bool:
        c = self.composite.get(func)
        if c is None:
            c = self.composite[func] = \
                torch._C._dispatch_has_kernel_for_dispatch_key(
                    func.name(), "CompositeImplicitAutograd")
        return c

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        formula = flop_registry.get(func.overloadpacket)
        if formula is None and self._is_composite(func):
            # a composite op (``matmul`` reaches the mode whole under
            # inference_mode): count the ops it decomposes into
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        self.counts.ops += 1
        if formula is not None:
            self.counts.dot_flops += int(formula(*args, **kwargs,
                                                 out_val=out))
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor) and not t.is_sparse:
                st = t.untyped_storage()
                key = st._cdata
                if key not in self.live:
                    n = st.nbytes()
                    self.live[key] = (StorageWeakRef(st), n)
                    self.total += n
        if self.total > self.counts.peak_bytes and \
                self.counts.ops >= self.next_sweep:
            self._sweep()               # only an upper bound until swept
            self.counts.peak_bytes = max(self.counts.peak_bytes, self.total)
        return out

    def finish(self) -> None:
        """The last reading: the live bytes at the block's end."""
        self._sweep()
        self.counts.peak_bytes = max(self.counts.peak_bytes, self.total)


@contextlib.contextmanager
def count(groups: Optional[Dict[int, str]] = None):
    """Count the ops run inside the block into the yielded ``Counts``.
    ``groups`` maps ``id(process group)`` to its mesh axis name (a
    collective on another group is tallied under "other")."""
    counts = Counts()
    groups = groups or {}
    inner = dist.all_reduce

    def counted(t, *args, **kw):
        group = kw.get("group", args[1] if len(args) > 1 else None)
        axis = groups.get(id(group), "other")
        label = issuer()
        label = LABELS.get(label, label)
        row = counts.collectives.setdefault(axis, {}).setdefault(
            label, [0, 0])
        row[0] += 1
        row[1] += t.numel() * t.element_size()
        return inner(t, *args, **kw)

    mode = _Counter(counts)
    dist.all_reduce = counted
    try:
        with mode:
            yield counts
    finally:
        dist.all_reduce = inner
        mode.finish()


def mesh_groups(mesh) -> Dict[int, str]:
    """``id(group) -> axis name`` of every dimension of a DeviceMesh."""
    if mesh is None:
        return {}
    return {id(mesh.get_group(a)): a for a in mesh.mesh_dim_names}
