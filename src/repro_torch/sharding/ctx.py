"""Distribution contexts threaded through model and engine code — the JAX
package's ``ShardCtx`` and ``CohortCtx`` over ``torch.distributed``.

The design is SPMD: every rank runs the same program, and a mesh is a
``torch.distributed.device_mesh.DeviceMesh`` whose dimensions carry the
reference's axis names. Where the reference ``shard_map``s a body and
``psum``s its result, a rank computes its own part and the part is
``all_reduce``d over the mesh dimension's process group. Without a mesh
(one process) every path is the single-card one.

``ShardCtx`` drives the model. Over ``model_axis`` it runs tensor
parallelism, Megatron-style, on the rank's part of the parameter tree
(``sharding.rules.tp_slice``): attention, MLA and cross-attention heads
(the head layouts of ``sharding.rules.head_layout``), d_ff, the
recurrent blocks' channels or heads and the vocabulary are split,
column-parallel input projections take no forward collective and
row-parallel output projections are summed by one ``all_reduce`` over
``model_group()`` (``sharding/collectives.py``); the MoE block's experts
are split over the ranks (expert parallelism) or, when E does not divide
the axis, each expert's F axis. A leaf held whole is computed whole on
every rank. ``embed_tp``, ``tp_bf16_reduce`` and ``seq_parallel`` are the
reference's knobs. It also drives layer rematerialisation
(``models/transformer.py``). Over the data axes it runs FSDP: the batch
is split into ``data_size`` contiguous row blocks (``data_rank``'s is
this rank's), every parameter leaf is cut on the plan's data dimension
on top of its ``model`` cut (``sharding.rules.tp_slice``), a unit's
leaves are gathered whole just before it runs and their gradients summed
over the data ranks and cut back to the rank's part
(``sharding.collectives.dp_enter``). A sum over a product of data
axes (``("pod", "data")``) is one ``all_reduce`` a group in turn
(``data_sum``). A decode batch the data axes do not split
(``batch_whole``, by the reference's rule: ``sharding.rules.batch_ctx``)
is served whole on every data rank, each attention cache holding the
rank's block of slots, and every decode step's attention combined over
the data axes (``sharding.collectives.combine_seq``). The same code runs
on gloo ranks of the CPU and on the card.

``CohortCtx`` drives the unified FL engine's client axis: rank r of the
client axes holds the contiguous plane rows ``edge_groups(ks)[r]``,
trains them, and pre-reduces them into one "edge" partial (fedadp's
triple, the per-client methods' cluster and prefix sums) before the one
global reduce; ``gather_rows`` brings every rank's rows to every rank,
and ``writer`` / ``barrier`` let one rank write a checkpoint.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional, Tuple

import torch
import torch.distributed as dist

REMAT_POLICIES = ("full", "dots")


def check_mesh(mesh, axes: Tuple[str, ...], what: str):
    """``mesh`` must be ``None`` or a ``DeviceMesh`` naming ``axes``, with
    this rank in it. Returns it."""
    if mesh is None:
        return None
    from torch.distributed.device_mesh import DeviceMesh
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"{what}: mesh must be a torch.distributed."
                        f"device_mesh.DeviceMesh (or None), got "
                        f"{type(mesh).__name__}")
    names = tuple(mesh.mesh_dim_names or ())
    missing = [a for a in axes if a not in names]
    if missing:
        raise ValueError(f"{what}: the DeviceMesh has dimensions {names}, "
                         f"not {missing}")
    if mesh.get_coordinate() is None:
        raise ValueError(f"{what}: rank {dist.get_rank()} is not in the "
                         f"DeviceMesh {mesh.mesh.tolist()} (ranks outside a "
                         f"cohort mesh run without one: "
                         f"sharding.rules.cohort_mesh returns None there)")
    return mesh


def axis_size(mesh, axis: str) -> int:
    return int(mesh.size(list(mesh.mesh_dim_names).index(axis)))


def axes_size(mesh, axes: Tuple[str, ...]) -> int:
    """The product of the mesh dimensions ``axes``' extents (1 without a
    mesh)."""
    n = 1
    for a in (axes if mesh is not None else ()):
        n *= axis_size(mesh, a)
    return n


def axes_rank(mesh, axes: Tuple[str, ...]) -> int:
    """This rank's flat coordinate over the mesh dimensions ``axes``,
    row-major (0 without a mesh)."""
    r = 0
    for a in (axes if mesh is not None else ()):
        r = r * axis_size(mesh, a) + int(mesh.get_local_rank(a))
    return r


def all_reduce_sum(t: torch.Tensor, mesh, axes: Tuple[str, ...]):
    """Sum ``t`` in place over the product of the mesh dimensions
    ``axes``: one ``all_reduce`` per dimension (a sum over a product of
    groups is the sum over each in turn)."""
    for a in axes:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.get_group(a))
    return t


@dataclass(frozen=True)
class ShardCtx:
    mesh: Any = None                    # DeviceMesh or None
    data_axes: Tuple[str, ...] = ()     # batch axes, e.g. ("data",)
    model_axis: Optional[str] = None    # tensor/expert-parallel axis
    attn_backend: str = "auto"          # "auto" | "flash" | "blockwise":
                                        # auto = the CUDA kernels on CUDA
                                        # tensors (flash, swa_prefill,
                                        # swa_decode: models/attention.py),
                                        # the plain versions elsewhere
    banded_local: bool = True           # banded blockwise attn, local layers
    causal_skip: bool = False           # skip fully-masked kv blocks (causal)
    mla_absorb: bool = False            # absorbed MLA decode (w_kv_b folded)
    moe_all_to_all: bool = False        # the reference's a2a-dispatch knob:
                                        # it changes no computation there,
                                        # and here neither
    block_q: int = 512
    block_kv: int = 512
    remat: bool = False                 # checkpoint each layer unit
    remat_policy: str = "full"          # "full" | "dots" (keep the
                                        # batch-free products' outputs)
    embed_tp: bool = False              # embed: (model, None) instead of
                                        # (model, data) in the plan (and
                                        # lm_head likewise): held whole
                                        # over the data axes
    tp_bf16_reduce: bool = False        # row-parallel partials cast to the
                                        # activation dtype before the
                                        # reduce (else reduced in f32)
    seq_parallel: bool = False          # the residual stream's rows split
                                        # over model between blocks
    batch_whole: bool = False           # every data rank holds the whole
                                        # batch and the decode caches'
                                        # slots are cut over the data axes
                                        # (the plan's ``__seq__``): not a
                                        # knob, ``sharding.rules.batch_ctx``
                                        # sets it by the reference's rule

    def __post_init__(self):
        axes = tuple(self.data_axes) + (
            (self.model_axis,) if self.model_axis is not None else ())
        check_mesh(self.mesh, axes, "ShardCtx")
        if self.remat_policy not in REMAT_POLICIES:
            raise ValueError(f"remat_policy={self.remat_policy!r}, expected "
                             f"one of {REMAT_POLICIES}")
        if self.batch_whole and self.data_size <= 1:
            raise ValueError("batch_whole needs data axes of more than one "
                             "rank")

    @property
    def distributed(self) -> bool:
        return self.mesh is not None and self.model_axis is not None

    @property
    def model_size(self) -> int:
        if not self.distributed:
            return 1
        return axis_size(self.mesh, self.model_axis)

    @property
    def model_rank(self) -> int:
        """This rank's coordinate on ``model_axis`` (0 without one)."""
        if not self.distributed:
            return 0
        return int(self.mesh.get_local_rank(self.model_axis))

    def model_group(self):
        return self.mesh.get_group(self.model_axis)

    @property
    def data_size(self) -> int:
        return axes_size(self.mesh, tuple(self.data_axes))

    @property
    def data_rank(self) -> int:
        """This rank's block of the batch's rows (``axes_rank``)."""
        return axes_rank(self.mesh, tuple(self.data_axes))

    def data_groups(self) -> list:
        return [self.mesh.get_group(a) for a in self.data_axes]

    def data_sum(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` in place over the data axes."""
        return all_reduce_sum(t, self.mesh, tuple(self.data_axes))


CPU_CTX = ShardCtx()


@dataclass(frozen=True)
class CohortCtx:
    """Client-axis distribution context of the unified FL engine: which
    mesh dimensions the cohort's K (plane-row) axis is split over. Each
    rank of the client axes is one "edge" sub-cohort: it trains its
    rows and reduces them to one partial triple; an ``all_reduce`` of the
    triples is the global reduce."""
    mesh: Any = None
    client_axes: Tuple[str, ...] = ("clients",)

    def __post_init__(self):
        check_mesh(self.mesh, tuple(self.client_axes), "CohortCtx")

    @property
    def edge_extent(self) -> int:
        """How many edge reducers the client axes hold (1 = no mesh)."""
        return axes_size(self.mesh, tuple(self.client_axes))

    @property
    def edge_rank(self) -> int:
        """This rank's slot on the client axes, row-major over them."""
        return axes_rank(self.mesh, tuple(self.client_axes))

    def edge_groups(self, ks) -> List[list]:
        """The two-level reduce's sub-cohorts: the participating client
        ids split contiguously, one group per slot of the client axes —
        exactly the rows each rank holds. With no (usable) mesh the whole
        cohort is one group."""
        ks = list(ks)
        e = self.edge_extent
        if e <= 1 or len(ks) % e != 0:
            return [ks]
        step = len(ks) // e
        return [ks[i * step:(i + 1) * step] for i in range(e)]

    def local_rows(self, n_rows: int) -> Optional[slice]:
        """This rank's rows of an ``(n_rows, ...)`` cohort array: the
        replacement of the reference's ``row_spec``. None when the rows
        do not split over the client axes (the rules.py divisibility
        rule: every rank then holds them all)."""
        from repro_torch.sharding.rules import stacked_client_spec
        if not stacked_client_spec(self.mesh, self.client_axes, n_rows):
            return None
        step = n_rows // self.edge_extent
        lo = self.edge_rank * step
        return slice(lo, lo + step)

    def all_reduce(self, *tensors: torch.Tensor) -> None:
        """Sum each tensor in place over the client axes."""
        for t in tensors:
            all_reduce_sum(t, self.mesh, tuple(self.client_axes))

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``local_rows`` of a cohort array -> the whole
        array, in row order, on every rank: ``x`` is this rank's rows
        (one zero-padded sum ``all_reduce``, ``collectives.
        gather_padded``)."""
        from repro_torch.sharding.collectives import gather_padded
        return gather_padded(x, 0, self.edge_rank, self.edge_extent,
                             self.all_reduce)

    @property
    def writer(self) -> bool:
        """Whether this rank writes what every rank holds alike (a
        checkpoint): the mesh's first rank, or the one process."""
        if self.mesh is None:
            return True
        return dist.get_rank() == int(self.mesh.mesh.flatten()[0])

    def barrier(self) -> None:
        """Wait for every rank of the mesh: a barrier over each of its
        dimensions in turn (a rank passes the last only after every rank
        has entered the first)."""
        if self.mesh is None:
            return
        for a in self.mesh.mesh_dim_names:
            dist.barrier(group=self.mesh.get_group(a))
