"""Model-parallel topology over ``torch.distributed`` process groups.

Port of ``apex_tpu/transformer/parallel_state.py``.  Where the JAX
package lays every device out in ONE ``jax.sharding.Mesh`` whose named
axes play the role of process groups, the port runs one process a rank
(the caller picks the backend: NCCL with one card a rank, gloo where
ranks share a card or run on the CPU) and :func:`initialize_model_parallel`
builds one ``torch.distributed`` process group per axis, in the JAX
rank order (Megatron's): global rank =
``pp_rank * (dp*ep*cp*tp) + dp_rank * (ep*cp*tp) + ep_rank * (cp*tp)
+ cp_rank * tp + tp_rank``.  The data size is inferred from the world
size.

=====================  ================================  ====================
JAX (a mesh)           here                              getter
=====================  ================================  ====================
mesh axis name         the axis's process group          ``get_*_group``
static axis size       the group's size                  ``get_*_world_size``
``lax.axis_index``     this process's rank in the group  ``get_*_rank``
axis-name tuple        a group over those axes           ``get_dense_param_grad_axes``
=====================  ================================  ====================

The context group (``"context"``, cp ranks a sequence's shards) carries
ring attention's K/V hops and Ulysses attention's all-to-alls
(``apex_tpu_torch.ops``) and the GPT's ``context_parallel``; a dense
grad is reduced over it with the data group's
(:func:`get_dense_param_grad_axes`).

The getters return process groups; :func:`get_dense_param_grad_axes`
and :func:`get_expert_param_grad_axes` return axis NAMES, as in JAX, and
:func:`resolve_group` turns a name (``"data"``), a tuple of names, or
``None`` (the dense data-parallel axes) into the group built for it.
Ranks are host integers: a process knows its own coordinates.

:func:`serving_group` (tensor-parallel serving) needs none of this
state.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch.distributed as dist

__all__ = [
    "initialize_model_parallel",
    "destroy_model_parallel",
    "model_parallel_is_initialized",
    "get_mesh",
    "serving_group",
    "resolve_group",
    "get_tensor_model_parallel_group",
    "get_pipeline_model_parallel_group",
    "get_data_parallel_group",
    "get_context_parallel_group",
    "get_expert_model_parallel_group",
    "get_data_modulo_expert_parallel_group",
    "get_dense_param_grad_axes",
    "get_expert_param_grad_axes",
    "get_embedding_group",
    "get_position_embedding_group",
    "get_amax_reduction_group",
    "get_tensor_model_parallel_world_size",
    "get_pipeline_model_parallel_world_size",
    "get_data_parallel_world_size",
    "get_context_parallel_world_size",
    "get_expert_model_parallel_world_size",
    "get_tensor_model_parallel_rank",
    "get_pipeline_model_parallel_rank",
    "get_data_parallel_rank",
    "get_context_parallel_rank",
    "get_expert_model_parallel_rank",
    "get_pipeline_model_parallel_prev_rank",
    "get_pipeline_model_parallel_next_rank",
    "is_pipeline_first_stage",
    "is_pipeline_last_stage",
    "get_virtual_pipeline_model_parallel_rank",
    "set_virtual_pipeline_model_parallel_rank",
    "get_virtual_pipeline_model_parallel_world_size",
    "get_tensor_model_parallel_src_rank",
]

TENSOR_AXIS = "tensor"
PIPE_AXIS = "pipe"
DATA_AXIS = "data"
CONTEXT_AXIS = "context"
EXPERT_AXIS = "expert"
#: the grid's axes, outermost first (the JAX mesh's axis order)
AXES = (PIPE_AXIS, DATA_AXIS, EXPERT_AXIS, CONTEXT_AXIS, TENSOR_AXIS)
#: the axis sets that get a group of their own besides the five axes: the
#: dense grads' (data with expert and/or context), the expert grads'
#: (data, context) and the FP8 amax reduction's
_COMPOSITES = ((DATA_AXIS, EXPERT_AXIS), (DATA_AXIS, CONTEXT_AXIS),
               (DATA_AXIS, EXPERT_AXIS, CONTEXT_AXIS),
               (DATA_AXIS, EXPERT_AXIS, CONTEXT_AXIS, TENSOR_AXIS))


class RankMesh(NamedTuple):
    """The topology as JAX's mesh shows it: ``grid[pp, dp, ep, cp, tp]``
    holds each global rank, ``axis_names`` its axes (:data:`AXES`)."""
    grid: np.ndarray
    axis_names: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.grid.shape))


class _Topology:
    def __init__(self, mesh: RankMesh, coords: dict, groups: dict):
        self.mesh = mesh
        self.coords = coords        # axis -> this process's coordinate
        self.groups = groups        # sorted axis tuple -> process group


_STATE: Optional[_Topology] = None
_VIRTUAL_PIPELINE_MODEL_PARALLEL_RANK: Optional[int] = None
_VIRTUAL_PIPELINE_MODEL_PARALLEL_WORLD_SIZE: Optional[int] = None


def _require_distributed(what: str) -> None:
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            f"{what} needs torch.distributed: every rank calls "
            f"torch.distributed.init_process_group (and, on CUDA, "
            f"torch.cuda.set_device) first")


def _key(axes) -> tuple:
    """An axis set in the grid's order (the order its ranks run in)."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    unknown = [a for a in axes if a not in AXES]
    if unknown:
        raise ValueError(f"unknown mesh axes {unknown}; the axes are {AXES}")
    return tuple(a for a in AXES if a in axes)


def _groups_along(grid: np.ndarray, axes: tuple) -> list:
    """Every group of ranks along ``axes``: the ranks that share all the
    other coordinates, in the grid's C order over ``axes``."""
    along = [AXES.index(a) for a in axes]
    other = [i for i in range(grid.ndim) if i not in along]
    moved = np.transpose(grid, other + along)
    return [list(map(int, row)) for row in
            moved.reshape(-1, int(np.prod([grid.shape[i] for i in along])))]


def initialize_model_parallel(
        tensor_model_parallel_size_: int = 1,
        pipeline_model_parallel_size_: int = 1,
        virtual_pipeline_model_parallel_size_: Optional[int] = None,
        pipeline_model_parallel_split_rank_: Optional[int] = None,
        context_parallel_size_: int = 1,
        expert_model_parallel_size_: int = 1,
        *,
        default_backend: Optional[str] = None,
        p2p_backend: Optional[str] = None,
) -> RankMesh:
    """Build the topology's process groups (reference: NCCL group
    construction) over the initialised ``torch.distributed`` world.

    Every rank must call this, with the same arguments: each
    ``new_group`` is collective.  The data-parallel size is
    ``world_size // (tp * pp * cp * ep)``.  ``default_backend`` is the
    groups' backend (``None``: the world's); ``p2p_backend`` is accepted
    for signature parity: the pipeline schedules' hops
    (``pipeline_parallel.p2p_communication``) ride the pipe group, in
    its backend.  ``virtual_pipeline_model_parallel_size_`` is the
    interleaved executor's default chunk count.  Returns the rank
    grid."""
    global _STATE, _VIRTUAL_PIPELINE_MODEL_PARALLEL_WORLD_SIZE
    _require_distributed("initialize_model_parallel")
    tp = tensor_model_parallel_size_
    pp = pipeline_model_parallel_size_
    cp = context_parallel_size_
    ep = expert_model_parallel_size_
    n = dist.get_world_size()
    denom = tp * pp * cp * ep
    if min(tp, pp, cp, ep) < 1 or n % denom != 0:
        raise RuntimeError(
            f"world size ({n}) is not divisible by tensor ({tp}) x "
            f"pipeline ({pp}) x context ({cp}) x expert ({ep}) "
            "parallel sizes")
    dp = n // denom
    grid = np.arange(n).reshape(pp, dp, ep, cp, tp)
    me = dist.get_rank()
    coords = dict(zip(AXES, (int(c) for c in np.unravel_index(me,
                                                               grid.shape))))
    groups = {}
    for axes in [(a,) for a in AXES] + list(_COMPOSITES):
        ranks = _groups_along(grid, axes)
        if len(ranks) == 1 and default_backend is None:
            groups[axes] = dist.group.WORLD
            continue
        mine = None
        for r in ranks:         # every rank asks for every group
            g = dist.new_group(r, backend=default_backend)
            if me in r:
                mine = g
        groups[axes] = mine
    _STATE = _Topology(RankMesh(grid, AXES), coords, groups)
    if virtual_pipeline_model_parallel_size_ is not None:
        _VIRTUAL_PIPELINE_MODEL_PARALLEL_WORLD_SIZE = (
            virtual_pipeline_model_parallel_size_)
    return _STATE.mesh


def model_parallel_is_initialized() -> bool:
    return _STATE is not None


def destroy_model_parallel() -> None:
    """Forget the topology (reference: destroy all process groups).  The
    groups themselves end with ``torch.distributed.destroy_process_group``."""
    global _STATE, _VIRTUAL_PIPELINE_MODEL_PARALLEL_RANK
    global _VIRTUAL_PIPELINE_MODEL_PARALLEL_WORLD_SIZE
    _STATE = None
    _VIRTUAL_PIPELINE_MODEL_PARALLEL_RANK = None
    _VIRTUAL_PIPELINE_MODEL_PARALLEL_WORLD_SIZE = None


def _state() -> _Topology:
    if _STATE is None:
        raise RuntimeError(
            "model parallel is not initialized; call "
            "initialize_model_parallel() first")
    return _STATE


def get_mesh() -> RankMesh:
    return _state().mesh


def resolve_group(axis_name=None):
    """The process group of ``axis_name``: a ``ProcessGroup`` is returned
    as it is; a mesh-axis name (``"data"``), a tuple of names, or
    ``None`` (the dense data-parallel axes, :func:`get_dense_param_grad_axes`)
    resolves to the group :func:`initialize_model_parallel` built.  A
    name without that state raises ``RuntimeError``: a collective never
    quietly runs as one rank."""
    if isinstance(axis_name, dist.ProcessGroup):
        return axis_name
    if _STATE is None:
        raise RuntimeError(
            f"the mesh axis {axis_name!r} has no process group: call "
            f"initialize_model_parallel() on every rank first, or pass a "
            f"torch.distributed ProcessGroup")
    if axis_name is None:
        axis_name = get_dense_param_grad_axes()
    key = _key(axis_name)
    if key not in _STATE.groups:
        raise ValueError(f"no process group spans the axes {key}; the "
                         f"groups are {sorted(_STATE.groups)}")
    return _STATE.groups[key]


# --- groups -------------------------------------------------------------------

def get_tensor_model_parallel_group():
    return resolve_group(TENSOR_AXIS)


def get_pipeline_model_parallel_group():
    return resolve_group(PIPE_AXIS)


def get_data_parallel_group(with_expert_parallel: bool = False,
                            with_context_parallel: bool = False):
    """The data-parallel group; with the flags, the group over ``data``
    and the ``expert`` and/or ``context`` axes (the axes a dense param's
    grads replicate over, see :func:`get_dense_param_grad_axes`)."""
    axes = [DATA_AXIS]
    if with_expert_parallel:
        axes.append(EXPERT_AXIS)
    if with_context_parallel:
        axes.append(CONTEXT_AXIS)
    return resolve_group(tuple(axes))


def get_dense_param_grad_axes():
    """The axes a DENSE param's grad reduction must span: ``data``, plus
    ``expert`` / ``context`` whenever those axes have size > 1.  A name or
    a tuple of names, as in JAX (:func:`resolve_group` gives the group)."""
    axes = [DATA_AXIS]
    if get_expert_model_parallel_world_size() > 1:
        axes.append(EXPERT_AXIS)
    if get_context_parallel_world_size() > 1:
        axes.append(CONTEXT_AXIS)
    return DATA_AXIS if len(axes) == 1 else tuple(axes)


def get_expert_param_grad_axes():
    """The axes an EXPERT param's grad reduction must span: ``data`` plus
    ``context`` when active."""
    if get_context_parallel_world_size() > 1:
        return (DATA_AXIS, CONTEXT_AXIS)
    return DATA_AXIS


def get_context_parallel_group():
    return resolve_group(CONTEXT_AXIS)


def get_expert_model_parallel_group():
    return resolve_group(EXPERT_AXIS)


def get_data_modulo_expert_parallel_group():
    """The replicas of one expert shard: the bare ``data`` axis."""
    return resolve_group(DATA_AXIS)


def get_embedding_group():
    """The pipe axis, whose first and last stages tie the word
    embedding (JAX: a masked psum over the pipe axis)."""
    return resolve_group(PIPE_AXIS)


def get_position_embedding_group():
    return resolve_group(PIPE_AXIS)


def get_amax_reduction_group():
    """The FP8 amax reduction's group: data, expert, context and tensor."""
    return resolve_group((DATA_AXIS, EXPERT_AXIS, CONTEXT_AXIS,
                          TENSOR_AXIS))


# --- world sizes and ranks (host integers) ------------------------------------

def _size(axis: str) -> int:
    return get_mesh().shape[axis]


def get_tensor_model_parallel_world_size() -> int:
    return _size(TENSOR_AXIS)


def get_pipeline_model_parallel_world_size() -> int:
    return _size(PIPE_AXIS)


def get_data_parallel_world_size() -> int:
    return _size(DATA_AXIS)


def get_context_parallel_world_size() -> int:
    return _size(CONTEXT_AXIS)


def get_expert_model_parallel_world_size() -> int:
    return _size(EXPERT_AXIS)


def _rank(axis: str) -> int:
    return _state().coords[axis]


def get_tensor_model_parallel_rank() -> int:
    return _rank(TENSOR_AXIS)


def get_pipeline_model_parallel_rank() -> int:
    return _rank(PIPE_AXIS)


def get_data_parallel_rank() -> int:
    return _rank(DATA_AXIS)


def get_context_parallel_rank() -> int:
    return _rank(CONTEXT_AXIS)


def get_expert_model_parallel_rank() -> int:
    return _rank(EXPERT_AXIS)


def get_pipeline_model_parallel_prev_rank() -> int:
    pp = get_pipeline_model_parallel_world_size()
    return (get_pipeline_model_parallel_rank() - 1) % pp


def get_pipeline_model_parallel_next_rank() -> int:
    pp = get_pipeline_model_parallel_world_size()
    return (get_pipeline_model_parallel_rank() + 1) % pp


def is_pipeline_first_stage(ignore_virtual: bool = False) -> bool:
    if not ignore_virtual:
        vr = _VIRTUAL_PIPELINE_MODEL_PARALLEL_RANK
        if vr is not None and vr != 0:
            return False
    return get_pipeline_model_parallel_rank() == 0


def is_pipeline_last_stage(ignore_virtual: bool = False) -> bool:
    if not ignore_virtual:
        vr = _VIRTUAL_PIPELINE_MODEL_PARALLEL_RANK
        vws = _VIRTUAL_PIPELINE_MODEL_PARALLEL_WORLD_SIZE
        if vr is not None and vws is not None and vr != vws - 1:
            return False
    return get_pipeline_model_parallel_rank() == \
        get_pipeline_model_parallel_world_size() - 1


def get_virtual_pipeline_model_parallel_rank() -> Optional[int]:
    return _VIRTUAL_PIPELINE_MODEL_PARALLEL_RANK


def set_virtual_pipeline_model_parallel_rank(rank: Optional[int]) -> None:
    global _VIRTUAL_PIPELINE_MODEL_PARALLEL_RANK
    _VIRTUAL_PIPELINE_MODEL_PARALLEL_RANK = rank


def get_virtual_pipeline_model_parallel_world_size() -> Optional[int]:
    return _VIRTUAL_PIPELINE_MODEL_PARALLEL_WORLD_SIZE


def get_tensor_model_parallel_src_rank() -> int:
    """The global rank of tensor rank 0 in my tensor group: my global rank
    with the tensor coordinate zeroed."""
    tp = get_tensor_model_parallel_world_size()
    _state()
    return (dist.get_rank() // tp) * tp


# --- tensor-parallel serving ----------------------------------------------------

def serving_group(tp: int, group=None):
    """The process group of a ``tp``-wide serving engine, validated.

    Port of ``serving_mesh``.  With ``group`` (the engine passes its
    ``group=`` argument, or the world group), that group is checked: it
    must have exactly ``tp`` ranks and hold this process.  Without it,
    ``tp`` is checked against the world size and the group of the first
    ``tp`` ranks is returned: the world group when they are all of them,
    else a new group, which every rank of the world must ask for
    (``new_group`` is collective).

    Raises ``ValueError`` for ``tp < 1`` and ``RuntimeError`` when
    ``torch.distributed`` is not initialised, the world is smaller than
    ``tp``, or the group's size is not ``tp``: tensor-parallel serving
    never falls back to one rank."""
    if tp < 1:
        raise ValueError(f"serving tp must be >= 1, got {tp}")
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            f"tensor-parallel serving (tp={tp}) needs torch.distributed: "
            f"every rank calls torch.distributed.init_process_group (and, on "
            f"CUDA, torch.cuda.set_device) before it builds the engine")
    if group is None:
        world = dist.get_world_size()
        if world < tp:
            raise RuntimeError(f"serving tp={tp} needs {tp} ranks, the world "
                               f"has {world}")
        group = dist.group.WORLD if world == tp \
            else dist.new_group(list(range(tp)))
        if world > tp and dist.get_rank() >= tp:
            raise RuntimeError(f"rank {dist.get_rank()} is not among the "
                               f"first {tp} ranks that serve")
    size = dist.get_world_size(group)
    if size != tp:
        raise RuntimeError(f"tp={tp} needs a process group of {tp} ranks, "
                           f"got one of {size}")
    if dist.get_rank(group) < 0:
        raise RuntimeError("this process is not a rank of the serving group")
    return group
