"""Process groups and the ('chan', 'time') mesh: the port of
parallel/mesh.py on ``torch.distributed``.

Channels are data-parallel; long signals shard along time with their
carried state exchanged (halos for FIR/FFT, affine summaries for IIR:
:mod:`.halo`, :mod:`.time_iir`, :mod:`.fused_iir`).  A JAX
``Mesh`` becomes a ``DeviceMesh`` with ``mesh_dim_names=("chan",
"time")``; an ``axis_name`` becomes the mesh's process group for that
dimension (``mesh.get_group(TIME_AXIS)``).  Each rank holds plain local
tensors: the JAX package's ``NamedSharding`` helpers become functions that
cut a global tensor (or a state tree) into this rank's shard, beside the
gathers that rebuild the global tensor.

The collectives below stand in for the ``jax.lax`` ones the JAX package
calls inside ``shard_map``: ``axis_index``/``axis_size`` (the rank and size
of a group), ``all_gather``, ``psum``/``pmax`` (an all-reduce, over one
group or, for a tuple, over each in turn), ``ppermute_right`` (``perm=[(i,
i + 1)]``, zeros where no source exists) and ``replicate_last`` (the
masked ``psum`` that makes the last rank's value every rank's).

Under autograd (``ops._build.needs_grad``) ``all_gather``, ``psum`` and
``ppermute_right`` run as ``torch.autograd.Function``s whose backwards are
their transposes, as ``jax.grad`` takes them inside ``shard_map``: a
gather's cotangent summed over the group, this rank's part of it; a sum's
cotangent summed; a shift's cotangent shifted back.  Each rank's loss is
its own, and the gradient is that of their sum.  A backward is itself a
collective, so every rank of the group must reach it, in the same order:
the sharded layer keeps one graph shape on every rank (no rank cuts a
collective out of its graph by a branch on its index).  ``pmax`` has no
backward (nor has JAX's) and raises under grad.  Without grad every
collective runs as before.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Sequence, Union

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from lsp_dsp_units_tpu_torch.ops import _build
from lsp_dsp_units_tpu_torch.utils.tree import tree_map

CHAN_AXIS = "chan"
TIME_AXIS = "time"
# a rank that never arrives (or a peer that died) fails the run after this
# long instead of hanging it
DEFAULT_TIMEOUT_S = 120.0

Group = dist.ProcessGroup
Groups = Union[Group, Sequence[Group]]


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     platform: Optional[str] = None,
                     timeout: float = DEFAULT_TIMEOUT_S) -> None:
    """Start the default process group.

    The arguments fall back to ``LSP_COORDINATOR``, ``LSP_NUM_PROCESSES``
    and ``LSP_PROCESS_ID``, as in the JAX package.  ``coordinator`` is
    ``host:port`` (a TCP rendezvous, rank 0 listens) or an init-method URL
    (``tcp://...``, ``file://...``); a world of one process needs none
    (an in-process store).  The backend is gloo for ``platform="cpu"``
    and NCCL otherwise: the card unless the caller asks for the CPU.  On
    the card each rank takes card ``process_id % device_count``.
    """
    coordinator = coordinator or os.environ.get("LSP_COORDINATOR")
    if num_processes is None:
        num_processes = int(os.environ.get("LSP_NUM_PROCESSES", "1"))
    if process_id is None:
        process_id = int(os.environ.get("LSP_PROCESS_ID", "0"))
    kw = dict(rank=process_id, world_size=num_processes,
              timeout=datetime.timedelta(seconds=timeout))
    if platform == "cpu":
        kw["backend"] = "gloo"
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed: no CUDA device for NCCL "
                               "(pass platform='cpu' for gloo)")
        card = process_id % torch.cuda.device_count()
        torch.cuda.set_device(card)
        kw.update(backend="nccl", device_id=torch.device("cuda", card))
    if coordinator is None:
        if num_processes != 1:
            raise ValueError("init_distributed: a coordinator is needed for "
                             f"{num_processes} processes")
        kw["store"] = dist.HashStore()
    else:
        kw["init_method"] = (coordinator if "://" in coordinator
                             else f"tcp://{coordinator}")
    dist.init_process_group(**kw)


def make_mesh(chan: Optional[int] = None, time: int = 1,
              device_type: str = "cuda") -> DeviceMesh:
    """The ('chan', 'time') mesh over every rank of the default group.
    With ``chan`` None, the ranks not used by ``time`` go to channels."""
    n = dist.get_world_size()
    if chan is None:
        if n % time:
            raise ValueError(f"{n} ranks do not split into time = {time}")
        chan = n // time
    if chan * time != n:
        raise ValueError(f"a ({chan}, {time}) mesh needs {chan * time} "
                         f"ranks, the world has {n}")
    return init_device_mesh(device_type, (chan, time),
                            mesh_dim_names=(CHAN_AXIS, TIME_AXIS))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device: its card, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


# -- cutting and gathering global tensors ----------------------------------

def _as_tensor(leaf, device):
    if torch.is_tensor(leaf):
        return leaf.to(device)
    if hasattr(leaf, "dtype") and hasattr(leaf, "shape"):    # numpy
        return torch.as_tensor(leaf).to(device)
    return leaf


def _cut(t: torch.Tensor, n: int, i: int, dim: int) -> torch.Tensor:
    size = t.shape[dim]
    if size % n:
        raise ValueError(f"axis of {size} does not split into {n} shards")
    return t.narrow(dim, i * (size // n), size // n).contiguous()


def chan_sharding(mesh: DeviceMesh, tree):
    """This rank's channel shard of every tensor leaf of ``tree`` (axis 0),
    on this rank's device: [C, ...] -> [C / chan, ...]."""
    n, i = mesh.size(0), mesh.get_coordinate()[0]
    dev = mesh_device(mesh)

    def shard(v):
        v = _as_tensor(v, dev)
        return _cut(v, n, i, 0) if torch.is_tensor(v) else v

    return tree_map(shard, tree)


def time_sharding(mesh: DeviceMesh, x) -> torch.Tensor:
    """This rank's time shard of [..., T], every channel."""
    return _cut(_as_tensor(x, mesh_device(mesh)), mesh.size(1),
                mesh.get_coordinate()[1], -1)


def chan_time_sharding(mesh: DeviceMesh, x) -> torch.Tensor:
    """This rank's shard of [C, T]: [C / chan, T / time]."""
    return time_sharding(mesh, chan_sharding(mesh, x))


def replicated(mesh: DeviceMesh, tree):
    """``tree`` as every rank holds it, on this rank's device."""
    dev = mesh_device(mesh)
    return tree_map(lambda v: _as_tensor(v, dev), tree)


def gather_chan(mesh: DeviceMesh, tree):
    """Inverse of :func:`chan_sharding`: every tensor leaf's channel shards
    concatenated on axis 0, on every rank."""
    g = mesh.get_group(CHAN_AXIS)
    return tree_map(lambda v: all_gather(v, g, dim=0, tiled=True)
                    if torch.is_tensor(v) else v, tree)


def gather_time(mesh: DeviceMesh, x: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`time_sharding`, on every rank."""
    return all_gather(x, mesh.get_group(TIME_AXIS), dim=-1, tiled=True)


def gather_chan_time(mesh: DeviceMesh, x: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`chan_time_sharding`, on every rank."""
    return gather_chan(mesh, gather_time(mesh, x))


# -- the collectives -------------------------------------------------------

def axis_index(group: Group) -> int:
    return dist.get_rank(group)


def axis_size(group: Group) -> int:
    return dist.get_world_size(group)


def _gather(x: torch.Tensor, group: Group, dim: int,
            tiled: bool) -> torch.Tensor:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(axis_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim) if tiled else torch.stack(parts, dim)


def _groups(groups: Groups) -> Sequence[Group]:
    return groups if isinstance(groups, (tuple, list)) else (groups,)


def _reduce(x: torch.Tensor, groups: Groups, op) -> torch.Tensor:
    x = x.clone(memory_format=torch.contiguous_format)
    for g in _groups(groups):
        dist.all_reduce(x, op=op, group=g)
    return x


def _shift(x: torch.Tensor, group: Group, step: int,
           cyclic: bool) -> torch.Tensor:
    """Rank i's ``x`` arrives at rank i + step (step = +-1); a rank with no
    source receives zeros, unless ``cyclic``."""
    n, i = axis_size(group), axis_index(group)
    if cyclic and n == 1:
        return x.clone()
    out = torch.zeros_like(x)
    ops = []
    if cyclic or 0 <= i + step < n:
        ops.append(dist.P2POp(dist.isend, x.contiguous(),
                              dist.get_global_rank(group, (i + step) % n),
                              group))
    if cyclic or 0 <= i - step < n:
        ops.append(dist.P2POp(dist.irecv, out,
                              dist.get_global_rank(group, (i - step) % n),
                              group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, tiled):
        ctx.group, ctx.dim, ctx.tiled = group, dim, tiled
        ctx.size = x.shape[dim] if tiled else None
        return _gather(x, group, dim, tiled)

    @staticmethod
    def backward(ctx, g):
        # the transpose of a gather is a reduce-scatter: every rank's
        # cotangent of the gathered tensor summed, this rank's part of it
        g = _reduce(g, ctx.group, dist.ReduceOp.SUM)
        i = axis_index(ctx.group)
        part = (g.narrow(ctx.dim, i * ctx.size, ctx.size) if ctx.tiled
                else g.select(ctx.dim, i))
        return part, None, None, None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return _reduce(x, groups, dist.ReduceOp.SUM)

    @staticmethod
    def backward(ctx, g):
        return _reduce(g, ctx.groups, dist.ReduceOp.SUM), None


class _ShiftRight(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, cyclic):
        ctx.group, ctx.cyclic = group, cyclic
        return _shift(x, group, 1, cyclic)

    @staticmethod
    def backward(ctx, g):
        # the reverse permutation: rank i + 1's cotangent back to rank i
        return _shift(g, ctx.group, -1, ctx.cyclic), None, None


def all_gather(x: torch.Tensor, group: Group, dim: int = 0,
               tiled: bool = False) -> torch.Tensor:
    """Every rank's ``x`` in rank order: stacked on a new axis ``dim``, or
    (``tiled``) concatenated along ``dim``."""
    if _build.needs_grad(x):
        return _AllGather.apply(x, group, dim, tiled)
    return _gather(x, group, dim, tiled)


def psum(x: torch.Tensor, groups: Groups) -> torch.Tensor:
    """Sum over the ranks of ``groups`` (a group, or a tuple of groups:
    over both mesh dimensions).  Returns a new tensor."""
    if _build.needs_grad(x):
        return _Psum.apply(x, groups)
    return _reduce(x, groups, dist.ReduceOp.SUM)


def pmax(x: torch.Tensor, groups: Groups) -> torch.Tensor:
    """Maximum over the ranks of ``groups``.  Returns a new tensor."""
    _build.no_grad_route("pmax", x)
    return _reduce(x, groups, dist.ReduceOp.MAX)


def groups_size(groups: Groups) -> int:
    n = 1
    for g in _groups(groups):
        n *= axis_size(g)
    return n


def ppermute_right(x: torch.Tensor, group: Group,
                   cyclic: bool = False) -> torch.Tensor:
    """Rank i's ``x`` arrives at rank i + 1 (``jax.lax.ppermute`` with
    ``perm=[(i, i + 1)]``): rank 0 receives zeros, or (``cyclic``) the
    last rank's ``x``.  Peers are named by their global ranks."""
    if _build.needs_grad(x):
        return _ShiftRight.apply(x, group, cyclic)
    return _shift(x, group, 1, cyclic)


def replicate_last(x: torch.Tensor, group: Group) -> torch.Tensor:
    """The last rank's ``x`` on every rank, as the JAX package's masked
    ``psum`` makes it: a sum of the last rank's value and zeros, which is
    exact, so the result is bitwise the same everywhere."""
    last = axis_index(group) == axis_size(group) - 1
    return psum(x if last else zeros_in_graph(x), group)


def zeros_in_graph(x: torch.Tensor) -> torch.Tensor:
    """Zeros of ``x``'s shape; under grad they stay in ``x``'s graph (a
    select of nothing from ``x``), so that a rank which contributes zeros
    to a collective still reaches the collective's backward.  The mask is
    made on the device (no copy from the host, which would wait for the
    stream)."""
    if _build.needs_grad(x):
        return torch.where(torch.zeros((), dtype=torch.bool,
                                       device=x.device), x, 0.0)
    return torch.zeros_like(x)
