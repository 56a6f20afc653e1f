"""Halo exchange and reductions over a torch.distributed process group: the
counterparts of the JAX package's `lax.ppermute`, `all_gather`, `psum`
and `pmin` inside its shard_map programs (dist/shard.py), for one process
per part.

The backend is the caller's choice and is never switched here. Over NCCL
the buffers stay on the card. A gloo group takes CPU tensors only for its
point-to-point messages, so where the field lies on a CUDA card a gloo
group stages every send, receive and reduction through host memory, on
purpose and in the open: `Comm.route` names it ("gloo, host-staged").

The halo exchange is linear, and the exact-JVP matrix-free matvec
differentiates the residual through its gradient exchange, which
torch.func.jvp cannot see through `dist.isend`/`irecv`: HaloExchange is a
torch.autograd.Function whose forward-mode rule exchanges the tangent by
the same schedule.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from .partition import PartMaps


@dataclasses.dataclass(frozen=True)
class Comm:
    """A rank's view of the (default) process group: its rank, the
    group's size, the backend and the device its fields live on."""
    rank: int
    size: int
    backend: str
    device: torch.device

    @property
    def staged(self) -> bool:
        """Whether messages go through host memory (gloo over CUDA
        tensors)."""
        return self.backend == "gloo" and self.device.type == "cuda"

    @property
    def route(self) -> str:
        return f"{self.backend}{', host-staged' if self.staged else ''}"

    def _out(self, t):
        return t.cpu() if self.staged else t

    def _in(self, t):
        return t.to(self.device) if self.staged else t


@dataclasses.dataclass(frozen=True)
class Round:
    """One round of the schedule as this rank sees it: whom it sends to and
    which of its cells (exact length), whom it receives from and which of
    its slots the message fills. -1: no partner this round."""
    send_to: int
    send_idx: torch.Tensor
    recv_from: int
    recv_slots: torch.Tensor


@dataclasses.dataclass(frozen=True)
class Exchange:
    """One rank's halo exchange: its process group and its part's maps,
    with each round's index lists cut to their exact lengths. JAX's
    scatter with mode="drop" skips the NC_local padding entries of
    pp_recv; here they are filtered out once (index_copy_ would raise on
    them)."""
    comm: Comm
    maps: PartMaps
    rounds: tuple

    @classmethod
    def build(cls, comm: Comm, maps: PartMaps) -> "Exchange":
        if maps.rank != comm.rank or maps.n_parts != comm.size:
            raise ValueError(f"part {maps.rank} of {maps.n_parts} on rank "
                             f"{comm.rank} of {comm.size}")
        rounds = tuple(
            Round(maps.send_to[r], maps.pp_send[r, :maps.send_len[r]],
                  maps.recv_from[r], maps.pp_recv[r, :maps.recv_len[r]])
            for r in range(len(maps.pp_perms))
            if maps.send_to[r] >= 0 or maps.recv_from[r] >= 0)
        return cls(comm, maps, rounds)

    @property
    def halo_cells(self) -> int:
        """The cells this rank receives per exchange."""
        return sum(int(r.recv_slots.numel()) for r in self.rounds)


def _exchange(exch: Exchange, field: torch.Tensor) -> torch.Tensor:
    """`field` (NC_local, ...) with its halo slots filled from their owners,
    one batch_isend_irecv per round (one send, one receive at most)."""
    comm = exch.comm
    out = field.clone()
    for rnd in exch.rounds:
        ops, rbuf = [], None
        if rnd.send_to >= 0:
            buf = comm._out(field[rnd.send_idx].contiguous())
            ops.append(dist.P2POp(dist.isend, buf, rnd.send_to))
        if rnd.recv_from >= 0:
            rbuf = torch.empty((rnd.recv_slots.numel(),) + field.shape[1:],
                               dtype=field.dtype,
                               device="cpu" if comm.staged else field.device)
            ops.append(dist.P2POp(dist.irecv, rbuf, rnd.recv_from))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        if rbuf is not None:
            out.index_copy_(0, rnd.recv_slots, comm._in(rbuf))
    return out


class HaloExchange(torch.autograd.Function):
    """The halo exchange as a differentiable function of the field: the
    map is linear, so its forward-mode derivative exchanges the tangent by
    the same schedule."""

    @staticmethod
    def forward(field, exch):
        return _exchange(exch, field)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.exch = inputs[1]

    @staticmethod
    def jvp(ctx, field_t, _):
        return HaloExchange.apply(field_t, ctx.exch)


def halo_exchange(exch: Exchange, field: torch.Tensor) -> torch.Tensor:
    """Fill the halo cell slots of `field` (NC_local, ...) from their remote
    owners by the R rounds of the neighbour schedule (partition.
    _neighbor_schedule); per-rank traffic is its own partition boundary.
    Returns a new tensor; differentiable in forward mode."""
    if not exch.rounds:
        return field
    return HaloExchange.apply(field, exch)


def halo_exchange_allgather(exch: Exchange, field: torch.Tensor
                            ) -> torch.Tensor:
    """The all-gather variant (the A/B check of the schedule): every rank
    receives every other's packed send buffer and fills its halo slots
    from it."""
    comm, maps = exch.comm, exch.maps
    buf = comm._out(field[maps.send_idx].contiguous())   # (max_send, ...)
    parts = [torch.empty_like(buf) for _ in range(comm.size)]
    dist.all_gather(parts, buf)
    flat = comm._in(torch.cat(parts))                     # (D*max_send, ...)
    keep = maps.halo_slots < maps.NC
    out = field.clone()
    out.index_copy_(0, maps.halo_slots[keep], flat[maps.halo_src[keep]])
    return out


def _allreduce(comm: Comm, t: torch.Tensor, op) -> torch.Tensor:
    buf = comm._out(t.detach().clone())
    dist.all_reduce(buf, op=op)
    return comm._in(buf)


def allreduce_sum(comm: Comm, t: torch.Tensor) -> torch.Tensor:
    """The sum of `t` over the ranks (psum), as a new tensor on t's
    device."""
    return _allreduce(comm, t, dist.ReduceOp.SUM)


def allreduce_min(comm: Comm, t: torch.Tensor) -> torch.Tensor:
    """The elementwise minimum of `t` over the ranks (pmin)."""
    return _allreduce(comm, t, dist.ReduceOp.MIN)


def all_gather_rows(comm: Comm, t: torch.Tensor) -> torch.Tensor:
    """(size, *t.shape): every rank's `t`, stacked by rank, on t's
    device."""
    buf = comm._out(t.detach().contiguous())
    parts = [torch.empty_like(buf) for _ in range(comm.size)]
    dist.all_gather(parts, buf)
    return comm._in(torch.stack(parts))
