"""Shard groups of the sharded pipelines: the port's counterpart of
``tpualign/parallel/mesh.py:make_mesh``.

A group is a 1-D line of P shards with three operations, the three that
``tpualign``'s pipelines use under ``shard_map``:

- :meth:`Group.shift`, ``lax.ppermute`` with ``[(i, i + 1)]``: each shard's
  tensor moves to the next shard; shard 0 gets nothing and the last
  shard's tensor goes nowhere;
- :meth:`Group.max` and :meth:`Group.sum`, ``pmax`` and ``psum``; and
  :meth:`Group.gather`, the shards' tensors in shard order on every shard.

Two transports carry them:

- :class:`Group` runs every shard in this process, on a list of devices
  (``cuda:0`` repeated on a card, ``cpu`` in the tests, or several cards):
  a superstep runs the shards in turn, and the hand-off passes the tensor
  on, copied where the next shard's device differs;
- :class:`DistGroup` runs one shard a rank of the default
  ``torch.distributed`` group, on that rank's device: the shift is a
  ``batch_isend_irecv`` to the neighbours, the reductions ``all_reduce``
  and the gather ``all_gather``, so every rank returns the same result.

A pipeline is written once, as the superstep of one shard, and
:func:`run` drives it over the shards this process holds.  Over
``torch.distributed`` every shard's tensor in a shift has one shape and
dtype (the receiver allocates it before the sender's arrives).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch

__all__ = ["DistGroup", "Group", "default_group", "make_group", "run"]


class Group:
    """P shards in this process, shard ``c`` on ``devices[c]``.

    ``stats`` counts the supersteps that :func:`run` drove.  In one process
    on one device a hand-off is the tensor itself, passed on with no copy
    and no device work."""

    def __init__(self, devices: Sequence):
        if not devices:
            raise ValueError("a group needs at least one shard")
        self.devices = [torch.device(d) for d in devices]
        self.size = len(self.devices)
        self.shards = list(range(self.size))
        self.stats = dict(supersteps=0)

    def device(self, c: int) -> torch.device:
        return self.devices[c]

    def shift(self, outs: List[torch.Tensor]) -> List[Optional[torch.Tensor]]:
        """Each shard's tensor to the next shard (``outs[c]`` is shard c's):
        the tensors each shard receives, None for shard 0."""
        return [None] + [x.to(self.devices[c + 1]) for c, x in enumerate(outs[:-1])]

    def _here(self, vals: List[torch.Tensor]) -> torch.Tensor:
        return torch.stack([v.reshape(()).to(self.devices[0]) for v in vals])

    def max(self, vals: List[torch.Tensor]) -> torch.Tensor:
        """The max over the shards of each shard's 0-d tensor."""
        return self._here(vals).max()

    def sum(self, vals: List[torch.Tensor]) -> torch.Tensor:
        """The sum over the shards of each shard's 0-d tensor."""
        return self._here(vals).sum()

    def gather(self, vals: List[torch.Tensor]) -> torch.Tensor:
        """The shards' 1-D tensors concatenated in shard order."""
        return torch.cat([v.to(self.devices[0]) for v in vals])


class DistGroup(Group):
    """One shard a rank of the default ``torch.distributed`` group: shard
    ``rank`` of ``world_size``, on ``device``."""

    def __init__(self, device):
        import torch.distributed as dist

        self._dist = dist
        self.rank = dist.get_rank()
        self.size = dist.get_world_size()
        self.devices = [torch.device(device)]
        self.shards = [self.rank]
        self.stats = dict(supersteps=0)

    def device(self, c: int) -> torch.device:
        return self.devices[0]

    def shift(self, outs: List[torch.Tensor]) -> List[Optional[torch.Tensor]]:
        dist = self._dist
        out = outs[0].contiguous()
        ops, got = [], None
        if self.rank + 1 < self.size:
            ops.append(dist.P2POp(dist.isend, out, self.rank + 1))
        if self.rank > 0:
            got = torch.empty_like(out)
            ops.append(dist.P2POp(dist.irecv, got, self.rank - 1))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return [got]

    def _reduce(self, vals, op) -> torch.Tensor:
        x = vals[0].reshape(1).to(self.devices[0], copy=True)
        self._dist.all_reduce(x, op=op)
        return x[0]

    def max(self, vals: List[torch.Tensor]) -> torch.Tensor:
        return self._reduce(vals, self._dist.ReduceOp.MAX)

    def sum(self, vals: List[torch.Tensor]) -> torch.Tensor:
        return self._reduce(vals, self._dist.ReduceOp.SUM)

    def gather(self, vals: List[torch.Tensor]) -> torch.Tensor:
        x = vals[0].contiguous()
        parts = [torch.empty_like(x) for _ in range(self.size)]
        self._dist.all_gather(parts, x)
        return torch.cat(parts)


def _dist_ready() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def default_group(device="cuda") -> Group:
    """The group of ``jax.devices()``'s place: the ``torch.distributed``
    world when it is initialized (a shard a rank, on ``cuda``'s current
    device for a CUDA ``device``), else every visible CUDA device for a
    CUDA ``device`` and one shard for the CPU."""
    dev = torch.device(device)
    if _dist_ready():
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return DistGroup(dev)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' for the plain "
                               "PyTorch path")
        return Group([torch.device("cuda", i) for i in range(torch.cuda.device_count())])
    return Group([dev])


def make_group(n_shards: Optional[int] = None, device="cuda") -> Group:
    """A group of ``n_shards`` shards in this process, all on ``device``
    (``make_group(4, device="cuda")``: four shards on one card; a shard a
    device of a list is ``Group(devices)``); without ``n_shards``,
    :func:`default_group`."""
    if n_shards is None:
        return default_group(device)
    if n_shards < 1:
        raise ValueError(f"a group needs at least one shard, got {n_shards}")
    return Group([device] * n_shards)


def run(group: Group, step: Callable, supersteps: int) -> None:
    """Drive a pipeline: at superstep ``t`` each shard ``c`` this process
    holds runs ``step(c, t, got)``, ``got`` the tensor the previous
    superstep's shift brought it (None at ``t = 0`` and on shard 0), and
    returns the tensor to shift to shard ``c + 1``."""
    got = [None] * len(group.shards)
    for t in range(supersteps):
        outs = [step(c, t, x) for c, x in zip(group.shards, got)]
        got = group.shift(outs)
        group.stats["supersteps"] += 1
