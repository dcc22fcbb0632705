"""Boundary tensors between pipeline stages — the port's counterpart of the
JAX engine's per-tick ``ppermute`` over ``pipe`` (reference:
deepspeed/runtime/pipe/p2p.py).

:class:`PipeChannel` sends and receives on the pipe axis's process group
(``parallel/mesh.py``): one ``dist.batch_isend_irecv`` per schedule step
posts that step's sends and receives together, and a receive is waited
on only where an instruction consumes its buffer.  No blocking send is
ever made before its receive is posted, so two neighbours never wait on
each other.

Transport follows the group's backend.  On NCCL (a card per rank) the
device tensors themselves are sent.  Gloo's point-to-point calls read
and write the bytes at a tensor's pointer as host memory, so on a gloo
group a CUDA tensor is staged explicitly: copied into a pinned host
buffer before its send, received into one and copied to the card after
— each staging counted.  Nothing switches backend or device on a
failure: a failed send or receive raises.

``stats`` counts this process's calls, bytes and wall seconds (the
wait and staging time of the sends and receives), per direction.
"""
from __future__ import annotations

import collections
import time
from typing import Dict, List, Tuple

import torch
import torch.distributed as dist

from ..parallel.mesh import PIPE_AXIS, Mesh


class PipeStats:
    """Per-process point-to-point counters."""

    __slots__ = ("sends", "recvs", "send_bytes", "recv_bytes", "seconds",
                 "staged")

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.sends = self.recvs = 0
        self.send_bytes = self.recv_bytes = 0
        self.seconds = 0.0
        #: tensors copied through pinned host buffers (gloo + CUDA)
        self.staged = 0

    def as_dict(self) -> Dict[str, float]:
        return {k: getattr(self, k) for k in self.__slots__}


class _Pending:
    """One posted receive: its buffer and the step's works."""

    __slots__ = ("works", "host", "dest", "done")

    def __init__(self, works, host, dest):
        self.works, self.host, self.dest, self.done = works, host, dest, False


class PipeChannel:
    """This rank's sends and receives on the pipe axis of ``mesh``."""

    def __init__(self, mesh: Mesh, device: torch.device):
        self.mesh = mesh
        self.device = torch.device(device)
        self.group = mesh.group(PIPE_AXIS)
        self.stage = mesh.axis_index(PIPE_AXIS)
        self.ranks = mesh.axis_ranks(PIPE_AXIS)
        backend = (dist.get_backend(self.group)
                   if self.group is not None else None)
        self.staged = backend == "gloo" and self.device.type == "cuda"
        self.stats = PipeStats()
        self._pinned: Dict[tuple, List[torch.Tensor]] = \
            collections.defaultdict(list)
        self._send_works: list = []
        self._send_hosts: list = []
        #: the tensors of the posted sends, alive until they complete
        self._sent: list = []

    def _host(self, like: torch.Tensor) -> torch.Tensor:
        key = (tuple(like.shape), like.dtype)
        free = self._pinned[key]
        if free:
            return free.pop()
        return torch.empty(like.shape, dtype=like.dtype, device="cpu",
                           pin_memory=True)

    def _release(self, host: torch.Tensor) -> None:
        self._pinned[(tuple(host.shape), host.dtype)].append(host)

    def step(self, sends: List[Tuple[int, torch.Tensor]],
             recvs: List[Tuple[int, torch.Tensor]]) -> List[_Pending]:
        """Post one schedule step: ``sends`` (peer stage, tensor) and
        ``recvs`` (peer stage, a buffer of the boundary's shape and
        dtype).  Returns one handle per receive (:meth:`wait` gives its
        tensor).  The previous step's sends are completed first."""
        self.finish_sends()
        if not sends and not recvs:
            return []
        if self.group is None:
            raise RuntimeError(
                "pipeline point-to-point call on a mesh with no process "
                "group (a local mesh has one stage)")
        t0 = time.perf_counter()
        ops, pending = [], []
        for peer, t in sends:
            t = t.detach().contiguous()
            if self.staged:
                host = self._host(t)
                host.copy_(t)
                self._send_hosts.append(host)
                self.stats.staged += 1
                t = host
            ops.append(dist.P2POp(dist.isend, t, self.ranks[peer],
                                  group=self.group))
            self._sent.append(t)
            self.stats.sends += 1
            self.stats.send_bytes += t.numel() * t.element_size()
        for peer, buf in recvs:
            host = self._host(buf) if self.staged else None
            ops.append(dist.P2POp(dist.irecv, buf if host is None else host,
                                  self.ranks[peer], group=self.group))
            pending.append(_Pending(None, host, buf))
            self.stats.recvs += 1
            self.stats.recv_bytes += buf.numel() * buf.element_size()
        works = dist.batch_isend_irecv(ops)
        if len(works) == len(ops):
            # one work per op (gloo): each is waited on once, by its owner
            self._send_works = list(works[:len(sends)])
            for i, p in enumerate(pending):
                p.works = [works[len(sends) + i]]
        else:
            # NCCL coalesces the step into one work, which every handle
            # (and the sends' completion) waits on
            self._send_works = list(works) if sends else []
            for p in pending:
                p.works = list(works)
        self.stats.seconds += time.perf_counter() - t0
        return pending

    def wait(self, p: _Pending) -> torch.Tensor:
        """The received tensor of ``p`` (on this rank's device)."""
        if not p.done:
            t0 = time.perf_counter()
            for w in p.works:
                w.wait()
            if p.host is not None:
                p.dest.copy_(p.host)
                self._release(p.host)
                self.stats.staged += 1
            p.done = True
            self.stats.seconds += time.perf_counter() - t0
        return p.dest

    def finish_sends(self) -> None:
        """Complete the posted sends (their buffers may then be reused)."""
        if not self._send_works and not self._sent:
            return
        t0 = time.perf_counter()
        for w in self._send_works:
            w.wait()
        for h in self._send_hosts:
            self._release(h)
        self._send_works, self._send_hosts, self._sent = [], [], []
        self.stats.seconds += time.perf_counter() - t0

