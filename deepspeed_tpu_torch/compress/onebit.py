"""1-bit Adam — the port of ``deepspeed_tpu/compress/onebit.py``:
error-feedback sign compression of the momentum, exchanged over the
``data`` process group.

The two-phase compressed all-reduce (the reference's igather to servers
and allgather of their results):

  worker:  buf = momentum + worker_error, padded to ``padded_size``;
           scale = ||buf||_2 / sqrt(P) over the padded length P;
           sign-compress (sign(0) = +1); worker_error = buf - scale·sign;
           chunk r of the packed signs goes to data index r
           (:func:`~..parallel.collectives.onebit_all_to_all`), the
           scales to every index
  server:  the mean of the workers' scaled signs over its chunk,
           compressed again against ``server_error``; the packed result
           and its scale all-gathered over ``data``

The signs travel bit-packed as ``uint8``, big-endian like
``cupy.packbits`` (bit weight 128 first; a 0 bit unpacks to −1, a 1 bit
to +1), so the wire holds 1/32 of the fp32 momentum.  The padded tail's
zeros take sign +1, so their error is −scale and carries over like any
other element's.

``onebit_adam`` is the optimizer, with the ``init`` / ``update(grads,
state, params)`` contract of ``ops/adam.py::fused_adam`` (lists of
tensors in ``tree_leaves`` order).  Steps 1..freeze_step are Adam on both
moments (from the data-mean gradient where a mesh is given) without bias
correction — the reference computes the flag and never applies it; ν
takes ``ops/adam.py``'s ``(1 − β2)·(g·g)``, one rounding from the JAX
code's ``(1 − β2)·g·g``, so these steps are the port's Adam to the bit
— and afterwards ν stays as it is and μ is replaced by the compressed
exchange's output.  Weight decay adds ``wd·p`` to the update, and the
learning rate is ``lr(count)`` at the incremented count.  Without a mesh
the optimizer runs the single-worker simulation of the exchange (the
engine's one-rank path).  None of this is a kernel in the JAX package:
the packing, the compression and the exchange are torch ops and
``torch.distributed`` calls here too.
"""
from __future__ import annotations

import math
from typing import Callable, List, NamedTuple, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from ..ops.adam import GradientTransformation, adam_moments
from ..parallel import collectives as col
from ..parallel.mesh import DATA_AXIS

ScalarOrSchedule = Union[float, Callable[[torch.Tensor], torch.Tensor]]

# packbits-compatible big-endian bit weights (cupy.packbits default order)
_BIT_WEIGHTS = (128, 64, 32, 16, 8, 4, 2, 1)
#: the weights on each device, copied there once (a step copies nothing
#: from the host)
_weights_on: dict = {}


def _weights(device) -> torch.Tensor:
    w = _weights_on.get(device)
    if w is None:
        w = _weights_on[device] = torch.tensor(_BIT_WEIGHTS,
                                               dtype=torch.uint8,
                                               device=device)
    return w


def pack_signs(bits: torch.Tensor) -> torch.Tensor:
    """bool ``[..., 8k]`` → uint8 ``[..., k]``, big-endian like
    ``cupy.packbits``."""
    b = bits.reshape(tuple(bits.shape[:-1]) + (-1, 8)).to(torch.uint8)
    return (b * _weights(bits.device)).sum(-1, dtype=torch.uint8)


def unpack_signs(packed: torch.Tensor) -> torch.Tensor:
    """uint8 ``[..., k]`` → ±1 float32 ``[..., 8k]`` (a 0 bit → −1, a 1
    bit → +1)."""
    bits = (packed.unsqueeze(-1) & _weights(packed.device)) > 0
    pm = bits.to(torch.float32) * 2.0 - 1.0
    return pm.reshape(tuple(packed.shape[:-1]) + (-1,))


def _sign_compress(buf: torch.Tensor, error: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Error-feedback sign compression of a flat buffer: (sign ±1, scale,
    new error), ``scale = ||buf + error||_2 / sqrt(n)`` and sign(0) = +1
    (the reference's ``sign().add_(1).bool()``)."""
    buf = buf + error
    # the sum of squares accumulated in fp64 and rounded once to fp32: an
    # fp32 accumulation over millions of elements drifts by 1e-5 relative
    # and more; sqrt(n) rounded once to fp32, as the JAX code's fp32 sqrt
    scale = (torch.linalg.vector_norm(buf, dtype=torch.float64).float()
             / math.sqrt(buf.numel()))
    sign = torch.where(buf >= 0, 1.0, -1.0).to(torch.float32)
    return sign, scale, buf - scale * sign


def padded_size(n: int, world: int) -> int:
    """Pad length so every per-server chunk is a whole number of bytes
    (the reference's ``corrected_tensor_size``)."""
    q = world * 8
    return ((n + q - 1) // q) * q


def _padded(x: torch.Tensor, P: int) -> torch.Tensor:
    flat = x.reshape(-1).to(torch.float32)
    return F.pad(flat, (0, P - flat.numel()))


def compressed_allreduce(x: torch.Tensor, worker_error: torch.Tensor,
                         server_error: torch.Tensor, mesh,
                         axis: str = DATA_AXIS
                         ) -> Tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor]:
    """The two-phase error-compensated 1-bit all-reduce over ``axis`` of
    ``mesh``.  ``x`` is this rank's buffer (flattened), ``worker_error``
    has ``padded_size(x.numel(), world)`` elements and ``server_error``
    one world-th of that.  Returns (the averaged buffer, flat
    ``[x.numel()]``; the new worker error; the new server error)."""
    world = mesh.axis_size(axis)
    n = x.numel()
    P = worker_error.numel()
    chunk = P // world
    if P != padded_size(n, world) or server_error.numel() != chunk:
        raise ValueError(
            f"error-buffer sizes ({P}, {server_error.numel()}) do not "
            f"match padded_size({n}, {world})={padded_size(n, world)}")
    sign, scale, new_we = _sign_compress(_padded(x, P), worker_error)

    # phase 1: chunk r of the packed signs to server r, the scales to all
    packed = pack_signs(sign.reshape(world, chunk) > 0)     # [world, c/8]
    recv = col.onebit_all_to_all(packed, mesh, axis)
    scales = col.data_all_gather(scale.reshape(1), mesh, col.onebit_stats,
                                 axis).reshape(world)

    # server: the workers' scaled signs of my chunk averaged, compressed
    comp = (unpack_signs(recv) * scales[:, None]).mean(0)
    ssign, sscale, new_se = _sign_compress(comp, server_error)

    # phase 2: every server's compressed chunk and scale to all
    all_signs = col.data_all_gather(pack_signs(ssign > 0), mesh,
                                    col.onebit_stats, axis)  # [world, c/8]
    all_scales = col.data_all_gather(sscale.reshape(1), mesh,
                                     col.onebit_stats, axis).reshape(world)
    out = (unpack_signs(all_signs) * all_scales[:, None]).reshape(P)[:n]
    return out, new_we, new_se


def simulated_compressed_allreduce(x: torch.Tensor,
                                   worker_error: torch.Tensor,
                                   server_error: torch.Tensor
                                   ) -> Tuple[torch.Tensor, torch.Tensor,
                                              torch.Tensor]:
    """The exchange's fixed point when every worker holds the same buffer
    (one worker): worker compress → server compress, no communication.
    ``server_error`` spans the whole padded buffer here."""
    n = x.numel()
    sign, scale, new_we = _sign_compress(_padded(x, worker_error.numel()),
                                         worker_error)
    ssign, sscale, new_se = _sign_compress(scale * sign, server_error)
    return (sscale * ssign)[:n], new_we, new_se


class OnebitAdamState(NamedTuple):
    count: torch.Tensor                # i32 device scalar: applied steps
    mu: List[torch.Tensor]             # momentum (fp32)
    nu: List[torch.Tensor]             # variance (fp32, frozen after freeze)
    worker_error: List[torch.Tensor]   # flat padded, per leaf
    server_error: List[torch.Tensor]   # flat padded / world, per leaf


def init_onebit_state(params, world: int) -> OnebitAdamState:
    """Zeroed state with error buffers sized for a ``data`` axis of
    ``world`` ranks (``world=1``: the simulated exchange's sizes)."""
    dev = params[0].device if params else None
    sizes = [padded_size(p.numel(), world) for p in params]
    return OnebitAdamState(
        count=torch.zeros((), dtype=torch.int32, device=dev),
        mu=[torch.zeros_like(p, dtype=torch.float32) for p in params],
        nu=[torch.zeros_like(p, dtype=torch.float32) for p in params],
        worker_error=[torch.zeros(P, dtype=torch.float32, device=dev)
                      for P in sizes],
        server_error=[torch.zeros(P // world, dtype=torch.float32,
                                  device=dev) for P in sizes])


def onebit_adam(lr: ScalarOrSchedule = 1e-3,
                betas: Tuple[float, float] = (0.9, 0.999),
                eps: float = 1e-8,
                weight_decay: float = 0.0,
                freeze_step: int = 100000,
                mesh=None,
                data_axis: str = DATA_AXIS,
                phase: Optional[str] = None) -> GradientTransformation:
    """1-bit Adam.  With ``mesh`` the gradients are this rank's local
    ones: warm steps average them over ``data_axis`` and frozen steps
    exchange the momentum through :func:`compressed_allreduce` (the error
    buffers sized by ``init_onebit_state(params, world)``); without it
    the single-worker simulation runs on already-averaged gradients.

    ``phase``: ``"warm"`` / ``"frozen"`` fix the branch (the engine's
    pair of steps, chosen on the host); ``None`` takes the warm branch
    while the incremented count is at most ``freeze_step`` — without a
    mesh by computing both branches and selecting on the card (no read
    back), with a mesh by reading the count on the host, so that only one
    branch's collectives run."""
    b1, b2 = betas
    if phase not in (None, "warm", "frozen"):
        raise ValueError(f"phase must be None|'warm'|'frozen', got {phase!r}")

    def init_fn(params):
        return init_onebit_state(params, 1)

    def warm(g, mu, nu):
        ga = col.pmean(g, mesh, data_axis) if mesh is not None else g
        # Adam's moments (``ops/adam.py::adam_moments``), so the warm
        # steps are Adam without bias correction to the bit; the JAX
        # code's (1 - b2) * g * g rounds ν once differently
        return adam_moments([ga], [mu], [nu], b1, b2)

    def frozen(g, mu, we, se):
        mu2 = b1 * mu + (1 - b1) * g
        if mesh is not None:
            out, we2, se2 = compressed_allreduce(mu2, we, se, mesh,
                                                 data_axis)
        else:
            out, we2, se2 = simulated_compressed_allreduce(mu2, we, se)
        return out.reshape(mu2.shape), we2, se2

    def update_fn(grads, state, params=None):
        if params is None:
            raise ValueError("onebit_adam requires params (weight decay)")
        count = state.count + 1
        branch = phase
        if branch is None and mesh is not None:
            branch = "warm" if int(count) <= freeze_step else "frozen"
        is_warm = count <= freeze_step
        if callable(lr):
            step_lr = torch.as_tensor(lr(count), dtype=torch.float32,
                                      device=count.device)
        else:
            step_lr = torch.full((), float(lr), dtype=torch.float32,
                                 device=count.device)
        out = ([], [], [], [], [])
        for g, p, mu, nu, we, se in zip(grads, params, state.mu, state.nu,
                                        state.worker_error,
                                        state.server_error):
            g = g.to(torch.float32)
            if branch == "warm":
                (mu2,), (nu2,) = warm(g, mu, nu)
                we2, se2 = we, se
            elif branch == "frozen":
                mu2, we2, se2 = frozen(g, mu, we, se)
                nu2 = nu
            else:
                (wmu,), (wnu,) = warm(g, mu, nu)
                fmu, fwe, fse = frozen(g, mu, we, se)
                mu2 = torch.where(is_warm, wmu, fmu)
                nu2 = torch.where(is_warm, wnu, nu)
                we2 = torch.where(is_warm, we, fwe)
                se2 = torch.where(is_warm, se, fse)
            upd = mu2 / (torch.sqrt(nu2) + eps)
            if weight_decay > 0.0:
                upd = upd + weight_decay * p.to(torch.float32)
            for lst, v in zip(out, ((-step_lr * upd).to(p.dtype), mu2, nu2,
                                    we2, se2)):
                lst.append(v)
        updates, mu, nu, we, se = out
        return updates, OnebitAdamState(count=count, mu=mu, nu=nu,
                                        worker_error=we, server_error=se)

    return GradientTransformation(init_fn, update_fn)
