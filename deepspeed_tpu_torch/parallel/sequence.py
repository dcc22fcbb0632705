"""Sequence parallelism — ring attention and Ulysses all-to-all over the
mesh's ``seq`` axis, the port of ``deepspeed_tpu/parallel/sequence.py``.

Each ``seq`` rank is a process holding its shard of the sequence
``[B, H, T_local, D]``; the collectives are ``parallel/collectives.py``'s
autograd pairs on the seq group (NCCL on the card, gloo on the CPU):

  ring_attention(q, k, v, mesh, causal=True)
      Blockwise-softmax attention: the K/V shards rotate around the ring
      (:func:`~.collectives.seq_ring_shift`, n − 1 rotations, the last
      chunk consumed without one) while each rank keeps its query shard,
      accumulating with the flash online-softmax recurrence in fp32.  It
      is ``jnp`` code in the JAX package, so its port is torch ops: no
      kernel.

  ulysses_attention(q, k, v, mesh, causal=True)
      DeepSpeed-Ulysses: a tiled all-to-all re-shards [seq → heads]
      (:func:`~.collectives.seq_all_to_all`), each rank attends the full
      sequence for H/n of its heads — through the flash kernels
      (``ops/kernels/flash_attention.py``: forward, dQ, dK/dV) by default,
      ``local_impl="dense"`` keeping the fp32 einsum path — then an
      all-to-all back.  Needs its heads divisible by the axis size.

Both drop attention probabilities with the flash kernels' position hash
over GLOBAL coordinates (query and key positions in the whole sequence,
the (batch, head) id of each row), so the realization does not depend on
the shard layout.  ``bh_affine = (base, period, stride)`` names the
global id of row g of the caller's ``[B·H]`` grid, ``base + (g //
period)·stride + g % period``, with ``period`` equal to the local head
count; the default ``(0, H, H)`` is the JAX functions' ``arange(B·H)``
(the global ids when the caller holds every row and head).  Under data
and tensor parallelism the caller (``models/gpt2.py``) passes its rows'
and heads' base.  Signatures are the JAX ones with ``axis_name`` replaced
by ``mesh``, plus ``bh_affine``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..ops.kernels.flash_attention import (dense_keep_mask,
                                           dropout_keep_mask, grid_bh_ids)
from . import collectives as col
from .mesh import SEQ_AXIS, Mesh

_NEG = -1e30

__all__ = ["SEQ_AXIS", "ring_attention", "ulysses_attention"]


def _block_scores(q32, k, sm_scale):
    """[B,H,Tq,D] (fp32) x [B,H,Tk,D] → fp32 scores [B,H,Tq,Tk]."""
    return torch.einsum("bhqd,bhkd->bhqk", q32, k.float()) * sm_scale


def _triple(B: int, H: int, bh_affine) -> Tuple[int, int, int]:
    base, period, stride = bh_affine if bh_affine is not None else (0, H, H)
    if int(period) != H:
        raise ValueError(f"bh_affine period {period} must be the local head "
                         f"count {H}")
    return int(base), H, int(stride)


def _rank(mesh: Mesh, rank) -> Tuple[int, int]:
    n = mesh.axis_size(SEQ_AXIS)
    return n, mesh.axis_index(SEQ_AXIS) if rank is None else int(rank)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mesh: Mesh,
                   causal: bool = True,
                   sm_scale: Optional[float] = None,
                   dropout_rate: float = 0.0,
                   dropout_seed=None,
                   rank=None,
                   bh_affine=None) -> torch.Tensor:
    """Ring attention over a sharded sequence.

    q, k, v: this rank's shard [B, H, T_local, D] (the sequence split
    over ``mesh``'s seq axis in seq order).  Returns the local output
    shard [B, H, T_local, D] in ``q``'s dtype.  ``dropout_rate > 0``
    drops probabilities with the flash kernels' hashed keep mask over
    global positions, seeded by ``dropout_seed`` (a uint32 integer, the
    same on every rank).  ``rank``: this rank's seq index (default the
    mesh's)."""
    B, H, T, D = q.shape
    n, idx = _rank(mesh, rank)
    scale = float(D) ** -0.5 if sm_scale is None else sm_scale
    if dropout_rate > 0.0:
        assert dropout_seed is not None, \
            "dropout_rate > 0 requires dropout_seed"
        bh = grid_bh_ids(B * H, _triple(B, H, bh_affine),
                         q.device).view(B, H, 1, 1)

    q32 = q.float()
    pos_local = torch.arange(T, device=q.device)
    q_pos = idx * T + pos_local                     # global query positions

    def accumulate(o, m, l, kc, vc, step):
        """Online-softmax (flash recurrence) over the chunk that
        originated on seq index (idx - step) mod n."""
        src = (idx - step) % n
        k_pos = src * T + pos_local
        s = _block_scores(q32, kc, scale)
        if causal:
            mask = k_pos[None, None, None, :] <= q_pos[None, None, :, None]
            s = torch.where(mask, s, _NEG)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l_new = l * alpha + p.sum(-1)
        pd = p
        if dropout_rate > 0.0:
            keep = dropout_keep_mask(q_pos[None, None, :, None],
                                     k_pos[None, None, None, :], bh,
                                     dropout_seed, dropout_rate)
            pd = p * keep.to(p.dtype) / (1.0 - dropout_rate)
        o_new = o * alpha[..., None] + torch.einsum("bhqk,bhkd->bhqd", pd,
                                                    vc.float())
        return o_new, m_new, l_new

    o = torch.zeros((B, H, T, D), dtype=torch.float32, device=q.device)
    m = torch.full((B, H, T), _NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, T), dtype=torch.float32, device=q.device)
    # K and V rotate as one tensor: one send and one receive a rotation
    kv = torch.stack([k, v])
    for step in range(n - 1):
        o, m, l = accumulate(o, m, l, kv[0], kv[1], step)
        kv = col.seq_ring_shift(kv, mesh)
    # the last chunk is consumed without the wasted final rotation
    o, m, l = accumulate(o, m, l, kv[0], kv[1], n - 1)
    # causal first-token rows always see at least their own position → l>0
    out = o / torch.clamp(l, min=1e-30)[..., None]
    return out.to(q.dtype)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      mesh: Mesh,
                      causal: bool = True,
                      sm_scale: Optional[float] = None,
                      dropout_rate: float = 0.0,
                      dropout_seed=None,
                      local_impl: str = "flash",
                      rank=None,
                      bh_affine=None) -> torch.Tensor:
    """All-to-all sequence parallelism (the DeepSpeed-Ulysses scheme).

    q, k, v: [B, H, T_local, D], the sequence split over ``mesh``'s seq
    axis; H must divide by the axis size.  Each rank attends the FULL
    sequence for H/n heads — through the flash kernels
    (``local_impl="flash"``; on a CUDA tensor they launch or raise) or
    the fp32 einsum path (``"dense"``) — with the hashed dropout mask
    over global positions and global (batch, head) ids, so the dense,
    ring and Ulysses realizations agree for one seed."""
    B, H, T, D = q.shape
    n, idx = _rank(mesh, rank)
    if H % n:
        raise ValueError(
            f"ulysses needs heads ({H}) divisible by sequence shards ({n})")
    if local_impl not in ("flash", "dense"):
        raise ValueError(f"local_impl={local_impl!r}: expected 'flash' or "
                         "'dense'")
    if dropout_rate > 0.0:
        assert dropout_seed is not None, \
            "dropout_rate > 0 requires dropout_seed"
    base, _, stride = _triple(B, H, bh_affine)
    hn = H // n

    def head2seq(x):
        # [B, H/n, T_global, D] → [B, H, T_local, D]
        return col.seq_all_to_all(x, mesh, 2, 1)

    # [3, B, H, T_local, D] → [3, B, H/n, n·T_local, D]: the head dim
    # splits n ways and the received sequence chunks concatenate in seq
    # order — q, k and v in one exchange (JAX makes three; the function
    # is the same)
    qg, kg, vg = col.seq_all_to_all(torch.stack([q, k, v]), mesh, 2,
                                    3).unbind(0)
    scale = float(D) ** -0.5 if sm_scale is None else sm_scale
    # this rank holds local heads idx·H/n … (idx+1)·H/n − 1: row
    # g = b·(H/n) + j of its grid is global id base + b·stride + idx·H/n + j
    triple = (base + idx * hn, hn, stride)
    if local_impl == "flash":
        from ..ops.kernels.flash_attention import flash_attention
        og = flash_attention(qg, kg, vg, causal=causal, sm_scale=scale,
                             dropout_rate=dropout_rate,
                             dropout_seed=dropout_seed, bh_affine=triple)
        return head2seq(og)
    s = _block_scores(qg.float(), kg, scale)
    if causal:
        Tg = s.shape[-1]
        mask = torch.tril(torch.ones((Tg, Tg), dtype=torch.bool,
                                     device=q.device))
        s = torch.where(mask[None, None], s, _NEG)
    p = torch.softmax(s, dim=-1)
    if dropout_rate > 0.0:
        Tg = p.shape[-1]
        keep = dense_keep_mask(B, hn, Tg, Tg, dropout_seed, dropout_rate,
                               bh_ids=grid_bh_ids(B * hn, triple, q.device),
                               device=q.device)
        p = p * keep.to(p.dtype) / (1.0 - dropout_rate)
    og = torch.einsum("bhqk,bhkd->bhqd", p, vg.float()).to(q.dtype)
    return head2seq(og)
