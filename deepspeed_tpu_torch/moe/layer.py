"""Mixture-of-Experts FFN with expert parallelism over ``data`` — the port
of ``deepspeed_tpu/moe/layer.py``.

The math is the JAX layer's, function for function: fp32 gating, top-1
(Switch) or top-2 (GShard, the two gates renormalized) routing, static
capacity ``ceil(top_k · cf · S / E)`` with over-capacity tokens dropped
(their output is zero; the caller's residual carries them), the Switch
load-balance loss ``E · Σ_e density_e · mean_prob_e``, the router z-loss
and the multiplicative router jitter.  Both dispatch forms are here: the
one-hot einsums (``"einsum"``) and the scatter/gather form
(``"scatter"``: ``index_add`` into the capacity slots, ``gather`` back).
Like the JAX layer, none of it is a hand-written kernel: the routing,
the dispatch and combine, the scatter/gather and the expert products are
torch ops.

Expert parallelism.  The JAX layer states it as placement: the expert
dim of ``wi``/``bi``/``wo``/``bo`` carries ``'data'``
(:func:`moe_param_specs`), ``_constrain`` pins the dispatched tokens
``[E, G, C, d]`` to the same placement, and GSPMD writes the exchange.
Here the training engine gives each data rank its ``E/dp`` experts
(``runtime/zero.py``) and :func:`moe_ffn` moves the tokens itself: under
a mesh whose ``data`` axis divides ``E``, the rank's dispatched tokens
``[E, G_local, C, d]`` go through ``collectives.data_all_to_all`` to
``[E/dp, G, C, d]`` (every data rank's tokens for the rank's experts),
the rank runs its experts, and the outputs go back the same way before
the combine.  The all-to-all's backward is the reverse exchange, so an
expert's gradient holds every data rank's tokens.  Under tensor
parallelism the experts are column- then row-parallel over ``model``,
as ``gpt2_ffn`` is (``bo`` added once, after the all-reduce), and the
exchange runs in the data group of the rank's model index.  Where
``data`` does not divide ``E`` the experts stay replicated and each rank
runs all of them on its own tokens, with no exchange.

Sequence parallelism.  Under a mesh with a ``seq`` axis of sp > 1 each
rank holds ``S/sp`` tokens of every row, and the layer computes what the
JAX layer computes on the whole sequence: the capacity is that of the
whole row (``C = capacity(sp · S)``); each token's arrival position is
its rank-local ``cumsum`` plus the counts ``[G, E]`` of its choice on the
lower seq ranks, and a second choice queues behind every first choice of
the whole row, so the drops fall on global positions.  One all-gather of
the routing counts over ``seq`` (``collectives.seq_all_gather``) gives
both.  Each rank fills only its own tokens' slots of the global
``[E, G, C, d]`` buffer and runs the experts (and the exchange over
``data``) on that partial buffer: the expert FFN is slotwise, a token's
output depends on its own slot only, and a slot another rank filled gets
no cotangent here (its combine weight is zero on this rank), so the
expert gradients hold the rank's tokens and ZeRO's sum over ``seq``
(``runtime/zero.py``) completes them once.

The aux loss is the JAX layer's over the GLOBAL batch: the routed
counts and the probability sums are summed over ``data`` and ``seq``
before their product, and the z-loss is a mean over every token.  Over
``data`` the sums go through ``collectives.sum_over_axis`` (its backward
all-reduces the cotangents: the engine averages the data ranks'
gradients, and every rank's loss takes the aux whole); over ``seq``
through ``collectives.reduce_from_axis`` (its backward passes the
cotangent through: the engine sums the seq ranks' gradients, so each
rank back-propagates its own tokens' share, as ``token_mean`` does for
the loss).  The jitter's uniform draw covers the global rows and the
whole sequence (``runtime.utils.data_rows``, ``seq_tokens``), so a data-
or sequence-parallel run equals the one-rank run.  ``rng`` is the port's
host-integer seed; the jitter's seed is ``fold_in(rng, 11)``, as the JAX
layer folds its key.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..parallel import collectives as col
from ..parallel.mesh import DATA_AXIS, MODEL_AXIS, SEQ_AXIS
from ..runtime.utils import data_rows, fold_in, seeded_generator, seq_tokens


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    d_model: int
    d_ff: int
    top_k: int = 1                    # 1 = Switch, 2 = GShard
    capacity_factor: float = 1.25
    eval_capacity_factor: float = 2.0
    aux_loss_weight: float = 1e-2
    z_loss_weight: float = 0.0
    router_jitter: float = 0.0        # multiplicative input noise, train only
    dispatch_impl: str = "einsum"     # "einsum" (one-hot) | "scatter"

    def __post_init__(self):
        if self.top_k not in (1, 2):
            raise ValueError(f"top_k must be 1 or 2, got {self.top_k}")
        if self.dispatch_impl not in ("einsum", "scatter"):
            raise ValueError(
                f"dispatch_impl must be 'einsum' or 'scatter', got "
                f"{self.dispatch_impl!r}")
        if self.n_experts < 1:
            raise ValueError(f"n_experts must be >= 1, got {self.n_experts}")
        if self.n_experts < self.top_k:
            # top_k > n_experts would double-assign tokens to expert 0
            # with half gates — a silent half-weighting
            raise ValueError(
                f"n_experts ({self.n_experts}) must be >= top_k "
                f"({self.top_k})")

    def capacity(self, tokens_per_group: int, train: bool) -> int:
        cf = self.capacity_factor if train else self.eval_capacity_factor
        c = math.ceil(self.top_k * cf * tokens_per_group / self.n_experts)
        return max(1, min(tokens_per_group, c))


def init_moe_params(gen: torch.Generator, cfg: MoEConfig, std: float = 0.02,
                    out_std: Optional[float] = None,
                    dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
    """Expert-stacked FFN weights and the router, drawn from ``gen`` (an
    explicit ``torch.Generator``, on the device the tensors land on):
    the JAX init's distributions, not its numbers.  ``out_std`` scales
    the output projection (models pass their residual-scaled std)."""
    E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    dev = gen.device

    def norm(shape, s):
        return (torch.randn(shape, generator=gen, device=dev,
                            dtype=torch.float32) * s).to(dtype)

    return {
        "wg": norm((d, E), std),
        "wi": norm((E, d, f), std),
        "bi": torch.zeros((E, f), device=dev, dtype=dtype),
        "wo": norm((E, f, d), std if out_std is None else out_std),
        "bo": torch.zeros((E, d), device=dev, dtype=dtype),
    }


def moe_param_specs(ep_axis: str = DATA_AXIS,
                    tp_axis: Optional[str] = MODEL_AXIS,
                    stacked: bool = False) -> Dict[str, tuple]:
    """Placement (the port's tuple of axis names per dim): the expert dim
    over ``ep_axis``, the hidden feature dim over ``tp_axis`` (column- and
    row-parallel experts; None disables the split).  With ``stacked`` the
    specs gain a leading None for a layer axis."""
    lead = (None,) if stacked else ()
    tp = tp_axis
    return {
        "wg": lead,                          # tiny; replicated
        "wi": (*lead, ep_axis, None, tp),    # column parallel
        "bi": (*lead, ep_axis, tp),
        "wo": (*lead, ep_axis, tp, None),    # row parallel
        "bo": (*lead, ep_axis, None),
    }


def _route(probs, top_k: int):
    """Routing choices from fp32 router probs [G, S, E]: ``[(idx [G, S],
    gate [G, S], mask [G, S, E]), ...]`` per choice — the one source of
    the gate math for both dispatch forms.  ``argmax`` takes the first
    of tied maxima, as ``jnp.argmax`` does."""
    E = probs.shape[-1]
    idx1 = probs.argmax(dim=-1)
    mask1 = F.one_hot(idx1, E).to(probs.dtype)
    g1 = (probs * mask1).sum(dim=-1)
    if top_k == 1:
        return [(idx1, g1, mask1)]
    probs2 = probs * (1.0 - mask1)
    idx2 = probs2.argmax(dim=-1)
    mask2 = F.one_hot(idx2, E).to(probs.dtype)
    g2 = (probs * mask2).sum(dim=-1)
    denom = torch.clamp(g1 + g2, min=1e-9)
    return [(idx1, g1 / denom, mask1), (idx2, g2 / denom, mask2)]


def _choice_positions(mask, base):
    """Each (token, expert)'s arrival position [G, S, E] for one choice's
    one-hot mask, in fp32 as the JAX layer keeps it (the drops compare
    it with the capacity); ``base`` [G, 1, E] queues this choice behind
    the earlier choices' assignments (and, on a seq shard, behind the
    lower seq ranks' tokens).  -1 where not selected."""
    return (torch.cumsum(mask, dim=1) + base) * mask - 1.0


def _queue_bases(choices, mesh):
    """(each choice's ``base`` [G, 1, E], the first choices' counts [E]
    over the rank's rows of the whole sequence).  GShard order: choice k
    queues behind every earlier choice of the whole row.  On a seq axis
    of sp > 1 the counts ``[k, G, E]`` of every seq rank are gathered
    once: a choice's base adds its counts on the lower seq ranks, and
    the second choice's adds every seq rank's first choices."""
    counts = torch.stack([m.sum(dim=1) for _idx, _gate, m in choices])
    sp = 1 if mesh is None else mesh.axis_size(SEQ_AXIS)
    if sp > 1:
        every = col.seq_all_gather(counts, mesh)           # [sp, k, G, E]
        lower = every[:mesh.axis_index(SEQ_AXIS)].sum(dim=0)
        total = every.sum(dim=0)
    else:
        lower, total = torch.zeros_like(counts), counts
    bases, behind = [], torch.zeros_like(counts[0])
    for k in range(len(choices)):
        bases.append((behind + lower[k])[:, None, :])
        behind = behind + total[k]
    return bases, total[0].sum(dim=0)


def _einsum_dispatch(choices, bases, capacity: int):
    """(dispatch [G, S, E, C] in {0, 1}, combine [G, S, E, C]): the
    one-hot formulation.  ``jax.nn.one_hot`` gives a zero row for a
    position of -1 or >= C, where ``F.one_hot`` raises: the position is
    clamped into range and those rows zeroed by the keep mask."""
    dispatch = combine = None
    for (_idx, gate, mask), base in zip(choices, bases):
        pos = _choice_positions(mask, base)
        keep = (pos >= 0) & (pos < capacity)
        slot = pos.clamp(0, capacity - 1).long()
        d = (F.one_hot(slot, capacity).to(mask.dtype)
             * (mask * keep)[..., None])
        c = gate[..., None, None] * d
        dispatch = d if dispatch is None else dispatch + d
        combine = c if combine is None else combine + c
    return dispatch, combine


def _token_slots(mask, base):
    """Each token's capacity slot [G, S] (fp32) for one choice: its
    position in its expert's arrival order, the max over E."""
    return _choice_positions(mask, base).max(dim=-1).values


def _expert_parallel(mesh, n_experts: int) -> bool:
    """The experts are split over ``data`` (and the tokens exchanged):
    under a mesh whose data axis divides the expert count — the rule by
    which the engine places them (``runtime/zero.py``)."""
    return mesh is not None and n_experts % mesh.axis_size(DATA_AXIS) == 0


def _experts(mp: Dict[str, Any], ein, mesh):
    """Dispatched tokens ``ein`` [E, G, C, d] → expert outputs, the same
    shape.  Under expert parallelism the tokens go to their experts'
    data ranks and back (``data_all_to_all``) around the rank's own
    ``E/dp`` experts; under a mesh the products are column- then
    row-parallel over ``model``."""
    E = ein.shape[0]
    ep = _expert_parallel(mesh, E)
    if ep:
        ein = col.data_all_to_all(ein, mesh, 0, 1)       # [E/dp, G, C, d]
    El, G, C, d = ein.shape
    if mp["wi"].shape[0] != El:
        raise ValueError(
            f"the expert weights hold {mp['wi'].shape[0]} experts, the "
            f"dispatched tokens {El} (of {E}; mesh {mesh})")
    dt = ein.dtype
    if mesh is not None:
        ein = col.copy_to_axis(ein, mesh, MODEL_AXIS)
    h = ein.reshape(El, G * C, d) @ mp["wi"].to(dt)
    h = F.gelu(h + mp["bi"].to(dt)[:, None, :], approximate="tanh")
    eo = h @ mp["wo"].to(dt)
    if mesh is not None:
        eo = col.reduce_from_axis(eo, mesh, MODEL_AXIS)
    eo = (eo + mp["bo"].to(dt)[:, None, :]).reshape(El, G, C, d)
    if ep:
        eo = col.data_all_to_all(eo, mesh, 1, 0)         # [E, G_local, C, d]
    return eo


def _scatter_moe(cfg: MoEConfig, mp: Dict[str, Any], x, capacity: int,
                 choices, bases, mesh):
    """Scatter/gather dispatch: each kept token added into its slot of
    a ``[G·E·C, d]`` buffer (``index_add``), the experts run on it, and
    each token's output gathered back and gated.  Slots are unique by
    construction; a dropped token adds zeros to its expert's last
    slot."""
    G, S, d = x.shape
    E, C = cfg.n_experts, capacity
    dt = x.dtype
    slots = []
    for (idx, gate, mask), base in zip(choices, bases):
        pos = _token_slots(mask, base)                       # [G, S]
        keep = pos < C
        slot = idx * C + torch.clamp(pos, max=C - 1.0).long()
        slots.append((slot, keep, gate))

    group_off = (torch.arange(G, device=x.device) * (E * C))[:, None]
    xf = x.reshape(G * S, d)
    buf = x.new_zeros((G * E * C, d))
    for slot, keep, _gate in slots:
        flat = (slot + group_off).reshape(-1)
        buf = buf.index_add(0, flat, xf * keep.reshape(-1, 1).to(dt))

    ein = buf.reshape(G, E, C, d).transpose(0, 1)            # [E, G, C, d]
    eo = _experts(mp, ein, mesh)
    eo_g = eo.transpose(0, 1).reshape(G, E * C, d)           # [G, E·C, d]
    y = torch.zeros_like(x)
    for slot, keep, gate in slots:
        picked = torch.gather(eo_g, 1, slot[..., None].expand(G, S, d))
        y = y + picked * (gate * keep).to(dt)[..., None]
    return y


def _global_sum(v, mesh):
    """``v`` summed over the global batch: over ``data`` with its
    cotangent all-reduced, over ``seq`` with it passed through (the
    module docstring says why)."""
    if mesh is None:
        return v
    v = col.sum_over_axis(v, mesh, DATA_AXIS)
    if mesh.axis_size(SEQ_AXIS) > 1:
        v = col.reduce_from_axis(v, mesh, SEQ_AXIS)
    return v


def moe_ffn(cfg: MoEConfig, mp: Dict[str, Any], x: torch.Tensor,
            rng: Optional[int], train: bool = True,
            mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [G, S, d] → (y [G, S, d], the weighted aux loss, an fp32 scalar,
    the same on every rank).  ``mesh``: the training engine's (the rank's
    rows of the global batch and its token shard of the sequence, its
    expert and tensor-parallel pieces); None for one process holding
    everything.  Dropped tokens give y = 0 at their positions."""
    G, S, d = x.shape
    E = cfg.n_experts
    seq = seq_tokens(mesh, S)
    s_all = S if seq is None else seq[1]              # the whole sequence
    C = cfg.capacity(s_all, train)
    rows = data_rows(mesh, G)
    g_all = G if rows is None else rows[1]           # the global rows
    n_tok = float(g_all * s_all)
    x_gate = x.float()
    if train and cfg.router_jitter > 0.0:
        eps = cfg.router_jitter
        u = torch.rand((g_all, s_all, d), device=x.device,
                       generator=seeded_generator(fold_in(rng, 11),
                                                  x.device))
        if rows is not None:
            u = u[rows[0]:rows[0] + G]
        if seq is not None:
            u = u[:, seq[0]:seq[0] + S]
        x_gate = x_gate * ((1.0 - eps) + (2.0 * eps) * u)
    logits = x_gate @ mp["wg"].float()                        # [G, S, E]
    probs = torch.softmax(logits, dim=-1)
    choices = _route(probs, cfg.top_k)
    bases, routed = _queue_bases(choices, mesh)

    # Switch load-balance loss over the global batch: E · Σ_e (fraction
    # routed to e) · (mean router prob of e), 1.0 at perfect balance —
    # the counts and sums reduced over ``data`` and ``seq`` before the
    # product (``routed`` holds the whole sequence's already)
    prob_sum = probs.sum(dim=(0, 1))
    if mesh is not None:
        routed = col.psum(routed, mesh, DATA_AXIS)
    prob_sum = _global_sum(prob_sum, mesh)
    aux = cfg.aux_loss_weight * E * torch.sum(
        (routed / n_tok) * (prob_sum / n_tok))
    if cfg.z_loss_weight > 0.0:
        z = torch.logsumexp(logits, dim=-1)
        zz = _global_sum((z * z).sum(), mesh)
        aux = aux + cfg.z_loss_weight * (zz / n_tok)

    if cfg.dispatch_impl == "scatter":
        return _scatter_moe(cfg, mp, x, C, choices, bases, mesh), aux

    dispatch, combine = _einsum_dispatch(choices, bases, C)
    dt = x.dtype
    ein = torch.einsum("gsec,gsd->egcd", dispatch.to(dt), x)
    eo = _experts(mp, ein, mesh)
    y = torch.einsum("gsec,egcd->gsd", combine.to(dt), eo)
    return y, aux
