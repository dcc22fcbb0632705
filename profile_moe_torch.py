#!/usr/bin/env python3
"""GPT-2 small MoE with expert parallelism over the cards of one machine,
over NCCL.

    python3 profile_moe_torch.py

Needs at least two NVIDIA cards. From chip_smoke.py's train_moe weight
tree and batch (GPT-2 small at full width and depth with 8 experts on
every second block, top-2, capacity factor 1.25, aux 1e-2, z-loss 1e-3,
dropout 0.1, 8 x 1024 tokens, Adam, clipping 1.0, no remat, ZeRO 0; 1 +
2 steps) it trains at ep N = the card count (4 at most) — one data rank
a process and a card, each holding 8/N experts, the token exchange an
NCCL all-to-all on the card with no host staging — at fp32 and bf16,
against the same model at ep 1 on card 0 with no process group and the
same micro-batches (N rows each), Adam's eps 1e-3 at fp32. First each
rank runs one MoE layer on its experts and its row against the whole
layer (chip_smoke's ``_moe_layer_split``: y and every gradient within
1e-5 normwise, the same dropped tokens). The fp32 losses must match ep
1's within 1e-3 relative (chip_smoke's ``MOE_LOSS_RTOL``: fp32 rounding
flips routing near-ties) and the first bf16 loss within 1e-2; every
rank's flash launches a step must be L·M, and its exchange's calls and
bytes a step those worked out from ``[E, rows, C, d]``. One more step of
each arm runs under ``torch.profiler`` (CUDA activity) and the NCCL
kernels' device time is summed over it: an NCCL kernel spins from its
launch until its peers arrive, so that sum holds the ranks' skew as well
as the transfers — it bounds the collectives' time from above and is no
share of the step. It prints each rank's step ms, peak MiB, the
exchange's counters a step and that sum, beside the cards' names and
power limits, and ends with one JSON line. Any failure exits non-zero.

With four cards or more it then trains ep 2 × sp 2 — dp 2 with 4 experts
a data rank, each data rank's rows split over a seq axis of 2 with
Ulysses attention, one process a card — at fp32 and bf16 on
micro-batches of 2 rows a data rank (the ep-N run's 4 global rows), 1 +
2 steps and one profiled step, against the same ep 1 engines: first one
MoE layer split over both axes against the whole layer (the same check),
then the fp32 losses within 1e-3 of ep 1's and the first bf16 loss
within 1e-2; every rank's flash launches a step L·M, its expert
exchange's and its seq collectives' (the Ulysses all-to-alls and the
routing-count gather) calls and bytes a step those worked out from the
shapes.
"""
import json
import sys

import chip_smoke as cs

ARMS = "fp32,bf16"

_RANK = r"""
import sys
sys.path.insert(0, sys.argv[1])
import profile_moe_torch
profile_moe_torch.moe_rank(int(sys.argv[2]), sys.argv[3], float(sys.argv[4]),
                           int(sys.argv[5]), sys.argv[6])
"""


_SEQ_RANK = _RANK.replace("moe_rank", "moe_seq_rank")
#: ep 2 × sp 2: the data and seq axes and a data rank's micro-batch
SEQ_DP, SEQ_MICRO = 2, 2


def moe_seq_rank(rank: int, init: str, digest: float, world: int,
                 backend: str = "nccl") -> None:
    """chip_smoke's ``moe_seq_rank`` on card ``rank`` at dp ``SEQ_DP`` ×
    sp ``world / SEQ_DP``, both arms, each followed by one profiled
    step."""
    def profiled(eng, tokens, r):
        r["profiled_ms"], r["nccl_ms"] = _profiled_step(eng, tokens)
    cs.moe_seq_rank(rank, init, digest, world, backend, dp=SEQ_DP,
                    micro=SEQ_MICRO, ga=cs.PIPE_GA // (SEQ_DP * SEQ_MICRO),
                    arms=ARMS, after=profiled)


def moe_rank(rank: int, init: str, digest: float, world: int,
             backend: str = "nccl") -> None:
    """chip_smoke's ``moe_rank`` on card ``rank`` for both arms, each
    followed by one profiled step."""
    def profiled(eng, tokens, r):
        r["profiled_ms"], r["nccl_ms"] = _profiled_step(eng, tokens)
    cs.moe_rank(rank, init, digest, world, backend, ARMS, after=profiled)


def _profiled_step(eng, tokens):
    """One more step under ``torch.profiler``: (host ms, the NCCL
    kernels' device ms)."""
    import time
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.train_batch(tokens)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    nccl = sum(e.self_device_time_total for e in prof.key_averages()
               if "nccl" in e.key.lower()) / 1e3
    return wall, nccl


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        cs.fail("no CUDA device")
    cards_n = torch.cuda.device_count()
    if cards_n < 2:
        cs.fail(f"expert parallelism over NCCL needs two cards or more, "
                f"found {cards_n}")
    world = min(cards_n, 4)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cards = "; ".join(cs.smi().splitlines())
    print(f"[moe] {cards_n} x {torch.cuda.get_device_name(0)}; "
          f"nvidia-smi: {cards}")
    cs.phase_build()
    dev = torch.device("cuda", 0)
    tree, digest = cs._moe_tree()
    tokens = torch.from_numpy(cs._pipe_tokens()).to(dev)
    L, M = 12, cs.PIPE_GA
    ga = M // world
    ref = {}
    for label in ARMS.split(","):
        block = {"bf16": {"enabled": True}} if label == "bf16" else {}
        eng = cs._moe_engine(dev, block, world, ga, params=tree)
        ref[label] = cs._seq_steps(eng, tokens, cs.MOE_STEPS, dev, "ep")
        eng.close()
        print(f"[moe] ep 1 {label} on card 0 (micro-batches of {world} "
              f"rows, ga {ga}): {ref[label]['step_ms']:.1f} ms per step, "
              f"peak {ref[label]['peak_mib']:.1f} MiB; losses "
              f"{ref[label]['losses']} [{cards}]")
    del eng, tree
    torch.cuda.empty_cache()
    ranks = cs._pipe_ranks(digest, world=world, backend="nccl",
                           script=_RANK, tag="MOE_RANK")
    rows = []
    timed = cs.MOE_STEPS - 1
    for res in ranks:
        d = res["data_index"]
        print(f"[moe] ep {world} data rank {d} (NCCL): "
              + cs._moe_check_layer(f"ep {world} rank {d}", res["layer"])
              + f" [{cards}]")
    for label in ARMS.split(","):
        want = cs.moe_exchange(1, ga, False, 4 if label == "fp32" else 2)
        for res in ranks:
            d = res["data_index"]
            r = res[label]
            for name, got in r["launches"].items():
                if got != L * ga * timed:
                    cs.fail(f"ep {world} {label} rank {d}: {name} launched "
                            f"{got} times in {timed} steps")
            q = r["ep"]
            if (q.get("calls"), q.get("bytes"), q.get("staged", 0)) != (
                    want["calls"], want["bytes"], 0):
                cs.fail(f"ep {world} {label} rank {d}: exchange {q}, "
                        f"{want} from the shapes")
            if r["losses"] != ranks[0][label]["losses"]:
                cs.fail(f"ep {world} {label}: the ranks' losses differ")
            rows.append({"ep": world, "rank": d, "arm": label,
                         "step_ms": r["step_ms"], "peak_mib": r["peak_mib"],
                         "exchange_calls": q["calls"],
                         "exchange_bytes": q["bytes"],
                         "exchange_host_ms": q.get("seconds", 0.0) * 1e3,
                         "profiled_ms": r["profiled_ms"],
                         "nccl_ms": r["nccl_ms"]})
            print(f"[moe] ep {world} {label} data rank {d} (NCCL, card {d}, "
                  f"experts {r['wi_piece'][1]} of {cs.MOE_EXPERTS}): "
                  f"{r['step_ms']:.1f} ms per step, peak "
                  f"{r['peak_mib']:.1f} MiB; exchange {q['calls']:.0f} "
                  f"calls, {q['bytes']:.0f} B sent per step (enqueue "
                  f"{q.get('seconds', 0.0) * 1e3:.1f} ms); profiled step "
                  f"{r['profiled_ms']:.1f} ms, NCCL kernels "
                  f"{r['nccl_ms']:.1f} ms of device time, waits included "
                  f"[{cards}]")
    got = ranks[0]["fp32"]["losses"]
    want = ref["fp32"]["losses"]
    worst = max(abs(a - b) / abs(b) for a, b in zip(got, want))
    print(f"[moe] ep {world} fp32 vs ep 1: {got} vs {want}; max rel diff "
          f"{worst:.3g} (bar {cs.MOE_LOSS_RTOL}) [{cards}]")
    if not worst <= cs.MOE_LOSS_RTOL:
        cs.fail(f"ep {world} fp32 losses {got} differ from ep 1's {want}")
    b2 = ranks[0]["bf16"]["losses"][0]
    b1 = ref["bf16"]["losses"][0]
    rel = abs(b2 - b1) / abs(b1)
    print(f"[moe] ep {world} first bf16 loss {b2:.6f} vs ep 1's {b1:.6f}: "
          f"rel diff {rel:.3g} (bar {cs.PIPE_BF16_RTOL})")
    if not rel <= cs.PIPE_BF16_RTOL:
        cs.fail(f"ep {world} first bf16 loss {b2} vs ep 1's {b1}")
    out = {"ok": True, "cards": cards,
           "ep1": {k: v["step_ms"] for k, v in ref.items()},
           f"ep{world}": rows}
    if world >= 4:
        out["ep2_sp2"] = _ep_seq(digest, ref, cards)
    print(json.dumps(out))


def _ep_seq(digest, ref, cards) -> list:
    """ep 2 × sp 2 over NCCL on cards 0–3 (:func:`moe_seq_rank`), held to
    the ep-1 engines ``ref``; returns its rows of the JSON line."""
    world, L = 4, 12
    sp = world // SEQ_DP
    ga = cs.PIPE_GA // (SEQ_DP * SEQ_MICRO)
    timed = cs.MOE_STEPS - 1
    ranks = cs._pipe_ranks(digest, world=world, backend="nccl",
                           script=_SEQ_RANK, tag="MOE_SEQ_RANK")
    rows = []
    for res in ranks:
        d, s = res["data_index"], res["seq_index"]
        print(f"[moe] ep {SEQ_DP} x sp {sp} data rank {d} seq rank {s} "
              f"(NCCL): " + cs._moe_check_layer(
                  f"ep {SEQ_DP} x sp {sp} rank {d}/{s}", res["layer"])
              + f" [{cards}]")
    for label in ARMS.split(","):
        elt = 4 if label == "fp32" else 2
        want_ep = cs.moe_exchange(SEQ_MICRO, ga, False, elt)
        want_seq = cs.moe_seq_collectives(SEQ_MICRO, ga, sp, elt)
        for res in ranks:
            d, s = res["data_index"], res["seq_index"]
            r = res[label]
            for name, got in r["launches"].items():
                if got != L * ga * timed:
                    cs.fail(f"ep {SEQ_DP} x sp {sp} {label} rank {d}/{s}: "
                            f"{name} launched {got} times in {timed} steps")
            for key, want in (("ep", want_ep), ("seq", want_seq)):
                q = r[key]
                if (q.get("calls"), q.get("bytes"), q.get("staged", 0)) != (
                        want["calls"], want["bytes"], 0):
                    cs.fail(f"ep {SEQ_DP} x sp {sp} {label} rank {d}/{s}: "
                            f"{key} {q}, {want} from the shapes")
            if r["losses"] != ranks[0][label]["losses"]:
                cs.fail(f"ep {SEQ_DP} x sp {sp} {label}: the ranks' losses "
                        f"differ")
            rows.append({"ep": SEQ_DP, "sp": sp, "data": d, "seq": s,
                         "arm": label, "step_ms": r["step_ms"],
                         "peak_mib": r["peak_mib"],
                         "exchange_bytes": r["ep"]["bytes"],
                         "seq_bytes": r["seq"]["bytes"],
                         "profiled_ms": r["profiled_ms"],
                         "nccl_ms": r["nccl_ms"]})
            print(f"[moe] ep {SEQ_DP} x sp {sp} {label} data rank {d} seq "
                  f"rank {s} (NCCL, card {res['rank']}, Ulysses): "
                  f"{r['step_ms']:.1f} ms per step, peak "
                  f"{r['peak_mib']:.1f} MiB; expert exchange "
                  f"{r['ep']['calls']:.0f} calls, {r['ep']['bytes']:.0f} B; "
                  f"seq collectives {r['seq']['calls']:.0f} calls, "
                  f"{r['seq']['bytes']:.0f} B sent per step; profiled step "
                  f"{r['profiled_ms']:.1f} ms, NCCL kernels "
                  f"{r['nccl_ms']:.1f} ms of device time, waits included "
                  f"[{cards}]")
    got = ranks[0]["fp32"]["losses"]
    want = ref["fp32"]["losses"]
    worst = max(abs(a - b) / abs(b) for a, b in zip(got, want))
    print(f"[moe] ep {SEQ_DP} x sp {sp} fp32 vs ep 1: {got} vs {want}; max "
          f"rel diff {worst:.3g} (bar {cs.MOE_LOSS_RTOL}) [{cards}]")
    if not worst <= cs.MOE_LOSS_RTOL:
        cs.fail(f"ep {SEQ_DP} x sp {sp} fp32 losses {got} differ from ep "
                f"1's {want}")
    b2 = ranks[0]["bf16"]["losses"][0]
    b1 = ref["bf16"]["losses"][0]
    rel = abs(b2 - b1) / abs(b1)
    print(f"[moe] ep {SEQ_DP} x sp {sp} first bf16 loss {b2:.6f} vs ep 1's "
          f"{b1:.6f}: rel diff {rel:.3g} (bar {cs.PIPE_BF16_RTOL})")
    if not rel <= cs.PIPE_BF16_RTOL:
        cs.fail(f"ep {SEQ_DP} x sp {sp} first bf16 loss {b2} vs ep 1's {b1}")
    return rows


if __name__ == "__main__":
    sys.exit(main())
