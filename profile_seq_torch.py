#!/usr/bin/env python3
"""GPT-2 small with sequence parallelism over the cards of one machine,
over NCCL.

    python3 profile_seq_torch.py

Needs at least two NVIDIA cards.  From chip_smoke.py's train_seq weight
tree and batch (GPT-2 small at full width and depth, 8 micro-batches of
1 x 1024 tokens, dropout 0.1, Adam, clipping 1.0, no remat; 1 + 3 steps)
it trains, at sp 2 and, with four cards or more, at sp 4 — one seq rank
a process and a card, ``torch.distributed`` over NCCL, the all-to-alls
and ring rotations on the card with no host staging — Ulysses at fp32
and bf16 and ring attention at fp32 (chip_smoke.py's ``SEQ_ARMS``),
against the same model at sp 1 on card 0 with no process group.  The
fp32 losses must match sp 1's within 1e-5 relative and Ulysses' first
bf16 loss within 1e-2; every rank's Ulysses flash launches a step must
be L·M.  One more step of each arm runs under ``torch.profiler`` (CUDA
activity) and the NCCL kernels' device time is summed over it.  An NCCL
kernel spins from its launch until its peers arrive, so that sum holds
the ranks' skew as well as the transfers (it can pass the step's wall,
the kernels overlapping compute): it bounds the collectives' time from
above and is no share of the step.  It prints each rank's step ms, peak
MiB, the seq collectives' calls and bytes a step and that sum, beside
the cards' names and power limits, and ends with one JSON line.  Any
failure exits non-zero.
"""
import datetime
import json
import sys

import chip_smoke as cs

_RANK = r"""
import sys
sys.path.insert(0, sys.argv[1])
import profile_seq_torch
profile_seq_torch.seq_rank(int(sys.argv[2]), sys.argv[3], float(sys.argv[4]),
                           int(sys.argv[5]), sys.argv[6])
"""


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


def seq_rank(rank: int, init: str, digest: float, world: int,
             backend: str = "nccl") -> None:
    """One seq rank on card ``rank``: every arm of ``cs.SEQ_ARMS``, its
    1 + 3 steps (``cs._seq_steps``) and one profiled step.  Prints one
    ``SEQ_RANK`` JSON line."""
    import torch
    import torch.distributed as dist
    from deepspeed_tpu_torch.parallel import build_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", rank)
    torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=240))
    out = {"rank": rank}
    try:
        tree, mine = cs._seq_tree()
        if mine != digest:
            raise AssertionError(f"rank {rank}: weight tree digest {mine} "
                                 f"!= sp 1's {digest}")
        mesh = build_mesh(sp=world)
        out["seq_index"] = mesh.axis_index("seq")
        tokens = torch.from_numpy(cs._pipe_tokens()).to(dev)
        for label, impl, block in cs.SEQ_ARMS:
            eng = cs._seq_engine(impl, block, dev, mesh, tree)
            out[label] = r = cs._seq_steps(eng, tokens, cs.SEQ_STEPS, dev)
            r["profiled_ms"], r["nccl_ms"] = _profiled_step(eng, tokens)
            eng.close()
        dist.barrier()
    finally:
        dist.destroy_process_group()
    print("SEQ_RANK " + json.dumps(out), flush=True)


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        cs.fail("no CUDA device")
    cards_n = torch.cuda.device_count()
    if cards_n < 2:
        cs.fail(f"sequence parallelism over NCCL needs two cards or more, "
                f"found {cards_n}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cards = "; ".join(cs.smi().splitlines())
    print(f"[seq] {cards_n} x {torch.cuda.get_device_name(0)}; "
          f"nvidia-smi: {cards}")
    cs.phase_build()
    dev = torch.device("cuda", 0)
    tree, digest = cs._seq_tree()
    tokens = torch.from_numpy(cs._pipe_tokens()).to(dev)
    ref = {}
    for label, impl, block in cs.SEQ_ARMS[:2]:
        eng = cs._seq_engine(impl, block, dev, params=tree)
        ref[label] = cs._seq_steps(eng, tokens, cs.SEQ_STEPS, dev)
        eng.close()
        print(f"[seq] sp 1 {label} on card 0 (the dense attention, the same "
              f"hashed mask): {ref[label]['step_ms']:.1f} ms per step; "
              f"losses {ref[label]['losses']} [{cards}]")
    del eng
    torch.cuda.empty_cache()
    L, M = 12, cs.PIPE_GA
    summary = {"ok": True, "cards": cards,
               "sp1": {k: v["step_ms"] for k, v in ref.items()}}
    for sp in (2, 4):
        if sp > cards_n:
            continue
        ranks = cs._pipe_ranks(digest, world=sp, backend="nccl",
                               script=_RANK, tag="SEQ_RANK")
        rows = []
        for res in ranks:
            s = res["seq_index"]
            for label, impl, _ in cs.SEQ_ARMS:
                r = res[label]
                per = L * M if impl == "ulysses" else 0
                for name, got in r["launches"].items():
                    if got != per * (cs.SEQ_STEPS - 1):
                        cs.fail(f"sp {sp} {label} rank {s}: {name} "
                                f"launched {got} times")
                if r["losses"] != ranks[0][label]["losses"]:
                    cs.fail(f"sp {sp} {label}: the ranks' losses differ")
                q = r["seq"]
                rows.append({"sp": sp, "rank": s, "arm": label,
                             "step_ms": r["step_ms"],
                             "profiled_ms": r["profiled_ms"],
                             "nccl_ms": r["nccl_ms"]})
                print(f"[seq] sp {sp} {label} seq rank {s} (NCCL, card "
                      f"{s}): {r['step_ms']:.1f} ms per step, peak "
                      f"{r['peak_mib']:.1f} MiB; seq collectives "
                      f"{q.get('calls', 0):.0f} calls, "
                      f"{q.get('bytes', 0):.0f} B sent per step; profiled "
                      f"step {r['profiled_ms']:.1f} ms, NCCL kernels "
                      f"{r['nccl_ms']:.1f} ms of device time, waits "
                      f"included [{cards}]")
        for impl in ("ulysses", "ring"):
            got = ranks[0][f"{impl} fp32"]["losses"]
            want = ref["ulysses fp32"]["losses"]
            worst = max(abs(a - b) / abs(b) for a, b in zip(got, want))
            print(f"[seq] sp {sp} {impl} fp32 vs sp 1: {got} vs {want}; "
                  f"max rel diff {worst:.3g} (bar {cs.PIPE_FP32_RTOL}) "
                  f"[{cards}]")
            if not worst <= cs.PIPE_FP32_RTOL:
                cs.fail(f"sp {sp} {impl} fp32 losses {got} differ from "
                        f"sp 1's {want}")
        b2 = ranks[0]["ulysses bf16"]["losses"][0]
        b1 = ref["ulysses bf16"]["losses"][0]
        rel = abs(b2 - b1) / abs(b1)
        print(f"[seq] sp {sp} Ulysses first bf16 loss {b2:.6f} vs sp 1's "
              f"{b1:.6f}: rel diff {rel:.3g} (bar {cs.PIPE_BF16_RTOL})")
        if not rel <= cs.PIPE_BF16_RTOL:
            cs.fail(f"sp {sp} first bf16 loss {b2} vs sp 1's {b1}")
        summary[f"sp{sp}"] = rows
    print(json.dumps(summary))


if __name__ == "__main__":
    sys.exit(main())
