#!/usr/bin/env python3
"""1-bit Adam over the cards of one machine, over NCCL.

    python3 profile_onebit_torch.py

Needs at least two NVIDIA cards.  GPT-2 small at full width and depth
(chip_smoke.py's train_onebit weight tree: the init at the seed, remat
per block, dropout 0) on train_pipe's batch (8 rows of 1024 tokens), bf16,
ZeRO 0, clipping 1.0, at dp N = the card count (4 at most): one data rank
a process and a card, each feeding its 8/N rows as micro-batches of one.
Two arms from the same tree: 1-bit Adam with freeze step 2 for 6 steps
(2 warm, 4 frozen: the momentum crosses the cards as NCCL uint8
all-to-alls and all-gathers, with no host staging), then Adam for 3
steps.  Every rank's master must be bitwise equal to rank 0's after
every step, the frozen steps' uint8 bytes must be those worked out from
the leaves' ``padded_size``, and no float collective of a frozen step
may exceed 4·N elements.  It prints each rank's ms of every step and the
bytes each step's collectives carried, by dtype (the elements of each
collective's result times its dtype's size), beside the cards' names and
power limits, and ends with one JSON line.  Any failure exits non-zero.
"""
import json
import sys
import time

import chip_smoke as cs

STEPS, FREEZE, ADAM_STEPS = 6, 2, 3
_SIZE = {"float32": 4, "bfloat16": 2, "float16": 2, "uint8": 1,
         "int32": 4, "int64": 8}

_RANK = r"""
import sys
sys.path.insert(0, sys.argv[1])
import profile_onebit_torch
profile_onebit_torch.onebit_rank(int(sys.argv[2]), sys.argv[3],
                                 float(sys.argv[4]), int(sys.argv[5]),
                                 sys.argv[6])
"""


def _steps(eng, tokens, n, dev):
    """``n`` steps: each one's loss, ms (the card synchronized), bytes by
    dtype of the collectives it called, largest float collective, the
    compressed exchange's counters and the master's digest."""
    import torch
    from deepspeed_tpu_torch.parallel import collectives as col
    out = []
    for _ in range(n):
        col.onebit_stats.clear()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        with col.recorded() as log:
            loss = float(eng.train_batch(tokens))
        torch.cuda.synchronize(dev)
        ms = (time.perf_counter() - t0) * 1e3
        by_dtype = {}
        for _, dt, e in log:
            by_dtype[dt] = by_dtype.get(dt, 0) + e * _SIZE[dt]
        out.append({"loss": loss, "ms": ms, "bytes": by_dtype,
                    "max_float": max((e for _, dt, e in log
                                      if dt.startswith(("float", "bfloat"))),
                                     default=0),
                    "onebit": dict(col.onebit_stats),
                    "digest": cs._master_digest(eng)})
    return out


def onebit_rank(rank: int, init: str, digest: float, world: int,
                backend: str = "nccl") -> None:
    """Data rank ``rank`` on card ``rank``: both arms.  Prints one
    ``ONEBIT_RANK`` JSON line."""
    import datetime
    import torch
    import torch.distributed as dist
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.compress import padded_size
    from deepspeed_tpu_torch.models.gpt2 import GPT2Model
    from deepspeed_tpu_torch.parallel import build_mesh
    from deepspeed_tpu_torch.runtime.dataloader import rank_rows
    from deepspeed_tpu_torch.runtime.utils import tree_leaves
    dev = torch.device("cuda", rank)
    torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=240))
    out = {"rank": rank}
    try:
        tree, mine = cs._onebit_tree()
        if mine != digest:
            raise AssertionError(f"rank {rank}: weight tree digest {mine} "
                                 f"!= the parent's {digest}")
        mesh = build_mesh(dp=world)
        d = out["data_index"] = mesh.axis_index("data")
        ga = cs.PIPE_GA // world
        tokens = torch.from_numpy(rank_rows(cs._pipe_tokens(), ga, world,
                                            d)).to(dev)
        for label, opt, n in (
                ("onebit", {"type": "OneBitAdam",
                            "params": {"lr": 1e-4, "freeze_step": FREEZE}},
                 STEPS),
                ("adam", {"type": "Adam", "params": {"lr": 1e-4}},
                 ADAM_STEPS)):
            conf = cs._train_config({"bf16": {"enabled": True}}, 1, ga)
            conf["optimizer"] = opt
            eng = deepspeed_tpu_torch.initialize(
                model=GPT2Model(cs._onebit_model_cfg()), mesh=mesh,
                params=tree, seed=cs.SEED, config=conf, device=dev)[0]
            out[label] = _steps(eng, tokens, n, dev)
            if label == "onebit":
                out["uint8_want"] = sum(
                    padded_size(x.numel(), world) // 8
                    + padded_size(x.numel(), world) // (8 * world)
                    for x in tree_leaves(eng.state.master_params))
            eng.close()
        dist.barrier()
    finally:
        dist.destroy_process_group()
    print("ONEBIT_RANK " + json.dumps(out), flush=True)


def _fmt(steps, key="ms"):
    return " ".join(f"{s[key]:.1f}" for s in steps)


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        cs.fail("no CUDA device")
    cards_n = torch.cuda.device_count()
    if cards_n < 2:
        cs.fail(f"1-bit Adam over NCCL needs two cards or more, found "
                f"{cards_n}")
    world = min(cards_n, 4)
    cards = "; ".join(cs.smi().splitlines())
    print(f"[onebit] {cards_n} x {torch.cuda.get_device_name(0)}; "
          f"nvidia-smi: {cards}")
    cs.phase_build()
    _, digest = cs._onebit_tree()
    ranks = cs._pipe_ranks(digest, world=world, backend="nccl",
                           script=_RANK, tag="ONEBIT_RANK")
    rows = []
    for res in ranks:
        d = res["data_index"]
        for label in ("onebit", "adam"):
            for i, s in enumerate(res[label]):
                if s["digest"] != ranks[0][label][i]["digest"]:
                    cs.fail(f"dp {world} {label} rank {d}: step {i + 1}'s "
                            "master differs from rank 0's")
        ob = res["onebit"]
        frozen, warm, adam = ob[FREEZE:], ob[:FREEZE], res["adam"]
        for s in frozen:
            if s["onebit"].get("bytes_uint8") != res["uint8_want"] \
                    or s["max_float"] > 4 * world:
                cs.fail(f"dp {world} rank {d}: a frozen step moved "
                        f"{s['onebit']} (largest float collective "
                        f"{s['max_float']}); {res['uint8_want']} uint8 bytes "
                        "from padded_size")
        if not all(s["loss"] == s["loss"] for s in ob + adam):
            cs.fail(f"dp {world} rank {d}: a loss is not finite")
        f32 = adam[-1]["bytes"].get("float32", 0)
        u8 = frozen[-1]["bytes"].get("uint8", 0)
        rows.append({"dp": world, "rank": d,
                     "onebit_warm_ms": [s["ms"] for s in warm],
                     "onebit_frozen_ms": [s["ms"] for s in frozen],
                     "adam_ms": [s["ms"] for s in adam],
                     "frozen_bytes": frozen[-1]["bytes"],
                     "warm_bytes": warm[-1]["bytes"],
                     "adam_bytes": adam[-1]["bytes"],
                     "uint8_sent": frozen[-1]["onebit"]["bytes_uint8"]})
        print(f"[onebit] dp {world} data rank {d} (NCCL, card {d}): 1-bit "
              f"Adam losses {[s['loss'] for s in ob]}; step ms warm "
              f"{_fmt(warm)}, frozen {_fmt(frozen)}; Adam step ms "
              f"{_fmt(adam)}; bytes of a step's collectives (results): "
              f"frozen {frozen[-1]['bytes']} (uint8 sent "
              f"{frozen[-1]['onebit']['bytes_uint8']}, "
              f"{res['uint8_want']} from padded_size), warm "
              f"{warm[-1]['bytes']}, Adam {adam[-1]['bytes']}: frozen uint8 "
              f"/ Adam fp32 = {u8 / f32:.4f} [{cards}]")
    print(f"[onebit] every rank's master bitwise equal to rank 0's after "
          f"every step of both arms [{cards}]")
    print(json.dumps({"onebit": rows, "cards": cards}))


if __name__ == "__main__":
    sys.exit(main())
