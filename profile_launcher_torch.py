#!/usr/bin/env python3
"""The launcher and the elastic agent over the cards of one machine, on
NCCL.

    python3 profile_launcher_torch.py

Needs four NVIDIA cards.  ``bin/ds_torch --hostfile <localhost slots=4>
--launcher local --elastic --max-restarts 1`` with a ``--probe-cmd``
that reports the host at 2 slots runs chip_smoke.py's launched worker
(``chip_smoke.launcher_worker``: phase train's GPT-2 small bf16 engine,
dropout 0.1, remat block, 16 x 1024 tokens a step in micro-batches of 2,
4 steps with a checkpoint each): attempt 0 at dp 4 (accumulation 2)
exits after step 2, the supervisor re-probes, and attempt 1 resumes at
dp 2 (accumulation 4) from the dp-4 checkpoint on the first two of
attempt 0's cards.  Then the same worker uninterrupted at dp 4.  Checks:
every rank's RANK, LOCAL_RANK, WORLD_SIZE and CUDA_VISIBLE_DEVICES, its
physical card (the CUDA UUID against ``nvidia-smi``'s) equal to the card
its slot names (under an inherited CUDA_VISIBLE_DEVICES the first of its
cards, else 0 to 3), NCCL with the attempt's
world, the flash kernels' launches a step; attempt 0's losses bitwise the
uninterrupted run's, attempt 1's (dp 2) within 1e-2 relative of its (dp
4, bf16).  It prints each attempt's step ms and the time from attempt
0's exit to attempt 1's first step done, beside the cards' names and
power limits, and ends with one JSON line.  Any failure exits non-zero.
"""
import json
import os
import shutil
import subprocess
import sys
import tempfile

import chip_smoke as cs

MICRO, SLOTS, SHRUNK, STEPS = 2, 4, 2, 4


def _cards() -> dict:
    """nvidia-smi's card index by UUID (lower case, no ``GPU-``)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=index,uuid",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout
    idx = {}
    for line in out.splitlines():
        i, uuid = (x.strip() for x in line.split(","))
        idx[uuid.lower().removeprefix("gpu-")] = int(i)
    return idx


def _check(res, attempt, slots, cards, card_of, label):
    """The attempt's ranks: env contract, group, physical card (the
    first ``slots`` of :func:`chip_smoke.launch_cards`: a shrink keeps
    the first cards), launches (``2·L·A``, ``L·A``, ``L·A`` a step)."""
    from deepspeed_tpu_torch.models.gpt2 import GPT2_SMALL
    ranks = sorted(r for a, r in res if a == attempt)
    if ranks != list(range(slots)):
        cs.fail(f"attempt {attempt}: ranks {ranks}, expected {slots}")
    phys_of = cs.launch_cards(slots)
    visible = ",".join(str(i) for i in phys_of)
    for rank in ranks:
        r = res[(attempt, rank)]
        env = r["env"]
        seen = (env["RANK"], env["LOCAL_RANK"], env["WORLD_SIZE"],
                env["CUDA_VISIBLE_DEVICES"])
        if seen != (str(rank), str(rank), str(slots), visible):
            cs.fail(f"attempt {attempt} rank {rank}: env {env}")
        phys = card_of.get(r["uuid"].lower().removeprefix("gpu-"))
        if (r["backend"], r["world"], r["dp"], phys) != (
                "nccl", slots, slots, phys_of[rank]):
            cs.fail(f"attempt {attempt} rank {rank}: {r['backend']} group "
                    f"of {r['world']}, dp {r['dp']}, physical card {phys}")
        L, A = GPT2_SMALL.n_layer, r["ga"]
        n = len(r["losses"])
        for name, per in (("flash_fwd", 2 * L * A), ("flash_bwd_dq", L * A),
                          ("flash_bwd_dkv", L * A)):
            if r["launches"][name] != per * n:
                cs.fail(f"attempt {attempt} rank {rank}: {name} launched "
                        f"{r['launches'][name]} times in {n} steps")
        if r["losses"] != res[(attempt, 0)]["losses"]:
            cs.fail(f"attempt {attempt}: the ranks' losses differ")
        print(f"[launcher] {label} rank {rank}: RANK {rank} "
              f"LOCAL_RANK {rank} WORLD_SIZE {slots} CUDA_VISIBLE_DEVICES "
              f"{visible}, physical card {phys} (UUID {r['uuid']}), NCCL "
              f"dp {r['dp']} accumulation {A}; steps "
              f"{sorted(r['losses'])} [{cards}]")


def _step_ms(r) -> list:
    t = r["step_end"]
    return [round((b - a) * 1e3, 1) for a, b in zip(t, t[1:])]


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        cs.fail("no CUDA device")
    n = torch.cuda.device_count()
    if n < SLOTS:
        cs.fail(f"the elastic shrink over NCCL needs {SLOTS} cards, "
                f"found {n}")
    cards = "; ".join(cs.smi().splitlines())
    print(f"[launcher] {n} x {torch.cuda.get_device_name(0)}; nvidia-smi: "
          f"{cards}")
    cs.phase_build()
    card_of = _cards()
    root = tempfile.mkdtemp(prefix="profile_launcher_")
    try:
        probe = os.path.join(root, "probe.sh")
        with open(probe, "w") as f:
            f.write(f"#!/bin/sh\necho slots={SHRUNK}\n")
        os.chmod(probe, 0o755)
        os.makedirs(os.path.join(root, "elastic"))
        wall, log, _, res = cs.launch_elastic(
            os.path.join(root, "elastic"), SLOTS, MICRO,
            probe_cmd=f"{probe} {{host}}", steps=STEPS)
        os.makedirs(os.path.join(root, "ref"))
        ref_wall, _, _, ref = cs.launch_elastic(
            os.path.join(root, "ref"), SLOTS, MICRO, crash_at=0, steps=STEPS)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if "resized 4 -> 2 slot(s)" not in log:
        cs.fail(f"the supervisor did not shrink the world:\n{log[-3000:]}")
    _check(res, 0, SLOTS, cards, card_of, "attempt 0")
    _check(res, 1, SHRUNK, cards, card_of, "attempt 1")
    _check(ref, 0, SLOTS, cards, card_of, "uninterrupted")
    a0, a1, r0 = res[(0, 0)], res[(1, 0)], ref[(0, 0)]
    if a1["start_step"] != cs.LAUNCH_CRASH_AT:
        cs.fail(f"attempt 1 resumed at step {a1['start_step']}")
    want = r0["losses"]
    for s, loss in a0["losses"].items():
        if loss != want[s]:
            cs.fail(f"dp 4 step {s}: {loss} != the uninterrupted {want[s]}")
    worst = max(abs(loss - want[s]) / abs(want[s])
                for s, loss in a1["losses"].items())
    if not worst <= cs.PIPE_BF16_RTOL:
        cs.fail(f"dp 2 resumed losses {a1['losses']} vs dp 4's {want}")
    relaunch = a1["t_start"] - a0["t_exit"]
    ready = a1["t_ready"] - a1["t_start"]
    first = a1["step_end"][0] - a1["t_ready"]
    recover = relaunch + ready + first
    print(f"[launcher] losses by step: dp 4 then dp 2 "
          f"{[a0['losses'][s] for s in sorted(a0['losses'])]} + "
          f"{[a1['losses'][s] for s in sorted(a1['losses'])]}; "
          f"uninterrupted dp 4 {[want[s] for s in sorted(want)]}; dp 4 "
          f"steps bitwise, dp 2 within {worst:.3g} (bar "
          f"{cs.PIPE_BF16_RTOL}) [{cards}]")
    print(f"[launcher] step ms with its checkpoint: attempt 0 (dp 4) "
          f"{_step_ms(a0)}, attempt 1 (dp 2) {_step_ms(a1)}, uninterrupted "
          f"dp 4 {_step_ms(r0)}; time to recover {recover:.1f} s = "
          f"attempt 0's exit to attempt 1's workers running "
          f"{relaunch:.1f} s + to engine ready {ready:.1f} s (attempt "
          f"0's {a0['t_ready'] - a0['t_start']:.1f} s without a load) + "
          f"the first step {first:.1f} s; elastic run {wall:.1f} s, "
          f"uninterrupted {ref_wall:.1f} s [{cards}]")
    print(json.dumps({"ok": True, "cards": cards, "recover_s": recover,
                      "relaunch_s": relaunch, "ready_s": ready,
                      "first_step_s": first,
                      "step_ms": {"dp4": _step_ms(a0), "dp2": _step_ms(a1),
                                  "dp4_ref": _step_ms(r0)},
                      "wall_s": {"elastic": wall, "ref": ref_wall}}))


if __name__ == "__main__":
    sys.exit(main())
