#!/usr/bin/env python3
"""Where a decode tick of the PyTorch port's ServeEngine spends its time,
on one NVIDIA card.

    python3 profile_serve_torch.py [--ticks N]

Serves full-size GPT-2 small in bf16 (random weights from seed 0, the
serving config and load of chip_smoke.py: 8 slots, max_seq_len 1024,
prefill bucket 512, 12 prompts of 16-512 tokens).  Once all 8 slots
decode, it times N decode-only ticks on the host clock (each ends in the
token read-back, which synchronises), then traces N more with
``torch.profiler`` and prints: wall per tick, device busy time per tick
by kernel name (top 12), the device's idle share, and the time of one
512-token prefill.  The trace goes to ``chiprun_out/serve_trace.json``.
"""
import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ticks", type=int, default=20)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("profile_serve_torch: needs a CUDA device")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from deepspeed_tpu_torch.inference import ServeEngine
    from deepspeed_tpu_torch.models.gpt2 import GPT2_SMALL, GPT2Model

    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    model = GPT2Model(GPT2_SMALL)
    params = model.init(0, device=dev, dtype=torch.bfloat16)
    eng = ServeEngine(model, {"serving": {"slots": 8, "max_seq_len": 1024,
                                          "prefill_len": 512}},
                      params=params, device=dev)
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(0, GPT2_SMALL.vocab_size, n)]
               for n in rng.integers(16, 513, 12)]
    budget = 2 * args.ticks + 8
    for p in prompts[:8]:
        eng.submit(p, max_new_tokens=budget)
    eng.step()  # admits (prefills) all 8, then the first decode tick
    eng.step()
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    for _ in range(args.ticks):
        eng.step()
    tick_ms = (time.perf_counter() - t0) / args.ticks * 1e3

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.ticks):
            eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / args.ticks * 1e3
    os.makedirs("chiprun_out", exist_ok=True)
    prof.export_chrome_trace("chiprun_out/serve_trace.json")

    rows = []  # device-side events only: kernels and copies
    for ev in prof.key_averages():
        dt = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0))
        if ev.device_type == DeviceType.CUDA and dt > 0:
            rows.append((dt / args.ticks / 1e3, ev.count // args.ticks,
                         ev.key))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    print(f"decode tick, 8 active slots: {tick_ms:.3f} ms wall "
          f"(unprofiled), {wall_ms:.3f} ms wall under the profiler")
    # the profiler slows the host, not the device: the idle share of an
    # unprofiled tick is the busy time over the unprofiled wall
    print(f"device busy {busy_ms:.3f} ms per tick -> idle share "
          f"{1 - busy_ms / tick_ms:.3f} of an unprofiled tick "
          f"({1 - busy_ms / wall_ms:.3f} under the profiler); "
          f"{sum(r[1] for r in rows)} device ops per tick")
    for ms, n, key in rows[:12]:
        print(f"  {ms:9.4f} ms  x{n:<4d} {key[:90]}")

    # one 512-token prefill into a free slot (host clock, synchronised)
    eng.close()
    eng = ServeEngine(model, {"serving": {"slots": 8, "max_seq_len": 1024,
                                          "prefill_len": 512}},
                      params=params, device=dev)
    tokens = torch.zeros((1, 512), dtype=torch.long, device=dev)
    for _ in range(3):
        eng._prefill(tokens, 512, 0)
    t0 = time.perf_counter()
    for _ in range(args.ticks):
        eng._prefill(tokens, 512, 0)
    prefill_ms = (time.perf_counter() - t0) / args.ticks * 1e3
    eng.close()
    print(f"one 512-token prefill (12 layers + logits + read-back): "
          f"{prefill_ms:.3f} ms")
    print(json.dumps({"tick_ms": tick_ms, "profiled_tick_ms": wall_ms,
                      "device_busy_ms": busy_ms,
                      "idle_share": 1 - busy_ms / tick_ms,
                      "prefill_ms": prefill_ms}))


if __name__ == "__main__":
    main()
