#!/usr/bin/env python3
"""Where a serving tick of the PyTorch port's ServeEngine spends its time,
on one NVIDIA card.

    python3 profile_serve_torch.py [--ticks N] [--paged [--quant] [--lora]]
                                   [--spec]

Serves full-size GPT-2 small in bf16 (random weights from seed 0, the
serving config and load of chip_smoke.py: 8 slots, max_seq_len 1024,
prefill bucket 512, 12 prompts of 16-512 tokens).  ``--paged`` serves from
the paged pool (page_len 16) instead of the slot cache, ``--quant`` (with
``--paged``) with int8 weights and the int8 pool (``quantization:
{"weights": "int8", "kv": "int8"}``, the serve_quant phase), ``--lora``
(with ``--paged``) with multi-tenant LoRA adapters (rank 16, alpha 32, all
four targets, 4 pool slots; the 8 requests on tenants 0-4, as
chip_smoke.py's serve_lora phase) and then also prints the device and
host time of the LoRA products (``_lora_delta``) and gathers
(``_lora_rows``) per tick, each under a ``torch.profiler.record_function``
range; ``--spec`` makes
every tick a speculative block (k = 4, a 2-layer draft cut from the
target, as chip_smoke.py's serve_spec phase), so a "tick" is one draft
propose plus one verify pass.  Once all 8 slots decode, it times N ticks
on the host clock (each ends in the token read-back, which synchronises),
then traces N more with ``torch.profiler`` and prints: wall per tick,
tokens per tick, device busy time per tick by kernel name (top 12), the
host ops with the most host time of their own per tick (top 8, under the
profiler), the decode attention kernels' time per tick, the device's
idle share and the
time of one 512-token prefill.  The trace goes to ``chiprun_out/serve_trace.json``.
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
    ap.add_argument("--paged", action="store_true",
                    help="serve from the paged pool (page_len 16)")
    ap.add_argument("--quant", action="store_true",
                    help="int8 weights and the int8 pool (needs --paged)")
    ap.add_argument("--lora", action="store_true",
                    help="LoRA adapters on 5 tenants (needs --paged)")
    ap.add_argument("--spec", action="store_true",
                    help="speculative ticks (k 4, 2-layer draft)")
    args = ap.parse_args()
    if args.quant and not args.paged:
        ap.error("--quant needs --paged: the int8 pool is paged only")
    if args.lora and not args.paged:
        ap.error("--lora needs --paged: LoRA serving is paged only")
    import torch
    if not torch.cuda.is_available():
        sys.exit("profile_serve_torch: needs a CUDA device")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from deepspeed_tpu_torch.inference import ServeEngine
    from deepspeed_tpu_torch.models import gpt2
    from deepspeed_tpu_torch.models.gpt2 import GPT2_SMALL, GPT2Model

    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    model = GPT2Model(GPT2_SMALL)
    params = model.init(0, device=dev, dtype=torch.bfloat16)
    serving = {"slots": 8, "max_seq_len": 1024, "prefill_len": 512}
    if args.paged:
        serving["page_len"] = 16
    if args.quant:
        serving["quantization"] = {"weights": "int8", "kv": "int8"}
    tenants = [0] * 8
    if args.lora:
        serving["lora"] = {"rank": 16, "alpha": 32.0, "hbm_adapter_slots": 4,
                           "max_adapters": 8,
                           "targets": ["qkv_w", "out_w", "fc_w", "proj_w"]}
        tenants = [0, 1, 2, 3, 4, 1, 2, 3]
        for name in ("_lora_delta", "_lora_rows"):
            real = getattr(gpt2, name)

            def ranged(*a, _real=real, _name=name, **k):
                with torch.profiler.record_function(_name):
                    return _real(*a, **k)
            setattr(gpt2, name, ranged)
    draft = None
    if args.spec:
        serving.update(speculate_k=4, draft={"d_model": 768, "n_layer": 2,
                                             "n_head": 12})
        draft = {k: v for k, v in params.items() if k != "blocks"}
        draft["blocks"] = {k: v[:2] for k, v in params["blocks"].items()}

    def engine():
        return ServeEngine(model, {"serving": serving}, params=params,
                           device=dev, draft_params=draft)

    eng = engine()
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(0, GPT2_SMALL.vocab_size, n)]
               for n in rng.integers(16, 513, 12)]
    per_tick = 5 if args.spec else 1
    budget = per_tick * (2 * args.ticks + 8)
    reqs = [eng.submit(p, max_new_tokens=budget, adapter_id=t)
            for p, t in zip(prompts[:8], tenants)]
    eng.step()  # admits (prefills) all 8, then the first tick
    eng.step()
    torch.cuda.synchronize()

    def produced():
        return sum(len(r.tokens) for r in reqs)

    t0, n0 = time.perf_counter(), produced()
    for _ in range(args.ticks):
        eng.step()
    tick_ms = (time.perf_counter() - t0) / args.ticks * 1e3
    tokens_per_tick = (produced() - n0) / args.ticks

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.ticks):
            eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / args.ticks * 1e3
    if any(r.finish_reason for r in reqs):
        sys.exit("profile_serve_torch: a request finished inside the "
                 "measured window; raise the budget")
    os.makedirs("chiprun_out", exist_ok=True)
    prof.export_chrome_trace("chiprun_out/serve_trace.json")

    rows = []  # device-side events only: kernels and copies
    ranges = ("_lora_delta", "_lora_rows")  # --lora's annotations
    for ev in prof.key_averages():
        dt = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0))
        if ev.device_type == DeviceType.CUDA and dt > 0 \
                and ev.key not in ranges:
            rows.append((dt / args.ticks / 1e3, ev.count // args.ticks,
                         ev.key))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    kind = ("speculative block (draft propose + verify)" if args.spec
            else "decode tick")
    cache = ("int8 paged pool, int8 weights" if args.quant else
             "paged pool" if args.paged else "slot cache")
    if args.lora:
        cache += ", LoRA rank 16 on 5 tenants"
    print(f"{kind}, {cache}, 8 active slots: {tick_ms:.3f} ms wall "
          f"(unprofiled), {wall_ms:.3f} ms wall under the profiler; "
          f"{tokens_per_tick:.3f} tokens per tick")
    # the profiler slows the host, not the device: the idle share of an
    # unprofiled tick is the busy time over the unprofiled wall
    print(f"device busy {busy_ms:.3f} ms per tick -> idle share "
          f"{1 - busy_ms / tick_ms:.3f} of an unprofiled tick "
          f"({1 - busy_ms / wall_ms:.3f} under the profiler); "
          f"{sum(r[1] for r in rows)} device ops per tick")
    for ms, n, key in rows[:12]:
        print(f"  {ms:9.4f} ms  x{n:<4d} {key[:90]}")
    # the decode attention kernels: the instantiations of decode_split.cuh's
    # key-split cluster kernel (the bf16/fp16 arms of the single-query,
    # paged, multi and paged multi kernels, int8 pools included) and of
    # decode_common.cuh's rows_kernel (their fp32 arms); decode_kernel is
    # the single-query kernel of trees before the split kernel took it
    attn = [r for r in rows if any(
        name in r[2] for name in ("rows_kernel", "decode_kernel",
                                  "decode_split_kernel"))]
    attn_ms = sum(r[0] for r in attn)
    print(f"decode attention kernels: {attn_ms:.4f} ms per tick over "
          f"{sum(r[1] for r in attn)} launches")
    # the host side: the ops that took the most host time of their own
    # per tick (under the profiler, which inflates every op alike)
    host = sorted(((ev.self_cpu_time_total / args.ticks / 1e3,
                    ev.count // args.ticks, ev.key)
                   for ev in prof.key_averages()
                   if ev.device_type == DeviceType.CPU), reverse=True)
    print("host ms per tick by op (self time, under the profiler):")
    for ms, n, key in host[:8]:
        print(f"  {ms:9.4f} ms  x{n:<4d} {key[:90]}")
    lora_ms, lora_host_ms = {}, {}
    if args.lora:
        # the device time of the kernels each range launched (a CPU-side
        # event's device total) and the host time spent inside it
        for ev in prof.key_averages():
            if ev.key in ranges and ev.device_type == DeviceType.CPU:
                lora_ms[ev.key] = getattr(
                    ev, "device_time_total",
                    getattr(ev, "cuda_time_total", 0)) / args.ticks / 1e3
                lora_host_ms[ev.key] = ev.cpu_time_total / args.ticks / 1e3
        print(f"LoRA products (_lora_delta): "
              f"{lora_ms.get('_lora_delta', 0.0):.4f} ms per tick on the "
              f"device, {lora_host_ms.get('_lora_delta', 0.0):.4f} ms on "
              f"the host (under the profiler); gathers (_lora_rows): "
              f"{lora_ms.get('_lora_rows', 0.0):.4f} / "
              f"{lora_host_ms.get('_lora_rows', 0.0):.4f} ms")

    # one 512-token prefill into a free slot (host clock, synchronised)
    eng.close()
    eng = engine()
    tokens = np.zeros((1, 512), np.int64)
    if args.paged:
        row = np.zeros((eng.max_pages,), np.int32)
        row[:32] = np.arange(1, 33)

        def prefill():
            eng._prefill_paged(tokens, 512, 0, row, 0, int(args.lora))
    else:
        dev_tokens = torch.from_numpy(tokens).to(dev)

        def prefill():
            eng._prefill(dev_tokens, 512, 0)
    for _ in range(3):
        prefill()
    t0 = time.perf_counter()
    for _ in range(args.ticks):
        prefill()
    prefill_ms = (time.perf_counter() - t0) / args.ticks * 1e3
    eng.close()
    print(f"one 512-token prefill (12 layers + logits + read-back): "
          f"{prefill_ms:.3f} ms")
    print(json.dumps({"paged": args.paged, "quant": args.quant,
                      "lora": args.lora, "lora_ms": lora_ms,
                      "lora_host_ms": lora_host_ms,
                      "spec": args.spec, "attention_kernel_ms": attn_ms,
                      "tick_ms": tick_ms, "profiled_tick_ms": wall_ms,
                      "tokens_per_tick": tokens_per_tick,
                      "device_busy_ms": busy_ms,
                      "idle_share": 1 - busy_ms / tick_ms,
                      "prefill_ms": prefill_ms}))


if __name__ == "__main__":
    main()
