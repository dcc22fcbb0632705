#!/usr/bin/env python3
"""Where a training step of the PyTorch port spends its time, on one
NVIDIA card.

    python3 profile_train_torch.py [--model gpt2-small|bert-large] [--steps N]

``gpt2-small`` (the default) trains full-size GPT-2 small with the train
phase of chip_smoke.py (``deepspeed_tpu_torch.initialize``, bf16, dropout
0.1, ``remat="block"``, micro-batch 8 x 1024 tokens, gradient
accumulation 2, Adam, clipping 1.0, random weights from seed 0).
``bert-large`` trains BERT-large with its bert_train phase (bf16, dropout
0.1, ``remat="block"``, LAMB lr 1e-3, micro-batch 8 x 512 MLM + NSP
tokens with a quarter of the rows right-padded).  After 2 warm-up steps
it times N steps on the host clock (ending in
``torch.cuda.synchronize()``), then traces N more with ``torch.profiler``
and prints: wall per step, device busy time per step by kernel name (top
15) and by group (the three flash kernels, matrix products, the rest),
and the device's idle share.
"""
import argparse
import dataclasses
import json
import subprocess
import sys
import time

import numpy as np

#: kernel-name fragments of each group (the flash kernels by their
#: entry points: the fp32 FMA kernels and the bf16/fp16 tensor-core ones;
#: cuBLAS/CUTLASS products by their name families)
GROUPS = (("flash_fwd", ("flash_fwd_kernel", "flash_fwd_sm90")),
          ("flash_bwd_dq", ("flash_bwd_dq_kernel", "flash_bwd_dq_sm90")),
          ("flash_bwd_dkv", ("flash_bwd_dkv_kernel", "flash_bwd_dkv_sm90")),
          ("matmul", ("gemm", "xmma", "cutlass", "nvjet")))


def _gpt2_small():
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.gpt2 import GPT2_SMALL, GPT2Model
    cfg = dataclasses.replace(GPT2_SMALL, dropout=0.1, embd_dropout=0.1,
                              remat="block")
    eng, _, _, _ = deepspeed_tpu_torch.initialize(
        model=GPT2Model(cfg), seed=0,
        config={"train_micro_batch_size_per_gpu": 8,
                "gradient_accumulation_steps": 2,
                "steps_per_print": 10 ** 9, "gradient_clipping": 1.0,
                "bf16": {"enabled": True},
                "optimizer": {"type": "Adam", "params": {"lr": 1e-4}}})
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (16, cfg.n_positions + 1))).to(eng.device)
    return eng, tokens, "GPT-2 small, 16 x 1024 tokens"


def _bert_large():
    import torch
    import deepspeed_tpu_torch
    from chip_smoke import (BERT_MICRO, BERT_SEQ, lamb_config, mlm_batch)
    from deepspeed_tpu_torch.models.bert import BERT_LARGE, BertModel
    cfg = dataclasses.replace(BERT_LARGE, remat="block")
    eng, _, _, _ = deepspeed_tpu_torch.initialize(
        model=BertModel(cfg), seed=0,
        config=lamb_config({"bf16": {"enabled": True}}, BERT_MICRO))
    batch = {k: torch.from_numpy(v).to(eng.device) for k, v in mlm_batch(
        BERT_MICRO, BERT_SEQ, cfg.vocab_size, 0).items()}
    return eng, batch, f"BERT-large, {BERT_MICRO} x {BERT_SEQ} tokens"


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--model", choices=("gpt2-small", "bert-large"),
                    default="gpt2-small")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("profile_train_torch: needs a CUDA device")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    eng, batch, label = (_bert_large() if args.model == "bert-large"
                          else _gpt2_small())
    for _ in range(2):
        eng.train_batch(batch)
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    for _ in range(args.steps):
        eng.train_batch(batch)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / args.steps * 1e3

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            eng.train_batch(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / args.steps * 1e3

    rows = []  # device-side events only: kernels and copies
    for ev in prof.key_averages():
        dt = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0))
        if ev.device_type == DeviceType.CUDA and dt > 0:
            rows.append((dt / args.steps / 1e3, ev.count // args.steps,
                         ev.key))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    groups = {name: 0.0 for name, _ in GROUPS}
    groups["other"] = 0.0
    for ms, _, key in rows:
        name = next((n for n, frags in GROUPS
                     if any(f in key for f in frags)), "other")
        groups[name] += ms
    print(f"train step ({label}): {step_ms:.3f} ms wall "
          f"(unprofiled), {wall_ms:.3f} ms under the profiler")
    # the profiler slows the host, not the device: the idle share of an
    # unprofiled step is the busy time over the unprofiled wall
    print(f"device busy {busy_ms:.3f} ms per step -> idle share "
          f"{1 - busy_ms / step_ms:.3f} of an unprofiled step "
          f"({1 - busy_ms / wall_ms:.3f} under the profiler); "
          f"{sum(r[1] for r in rows)} device ops per step")
    for name, ms in groups.items():
        print(f"  group {name:14s} {ms:9.3f} ms  ({ms / busy_ms:.3f} of busy)")
    for ms, n, key in rows[:15]:
        print(f"  {ms:9.4f} ms  x{n:<5d} {key[:90]}")
    print(json.dumps({"step_ms": step_ms, "profiled_step_ms": wall_ms,
                      "device_busy_ms": busy_ms,
                      "idle_share": 1 - busy_ms / step_ms,
                      "groups_ms": groups}))
    eng.close()


if __name__ == "__main__":
    main()
