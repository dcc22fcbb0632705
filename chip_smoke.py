#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``deepspeed_tpu_torch``).

Run from the root of a checkout, on a machine with one NVIDIA card:

    python3 chip_smoke.py

Phases, all on ``cuda:0``; any failure exits non-zero:

1. build    both kernels of the serving path from ``deepspeed_tpu_torch/
            csrc/`` with nvcc for sm_90a (``-Xptxas -v`` lines printed),
            all sources compiled in parallel;
2. kernels  each kernel against its plain PyTorch version at the serving
            path's shapes, fp32 (max abs error 1e-4) and bf16 (2e-2,
            against the plain version in fp32 on the same bf16 inputs);
            timed with CUDA events beside the plain version, one PyTorch
            library call on the same work (``library_ms``, a yardstick
            only) and the bound the card's peak rates give;
3. serve    ``ServeEngine`` on full-size GPT-2 small (bf16, random weights
            from a seed): 12 requests over 8 slots, prompts of 16-512
            tokens, 64 new tokens each; tokens/s, per-token p50/p99 and
            peak memory; asserts that every prefill went through the
            flash kernel and every decode tick through the decode kernel;
4. parity   the same 12 requests in fp32 on the kernel path and on the
            dense path (``attn_impl="dense"``, ``decode_impl="dense"``):
            greedy streams must be equal, a flip allowed only on a near tie
            (top-2 logit gap below 1e-3), each reported with its gap.

Then one ``{"kernels": [...]}`` line and, last, the run's result line.
Without a CUDA device, or without the package beside this file, it exits
non-zero and prints no result.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
KERNELS = ("flash_fwd", "decode_attention")
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
#: the card's published peaks (H100 SXM data sheet, dense)
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS_S = {"float32": 67e12, "bfloat16": 989e12}
N_REQ, NEW_TOKENS, PROMPT_MIN, PROMPT_MAX = 12, 64, 16, 512
SEED = 0
NEAR_TIE = 1e-3


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()


def time_ms(fn, iters: int = 20) -> float:
    import torch
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: int, flops: int, dtype: str):
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS_S[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def phase_build():
    from deepspeed_tpu_torch.ops.kernels import build
    t0 = time.perf_counter()
    logs = build.build(KERNELS, verbose=True, force=True)
    print(f"[build] nvcc for sm_90a, {len(logs)} sources in parallel: "
          f"{time.perf_counter() - t0:.1f} s")
    for name in KERNELS:
        for line in logs[name].splitlines():
            if "ptxas" in line and ("registers" in line or "smem" in line
                                    or "Compiling" in line
                                    or "spill" in line):
                print(f"[build] {name}: {line.strip()}")


def phase_kernels(dev):
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.kernels.decode_attention import (
        _default_scale, decode_attention_cuda, decode_attention_plain)
    from deepspeed_tpu_torch.ops.kernels.flash_attention import (
        flash_attention_cuda, flash_attention_plain)

    g = torch.Generator(device=dev)
    g.manual_seed(SEED)
    results = {}

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    # -- flash forward: the prefill's [1, 12, 512, 64] causal, plus a
    # cross-length case with kv_length < Tk and an all-dead kv_length=0
    B, H, T, D = 1, 12, 512, 64
    scale = D ** -0.5
    q32, k32, v32 = randn(B, H, T, D), randn(B, H, T, D), randn(B, H, T, D)
    cases = [("causal", True, None), ("kv_length=300", False, 300),
             ("kv_length=0 (dead rows)", False, 0)]
    err_main = None
    for dtype in ("float32", "bfloat16"):
        tdt = getattr(torch, dtype)
        q, k, v = (t.to(tdt) for t in (q32, k32, v32))
        for label, causal, kvl in cases:
            out, lse = flash_attention_cuda(q, k, v, causal, scale, kvl)
            torch.cuda.synchronize()
            ref, ref_lse = flash_attention_plain(q.float(), k.float(),
                                                 v.float(), causal, scale,
                                                 kvl)
            err = (out.float() - ref).abs().max().item()
            lse_err = (lse - ref_lse).abs().max().item()
            print(f"[kernels] flash_fwd {dtype} {label}: max abs err "
                  f"{err:.3g} (lse {lse_err:.3g})")
            if not (err <= TOL[dtype] and lse_err <= TOL[dtype]):
                fail(f"flash_fwd {dtype} {label}: error {err} / lse "
                     f"{lse_err} above {TOL[dtype]}")
            if kvl == 0 and not (out == 0).all():
                fail("flash_fwd: dead rows are not exact zeros")
            if dtype == "bfloat16" and causal:
                err_main = err
    q, k, v = (t.to(torch.bfloat16) for t in (q32, k32, v32))
    pairs = B * H * T * (T + 1) // 2  # causal (query, key) pairs
    nbytes = 4 * B * H * T * D * 2 + B * H * T * 4  # q,k,v,o + lse
    bms, by = bound_ms(nbytes, 4 * D * pairs, "bfloat16")
    results["flash_fwd"] = {
        "name": "flash_fwd", "route": "cuda",
        "source": "deepspeed_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "deepspeed_tpu/ops/pallas/flash_attention.py:175",
        "max_abs_err": err_main,
        "ms": time_ms(lambda: flash_attention_cuda(q, k, v, True, scale)),
        "plain_ms": time_ms(lambda: flash_attention_plain(
            q, k, v, True, scale)),
        "bound_ms": bms, "bound_by": by,
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True)),
    }

    # -- decode: the tick's [8, 12, 1024, 64] slot cache, lengths with a
    # free slot (0), one key, one past a 512 boundary and a full slot
    S, T = 8, 1024
    lengths = torch.tensor([0, 1, 513, 1024, 77, 300, 640, 1000],
                           dtype=torch.int32, device=dev)
    dscale = _default_scale(D)
    q32, k32, v32 = randn(S, H, D), randn(S, H, T, D), randn(S, H, T, D)
    for dtype in ("float32", "bfloat16"):
        tdt = getattr(torch, dtype)
        q, k, v = (t.to(tdt) for t in (q32, k32, v32))
        out = decode_attention_cuda(q, k, v, lengths, dscale)
        torch.cuda.synchronize()
        ref = decode_attention_plain(q.float(), k.float(), v.float(),
                                     lengths, dscale)
        err = (out.float() - ref).abs().max().item()
        print(f"[kernels] decode_attention {dtype}: max abs err {err:.3g}")
        if not err <= TOL[dtype]:
            fail(f"decode_attention {dtype}: error {err} above "
                 f"{TOL[dtype]}")
        if not (out[0] == 0).all():
            fail("decode_attention: a length-0 slot is not exact zeros")
        if dtype == "bfloat16":
            err_main = err
    q, k, v = (t.to(torch.bfloat16) for t in (q32, k32, v32))
    live = int(lengths.sum().item()) * H  # live (head, key) rows
    nbytes = live * D * 2 * 2 + 2 * S * H * D * 2 + S * 4
    bms, by = bound_ms(nbytes, 4 * D * live, "bfloat16")
    mask = (torch.arange(T, device=dev)[None, :]
            < lengths[:, None])[:, None, None, :]
    results["decode_attention"] = {
        "name": "decode_attention", "route": "cuda",
        "source": "deepspeed_tpu_torch/csrc/decode_attention.cu",
        "replaces": "deepspeed_tpu/ops/pallas/decode_attention.py:114",
        "max_abs_err": err_main,
        "ms": time_ms(lambda: decode_attention_cuda(q, k, v, lengths,
                                                    dscale)),
        "plain_ms": time_ms(lambda: decode_attention_plain(
            q, k, v, lengths, dscale)),
        "bound_ms": bms, "bound_by": by,
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            q[:, :, None], k, v, attn_mask=mask)),
    }
    for r in results.values():
        print(f"[kernels] {r['name']} bf16: {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.5f} ms ({r['bound_by']})")
    return results


def _load():
    rng = np.random.default_rng(SEED)
    lens = rng.integers(PROMPT_MIN, PROMPT_MAX + 1, N_REQ)
    from deepspeed_tpu_torch.models.gpt2 import GPT2_SMALL
    return [[int(t) for t in rng.integers(0, GPT2_SMALL.vocab_size, n)]
            for n in lens]


def _serve(model, params, cfg, prompts, dev):
    from deepspeed_tpu_torch.inference import ServeEngine
    eng = ServeEngine(model, cfg, params=params, device=dev)
    reqs = [eng.submit(p, max_new_tokens=NEW_TOKENS) for p in prompts]
    eng.run_until_idle()
    eng.close()
    for r in reqs:
        if r.error is not None or r.finish_reason != "length" \
                or len(r.tokens) != NEW_TOKENS:
            fail(f"request {r.rid}: {r.finish_reason} {r.error!r} "
                 f"({len(r.tokens)} tokens)")
    return reqs


def phase_serve(dev):
    import torch
    from deepspeed_tpu_torch.inference import ServeEngine
    from deepspeed_tpu_torch.models.gpt2 import GPT2_SMALL, GPT2Model
    from deepspeed_tpu_torch.ops.kernels.decode_attention import (
        decode_attention)
    from deepspeed_tpu_torch.ops.kernels.flash_attention import (
        flash_attention)

    model = GPT2Model(GPT2_SMALL)
    params = model.init(SEED, device=dev, dtype=torch.bfloat16)
    cfg = {"serving": {"slots": 8, "max_seq_len": 1024,
                       "prefill_len": 512}}
    eng = ServeEngine(model, cfg, params=params, device=dev)
    warm = eng.submit(list(range(16)), max_new_tokens=2)  # cuBLAS, caches
    eng.run_until_idle()
    if warm.error is not None:
        fail(f"warm-up request: {warm.error!r}")
    ticks0 = eng.decode_ticks
    prompts = _load()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    flash_attention.launches = 0
    decode_attention.launches = 0
    t0 = time.perf_counter()
    reqs = [eng.submit(p, max_new_tokens=NEW_TOKENS) for p in prompts]
    eng.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_fwd": flash_attention.launches,
                "decode_attention": decode_attention.launches}
    ticks = eng.decode_ticks - ticks0
    eng.close()
    L = GPT2_SMALL.n_layer
    for r in reqs:
        if r.error is not None or r.finish_reason != "length" \
                or len(r.tokens) != NEW_TOKENS \
                or not all(0 <= t < GPT2_SMALL.vocab_size for t in r.tokens):
            fail(f"serve request {r.rid}: {r.finish_reason} {r.error!r}")
    if launches["flash_fwd"] != N_REQ * L:
        fail(f"flash_fwd launched {launches['flash_fwd']} times, expected "
             f"{N_REQ} prefills x {L} layers")
    if launches["decode_attention"] != L * ticks or ticks == 0:
        fail(f"decode_attention launched {launches['decode_attention']} "
             f"times, expected {L} layers x {ticks} decode ticks")
    tokens = sum(len(r.tokens) for r in reqs)
    tpot = sorted(t for r in reqs for t in r.token_times[1:])
    ttft = sorted(r.token_times[0] for r in reqs)
    pct = lambda xs, p: xs[min(len(xs) - 1, int(p * len(xs)))]  # noqa: E731
    print(f"[serve] GPT-2 small bf16, {N_REQ} requests x {NEW_TOKENS} "
          f"tokens over 8 slots, prompts {min(map(len, prompts))}-"
          f"{max(map(len, prompts))}: {tokens} tokens in {wall:.3f} s = "
          f"{tokens / wall:.1f} tokens/s; {ticks} decode ticks")
    print(f"[serve] per-token (decode) p50 {pct(tpot, 0.5) * 1e3:.3f} ms "
          f"p99 {pct(tpot, 0.99) * 1e3:.3f} ms; time to first token p50 "
          f"{pct(ttft, 0.5) * 1e3:.1f} ms p99 {pct(ttft, 0.99) * 1e3:.1f} "
          f"ms; peak memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**20:.1f} MiB")
    print(f"[serve] launches: flash_fwd {launches['flash_fwd']} "
          f"(= {N_REQ} x {L}), decode_attention "
          f"{launches['decode_attention']} (= {L} x {ticks})")
    return launches


def phase_parity(dev):
    import torch
    from deepspeed_tpu_torch.models.gpt2 import (GPT2_SMALL, GPT2Config,
                                                 GPT2Model, gpt2_prefill)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kern = GPT2Model(GPT2_SMALL)
    dense_cfg = GPT2Config(**{**GPT2_SMALL.__dict__, "attn_impl": "dense"})
    dense = GPT2Model(dense_cfg)
    params = kern.init(SEED, device=dev, dtype=torch.float32)
    prompts = _load()
    base = {"slots": 8, "max_seq_len": 1024, "prefill_len": 512}
    ours = _serve(kern, params, {"serving": base}, prompts, dev)
    ref = _serve(dense, params, {"serving": {**base,
                                             "decode_impl": "dense"}},
                 prompts, dev)
    flips = 0
    for p, a, b in zip(prompts, ours, ref):
        if a.tokens == b.tokens:
            continue
        i = next(i for i, (x, y) in enumerate(zip(a.tokens, b.tokens))
                 if x != y)
        logits, _, _ = gpt2_prefill(dense_cfg, params, torch.tensor(
            [p + b.tokens[:i]], device=dev))
        top = torch.topk(logits[0, -1].float(), 2).values
        gap = float(top[0] - top[1])
        print(f"[parity] request {a.rid}: flip at token {i} "
              f"({a.tokens[i]} vs {b.tokens[i]}), top-2 logit gap {gap:.3g}")
        if not gap < NEAR_TIE:
            fail(f"request {a.rid} diverges at token {i} with gap {gap}")
        flips += 1
    print(f"[parity] fp32 kernel path vs dense path: {N_REQ - flips}/"
          f"{N_REQ} greedy streams equal, {flips} near-tie flips")


def main() -> None:
    if not os.path.isdir(os.path.join(HERE, "deepspeed_tpu_torch")):
        fail("deepspeed_tpu_torch/ is not beside chip_smoke.py: run it "
             "from the root of a checkout")
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device: the smoke run needs one card")
    sys.path.insert(0, HERE)
    dev = torch.device("cuda", 0)
    card = smi()
    print(f"[device] {torch.cuda.get_device_name(0)}; nvidia-smi: {card}; "
          f"torch {torch.__version__} cuda {torch.version.cuda}")
    phase_build()
    kernels = phase_kernels(dev)
    launches = phase_serve(dev)
    phase_parity(dev)
    for name, r in kernels.items():
        r["launches"] = launches[name]
    print(card)
    print(json.dumps({"kernels": [kernels[n] for n in KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
