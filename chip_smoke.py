#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``deepspeed_tpu_torch``).

Run from the root of a checkout, on a machine with one NVIDIA card:

    python3 chip_smoke.py

Phases, all on ``cuda:0``; any failure exits non-zero:

1. build    the four kernels of the serving and training paths from
            ``deepspeed_tpu_torch/csrc/`` with nvcc for sm_90a
            (``-Xptxas -v`` lines printed), all sources compiled in
            parallel;
2. kernels  each kernel against its plain PyTorch version at the serving
            and training paths' shapes, fp32 (max abs error 1e-4) and bf16
            (2e-2, against the plain version in fp32 on the same bf16
            inputs; the backward gradients relative to their largest
            magnitude when it exceeds 1): the flash forward also with
            dropout 0.1, a key mask with an all-masked row and a
            non-trivial ``bh_affine``, the dQ and dK/dV kernels at
            [8, 12, 1024, 64] causal with dropout 0.1 and an all-dead case
            (exact-zero gradients); timed with CUDA events beside the plain
            version, one PyTorch library call on the same work
            (``library_ms``, a yardstick only) and the bound the card's
            peak rates give;
3. serve    ``ServeEngine`` on full-size GPT-2 small (bf16, random weights
            from a seed): 12 requests over 8 slots, prompts of 16-512
            tokens, 64 new tokens each; tokens/s, per-token p50/p99 and
            peak memory; asserts that every prefill went through the
            flash kernel and every decode tick through the decode kernel;
4. parity   the same 12 requests in fp32 on the kernel path and on the
            dense path (``attn_impl="dense"``, ``decode_impl="dense"``):
            greedy streams must be equal, a flip allowed only on a near tie
            (top-2 logit gap below 1e-3), each reported with its gap;
5. train    ``deepspeed_tpu_torch.initialize`` on full-size GPT-2 small
            (bf16, dropout 0.1 everywhere, ``remat="block"``, random
            weights from a seed), micro-batch 8 x 1024 tokens, gradient
            accumulation 2, Adam, clipping 1.0: 2 warm-up steps, then 8
            timed steps on one batch; every loss finite and the last below
            the first; step ms, tokens/s and peak memory; asserts that
            every step launched the flash forward 2 x 12 x 2 times (forward
            and recompute) and each backward kernel 12 x 2 times;
6. train parity  fp32 (TF32 off), width 768 at 4 layers, dropout 0: the
            kernel path against the dense path (``attn_impl="dense"``) on
            the same params and tokens, the first step's attention-weight
            gradients within 1e-3 (max relative) and 5 steps' losses within
            1e-4 (relative).

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
KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "decode_attention")
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
#: the card's published peaks (H100 SXM data sheet, dense)
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS_S = {"float32": 67e12, "bfloat16": 989e12}
N_REQ, NEW_TOKENS, PROMPT_MIN, PROMPT_MAX = 12, 64, 16, 512
SEED = 0
NEAR_TIE = 1e-3
#: the training path's attention call: micro-batch 8, 12 heads, T 1024
TRAIN_SHAPE = (8, 12, 1024, 64)
TRAIN_MICRO, TRAIN_GA, TRAIN_WARM, TRAIN_STEPS = 8, 2, 2, 8
PARITY_LAYERS, PARITY_STEPS = 4, 5


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


def _rel_err(got, want) -> float:
    """max abs error, relative to the largest magnitude when it exceeds 1."""
    return ((got.float() - want).abs().max()
            / max(1.0, want.abs().max().item())).item()


def phase_train_kernels(dev, results):
    """The flash kernels at the training shape: the forward's training
    arms, then dQ and dK/dV against their plain versions, and their
    timings (bf16, causal, dropout 0.1: the train phase's call)."""
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.kernels.flash_attention import (
        flash_attention_cuda, flash_attention_plain, flash_bwd_dkv_cuda,
        flash_bwd_dkv_plain, flash_bwd_dq_cuda, flash_bwd_dq_plain)

    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 1)
    B, H, T, D = TRAIN_SHAPE
    scale = D ** -0.5
    q32, k32, v32, do32 = (torch.randn((B, H, T, D), generator=g,
                                       device=dev) for _ in range(4))
    km = torch.zeros(B * H, T, device=dev)
    km[3, 100:700] = -1e9
    km[B * H - 1] = -1e9          # an all-masked row: dead rows
    fwd_cases = [
        ("causal dropout 0.1", True, None, None, 0.1, (0, B * H, 0)),
        ("causal dropout 0.1 key mask bh_affine", True, None, km, 0.1,
         (7, H, 2 * H)),
        ("non-causal kv_length=700 dropout 0.25 key mask", False, 700, km,
         0.25, (3, 5, 11)),
    ]
    bwd_cases = [("causal dropout 0.1", True, None, None, 0.1, None),
                 ("key mask bh_affine dropout 0.1", True, None, km, 0.1,
                  (7, H, 2 * H)),
                 ("kv_length=0 (all dead)", False, 0, None, 0.1, None)]
    errs = {}
    for dtype in ("float32", "bfloat16"):
        tdt = getattr(torch, dtype)
        q, k, v, do = (t.to(tdt) for t in (q32, k32, v32, do32))
        f32 = (q.float(), k.float(), v.float())
        for label, causal, kvl, kmask, rate, aff in fwd_cases:
            args = (causal, scale, kvl, kmask, rate, 0x9E3779B9, aff)
            out, lse = flash_attention_cuda(q, k, v, *args)
            torch.cuda.synchronize()
            ref, ref_lse = flash_attention_plain(*f32, *args)
            err = (out.float() - ref).abs().max().item()
            live = ref_lse < 1e29
            lse_err = (lse[live] - ref_lse[live]).abs().max().item()
            print(f"[kernels] flash_fwd {dtype} {label}: max abs err "
                  f"{err:.3g} (lse {lse_err:.3g})")
            if not (err <= TOL[dtype] and lse_err <= TOL[dtype]
                    and torch.equal(lse >= 1e29, ~live)):
                fail(f"flash_fwd {dtype} {label}: error {err} / lse "
                     f"{lse_err} above {TOL[dtype]}")
            if kmask is not None and not (
                    out.view(B * H, T, D)[B * H - 1] == 0).all():
                fail("flash_fwd: the all-masked row is not exact zeros")
        for label, causal, kvl, kmask, rate, aff in bwd_cases:
            args = (causal, scale, kvl, kmask, rate, 12345, aff)
            ref, ref_lse = flash_attention_plain(*f32, *args)
            delta = (do.float() * ref).sum(-1)
            dq = flash_bwd_dq_cuda(q, k, v, do, ref_lse, delta, *args)
            dk, dv = flash_bwd_dkv_cuda(q, k, v, do, ref_lse, delta, *args)
            torch.cuda.synchronize()
            plain = (*f32, do.float(), ref_lse, delta)
            rdq = flash_bwd_dq_plain(*plain, *args)
            rdk, rdv = flash_bwd_dkv_plain(*plain, *args)
            e_dq = _rel_err(dq, rdq)
            e_dkv = max(_rel_err(dk, rdk), _rel_err(dv, rdv))
            print(f"[kernels] flash_bwd {dtype} {label}: dq err {e_dq:.3g}, "
                  f"dk/dv err {e_dkv:.3g}")
            if not (e_dq <= TOL[dtype] and e_dkv <= TOL[dtype]):
                fail(f"flash_bwd {dtype} {label}: dq {e_dq} dk/dv {e_dkv} "
                     f"above {TOL[dtype]}")
            if kvl == 0 and not all((t == 0).all() for t in (dq, dk, dv)):
                fail("flash_bwd: all-dead gradients are not exact zeros")
            if kmask is not None and not (
                    dq.view(B * H, T, D)[B * H - 1] == 0).all():
                fail("flash_bwd: the all-masked row's dq is not zeros")
            if dtype == "bfloat16" and kmask is None and kvl is None:
                errs["dq"], errs["dkv"] = e_dq, e_dkv
            del dq, dk, dv, rdq, rdk, rdv

    # timings at the train phase's call: bf16, causal, dropout 0.1
    q, k, v, do = (t.bfloat16() for t in (q32, k32, v32, do32))
    args = (True, scale, None, None, 0.1, 12345, None)
    out, lse = flash_attention_cuda(q, k, v, *args)
    delta = (do.float() * out.float()).sum(-1)
    pairs = B * H * T * (T + 1) // 2
    row_b = B * H * T * D * 2            # one bf16 [B, H, T, 64] tensor
    stat_b = B * H * T * 4               # one fp32 [B, H, T] row statistic
    qs, ks, vs = (t.clone().requires_grad_(True) for t in (q, k, v))
    ref_out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
    lib_bwd = time_ms(lambda: torch.autograd.grad(
        ref_out, (qs, ks, vs), do, retain_graph=True))
    note = ("backward of F.scaled_dot_product_attention(is_causal=True, "
            "no dropout) through autograd: all three gradients")
    bms, by = bound_ms(4 * row_b + stat_b, 4 * D * pairs, "bfloat16")
    results["flash_fwd"].update({
        "train_shape": list(TRAIN_SHAPE),
        "train_ms": time_ms(lambda: flash_attention_cuda(q, k, v, *args)),
        "train_plain_ms": time_ms(lambda: flash_attention_plain(
            q, k, v, *args)),
        "train_bound_ms": bms, "train_bound_by": by,
        "train_library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True)),
    })
    bms, by = bound_ms(5 * row_b + 2 * stat_b, 6 * D * pairs, "bfloat16")
    results["flash_bwd_dq"] = {
        "name": "flash_bwd_dq", "route": "cuda",
        "source": "deepspeed_tpu_torch/csrc/flash_bwd_dq.cu",
        "replaces": "deepspeed_tpu/ops/pallas/flash_attention.py:363",
        "max_abs_err": errs["dq"], "shape": list(TRAIN_SHAPE),
        "ms": time_ms(lambda: flash_bwd_dq_cuda(q, k, v, do, lse, delta,
                                                *args)),
        "plain_ms": time_ms(lambda: flash_bwd_dq_plain(q, k, v, do, lse,
                                                       delta, *args)),
        "bound_ms": bms, "bound_by": by, "library_ms": lib_bwd,
        "library_note": note,
    }
    bms, by = bound_ms(6 * row_b + 2 * stat_b, 8 * D * pairs, "bfloat16")
    results["flash_bwd_dkv"] = {
        "name": "flash_bwd_dkv", "route": "cuda",
        "source": "deepspeed_tpu_torch/csrc/flash_bwd_dkv.cu",
        "replaces": "deepspeed_tpu/ops/pallas/flash_attention.py:414",
        "max_abs_err": errs["dkv"], "shape": list(TRAIN_SHAPE),
        "ms": time_ms(lambda: flash_bwd_dkv_cuda(q, k, v, do, lse, delta,
                                                 *args)),
        "plain_ms": time_ms(lambda: flash_bwd_dkv_plain(q, k, v, do, lse,
                                                        delta, *args)),
        "bound_ms": bms, "bound_by": by, "library_ms": lib_bwd,
        "library_note": note,
    }
    r = results["flash_fwd"]
    print(f"[kernels] flash_fwd bf16 {TRAIN_SHAPE} dropout 0.1: "
          f"{r['train_ms']:.4f} ms, plain {r['train_plain_ms']:.4f} ms, "
          f"library {r['train_library_ms']:.4f} ms, bound "
          f"{r['train_bound_ms']:.5f} ms ({r['train_bound_by']})")
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        r = results[name]
        print(f"[kernels] {name} bf16 {TRAIN_SHAPE} dropout 0.1: "
              f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library "
              f"(all three grads) {r['library_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.5f} ms ({r['bound_by']})")


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
    _zero_counts()
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


def _train_counts():
    from deepspeed_tpu_torch.ops.kernels.flash_attention import (
        flash_attention, flash_bwd_dkv, flash_bwd_dq)
    return {"flash_fwd": flash_attention.launches,
            "flash_bwd_dq": flash_bwd_dq.launches,
            "flash_bwd_dkv": flash_bwd_dkv.launches}


def _zero_counts():
    from deepspeed_tpu_torch.ops.kernels.decode_attention import (
        decode_attention)
    from deepspeed_tpu_torch.ops.kernels.flash_attention import (
        flash_attention, flash_bwd_dkv, flash_bwd_dq)
    for fn in (flash_attention, flash_bwd_dq, flash_bwd_dkv,
               decode_attention):
        fn.launches = 0


def _train_config(dtype_block: dict, micro: int, ga: int) -> dict:
    return {"train_micro_batch_size_per_gpu": micro,
            "gradient_accumulation_steps": ga,
            "steps_per_print": 10 ** 9,
            "gradient_clipping": 1.0,
            "optimizer": {"type": "Adam", "params": {"lr": 1e-4}},
            **dtype_block}


def phase_train(dev):
    """initialize() + train_batch on full-size GPT-2 small, bf16."""
    import dataclasses
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.gpt2 import GPT2_SMALL, GPT2Model

    cfg = dataclasses.replace(GPT2_SMALL, dropout=0.1, embd_dropout=0.1,
                              remat="block")
    eng, _, _, _ = deepspeed_tpu_torch.initialize(
        model=GPT2Model(cfg), seed=SEED,
        config=_train_config({"bf16": {"enabled": True}}, TRAIN_MICRO,
                             TRAIN_GA))
    if eng.device != dev:
        fail(f"initialize() placed the engine on {eng.device}, not {dev}")
    T = cfg.n_positions
    rows = TRAIN_MICRO * TRAIN_GA
    tokens = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (rows, T + 1))).to(dev)
    losses = [eng.train_batch(tokens) for _ in range(TRAIN_WARM)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _zero_counts()
    t0 = time.perf_counter()
    # any host sync inside a step (a read-back, a blocking copy) raises
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(TRAIN_STEPS):
            losses.append(eng.train_batch(tokens))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _train_counts()
    losses = [float(x) for x in losses]
    m = eng.last_metrics
    eng.close()
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"train losses not finite and falling: {losses}")
    if m.overflow or eng.get_skipped_steps() != 0:
        fail("a bf16 train step was skipped")
    L, A = cfg.n_layer, TRAIN_GA
    want = {"flash_fwd": 2 * L * A, "flash_bwd_dq": L * A,
            "flash_bwd_dkv": L * A}
    for name, per_step in want.items():
        if launches[name] != per_step * TRAIN_STEPS:
            fail(f"{name} launched {launches[name]} times in "
                 f"{TRAIN_STEPS} steps, expected {per_step} per step")
    step_ms = wall / TRAIN_STEPS * 1e3
    print(f"[train] GPT-2 small bf16, micro-batch {TRAIN_MICRO} x {T} "
          f"tokens, grad accumulation {A}, dropout 0.1, remat block: "
          f"{step_ms:.1f} ms per step = {rows * T / (wall / TRAIN_STEPS):.0f}"
          f" tokens/s over {TRAIN_STEPS} steps; peak memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**20:.1f} MiB")
    print(f"[train] losses {' '.join(f'{x:.4f}' for x in losses)}; grad "
          f"norm {m.grad_norm:.4f}, lr {m.lr:.3g}")
    print(f"[train] {TRAIN_STEPS} steps queued with no host sync (torch.cuda "
          "sync debug mode 'error')")
    print(f"[train] launches per step: flash_fwd "
          f"{launches['flash_fwd'] // TRAIN_STEPS} (= 2 x {L} x {A}), "
          f"flash_bwd_dq {launches['flash_bwd_dq'] // TRAIN_STEPS}, "
          f"flash_bwd_dkv {launches['flash_bwd_dkv'] // TRAIN_STEPS} "
          f"(= {L} x {A})")
    return launches


def phase_train_parity(dev):
    """fp32 kernel path vs dense path, 4 layers at full width."""
    import dataclasses
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.gpt2 import GPT2_SMALL, GPT2Model
    from deepspeed_tpu_torch.runtime.utils import tree_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kcfg = dataclasses.replace(GPT2_SMALL, n_layer=PARITY_LAYERS,
                               remat=None)
    models = {impl: GPT2Model(dataclasses.replace(kcfg, attn_impl=impl))
              for impl in ("flash", "dense")}
    params = models["flash"].init(SEED, device=dev)
    tokens = torch.from_numpy(np.random.default_rng(SEED + 2).integers(
        0, kcfg.vocab_size, (2, kcfg.n_positions + 1))).to(dev)
    grads = {}
    for impl, model in models.items():
        p = {k: (v if not isinstance(v, dict) else dict(v))
             for k, v in params.items()}
        for leaf in tree_leaves(p):
            leaf.requires_grad_(True)
        model.loss_fn(p, tokens, None, train=True).backward()
        grads[impl] = {n: p["blocks"][n].grad.clone()
                       for n in ("qkv_w", "out_w")}
        for leaf in tree_leaves(p):
            leaf.grad = None
            leaf.requires_grad_(False)
    for n in ("qkv_w", "out_w"):
        a, b = grads["flash"][n], grads["dense"][n]
        rel = ((a - b).abs().max() / b.abs().max()).item()
        print(f"[train parity] first-step grad {n}: max rel diff {rel:.3g}")
        if not rel <= 1e-3:
            fail(f"train parity: {n} gradients differ by {rel} (max rel)")
    losses = {}
    for impl, model in models.items():
        eng, _, _, _ = deepspeed_tpu_torch.initialize(
            model=model, params=params, seed=SEED,
            config=_train_config({}, 2, 1))
        _zero_counts()
        losses[impl] = [float(eng.train_batch(tokens))
                        for _ in range(PARITY_STEPS)]
        n = PARITY_STEPS * PARITY_LAYERS if impl == "flash" else 0
        if _train_counts() != dict.fromkeys(_train_counts(), n):
            fail(f"train parity: the {impl} path launched "
                 f"{_train_counts()}, expected {n} of each")
    worst = max(abs(a - b) / abs(b)
                for a, b in zip(losses["flash"], losses["dense"]))
    print(f"[train parity] fp32 kernel vs dense, {PARITY_LAYERS} layers at "
          f"width {kcfg.d_model}, {PARITY_STEPS} steps: losses "
          f"{' '.join(f'{x:.6f}' for x in losses['flash'])} vs "
          f"{' '.join(f'{x:.6f}' for x in losses['dense'])}; max rel diff "
          f"{worst:.3g}")
    if not worst <= 1e-4:
        fail(f"train parity: losses differ by {worst} (relative)")


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
    phase_train_kernels(dev, kernels)
    serve = phase_serve(dev)
    phase_parity(dev)
    train = phase_train(dev)
    phase_train_parity(dev)
    for name, r in kernels.items():
        by_phase = {"serve": serve.get(name, 0), "train": train.get(name, 0)}
        r["launches"] = sum(by_phase.values())
        r["launches_by_phase"] = by_phase
    print(card)
    print(json.dumps({"kernels": [kernels[n] for n in KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
