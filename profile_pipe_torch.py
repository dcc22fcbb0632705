#!/usr/bin/env python3
"""GPT-2 small as a pipeline over every card of one machine, over NCCL.

    python3 profile_pipe_torch.py

Needs at least two NVIDIA cards: with N of them it runs pp N, one stage a
process and a card (``torch.distributed`` over NCCL, the boundary tensors
sent on the card as they are, ``pipe/p2p.py``), from chip_smoke.py's
train_pipe weight tree and batch (GPT-2 small at full width and depth, 8
micro-batches of 1 x 1024 tokens, dropout 0.1, Adam, clipping 1.0; 1 + 2
fp32 and bf16 1F1B steps), against the same model at pp 1 on card 0 with
no process group.  The fp32 losses must match pp 1's within 1e-5
relative and the first bf16 loss within 1e-2; every rank's flash
launches a step must be pp 1's over N (its share of the 12 blocks).  It
prints each rank's step ms, peak MiB, point-to-point calls, bytes and
wait ms a step, beside the cards' names and power limits, and ends with
one JSON line.  Any failure exits non-zero.

    python3 profile_pipe_torch.py --trace

Needs one card. Traces one bf16 1F1B step of the same model under
``torch.profiler`` (CUDA activity): at pp 1 in this process, the plain
engine's step on the same GPT-2 (``remat="block"``) and micro-batches,
and pp 2 as two processes on card 0 over a gloo pipe group
(chip_smoke.py's train_pipe leg (b)). The engine's layers are labelled
for the trace by wrapping them here (the package carries no
instrumentation for it): ``fetch`` (a leaf's cast or gather for the
forward and the recompute), ``accumulate`` (its fp32 gradient added),
``finish_grads``, each ``psum[<axis>]`` (collective, by axis),
``p2p_post``/``p2p_wait``/``p2p_finish``, ``loss_head``, ``norm`` and
``update``. Prints, per process, the step's host ms, the card's busy ms
(the union of its kernel and copy intervals) and idle share, the kernel
count, and each label's host ms and the device ms of the kernels
launched inside it (beside it, the step before, timed without the
profiler); writes the full ``key_averages`` tables under
``chiprun_out/``.
"""
import json
import sys

import chip_smoke as cs


def main() -> None:
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.gpt2_pipe import (build_gpt2_pipe,
                                                      split_gpt2_batch)
    if not torch.cuda.is_available():
        cs.fail("no CUDA device")
    world = torch.cuda.device_count()
    if world < 2:
        cs.fail(f"a pipeline over NCCL needs two cards or more, found "
                f"{world}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cards = "; ".join(cs.smi().splitlines())
    print(f"[pipe] {world} x {torch.cuda.get_device_name(0)}; nvidia-smi: "
          f"{cards}")
    cs.phase_build()
    dev = torch.device("cuda", 0)
    tree, digest = cs._pipe_tree()
    batch = split_gpt2_batch(torch.from_numpy(cs._pipe_tokens()).to(dev))
    ref = {}
    for label, block in (("fp32", {}), ("bf16", {"bf16": {"enabled": True}})):
        eng = deepspeed_tpu_torch.initialize(
            model=build_gpt2_pipe(cs._pipe_model_cfg(0.1), 1), params=tree,
            seed=cs.SEED, config=cs._pipe_cfg(block), device=dev)[0]
        ref[label] = cs._pipe_steps(eng, batch, cs.PIPE_PP2_STEPS, dev)
        eng.close()
        print(f"[pipe] pp 1 {label} on card 0: {ref[label]['step_ms']:.1f} "
              f"ms per step; losses {ref[label]['losses']} [{cards}]")
    del eng
    torch.cuda.empty_cache()
    ranks = cs._pipe_ranks(digest, world=world, backend="nccl")
    for res in ranks:
        s = res["fp32"]["stage"]
        for label in ("fp32", "bf16"):
            r, want = res[label], ref[label]["launches"]
            for name, n in want.items():
                if r["launches"][name] * world != n:
                    cs.fail(f"stage {s} {label}: {name} launched "
                            f"{r['launches'][name]} times, pp 1 {n}")
            p = r["p2p"]
            print(f"[pipe] pp {world} {label} stage {s} (NCCL, card {s}): "
                  f"{r['step_ms']:.1f} ms per step, peak "
                  f"{r['peak_mib']:.1f} MiB; point-to-point "
                  f"{p['sends'] + p['recvs']:.0f} calls, "
                  f"{p['send_bytes'] + p['recv_bytes']:.0f} B, "
                  f"{p['seconds'] * 1e3:.1f} ms of posting and waiting "
                  f"per step; boundary inputs held {r['max_live']} "
                  f"[{cards}]")
        if res["fp32"]["losses"] != ranks[0]["fp32"]["losses"]:
            cs.fail("the stages return different losses")
    got, want = ranks[0]["fp32"]["losses"], ref["fp32"]["losses"]
    worst = max(abs(a - b) / abs(b) for a, b in zip(got, want))
    first = (abs(ranks[0]["bf16"]["losses"][0] - ref["bf16"]["losses"][0])
             / abs(ref["bf16"]["losses"][0]))
    print(f"[pipe] pp {world} vs pp 1: fp32 max rel diff {worst:.3g} (bar "
          f"{cs.PIPE_FP32_RTOL}), first bf16 loss rel diff {first:.3g} (bar "
          f"{cs.PIPE_BF16_RTOL}) [{cards}]")
    if not worst <= cs.PIPE_FP32_RTOL or not first <= cs.PIPE_BF16_RTOL:
        cs.fail(f"pp {world} losses {got} differ from pp 1's {want}")
    print(json.dumps({"ok": True, "pp": world, "cards": cards,
                      "pp1": {k: v["step_ms"] for k, v in ref.items()},
                      "ranks": [{k: res[k]["step_ms"]
                                 for k in ("fp32", "bf16")}
                                for res in ranks]}))


#: the engine's calls labelled in the trace: (module, owner, attribute)
LABELS = (("deepspeed_tpu_torch.runtime.zero", "ZeroRuntime", "materialize",
           "fetch"),
          ("deepspeed_tpu_torch.runtime.zero", "ZeroRuntime", "accumulate",
           "accumulate"),
          ("deepspeed_tpu_torch.runtime.zero", "ZeroRuntime", "finish_grads",
           "finish_grads"),
          ("deepspeed_tpu_torch.pipe.p2p", "PipeChannel", "step", "p2p_post"),
          ("deepspeed_tpu_torch.pipe.p2p", "PipeChannel", "wait", "p2p_wait"),
          ("deepspeed_tpu_torch.pipe.p2p", "PipeChannel", "finish_sends",
           "p2p_finish"),
          ("deepspeed_tpu_torch.runtime.engine", "DeepSpeedEngine",
           "_global_norm", "norm"),
          ("deepspeed_tpu_torch.runtime.engine", "DeepSpeedEngine",
           "_apply_update", "update"))
TRACE_OUT = "chiprun_out"


def _label(fn, name):
    import functools
    import torch

    @functools.wraps(fn)
    def wrapped(*a, **k):
        with torch.profiler.record_function(name):
            return fn(*a, **k)
    return wrapped


def _install_labels() -> None:
    """Wrap the engine's calls in ``record_function`` ranges; each psum
    is labelled with its axis."""
    import importlib
    import deepspeed_tpu_torch.models.gpt2_pipe as gp
    import deepspeed_tpu_torch.parallel.collectives as col
    for mod, owner, attr, name in LABELS:
        cls = getattr(importlib.import_module(mod), owner)
        setattr(cls, attr, _label(getattr(cls, attr), name))
    psum = col.psum

    def labelled_psum(x, mesh, axis):
        import torch
        with torch.profiler.record_function(f"psum[{axis}]"):
            return psum(x, mesh, axis)
    col.psum = labelled_psum
    gp.gpt2_loss_head = _label(gp.gpt2_loss_head, "loss_head")


def _union_ms(spans) -> float:
    total, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total / 1e3


def traced_step(eng, batch, tag: str) -> dict:
    """A warm-up step, a timed step, then one step under the profiler:
    host ms, the card's busy ms and idle share over the step, kernel
    count, and each label's host ms and the device ms of the kernels
    launched inside it."""
    import os
    import time
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    eng.train_batch(batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.train_batch(batch)
    torch.cuda.synchronize()
    untraced_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        loss = float(eng.train_batch(batch))
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    dev = [e for e in events if e.device_type == DeviceType.CUDA]
    busy = _union_ms((e.time_range.start, e.time_range.end) for e in dev)
    avg = prof.key_averages()
    names = [name for *_, name in LABELS] + ["loss_head"]
    names += sorted({e.key for e in avg if e.key.startswith("psum[")})
    labels = {}
    for e in avg:
        # the host ranges (a range's device twin on the card's timeline
        # has the same key)
        if e.key in names and e.device_type == DeviceType.CPU:
            labels[e.key] = {"count": e.count,
                             "host_ms": e.cpu_time_total / 1e3,
                             "device_ms": e.device_time_total / 1e3}
    os.makedirs(TRACE_OUT, exist_ok=True)
    with open(os.path.join(TRACE_OUT, f"pipe_trace_{tag}.txt"), "w") as f:
        f.write(avg.table(sort_by="self_cpu_time_total", row_limit=60))
        f.write("\n")
        f.write(avg.table(sort_by="self_device_time_total", row_limit=40))
    return {"tag": tag, "loss": loss, "host_ms": host_ms,
            "untraced_ms": untraced_ms,
            "device_busy_ms": busy,
            "idle_share": 1.0 - busy / host_ms if dev else None,
            "kernels": len(dev), "labels": labels}


_TRACE_RANK = r"""
import sys
sys.path.insert(0, sys.argv[1])
import profile_pipe_torch
profile_pipe_torch.trace_rank(int(sys.argv[2]), sys.argv[3])
"""


def trace_rank(rank: int, init: str) -> None:
    """One stage of the pp-2 trace: card 0, a gloo pipe group."""
    import datetime
    import json
    import torch
    import torch.distributed as dist
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.gpt2_pipe import (build_gpt2_pipe,
                                                      split_gpt2_batch)
    from deepspeed_tpu_torch.parallel import build_mesh
    _install_labels()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=2,
                            timeout=datetime.timedelta(seconds=240))
    try:
        tree, _ = cs._pipe_tree()
        batch = split_gpt2_batch(torch.from_numpy(cs._pipe_tokens()).to(dev))
        eng = deepspeed_tpu_torch.initialize(
            model=build_gpt2_pipe(cs._pipe_model_cfg(0.1), 2),
            mesh=build_mesh(pp=2), params=tree, seed=cs.SEED,
            config=cs._pipe_cfg({"bf16": {"enabled": True}}), device=dev)[0]
        out = traced_step(eng, batch, f"pp2_stage{eng.stage_id}")
        eng.close()
        dist.barrier()
    finally:
        dist.destroy_process_group()
    print("TRACE_RANK " + json.dumps(out), flush=True)


def _report(r: dict, cards: str) -> None:
    idle = ("not measured" if r["idle_share"] is None
            else f"{r['idle_share']:.3f}")
    print(f"[trace] {r['tag']} bf16 step: {r['untraced_ms']:.1f} ms "
          f"untraced; traced: host {r['host_ms']:.1f} ms, card "
          f"busy {r['device_busy_ms']:.1f} ms, idle share {idle}, "
          f"{r['kernels']} kernels; loss {r['loss']:.6f} [{cards}]")
    for name, v in sorted(r["labels"].items(),
                          key=lambda kv: -kv[1]["host_ms"]):
        print(f"[trace] {r['tag']}   {name}: {v['count']} calls, host "
              f"{v['host_ms']:.1f} ms, device {v['device_ms']:.1f} ms")


def trace() -> None:
    import json
    import subprocess
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.gpt2_pipe import (build_gpt2_pipe,
                                                      split_gpt2_batch)
    if not torch.cuda.is_available():
        cs.fail("no CUDA device")
    cards = "; ".join(cs.smi().splitlines())
    cs.phase_build()
    _install_labels()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    tree, _ = cs._pipe_tree()
    batch = split_gpt2_batch(torch.from_numpy(cs._pipe_tokens()).to(dev))
    eng = deepspeed_tpu_torch.initialize(
        model=build_gpt2_pipe(cs._pipe_model_cfg(0.1), 1), params=tree,
        seed=cs.SEED, config=cs._pipe_cfg({"bf16": {"enabled": True}}),
        device=dev)[0]
    results = [traced_step(eng, batch, "pp1")]
    eng.close()
    # the plain engine on the same model, micro-batches and batch
    import dataclasses
    from deepspeed_tpu_torch.models.gpt2 import GPT2Model
    tokens = torch.from_numpy(cs._pipe_tokens()).to(dev)
    eng = deepspeed_tpu_torch.initialize(
        model=GPT2Model(dataclasses.replace(cs._pipe_model_cfg(0.1),
                                            remat="block")),
        seed=cs.SEED, device=dev, config=cs._train_config(
            {"bf16": {"enabled": True}}, cs.PIPE_MICRO, cs.PIPE_GA))[0]
    results.append(traced_step(eng, tokens, "plain"))
    eng.close()
    del eng
    torch.cuda.empty_cache()
    init = f"tcp://127.0.0.1:{cs._free_port()}"
    here = cs.HERE
    procs = [subprocess.Popen(
        [sys.executable, "-c", _TRACE_RANK, here, str(r), init],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append((p.communicate(timeout=cs.PIPE_RANK_TIMEOUT_S)[0],
                         p.returncode))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (out, rc) in enumerate(outs):
        lines = [ln for ln in out.splitlines()
                 if ln.startswith("TRACE_RANK ")]
        if rc != 0 or not lines:
            cs.fail(f"trace rank {r} exited {rc}:\n{out[-3000:]}")
        results.append(json.loads(lines[-1][len("TRACE_RANK "):]))
    for r in results:
        _report(r, cards)
    print(json.dumps({"ok": True, "cards": cards, "trace": results}))


if __name__ == "__main__":
    sys.exit(trace() if sys.argv[1:] == ["--trace"] else main())
