#!/usr/bin/env python3
"""Device time of the decode kernels of one checkout, on one NVIDIA card.

    python3 profile_decode_torch.py [--root DIR]

Builds the kernels of DIR's ``deepspeed_tpu_torch`` (default: this
checkout) from DIR's sources and times their bf16 arms by device time
(``chip_smoke.py``'s ``device_ms``: the kernels' own durations under
``torch.profiler`` over 20 calls, per call; after two seconds of matrix
products, so the card's clocks have risen) at two widths, the operands
made by this checkout's ``chip_smoke.py``:

- serving (``decode_case``: [8, 12, 1024, 64], page_len 16, W = 5):
  ``decode_attention`` (the slot cache, one query), ``decode_paged``,
  ``decode_paged_int8``, ``decode_multi``, ``decode_paged_multi``,
  ``decode_paged_multi_int8``;
- capacity (``capacity_case``: 64 slots x 12 heads, rows of at most 3
  pages, T 64 as the capacity leg's own table and T 1024):
  ``decode_paged``, ``decode_paged_int8``.

Prints the card's name and power limit, then one JSON line
``{"serving": {kernel: ms}, "capacity_t64": {kernel: ms},
"capacity_t1024": {kernel: ms}}``.  Only the
wrappers' public signatures are used, so two checkouts can be compared in
turns within one call (parent, change, change, parent).
"""
import argparse
import importlib.util
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE,
                    help="the checkout whose kernels are timed")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import torch
    if not torch.cuda.is_available():
        sys.exit("profile_decode_torch: needs a CUDA device")
    from deepspeed_tpu_torch.ops.kernels import decode_attention as da
    dev = torch.device("cuda", 0)
    print(cs.smi())
    # two seconds of products first, so the clocks have risen before the
    # first timed window
    x = torch.randn((4096, 4096), device=dev, dtype=torch.bfloat16)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 2.0:
        x @ x
    torch.cuda.synchronize()
    print("deepspeed_tpu_torch from", os.path.dirname(da.__file__))
    scale = da._default_scale(64)

    c = cs.decode_case(dev)
    base, lens, table = c["base"], c["multi_lens"], c["table"]
    kc, vc, kp, vp = (c[k].bfloat16() for k in ("kc32", "vc32", "kp32",
                                                "vp32"))
    q1, qw = c["q1_32"].bfloat16(), c["qw_32"].bfloat16()
    page = kp.shape[2]
    k8, ks = cs._int8_pool(c["kp32"], table, c["live"], page, cs.SEED + 7)
    v8, vs = cs._int8_pool(c["vp32"], table, c["live"], page, cs.SEED + 8)
    serving = {
        "decode_attention": lambda: da.decode_attention_cuda(q1, kc, vc, base,
                                                             scale),
        "decode_paged": lambda: da.decode_paged_cuda(q1, kp, vp, table,
                                                     base, scale),
        "decode_paged_int8": lambda: da.decode_paged_int8_cuda(
            q1, k8, v8, ks, vs, table, base, scale),
        "decode_multi": lambda: da.decode_multi_cuda(qw, kc, vc, lens,
                                                     scale),
        "decode_paged_multi": lambda: da.decode_paged_multi_cuda(
            qw, kp, vp, table, lens, scale),
        "decode_paged_multi_int8": lambda: da.decode_paged_multi_int8_cuda(
            qw, k8, v8, ks, vs, table, lens, scale),
    }
    out = {"serving": {n: cs.device_ms(f) for n, f in serving.items()}}
    for cols in cs.CAPACITY_COLS:
        c = cs.capacity_case(dev, cols)
        capacity = {
            "decode_paged": lambda: da.decode_paged_cuda(
                c["q"], c["kp"], c["vp"], c["table"], c["lens"], scale),
            "decode_paged_int8": lambda: da.decode_paged_int8_cuda(
                c["q"], c["k8"], c["v8"], c["ks"], c["vs"], c["table"],
                c["lens"], scale),
        }
        out[f"capacity_t{cs.CAPACITY_DECODE[2] * cols}"] = {
            n: cs.device_ms(f) for n, f in capacity.items()}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
