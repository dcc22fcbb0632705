#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``deepspeed_tpu_torch``).

Run from the root of a checkout, on a machine with one NVIDIA card:

    python3 chip_smoke.py

Phases, all on ``cuda:0``; any failure exits non-zero:

1. build    the ten sources of the twelve kernels of the serving, training
            and sparse paths (the paged decode sources also hold their
            int8 pool arms) from ``deepspeed_tpu_torch/csrc/`` with nvcc
            for sm_90a
            (``-Xptxas -v`` lines printed), all sources compiled in
            parallel; the tensor-core instructions of each library
            counted with ``cuobjdump -sass``, HGMMA (wgmma) and HMMA
            (mma.sync): the tensor-core flash forward, dQ and dK/dV must
            hold HGMMA, the block-sparse forward, dQ and dK/dV, the
            single-query and multi-query decode kernels and the paged and
            paged multi-query decode kernels (both pools) HMMA;
2. kernels  each kernel against its plain PyTorch version at the serving
            and training paths' shapes, fp32 (max abs error 1e-4) and bf16
            (2e-2, against the plain version in fp32 on the same bf16
            inputs; the backward gradients relative to their largest
            magnitude when it exceeds 1): the flash forward also with
            dropout 0.1, a key mask with an all-masked row and a
            non-trivial ``bh_affine``, the dQ and dK/dV kernels at
            [8, 12, 1024, 64] causal with dropout 0.1 and an all-dead case
            (exact-zero gradients), all three at the bert_train call
            ([8, 16, 512, 64], non-causal, dropout 0.1, the padded batch's
            [B, T] key mask; the forward also within one bf16 ulp + 1e-4
            elementwise; padded keys' dK/dV exact zeros; the backward
            kernels' device time there), dQ and dK/dV also at Ulysses'
            local shape in train_seq ([1, 6, 1024, 64], seq rank 1's
            ``bh_affine`` (6, 6, 12), dropout 0.1), the paged,
            multi-query and paged
            multi-query decode kernels at [8, 12, 1024, 64] with page_len
            16 over a 513-page pool (permuted table, garbage in every page
            no live row lands in) and W = 5 verify rows (the split count
            and cluster size of the bf16/fp16 multi-query and paged
            kernels printed), and the int8 pool
            arms of the paged and paged multi-query kernels on that pool
            quantized from bf16 (random bytes and NaN scales in every row
            no live row reads; fp32 queries within 1e-4, bf16 queries
            within one bf16 ulp + 1e-4 elementwise); the single-query paged
            arms also at the capacity leg's width (64 slots x 12 heads,
            rows of at most 3 pages) with its own table (T 64) and a long
            one (T 1024), checked the same way, timed and printed beside
            the parent's one-block kernel's device time; timed beside the
            plain version, one PyTorch library call on the same work
            (``library_ms``, a yardstick only) and the bound the card's
            peak rates give, each twice: ``ms`` with CUDA events around 20
            back-to-back wrapper calls (the launch rate, host work
            included) and ``device_ms`` from ``torch.profiler`` (the
            kernels' own device time per call); at the training shape
            also SDPA with dropout 0.1, forward and backward (the work the
            kernels do), and the flash forward's, dQ's and dK/dV's device
            time at dropout 0 (the dropout hash's cost);
3. serve    ``ServeEngine`` on full-size GPT-2 small (bf16, random weights
            from a seed): 12 requests over 8 slots, prompts of 16-512
            tokens, 64 new tokens each; tokens/s, per-token p50/p99 and
            peak memory; asserts that every prefill went through the
            flash kernel and every decode tick through the decode kernel;
4. serve_paged  the same model on the paged pool (page_len 16, 640 pages,
            prefix cache, prefill chunks of 128): 16 requests (8 sharing a
            256-token template, two identical 300-token prompts, a 1-token
            prompt, 5 random ones) in two waves; tokens/s, TPOT and TTFT
            p50/p99, peak memory, prefix hits/misses/COW, prompt tokens
            computed against submitted; asserts 12 paged-decode launches
            per decode tick, 12 flash launches per prefill with no cached
            prefix, and the pool's free pages after the run equal to its
            start less the pages the prefix cache holds;
5. serve_spec   the serve phase's 12 requests with speculate_k 4 and a
            2-layer draft cut from the target (its embeddings, final norm
            and blocks 0-1), on the slot cache and on the paged pool;
            tokens/s, tokens per target pass, TPOT; asserts 12 multi-query
            launches (slot: ``decode_multi``, paged:
            ``decode_paged_multi``) and 2 x 5 draft ``decode_attention``
            launches per verify pass;
6. serve_quant  the serve_paged phase's engine and 16 requests with
            ``quantization: {"weights": "int8", "kv": "int8"}``: the same
            figures, plus param_bytes, kv_bytes and peak memory beside
            serve_paged's; asserts 12 int8 paged-decode launches per tick
            and none of the fp arm, and the free pages as in serve_paged;
7. serve_quant_capacity  the bf16 pool and the int8 pool (kv int8) in
            the same KV bytes (4 slots x 64 tokens of bf16 KV; page_len
            16, 64 slots): 96 requests all due at once, every 4th long (3
            pages) and the rest short (1 page); prints each pool's highest
            concurrency, asserts the int8 pool's kv_bytes are no more, no
            kv_capacity finish, and more requests at once on int8;
8. serve_quant_spec  the serve_spec paged arm on the int8 pool with int8
            target and draft weights; asserts 12 int8 paged multi-query
            launches and 2 x 5 draft ``decode_attention`` launches per
            verify pass;
9. parity   the serve phase's 12 requests in fp32 on the dense path
            (``attn_impl="dense"``, ``decode_impl="dense"``) against the
            kernel path, the paged kernel path, and the speculative path
            on both caches: greedy streams must be equal, a flip allowed
            only on a near tie (top-2 logit gap below 1e-3), each reported
            with its gap; then with int8 weights and pool, the paged
            kernel path and the speculative paged path against the int8
            dense path, and the speculative against the non-speculative,
            under the same rule; the int8 streams' token agreement with
            the fp dense path is reported;
10. train    ``deepspeed_tpu_torch.initialize`` on full-size GPT-2 small
            (bf16, dropout 0.1 everywhere, ``remat="block"``, random
            weights from a seed), micro-batch 8 x 1024 tokens, gradient
            accumulation 2, Adam, clipping 1.0: 2 warm-up steps, then 8
            timed steps on one batch; every loss finite and the last below
            the first; step ms, tokens/s and peak memory; asserts that
            every step launched the flash forward 2 x 12 x 2 times (forward
            and recompute) and each backward kernel 12 x 2 times;
11. train parity  fp32 (TF32 off), width 768 at 4 layers, dropout 0: the
            kernel path against the dense path (``attn_impl="dense"``) on
            the same params and tokens, the first step's attention-weight
            gradients within 1e-3 (max relative) and 5 steps' losses within
            1e-4 (relative);
12. sparse_kernels  (run right after the kernels phase) the block-sparse
            forward, dQ and dK/dV kernels against their plain versions at
            [2, 16, 4096, 64] on five layouts: Fixed block 16 with the
            ``ds_config`` defaults, BigBird block 64 (both head-uniform),
            per-head BigBird at blocks 32 and 16 (block 16: the rows of
            one group of the tensor-core kernels differ, so their unions
            and member masks are exercised), and Fixed with an empty query
            block row and key block column (exact zeros, no NaN);
            tolerances as in phase 2, and the bf16 forward within one bf16
            ulp + 1e-4 elementwise; timed on the Fixed layout beside the
            plain versions, SDPA with the layout as a token mask (forward;
            the backward alone, the dQ and dK/dV rows' yardstick; forward
            plus backward) and the bound of the active blocks' work;
13. sparse  ``BertSparseSelfAttention`` at BERT-large's width (d 1024, 16
            heads, Fixed layout) over B 2 x T 4096, bf16, weights from a
            seed: forward and backward through autograd, 2 warm-up and 5
            timed iterations (queued under sync debug mode 'error': no
            host sync); ms, tokens/s and peak memory; asserts one
            launch of each block-sparse kernel per iteration; then the
            gather path (an all-zero additive key padding mask, which must
            launch no block-sparse kernel) against the kernel path, within
            2e-2 of the largest output magnitude;
14. bert_train  ``deepspeed_tpu_torch.initialize`` on BERT-large (24
            layers, d 1024, 16 heads, vocab 30522), bf16, dropout 0.1,
            ``remat="block"``, LAMB lr 1e-3, micro-batch 8 x 512 MLM + NSP
            tokens by BERT's masking recipe with a quarter of the rows
            right-padded: 2 warm-up and 4 timed steps on one batch (no host
            sync, as in phase 10); losses finite and falling; step ms,
            tokens/s, peak memory; asserts
            2 x 24 flash forward launches (forward and recompute) and 24 of
            each backward kernel per step; then the same model with
            progressive layer drop (theta 0.5, gamma 1) for 2 steps with no
            host sync: fewer than 24 layer passes per step, each dropped
            layer launching no flash kernel;
15. bert parity  fp32 (TF32 off), width 1024 at 4 layers, dropout 0: the
            flash path against ``attn_impl="dense"`` on the same params and
            padded batch, first-step attention-weight gradients within 1e-3
            (max relative) and 5 LAMB steps' losses within 1e-4 (relative);
16. serve_kv_tier  (run after serve_quant_spec) the serve_paged engine
            with ``serving.kv_tier`` (idle_park_ticks 1, 8 host pages, the
            rest in page files under a temporary directory): 4 sessions
            sharing a 256-token template, idle ticks until every prefix-
            cache page has parked, then their next turns and 2 more
            sharers, 16 new tokens each; bf16, then the int8 pool; the
            streams must equal the same run's with the tier off token for
            token, pages must park, land in page files and resume, and
            the paged decode kernel (the int8 arm on the int8 pool) must
            launch; prints parked/resumed pages, the prompt tokens wave 2
            recomputed and the resume p99;
17. checkpoint  (run after train parity) phase 10's engine and config:
            3 steps, a synchronous save, 3 more steps; a fresh engine of
            another seed loads it and trains the same 3 batches — the
            losses must equal bitwise; then an async save while 2 steps
            run, drained by ``close()`` (``latest`` names it); one byte
            of its largest leaf flipped, ``load_checkpoint(tag=None)``
            must fall back to the older tag; prints the checkpoint's
            bytes and the save and load wall times beside the card's name
            and power limit.  Both write under ``tempfile`` directories
            they remove;
18. sampler  (run after the kernels phases) the samplers on the card at
            GPT-2's vocabulary (50257), under sync debug mode 'error' (no
            host sync): ``select_next_token`` at temperature 0.8, 65,536
            draws of one Zipf-shaped logits row, chi-square against its
            softmax over the bins of expected count >= 5 (the rest
            pooled), p >= 1e-3; ``rejection_sample_accept`` at S 8, k 4
            over 4,096 calls with drafts drawn from the draft's softmax:
            the mean accepted length against its closed form
            sum_i prod_{j<=i} sum min(p_j, q_j) (z-test) and the first
            emitted token against the target's softmax, same bar; one
            seed's outputs bitwise equal twice; their times at the
            serving shape;
19. serve_sample  (run after serve_kv_tier) the serve phase's 12
            requests at temperature 0.8 on the slot cache and on the
            paged pool, then with speculate_k 4 and the 2-layer draft on
            both (rejection-sampling acceptance): the launches per
            prefill, tick and pass of serve, serve_paged and serve_spec;
            every request its 64 tokens; a second engine of the seed
            streams the same tokens bit for bit, and they are not the
            greedy streams; tokens/s, TPOT, tokens per target pass;
20. serve_lora  serve_paged's engine and load with ``serving.lora``
            (rank 16, alpha 32, all four targets, 4 device pool slots,
            8 adapters at most), the 16 requests over tenants 0-6 so
            adapters fault and evict: 12 paged-decode launches a decode
            tick; every request on tenant 0 streams serve_paged's
            lora-off tokens bit for bit; in fp32 (TF32 off) each
            tenant's greedy streams equal a lora-off engine's on
            ``merge_adapter``'s dense-merged weights on the dense path
            (near-tie rule); then int8 weights and pool (the int8 arm
            launches; tenant 0 equals serve_quant's streams) and
            speculate_k 4 (the paged multi-query kernel); tokens/s and
            TPOT beside serve_paged's, adapter hits, faults, evictions
            and bytes;
21. serve_telemetry  serve_lora's bf16 run (plain and speculative) and
            serve_kv_tier's bf16 run with ``telemetry.enabled`` into
            temporary directories: streams equal to the runs without
            it; ``summarize`` of each events.jsonl gives the adapter,
            prefix, speculation and KV-tier scalars equal to the
            engines' own counters; trace.json and metrics.prom parse;
            under sync debug mode 'warn' the plain run makes as many
            synchronizing calls with telemetry as without; tokens/s with
            and without.
22. fleet  (run after serve) the serving fleet (``FleetRouter``, replica
            subprocesses of GPT-2 small with flash prefill on serve's slot
            cache, random weights from the seed; the kernel libraries are
            built before any replica spawns): fp32, a 1-replica fleet's
            streams against a bare engine of the seed (near-tie rule);
            bf16, 2 replicas over serve's 12 requests twice: the JSQ
            split, tokens/s and TTFT/TPOT p50/p99 beside a bare engine's;
            a replica killed once it streams: unstarted requests fail over,
            started ones fail typed ``ReplicaFailure``, none is lost from
            the ledger, the replica respawns; launches from each
            replica's ``launches.json`` (its warm request included);
23. fleet_disagg  (run after serve_paged) a prefill replica and a decode
            replica on serve_paged's pool: fp32 streams against a bare
            paged engine (near-tie rule), one migration a request and a
            balanced custody ledger (one router and one decode record a
            request); the decode replica killed mid-stream loses no
            request and respawns; the bytes of one page and the
            engine-level migration rate (export, adopt) of a 512-token
            prompt, fp32 and bf16;
24. train_telemetry  (run after checkpoint) phase 10's engine and config,
            three runs of 4 steps on the same batches: (a) telemetry off,
            (b) telemetry, tensorboard and the heartbeat on with an async
            save after step 2, (c) (b) plus ``wall_clock_breakdown`` and a
            profiler window over steps 2-3: the losses of (b) and (c)
            equal (a)'s bitwise; (b)'s ``train_batch`` calls make as many
            synchronizing calls as (a)'s (sync debug mode 'warn', (c)'s
            printed); summarize reports the steps and samples trained and
            one checkpoint save; trace.json holds the train/* and
            checkpoint/* spans, the profiler's Chrome trace the three
            flash kernels; a flight record dumped on demand parses; the
            step walls and the timers' per-phase ms printed.
25. train_zero  (run last) data parallelism and ZeRO on
            ``torch.distributed``: the script sets the env contract
            (``MASTER_ADDR`` 127.0.0.1, a free ``MASTER_PORT``, ``RANK``
            0, ``WORLD_SIZE`` 1) and ``initialize()`` joins a real NCCL
            process group of one rank; phase 10's model and config
            (GPT-2 small, 8 x 1024 tokens, accumulation 2, bf16, dropout
            0.1, remat block) at ZeRO stages 0, 1, 2 and 3, 1 + 4 steps
            each: the losses of stages 1-3 equal stage 0's bitwise (at one
            rank every collective is a one-rank NCCL call and every value
            the same), flash launches 2·L·A, L·A and L·A a step, no host
            sync in the 4 steps (sync debug mode 'error'), a
            ``torch.profiler`` trace of one stage-3 step holds the c10d
            ``nccl:*`` ranges (their device work printed), step ms and
            peak memory a stage; then BERT-large with LAMB at stage 1
            (``examples/bert_pretrain.py``'s configuration) and at stage
            0, 1 + 3 steps each: losses finite, falling and bitwise equal;
            then whether NCCL takes two ranks on the one card (two
            processes, printed, never a failure: the answer is a fact of
            the machine).  The process group is destroyed and the env
            restored after.
26. train_pipe  (after train_zero) pipeline parallelism through
            ``initialize(model=PipelineModule)``: GPT-2 small at full
            width and depth, 8 micro-batches of 1 x 1024 tokens, dropout
            0.1, Adam, clipping 1.0, every arm from one weight tree (the
            pp-1 module's init at the seed).  (a) pp 1 on a one-rank NCCL
            group: 1 + 4 bf16 steps under 1F1B and under GPipe, losses
            equal (whether bitwise printed); fp32, 1 + 2 steps; fp32 at
            dropout 0 with the kernels against the dense attention,
            within 1e-4; flash launches 2·L·M, L·M and L·M a step (the
            stage body recomputed in the backward).  (c) BERT-large bf16
            through ``build_bert_pipe`` with LAMB, 4 micro-batches of 2 x
            512, 1 + 1 steps: finite, launches 2·24·4, 24·4, 24·4.  (b)
            pp 2: two processes on cuda:0 over a gloo group (NCCL takes
            no two ranks on one card), each one stage, building the same
            tree (its digest checked): 1 + 2 fp32 and bf16 1F1B steps,
            the fp32 losses within 1e-5 relative of (a)'s, the first bf16
            loss within 1e-2 of (a)'s, each rank's launches half of (a)'s;
            each rank's step ms, peak MiB, point-to-point calls, bytes,
            wait and staging ms per step (boundary tensors staged through
            pinned host buffers) and the boundary inputs it held, beside
            the card's name and power limit.
27. train_seq  (after train_pipe) sequence parallelism through
            ``initialize()`` on a mesh with a seq axis of 2: GPT-2 small
            at full width and depth on train_pipe's batch (8 micro-batches
            of 1 x 1024 tokens), dropout 0.1, Adam, clipping 1.0, no
            remat, 1 + 3 steps, every arm from one weight tree (the
            model's init at the seed on the CPU).  Two processes on
            cuda:0 over a gloo group (NCCL takes no two ranks on one
            card), each holding 512 tokens of every row, build the same
            tree (its digest checked) and train Ulysses (the flash
            kernels over 6 of the 12 heads of the whole sequence) at
            fp32 and bf16 and ring attention at fp32: the two ranks'
            losses equal; the fp32 losses within 1e-5 relative of sp 1's
            with the same ``attn_impl`` (the dense attention with the
            same hashed mask) and Ulysses' first bf16 loss within 1e-2;
            Ulysses' flash launches L·M, L·M and L·M a step on each
            rank, ring's none; each rank's
            step ms, peak MiB and the seq collectives' calls, bytes,
            host stagings and ms per step printed beside the sp-1
            flash engine's losses and the card's name and power limit.
28. train_moe  (after train_seq) expert parallelism through
            ``initialize()``: GPT-2 small at full width and depth with 8
            experts on every second block (6 MoE layers, top-2, capacity
            factor 1.25, aux 1e-2, z-loss 1e-3, ~323 M parameters),
            train_pipe's batch, dropout 0.1, Adam, clipping 1.0, the
            flash kernels: (a) bf16, ZeRO 2, remat block, ep 1 in a
            one-rank NCCL group, 3 steps: losses finite and falling,
            flash launches 2·L·M, L·M and L·M a step and the expert
            exchange's calls and bytes a step equal to the ones worked
            out from ``[E, rows, C, d]``; (b) fp32, the einsum and the
            scatter dispatch: one layer at full width on the same inputs,
            y and every gradient within 1e-5 normwise, then the two
            engines on one weight tree (micro-batches of 2 rows, Adam eps
            1e-3), losses within 1e-3 relative (fp32 rounding flips
            routing near-ties over 8192 tokens); (c) ep 2 as two
            processes on cuda:0 over gloo (``moe_rank``), fp32, 4 experts
            each: the weight digest checked, one layer on the rank's
            experts and row against the whole layer within 1e-5
            normwise, the engines' losses within 1e-3 of (b)'s einsum
            engine, the exchange's calls, bytes and host stagings a step
            equal to the shapes'; step ms, peak MiB and the card's name
            and power limit printed.
29. serve_mesh  (after train_moe) ``ServeEngine(mesh=...)`` on a real
            NCCL process group of one rank (the env contract as
            train_zero's): GPT-2 small bf16 on the slot cache, the paged
            pool, the int8 weights and pool and speculation on both caches
            (k 4, the 2-layer draft), 8 of serve's requests x 32 tokens
            each, every
            arm beside the same engine with no mesh: the streams equal
            bit for bit, the decode ticks and every kernel's launches
            equal, the mesh run's tokens/s printed beside;
30. train_offload  ZeRO-Offload's host tier on phase 10's model (GPT-2
            small bf16, 8 x 1024 tokens, accumulation 2, dropout 0.1,
            remat block), ZeRO stage 2 with ``cpu_offload``, 1 + 5 steps
            from a loader: (a) the pipelined upload with ``data_prefetch``
            depth 2, (b) the same inline (``DS_PREFETCH=0``), (c) the
            serial upload inline: (a), (b) and (c) bitwise equal; (d) the
            delayed update, losses finite; (e) the plain stage-2 engine,
            (a)'s losses within 1e-4 relative of its, (a)'s fp32 master
            within 1e-4 of (e)'s travel after the first step and 5e-2
            after the window, (d)'s first loss within 1e-4 and its master
            after its first applied update within 1e-4; the host Adam
            native, its OpenMP threads and torch's printed; one
            synchronizing call a step (the overflow flag, sync debug mode
            'warn'); step ms, D2H and H2D GB/s, host Adam ms, the overlap
            ratio, the device idle share of a profiled step and peak
            device MiB against (e)'s; then GPT-2 XL (1.5B, 48 layers,
            micro-batch 1 x 1024) with the host tier, 1 + 3 steps: the
            host bytes of its fp32 master and moments, peak device MiB
            and the same breakdown.
31. train_offload_disk  the disk tier (``offload.tier: "disk"``) on
            30's model and batches, fsync on, the state under a temporary
            directory on the local disk: the pipelined read-ahead and
            write-back (prefetch 2), 1 + 5 steps: losses, the fp32 master
            and the compute copy on the card bitwise 30's (a); the serial
            loop, 1 + 2 steps, bitwise the pipelined loop's losses and
            master at its step 2; the Adam
            native, the resident state window within the io_depth
            budget; the filesystem and its free bytes, the read and
            write GB/s, the overlap ratio and the step ms printed.
32. train_offload_xla  the XLA tier (``offload_impl: "xla"``, the
            pinned host pieces updated on the card) on the same model and
            batches, 1 + 5 steps each: (f) the fused update, its losses
            within 1e-4 relative of 30's plain engine and its master after
            step 0 within 1e-4 of the plain engine's travel; (g) gradient
            chunks 2 and (h) the split update, each bitwise (f); (i) the
            delayed update, finite, its first loss bitwise (f)'s; (j)
            ZeRO-3 in a one-rank NCCL group, bitwise (f); the step ms, the
            H2D and D2H GB/s of the update, the idle share of a profiled
            step and peak device MiB against 30's (a); then GPT-2 XL
            (micro-batch 1 x 1024) on the tier with ``param_streaming``,
            ``stream_scan`` and the split update, 1 + 3 steps: the pinned
            host bytes, peak device MiB against 30's XL host tier, the
            step ms and the layer fetches' GB/s, and the compute copy on
            the card == bf16 of the pinned master on every leaf that does
            not stream.
33. train_onebit  (after train_moe) compressed data parallelism
            through ``initialize()``: (a) phase 10's model and batch with
            1-bit Adam (bf16, ZeRO 0, freeze step 2, clipping 1.0) in a
            one-rank NCCL group, 4 steps: losses finite, flash launches
            2·L·A, L·A and L·A a step, the master after the 2 warm steps
            within 1e-6 (leaf by leaf) of an Adam engine's without bias
            correction on the same tree and batch, ν bitwise unchanged
            after the freeze, the error buffers nonzero, no compressed
            collective called (the simulated exchange); (b) dp 2 as two
            processes on cuda:0 over gloo (``onebit_rank``), fp32,
            dropout 0, freeze step 1, 3 steps on train_pipe's batch: the
            first loss within 1e-5 of an fp32 dp-1 engine's on the same
            tree (its digest checked) and global batch, the two ranks'
            masters bitwise equal after every step, rank 0's first
            frozen exchange (the leaves of at most 8M elements) within
            1e-6 of a numpy version of the two-phase algorithm on both
            ranks' μ and errors (a sign flip only on a near-tie, |buf| <
            1e-5·scale, reported), a frozen step's uint8 bytes those of
            the leaves' ``padded_size``s with no float collective over
            4·dp elements, the warm step's fp32 reduction covering the
            largest leaf; (c) CSR gradients on the same processes: GPT-2
            small's embedding table [50257, 768] mean-pooled into a head
            (``EmbedPool``), 8 x 1024 tokens a rank, fp32, 3 steps: the
            sparse engine's losses within 1e-5 of the dense engine's, no
            collective as large as the table, the indices' and values'
            bytes those of the tokens; each arm's step ms and wire bytes
            beside the card's name and power limit.

Every phase that drives a path sets the launch counts to 0 just before it
and reads them just after; the kernels line carries each kernel's
launches by phase and their sum.  Each phase's wall time is printed
(``[wall]``).
Then one ``{"kernels": [...]}`` line and, last, the run's result line.
Without a CUDA device, or without the package beside this file, it exits
non-zero and prints no result.
"""
import contextlib
import gc
import io
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
#: the kernels of the kernels line; the int8 pool arms are built from the
#: sources of their fp arms (csrc/decode_paged.cu, decode_paged_multi.cu)
KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "decode_attention",
           "decode_paged", "decode_paged_int8", "decode_multi",
           "decode_paged_multi", "decode_paged_multi_int8",
           "block_sparse_fwd", "block_sparse_bwd_dq", "block_sparse_bwd_dkv")
SOURCES = tuple(n for n in KERNELS if not n.endswith("_int8"))
#: the sources whose bf16/fp16 arms run on the tensor cores, and the SASS
#: instruction their libraries must hold: HGMMA for wgmma, HMMA for
#: mma.sync (``HGMMA`` does not contain ``HMMA``)
TENSOR_CORE_SOURCES = {"flash_fwd": "HGMMA", "flash_bwd_dq": "HGMMA",
                       "flash_bwd_dkv": "HGMMA", "block_sparse_fwd": "HMMA",
                       "block_sparse_bwd_dq": "HMMA",
                       "block_sparse_bwd_dkv": "HMMA",
                       "decode_attention": "HMMA", "decode_multi": "HMMA",
                       "decode_paged": "HMMA", "decode_paged_multi": "HMMA"}
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
#: the sparse path: BertSparseSelfAttention at BERT-large's width
SPARSE_SHAPE = (2, 16, 4096, 64)
SPARSE_WARM, SPARSE_ITERS = 2, 5
#: the BERT-large training path: micro-batch 8 x 512 tokens
BERT_MICRO, BERT_SEQ, BERT_WARM, BERT_STEPS = 8, 512, 2, 4
BERT_PLD_STEPS = 2
MASK_TOKEN = 103   # BERT's [MASK] id
#: the serving phases' engine configs
SLOT_CFG = {"slots": 8, "max_seq_len": 1024, "prefill_len": 512}
PAGED_CFG = {**SLOT_CFG, "page_len": 16, "pages": 640, "prefix_cache": True,
             "prefill_chunk_len": 128}
DRAFT_LAYERS = 2
#: the capacity leg's decode width: slots, heads, page_len, most keys a
#: row (3 pages), and the table columns timed: the leg's own (T 64,
#: max_seq_len 64) and a long table (T 1024)
CAPACITY_DECODE = (64, 12, 16, 48)
CAPACITY_COLS = (4, 64)
#: device ms of the single-query paged arms at those widths, by table
#: columns, before the split kernel (decode_common.cuh's rows_kernel then
#: ran every arm, one block a (slot, head)): the mean of eight parent runs
#: in turns with this tree's kernels over four calls
#: (profile_decode_torch.py; PERF.md section 6, NVIDIA H100 80GB HBM3,
#: 700 W); printed beside this run's times, never compared
PARENT_CAPACITY_MS = {("decode_paged", 4): 0.0066,
                      ("decode_paged_int8", 4): 0.0069,
                      ("decode_paged", 64): 0.0066,
                      ("decode_paged_int8", 64): 0.0069}
#: the quantized serving plane, both arms on
QUANT = {"weights": "int8", "kv": "int8"}
SPEC = {"speculate_k": 4,
        "draft": {"d_model": 768, "n_layer": DRAFT_LAYERS, "n_head": 12}}
#: the KV tier: park after one idle tick, eight pages on the host, the
#: rest in page files; the kv_tier phase's requests are shorter than the
#: others' (a few sessions of a few tokens show parking and resume)
KV_TIER = {"idle_park_ticks": 1, "host_budget_pages": 8}
KV_NEW_TOKENS, KV_IDLE_TICKS = 16, 400
#: checkpoint phase: steps before the save and after it (the resume's)
CKPT_STEPS = 3
#: train_telemetry: steps in each of its three runs
TEL_STEPS = 4
#: the fleets' liveness bounds: a replica imports torch, initializes CUDA
#: and GPT-2 small and serves its warm request (loading the kernel
#: libraries phase_build built) before hello; after hello it beats every
#: 0.1 s between ticks
FLEET_SPAWN_TIMEOUT_S, FLEET_HEARTBEAT_TIMEOUT_S = 300.0, 60.0
#: sampling: the serving temperature; the sampler phase's draws of one
#: logits row (in chunks of rows) and its rejection-sampling calls at S 8
TEMPERATURE = 0.8
SAMPLER_DRAWS, SAMPLER_CHUNK, SAMPLER_CALLS = 65536, 4096, 4096
#: the statistical checks' bar: a chi-square or z-test p of at least this
P_MIN = 1e-3
#: multi-tenant LoRA (serve_lora): rank 16, all four targets, 4 device
#: pool slots for the 6 tenants 1-6 (tenant 0 is the base model)
LORA = {"rank": 16, "alpha": 32.0, "hbm_adapter_slots": 4,
        "max_adapters": 8, "targets": ["qkv_w", "out_w", "fc_w", "proj_w"]}
LORA_TENANTS = 7



def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()


#: how ``device_ms`` (and ``plain_device_ms``, ``library_device_ms``) are
#: read
DEVICE_MS_METHOD = ("torch.profiler: the CUDA kernels' own durations "
                    "summed over 20 back-to-back calls (5 for the "
                    "block-sparse plain versions), per call")


def print_row(tag: str, label: str, r: dict, prefix: str = "") -> None:
    """One kernel row's times: wrapper rate and device time of the kernel,
    its plain version and its library call, and the bound."""
    g = lambda k: r[prefix + k]  # noqa: E731
    lib = (f", library {g('library_ms'):.4f} ms (device "
           f"{g('library_device_ms'):.4f})"
           if r.get(prefix + "library_ms") is not None else "")
    print(f"{tag} {label}: {g('ms'):.4f} ms (device {g('device_ms'):.4f}), "
          f"plain {g('plain_ms'):.4f} ms (device "
          f"{g('plain_device_ms'):.4f}){lib}, bound {g('bound_ms'):.5f} ms "
          f"({g('bound_by')})")


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


def device_ms(fn, iters: int = 20) -> float:
    """Device time of one call: the durations of the CUDA kernels (and
    device copies) that ``iters`` back-to-back calls ran, summed under
    ``torch.profiler`` and divided by ``iters`` — no host time and no gap
    between launches, unlike :func:`time_ms`."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    fullest = 0.0
    # a window that recorded nothing, or lost some of its calls' kernels
    # (a kernel seen a number of times that is no multiple of iters), is
    # taken again; after 3 the fullest is kept
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        evs = [ev for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA]
        us = sum(getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
                 for ev in evs)
        if us > 0 and all(ev.count % iters == 0 for ev in evs):
            return us / iters / 1e3
        fullest = max(fullest, us)
    if fullest > 0:
        print(f"chip_smoke: device_ms: no window of {iters} calls held "
              "every call's kernels; the fullest is kept", file=sys.stderr)
        return fullest / iters / 1e3
    fail("device_ms: the profiler recorded no device time in 3 windows")


def timings(run, plain, lib=None, iters: int = 20,
            plain_iters: int = 20) -> dict:
    """A kernel row's times: the wrapper's launch rate (``ms``, CUDA
    events around back-to-back calls) and the device time (``device_ms``)
    of the kernel, its plain version and, where given, the library
    call."""
    out = {"ms": time_ms(run, iters), "device_ms": device_ms(run, iters),
           "plain_ms": time_ms(plain, plain_iters),
           "plain_device_ms": device_ms(plain, plain_iters)}
    if lib is not None:
        out["library_ms"] = time_ms(lib, iters)
        out["library_device_ms"] = device_ms(lib, iters)
    return out


def bound_ms(nbytes: int, flops: int, dtype: str):
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS_S[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def sass_count(name: str, ops=("HGMMA", "HMMA")) -> dict:
    """Instructions of each of ``ops`` in the built library of
    ``csrc/<name>.cu`` (``cuobjdump -sass``)."""
    from deepspeed_tpu_torch.ops.kernels import build
    tool = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", build._target(name)[1]],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout.splitlines()
    return {op: sum(1 for line in sass if op in line) for op in ops}


def phase_build():
    from deepspeed_tpu_torch.ops.kernels import build
    t0 = time.perf_counter()
    logs = build.build(SOURCES, verbose=True, force=True)
    print(f"[build] nvcc for sm_90a, {len(logs)} sources in parallel: "
          f"{time.perf_counter() - t0:.1f} s")
    for name in SOURCES:
        for line in logs[name].splitlines():
            if ("ptxas" in line and ("registers" in line or "smem" in line
                                     or "Compiling" in line)
                    or "spill" in line):
                print(f"[build] {name}: {line.strip()}")
        n = sass_count(name)
        print(f"[build] {name}: {n['HGMMA']} HGMMA (wgmma) and {n['HMMA']} "
              "HMMA (mma.sync) instructions (cuobjdump -sass)")
        op = TENSOR_CORE_SOURCES.get(name)
        if op is not None and n[op] == 0:
            fail(f"csrc/{name}.cu: no {op} instruction in its library: "
                 "the tensor-core arms did not compile to "
                 f"{'wgmma' if op == 'HGMMA' else 'mma.sync'}")


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
        "max_abs_err": err_main, "device_ms_method": DEVICE_MS_METHOD,
        **timings(lambda: flash_attention_cuda(q, k, v, True, scale),
                  lambda: flash_attention_plain(q, k, v, True, scale),
                  lambda: F.scaled_dot_product_attention(
                      q, k, v, is_causal=True)),
        "bound_ms": bms, "bound_by": by,
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
        "source": "deepspeed_tpu_torch/csrc/decode_attention.cu + "
                  "deepspeed_tpu_torch/csrc/decode_split.cuh",
        "replaces": "deepspeed_tpu/ops/pallas/decode_attention.py:114",
        "max_abs_err": err_main, "device_ms_method": DEVICE_MS_METHOD,
        **timings(lambda: decode_attention_cuda(q, k, v, lengths, dscale),
                  lambda: decode_attention_plain(q, k, v, lengths, dscale),
                  lambda: F.scaled_dot_product_attention(
                      q[:, :, None], k, v, attn_mask=mask)),
        "bound_ms": bms, "bound_by": by,
    }
    for r in results.values():
        print_row("[kernels]", r["name"] + " bf16", r)
    return results


def _paged_pool(cache, lengths, page_len, pool_pages):
    """The rows of a slot cache [S, H, T, D] as a page pool [P, H,
    page_len, D] and an int32 table [S, T // page_len]: each slot's live
    pages (for its longest row) at permuted page ids, everything else,
    dead table entries' scratch page 0 included, garbage."""
    import torch
    S, H, T, D = cache.shape
    M = T // page_len
    need = ((lengths.reshape(S, -1).amax(1) + page_len - 1)
            // page_len).tolist()
    ids = (torch.randperm(pool_pages - 1, generator=torch.Generator()
                          .manual_seed(SEED)) + 1).tolist()
    table = torch.zeros((S, M), dtype=torch.int32)
    pool = 100 * torch.randn((pool_pages, H, page_len, D),
                             generator=torch.Generator().manual_seed(SEED))
    pool = pool.to(cache.device)
    nxt = 0
    for s in range(S):
        n = need[s]
        table[s, :n] = torch.tensor(ids[nxt:nxt + n], dtype=torch.int32)
        nxt += n
        pool[table[s, :n].long()] = cache[s].reshape(
            H, M, page_len, D)[:, :n].transpose(0, 1)
    return pool, table.to(cache.device)


def decode_case(dev) -> dict:
    """The decode phase's operands at the serving shapes, fp32: the slot
    cache ``kc32``/``vc32`` [8, 12, 1024, 64], its rows as page pools
    ``kp32``/``vp32`` (page_len 16, 513 pages, a permuted ``table``),
    lengths {0, 1, 513, 1024, 77, 300, 640, 1000} (``base``), W = 5 verify
    rows at L + i + 1 (``multi_lens``; rows past the capacity masked, as
    ``_verify_rows`` does), the lengths both need (``live``) and the
    queries ``q1_32`` [8, 12, 64] and ``qw_32`` [8, 12, 5, 64]."""
    import torch
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 3)
    S, H, T, D, W, PAGE, POOL = 8, 12, 1024, 64, 5, 16, 513
    base = torch.tensor([0, 1, 513, 1024, 77, 300, 640, 1000],
                        dtype=torch.int32, device=dev)
    rows = base[:, None] + torch.arange(1, W + 1, device=dev,
                                        dtype=torch.int32)[None]
    multi_lens = torch.where((base[:, None] > 0) & (rows <= T), rows,
                             0).to(torch.int32)
    kc32, vc32 = (torch.randn((S, H, T, D), generator=g, device=dev)
                  for _ in range(2))
    # the pages the single-query lengths and the verify rows both need
    live = torch.cat([base[:, None], multi_lens], dim=1)
    kp32, table = _paged_pool(kc32, live, PAGE, POOL)
    vp32, _ = _paged_pool(vc32, live, PAGE, POOL)
    return {"base": base, "multi_lens": multi_lens, "live": live,
            "kc32": kc32, "vc32": vc32, "kp32": kp32, "vp32": vp32,
            "table": table,
            "q1_32": torch.randn((S, H, D), generator=g, device=dev),
            "qw_32": torch.randn((S, H, W, D), generator=g, device=dev)}


def capacity_case(dev, cols: int) -> dict:
    """The single-query paged arms' operands at the capacity leg's width
    (``CAPACITY_DECODE``): 64 slots x 12 heads, page_len 16, ``cols``
    table columns (T = 16 ``cols``), rows of 1-48 keys from a seed, each
    slot's 3 pages at permuted ids and its dead columns at the scratch
    page 0 (garbage); bf16 ``q`` and pools ``kp``/``vp``, and the int8
    pools ``k8``/``v8`` with scales ``ks``/``vs`` quantized from them
    (random bytes and NaN scales in every row no live row reads)."""
    import torch
    S, H, PAGE, most = CAPACITY_DECODE
    g = torch.Generator().manual_seed(SEED + 11)
    lens = torch.randint(1, most + 1, (S,), generator=g, dtype=torch.int32)
    table = torch.zeros((S, cols), dtype=torch.int32)
    table[:, :3] = (torch.randperm(3 * S, generator=g).view(S, 3) + 1).to(
        torch.int32)
    pools = []
    for _ in range(2):
        x = torch.randn((3 * S + 1, H, PAGE, 64), generator=g)
        x[0] = 100 * torch.randn((H, PAGE, 64), generator=g)
        pools.append(x.to(dev))
    table, lens = table.to(dev), lens.to(dev)
    k8, ks = _int8_pool(pools[0], table, lens, PAGE, SEED + 12)
    v8, vs = _int8_pool(pools[1], table, lens, PAGE, SEED + 13)
    q = torch.randn((S, H, 64), generator=g).to(dev, torch.bfloat16)
    return {"q": q, "kp": pools[0].bfloat16(), "vp": pools[1].bfloat16(),
            "k8": k8, "v8": v8, "ks": ks, "vs": vs, "table": table,
            "lens": lens}


def phase_decode_kernels(dev, results):
    """The paged, multi-query and paged multi-query decode kernels against
    their plain versions at the serving shapes (:func:`decode_case`);
    timed beside the plain version, a library yardstick (the pages
    gathered through the table, then masked ``scaled_dot_product_
    attention``) and the bytes bound (the live K/V rows read once, plus
    q, out, lengths and table); then the single-query paged arms at the
    capacity leg's width (:func:`phase_decode_capacity`)."""
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.kernels.decode_attention import (
        _default_scale, decode_attention_plain, decode_multi_cuda,
        decode_multi_plain, decode_paged_cuda, decode_paged_multi_cuda,
        decode_paged_multi_plain, decode_paged_plain, decode_splits,
        paged_gather)

    c = decode_case(dev)
    base, multi_lens, live, table = (c[k] for k in ("base", "multi_lens",
                                                    "live", "table"))
    kc32, vc32, kp32, vp32, q1_32, qw_32 = (
        c[k] for k in ("kc32", "vc32", "kp32", "vp32", "q1_32", "qw_32"))
    S, H, T, D = kc32.shape
    W = qw_32.shape[2]
    scale = _default_scale(D)
    # name: (kernel, plain, slot-cache plain of the same rows, paged, lens)
    cases = {
        "decode_paged": (decode_paged_cuda, decode_paged_plain,
                         decode_attention_plain, True, base),
        "decode_multi": (decode_multi_cuda, decode_multi_plain, None, False,
                         multi_lens),
        "decode_paged_multi": (decode_paged_multi_cuda,
                               decode_paged_multi_plain, decode_multi_plain,
                               True, multi_lens),
    }
    for name, n in (("decode_multi", decode_splits(T, S * H)),
                    ("decode_paged(_multi)", decode_splits(
                        table.shape[1] * kp32.shape[2], S * H))):
        print(f"[kernels] {name} bf16/fp16 at T {T}: the keys of each "
              f"(slot, head) split over {n} CUDA blocks, cluster size {n}, "
              f"{n * S * H} blocks")
    errs = {}
    for dtype in ("float32", "bfloat16"):
        tdt = getattr(torch, dtype)
        kc, vc, kp, vp = (t.to(tdt) for t in (kc32, vc32, kp32, vp32))
        for name, (cuda, plain, slot_plain, paged, lens) in cases.items():
            q = (q1_32 if name == "decode_paged" else qw_32).to(tdt)
            out = cuda(q, *((kp, vp, table) if paged else (kc, vc)), lens,
                       scale)
            torch.cuda.synchronize()
            if paged:
                ref = plain(q.float(), kp.float(), vp.float(), table, lens,
                            scale)
                # the pool holds the cache's rows: the same attention
                same = slot_plain(q.float(), kc.float(), vc.float(), lens,
                                  scale)
                if not (same - ref).abs().max().item() < 1e-5:
                    fail(f"{name}: the paged operands differ from the cache")
            else:
                ref = plain(q.float(), kc.float(), vc.float(), lens, scale)
            err = (out.float() - ref).abs().max().item()
            print(f"[kernels] {name} {dtype}: max abs err {err:.3g}")
            if not err <= TOL[dtype]:
                fail(f"{name} {dtype}: error {err} above {TOL[dtype]}")
            if not (out[0] == 0).all():
                fail(f"{name}: the length-0 slot is not exact zeros")
            if dtype == "bfloat16":
                errs[name] = err
    # timings, bf16, at the same shapes
    kc, vc, kp, vp = (t.bfloat16() for t in (kc32, vc32, kp32, vp32))
    q1, qw = q1_32.bfloat16(), qw_32.bfloat16()
    keys = torch.arange(T, device=dev)
    mask1 = (keys[None] < base[:, None])[:, None, None, :]
    maskw = (keys[None, None] < multi_lens[:, :, None])[:, None]
    # bytes: live K and V rows (the longest row's keys per slot) read
    # once, q read and out written once, the lengths and the table
    kv_b = lambda lens: int(lens.reshape(S, -1).amax(1).sum()) * H * D * 4  # noqa: E731
    qo_b = lambda w: 2 * S * H * w * D * 2  # noqa: E731
    pairs1 = int(base.sum()) * H
    pairsw = int(multi_lens.sum()) * H

    def lib_paged(q, mask):
        return F.scaled_dot_product_attention(
            q, paged_gather(kp, table), paged_gather(vp, table),
            attn_mask=mask)

    specs = {
        "decode_paged": (
            "decode_paged.cu", 308,
            lambda: decode_paged_cuda(q1, kp, vp, table, base, scale),
            lambda: decode_paged_plain(q1, kp, vp, table, base, scale),
            lambda: lib_paged(q1[:, :, None], mask1),
            kv_b(base) + qo_b(1) + table.numel() * 4 + S * 4, 4 * D * pairs1),
        "decode_multi": (
            "decode_multi.cu", 540,
            lambda: decode_multi_cuda(qw, kc, vc, multi_lens, scale),
            lambda: decode_multi_plain(qw, kc, vc, multi_lens, scale),
            lambda: F.scaled_dot_product_attention(qw, kc, vc,
                                                   attn_mask=maskw),
            kv_b(multi_lens) + qo_b(W) + S * W * 4, 4 * D * pairsw),
        "decode_paged_multi": (
            "decode_paged_multi.cu", 666,
            lambda: decode_paged_multi_cuda(qw, kp, vp, table, multi_lens,
                                            scale),
            lambda: decode_paged_multi_plain(qw, kp, vp, table, multi_lens,
                                             scale),
            lambda: lib_paged(qw, maskw),
            kv_b(multi_lens) + qo_b(W) + table.numel() * 4 + S * W * 4,
            4 * D * pairsw),
    }
    _decode_int8_kernels(dev, specs, errs, kc32, vc32, kp32, vp32, table,
                         live, base, multi_lens, q1_32, qw_32, mask1, maskw,
                         qo_b)
    for name, (src, line, run, plain, lib, nbytes, flops) in specs.items():
        bms, by = bound_ms(nbytes, flops, "bfloat16")
        results[name] = {
            "name": name, "route": "cuda",
            "source": f"deepspeed_tpu_torch/csrc/{src}",
            "replaces": f"deepspeed_tpu/ops/pallas/decode_attention.py:{line}",
            "max_abs_err": errs[name], "device_ms_method": DEVICE_MS_METHOD,
            **timings(run, plain, lib), "bound_ms": bms, "bound_by": by,
            "library_note": (
                "the int8 pages dequantized through the table "
                "(dequantize_paged, in bf16), then masked "
                "F.scaled_dot_product_attention" if name.endswith("_int8")
                else "the pages gathered through the table (paged arms), "
                     "then masked F.scaled_dot_product_attention"),
        }
        print_row("[kernels]", name + " bf16", results[name])
    phase_decode_capacity(dev, results)


def phase_decode_capacity(dev, results):
    """The single-query paged arms, fp and int8 pools, at the capacity
    leg's width (:func:`capacity_case`: 64 slots x 12 heads, rows of at
    most 3 pages) with the leg's own table (T 64, each slot's keys in one
    tile) and a long one (T 1024, where most ranks of a T-sized cluster
    would see no key): the slots alone fill the card.  Checked against
    the plain versions as at the serving shapes, timed beside them, kept
    in each kernel's row as ``capacity_t<T>``, and printed beside the
    parent's one-block kernel's time from PERF.md."""
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.kernels.decode_attention import (
        _default_scale, decode_paged_cuda, decode_paged_int8_cuda,
        decode_paged_int8_plain, decode_paged_plain, decode_splits,
        dequantize_paged, paged_gather)
    for cols in CAPACITY_COLS:
        c = capacity_case(dev, cols)
        q, kp, vp, k8, v8, ks, vs, table, lens = (
            c[k] for k in ("q", "kp", "vp", "k8", "v8", "ks", "vs", "table",
                           "lens"))
        S, H, D = q.shape
        T = cols * kp.shape[2]
        scale = _default_scale(D)
        n = decode_splits(T, S * H)
        print(f"[kernels] capacity width: {S} slots x {H} heads, T {T}, rows "
              f"of {int(lens.min())}-{int(lens.max())} keys: {n} CUDA "
              "block(s) a (slot, head)")
        mask = (torch.arange(T, device=dev)[None] < lens[:, None])[
            :, None, None, :]
        ks_l, vs_l = torch.nan_to_num(ks), torch.nan_to_num(vs)
        rows = int(lens.sum()) * H
        other_b = 2 * S * H * D * 2 + table.numel() * 4 + S * 4
        cases = {
            "decode_paged": (
                lambda: decode_paged_cuda(q, kp, vp, table, lens, scale),
                lambda: decode_paged_plain(q, kp, vp, table, lens, scale),
                lambda: F.scaled_dot_product_attention(
                    q[:, :, None], paged_gather(kp, table),
                    paged_gather(vp, table), attn_mask=mask),
                lambda: decode_paged_plain(q.float(), kp.float(), vp.float(),
                                           table, lens, scale),
                rows * 4 * D + other_b),
            "decode_paged_int8": (
                lambda: decode_paged_int8_cuda(q, k8, v8, ks, vs, table,
                                               lens, scale),
                lambda: decode_paged_int8_plain(q, k8, v8, ks, vs, table,
                                                lens, scale),
                lambda: F.scaled_dot_product_attention(
                    q[:, :, None],
                    dequantize_paged(k8, ks_l, table).bfloat16(),
                    dequantize_paged(v8, vs_l, table).bfloat16(),
                    attn_mask=mask),
                lambda: decode_paged_int8_plain(q.float(), k8, v8, ks, vs,
                                                table, lens, scale),
                rows * (2 * D + 2 * 4) + other_b),
        }
        for name, (run, plain, lib, ref32, nbytes) in cases.items():
            out = run()
            torch.cuda.synchronize()
            ref = ref32()
            err = (out.float() - ref).abs().max().item()
            ok = (_ulp_err(out, ref) <= 1.0 if name.endswith("_int8")
                  else err <= TOL["bfloat16"])
            if not (ok and torch.isfinite(out).all()):
                fail(f"{name} at the capacity width, T {T}: error {err}")
            bms, by = bound_ms(nbytes, 4 * D * rows, "bfloat16")
            row = {**timings(run, plain, lib), "bound_ms": bms,
                   "bound_by": by, "max_abs_err": err, "splits": n}
            results[name][f"capacity_t{T}"] = row
            print_row("[kernels]", f"{name} bf16 at the capacity width, T "
                      f"{T}", row)
            parent = PARENT_CAPACITY_MS[(name, cols)]
            print(f"[kernels] {name} at the capacity width, T {T}: device "
                  f"{row['device_ms']:.4f} ms; the parent's one-block "
                  f"kernel {parent:.4f} ms (PERF.md, section 6)")


def _int8_pool(pool32, table, live_lens, page_len, seed):
    """The rows of an fp32 page pool as an int8 pool and its fp32 scales,
    quantized by the port's ``quantize_rows`` from their bf16 values;
    every (page, row) that no live row reads — the scratch page 0 and the
    tails of the last live pages included — holds random bytes and a NaN
    scale, so a stray read shows."""
    import torch
    from deepspeed_tpu_torch.inference.quantize import quantize_rows
    live = torch.zeros(pool32.shape[0], page_len, dtype=torch.bool)
    tab = table.cpu().long()
    for s, n in enumerate(live_lens.reshape(tab.shape[0], -1).amax(1)
                          .tolist()):
        pos = torch.arange(n)
        live[tab[s, pos // page_len], pos % page_len] = True
    dead = (~live).to(pool32.device)
    q8, sc = quantize_rows(pool32.bfloat16())
    junk = torch.randint(-128, 128, q8.shape, dtype=torch.int8,
                         generator=torch.Generator().manual_seed(seed))
    q8 = torch.where(dead[:, None, :, None], junk.to(q8.device), q8)
    sc = torch.where(dead[:, None, :], float("nan"), sc)
    return q8.contiguous(), sc.contiguous()


def _decode_int8_kernels(dev, specs, errs, kc32, vc32, kp32, vp32, table,
                         live, base, multi_lens, q1_32, qw_32, mask1, maskw,
                         qo_b):
    """The int8 pool arms of decode_paged and decode_paged_multi (W = 5)
    on the phase's pool, its rows quantized from bf16: fp32 and bf16
    queries against the plain versions in fp32 (the live pages
    dequantized, then the plain attention) within 1e-4 (fp32) and one
    bf16 ulp + 1e-4 elementwise (bf16); the plain versions against the
    dense attention over the dequantized cache; exact zeros at length 0.
    Adds their timing specs: bytes bound of 136 B per live (head, key)
    row (2 x 64 int8 + 2 x 4 B of scale), the library yardstick being
    dequantize_paged + masked SDPA."""
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.inference.quantize import (dequantize_rows,
                                                        quantize_rows)
    from deepspeed_tpu_torch.ops.kernels.decode_attention import (
        _default_scale, decode_attention_plain, decode_multi_plain,
        decode_paged_int8_cuda, decode_paged_int8_plain,
        decode_paged_multi_int8_cuda, decode_paged_multi_int8_plain,
        dequantize_paged)
    S, H, T, D = kc32.shape
    PAGE = kp32.shape[2]
    scale = _default_scale(D)
    k8, ks = _int8_pool(kp32, table, live, PAGE, SEED + 7)
    v8, vs = _int8_pool(vp32, table, live, PAGE, SEED + 8)
    kd, vd = (dequantize_rows(*quantize_rows(c.bfloat16()))
              for c in (kc32, vc32))
    cases = {
        "decode_paged_int8": (decode_paged_int8_cuda,
                              decode_paged_int8_plain,
                              decode_attention_plain, q1_32, base),
        "decode_paged_multi_int8": (decode_paged_multi_int8_cuda,
                                    decode_paged_multi_int8_plain,
                                    decode_multi_plain, qw_32, multi_lens),
    }
    for dtype in ("float32", "bfloat16"):
        for name, (cuda, plain, dense, q32, lens) in cases.items():
            q = q32.to(getattr(torch, dtype))
            out = cuda(q, k8, v8, ks, vs, table, lens, scale)
            torch.cuda.synchronize()
            ref = plain(q.float(), k8, v8, ks, vs, table, lens, scale)
            same = dense(q.float(), kd, vd, lens, scale)
            if not (same - ref).abs().max().item() < 1e-5:
                fail(f"{name}: the int8 pool differs from the quantized "
                     "cache")
            err = (out.float() - ref).abs().max().item()
            if dtype == "float32":
                ok, what = err <= TOL[dtype], f"above {TOL[dtype]}"
            else:
                ulp = _ulp_err(out, ref)
                ok, what = ulp <= 1.0, f"{ulp:.3g} bf16 ulps (+1e-4)"
                errs[name] = err
            print(f"[kernels] {name} q {dtype}: max abs err {err:.3g}")
            if not (ok and torch.isfinite(out).all()):
                fail(f"{name} q {dtype}: error {err}, {what}")
            if not (out[0] == 0).all():
                fail(f"{name}: the length-0 slot is not exact zeros")
    q1, qw = q1_32.bfloat16(), qw_32.bfloat16()
    # the library yardstick reads the same pages; its dead columns point
    # at page 0, so it gets finite scales there
    ks_l, vs_l = torch.nan_to_num(ks), torch.nan_to_num(vs)

    def lib(q, mask):
        return F.scaled_dot_product_attention(
            q, dequantize_paged(k8, ks_l, table).bfloat16(),
            dequantize_paged(v8, vs_l, table).bfloat16(), attn_mask=mask)

    kv8_b = lambda lens: (int(lens.reshape(S, -1).amax(1).sum()) * H  # noqa: E731
                          * (2 * D + 2 * 4))
    specs["decode_paged_int8"] = (
        "decode_paged.cu", 308,
        lambda: decode_paged_int8_cuda(q1, k8, v8, ks, vs, table, base,
                                       scale),
        lambda: decode_paged_int8_plain(q1, k8, v8, ks, vs, table, base,
                                        scale),
        lambda: lib(q1[:, :, None], mask1),
        kv8_b(base) + qo_b(1) + table.numel() * 4 + S * 4,
        4 * D * int(base.sum()) * H)
    specs["decode_paged_multi_int8"] = (
        "decode_paged_multi.cu", 666,
        lambda: decode_paged_multi_int8_cuda(qw, k8, v8, ks, vs, table,
                                             multi_lens, scale),
        lambda: decode_paged_multi_int8_plain(qw, k8, v8, ks, vs, table,
                                              multi_lens, scale),
        lambda: lib(qw, maskw),
        kv8_b(multi_lens) + qo_b(multi_lens.shape[1]) + table.numel() * 4
        + multi_lens.numel() * 4,
        4 * D * int(multi_lens.sum()) * H)


def _rel_err(got, want) -> float:
    """max abs error, relative to the largest magnitude when it exceeds 1."""
    return ((got.float() - want).abs().max()
            / max(1.0, want.abs().max().item())).item()


def _ulp_err(got, want) -> float:
    """max |got - want| over (one bf16 ulp of want + the fp32 tolerance):
    at most 1 when got is fp32 work on the same inputs rounded to bf16."""
    return ((got.float() - want).abs()
            / (want.abs() * 2.0 ** -7 + TOL["float32"])).max().item()


def _bert_flash_case(dev):
    """The flash kernels at the bert_train phase's call against their plain
    versions: [8, 16, 512, 64], non-causal, dropout 0.1, and the [B, T]
    additive key mask that the transformer layer's ``_key_mask_rows``
    builds from a padded MLM batch (fp32 and bf16).  The padded keys' dK
    and dV must be exact zeros.  Returns the bf16 dQ and dK/dV kernels'
    device ms at this call, by name, and the call's shape."""
    import torch
    from deepspeed_tpu_torch.models.bert import BERT_LARGE
    from deepspeed_tpu_torch.ops.kernels.flash_attention import (
        flash_attention_cuda, flash_attention_plain, flash_bwd_dkv_cuda,
        flash_bwd_dkv_plain, flash_bwd_dq_cuda, flash_bwd_dq_plain)
    from deepspeed_tpu_torch.ops.transformer import DeepSpeedTransformerLayer

    B, T = BERT_MICRO, BERT_SEQ
    H = BERT_LARGE.num_attention_heads
    D = BERT_LARGE.hidden_size // H
    scale = D ** -0.5
    att = torch.from_numpy(mlm_batch(B, T, BERT_LARGE.vocab_size, SEED)[
        "attention_mask"]).to(dev)
    # the additive mask as BertModel.encode builds it, then the kernels'
    # [B·H, T] rows
    add = (1.0 - att.float())[:, None, None, :] * -10000.0
    km = DeepSpeedTransformerLayer._key_mask_rows(add, B, H, T)
    km = km[:, None].expand(B, H, T).reshape(B * H, T).contiguous()
    pad = att == 0
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 2)
    q32, k32, v32, do32 = (torch.randn((B, H, T, D), generator=g,
                                       device=dev) for _ in range(4))
    args = (False, scale, None, km, 0.1, 0xB5297A4D, None)
    label = (f"[{B}, {H}, {T}, {D}] non-causal dropout 0.1 BERT key mask "
             f"({int(pad.any(1).sum())} padded rows)")
    for dtype in ("float32", "bfloat16"):
        tdt = getattr(torch, dtype)
        q, k, v, do = (t.to(tdt) for t in (q32, k32, v32, do32))
        f32 = (q.float(), k.float(), v.float())
        out, lse = flash_attention_cuda(q, k, v, *args)
        torch.cuda.synchronize()
        ref, ref_lse = flash_attention_plain(*f32, *args)
        err = (out.float() - ref).abs().max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        ulp = _ulp_err(out, ref)
        delta = (do.float() * ref).sum(-1)
        dq = flash_bwd_dq_cuda(q, k, v, do, ref_lse, delta, *args)
        dk, dv = flash_bwd_dkv_cuda(q, k, v, do, ref_lse, delta, *args)
        torch.cuda.synchronize()
        plain = (*f32, do.float(), ref_lse, delta)
        e_dq = _rel_err(dq, flash_bwd_dq_plain(*plain, *args))
        rdk, rdv = flash_bwd_dkv_plain(*plain, *args)
        e_dkv = max(_rel_err(dk, rdk), _rel_err(dv, rdv))
        print(f"[kernels] flash {dtype} {label}: fwd err {err:.3g} (lse "
              f"{lse_err:.3g}; {ulp:.3g} of one bf16 ulp + 1e-4), dq err "
              f"{e_dq:.3g}, dk/dv err {e_dkv:.3g}")
        if not (max(err, lse_err, e_dq, e_dkv) <= TOL[dtype]
                and (dtype == "float32" or ulp <= 1.0)):
            fail(f"flash kernels {dtype} {label}: errors {err} / {lse_err} "
                 f"/ {e_dq} / {e_dkv} above {TOL[dtype]}, or forward "
                 f"{ulp} ulp-relative above 1")
        if not all(torch.isfinite(t).all() for t in (out, dq, dk, dv)):
            fail(f"flash kernels {dtype} {label}: non-finite")
        if not ((dk.transpose(1, 2)[pad] == 0).all()
                and (dv.transpose(1, 2)[pad] == 0).all()):
            fail(f"flash_bwd_dkv {dtype} {label}: the padded keys' dK/dV "
                 "are not exact zeros")
        del out, lse, dq, dk, dv, ref, ref_lse, rdk, rdv, delta
    # the backward kernels' device time at this call, bf16
    q, k, v, do = (t.bfloat16() for t in (q32, k32, v32, do32))
    out, lse = flash_attention_cuda(q, k, v, *args)
    delta = (do.float() * out.float()).sum(-1)
    return {"bert_shape": [B, H, T, D], **{
        name: device_ms(lambda: fn(q, k, v, do, lse, delta, *args))
        for name, fn in (("flash_bwd_dq", flash_bwd_dq_cuda),
                         ("flash_bwd_dkv", flash_bwd_dkv_cuda))}}


def phase_train_kernels(dev, results):
    """The flash kernels at the training shape: the forward's training
    arms, then dQ and dK/dV against their plain versions, the same at the
    bert_train phase's call, and their timings (bf16, causal, dropout 0.1:
    the train phase's call)."""
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

    _ulysses_bwd_case(dev, q32, k32, v32, do32, scale)
    bert = _bert_flash_case(dev)

    # timings at the train phase's call: bf16, causal, dropout 0.1
    q, k, v, do = (t.bfloat16() for t in (q32, k32, v32, do32))
    args = (True, scale, None, None, 0.1, 12345, None)
    args0 = args[:4] + (0.0,) + args[5:]
    out, lse = flash_attention_cuda(q, k, v, *args)
    delta = (do.float() * out.float()).sum(-1)
    pairs = B * H * T * (T + 1) // 2
    row_b = B * H * T * D * 2            # one bf16 [B, H, T, 64] tensor
    stat_b = B * H * T * 4               # one fp32 [B, H, T] row statistic
    qs, ks, vs = (t.clone().requires_grad_(True) for t in (q, k, v))
    # the backward yardsticks: autograd through SDPA, all three gradients,
    # without dropout and with the kernels' dropout 0.1
    lib_bwd = {}
    for rate, key in ((0.0, "library"), (0.1, "library_dropout")):
        ref_out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True,
                                                 dropout_p=rate)
        run = lambda: torch.autograd.grad(  # noqa: E731
            ref_out, (qs, ks, vs), do, retain_graph=True)
        lib_bwd[key + "_ms"] = time_ms(run)
        lib_bwd[key + "_device_ms"] = device_ms(run)
        del ref_out, run
    note = ("backward of F.scaled_dot_product_attention(is_causal=True) "
            "through autograd: all three gradients; library_* without "
            "dropout, library_dropout_* with dropout_p=0.1")
    bms, by = bound_ms(4 * row_b + stat_b, 4 * D * pairs, "bfloat16")
    fwd = timings(lambda: flash_attention_cuda(q, k, v, *args),
                  lambda: flash_attention_plain(q, k, v, *args),
                  lambda: F.scaled_dot_product_attention(q, k, v,
                                                         is_causal=True))
    lib_drop = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q, k, v, is_causal=True, dropout_p=0.1)
    results["flash_fwd"].update({
        "train_shape": list(TRAIN_SHAPE),
        **{"train_" + key: val for key, val in fwd.items()},
        "train_library_dropout_ms": time_ms(lib_drop),
        "train_library_dropout_device_ms": device_ms(lib_drop),
        "train_device_ms_dropout0": device_ms(
            lambda: flash_attention_cuda(q, k, v, *args0)),
        "train_bound_ms": bms, "train_bound_by": by,
    })
    bms, by = bound_ms(5 * row_b + 2 * stat_b, 6 * D * pairs, "bfloat16")
    results["flash_bwd_dq"] = {
        "name": "flash_bwd_dq", "route": "cuda",
        "source": "deepspeed_tpu_torch/csrc/flash_bwd_dq.cu",
        "replaces": "deepspeed_tpu/ops/pallas/flash_attention.py:363",
        "max_abs_err": errs["dq"], "shape": list(TRAIN_SHAPE),
        "device_ms_method": DEVICE_MS_METHOD,
        **timings(lambda: flash_bwd_dq_cuda(q, k, v, do, lse, delta, *args),
                  lambda: flash_bwd_dq_plain(q, k, v, do, lse, delta,
                                             *args)),
        "device_ms_dropout0": device_ms(lambda: flash_bwd_dq_cuda(
            q, k, v, do, lse, delta, *args0)),
        "bound_ms": bms, "bound_by": by, **lib_bwd, "library_note": note,
    }
    bms, by = bound_ms(6 * row_b + 2 * stat_b, 8 * D * pairs, "bfloat16")
    results["flash_bwd_dkv"] = {
        "name": "flash_bwd_dkv", "route": "cuda",
        "source": "deepspeed_tpu_torch/csrc/flash_bwd_dkv.cu",
        "replaces": "deepspeed_tpu/ops/pallas/flash_attention.py:414",
        "max_abs_err": errs["dkv"], "shape": list(TRAIN_SHAPE),
        "device_ms_method": DEVICE_MS_METHOD,
        **timings(lambda: flash_bwd_dkv_cuda(q, k, v, do, lse, delta, *args),
                  lambda: flash_bwd_dkv_plain(q, k, v, do, lse, delta,
                                              *args)),
        "device_ms_dropout0": device_ms(lambda: flash_bwd_dkv_cuda(
            q, k, v, do, lse, delta, *args0)),
        "bound_ms": bms, "bound_by": by, **lib_bwd, "library_note": note,
    }
    r = results["flash_fwd"]
    print_row("[kernels]", f"flash_fwd bf16 {TRAIN_SHAPE} dropout 0.1", r,
              prefix="train_")
    print(f"[kernels] flash_fwd bf16 {TRAIN_SHAPE}: SDPA with dropout_p=0.1 "
          f"{r['train_library_dropout_ms']:.4f} ms (device "
          f"{r['train_library_dropout_device_ms']:.4f})")
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        r = results[name]
        print_row("[kernels]", f"{name} bf16 {TRAIN_SHAPE} dropout 0.1 "
                  "(library: all three grads, no dropout)", r)
    r = results["flash_bwd_dq"]
    print(f"[kernels] SDPA backward with dropout_p=0.1 (all three grads): "
          f"{r['library_dropout_ms']:.4f} ms (device "
          f"{r['library_dropout_device_ms']:.4f})")
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        results[name].update(bert_shape=bert["bert_shape"],
                             bert_device_ms=bert[name])
        print(f"[kernels] {name} bf16 {bert['bert_shape']} non-causal "
              f"dropout 0.1 BERT key mask: device {bert[name]:.4f} ms")
    f, dq, dkv = (results[n] for n in ("flash_fwd", "flash_bwd_dq",
                                       "flash_bwd_dkv"))
    print(f"[kernels] diagnostic, the dropout hash's cost on the card "
          f"(device ms, dropout 0.1 / 0): flash_fwd "
          f"{f['train_device_ms']:.4f} / {f['train_device_ms_dropout0']:.4f}"
          f", flash_bwd_dq {dq['device_ms']:.4f} / "
          f"{dq['device_ms_dropout0']:.4f}, flash_bwd_dkv "
          f"{dkv['device_ms']:.4f} / {dkv['device_ms_dropout0']:.4f}")


def _ulysses_bwd_case(dev, q32, k32, v32, do32, scale):
    """dQ and dK/dV at Ulysses' local call in train_seq: one row, 6 of
    GPT-2 small's 12 heads over the whole 1024 tokens, seq rank 1's
    ``bh_affine`` (base 6, period 6, stride 12), causal, dropout 0.1,
    against the plain versions, fp32 and bf16."""
    import torch
    from deepspeed_tpu_torch.ops.kernels.flash_attention import (
        flash_attention_plain, flash_bwd_dkv_cuda, flash_bwd_dkv_plain,
        flash_bwd_dq_cuda, flash_bwd_dq_plain)
    H = TRAIN_SHAPE[1]
    hn = H // SEQ_SP
    aff = (hn, hn, H)
    args = (True, scale, None, None, 0.1, 0x2545F491, aff)
    for dtype in ("float32", "bfloat16"):
        tdt = getattr(torch, dtype)
        q, k, v, do = (t[:1, :hn].contiguous().to(tdt)
                       for t in (q32, k32, v32, do32))
        f32 = (q.float(), k.float(), v.float())
        ref, lse = flash_attention_plain(*f32, *args)
        delta = (do.float() * ref).sum(-1)
        dq = flash_bwd_dq_cuda(q, k, v, do, lse, delta, *args)
        dk, dv = flash_bwd_dkv_cuda(q, k, v, do, lse, delta, *args)
        torch.cuda.synchronize()
        plain = (*f32, do.float(), lse, delta)
        e_dq = _rel_err(dq, flash_bwd_dq_plain(*plain, *args))
        rdk, rdv = flash_bwd_dkv_plain(*plain, *args)
        e_dkv = max(_rel_err(dk, rdk), _rel_err(dv, rdv))
        print(f"[kernels] flash_bwd {dtype} Ulysses' local call "
              f"{list(q.shape)} bh_affine {aff} dropout 0.1: dq err "
              f"{e_dq:.3g}, dk/dv err {e_dkv:.3g}")
        if not (e_dq <= TOL[dtype] and e_dkv <= TOL[dtype]):
            fail(f"flash_bwd {dtype} at Ulysses' local call: dq {e_dq} "
                 f"dk/dv {e_dkv} above {TOL[dtype]}")


def _load():
    rng = np.random.default_rng(SEED)
    lens = rng.integers(PROMPT_MIN, PROMPT_MAX + 1, N_REQ)
    from deepspeed_tpu_torch.models.gpt2 import GPT2_SMALL
    return [[int(t) for t in rng.integers(0, GPT2_SMALL.vocab_size, n)]
            for n in lens]


def _paged_load():
    """The serve_paged phase's 16 requests as two waves (the second is
    submitted once the first has its first tokens, so its prompts can hit
    the prefix cache): 8 prompts sharing a 256-token template, each with
    its own 8-64-token suffix; two identical 300-token prompts (a shared
    partial page: copy-on-write); one 1-token prompt; 5 random prompts of
    16-512 tokens."""
    from deepspeed_tpu_torch.models.gpt2 import GPT2_SMALL
    rng = np.random.default_rng(SEED + 5)

    def tok(n):
        return [int(t) for t in rng.integers(0, GPT2_SMALL.vocab_size, n)]

    template = tok(256)
    sharers = [template + tok(int(n)) for n in rng.integers(8, 65, 8)]
    twin = tok(300)
    rand = [tok(int(n)) for n in rng.integers(PROMPT_MIN, PROMPT_MAX + 1, 5)]
    return [sharers[0], twin], sharers[1:] + [list(twin), tok(1)] + rand


def _paged_waves(eng, tenants=None):
    """The serve_paged phase's load on ``eng``: its first wave, steps
    until each of those has its first token, then the rest; request ``i``
    on tenant ``tenants[i]`` (all on 0 when None).  Returns the requests in
    submission order once all have finished."""
    first, rest = _paged_load()
    tenants = tenants or [0] * (len(first) + len(rest))
    reqs = [eng.submit(p, max_new_tokens=NEW_TOKENS, adapter_id=t)
            for p, t in zip(first, tenants)]
    while not all(r.tokens for r in reqs):
        eng.step()
    reqs += [eng.submit(p, max_new_tokens=NEW_TOKENS, adapter_id=t)
             for p, t in zip(rest, tenants[len(first):])]
    eng.run_until_idle()
    return reqs


def _draft_params(params):
    """The speculative draft: the target's embeddings, final norm and its
    first DRAFT_LAYERS blocks (so acceptance is partial, not nil)."""
    draft = {k: v for k, v in params.items() if k != "blocks"}
    draft["blocks"] = {k: v[:DRAFT_LAYERS]
                       for k, v in params["blocks"].items()}
    return draft


def _check_requests(phase, reqs):
    from deepspeed_tpu_torch.models.gpt2 import GPT2_SMALL
    for r in reqs:
        if r.error is not None or r.finish_reason != "length" \
                or len(r.tokens) != NEW_TOKENS \
                or not all(0 <= t < GPT2_SMALL.vocab_size for t in r.tokens):
            fail(f"{phase} request {r.rid}: {r.finish_reason} {r.error!r} "
                 f"({len(r.tokens)} tokens)")


def _serve(model, params, cfg, prompts, dev, draft_params=None):
    from deepspeed_tpu_torch.inference import ServeEngine
    eng = ServeEngine(model, cfg, params=params, device=dev,
                      draft_params=draft_params)
    reqs = [eng.submit(p, max_new_tokens=NEW_TOKENS) for p in prompts]
    eng.run_until_idle()
    eng.close()
    _check_requests("parity", reqs)
    return reqs


def _pct(xs, p):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(p * len(xs)))]


def _latencies(phase, reqs, tokens, wall):
    """tokens/s over the run, decode per-token latency (TPOT) and time to
    first token p50/p99, peak memory; returns (tokens/s, TPOT p50 s, TPOT
    p99 s)."""
    import torch
    tpot = [t for r in reqs for t in r.token_times[1:]]
    ttft = [r.token_times[0] for r in reqs]
    print(f"[{phase}] {tokens} tokens in {wall:.3f} s = "
          f"{tokens / wall:.1f} tokens/s; per-token (decode) p50 "
          f"{_pct(tpot, 0.5) * 1e3:.3f} ms p99 {_pct(tpot, 0.99) * 1e3:.3f} "
          f"ms; time to first token p50 {_pct(ttft, 0.5) * 1e3:.1f} ms p99 "
          f"{_pct(ttft, 0.99) * 1e3:.1f} ms; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    return tokens / wall, _pct(tpot, 0.5), _pct(tpot, 0.99)


def _engine(cfg, dev, dtype, draft=False, extra=None):
    """GPT-2 small at full width and depth with random weights from the
    seed, warmed up on one short request (cuBLAS handles, caches).  The
    peak-memory count restarts once the engine holds only what it serves
    (the fp master dropped when the weights are quantized) and the earlier
    phases' engines are collected.  ``extra``: more top-level config
    blocks (telemetry)."""
    import gc
    import torch
    from deepspeed_tpu_torch.inference import ServeEngine
    from deepspeed_tpu_torch.models.gpt2 import GPT2_SMALL, GPT2Model
    model = GPT2Model(GPT2_SMALL)
    params = model.init(SEED, device=dev, dtype=dtype)
    eng = ServeEngine(model, {"serving": cfg, **(extra or {})},
                      params=params, device=dev,
                      draft_params=_draft_params(params) if draft else None)
    warm = eng.submit(list(range(16)), max_new_tokens=2)
    eng.run_until_idle()
    if warm.error is not None:
        fail(f"warm-up request: {warm.error!r}")
    del params
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    return eng


def phase_serve(dev):
    import torch
    from deepspeed_tpu_torch.models.gpt2 import GPT2_SMALL

    eng = _engine(SLOT_CFG, dev, torch.bfloat16)
    ticks0 = eng.decode_ticks
    prompts = _load()
    _zero_counts()
    t0 = time.perf_counter()
    reqs = [eng.submit(p, max_new_tokens=NEW_TOKENS) for p in prompts]
    eng.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _counts()
    ticks = eng.decode_ticks - ticks0
    eng.close()
    L = GPT2_SMALL.n_layer
    _check_requests("serve", reqs)
    if launches["flash_fwd"] != N_REQ * L:
        fail(f"flash_fwd launched {launches['flash_fwd']} times, expected "
             f"{N_REQ} prefills x {L} layers")
    if launches["decode_attention"] != L * ticks or ticks == 0:
        fail(f"decode_attention launched {launches['decode_attention']} "
             f"times, expected {L} layers x {ticks} decode ticks")
    print(f"[serve] GPT-2 small bf16, {N_REQ} requests x {NEW_TOKENS} "
          f"tokens over 8 slots, prompts {min(map(len, prompts))}-"
          f"{max(map(len, prompts))}, {ticks} decode ticks")
    _latencies("serve", reqs, sum(len(r.tokens) for r in reqs), wall)
    print(f"[serve] launches: flash_fwd {launches['flash_fwd']} "
          f"(= {N_REQ} x {L}), decode_attention "
          f"{launches['decode_attention']} (= {L} x {ticks})")
    return launches, [list(r.tokens) for r in reqs]


def phase_serve_paged(dev, fp_memory=None):
    """The paged engine: prefix cache, copy-on-write and chunked prefill
    on full-size GPT-2 small, bf16.  Given ``fp_memory`` (what the
    serve_paged phase returned beside its launches: param_bytes, kv_bytes
    and peak memory), the serve_quant phase: the same engine with int8
    weights and the int8 page pool, its memory printed beside that."""
    import torch
    from deepspeed_tpu_torch.models.gpt2 import GPT2_SMALL

    quant = fp_memory is not None
    label = "serve_quant" if quant else "serve_paged"
    cfg = {**PAGED_CFG, "quantization": QUANT} if quant else PAGED_CFG
    kernel, other = (("decode_paged_int8", "decode_paged") if quant
                     else ("decode_paged", "decode_paged_int8"))
    eng = _engine(cfg, dev, torch.bfloat16)
    eng.prefix.clear()        # forget the warm-up prompt's pages
    free0 = eng.pool.free_count
    ticks0 = eng.decode_ticks
    stats0 = (eng.prefix.hits, eng.prefix.misses, eng.prefix.cow)
    _zero_counts()
    t0 = time.perf_counter()
    reqs = _paged_waves(eng)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _counts()
    ticks = eng.decode_ticks - ticks0
    held = eng.prefix.entries
    free = eng.pool.free_count
    hits, misses, cow = (now - then for now, then in zip(
        (eng.prefix.hits, eng.prefix.misses, eng.prefix.cow), stats0))
    memory = (eng.param_bytes, eng.kv_bytes,
              torch.cuda.max_memory_allocated(dev))
    eng.close()
    L = GPT2_SMALL.n_layer
    _check_requests(label, reqs)
    # a prefill with no cached prefix (or the first chunk of one) runs the
    # flash kernel in every layer; a prefix hit runs the gather arm
    no_prefix = sum(r.shared_len == 0 for r in reqs)
    if launches["flash_fwd"] != L * no_prefix:
        fail(f"flash_fwd launched {launches['flash_fwd']} times, expected "
             f"{L} layers x {no_prefix} prefills with no cached prefix")
    if launches[kernel] != L * ticks or ticks == 0:
        fail(f"{kernel} launched {launches[kernel]} times, expected {L} "
             f"layers x {ticks} decode ticks")
    if launches["decode_attention"] != 0 or launches[other] != 0:
        fail(f"the {label} engine launched the slot-cache decode kernel "
             f"or {other}")
    if free != free0 - held:
        fail(f"{free} free pages after the run; expected {free0} less the "
             f"{held} the prefix cache holds")
    if hits < 8 or cow < 1:
        fail(f"prefix cache: {hits} hits, {cow} copies on write; expected "
             "the 7 template sharers and the twin to hit, the twin to COW")
    computed = sum(r.computed_len for r in reqs)
    submitted = sum(len(r.prompt) for r in reqs)
    print(f"[{label}] GPT-2 small bf16{' ' + str(QUANT) if quant else ''}, "
          f"{len(reqs)} requests x {NEW_TOKENS} tokens over 8 slots, "
          f"page_len {PAGED_CFG['page_len']}, {PAGED_CFG['pages']} pages, "
          f"prefill chunks of {PAGED_CFG['prefill_chunk_len']}: {ticks} "
          f"decode ticks; prefix hits {hits}, misses {misses}, copies on "
          f"write {cow}; prompt tokens computed {computed} of {submitted} "
          f"submitted; {free} free pages after the run = {free0} less "
          f"{held} held by the prefix cache")
    rates = _latencies(label, reqs, sum(len(r.tokens) for r in reqs), wall)
    print(f"[{label}] launches: flash_fwd {launches['flash_fwd']} (= "
          f"{L} x {no_prefix}), {kernel} {launches[kernel]} (= {L} x "
          f"{ticks}), {other} 0")
    if quant:
        (pb, kb, peak), (pb0, kb0, peak0) = memory, fp_memory
        print(f"[serve_quant] param_bytes {pb} vs serve_paged {pb0} "
              f"({pb0 / pb:.3f}x fewer); kv_bytes {kb} vs {kb0} "
              f"({kb0 / kb:.3f}x fewer); peak memory {peak / 2**20:.1f} "
              f"MiB vs {peak0 / 2**20:.1f} MiB, of which beyond the "
              f"params and KV {(peak - pb - kb) / 2**20:.1f} vs "
              f"{(peak0 - pb0 - kb0) / 2**20:.1f} MiB (transients: the "
              "int8 matmuls cast one layer's weight to bf16 at a time)")
    return launches, memory, {"streams": [list(r.tokens) for r in reqs],
                              "rates": rates}


def phase_serve_quant_capacity(dev):
    """How many requests each pool admits at once in the same KV bytes
    (``tools/loadgen/scenarios.py:279 run_quant_ab``'s geometry, rebuilt
    here): GPT-2 small bf16, page_len 16, max_seq_len 64, a KV budget of 4
    slots x 64 tokens of bf16 KV; the bf16 pool and the int8 pool (kv
    int8) get as many pages as fit the budget (plus the scratch page), 64
    slots, 96 requests all due at once, every 4th long (prompt 44, 3
    pages) and the rest short (prompt 12, 1 page), 4 new tokens each."""
    import torch
    from deepspeed_tpu_torch.inference.kv_cache import (KVCacheSpec,
                                                        PagedKVCacheSpec)
    from deepspeed_tpu_torch.models.gpt2 import GPT2_SMALL

    page_len, max_seq, n_req = 16, 64, 96
    c = GPT2_SMALL
    budget = KVCacheSpec(layers=c.n_layer, slots=4, heads=c.n_head,
                         max_len=max_seq, head_dim=c.d_head,
                         dtype=torch.bfloat16).bytes
    rng = np.random.default_rng(SEED + 9)
    prompts = [[int(t) for t in rng.integers(0, c.vocab_size,
                                             44 if i % 4 == 3 else 12)]
               for i in range(n_req)]
    base = {"slots": 64, "max_seq_len": max_seq, "prefill_len": 44,
            "queue_capacity": 256, "page_len": page_len,
            "prefix_cache": False}
    out, launches = {}, {}
    for name, quant in (("bf16", False), ("int8", True)):
        page_bytes = PagedKVCacheSpec(
            layers=c.n_layer, slots=1, heads=c.n_head, pages=1,
            page_len=page_len, head_dim=c.d_head, max_pages=1,
            dtype=torch.int8 if quant else torch.bfloat16,
            quant=quant).page_bytes
        pages = budget // page_bytes + 1
        cfg = {**base, "pages": pages}
        if quant:
            cfg["quantization"] = {"kv": "int8"}
        eng = _engine(cfg, dev, torch.bfloat16)
        _zero_counts()
        reqs = [eng.submit(p, max_new_tokens=4) for p in prompts]
        peak = 0
        while eng.scheduler.active or eng._pending or eng.queue.qsize():
            eng.step()
            peak = max(peak, len(eng.scheduler.active))
        torch.cuda.synchronize()
        for k, n in _counts().items():
            launches[k] = launches.get(k, 0) + n
        truncated = sum(r.finish_reason == "kv_capacity" for r in reqs)
        bad = [r.rid for r in reqs if r.error is not None
               or len(r.tokens) != 4 and r.finish_reason != "kv_capacity"]
        out[name] = (pages - 1, eng.kv_bytes, peak, truncated)
        eng.close()
        if bad:
            fail(f"serve_quant capacity {name}: requests {bad} failed")
        print(f"[serve_quant capacity] {name} pool: {pages - 1} pages of "
              f"{page_bytes} B in a budget of {budget} B, kv_bytes "
              f"{out[name][1]}; highest concurrency {peak} of 64 slots; "
              f"{truncated} kv_capacity finishes")
    (p8, kv8, c8, t8), (p16, kv16, c16, t16) = out["int8"], out["bf16"]
    if not (kv8 <= kv16 and t8 == 0 and t16 == 0 and c8 > c16):
        fail(f"serve_quant capacity: int8 {out['int8']} vs bf16 "
             f"{out['bf16']} (pages, kv_bytes, concurrency, truncations)")
    print(f"[serve_quant capacity] the int8 pool admits {c8} requests at "
          f"once against {c16} for bf16 ({c8 / c16:.3f}x) in "
          f"{kv8} vs {kv16} KV bytes")
    return launches


def phase_serve_spec(dev, quant=False):
    """Greedy speculation (k = 4, a 2-layer draft cut from the target) on
    the slot cache and on the paged pool, full-size GPT-2 small, bf16;
    with ``quant`` (the serve_quant_spec phase) on the int8 pool with int8
    target and draft weights."""
    import torch
    from deepspeed_tpu_torch.models.gpt2 import GPT2_SMALL

    L = GPT2_SMALL.n_layer
    paged = {**SLOT_CFG, "page_len": PAGED_CFG["page_len"]}
    arms = ((("paged int8", {**paged, "quantization": QUANT},
              "decode_paged_multi_int8"),) if quant else
            (("slot", SLOT_CFG, "decode_multi"),
             ("paged", paged, "decode_paged_multi")))
    tag = "serve_quant_spec" if quant else "serve_spec"
    total = {}
    for arm, cfg, kernel in arms:
        eng = _engine({**cfg, **SPEC}, dev, torch.bfloat16, draft=True)
        v0, p0, a0 = eng.verify_ticks, eng._spec_passes, eng._spec_accepted_n
        prompts = _load()
        _zero_counts()
        t0 = time.perf_counter()
        reqs = [eng.submit(p, max_new_tokens=NEW_TOKENS) for p in prompts]
        eng.run_until_idle()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _counts()
        passes = eng.verify_ticks - v0
        req_passes = eng._spec_passes - p0
        accepted = eng._spec_accepted_n - a0
        eng.close()
        _check_requests(f"{tag} {arm}", reqs)
        draft_steps = SPEC["draft"]["n_layer"] * (SPEC["speculate_k"] + 1)
        if launches[kernel] != L * passes or passes == 0:
            fail(f"{kernel} launched {launches[kernel]} times, expected "
                 f"{L} layers x {passes} verify passes")
        others = [k for k in ("decode_multi", "decode_paged_multi",
                              "decode_paged_multi_int8", "decode_paged",
                              "decode_paged_int8")
                  if k != kernel and launches[k]]
        if others:
            fail(f"{tag} {arm} also launched {others}")
        if launches["decode_attention"] != draft_steps * passes:
            fail(f"decode_attention launched {launches['decode_attention']} "
                 f"times, expected {draft_steps} draft steps x {passes} "
                 "verify passes")
        print(f"[{tag}] {arm} cache, k {SPEC['speculate_k']}, draft "
              f"{SPEC['draft']}: {passes} verify passes, "
              f"{(accepted + req_passes) / req_passes:.3f} tokens per target "
              f"pass per request, draft acceptance "
              f"{accepted / (req_passes * SPEC['speculate_k']):.3f}")
        _latencies(f"{tag} {arm}", reqs,
                   sum(len(r.tokens) for r in reqs), wall)
        print(f"[{tag}] {arm} launches: {kernel} {launches[kernel]} (= "
              f"{L} x {passes}), decode_attention "
              f"{launches['decode_attention']} (= {draft_steps} x {passes})")
        for name, n in launches.items():
            total[name] = total.get(name, 0) + n
    return total


def _kv_tier_waves():
    """Two waves of sessions over the serve_paged phase's geometry: the
    first, 4 prompts sharing a 256-token template with their own 8-64-
    token suffixes; the second, each of those extended by 8-32 tokens (a
    session's next turn) and 2 new sharers of the template."""
    from deepspeed_tpu_torch.models.gpt2 import GPT2_SMALL
    rng = np.random.default_rng(SEED + 11)

    def tok(n):
        return [int(t) for t in rng.integers(0, GPT2_SMALL.vocab_size, n)]

    template = tok(256)
    first = [template + tok(int(n)) for n in rng.integers(8, 65, 4)]
    second = ([p + tok(int(n)) for p, n in zip(first, rng.integers(
        8, 33, 4))] + [template + tok(int(n))
                       for n in rng.integers(8, 65, 2)])
    return first, second


def _kv_tier_run(dev, quant: bool, disk_dir, extra=None):
    """One run of the two waves on the paged engine (int8 weights and pool
    with ``quant``), the KV tier on when ``disk_dir`` is given: wave 1,
    idle ticks until every prefix-cache page has parked, wave 2.  Returns
    the streams, the launch counts, the tier's counters (over the run, and
    since the engine's start: ``*_total``) and the prompt tokens wave 2
    computed.  ``extra``: more top-level config blocks (telemetry)."""
    import torch
    cfg = {**PAGED_CFG, **({"quantization": QUANT} if quant else {})}
    if disk_dir is not None:
        cfg["kv_tier"] = {**KV_TIER, "disk_dir": disk_dir}
    eng = _engine(cfg, dev, torch.bfloat16, extra=extra)
    eng.prefix.clear()        # forget the warm-up prompt's pages
    tier = eng.kv_tier
    if (tier is None) != (disk_dir is None):
        fail("serving.kv_tier did not build the tier as configured")
    counters = ("parked_pages_total", "resumed_pages_total",
                "resumed_sessions_total", "spill_bytes", "fetch_bytes",
                "corrupt_total")
    # counted from here: the warm-up request may have parked a page
    base = {c: getattr(tier, c) for c in counters} if tier else {}
    first, second = _kv_tier_waves()
    _zero_counts()
    reqs = [eng.submit(p, max_new_tokens=KV_NEW_TOKENS) for p in first]
    eng.run_until_idle()
    idle = 0
    if tier is not None:
        while eng.prefix.entries and idle < KV_IDLE_TICKS:
            eng.step()
            idle += 1
        if eng.prefix.entries or eng.pool.used_count:
            fail(f"{eng.prefix.entries} prefix-cache entries and "
                 f"{eng.pool.used_count} pool pages still held after "
                 f"{idle} idle ticks with the KV tier on")
    on_disk = (len([f for f in os.listdir(disk_dir) if f.endswith(".page")])
               if disk_dir is not None else 0)
    parked_gap = (tier.parked_pages_total - base["parked_pages_total"]
                  if tier else 0)
    t0 = time.perf_counter()
    wave2 = [eng.submit(p, max_new_tokens=KV_NEW_TOKENS) for p in second]
    eng.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _counts()
    reqs += wave2
    for r in reqs:
        if r.error is not None or len(r.tokens) != KV_NEW_TOKENS:
            fail(f"kv_tier request {r.rid}: {r.finish_reason} {r.error!r}")
    out = {"streams": [list(r.tokens) for r in reqs],
           "launches": launches, "idle": idle, "on_disk": on_disk,
           "parked_gap": parked_gap,
           "computed": sum(r.computed_len for r in wave2),
           "submitted": sum(len(r.prompt) for r in wave2),
           "shared": [r.shared_len for r in wave2], "wall": wall}
    if tier is not None:
        d = {c: getattr(tier, c) - base[c] for c in counters}
        out.update(parked=d["parked_pages_total"],
                   resumed=d["resumed_pages_total"],
                   sessions=d["resumed_sessions_total"],
                   spill=d["spill_bytes"], fetch=d["fetch_bytes"],
                   corrupt=d["corrupt_total"], p99=tier.resume_p99_s(),
                   spill_total=tier.spill_bytes, fetch_total=tier.fetch_bytes)
    eng.close()
    if eng.pool.refs:
        fail(f"kv_tier: {len(eng.pool.refs)} pool pages held after close")
    return out


def phase_serve_kv_tier(dev):
    """The KV tier on the paged engine (full-size GPT-2 small, bf16, then
    the int8 pool): sessions park to host and disk while idle and resume
    into fresh pages; their streams must equal the tier-off run's."""
    import shutil
    import tempfile
    from deepspeed_tpu_torch.models.gpt2 import GPT2_SMALL

    L = GPT2_SMALL.n_layer
    total, streams = {}, {}
    for quant in (False, True):
        label = "int8 pool" if quant else "bf16"
        kernel = "decode_paged_int8" if quant else "decode_paged"
        off = _kv_tier_run(dev, quant, None)
        root = tempfile.mkdtemp(prefix="chip_smoke_kv_")
        try:
            on = _kv_tier_run(dev, quant, root)
        finally:
            shutil.rmtree(root, ignore_errors=True)
        if on["streams"] != off["streams"]:
            bad = [i for i, (a, b) in enumerate(zip(on["streams"],
                                                    off["streams"]))
                   if a != b]
            fail(f"kv_tier {label}: requests {bad} streamed other tokens "
                 "with the tier on than with it off")
        if on["shared"] != off["shared"]:
            fail(f"kv_tier {label}: wave 2 shared {on['shared']} prompt "
                 f"tokens with the tier on, {off['shared']} with it off")
        if on["parked"] <= 0 or on["resumed"] <= 0 or on["on_disk"] <= 0 \
                or on["corrupt"]:
            fail(f"kv_tier {label}: parked {on['parked']}, resumed "
                 f"{on['resumed']}, {on['on_disk']} page files, corrupt "
                 f"{on['corrupt']}")
        if on["launches"][kernel] <= 0 or on["launches"][kernel] % L:
            fail(f"kv_tier {label}: {kernel} launched "
                 f"{on['launches'][kernel]} times")
        print(f"[serve_kv_tier] {label}: {len(on['streams'])} requests "
              f"(4 sessions, then their next turns and 2 more sharers) x "
              f"{KV_NEW_TOKENS} tokens, idle_park_ticks "
              f"{KV_TIER['idle_park_ticks']}, host budget "
              f"{KV_TIER['host_budget_pages']} pages: {on['parked_gap']} "
              f"pages parked over {on['idle']} idle ticks ({on['on_disk']} "
              f"in page files), {on['parked']} with those wave 2 left idle "
              f"a tick; {on['resumed']} resumed into "
              f"{on['sessions']} admissions; spill {on['spill']} B, fetch "
              f"{on['fetch']} B; wave 2 computed {on['computed']} of "
              f"{on['submitted']} prompt tokens (tier off: "
              f"{off['computed']}); resume p99 {on['p99'] * 1e3:.3f} ms; "
              f"wave 2 wall {on['wall']:.3f} s (tier off "
              f"{off['wall']:.3f} s); streams equal to the tier-off run's; "
              f"{kernel} {on['launches'][kernel]} launches")
        for name, n in on["launches"].items():
            total[name] = total.get(name, 0) + n
        streams[label] = on["streams"]
    print(f"[serve_kv_tier] {smi()}")
    return total, streams


def _zipf_logits(dev, vocab: int, seed: int, s: float = 1.1):
    """Logits whose softmax falls off as rank^-s over a random permutation
    of the vocabulary (a seeded stand-in for a language model's row)."""
    import torch
    g = torch.Generator().manual_seed(seed)
    ranks = torch.empty(vocab)
    ranks[torch.randperm(vocab, generator=g)] = torch.arange(
        1, vocab + 1, dtype=torch.float32)
    return (-s * torch.log(ranks)).to(dev)


def _chi2_p(counts, probs) -> float:
    """Goodness-of-fit chi-square p of ``counts`` against ``probs`` over
    the bins of expected count >= 5, the rest pooled into one."""
    from scipy import stats
    counts = np.asarray(counts, np.float64)
    exp = np.asarray(probs, np.float64) * counts.sum()
    big = exp >= 5
    o = np.append(counts[big], counts[~big].sum())
    e = np.append(exp[big], exp[~big].sum())
    return float(stats.chisquare(o, e * o.sum() / e.sum()).pvalue)


def phase_sampler(dev):
    """The samplers on the card at GPT-2's vocabulary (torch ops, no
    kernel of their own), under sync debug mode 'error' (no host sync):
    ``select_next_token`` at T 0.8, 65,536 draws of one Zipf-shaped row
    against its softmax; ``rejection_sample_accept`` at S 8, k 4 over
    4,096 calls, drafts drawn from the draft's softmax: the mean accepted
    length against its closed form and the first emitted token against
    the target's softmax; one seed's outputs bitwise equal twice."""
    import math
    import torch
    from deepspeed_tpu_torch.inference.speculative import (
        rejection_sample_accept, select_next_token)
    from deepspeed_tpu_torch.models.gpt2 import GPT2_SMALL
    from deepspeed_tpu_torch.runtime.utils import seeded_generator
    V, T = GPT2_SMALL.vocab_size, TEMPERATURE
    logits = _zipf_logits(dev, V, SEED)
    rows = logits.expand(SAMPLER_CHUNK, V)

    def draws(seed):
        g = seeded_generator(seed, dev)
        return torch.cat([select_next_token(rows, T, g) for _ in
                          range(SAMPLER_DRAWS // SAMPLER_CHUNK)])

    torch.cuda.set_sync_debug_mode("error")
    try:
        a, b = draws(SEED + 1), draws(SEED + 1)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    if not torch.equal(a, b):
        fail("sampler: select_next_token drew other tokens from one seed")
    probs = torch.softmax(logits.double() / T, -1).cpu().numpy()
    p_select = _chi2_p(torch.bincount(a.long(), minlength=V).cpu(), probs)

    S, k = 8, 4
    tl = torch.stack([_zipf_logits(dev, V, SEED + 10 + i)
                      for i in range(k + 1)])
    dl = tl[:k] + torch.randn(k, V, generator=seeded_generator(SEED + 20,
                                                               dev),
                              device=dev)
    p = torch.softmax(tl.double() / T, -1)
    q = torch.softmax(dl / T, -1)
    alpha = torch.minimum(p[:k], q.double()).sum(-1).cpu()
    expect = sum(float(torch.prod(alpha[:i + 1])) for i in range(k))
    tl_s, q_s = tl[None].expand(S, k + 1, V), q[None].expand(S, k, V)
    logq = torch.log(q)[None].expand(S, k, V)
    g = seeded_generator(SEED + 30, dev)
    accs, firsts = [], []
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(SAMPLER_CALLS):
            d = select_next_token(logq, 1.0, g)
            out, acc = rejection_sample_accept(tl_s, d, q_s, T, g)
            accs.append(acc)
            firsts.append(out[:, 0])
        again = [rejection_sample_accept(tl_s, d, q_s, T,
                                         seeded_generator(SEED + 40, dev))
                 for _ in range(2)]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    if not all(torch.equal(x, y) for x, y in zip(*again)):
        fail("sampler: rejection_sample_accept gave other outputs from "
             "one seed")
    acc = torch.cat(accs).double().cpu()
    n = acc.numel()
    z = (float(acc.mean()) - expect) / (float(acc.std()) / math.sqrt(n))
    p_len = math.erfc(abs(z) / math.sqrt(2))
    p_first = _chi2_p(torch.bincount(torch.cat(firsts).long(),
                                     minlength=V).cpu(),
                      p[0].cpu().numpy())
    print(f"[sampler] select_next_token T {T}: {SAMPLER_DRAWS} draws of "
          f"one [{V}] Zipf row, chi-square p {p_select:.4g}; "
          f"rejection_sample_accept S {S} k {k} x {SAMPLER_CALLS} calls: "
          f"mean accepted {float(acc.mean()):.4f} against the closed form "
          f"{expect:.4f} (z {z:.3f}, p {p_len:.4g}), first token "
          f"chi-square p {p_first:.4g}; bitwise under one seed; no host "
          "sync (sync debug mode 'error')")
    bad = {name: pv for name, pv in (("select", p_select),
                                     ("accepted length", p_len),
                                     ("first token", p_first))
           if not pv >= P_MIN}
    if bad:
        fail(f"sampler: p below {P_MIN}: {bad}")
    serve_rows = logits.expand(S, V)
    g = seeded_generator(SEED + 50, dev)
    print(f"[sampler] at the serving tick's shape [{S}, {V}]: greedy "
          f"{time_ms(lambda: select_next_token(serve_rows)):.4f} ms, "
          f"sampled {time_ms(lambda: select_next_token(serve_rows, T, g)):.4f}"
          f" ms; one rejection block [{S}, {k + 1}, {V}] "
          f"{time_ms(lambda: rejection_sample_accept(tl_s, d, q_s, T, g)):.4f}"
          f" ms (CUDA events around 20 calls); {smi()}")


def _spec_stats(eng, before):
    """(verify passes, request passes, accepted drafts) since ``before``."""
    now = (eng.verify_ticks, eng._spec_passes, eng._spec_accepted_n)
    return tuple(a - b for a, b in zip(now, before))


def phase_serve_sample(dev, greedy):
    """The serve phase's 12 requests at temperature 0.8 on the slot cache
    and on the paged pool, then with speculate_k 4 and the 2-layer draft
    on both (rejection-sampling acceptance): the launches per prefill,
    tick and pass of serve, serve_paged and serve_spec; every request
    completes with its length; a second engine of the seed gives the same
    streams bit for bit, and they are not the greedy ones."""
    import torch
    from deepspeed_tpu_torch.models.gpt2 import GPT2_SMALL
    L = GPT2_SMALL.n_layer
    paged = {**SLOT_CFG, "page_len": PAGED_CFG["page_len"]}
    draft_steps = SPEC["draft"]["n_layer"] * (SPEC["speculate_k"] + 1)
    total = {}
    for arm, cfg, spec, kernel in (
            ("slot", SLOT_CFG, False, "decode_attention"),
            ("paged", paged, False, "decode_paged"),
            ("slot spec", {**SLOT_CFG, **SPEC}, True, "decode_multi"),
            ("paged spec", {**paged, **SPEC}, True, "decode_paged_multi")):
        runs = []
        for _ in range(2):
            eng = _engine({**cfg, "temperature": TEMPERATURE}, dev,
                          torch.bfloat16, draft=spec)
            ticks0 = eng.decode_ticks
            before = (eng.verify_ticks, eng._spec_passes,
                      eng._spec_accepted_n)
            _zero_counts()
            t0 = time.perf_counter()
            reqs = [eng.submit(p, max_new_tokens=NEW_TOKENS)
                    for p in _load()]
            eng.run_until_idle()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = _counts()
            ticks = eng.decode_ticks - ticks0
            passes, req_passes, accepted = _spec_stats(eng, before)
            eng.close()
            _check_requests(f"serve_sample {arm}", reqs)
            for name, n in launches.items():
                total[name] = total.get(name, 0) + n
            runs.append((reqs, launches))
            # the target's prefills with no cached prefix, and with a
            # draft its prefill of every prompt
            no_prefix = sum(r.shared_len == 0 for r in reqs)
            flash = L * no_prefix + (DRAFT_LAYERS * N_REQ if spec else 0)
            if launches["flash_fwd"] != flash:
                fail(f"serve_sample {arm}: flash_fwd launched "
                     f"{launches['flash_fwd']} times, expected {L} layers "
                     f"x {no_prefix} prefills with no cached prefix"
                     + (f" + {DRAFT_LAYERS} draft layers x {N_REQ} draft "
                        "prefills" if spec else ""))
            steps = passes if spec else ticks
            if launches[kernel] != L * steps or steps == 0:
                fail(f"serve_sample {arm}: {kernel} launched "
                     f"{launches[kernel]} times, expected {L} layers x "
                     f"{steps} {'verify passes' if spec else 'ticks'}")
            if spec and launches["decode_attention"] != draft_steps * passes:
                fail(f"serve_sample {arm}: decode_attention launched "
                     f"{launches['decode_attention']} times, expected "
                     f"{draft_steps} draft steps x {passes} passes")
        streams = [[list(r.tokens) for r in reqs] for reqs, _ in runs]
        if streams[0] != streams[1]:
            fail(f"serve_sample {arm}: two engines of one seed streamed "
                 "other tokens")
        if streams[0] == greedy:
            fail(f"serve_sample {arm}: the sampled streams are the greedy "
                 "ones")
        same = sum(a == b for s, g in zip(streams[0], greedy)
                   for a, b in zip(s, g))
        per_pass = (f", {(accepted + req_passes) / req_passes:.3f} tokens "
                    f"per target pass per request, draft acceptance "
                    f"{accepted / (req_passes * SPEC['speculate_k']):.3f}"
                    if spec else "")
        print(f"[serve_sample] {arm}, T {TEMPERATURE}: {ticks} decode "
              f"ticks, {passes} verify passes{per_pass}; streams of two "
              f"engines of one seed equal; {same} of "
              f"{N_REQ * NEW_TOKENS} tokens equal to the greedy streams'; "
              f"{kernel} {runs[0][1][kernel]} launches")
        _latencies(f"serve_sample {arm}", runs[1][0],
                   sum(len(r.tokens) for r in runs[1][0]), wall)
    return total


def _lora_cfg(quant=False):
    cfg = {**PAGED_CFG, "lora": LORA}
    if quant:
        cfg["quantization"] = QUANT
    return cfg


def _lora_run(label, dev, cfg, tenants, kernel, spec=False, extra=None):
    """One run of the serve_paged load on ``cfg`` with request ``i`` on
    tenant ``tenants[i]``: checks every request's length and the kernel's
    launches (``L`` a decode tick, or a verify pass with the draft's
    single-query launches beside it); returns its streams, launches,
    rates and counters."""
    import torch
    from deepspeed_tpu_torch.models.gpt2 import GPT2_SMALL
    L = GPT2_SMALL.n_layer
    eng = _engine(cfg, dev, torch.bfloat16, draft=spec, extra=extra)
    eng.prefix.clear()
    ticks0 = eng.decode_ticks
    before = (eng.verify_ticks, eng._spec_passes, eng._spec_accepted_n)
    pool0 = (eng.adapters.hits, eng.adapters.faults, eng.adapters.evictions)
    _zero_counts()
    t0 = time.perf_counter()
    reqs = _paged_waves(eng, tenants)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _counts()
    ticks = eng.decode_ticks - ticks0
    passes, req_passes, accepted = _spec_stats(eng, before)
    pool = eng.adapters
    counters = tuple(now - then for now, then in zip(
        (pool.hits, pool.faults, pool.evictions), pool0))
    eng.close()
    # the engine's own counters at close (what its last telemetry flush
    # saw); the engine itself is not kept, so its caches are freed
    prefix = eng.prefix
    stats = {"serve_adapters_resident": pool.resident(),
             "serve_adapter_bytes": eng.adapter_bytes,
             "serve_adapter_hits_total": pool.hits,
             "serve_adapter_faults_total": pool.faults,
             "serve_adapter_evictions_total": pool.evictions,
             "serve_prefix_hit_ratio":
                 prefix.hits / (prefix.hits + prefix.misses),
             "serve_prefix_hit_tokens": prefix.hit_tokens,
             "serve_page_cow_total": prefix.cow,
             "serve_free_pages": eng.pool.free_count,
             "serve_param_bytes": eng.param_bytes,
             "serve_kv_bytes": eng.kv_bytes}
    if spec:
        stats["serve_spec_accept_ratio"] = eng._spec_ratio()
        stats["serve_spec_mean_accepted_len"] = (
            (eng._spec_accepted_n + eng._spec_passes) / eng._spec_passes)
    out = {"streams": [list(r.tokens) for r in reqs], "launches": launches,
           "counters": counters, "adapter_bytes": eng.adapter_bytes,
           "ticks": ticks, "passes": passes, "stats": stats,
           "spec": (req_passes, accepted)}
    del eng
    _check_requests(label, reqs)
    steps = passes if spec else ticks
    if launches[kernel] != L * steps or steps == 0:
        fail(f"{label}: {kernel} launched {launches[kernel]} times, "
             f"expected {L} layers x {steps} "
             f"{'verify passes' if spec else 'decode ticks'}")
    others = [k for k in ("decode_paged", "decode_paged_int8",
                          "decode_paged_multi", "decode_paged_multi_int8",
                          "decode_multi") if k != kernel and launches[k]]
    if others:
        fail(f"{label}: also launched {others}")
    draft_steps = SPEC["draft"]["n_layer"] * (SPEC["speculate_k"] + 1)
    if launches["decode_attention"] != (draft_steps * passes if spec else 0):
        fail(f"{label}: decode_attention launched "
             f"{launches['decode_attention']} times")
    out["rates"] = _latencies(label, reqs, sum(len(r.tokens) for r in reqs),
                              wall)
    return out


def phase_serve_lora(dev, paged_ref, quant_ref):
    """serve_paged's engine with ``serving.lora`` (rank 16, all four
    targets, 4 device pool slots) and its 16 requests over tenants 0-6,
    so adapters fault and evict: 12 paged-decode launches a tick with
    mixed tenants; every request on tenant 0 streams what serve_paged's
    lora-off engine streamed, bit for bit; in fp32 each tenant's greedy
    streams equal a lora-off engine's on ``merge_adapter``'s dense-merged
    weights on the dense path (near-tie rule); then the int8 weights and
    pool (the int8 arm launches; tenant 0 equals serve_quant's streams)
    and speculate_k 4 on the bf16 engine (the paged multi-query kernel)."""
    import torch
    from deepspeed_tpu_torch.inference.adapters import merge_adapter
    from deepspeed_tpu_torch.models.gpt2 import (GPT2_SMALL, GPT2Config,
                                                 GPT2Model)
    n_req = len(paged_ref["streams"])
    tenants = [i % LORA_TENANTS for i in range(n_req)]
    total = {}

    def add(run):
        for name, n in run["launches"].items():
            total[name] = total.get(name, 0) + n
        return run

    mixed = add(_lora_run("serve_lora bf16", dev, _lora_cfg(), tenants,
                          "decode_paged"))
    hits, faults, evictions = mixed["counters"]
    if faults < LORA_TENANTS - 1 or evictions < 1:
        fail(f"serve_lora: {faults} adapter faults and {evictions} "
             f"evictions for {LORA_TENANTS - 1} tenants over "
             f"{LORA['hbm_adapter_slots']} slots")
    zero = add(_lora_run("serve_lora bf16 tenant 0", dev, _lora_cfg(),
                         [0] * n_req, "decode_paged"))
    if zero["streams"] != paged_ref["streams"]:
        fail("serve_lora: requests on tenant 0 streamed other tokens than "
             "serve_paged's lora-off engine")
    qmixed = add(_lora_run("serve_lora int8", dev, _lora_cfg(quant=True),
                           tenants, "decode_paged_int8"))
    qzero = add(_lora_run("serve_lora int8 tenant 0", dev,
                          _lora_cfg(quant=True), [0] * n_req,
                          "decode_paged_int8"))
    if qzero["streams"] != quant_ref["streams"]:
        fail("serve_lora: int8 requests on tenant 0 streamed other tokens "
             "than serve_quant's lora-off engine")
    spec = add(_lora_run("serve_lora spec", dev, {**_lora_cfg(), **SPEC},
                         tenants, "decode_paged_multi", spec=True))
    req_passes, accepted = spec["spec"]

    # fp32 parity: the mixed-tenant kernel path against per-tenant merged
    # weights on the dense path
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        from deepspeed_tpu_torch.inference import ServeEngine
        kern = GPT2Model(GPT2_SMALL)
        dense_cfg = GPT2Config(**{**GPT2_SMALL.__dict__,
                                  "attn_impl": "dense"})
        dense = GPT2Model(dense_cfg)
        params = kern.init(SEED, device=dev, dtype=torch.float32)
        eng = ServeEngine(kern, {"serving": _lora_cfg()}, params=params,
                          device=dev)
        reqs = _paged_waves(eng, tenants)
        eng.close()
        _check_requests("serve_lora fp32", reqs)
        prompts = [list(r.prompt) for r in reqs]
        for t in range(LORA_TENANTS):
            merged = params if t == 0 else merge_adapter(
                params, eng.adapter_registry.get(t), eng.lora_scale)
            sel = [i for i in range(n_req) if tenants[i] == t]
            ref = _serve(dense, merged, {"serving": {
                **PAGED_CFG, "decode_impl": "dense"}},
                [prompts[i] for i in sel], dev)
            _compare_streams(f"LoRA tenant {t} kernel path vs dense-merged "
                             "path", [reqs[i] for i in sel], ref,
                             [prompts[i] for i in sel], dense_cfg, merged)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    tps0, tpot0, _ = paged_ref["rates"]
    print(f"[serve_lora] LoRA {LORA}, {n_req} requests on tenants 0-"
          f"{LORA_TENANTS - 1}: adapter hits {hits}, faults {faults}, "
          f"evictions {evictions}; adapter bytes {mixed['adapter_bytes']}; "
          f"bf16 {mixed['rates'][0]:.1f} tokens/s, TPOT p50 "
          f"{mixed['rates'][1] * 1e3:.3f} ms against serve_paged's "
          f"{tps0:.1f} tokens/s, {tpot0 * 1e3:.3f} ms; tenant 0 alone "
          f"{zero['rates'][0]:.1f} tokens/s; int8 "
          f"{qmixed['rates'][0]:.1f} tokens/s (serve_quant "
          f"{quant_ref['rates'][0]:.1f}); speculative "
          f"{spec['rates'][0]:.1f} tokens/s, "
          f"{(accepted + req_passes) / req_passes:.3f} tokens per target "
          f"pass per request; tenant 0 bitwise equal to lora-off on bf16 "
          f"and int8; {smi()}")
    return total, {"mixed": mixed, "spec": spec, "tenants": tenants}


#: one line of the Prometheus text exposition format
_PROM_LINE = re.compile(
    r"^(?:# (?:HELP|TYPE) [a-zA-Z_:][a-zA-Z0-9_:]* .+"
    r"|[a-zA-Z_:][a-zA-Z0-9_:]*(?:\{[^{}]*\})? \S+)$")


def _check_artifacts(label, root):
    """trace.json parses (every event with ph/ts/name) and metrics.prom
    parses line by line (the exposition format's line grammar)."""
    with open(os.path.join(root, "trace.json")) as f:
        evs = json.load(f)["traceEvents"]
    if not evs or not all("ph" in e and "ts" in e and "name" in e
                          for e in evs):
        fail(f"serve_telemetry {label}: trace.json has no events or an "
             "event without ph/ts/name")
    with open(os.path.join(root, "metrics.prom")) as f:
        bad = [ln for ln in f.read().splitlines()
               if ln.strip() and not _PROM_LINE.match(ln)]
    if bad:
        fail(f"serve_telemetry {label}: metrics.prom lines {bad[:3]}")
    return len(evs)


def _summary_equal(label, summary, want):
    bad = {k: (summary.get(k), v) for k, v in want.items()
           if summary.get(k) is None or abs(summary[k] - v) > 1e-9 *
           max(1.0, abs(v))}
    if bad:
        fail(f"serve_telemetry {label}: summarize against the engine: "
             f"{bad}")


def _sync_count(run):
    """``run()`` under ``torch.cuda.set_sync_debug_mode('warn')``: its
    result and the synchronizing calls it made."""
    import warnings
    import torch
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = run()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("called a synchronizing CUDA operation" in
                    str(w.message) for w in rec)


def phase_serve_telemetry(dev, lora_ref, kv_streams):
    """serve_lora's bf16 run (plain and speculative) and serve_kv_tier's
    bf16 run with ``telemetry.enabled`` into temporary directories: the
    streams equal the telemetry-off runs'; ``summarize`` of each
    events.jsonl gives the adapter, prefix, speculation and KV-tier
    scalars equal to the engine's own counters; trace.json and
    metrics.prom parse; the plain run counted under sync debug mode makes
    as many synchronizing calls with telemetry as without."""
    import shutil
    import tempfile
    import torch
    from deepspeed_tpu_torch.telemetry.cli import summarize
    tenants = lora_ref["tenants"]
    total = {}
    root = tempfile.mkdtemp(prefix="chip_smoke_tel_")
    try:
        def tel(name):
            return {"telemetry": {"enabled": True,
                                  "output_path": os.path.join(root, name)}}

        def add(run):
            for name, n in run["launches"].items():
                total[name] = total.get(name, 0) + n
            return run

        off, syncs_off = _sync_count(lambda: add(_lora_run(
            "serve_telemetry off", dev, _lora_cfg(), tenants,
            "decode_paged")))
        on, syncs_on = _sync_count(lambda: add(_lora_run(
            "serve_telemetry on", dev, _lora_cfg(), tenants, "decode_paged",
            extra=tel("lora"))))
        if not on["streams"] == off["streams"] == lora_ref["mixed"]["streams"]:
            fail("serve_telemetry: the LoRA streams with telemetry differ "
                 "from those without")
        if syncs_on != syncs_off:
            fail(f"serve_telemetry: {syncs_on} synchronizing calls with "
                 f"telemetry, {syncs_off} without")
        rep = summarize(os.path.join(root, "lora", "events.jsonl"))
        _summary_equal("lora", rep, on["stats"])
        n_lora = _check_artifacts("lora", os.path.join(root, "lora"))

        spec = add(_lora_run("serve_telemetry spec", dev,
                             {**_lora_cfg(), **SPEC}, tenants,
                             "decode_paged_multi", spec=True,
                             extra=tel("spec")))
        if spec["streams"] != lora_ref["spec"]["streams"]:
            fail("serve_telemetry: the speculative LoRA streams with "
                 "telemetry differ from those without")
        srep = summarize(os.path.join(root, "spec", "events.jsonl"))
        _summary_equal("spec", srep, spec["stats"])
        _check_artifacts("spec", os.path.join(root, "spec"))

        disk = os.path.join(root, "kv_pages")
        os.makedirs(disk)
        kv = _kv_tier_run(dev, False, disk, extra=tel("kv"))
        for name, n in kv["launches"].items():
            total[name] = total.get(name, 0) + n
        if kv["streams"] != kv_streams:
            fail("serve_telemetry: the KV-tier streams with telemetry "
                 "differ from those without")
        krep = summarize(os.path.join(root, "kv", "events.jsonl"))
        _summary_equal("kv", krep, {
            "serve_kv_spill_bytes_total": kv["spill_total"],
            "serve_kv_fetch_bytes_total": kv["fetch_total"]})
        if krep["serve_kv_parked_sessions"] is None \
                or krep["serve_kv_resume_p99_s"] is None:
            fail("serve_telemetry: summarize has no KV-tier parked "
                 "sessions or resume p99")
        _check_artifacts("kv", os.path.join(root, "kv"))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"[serve_telemetry] LoRA bf16 run: {on['rates'][0]:.1f} tokens/s "
          f"with telemetry, {off['rates'][0]:.1f} without (TPOT p50 "
          f"{on['rates'][1] * 1e3:.3f} / {off['rates'][1] * 1e3:.3f} ms); "
          f"{syncs_on} synchronizing calls with telemetry, {syncs_off} "
          f"without, over {on['ticks']} decode ticks; {n_lora} trace "
          f"events; summarize equal to the engines' counters (adapters "
          f"{rep['serve_adapter_hits_total']:.0f} hits, "
          f"{rep['serve_adapter_faults_total']:.0f} faults, "
          f"{rep['serve_adapter_evictions_total']:.0f} evictions; prefix "
          f"{rep['serve_prefix_hit_tokens']:.0f} tokens reused; spec "
          f"{srep['serve_spec_mean_accepted_len']:.3f} tokens per pass; "
          f"KV tier spill {krep['serve_kv_spill_bytes_total']:.0f} B, fetch "
          f"{krep['serve_kv_fetch_bytes_total']:.0f} B); streams equal to "
          f"the telemetry-off runs'; {smi()}")
    return total


def _compare_streams(label, ours, ref, prompts, cfg, params):
    """Greedy streams equal, a flip allowed only on a near tie (top-2
    logit gap below NEAR_TIE at that step of ``cfg`` with ``params``,
    reported with its gap)."""
    import torch
    from deepspeed_tpu_torch.models.gpt2 import gpt2_prefill
    flips = 0
    for p, a, b in zip(prompts, ours, ref):
        if a.tokens == b.tokens:
            continue
        i = next(i for i, (x, y) in enumerate(zip(a.tokens, b.tokens))
                 if x != y)
        logits, _, _ = gpt2_prefill(cfg, params, torch.tensor(
            [p + b.tokens[:i]], device=params["wte"].device))
        top = torch.topk(logits[0, -1].float(), 2).values
        gap = float(top[0] - top[1])
        print(f"[parity] {label}, request {a.rid}: flip at token {i} "
              f"({a.tokens[i]} vs {b.tokens[i]}), top-2 logit gap "
              f"{gap:.3g}")
        if not gap < NEAR_TIE:
            fail(f"{label}: request {a.rid} diverges at token {i} with "
                 f"gap {gap}")
        flips += 1
    print(f"[parity] fp32 {label}: {len(ref) - flips}/{len(ref)} greedy "
          f"streams equal, {flips} near-tie flips")


def phase_parity(dev):
    """fp32, TF32 off: the dense path's greedy streams against the kernel
    path's on the slot cache and the paged pool, and against the
    speculative path's on both; then, quantized (int8 weights and pool),
    the kernel path's and the speculative path's streams against the
    quantized dense path's and each other, and the int8 streams' token
    agreement with the fp ones (reported)."""
    import torch
    from deepspeed_tpu_torch.inference.quantize import quantize_gpt2_params
    from deepspeed_tpu_torch.models.gpt2 import (GPT2_SMALL, GPT2Config,
                                                 GPT2Model)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kern = GPT2Model(GPT2_SMALL)
    dense_cfg = GPT2Config(**{**GPT2_SMALL.__dict__, "attn_impl": "dense"})
    dense = GPT2Model(dense_cfg)
    params = kern.init(SEED, device=dev, dtype=torch.float32)
    prompts = _load()
    ref = _serve(dense, params, {"serving": {**SLOT_CFG,
                                             "decode_impl": "dense"}},
                 prompts, dev)
    paged = {**SLOT_CFG, "page_len": PAGED_CFG["page_len"]}
    for label, cfg, draft in (
            ("kernel path", SLOT_CFG, None),
            ("paged kernel path", paged, None),
            ("speculative path", {**SLOT_CFG, **SPEC}, _draft_params(params)),
            ("speculative paged path", {**paged, **SPEC},
             _draft_params(params))):
        ours = _serve(kern, params, {"serving": cfg}, prompts, dev,
                      draft_params=draft)
        _compare_streams(f"{label} vs dense path", ours, ref, prompts,
                         dense_cfg, params)
    qpaged = {**paged, "quantization": QUANT}
    qparams = quantize_gpt2_params(params)
    qref = _serve(dense, params, {"serving": {**qpaged,
                                              "decode_impl": "dense"}},
                  prompts, dev)
    qkern = _serve(kern, params, {"serving": qpaged}, prompts, dev)
    qspec = _serve(kern, params, {"serving": {**qpaged, **SPEC}}, prompts,
                   dev, draft_params=_draft_params(params))
    for label, ours, against in (
            ("int8 paged kernel path vs int8 dense path", qkern, qref),
            ("int8 speculative paged path vs int8 dense path", qspec, qref),
            ("int8 speculative vs int8 non-speculative kernel path", qspec,
             qkern)):
        _compare_streams(label, ours, against, prompts, dense_cfg, qparams)
    same = total = 0
    for a, b in zip(qkern, ref):
        same += sum(x == y for x, y in zip(a.tokens, b.tokens))
        total += len(b.tokens)
    print(f"[parity] int8 (weights and KV) kernel path vs fp dense path: "
          f"{same}/{total} tokens agree ({same / total:.4f}; reported, "
          "not asserted)")


def _counted():
    """Every kernel wrapper's launch count as (wrapper, attribute), by
    kernel name: the paged arms count their int8 pool launches apart."""
    from deepspeed_tpu_torch.ops.kernels import launch_counters
    return launch_counters()


def _counts():
    """Every kernel wrapper's launch count, by kernel name."""
    return {name: getattr(fn, attr)
            for name, (fn, attr) in _counted().items()}


def _train_counts():
    counts = _counts()
    return {k: counts[k] for k in ("flash_fwd", "flash_bwd_dq",
                                   "flash_bwd_dkv")}


def _zero_counts():
    for fn, attr in _counted().values():
        setattr(fn, attr, 0)


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
    _checkpointing_case(dev)
    return launches


#: activation_checkpointing: the checkpointed blocks' grads against the
#: plain blocks' (fp32, relative to each gradient's largest magnitude)
CKPT_BLOCKS, CKPT_RTOL = 4, 1e-6


def _checkpointing_case(dev):
    """``runtime.activation_checkpointing``: four GPT-2 small blocks (fp32,
    the flash kernels, dropout 0.1) on [2, 1024, 768], plain, through
    ``checkpoint`` (recomputed) and through it with ``cpu_checkpointing``
    (run once, what the backward saves kept in pinned host memory): the
    gradients of every block parameter and of the input within
    ``CKPT_RTOL`` of the plain blocks', and the CUDA memory allocated
    between the forward and the backward (it must fall under
    ``cpu_checkpointing``).  Outside the timed steps: not counted."""
    import dataclasses
    import torch
    from deepspeed_tpu_torch.models.gpt2 import (GPT2_SMALL, GPT2Model,
                                                 gpt2_block_forward)
    from deepspeed_tpu_torch.runtime.activation_checkpointing import (
        checkpointing as ac)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(GPT2_SMALL, dropout=0.1, remat=None,
                              n_layer=CKPT_BLOCKS)
    blocks = GPT2Model(cfg).init(SEED, device=dev)["blocks"]
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 10)
    x0 = torch.randn((2, cfg.n_positions, cfg.d_model), generator=g,
                     device=dev)
    cot = torch.randn(x0.shape, generator=g, device=dev)

    def run(ckpt):
        params = {k: v.clone().requires_grad_() for k, v in blocks.items()}
        x = x0.clone().requires_grad_()

        def four(h):
            for i in range(CKPT_BLOCKS):
                h = gpt2_block_forward(cfg, {k: v[i] for k, v in
                                             params.items()}, h, SEED + i,
                                       True)
            return h
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated(dev)
        out = ckpt(four, x)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated(dev) - before
        (out * cot).sum().backward()
        grads = {k: v.grad for k, v in params.items()}
        grads["x"] = x.grad
        return grads, held

    plain, held_plain = run(lambda f, x: f(x))
    ac.reset()
    recomputed, held_re = run(ac.checkpoint)
    ac.configure(checkpoint_in_cpu=True)
    ac.offload_stats.clear()
    try:
        host, held_cpu = run(ac.checkpoint)
    finally:
        ac.reset()
    moved = dict(ac.offload_stats)
    err = {name: max(_normwise(got[k], plain[k]) for k in plain)
           for name, got in (("checkpoint", recomputed),
                             ("cpu_checkpointing", host))}
    mib = 2 ** 20
    print(f"[train] activation_checkpointing over {CKPT_BLOCKS} GPT-2 small "
          f"blocks (fp32, flash, dropout 0.1, [2, {cfg.n_positions}, "
          f"{cfg.d_model}]): grads vs the plain blocks', normwise: "
          f"checkpoint {err['checkpoint']:.3g}, cpu_checkpointing "
          f"{err['cpu_checkpointing']:.3g} (bar {CKPT_RTOL}); CUDA memory "
          f"held between forward and backward: plain "
          f"{held_plain / mib:.1f} MiB, checkpoint {held_re / mib:.1f} MiB, "
          f"cpu_checkpointing {held_cpu / mib:.1f} MiB ("
          f"{(held_plain - held_cpu) / mib:.1f} MiB less than plain; "
          f"{moved.get('tensors', 0)} saved tensors, "
          f"{moved.get('bytes', 0) / mib:.1f} MiB, kept in pinned host "
          f"memory) [{smi()}]")
    if not max(err.values()) <= CKPT_RTOL:
        fail(f"train: checkpointed grads differ from the plain blocks': "
             f"{err}")
    if not (held_cpu < held_plain and moved.get("restored", 0)
            == moved.get("tensors", -1) > 0):
        fail(f"train: cpu_checkpointing held {held_cpu} B on the card "
             f"(plain {held_plain} B), host hooks {moved}")


ZERO_STAGES = (0, 1, 2, 3)
ZERO_STEPS, BERT_ZERO_STEPS = 4, 3
#: the env contract train_zero sets for initialize()
ZERO_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK")
NCCL_PROBE_TIMEOUT_S = 90

_NCCL_PROBE = r"""
import datetime, os, sys
import torch, torch.distributed as dist
rank = int(sys.argv[1])
torch.cuda.set_device(0)
dist.init_process_group("nccl", init_method=sys.argv[2], rank=rank,
                        world_size=2,
                        timeout=datetime.timedelta(seconds=60))
x = torch.full((4,), float(rank + 1), device="cuda")
dist.all_reduce(x)
torch.cuda.synchronize()
print("sum", x.tolist(), flush=True)
dist.destroy_process_group()
"""


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _nccl_two_ranks_on_one_card() -> str:
    """Two processes join one 2-rank NCCL group, both on cuda:0, and
    all-reduce: what NCCL does there (a fact of the machine, printed)."""
    init = f"tcp://127.0.0.1:{_free_port()}"
    env = dict(os.environ, NCCL_DEBUG="WARN")
    procs = [subprocess.Popen([sys.executable, "-c", _NCCL_PROBE, str(r),
                               init], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env)
             for r in range(2)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=NCCL_PROBE_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
            out = f"timed out after {NCCL_PROBE_TIMEOUT_S} s\n{out}"
        outs.append((p.returncode, out))
    if all(rc == 0 and "sum [3.0" in out for rc, out in outs):
        return "accepted: both ranks all-reduced to 3.0"
    text = [ln for _, out in outs for ln in out.splitlines()]
    lines = ([ln for ln in text if "Duplicate GPU" in ln]
             or [ln for ln in text if "rror" in ln])
    return (f"refused (exit codes {[rc for rc, _ in outs]}): "
            + (lines[0].strip()[:300] if lines else outs[0][1][-300:]))


def _nccl_trace(eng, tokens) -> dict:
    """One step under ``torch.profiler``: the c10d ``nccl:*`` ranges and
    the device work NCCL issued (kernels or copies), count and device ms
    each."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        eng.train_batch(tokens)
        torch.cuda.synchronize()
    host, device = {}, {}
    for e in prof.key_averages():
        dev_us = getattr(e, "device_time_total",
                         getattr(e, "cuda_time_total", 0))
        if e.key.startswith("nccl:"):
            host[e.key] = (e.count, dev_us / 1e3)
        elif "nccl" in e.key.lower() or e.key.startswith("Memcpy DtoD"):
            device[e.key] = (e.count, dev_us / 1e3)
    return {"ranges": host, "device": device}


def _zero_run(label, build, batch, steps, dev, trace=False):
    """One engine: 1 warm step (the NCCL communicators start), then
    ``steps`` counted steps under sync debug mode 'error'.  Returns the
    losses, launches, step ms, peak MiB and (``trace``) the NCCL trace."""
    import torch
    import torch.distributed as dist
    gc.collect()    # earlier engines' reference cycles: each stage's
    torch.cuda.empty_cache()    # peak then counts its own engine alone
    eng = build()
    if eng.mesh.is_local or dist.get_backend() != "nccl":
        fail(f"{label}: the engine is not on an NCCL process group")
    if eng.device != dev:
        fail(f"{label}: initialize() placed the engine on {eng.device}")
    losses = [eng.train_batch(batch)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _zero_counts()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(steps):
            losses.append(eng.train_batch(batch))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _train_counts()
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 20
    out = {"losses": [float(x) for x in losses], "launches": launches,
           "step_ms": wall / steps * 1e3, "peak_mib": peak,
           "skipped": eng.get_skipped_steps()}
    if trace:
        out["trace"] = _nccl_trace(eng, batch)
    eng.close()
    return out


def phase_train_zero(dev):
    """Data parallelism and ZeRO 0-3 through ``initialize()`` on a real
    NCCL process group of one rank: GPT-2 small (phase train's model and
    config) and BERT-large with LAMB."""
    import dataclasses
    import torch
    import torch.distributed as dist
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.bert import BERT_LARGE, BertModel
    from deepspeed_tpu_torch.models.gpt2 import GPT2_SMALL, GPT2Model

    saved = {k: os.environ.get(k) for k in ZERO_ENV}
    os.environ.update({"MASTER_ADDR": "127.0.0.1",
                       "MASTER_PORT": str(_free_port()), "RANK": "0",
                       "WORLD_SIZE": "1", "LOCAL_RANK": "0"})
    total = {k: 0 for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    try:
        cfg = dataclasses.replace(GPT2_SMALL, dropout=0.1, embd_dropout=0.1,
                                  remat="block")
        T = cfg.n_positions
        tokens = torch.from_numpy(np.random.default_rng(SEED).integers(
            0, cfg.vocab_size, (TRAIN_MICRO * TRAIN_GA, T + 1))).to(dev)
        L, A = cfg.n_layer, TRAIN_GA
        want = {"flash_fwd": 2 * L * A, "flash_bwd_dq": L * A,
                "flash_bwd_dkv": L * A}
        runs = {}
        for stage in ZERO_STAGES:
            def build(stage=stage):
                conf = _train_config({"bf16": {"enabled": True}},
                                     TRAIN_MICRO, TRAIN_GA)
                conf["zero_optimization"] = {"stage": stage}
                return deepspeed_tpu_torch.initialize(
                    model=GPT2Model(cfg), seed=SEED, config=conf)[0]
            r = runs[stage] = _zero_run(f"train_zero stage {stage}", build,
                                        tokens, ZERO_STEPS, dev,
                                        trace=stage == 3)
            for name, per_step in want.items():
                total[name] += r["launches"][name]
                if r["launches"][name] != per_step * ZERO_STEPS:
                    fail(f"train_zero stage {stage}: {name} launched "
                         f"{r['launches'][name]} times in {ZERO_STEPS} "
                         f"steps, expected {per_step} per step")
            if not all(np.isfinite(r["losses"])) or r["skipped"]:
                fail(f"train_zero stage {stage}: losses {r['losses']}, "
                     f"{r['skipped']} skipped steps")
            print(f"[train_zero] GPT-2 small bf16 ZeRO stage {stage} on "
                  f"NCCL (world 1): {r['step_ms']:.1f} ms per step over "
                  f"{ZERO_STEPS} steps, peak memory {r['peak_mib']:.1f} "
                  f"MiB; losses {' '.join(f'{x:.6f}' for x in r['losses'])}")
        base = runs[0]["losses"]
        for stage in ZERO_STAGES[1:]:
            if runs[stage]["losses"] != base:
                fail(f"train_zero: stage {stage}'s losses "
                     f"{runs[stage]['losses']} differ from stage 0's {base}")
        print(f"[train_zero] stages 1-3's losses equal stage 0's bitwise "
              f"({len(base)} steps each)")
        print(f"[train_zero] launches per step, every stage: flash_fwd "
              f"{want['flash_fwd']} (= 2 x {L} x {A}), flash_bwd_dq "
              f"{want['flash_bwd_dq']}, flash_bwd_dkv {want['flash_bwd_dkv']}"
              f" (= {L} x {A}); {ZERO_STEPS} steps a stage queued with no "
              "host sync (torch.cuda sync debug mode 'error')")
        trace = runs[3]["trace"]
        if not trace["ranges"]:
            fail("train_zero: the stage-3 step's trace holds no nccl:* op")
        print("[train_zero] stage-3 step trace, c10d NCCL ranges (calls, "
              "device ms): " + "; ".join(
                  f"{k} {c} {ms:.3f}" for k, (c, ms) in
                  sorted(trace["ranges"].items())))
        print("[train_zero] device work under them (calls, device ms): "
              + ("; ".join(f"{k} {c} {ms:.3f}" for k, (c, ms) in
                           sorted(trace["device"].items()))
                 or "none recorded (one rank: NCCL moves nothing)"))

        bcfg = dataclasses.replace(BERT_LARGE, remat="block")
        batch = {k: torch.from_numpy(v).to(dev) for k, v in mlm_batch(
            BERT_MICRO, BERT_SEQ, bcfg.vocab_size, SEED).items()}
        bert = {}
        for stage in (1, 0):
            def build(stage=stage):
                conf = lamb_config({"bf16": {"enabled": True}}, BERT_MICRO)
                conf["zero_optimization"] = {"stage": stage}
                return deepspeed_tpu_torch.initialize(
                    model=BertModel(bcfg), seed=SEED, config=conf)[0]
            r = bert[stage] = _zero_run(f"train_zero BERT stage {stage}",
                                        build, batch, BERT_ZERO_STEPS, dev)
            for name in total:
                total[name] += r["launches"][name]
            print(f"[train_zero] BERT-large bf16 LAMB ZeRO stage {stage}: "
                  f"{r['step_ms']:.1f} ms per step, peak memory "
                  f"{r['peak_mib']:.1f} MiB; losses "
                  f"{' '.join(f'{x:.6f}' for x in r['losses'])}")
        losses = bert[1]["losses"]
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            fail(f"train_zero: BERT LAMB stage 1 losses not finite and "
                 f"falling: {losses}")
        if losses != bert[0]["losses"]:
            fail(f"train_zero: BERT LAMB stage 1 losses {losses} differ "
                 f"from stage 0's {bert[0]['losses']}")
        print("[train_zero] BERT-large LAMB stage 1 (examples/"
              "bert_pretrain.py's configuration) runs; its losses equal "
              "stage 0's bitwise")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    print(f"[train_zero] NCCL with two ranks on the one card: "
          f"{_nccl_two_ranks_on_one_card()}")
    return total


@contextlib.contextmanager
def _one_rank_group():
    """The env contract of one rank (127.0.0.1, a free port) and a real
    NCCL process group over it; the group destroyed and the env restored
    after."""
    import torch.distributed as dist
    from deepspeed_tpu_torch.parallel import init_distributed
    saved = {k: os.environ.get(k) for k in ZERO_ENV}
    os.environ.update({"MASTER_ADDR": "127.0.0.1",
                       "MASTER_PORT": str(_free_port()), "RANK": "0",
                       "WORLD_SIZE": "1", "LOCAL_RANK": "0"})
    try:
        init_distributed(device="cuda")
        if dist.get_backend() != "nccl":
            fail("the one-rank process group is not on NCCL")
        yield
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


#: train_pipe: GPT-2 small in 8 micro-batches of 1 x 1024 tokens
PIPE_MICRO, PIPE_GA, PIPE_STEPS, PIPE_PP2_STEPS = 1, 8, 5, 3
PIPE_FP32_STEPS, PIPE_PARITY_STEPS = 3, 2
#: BERT-large through build_bert_pipe: 4 micro-batches of 2 x 512 tokens
PIPE_BERT_MICRO, PIPE_BERT_GA, PIPE_BERT_STEPS = 2, 4, 2
PIPE_RANK_TIMEOUT_S = 300
PIPE_FP32_RTOL, PIPE_BF16_RTOL = 1e-5, 1e-2

_PIPE_RANK = r"""
import sys
sys.path.insert(0, sys.argv[1])
import chip_smoke
chip_smoke.pipe_rank(int(sys.argv[2]), sys.argv[3], float(sys.argv[4]),
                     int(sys.argv[5]), sys.argv[6])
"""


def _pipe_cfg(dtype_block: dict, schedule: str = "1f1b") -> dict:
    conf = _train_config(dtype_block, PIPE_MICRO, PIPE_GA)
    conf["pipeline"] = {"schedule": schedule}
    return conf


def _pipe_model_cfg(dropout: float, impl: str = "flash"):
    import dataclasses
    from deepspeed_tpu_torch.models.gpt2 import GPT2_SMALL
    return dataclasses.replace(GPT2_SMALL, dropout=dropout,
                               embd_dropout=dropout, attn_impl=impl)


def _pipe_tokens():
    from deepspeed_tpu_torch.models.gpt2 import GPT2_SMALL
    return np.random.default_rng(SEED + 5).integers(
        0, GPT2_SMALL.vocab_size,
        (PIPE_MICRO * PIPE_GA, GPT2_SMALL.n_positions + 1))


def _pipe_tree():
    """The one weight tree every train_pipe arm starts from: the pp-1
    module's init at SEED (numpy arrays), and its digest."""
    from deepspeed_tpu_torch.models.gpt2_pipe import build_gpt2_pipe
    from deepspeed_tpu_torch.runtime.utils import tree_leaves
    tree = build_gpt2_pipe(_pipe_model_cfg(0.0), 1).init(SEED)
    digest = float(sum(np.abs(x.numpy()).astype(np.float64).sum()
                       for x in tree_leaves(tree)))
    return tree, digest


def _pipe_steps(eng, batch, steps, dev):
    """``steps`` steps: losses, launches, step ms (the steps after the
    first), peak MiB and the point-to-point counters of those steps."""
    import torch
    losses = [float(eng.train_batch(batch))]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    eng.channel.stats.reset()
    _zero_counts()
    t0 = time.perf_counter()
    for _ in range(steps - 1):
        losses.append(float(eng.train_batch(batch)))
    torch.cuda.synchronize()
    n = max(steps - 1, 1)
    return {"losses": losses, "launches": _train_counts(),
            "step_ms": (time.perf_counter() - t0) / n * 1e3,
            "peak_mib": torch.cuda.max_memory_allocated(dev) / 2 ** 20,
            "p2p": {k: v / n for k, v in eng.channel.stats.as_dict().items()},
            "max_live": eng.max_live_boundaries}


def pipe_rank(rank: int, init: str, digest: float, world: int = 2,
              backend: str = "gloo") -> None:
    """One stage of GPT-2 small at pp ``world``, from the same weight tree
    as train_pipe's leg (a): over gloo every process on cuda:0 (train_pipe's
    leg (b)), over NCCL one card a process (``profile_pipe_torch.py``).
    Prints one ``PIPE_RANK`` JSON line."""
    import datetime
    import torch
    import torch.distributed as dist
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.gpt2_pipe import (build_gpt2_pipe,
                                                      split_gpt2_batch)
    from deepspeed_tpu_torch.parallel import build_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", rank if backend == "nccl" else 0)
    torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=240))
    out = {"rank": rank}
    try:
        tree, mine = _pipe_tree()
        if mine != digest:
            raise AssertionError(f"rank {rank}: weight tree digest {mine} "
                                 f"!= leg (a)'s {digest}")
        mesh = build_mesh(pp=world)
        batch = split_gpt2_batch(torch.from_numpy(_pipe_tokens()).to(dev))
        for label, block in (("fp32", {}),
                             ("bf16", {"bf16": {"enabled": True}})):
            gc.collect()
            torch.cuda.empty_cache()
            eng = deepspeed_tpu_torch.initialize(
                model=build_gpt2_pipe(_pipe_model_cfg(0.1), world),
                mesh=mesh, params=tree, seed=SEED, config=_pipe_cfg(block),
                device=dev)[0]
            if eng.channel.staged != (backend == "gloo"):
                raise AssertionError(
                    "a gloo pipe group stages CUDA tensors through pinned "
                    "host buffers, an NCCL group sends them as they are")
            out[label] = _pipe_steps(eng, batch, PIPE_PP2_STEPS, dev)
            out[label]["stage"] = eng.stage_id
            eng.close()
        dist.barrier()
    finally:
        dist.destroy_process_group()
    print("PIPE_RANK " + json.dumps(out), flush=True)


def _pipe_ranks(digest: float, world: int = 2, backend: str = "gloo",
                script: str = _PIPE_RANK, tag: str = "PIPE_RANK") -> list:
    """``world`` processes, each one stage (:func:`pipe_rank`; with
    ``_SEQ_RANK``/``"SEQ_RANK"`` one seq rank, :func:`seq_rank`); their
    results."""
    init = f"tcp://127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, "-c", script, HERE, str(r), init, repr(digest),
         str(world), backend],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=PIPE_RANK_TIMEOUT_S)
            outs.append((p.returncode, out))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    res = []
    for r, (rc, out) in enumerate(outs):
        lines = [ln for ln in out.splitlines() if ln.startswith(tag + " ")]
        if rc != 0 or not lines:
            fail(f"{tag} {r} of {world} ({backend}) exited "
                 f"{rc}:\n{out[-3000:]}")
        res.append(json.loads(lines[-1][len(tag) + 1:]))
    return res


def phase_train_pipe(dev, card: str):
    """Pipeline parallelism through ``initialize(model=PipelineModule)``:
    GPT-2 small at full width and depth, bf16, 8 micro-batches of 1 x 1024
    tokens, dropout 0.1, Adam, clipping 1.0.  (a) pp 1 on a one-rank
    NCCL group, 1F1B against GPipe and the fp32 kernels against the dense
    attention; (b) pp 2, two processes on cuda:0 over a gloo pipe group,
    against (a); (c) BERT-large through ``build_bert_pipe`` with LAMB."""
    import dataclasses
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.bert import BERT_LARGE
    from deepspeed_tpu_torch.models.bert_pipe import build_bert_pipe
    from deepspeed_tpu_torch.models.gpt2_pipe import (build_gpt2_pipe,
                                                      split_gpt2_batch)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tree, digest = _pipe_tree()
    batch = split_gpt2_batch(torch.from_numpy(_pipe_tokens()).to(dev))
    L, M = 12, PIPE_GA
    want = {"flash_fwd": 2 * L * M, "flash_bwd_dq": L * M,
            "flash_bwd_dkv": L * M}
    total = dict.fromkeys(want, 0)

    def check(label, r, per_step, steps):
        for name, n in per_step.items():
            got = r["launches"][name]
            total[name] += got
            if got != n * steps:
                fail(f"train_pipe {label}: {name} launched {got} times in "
                     f"{steps} steps, expected {n} per step")
        if not all(np.isfinite(r["losses"])):
            fail(f"train_pipe {label}: losses {r['losses']}")

    def engine(model_cfg, block, schedule="1f1b", stages=1):
        gc.collect()
        torch.cuda.empty_cache()
        eng = deepspeed_tpu_torch.initialize(
            model=build_gpt2_pipe(model_cfg, stages), params=tree, seed=SEED,
            config=_pipe_cfg(block, schedule))[0]
        if eng.device != dev:
            fail(f"train_pipe: initialize() placed the engine on "
                 f"{eng.device}")
        return eng

    runs = {}
    with _one_rank_group():
        bf16 = {"bf16": {"enabled": True}}
        for sched in ("1f1b", "gpipe"):
            eng = engine(_pipe_model_cfg(0.1), bf16, sched)
            runs[sched] = r = _pipe_steps(eng, batch, PIPE_STEPS, dev)
            eng.close()
            check(f"(a) bf16 {sched}", r, want, PIPE_STEPS - 1)
            print(f"[train_pipe] (a) GPT-2 small bf16 pp 1 {sched} on NCCL "
                  f"(world 1), {M} micro-batches of {PIPE_MICRO} x 1024 "
                  f"tokens, dropout 0.1: {r['step_ms']:.1f} ms per step, "
                  f"peak {r['peak_mib']:.1f} MiB, boundary inputs held "
                  f"{r['max_live']}; losses "
                  f"{' '.join(f'{x:.6f}' for x in r['losses'])} [{card}]")
        a, g = runs["1f1b"]["losses"], runs["gpipe"]["losses"]
        worst = max(abs(x - y) / abs(y) for x, y in zip(a, g))
        if not worst <= PIPE_FP32_RTOL:
            fail(f"train_pipe (a): 1F1B losses {a} differ from GPipe's {g}")
        print(f"[train_pipe] (a) 1F1B vs GPipe at one stage: "
              f"{'bitwise equal' if a == g else f'max rel diff {worst:.3g}'}"
              f" over {PIPE_STEPS} steps [{card}]")
        eng = engine(_pipe_model_cfg(0.1), {})
        runs["fp32"] = r = _pipe_steps(eng, batch, PIPE_FP32_STEPS, dev)
        eng.close()
        check("(a) fp32", r, want, PIPE_FP32_STEPS - 1)
        print(f"[train_pipe] (a) fp32 pp 1 1F1B, dropout 0.1: "
              f"{r['step_ms']:.1f} ms per step, peak {r['peak_mib']:.1f} "
              f"MiB; losses {' '.join(f'{x:.6f}' for x in r['losses'])} "
              f"[{card}]")
        parity = {}
        for impl in ("flash", "dense"):
            eng = engine(_pipe_model_cfg(0.0, impl), {})
            parity[impl] = _pipe_steps(eng, batch, PIPE_PARITY_STEPS, dev)
            eng.close()
            check(f"(a) fp32 {impl}", parity[impl],
                  want if impl == "flash" else dict.fromkeys(want, 0),
                  PIPE_PARITY_STEPS - 1)
        kf, kd = parity["flash"]["losses"], parity["dense"]["losses"]
        worst = max(abs(x - y) / abs(y) for x, y in zip(kf, kd))
        print(f"[train_pipe] (a) fp32 kernels vs dense attention, dropout "
              f"0, {PIPE_PARITY_STEPS} steps: {kf} vs {kd}; max rel diff "
              f"{worst:.3g} (bar 1e-4) [{card}]")
        if not worst <= 1e-4:
            fail(f"train_pipe (a): fp32 kernel losses {kf} differ from the "
                 f"dense path's {kd} by {worst}")

        # (c) BERT-large through build_bert_pipe, LAMB, bf16
        bcfg = dataclasses.replace(BERT_LARGE)
        mb = mlm_batch(PIPE_BERT_MICRO * PIPE_BERT_GA, BERT_SEQ,
                       bcfg.vocab_size, SEED)
        bbatch = (torch.from_numpy(mb["input_ids"]).to(dev),
                  torch.from_numpy(mb["masked_lm_labels"]).to(dev))
        gc.collect()
        torch.cuda.empty_cache()
        conf = lamb_config(bf16, PIPE_BERT_MICRO)
        conf["gradient_accumulation_steps"] = PIPE_BERT_GA
        eng = deepspeed_tpu_torch.initialize(
            model=build_bert_pipe(bcfg, 1), seed=SEED, config=conf)[0]
        runs["bert"] = r = _pipe_steps(eng, bbatch, PIPE_BERT_STEPS, dev)
        eng.close()
        BL = bcfg.num_hidden_layers
        check("(c) BERT-large LAMB", r,
              {"flash_fwd": 2 * BL * PIPE_BERT_GA,
               "flash_bwd_dq": BL * PIPE_BERT_GA,
               "flash_bwd_dkv": BL * PIPE_BERT_GA}, PIPE_BERT_STEPS - 1)
        print(f"[train_pipe] (c) BERT-large bf16 LAMB through "
              f"build_bert_pipe (pp 1), {PIPE_BERT_GA} micro-batches of "
              f"{PIPE_BERT_MICRO} x {BERT_SEQ}: {r['step_ms']:.1f} ms per "
              f"step, peak {r['peak_mib']:.1f} MiB; losses "
              f"{' '.join(f'{x:.6f}' for x in r['losses'])} [{card}]")

    # (b) pp 2: two processes on cuda:0 over a gloo pipe group
    ranks = _pipe_ranks(digest)
    half = {k: v // 2 for k, v in want.items()}
    for res in ranks:
        s = res["fp32"]["stage"]
        for label in ("fp32", "bf16"):
            r = res[label]
            check(f"(b) {label} stage {s}", r, half, PIPE_PP2_STEPS - 1)
            p = r["p2p"]
            calls = p["sends"] + p["recvs"]
            nbytes = p["send_bytes"] + p["recv_bytes"]
            print(f"[train_pipe] (b) {label} pp 2 stage {s} (gloo, cuda:0): "
                  f"{r['step_ms']:.1f} ms per step, peak "
                  f"{r['peak_mib']:.1f} MiB; point-to-point {calls:.0f} "
                  f"calls, {nbytes:.0f} B, {p['seconds'] * 1e3:.1f} ms and "
                  f"{p['staged']:.0f} pinned stagings per step "
                  f"({nbytes / max(p['seconds'], 1e-9) / 1e9:.3f} GB/s over "
                  f"the wait and staging time); boundary inputs held "
                  f"{r['max_live']}; losses "
                  f"{' '.join(f'{x:.6f}' for x in r['losses'])} [{card}]")
        if res["fp32"]["losses"] != ranks[0]["fp32"]["losses"]:
            fail("train_pipe (b): the two stages return different losses")
    f2, f1 = ranks[0]["fp32"]["losses"], runs["fp32"]["losses"]
    worst = max(abs(x - y) / abs(y) for x, y in zip(f2, f1))
    print(f"[train_pipe] (b) pp 2 vs pp 1 at fp32, dropout 0.1: {f2} vs "
          f"{f1}; max rel diff {worst:.3g} (bar {PIPE_FP32_RTOL}) [{card}]")
    if not worst <= PIPE_FP32_RTOL:
        fail(f"train_pipe (b): pp 2 fp32 losses {f2} differ from pp 1's {f1}")
    b2, b1 = ranks[0]["bf16"]["losses"][0], runs["1f1b"]["losses"][0]
    rel = abs(b2 - b1) / abs(b1)
    print(f"[train_pipe] (b) pp 2 vs pp 1 first bf16 loss: {b2:.6f} vs "
          f"{b1:.6f}, rel diff {rel:.3g} (bar {PIPE_BF16_RTOL}) [{card}]")
    if not rel <= PIPE_BF16_RTOL:
        fail(f"train_pipe (b): first bf16 loss {b2} vs pp 1's {b1}")
    return total


#: train_seq: GPT-2 small over a seq axis of 2, on train_pipe's batch
SEQ_SP, SEQ_STEPS = 2, 4
#: the arms every seq rank trains, in order: (label, attn_impl, dtype)
SEQ_ARMS = (("ulysses fp32", "ulysses", {}),
            ("ulysses bf16", "ulysses", {"bf16": {"enabled": True}}),
            ("ring fp32", "ring", {}))

_SEQ_RANK = _PIPE_RANK.replace("pipe_rank", "seq_rank")


def _seq_model_cfg(impl: str):
    """GPT-2 small with dropout 0.1 and no remat: a recomputed block
    would repeat its seq collectives, which over gloo cost more than the
    activations a 512-token shard keeps."""
    import dataclasses
    from deepspeed_tpu_torch.models.gpt2 import GPT2_SMALL
    return dataclasses.replace(GPT2_SMALL, dropout=0.1, embd_dropout=0.1,
                               attn_impl=impl, remat=None)


def _seq_tree():
    """The one weight tree every train_seq arm starts from: GPT-2
    small's init at SEED on the CPU, and its digest."""
    from deepspeed_tpu_torch.models.gpt2 import GPT2Model
    from deepspeed_tpu_torch.runtime.utils import tree_leaves
    tree = GPT2Model(_seq_model_cfg("ring")).init(SEED)
    digest = float(sum(np.abs(x.numpy()).astype(np.float64).sum()
                       for x in tree_leaves(tree)))
    return tree, digest


def _seq_steps(eng, tokens, steps, dev, key="seq"):
    """``steps`` steps: losses, then over the steps after the first the
    launches, step ms, peak MiB and the ``<key>_stats`` collectives'
    counters per step (``"seq"``, or ``"ep"``: the expert exchange; a
    tuple of keys for several)."""
    import torch
    from deepspeed_tpu_torch.parallel import collectives as col
    keys = (key,) if isinstance(key, str) else tuple(key)
    stats = {k: getattr(col, k + "_stats") for k in keys}
    losses = [float(eng.train_batch(tokens))]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for st in stats.values():
        st.clear()
    _zero_counts()
    t0 = time.perf_counter()
    for _ in range(steps - 1):
        losses.append(float(eng.train_batch(tokens)))
    torch.cuda.synchronize()
    n = max(steps - 1, 1)
    out = {"losses": losses, "launches": _train_counts(),
           "step_ms": (time.perf_counter() - t0) / n * 1e3,
           "peak_mib": torch.cuda.max_memory_allocated(dev) / 2 ** 20}
    for k, st in stats.items():
        out[k] = {c: v / n for c, v in st.items()}
    return out


def _seq_engine(impl, block, dev, mesh=None, params=None):
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.gpt2 import GPT2Model
    gc.collect()
    torch.cuda.empty_cache()
    return deepspeed_tpu_torch.initialize(
        model=GPT2Model(_seq_model_cfg(impl)), mesh=mesh, params=params,
        seed=SEED, config=_train_config(block, PIPE_MICRO, PIPE_GA),
        device=dev)[0]


def seq_rank(rank: int, init: str, digest: float, world: int = SEQ_SP,
             backend: str = "gloo") -> None:
    """One seq rank of GPT-2 small at sp ``world`` (train_seq's
    processes: over gloo every one on cuda:0), every arm of
    ``SEQ_ARMS`` from :func:`_seq_tree`.  Prints one ``SEQ_RANK`` JSON
    line."""
    import datetime
    import torch
    import torch.distributed as dist
    from deepspeed_tpu_torch.parallel import build_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", rank if backend == "nccl" else 0)
    torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=240))
    out = {"rank": rank}
    try:
        tree, mine = _seq_tree()
        if mine != digest:
            raise AssertionError(f"rank {rank}: weight tree digest {mine} "
                                 f"!= the sp-1 engines' {digest}")
        mesh = build_mesh(sp=world)
        out["seq_index"] = mesh.axis_index("seq")
        tokens = torch.from_numpy(_pipe_tokens()).to(dev)
        for label, impl, block in SEQ_ARMS:
            eng = _seq_engine(impl, block, dev, mesh, tree)
            out[label] = _seq_steps(eng, tokens, SEQ_STEPS, dev)
            eng.close()
        dist.barrier()
    finally:
        dist.destroy_process_group()
    print("SEQ_RANK " + json.dumps(out), flush=True)


def phase_train_seq(dev, card: str):
    """Sequence parallelism through ``initialize()`` on a seq axis of 2:
    GPT-2 small at full width and depth, train_pipe's batch, dropout 0.1,
    Adam, clipping 1.0 — Ulysses and ring attention as two processes on
    cuda:0 over gloo, each against the one-process sp-1 engine with the
    same ``attn_impl`` (the dense attention with the same hashed mask).
    Returns the flash launches of the seq ranks' timed steps."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tree, digest = _seq_tree()
    tokens = torch.from_numpy(_pipe_tokens()).to(dev)
    L, M = 12, PIPE_GA
    flash = {"flash_fwd": L * M, "flash_bwd_dq": L * M,
             "flash_bwd_dkv": L * M}
    timed_steps = SEQ_STEPS - 1
    sp1 = {}
    for label, impl, block in (("ring fp32", "ring", {}),) + SEQ_ARMS[:2] \
            + (("flash fp32", "flash", {}),):
        eng = _seq_engine(impl, block, dev, params=tree)
        if eng.device != dev:
            fail(f"train_seq: initialize() placed the engine on "
                 f"{eng.device}")
        steps = SEQ_STEPS if label.endswith("fp32") else 1
        sp1[label] = r = _seq_steps(eng, tokens, steps, dev)
        eng.close()
        want = flash if impl == "flash" else dict.fromkeys(flash, 0)
        for name, n in want.items():
            if r["launches"][name] != n * (steps - 1):
                fail(f"train_seq sp 1 {label}: {name} launched "
                     f"{r['launches'][name]} times in {steps - 1} steps, "
                     f"expected {n} per step")
        if not all(np.isfinite(r["losses"])):
            fail(f"train_seq sp 1 {label}: losses {r['losses']}")
        timing = (f"{r['step_ms']:.1f} ms per step, peak "
                  f"{r['peak_mib']:.1f} MiB; " if steps > 1 else "")
        print(f"[train_seq] sp 1 {label} (one process, local mesh): "
              f"{timing}losses {' '.join(f'{x:.6f}' for x in r['losses'])}"
              f" [{card}]")

    ranks = _pipe_ranks(digest, SEQ_SP, script=_SEQ_RANK, tag="SEQ_RANK")
    total = dict.fromkeys(flash, 0)
    for res in ranks:
        s = res["seq_index"]
        for label, impl, _ in SEQ_ARMS:
            r = res[label]
            want = flash if impl == "ulysses" else dict.fromkeys(flash, 0)
            for name, n in want.items():
                got = r["launches"][name]
                if impl == "ulysses":
                    total[name] += got
                if got != n * timed_steps:
                    fail(f"train_seq sp {SEQ_SP} {label} seq rank {s}: "
                         f"{name} launched {got} times in {timed_steps} "
                         f"steps, expected {n} per step")
            if not all(np.isfinite(r["losses"])):
                fail(f"train_seq {label} seq rank {s}: losses "
                     f"{r['losses']}")
            if r["losses"] != ranks[0][label]["losses"]:
                fail(f"train_seq {label}: the seq ranks return different "
                     f"losses")
            q = r["seq"]
            secs = q.get("seconds", 0.0)
            per = "/".join(str(r["launches"][n] // timed_steps)
                           for n in flash)
            print(f"[train_seq] sp {SEQ_SP} {label} seq rank {s} (gloo, "
                  f"cuda:0): {r['step_ms']:.1f} ms per step, peak "
                  f"{r['peak_mib']:.1f} MiB; seq collectives "
                  f"{q.get('calls', 0):.0f} calls, {q.get('bytes', 0):.0f} "
                  f"B sent, {q.get('staged', 0):.0f} host stagings, "
                  f"{secs * 1e3:.1f} ms per step "
                  f"({secs * 1e3 / r['step_ms'] * 100:.1f} % of the step); "
                  f"flash launches per step {per}; losses "
                  f"{' '.join(f'{x:.6f}' for x in r['losses'])} [{card}]")
    for impl in ("ulysses", "ring"):
        f2 = ranks[0][f"{impl} fp32"]["losses"]
        f1 = sp1[f"{impl} fp32"]["losses"]
        worst = max(abs(x - y) / abs(y) for x, y in zip(f2, f1))
        print(f"[train_seq] {impl} sp {SEQ_SP} vs sp 1 at fp32, dropout "
              f"0.1: {f2} vs {f1}; max rel diff {worst:.3g} (bar "
              f"{PIPE_FP32_RTOL}); the sp-1 flash engine: "
              f"{sp1['flash fp32']['losses']} [{card}]")
        if not worst <= PIPE_FP32_RTOL:
            fail(f"train_seq: {impl} sp {SEQ_SP} fp32 losses {f2} differ "
                 f"from sp 1's {f1}")
    b2 = ranks[0]["ulysses bf16"]["losses"][0]
    b1 = sp1["ulysses bf16"]["losses"][0]
    rel = abs(b2 - b1) / abs(b1)
    print(f"[train_seq] ulysses sp {SEQ_SP} vs sp 1 first bf16 loss: "
          f"{b2:.6f} vs {b1:.6f}, rel diff {rel:.3g} (bar "
          f"{PIPE_BF16_RTOL}) [{card}]")
    if not rel <= PIPE_BF16_RTOL:
        fail(f"train_seq: Ulysses' first bf16 loss {b2} vs sp 1's {b1}")
    return total


#: train_moe: GPT-2 small at full width and depth with 8 experts on every
#: second block (6 MoE layers), top-2, capacity factor 1.25, aux 1e-2,
#: z-loss 1e-3, dropout 0.1, train_pipe's batch of 8 x 1024 tokens
MOE_EXPERTS, MOE_FREQ, MOE_TOP_K, MOE_CF = 8, 2, 2, 1.25
MOE_STEPS, MOE_EP = 3, 2
#: one MoE layer, two ways on the same inputs: every output and gradient
#: within this much of the other's largest magnitude (fp32)
MOE_LAYER_RTOL = 1e-5
#: whole fp32 engines over 8192 tokens, 3 steps: a routing near-tie that
#: fp32 rounding flips moves the loss by ~6e-6 relative, and the steps
#: after it further — the einsum and the scatter engine, both right,
#: parted by 6.2e-6, 3.1e-5 and 9.1e-5 on the card — so the engines'
#: losses are held to ten times that; the layer checks hold 1e-5
MOE_LOSS_RTOL = 1e-3
#: Adam's eps for the fp32 engines: damps the sign flips of near-zero
#: gradients that summation order decides (tests/test_torch_zero.py)
MOE_FP32_EPS = 1e-3

_MOE_RANK = _PIPE_RANK.replace("pipe_rank", "moe_rank")


def _moe_model_cfg(remat=None, impl: str = "einsum", attn: str = "flash"):
    import dataclasses
    from deepspeed_tpu_torch.models import GPT2MoEConfig
    from deepspeed_tpu_torch.models.gpt2 import GPT2_SMALL
    base = dict(dataclasses.asdict(GPT2_SMALL), scan_layers=False,
                dropout=0.1, embd_dropout=0.1, remat=remat,
                attn_impl=attn)
    return GPT2MoEConfig(**base, n_experts=MOE_EXPERTS,
                         moe_top_k=MOE_TOP_K, moe_layer_freq=MOE_FREQ,
                         capacity_factor=MOE_CF, aux_loss_weight=1e-2,
                         router_z_loss_weight=1e-3, moe_dispatch_impl=impl)


def _moe_tree():
    """The one weight tree train_moe's fp32 arms start from: the MoE
    model's init at SEED on the CPU, and its digest."""
    from deepspeed_tpu_torch.models import GPT2MoEModel
    from deepspeed_tpu_torch.runtime.utils import tree_leaves
    tree = GPT2MoEModel(_moe_model_cfg()).init(SEED)
    digest = float(sum(np.abs(x.numpy()).astype(np.float64).sum()
                       for x in tree_leaves(tree)))
    return tree, digest


def _moe_engine(dev, block, micro, ga, remat=None, impl="einsum", mesh=None,
                params=None, stage=0, attn="flash"):
    """GPT-2 small MoE through ``initialize()``; an fp32 engine takes
    ``MOE_FP32_EPS``."""
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import GPT2MoEModel
    gc.collect()
    torch.cuda.empty_cache()
    conf = dict(_train_config(block, micro, ga),
                zero_optimization={"stage": stage})
    if not block:
        conf["optimizer"] = {"type": "Adam",
                             "params": {"lr": 1e-4, "eps": MOE_FP32_EPS}}
    return deepspeed_tpu_torch.initialize(
        model=GPT2MoEModel(_moe_model_cfg(remat, impl, attn)), mesh=mesh,
        params=params, seed=SEED, config=conf, device=dev)[0]


def moe_exchange(rows: int, micro_steps: int, remat: bool,
                 elt: int) -> dict:
    """The expert exchange a step a rank, worked out from the shapes: each
    MoE layer sends its dispatched tokens ``[E, rows, C, d]`` twice
    forward and twice backward a micro-step (three times each way with
    its block recomputed)."""
    cfg = _moe_model_cfg()
    C = cfg.moe_cfg().capacity(cfg.n_positions, True)
    calls = len(cfg.moe_layers) * micro_steps * (6 if remat else 4)
    return {"calls": calls,
            "bytes": calls * MOE_EXPERTS * rows * C * cfg.d_model * elt}


def _normwise(got, want) -> float:
    """max |got - want| over max |want|."""
    return float((got - want).abs().max() / want.abs().max())


def _moe_layer_run(cfg, mp0, x0, mesh=None, rows=None, weight=1.0):
    """``moe_ffn`` forward and backward of ``sum(y²) + weight · aux`` on
    fp32 copies of ``mp0`` and ``x0`` (with ``mesh``: the rank's experts
    and its ``rows`` of ``x0``); returns (y, aux, param grads, x grad)."""
    from deepspeed_tpu_torch.moe import moe_ffn
    from deepspeed_tpu_torch.moe.layer import _expert_parallel
    ep = _expert_parallel(mesh, cfg.n_experts)
    n = cfg.n_experts // (mesh.axis_size("data") if ep else 1)
    e0 = mesh.axis_index("data") * n if ep else 0
    mp = {k: (v[e0:e0 + n] if k != "wg" else v).clone().requires_grad_()
          for k, v in mp0.items()}
    x = (x0 if rows is None else x0[rows]).clone().requires_grad_()
    y, aux = moe_ffn(cfg, mp, x, SEED, train=True, mesh=mesh)
    (y.square().sum() + weight * aux).backward()
    return (y.detach(), aux.detach(), {k: v.grad for k, v in mp.items()},
            x.grad)


def _moe_layer_inputs(dev, rows: int):
    """One MoE layer's init at SEED and ``rows`` x 1024 tokens of unit
    normals at the model's width, on ``dev``."""
    import torch
    from deepspeed_tpu_torch.moe import init_moe_params
    mcfg = _moe_model_cfg().moe_cfg()
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    mp0 = init_moe_params(gen, mcfg)
    x0 = torch.randn((rows, 1024, mcfg.d_model), generator=gen, device=dev)
    return mcfg, mp0, x0


def _moe_layer_case(dev, card: str) -> None:
    """One MoE layer at train_moe's width on the card, fp32: the einsum
    and the scatter dispatch on the same inputs (8 rows), y and the
    gradients of ``sum(y²) + aux`` on every parameter and on ``x`` within
    ``MOE_LAYER_RTOL`` normwise, the aux within 1e-6; each form's forward
    + backward ms printed."""
    import dataclasses
    mcfg, mp0, x0 = _moe_layer_inputs(dev, PIPE_GA)
    out = {impl: _moe_layer_run(dataclasses.replace(
        mcfg, dispatch_impl=impl), mp0, x0) for impl in ("einsum",
                                                        "scatter")}
    ms = {impl: time_ms(lambda impl=impl: _moe_layer_run(
        dataclasses.replace(mcfg, dispatch_impl=impl), mp0, x0), iters=5)
        for impl in out}
    (ye, ae, ge, gxe), (ys, as_, gs, gxs) = out["einsum"], out["scatter"]
    worst_y = _normwise(ys, ye)
    worst_g = max([_normwise(gs[k], ge[k]) for k in ge]
                  + [_normwise(gxs, gxe)])
    aux_rel = abs(float(as_) - float(ae)) / abs(float(ae))
    print(f"[train_moe] (b) one MoE layer, fp32, [{PIPE_GA}, 1024, "
          f"{mcfg.d_model}], E {mcfg.n_experts}, top-2, C "
          f"{mcfg.capacity(1024, True)}: scatter vs einsum, normwise: y "
          f"{worst_y:.3g}, grads {worst_g:.3g} (bar {MOE_LAYER_RTOL}), aux "
          f"{aux_rel:.3g} (bar 1e-6); forward + backward einsum "
          f"{ms['einsum']:.2f} ms, scatter {ms['scatter']:.2f} ms [{card}]")
    if not (worst_y <= MOE_LAYER_RTOL and worst_g <= MOE_LAYER_RTOL
            and aux_rel <= 1e-6):
        fail("train_moe (b): the scatter dispatch's layer differs from the "
             "einsum's")


def _moe_dropped(cfg, tokens: int, run):
    """``run()``'s result and the (token, choice) pairs its MoE layer
    dropped: selected with a queue position at or past the capacity of a
    ``tokens``-long row (read from ``moe.layer._choice_positions``)."""
    from deepspeed_tpu_torch.moe import layer
    C = cfg.capacity(tokens, True)
    real, seen = layer._choice_positions, []

    def spy(mask, base):
        pos = real(mask, base)
        seen.append(int((pos >= C).sum()))
        return pos
    layer._choice_positions = spy
    try:
        out = run()
    finally:
        layer._choice_positions = real
    return out, sum(seen)


def _moe_layer_split(mesh, dev) -> dict:
    """One MoE layer on the ranks of ``mesh`` (each its data rows' token
    window of the seq axis, its experts where ``data`` divides them — the
    tokens exchanged over ``data`` — and the routing counts gathered over
    ``seq``) against the whole layer on every row in this process, on
    inputs that route most tokens to expert 0 (so the capacity drops):
    normwise errors of y, the window's x gradient and every parameter
    gradient (the router's summed over every rank, the experts' over
    ``seq``), the aux, and the dropped (token, choice) pairs, split (summed
    over the ranks) and whole. Each rank's loss takes the aux whole, and
    the data ranks' gradients add, so the reference weighs the aux by
    dp."""
    import torch
    import torch.distributed as dist
    from deepspeed_tpu_torch.moe.layer import _expert_parallel
    dp, d = mesh.axis_size("data"), mesh.axis_index("data")
    sp, s = mesh.axis_size("seq"), mesh.axis_index("seq")
    mcfg, mp0, x0 = _moe_layer_inputs(dev, max(MOE_EP, dp))
    R, S, dm = x0.shape
    u = torch.full((dm,), dm ** -0.5, device=dev)
    mp0 = dict(mp0, wg=mp0["wg"].clone())
    mp0["wg"][:, 0] += 0.5 * u
    x0 = x0 + 2.0 * u
    g_rows, t = R // dp, S // sp
    win = (slice(d * g_rows, (d + 1) * g_rows), slice(s * t, (s + 1) * t))
    (y, aux, g, gx), dropped = _moe_dropped(
        mcfg, S, lambda: _moe_layer_run(mcfg, mp0, x0, mesh, win))
    ep = _expert_parallel(mesh, mcfg.n_experts)
    for k, v in g.items():
        dist.all_reduce(v, group=mesh.group("seq"))
        if k == "wg" or not ep:
            dist.all_reduce(v, group=mesh.group("data"))
    n = torch.tensor([dropped], device=dev)
    dist.all_reduce(n)
    (yr, auxr, gr, gxr), whole = _moe_dropped(
        mcfg, S, lambda: _moe_layer_run(mcfg, mp0, x0, weight=float(dp)))
    ne = mcfg.n_experts // dp if ep else mcfg.n_experts
    err = {"y": _normwise(y, yr[win]), "x": _normwise(gx, gxr[win]),
           "aux": abs(float(aux) - float(auxr)) / abs(float(auxr))}
    for k in g:
        err[k] = _normwise(g[k], gr[k] if k == "wg" or not ep
                           else gr[k][d * ne:(d + 1) * ne])
    return {"err": err, "dropped": int(n.item()), "whole_dropped": whole,
            "shape": list(x0.shape)}


def moe_rank(rank: int, init: str, digest: float, world: int = MOE_EP,
             backend: str = "gloo", arms: str = "fp32", after=None) -> None:
    """One data rank of GPT-2 small MoE at ep ``world`` (its
    ``MOE_EXPERTS / world`` experts), from :func:`_moe_tree`: over gloo
    every process on cuda:0 (train_moe's arm (c)), over NCCL one card a
    process (``profile_moe_torch.py``).  First one MoE layer against the
    whole layer (:func:`_moe_layer_split`), then the engines: micro-batches
    of one row, ga ``8 / world``, the ``arms`` (comma-separated "fp32",
    "bf16") in turn, each arm's result passed to ``after(eng, tokens,
    result)`` when given.  Prints one ``MOE_RANK`` JSON line."""
    import datetime
    import torch
    import torch.distributed as dist
    from deepspeed_tpu_torch.parallel import build_mesh
    from deepspeed_tpu_torch.parallel import collectives as col
    from deepspeed_tpu_torch.runtime.dataloader import rank_rows
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", rank if backend == "nccl" else 0)
    torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=240))
    out = {"rank": rank}
    try:
        tree, mine = _moe_tree()
        if mine != digest:
            raise AssertionError(f"rank {rank}: weight tree digest {mine} "
                                 f"!= the ep-1 engines' {digest}")
        mesh = build_mesh(dp=world)
        d = out["data_index"] = mesh.axis_index("data")
        out["layer"] = _moe_layer_split(mesh, dev)
        col.ep_stats.clear()
        ga = PIPE_GA // world
        tokens = torch.from_numpy(rank_rows(_pipe_tokens(), ga, world,
                                            d)).to(dev)
        for label in arms.split(","):
            block = {"bf16": {"enabled": True}} if label == "bf16" else {}
            eng = _moe_engine(dev, block, 1, ga, mesh=mesh, params=tree)
            wi = eng.state.master_params["moe"]["wi"]
            out[label] = r = _seq_steps(eng, tokens, MOE_STEPS, dev, "ep")
            r["wi_piece"] = list(wi.shape)
            if after is not None:
                after(eng, tokens, r)
            eng.close()
        dist.barrier()
    finally:
        dist.destroy_process_group()
    print("MOE_RANK " + json.dumps(out), flush=True)


def _moe_check_flash(label, launches, L, micro_steps, remat, timed):
    want = {"flash_fwd": (2 if remat else 1) * L * micro_steps,
            "flash_bwd_dq": L * micro_steps,
            "flash_bwd_dkv": L * micro_steps}
    for name, n in want.items():
        if launches[name] != n * timed:
            fail(f"train_moe {label}: {name} launched {launches[name]} "
                 f"times in {timed} steps, expected {n} per step")
    return "/".join(str(n) for n in want.values())


def _moe_check_exchange(label, got, want, staged):
    for k in ("calls", "bytes"):
        if got.get(k, 0) != want[k]:
            fail(f"train_moe {label}: the expert exchange's {k} a step "
                 f"{got.get(k, 0)}, {want[k]} from the shapes")
    if got.get("staged", 0) != (2 * want["calls"] if staged else 0):
        fail(f"train_moe {label}: {got.get('staged', 0)} host stagings a "
             f"step")


def _moe_check_layer(label, lay) -> str:
    """Hold :func:`_moe_layer_split`'s result to ``MOE_LAYER_RTOL`` (the
    aux to 1e-6) and its drops to the whole layer's, and say so."""
    err = lay["err"]
    worst = max(v for k, v in err.items() if k != "aux")
    if not (worst <= MOE_LAYER_RTOL and err["aux"] <= 1e-6):
        fail(f"train_moe {label}: the split layer differs from the whole "
             f"one: {err}")
    if not 0 < lay["dropped"] == lay["whole_dropped"]:
        fail(f"train_moe {label}: the split layer dropped {lay['dropped']} "
             f"(token, choice) pairs, the whole layer "
             f"{lay['whole_dropped']}")
    grads = max(v for k, v in err.items() if k not in ("y", "aux"))
    R, S, _ = lay["shape"]
    return (f"one layer {lay['shape']} skewed to expert 0 against the "
            f"whole layer, normwise: y {err['y']:.3g}, grads {grads:.3g} "
            f"(bar {MOE_LAYER_RTOL}), aux {err['aux']:.3g} (bar 1e-6); "
            f"dropped (token, choice) pairs {lay['dropped']} of "
            f"{MOE_TOP_K * R * S}, the whole layer {lay['whole_dropped']}")


def phase_train_moe(dev, card: str):
    """Expert parallelism through ``initialize()``: GPT-2 small with 8
    experts on every second block at full width and depth, train_pipe's
    batch, dropout 0.1, Adam, clipping 1.0, the flash kernels.  (a) bf16,
    ZeRO 2, remat per block, ep 1 in a one-rank NCCL group, 3 steps: the
    losses finite and falling, the flash launches and the exchange's
    counters a step equal to the ones worked out; (b) fp32, the einsum
    and the scatter dispatch: one layer at the model's width within
    ``MOE_LAYER_RTOL``, and the two engines on one weight tree
    (micro-batches of 2 rows) within ``MOE_LOSS_RTOL``; (c) ep 2 as two
    processes on cuda:0 over gloo, fp32, each with 4 experts: one layer
    against the whole layer within ``MOE_LAYER_RTOL``, the engines'
    losses within ``MOE_LOSS_RTOL`` of (b)'s einsum engine, the counters
    equal to the shapes'; (d) sp 2 with Ulysses attention as two
    processes on cuda:0 over gloo, fp32, all experts on each: one layer
    split over seq against the whole layer within ``MOE_LAYER_RTOL`` and
    with the same drops, the engines' losses within ``MOE_LOSS_RTOL`` of
    (b)'s einsum engine, the flash launches and the seq collectives equal
    to the shapes'.  Returns arm (a)'s flash launches."""
    a = _moe_arm_a(dev, card)
    ref, digest = _moe_arm_b(dev, card)
    _moe_arm_c(ref, digest, card)
    _moe_arm_d(ref, digest, card)
    return a


def _moe_arm_a(dev, card: str):
    import torch
    L, M = 12, PIPE_GA
    tokens = torch.from_numpy(_pipe_tokens()).to(dev)
    with _one_rank_group():
        eng = _moe_engine(dev, {"bf16": {"enabled": True}}, PIPE_MICRO, M,
                          remat="block", stage=2)
        if eng.device != dev:
            fail(f"train_moe: initialize() placed the engine on "
                 f"{eng.device}")
        rt = eng._zero
        pl = rt.placements[rt.template["moe"]["wi"]]
        if pl.ep_dim != 1 or pl.zero_dim is not None:
            fail(f"train_moe: moe/wi placed as {pl}, not over data on E")
        a = _seq_steps(eng, tokens, MOE_STEPS, dev, "ep")
        eng.close()
    if not all(np.isfinite(a["losses"])) or not a["losses"][-1] < \
            a["losses"][0]:
        fail(f"train_moe (a): losses not finite and falling: {a['losses']}")
    per = _moe_check_flash("(a)", a["launches"], L, M, True, MOE_STEPS - 1)
    want = moe_exchange(PIPE_MICRO, M, True, 2)
    _moe_check_exchange("(a)", a["ep"], want, staged=False)
    print(f"[train_moe] (a) bf16 ZeRO 2, remat block, ep 1 (one-rank NCCL "
          f"group): {a['step_ms']:.1f} ms per step, peak "
          f"{a['peak_mib']:.1f} MiB; losses "
          f"{' '.join(f'{x:.6f}' for x in a['losses'])}; flash launches "
          f"per step {per} (fwd = 2 x {L} x {M}, dQ = dK/dV = {L} x {M}); "
          f"exchange {a['ep']['calls']:.0f} calls, {a['ep']['bytes']:.0f} "
          f"B per step ({want['calls']} and {want['bytes']} from "
          f"[E, rows, C, d]) [{card}]")
    return a["launches"]


def _moe_arm_b(dev, card: str):
    import torch
    L, M = 12, PIPE_GA
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _moe_layer_case(dev, card)
    tokens = torch.from_numpy(_pipe_tokens()).to(dev)
    tree, digest = _moe_tree()
    b = {}
    for impl in ("einsum", "scatter"):
        eng = _moe_engine(dev, {}, MOE_EP, M // MOE_EP, impl=impl,
                          params=tree)
        b[impl] = r = _seq_steps(eng, tokens, MOE_STEPS, dev, "ep")
        eng.close()
        _moe_check_flash(f"(b) {impl}", r["launches"], L, M // MOE_EP,
                         False, MOE_STEPS - 1)
        if not all(np.isfinite(r["losses"])):
            fail(f"train_moe (b) {impl}: losses {r['losses']}")
    diffs = [abs(x - y) / abs(y) for x, y in
             zip(b["scatter"]["losses"], b["einsum"]["losses"])]
    print(f"[train_moe] (b) fp32 engines (Adam eps {MOE_FP32_EPS}), "
          f"micro-batches of {MOE_EP} rows, einsum vs scatter dispatch: "
          f"einsum {b['einsum']['step_ms']:.1f} ms, scatter "
          f"{b['scatter']['step_ms']:.1f} ms per step; losses "
          f"{b['einsum']['losses']} vs {b['scatter']['losses']}; rel diffs "
          f"{' '.join(f'{x:.3g}' for x in diffs)} (bar {MOE_LOSS_RTOL}) "
          f"[{card}]")
    if not max(diffs) <= MOE_LOSS_RTOL:
        fail("train_moe (b): the scatter engine's losses differ from the "
             "einsum engine's")
    return b["einsum"]["losses"], digest


def _moe_arm_c(ref, digest, card: str):
    L, M = 12, PIPE_GA
    ranks = _pipe_ranks(digest, MOE_EP, script=_MOE_RANK, tag="MOE_RANK")
    want = moe_exchange(1, M // MOE_EP, False, 4)
    for res in ranks:
        r = res["fp32"]
        label = f"(c) ep {MOE_EP} data rank {res['data_index']}"
        layer = _moe_check_layer(label, res["layer"])
        if r["wi_piece"][1] != MOE_EXPERTS // MOE_EP:
            fail(f"train_moe {label}: moe/wi piece {r['wi_piece']}")
        per = _moe_check_flash(label, r["launches"], L, M // MOE_EP, False,
                               MOE_STEPS - 1)
        _moe_check_exchange(label, r["ep"], want, staged=True)
        worst = max(abs(x - y) / abs(y) for x, y in zip(r["losses"], ref))
        secs = r["ep"].get("seconds", 0.0)
        print(f"[train_moe] {label} (gloo, cuda:0, experts "
              f"{r['wi_piece'][1]} of {MOE_EXPERTS}): {layer}; engine "
              f"{r['step_ms']:.1f} ms per step, peak {r['peak_mib']:.1f} "
              f"MiB; exchange {r['ep']['calls']:.0f} calls, "
              f"{r['ep']['bytes']:.0f} B, {r['ep']['staged']:.0f} host "
              f"stagings, {secs * 1e3:.1f} ms per step ({want['calls']} "
              f"calls and {want['bytes']} B from the shapes); flash "
              f"launches per step {per}; losses {r['losses']} vs (b)'s "
              f"{ref}: max rel diff {worst:.3g} (bar {MOE_LOSS_RTOL}) "
              f"[{card}]")
        if not worst <= MOE_LOSS_RTOL:
            fail(f"train_moe {label}: fp32 losses {r['losses']} differ "
                 f"from ep 1's {ref}")


#: train_moe arm (d): GPT-2 small MoE with Ulysses attention over a seq
#: axis of SEQ_SP, fp32, as two processes on cuda:0 over gloo
_MOE_SEQ_RANK = _PIPE_RANK.replace("pipe_rank", "moe_seq_rank")


def moe_seq_rank(rank: int, init: str, digest: float, world: int = SEQ_SP,
                 backend: str = "gloo", dp: int = 1, micro: int = MOE_EP,
                 ga: int = PIPE_GA // MOE_EP, arms: str = "fp32",
                 after=None) -> None:
    """One rank of GPT-2 small MoE with Ulysses attention on a mesh of dp
    × (``world``/dp) seq ranks, from :func:`_moe_tree`: over gloo every
    process on cuda:0 (train_moe's arm (d), dp 1), over NCCL one card a
    process (``profile_moe_torch.py``).  First one MoE layer against the
    whole layer (:func:`_moe_layer_split`), then the engines on
    train_pipe's batch (each data rank its rows, ``micro`` a micro-batch,
    ``ga`` of them), the ``arms`` (comma-separated "fp32", "bf16") in
    turn, each arm's result passed to ``after(eng, tokens, result)`` when
    given.  Prints one ``MOE_SEQ_RANK`` JSON line."""
    import datetime
    import torch
    import torch.distributed as dist
    from deepspeed_tpu_torch.parallel import build_mesh
    from deepspeed_tpu_torch.runtime.dataloader import rank_rows
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", rank if backend == "nccl" else 0)
    torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=240))
    out = {"rank": rank}
    try:
        tree, mine = _moe_tree()
        if mine != digest:
            raise AssertionError(f"rank {rank}: weight tree digest {mine} "
                                 f"!= the one-process engines' {digest}")
        mesh = build_mesh(dp=dp, sp=world // dp)
        d = out["data_index"] = mesh.axis_index("data")
        out["seq_index"] = mesh.axis_index("seq")
        out["layer"] = _moe_layer_split(mesh, dev)
        tokens = torch.from_numpy(rank_rows(_pipe_tokens(), ga, dp,
                                            d)).to(dev)
        for label in arms.split(","):
            block = {"bf16": {"enabled": True}} if label == "bf16" else {}
            eng = _moe_engine(dev, block, micro, ga, mesh=mesh, params=tree,
                              attn="ulysses")
            out[label] = r = _seq_steps(eng, tokens, MOE_STEPS, dev,
                                        ("seq", "ep"))
            if after is not None:
                after(eng, tokens, r)
            eng.close()
        dist.barrier()
    finally:
        dist.destroy_process_group()
    print("MOE_SEQ_RANK " + json.dumps(out), flush=True)


def moe_seq_collectives(micro: int, micro_steps: int, sp: int,
                        elt: int) -> dict:
    """The seq collectives a step a rank, worked out from the shapes: per
    block and micro-step, Ulysses' two all-to-alls forward (q, k and v
    stacked ``[3, B, H, T/sp, Dh]`` to heads; the output ``[B, H/sp, T,
    Dh]`` back) and their two transposes backward; per MoE layer and
    micro-step one gather of the routing counts ``[k, B, E]`` (fp32) in
    the forward."""
    cfg = _moe_model_cfg()
    L, n_moe, d = cfg.n_layer, len(cfg.moe_layers), cfg.d_model
    t = cfg.n_positions // sp
    a2a = 2 * (3 + 1) * micro * t * d * elt
    gather = MOE_TOP_K * micro * MOE_EXPERTS * 4
    return {"calls": micro_steps * (L * 4 + n_moe),
            "bytes": micro_steps * (L * a2a + n_moe * gather)}


def _moe_arm_d(ref, digest, card: str):
    L, M = 12, PIPE_GA
    ranks = _pipe_ranks(digest, SEQ_SP, script=_MOE_SEQ_RANK,
                        tag="MOE_SEQ_RANK")
    want = moe_seq_collectives(MOE_EP, M // MOE_EP, SEQ_SP, 4)
    for res in ranks:
        r = res["fp32"]
        label = f"(d) sp {SEQ_SP} seq rank {res['seq_index']}"
        layer = _moe_check_layer(label, res["layer"])
        per = _moe_check_flash(label, r["launches"], L, M // MOE_EP, False,
                               MOE_STEPS - 1)
        q = r["seq"]
        for k in ("calls", "bytes"):
            if q.get(k, 0) != want[k]:
                fail(f"train_moe {label}: the seq collectives' {k} a step "
                     f"{q.get(k, 0)}, {want[k]} from the shapes")
        if q.get("staged", 0) != 2 * want["calls"]:
            fail(f"train_moe {label}: {q.get('staged', 0)} host stagings a "
                 f"step")
        if not all(np.isfinite(r["losses"])):
            fail(f"train_moe {label}: losses {r['losses']}")
        if r["losses"] != ranks[0]["fp32"]["losses"]:
            fail(f"train_moe {label}: the seq ranks return different "
                 f"losses")
        diff = max(abs(x - y) / abs(y) for x, y in zip(r["losses"], ref))
        secs = q.get("seconds", 0.0)
        print(f"[train_moe] {label} (gloo, cuda:0, Ulysses, all "
              f"{MOE_EXPERTS} experts): {layer}; engine "
              f"{r['step_ms']:.1f} ms per "
              f"step, peak {r['peak_mib']:.1f} MiB; seq collectives "
              f"{q['calls']:.0f} calls, {q['bytes']:.0f} B, "
              f"{q['staged']:.0f} host stagings, {secs * 1e3:.1f} ms per "
              f"step ({want['calls']} calls and {want['bytes']} B from the "
              f"shapes: the Ulysses all-to-alls and one routing-count "
              f"gather a MoE layer); expert exchange on the one-rank data "
              f"group {r['ep'].get('calls', 0):.0f} calls, "
              f"{r['ep'].get('bytes', 0):.0f} B; flash launches per step "
              f"{per}; losses "
              f"{r['losses']} vs (b)'s {ref}: max rel diff {diff:.3g} (bar "
              f"{MOE_LOSS_RTOL}) [{card}]")
        if not diff <= MOE_LOSS_RTOL:
            fail(f"train_moe {label}: fp32 losses {r['losses']} differ "
                 f"from (b)'s {ref}")


# ---------------------------------------------------------------------------
# train_onebit: compressed data parallelism (1-bit Adam, CSR gradients)
# ---------------------------------------------------------------------------
#: (a): phase train's model and batch (GPT-2 small, dropout 0.1, remat
#: block, 8 x 1024 tokens, accumulation 2), bf16, 1-bit Adam, 4 steps
#: across freeze step 2
ONEBIT_FREEZE, ONEBIT_STEPS = 2, 4
#: (b): dp 2 over gloo on cuda:0, fp32, dropout 0 (each worker draws its
#: own dropout, so only then does dp 2's first loss equal dp 1's),
#: train_pipe's batch, freeze step 1, 3 steps
ONEBIT_DP, ONEBIT_DP_FREEZE, ONEBIT_DP_STEPS = 2, 1, 3
#: (a)'s warm master against Adam without bias correction, leaf by leaf
ONEBIT_ADAM_RTOL = 1e-6
#: (b)'s first loss against dp 1's, (c)'s sparse against dense losses
ONEBIT_LOSS_RTOL = 1e-5
#: (b)'s first frozen exchange against the numpy two-phase algorithm
ONEBIT_EXCHANGE_RTOL = 1e-6
#: a sign may differ from numpy's only where |buf| < this · scale
ONEBIT_NEAR_TIE = 1e-5
#: the leaves the numpy check recomputes: at most this many elements
ONEBIT_ORACLE_ELEMS = 8 << 20
#: (c): GPT-2 small's embedding table mean-pooled into a [768, 768] head,
#: phase train's 8 x 1024 tokens a rank, Adam, fp32, 3 steps
CSR_MICRO, CSR_STEPS = 8, 3
_ONEBIT_RANK = _PIPE_RANK.replace("pipe_rank", "onebit_rank")


class EmbedPool:
    """``tests/test_sparse_grads_engine.py``'s model at GPT-2 small's
    embedding shape: ``wte [50257, 768]`` mean-pooled over a row's tokens
    into a ``[768, 768]`` head, MSE against a target.  It declares the
    table's gradient rows (``sparse_grad_tokens``)."""

    def init(self, seed, device=None):
        import torch
        from deepspeed_tpu_torch.models.gpt2 import GPT2_SMALL
        g = torch.Generator().manual_seed(seed)
        d = GPT2_SMALL.d_model
        return {"emb": torch.randn(GPT2_SMALL.vocab_size, d, generator=g)
                * 0.02,
                "head_w": torch.randn(d, d, generator=g) * d ** -0.5}

    def loss_fn(self, params, batch, rng, train=True):
        import torch
        tokens, target = batch
        h = params["emb"].float()[tokens.long()].mean(dim=1)
        return torch.mean((h @ params["head_w"].float() - target) ** 2)

    def sparse_grad_tokens(self, batch):
        return {"['emb']": batch[0]}


def _onebit_model_cfg():
    import dataclasses
    from deepspeed_tpu_torch.models.gpt2 import GPT2_SMALL
    return dataclasses.replace(GPT2_SMALL, remat="block")


def _onebit_tree():
    """(b)'s weight tree: GPT-2 small's init at SEED on the CPU, and its
    digest."""
    from deepspeed_tpu_torch.models.gpt2 import GPT2Model
    from deepspeed_tpu_torch.runtime.utils import tree_leaves
    tree = GPT2Model(_onebit_model_cfg()).init(SEED)
    digest = float(sum(np.abs(x.numpy()).astype(np.float64).sum()
                       for x in tree_leaves(tree)))
    return tree, digest


def _onebit_fp32(dev, tree, mesh, dp, micro, ga, freeze):
    """GPT-2 small with 1-bit Adam at fp32 through ``initialize()``: the
    config built with bf16 and bf16 switched off after (the config check
    refuses 1-bit Adam without fp16/bf16)."""
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.config import DeepSpeedConfig
    from deepspeed_tpu_torch.models.gpt2 import GPT2Model
    gc.collect()
    torch.cuda.empty_cache()
    conf = _train_config({"bf16": {"enabled": True}}, micro, ga)
    conf["optimizer"] = {"type": "OneBitAdam",
                         "params": {"lr": 1e-4, "freeze_step": freeze}}
    cfg = DeepSpeedConfig(conf, world_size=dp)
    cfg.bf16.enabled = False
    return deepspeed_tpu_torch.initialize(
        model=GPT2Model(_onebit_model_cfg()), mesh=mesh, params=tree,
        seed=SEED, config=cfg, device=dev)[0]


def _master_digest(eng) -> str:
    import hashlib
    from deepspeed_tpu_torch.runtime.utils import tree_leaves
    h = hashlib.sha256()
    for x in tree_leaves(eng.state.master_params):
        h.update(x.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def _onebit_dp_arm(mesh, tree, dev, work) -> dict:
    """(b) on this rank: 3 fp32 steps at freeze step 1; the first frozen
    exchange's inputs and outputs of the leaves the numpy check takes
    saved to ``work``; each step's loss, master digest, ms and wire."""
    import torch
    from deepspeed_tpu_torch.compress import onebit, padded_size
    from deepspeed_tpu_torch.parallel import collectives as col
    from deepspeed_tpu_torch.runtime.dataloader import rank_rows
    from deepspeed_tpu_torch.runtime.utils import tree_leaves
    dp, d = mesh.axis_size("data"), mesh.axis_index("data")
    ga = PIPE_GA // dp
    tokens = torch.from_numpy(rank_rows(_pipe_tokens(), ga, dp, d)).to(dev)
    eng = _onebit_fp32(dev, tree, mesh, dp, 1, ga, ONEBIT_DP_FREEZE)
    sizes = [x.numel() for x in tree_leaves(eng.state.master_params)]
    rec, saved = {"on": False}, []
    plain = onebit.compressed_allreduce

    def recording(x, we, se, mesh_, axis="data"):
        out = plain(x, we, se, mesh_, axis)
        if rec["on"] and x.numel() <= ONEBIT_ORACLE_ELEMS:
            saved.append([t.detach().reshape(-1).cpu().numpy()
                          for t in (x, we, se) + tuple(out)])
        return out

    onebit.compressed_allreduce = recording
    steps = []
    try:
        for step in range(ONEBIT_DP_STEPS):
            rec["on"] = step == ONEBIT_DP_FREEZE
            col.onebit_stats.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with col.recorded() as log:
                loss = float(eng.train_batch(tokens))
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            floats = [e for _, dt, e in log if dt == "float32"]
            steps.append({"loss": loss, "ms": ms,
                          "digest": _master_digest(eng),
                          "max_float": max(floats, default=0),
                          "float_bytes": 4 * sum(floats),
                          "stats": dict(col.onebit_stats)})
    finally:
        onebit.compressed_allreduce = plain
    eng.close()
    np.savez(os.path.join(work, f"exchange{d}.npz"),
             **{f"{i}_{j}": a for i, arrs in enumerate(saved)
                for j, a in enumerate(arrs)})
    return {"steps": steps, "largest": max(sizes),
            "uint8_want": sum(padded_size(n, dp) // 8
                              + padded_size(n, dp) // (8 * dp)
                              for n in sizes),
            "oracle_leaves": len(saved),
            "oracle_elems": sum(a[0].size for a in saved)}


def _csr_arm(mesh, dev) -> dict:
    """(c) on this rank: the CSR engine and the dense engine on
    :class:`EmbedPool` at dp 2, fp32, 3 steps each on the same rows."""
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.gpt2 import GPT2_SMALL
    from deepspeed_tpu_torch.parallel import collectives as col
    from deepspeed_tpu_torch.runtime.dataloader import rank_rows
    dp, d = mesh.axis_size("data"), mesh.axis_index("data")
    rng = np.random.default_rng(SEED + 11)
    T = GPT2_SMALL.n_positions
    tokens = rng.integers(0, GPT2_SMALL.vocab_size, (dp * CSR_MICRO, T))
    target = rng.standard_normal((dp * CSR_MICRO, GPT2_SMALL.d_model),
                                 dtype=np.float32)
    batch = tuple(torch.from_numpy(x).to(dev)
                  for x in rank_rows((tokens, target), 1, dp, d))
    tree = EmbedPool().init(SEED)
    out = {}
    for label, sparse in (("sparse", True), ("dense", False)):
        gc.collect()
        torch.cuda.empty_cache()
        eng = deepspeed_tpu_torch.initialize(
            model=EmbedPool(), mesh=mesh, params=tree, seed=SEED,
            device=dev, config={
                "train_micro_batch_size_per_gpu": CSR_MICRO,
                "gradient_accumulation_steps": 1,
                "steps_per_print": 10 ** 9, "sparse_gradients": sparse,
                "optimizer": {"type": "Adam", "params": {"lr": 1e-3}}})[0]
        if eng._sparse_path != sparse:
            raise AssertionError(f"{label}: the engine took the other step")
        r = out[label] = {"losses": [], "ms": [], "max_elems": 0,
                          "stats": {}}
        for _ in range(CSR_STEPS):
            col.csr_stats.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with col.recorded() as log:
                r["losses"].append(float(eng.train_batch(batch)))
            torch.cuda.synchronize()
            r["ms"].append((time.perf_counter() - t0) * 1e3)
            r["max_elems"] = max([r["max_elems"]]
                                 + [e for _, _, e in log])
            r["stats"] = dict(col.csr_stats)
        eng.close()
    return out


def onebit_rank(rank: int, init: str, digest: float,
                world: int = ONEBIT_DP, backend: str = "gloo") -> None:
    """One data rank of train_onebit's arms (b) and (c), every process
    on cuda:0 over gloo; the exchange's records go to the directory in
    ``ONEBIT_RANK_DIR``.  Prints one ``ONEBIT_RANK`` JSON line."""
    import datetime
    import torch
    import torch.distributed as dist
    from deepspeed_tpu_torch.parallel import build_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", rank if backend == "nccl" else 0)
    torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=240))
    out = {"rank": rank}
    try:
        tree, mine = _onebit_tree()
        if mine != digest:
            raise AssertionError(f"rank {rank}: weight tree digest {mine} "
                                 f"!= the dp-1 engine's {digest}")
        mesh = build_mesh(dp=world)
        out["data_index"] = mesh.axis_index("data")
        out["b"] = _onebit_dp_arm(mesh, tree, dev,
                                  os.environ["ONEBIT_RANK_DIR"])
        del tree
        out["c"] = _csr_arm(mesh, dev)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    print("ONEBIT_RANK " + json.dumps(out), flush=True)


def _np_sign_compress(buf, error):
    buf = buf + error
    scale = np.linalg.norm(buf) / np.sqrt(buf.size)
    sign = np.where(buf >= 0, 1.0, -1.0)
    return buf, sign, scale, buf - scale * sign


def _np_exchange(xs, wes, ses):
    """The two-phase algorithm in numpy (float64) over every worker's
    buffer and error rows: (out, worker bufs, signs and scales, server
    bufs, signs and scales)."""
    world, n = len(xs), xs[0].size
    P = wes[0].size
    chunk = P // world
    w = [_np_sign_compress(np.pad(x.astype(np.float64), (0, P - n)),
                           e.astype(np.float64)) for x, e in zip(xs, wes)]
    s = []
    for r in range(world):
        comp = np.mean([sign[r * chunk:(r + 1) * chunk] * scale
                        for _, sign, scale, _ in w], axis=0)
        s.append(_np_sign_compress(comp, ses[r].astype(np.float64)))
    out = np.concatenate([sc * sign for _, sign, sc, _ in s])[:n]
    return out, w, s


def _onebit_check_exchange(work, world) -> str:
    """(b)'s first frozen exchange: rank 0's output and error rows
    against :func:`_np_exchange` on both ranks' μ and errors, within
    ``ONEBIT_EXCHANGE_RTOL`` of the largest magnitude (the error rows of
    the μ they are residuals of); a sign that differs from numpy's must
    be a near-tie (|buf| < ``ONEBIT_NEAR_TIE`` · scale) and is left out
    of the comparison, each reported with its margin."""
    files = [np.load(os.path.join(work, f"exchange{r}.npz"))
             for r in range(world)]
    leaves = len(files[0].files) // 6
    flips, worst, elems = [], 0.0, 0
    for i in range(leaves):
        x, we, se, out, we2, se2 = (
            [f[f"{i}_{j}"] for f in files] for j in range(6))
        ref, wk, sv = _np_exchange(x, we, se)
        n, P = x[0].size, we[0].size
        chunk = P // world
        floor = max(np.abs(x[0]).max(), np.abs(x[1]).max())
        # worker signs (rank 0) implied by its residual, server signs by
        # the output's
        buf0, sign0, scale0, res0 = wk[0]
        got_sign = np.where((buf0 - we2[0]) >= 0, 1.0, -1.0)
        keep_w = got_sign == sign0
        ssign = np.concatenate([sign for _, sign, _, _ in sv])[:n]
        keep_o = np.sign(out[0]) == ssign
        for j in np.nonzero(~keep_w)[0]:
            flips.append(("worker", i, int(j), abs(buf0[j]) / scale0))
        for j in np.nonzero(~keep_o)[0]:
            b, _, sc, _ = sv[j // chunk]
            flips.append(("server", i, int(j), abs(b[j % chunk]) / sc))
        sbuf0, ssign0, sscale0, sres0 = sv[0]
        got_s = np.where((sbuf0 - se2[0]) >= 0, 1.0, -1.0)
        keep_s = got_s == ssign0
        for j in np.nonzero(~keep_s)[0]:
            flips.append(("server", i, int(j), abs(sbuf0[j]) / sscale0))
        for got, want, keep, fl in ((out[0], ref, keep_o, 0.0),
                                    (we2[0], res0, keep_w, floor),
                                    (se2[0], sres0, keep_s, floor)):
            err = np.abs(got[keep].astype(np.float64) - want[keep]).max(
                initial=0.0)
            rel = err / max(np.abs(want).max(), fl, 1e-30)
            worst = max(worst, rel)
        elems += n
    bad = [f for f in flips if not f[3] < ONEBIT_NEAR_TIE]
    if bad or not worst <= ONEBIT_EXCHANGE_RTOL:
        fail(f"train_onebit (b): rank 0's first frozen exchange differs "
             f"from the numpy two-phase algorithm: worst {worst:.3g} (bar "
             f"{ONEBIT_EXCHANGE_RTOL}), sign flips off the near-tie rule "
             f"{bad[:8]}")
    return (f"first frozen exchange of {leaves} leaves ({elems} elements) "
            f"against numpy on both ranks' μ and errors: worst "
            f"{worst:.3g} of the largest magnitude (bar "
            f"{ONEBIT_EXCHANGE_RTOL}); sign flips "
            f"{[(k, i, j, f'{m:.2g}') for k, i, j, m in flips] or 'none'}"
            f" (near-tie bar {ONEBIT_NEAR_TIE})")


def phase_train_onebit(dev, card: str):
    """Compressed data parallelism through ``initialize()``.  (a) phase
    train's model and batch with 1-bit Adam, bf16, ZeRO 0, freeze step
    2, in a one-rank NCCL group (the simulated exchange), 4 steps: the
    losses finite, the flash launches a step the ones worked out, the
    master after the 2 warm steps within ``ONEBIT_ADAM_RTOL`` of an Adam
    engine's without bias correction (leaf by leaf), ν bitwise unchanged
    after the freeze with the error buffers nonzero, and no compressed
    collective called.  (b) dp 2 as two processes on cuda:0 over gloo,
    fp32, dropout 0, freeze step 1, 3 steps: the first loss within
    ``ONEBIT_LOSS_RTOL`` of an fp32 dp-1 engine's on the same tree and
    global batch, the two ranks' masters bitwise equal after every
    step, rank 0's first frozen exchange against numpy, the frozen
    steps' uint8 bytes those of the leaves' ``padded_size``s with no
    float collective over 4·dp elements, the warm step's fp32 reduction
    covering the largest leaf.  (c) CSR gradients at GPT-2 small's
    embedding shape on the same two processes: the sparse engine's
    losses within ``ONEBIT_LOSS_RTOL`` of the dense engine's, no
    collective as large as the table, the indices' and values' bytes
    those of the tokens.  Returns (a)'s flash launches."""
    import tempfile
    import torch
    launches = _onebit_arm_a(dev, card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tree, digest = _onebit_tree()
    tokens = torch.from_numpy(_pipe_tokens()).to(dev)
    eng = _onebit_fp32(dev, tree, None, 1, 1, PIPE_GA, ONEBIT_DP_FREEZE)
    ref = float(eng.train_batch(tokens))
    eng.close()
    del eng, tree
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as work:
        os.environ["ONEBIT_RANK_DIR"] = work
        try:
            ranks = _pipe_ranks(digest, ONEBIT_DP, script=_ONEBIT_RANK,
                                tag="ONEBIT_RANK")
        finally:
            os.environ.pop("ONEBIT_RANK_DIR", None)
        exchange = _onebit_check_exchange(work, ONEBIT_DP)
    _onebit_check_bc(ranks, ref, exchange, card)
    return launches


def _onebit_arm_a(dev, card: str):
    import dataclasses
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.gpt2 import GPT2_SMALL, GPT2Model
    from deepspeed_tpu_torch.parallel import collectives as col
    from deepspeed_tpu_torch.runtime.utils import tree_leaves
    cfg = dataclasses.replace(GPT2_SMALL, dropout=0.1, embd_dropout=0.1,
                              remat="block")
    tree = GPT2Model(cfg).init(SEED)
    T, L, A = cfg.n_positions, cfg.n_layer, TRAIN_GA
    tokens = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (TRAIN_MICRO * A, T + 1))).to(dev)

    def build(opt):
        gc.collect()
        torch.cuda.empty_cache()
        conf = _train_config({"bf16": {"enabled": True}}, TRAIN_MICRO, A)
        conf["optimizer"] = opt
        return deepspeed_tpu_torch.initialize(
            model=GPT2Model(cfg), params=tree, seed=SEED, config=conf)[0]

    with _one_rank_group():
        eng = build({"type": "Adam", "params": {"lr": 1e-4,
                                                "bias_correction": False}})
        for _ in range(ONEBIT_FREEZE):
            eng.train_batch(tokens)
        adam = [x.detach().clone() for x in
                tree_leaves(eng.state.master_params)]
        eng.close()
        del eng
        eng = build({"type": "OneBitAdam",
                     "params": {"lr": 1e-4, "freeze_step": ONEBIT_FREEZE}})
        if eng.device != dev or eng._onebit_steps is not None:
            fail(f"train_onebit (a): the engine is on {eng.device} with "
                 f"the per-worker steps {eng._onebit_steps}")
        col.onebit_stats.clear()
        losses, ms = [], []
        torch.cuda.synchronize()
        _zero_counts()
        for step in range(ONEBIT_STEPS):
            t0 = time.perf_counter()
            losses.append(float(eng.train_batch(tokens)))
            ms.append((time.perf_counter() - t0) * 1e3)
            st = eng.state
            if step == ONEBIT_FREEZE - 1:
                worst = max(float((a - b).abs().max() / b.abs().max())
                            for a, b in zip(tree_leaves(st.master_params),
                                            adam))
                nu = [v.clone() for v in st.opt_state.nu]
        launches = _train_counts()
        st = eng.state.opt_state
        nu_kept = all(torch.equal(a, b) for a, b in zip(st.nu, nu))
        err_max = max(float(e.abs().max()) for e in st.worker_error)
        count = int(st.count)
        eng.close()
    want = {"flash_fwd": 2 * L * A, "flash_bwd_dq": L * A,
            "flash_bwd_dkv": L * A}
    for name, per in want.items():
        if launches[name] != per * ONEBIT_STEPS:
            fail(f"train_onebit (a): {name} launched {launches[name]} times "
                 f"in {ONEBIT_STEPS} steps, expected {per} per step")
    if not all(np.isfinite(losses)):
        fail(f"train_onebit (a): losses {losses}")
    if not worst <= ONEBIT_ADAM_RTOL:
        fail(f"train_onebit (a): the warm master differs from Adam's "
             f"without bias correction by {worst:.3g} (bar "
             f"{ONEBIT_ADAM_RTOL})")
    if not nu_kept or not err_max > 0 or count != ONEBIT_STEPS:
        fail(f"train_onebit (a): after the freeze ν kept {nu_kept}, error "
             f"max {err_max}, count {count}")
    if col.onebit_stats:
        fail(f"train_onebit (a): dp 1 called the compressed collectives "
             f"{dict(col.onebit_stats)}")
    print(f"[train_onebit] (a) GPT-2 small bf16, 1-bit Adam freeze step "
          f"{ONEBIT_FREEZE}, one-rank NCCL group (the simulated exchange), "
          f"8 x {T} tokens, accumulation {A}, dropout 0.1, remat block: "
          f"losses {' '.join(f'{x:.4f}' for x in losses)}; step ms "
          f"{_ms_list(ms)} (warm, warm, frozen, "
          f"frozen; the first includes the engine's first launches); "
          f"warm master vs Adam without bias correction {worst:.3g} "
          f"(bar {ONEBIT_ADAM_RTOL}); ν unchanged after the freeze, "
          f"worker error max {err_max:.3g}; no compressed collective "
          f"called; flash launches per step "
          f"{'/'.join(str(v) for v in want.values())} [{card}]")
    return launches


def _ms_list(ms) -> str:
    return " ".join(f"{x:.1f}" for x in ms)


def _onebit_check_bc(ranks, ref, exchange, card):
    for res in ranks:
        b = res["b"]
        label = f"(b) dp {ONEBIT_DP} data rank {res['data_index']}"
        s = b["steps"]
        if abs(s[0]["loss"] - ref) > ONEBIT_LOSS_RTOL * abs(ref):
            fail(f"train_onebit {label}: first loss {s[0]['loss']} vs dp "
                 f"1's {ref}")
        if not all(np.isfinite([x["loss"] for x in s])):
            fail(f"train_onebit {label}: losses {[x['loss'] for x in s]}")
        for i, x in enumerate(s):
            if x["digest"] != ranks[0]["b"]["steps"][i]["digest"]:
                fail(f"train_onebit {label}: step {i + 1}'s master differs "
                     f"from rank 0's")
        warm, frozen = s[:ONEBIT_DP_FREEZE], s[ONEBIT_DP_FREEZE:]
        for x in frozen:
            if x["stats"].get("bytes_uint8") != b["uint8_want"] or \
                    x["max_float"] > 4 * ONEBIT_DP:
                fail(f"train_onebit {label}: a frozen step moved "
                     f"{x['stats']} with a float collective of "
                     f"{x['max_float']} elements; {b['uint8_want']} uint8 "
                     "bytes from padded_size")
        for x in warm:
            if x["max_float"] < b["largest"] or x["stats"]:
                fail(f"train_onebit {label}: the warm step's largest fp32 "
                     f"collective {x['max_float']} < the largest leaf "
                     f"{b['largest']}")
        step_ms = _ms_list(x["ms"] for x in s)
        staging = frozen[0]["stats"].get("seconds", 0) * 1e3
        print(f"[train_onebit] {label} (gloo, cuda:0, fp32, dropout 0, "
              f"freeze step {ONEBIT_DP_FREEZE}): losses "
              f"{[x['loss'] for x in s]}, first vs dp 1's {ref}: rel "
              f"{abs(s[0]['loss'] - ref) / abs(ref):.3g} (bar "
              f"{ONEBIT_LOSS_RTOL}); masters bitwise equal across ranks "
              f"after every step; step ms {step_ms}; warm step fp32 "
              f"bytes {warm[0]['float_bytes']} (largest collective "
              f"{warm[0]['max_float']} elements); frozen step uint8 bytes "
              f"{frozen[0]['stats']['bytes_uint8']} ({b['uint8_want']} "
              f"from padded_size), fp32 scale bytes "
              f"{frozen[0]['stats'].get('bytes_float32', 0)}, largest float "
              f"collective {frozen[0]['max_float']} elements (bar "
              f"{4 * ONEBIT_DP}), the exchange's host time {staging:.1f} ms "
              f"[{card}]")
    print(f"[train_onebit] (b) rank 0's {exchange}")
    from deepspeed_tpu_torch.models.gpt2 import GPT2_SMALL
    table = GPT2_SMALL.vocab_size * GPT2_SMALL.d_model
    toks = CSR_MICRO * GPT2_SMALL.n_positions
    for res in ranks:
        c = res["c"]
        label = f"(c) CSR dp {ONEBIT_DP} data rank {res['data_index']}"
        sp, dn = c["sparse"], c["dense"]
        diffs = [abs(a - b) / abs(b) for a, b in zip(sp["losses"],
                                                      dn["losses"])]
        st = sp["stats"]
        if not max(diffs) <= ONEBIT_LOSS_RTOL:
            fail(f"train_onebit {label}: sparse losses {sp['losses']} vs "
                 f"dense {dn['losses']}")
        if not sp["max_elems"] < table or dn["max_elems"] < table:
            fail(f"train_onebit {label}: largest collective sparse "
                 f"{sp['max_elems']}, dense {dn['max_elems']} elements, "
                 f"table {table}")
        if (st.get("bytes_int32") != toks * 4
                or st.get("bytes_float32") != toks * GPT2_SMALL.d_model * 4):
            fail(f"train_onebit {label}: CSR bytes {st}, {toks} tokens")
        print(f"[train_onebit] {label} (gloo, cuda:0, fp32, [50257, 768] "
              f"table, {CSR_MICRO} x {GPT2_SMALL.n_positions} tokens a "
              f"rank): losses {sp['losses']} vs dense {dn['losses']}, rel "
              f"{max(diffs):.3g} (bar {ONEBIT_LOSS_RTOL}); largest "
              f"collective {sp['max_elems']} elements vs the dense step's "
              f"{dn['max_elems']}; CSR bytes a step: indices "
              f"{st.get('bytes_int32')}, values {st.get('bytes_float32')} "
              f"({toks} tokens); step ms sparse {_ms_list(sp['ms'])}, "
              f"dense {_ms_list(dn['ms'])} [{card}]")


MESH_REQ, MESH_NEW = 8, 32


def phase_serve_mesh(dev):
    """Data/tensor-parallel serving through ``ServeEngine(mesh=...)`` on a
    one-rank NCCL group, each arm against the engine with no mesh."""
    import torch
    from deepspeed_tpu_torch.inference import ServeEngine
    from deepspeed_tpu_torch.models.gpt2 import GPT2_SMALL, GPT2Model
    from deepspeed_tpu_torch.parallel import build_mesh

    paged = {**SLOT_CFG, "page_len": PAGED_CFG["page_len"]}
    arms = (("slot", SLOT_CFG, False),
            ("paged", PAGED_CFG, False),
            ("paged int8", {**paged, "quantization": QUANT}, False),
            ("slot spec", {**SLOT_CFG, **SPEC}, True),
            ("paged spec", {**paged, **SPEC}, True))
    prompts = _load()[:MESH_REQ]
    model = GPT2Model(GPT2_SMALL)
    params = model.init(SEED, device=dev, dtype=torch.bfloat16)
    total = {}
    with _one_rank_group():
        mesh = build_mesh()
        for arm, cfg, draft in arms:
            out = {}
            for tag, m in (("none", None), ("mesh", mesh)):
                eng = ServeEngine(model, {"serving": cfg}, params=params,
                                  device=dev, mesh=m,
                                  draft_params=(_draft_params(params)
                                                if draft else None))
                warm = eng.submit(list(range(16)), max_new_tokens=2)
                eng.run_until_idle()
                if warm.error is not None:
                    fail(f"serve_mesh {arm} {tag}: warm-up {warm.error!r}")
                t0_ticks = (eng.decode_ticks, eng.verify_ticks)
                torch.cuda.synchronize()
                _zero_counts()
                t0 = time.perf_counter()
                reqs = [eng.submit(p, max_new_tokens=MESH_NEW)
                        for p in prompts]
                eng.run_until_idle()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                launches = _counts()
                ticks = (eng.decode_ticks - t0_ticks[0],
                         eng.verify_ticks - t0_ticks[1])
                eng.close()
                for r in reqs:
                    if r.error is not None or len(r.tokens) != MESH_NEW:
                        fail(f"serve_mesh {arm} {tag} request {r.rid}: "
                             f"{r.error!r} ({len(r.tokens)} tokens)")
                out[tag] = ([list(r.tokens) for r in reqs], launches,
                            ticks, sum(len(r.tokens) for r in reqs) / wall)
            if out["mesh"][0] != out["none"][0]:
                fail(f"serve_mesh {arm}: the mesh engine's streams differ "
                     "from the engine's with no mesh")
            if out["mesh"][1] != out["none"][1] \
                    or out["mesh"][2] != out["none"][2]:
                fail(f"serve_mesh {arm}: launches {out['mesh'][1]} over "
                     f"ticks {out['mesh'][2]} differ from no mesh's "
                     f"{out['none'][1]} over {out['none'][2]}")
            used = {k: v for k, v in out["mesh"][1].items() if v}
            print(f"[serve_mesh] {arm}: {MESH_REQ} requests x {MESH_NEW} "
                  f"tokens on a one-rank NCCL mesh (dp 1, tp 1): streams "
                  f"equal no mesh's bitwise; (decode, verify) ticks "
                  f"{out['mesh'][2]}; launches {used} equal; "
                  f"{out['mesh'][3]:.1f} tokens/s (no mesh "
                  f"{out['none'][3]:.1f})")
            for name, n in out["mesh"][1].items():
                total[name] = total.get(name, 0) + n
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return total


OFFLOAD_STEPS, OFFLOAD_XL_STEPS = 5, 3
#: the host tier against the plain stage-2 engine, GPT-2 small bf16: each
#: loss, relative; and the fp32 master's distance from the plain engine's
#: over the plain engine's own travel, ||host - plain|| / ||plain - init||
#: (a host Adam that never ran gives 1), after the first update (the same
#: gradient: only the two Adams' rounding differs) and after the window
#: (where a compute copy rounded apart feeds back into the gradients).
#: On an H100 the three read 5.5e-6, 9.3e-6 and 1.3e-2; updates that never
#: reached the card gave 1.7e-3 and 0.84 after the window
OFFLOAD_LOSS_RTOL = 1e-4
OFFLOAD_FIRST_RTOL = 1e-4
OFFLOAD_MASTER_RTOL = 5e-2


def _offload_config(dtype_block, micro, ga, **zero):
    conf = _train_config(dtype_block, micro, ga)
    conf["zero_optimization"] = {"stage": 2, **zero}
    return conf


def _master_leaves(eng):
    """The engine's fp32 master leaves copied to the host (the host
    tier's live in host RAM: copying them makes no device call)."""
    from deepspeed_tpu_torch.runtime.utils import tree_leaves
    return [x.detach().to("cpu", copy=True)
            for x in tree_leaves(eng.state.master_params)]


def _master_dist(a, b, base) -> float:
    """||a - b|| / ||b - base|| over lists of leaves, in fp64."""
    def sq(x, y):
        return sum(float(((u - v).double() ** 2).sum())
                   for u, v in zip(x, y))
    return (sq(a, b) / sq(b, base)) ** 0.5


def _upload_mismatch(eng):
    """The leaves whose compute copy on the card differs from the host
    master rounded to the compute dtype by torch: after every applied
    update the uploaded copy must equal it bitwise."""
    import torch
    return [i for i, (m, src) in enumerate(zip(eng._host_opt.master,
                                               eng._zero.sources))
            if not torch.equal(src.cpu(), m.to(src.dtype))]


def _run_lines(cmd) -> list:
    try:
        return subprocess.run(cmd, capture_output=True, text=True,
                              timeout=60).stdout.splitlines()
    except OSError:
        return []


def _host_line() -> str:
    """The host the tier runs on: usable cores, CPU (``lscpu``), total
    RAM (``free -g`` and /proc/meminfo), and the card's link as
    ``nvidia-smi -q`` reads it."""
    cpu = "; ".join(
        " ".join(ln.split()) for ln in _run_lines(["lscpu"])
        if ln.split(":")[0].strip() in ("Architecture", "Vendor ID",
                                        "Model name", "CPU(s)"))
    mem = next((int(ln.split()[1]) * 1024 for ln in open("/proc/meminfo")
                if ln.startswith("MemTotal")), 0)
    free_total = next((ln.split()[1] for ln in _run_lines(["free", "-g"])
                       if ln.startswith("Mem:")), "?")
    smi_q = _run_lines(["nvidia-smi", "-q"])
    at = next((i for i, ln in enumerate(smi_q)
               if ln.strip() == "GPU Link Info"), None)
    link = "not in nvidia-smi -q"
    if at is not None:
        depth = len(smi_q[at]) - len(smi_q[at].lstrip())
        block = []
        for ln in smi_q[at + 1:]:
            if ln.strip() and len(ln) - len(ln.lstrip()) <= depth:
                break
            if ln.strip():
                block.append(" ".join(ln.split()))
        link = ", ".join(block)
    return (f"nproc {len(os.sched_getaffinity(0))} (os.cpu_count "
            f"{os.cpu_count()}); lscpu: {cpu or 'not read'}; RAM MemTotal "
            f"{mem} B, free -g total {free_total} GiB; nvidia-smi -q GPU "
            f"Link Info: {link}")


def _offload_run(label, cfg, build, rows, steps, dev, profile=False,
                 probe=None):
    """One engine over a loader of ``rows``-row token batches: 1 warm
    step, then ``steps`` counted ones under sync debug mode 'warn'.
    ``probe(eng, k)`` runs after the build (k = -1) and after step k
    (0 the warm one, ``steps`` the last, both outside the counted
    window; between them only host reads, its time taken out of the
    step's).  Returns losses, launches, step ms, peak MiB, synchronizing
    calls, the last step's offload breakdown and (``profile``) the
    device busy ms of one profiled step."""
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    T = cfg.n_positions
    data = list(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (rows * (steps + 2), T + 1)))
    eng = build(data)
    if eng.device != dev:
        fail(f"{label}: initialize() placed the engine on {eng.device}")
    if probe is not None:
        probe(eng, -1)
    losses = [eng.train_batch()]
    torch.cuda.synchronize()
    if probe is not None:
        probe(eng, 0)
    torch.cuda.reset_peak_memory_stats(dev)
    _zero_counts()
    probe_s = 0.0
    t0 = time.perf_counter()

    def run():
        nonlocal probe_s
        out = []
        for k in range(1, steps + 1):
            out.append(eng.train_batch())
            if probe is not None and k < steps:
                p0 = time.perf_counter()
                probe(eng, k)
                probe_s += time.perf_counter() - p0
        return out

    more, syncs = _sync_count(run)
    losses += more
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0 - probe_s
    out = {"losses": [float(x) for x in losses], "launches": _train_counts(),
           "step_ms": wall / steps * 1e3, "syncs": syncs,
           "peak_mib": torch.cuda.max_memory_allocated(dev) / 2 ** 20,
           "skipped": eng.get_skipped_steps(),
           "breakdown": dict(getattr(eng, "last_offload_breakdown", None)
                             or {}),
           "offload": getattr(eng, "_offload", False)}
    if getattr(eng, "_offload_xla", False):
        out["xla"] = eng._xla.transfer_stats() or {}
        st = eng._zero.streamer
        out["host_bytes"] = eng._xla.nbytes + (st.nbytes if st else 0)
        out["adam_steps"] = int(eng._xla.count)
    elif out["offload"]:
        ho = eng._host_opt
        out["native"] = ho.is_native
        out["omp"] = (ho.opt.omp_threads, torch.get_num_threads())
        out["host_bytes"] = ho.staged_bytes
        out["adam_steps"] = ho.opt.step_count
    if probe is not None:
        probe(eng, steps)
    if profile:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile as prof_ctx
        with prof_ctx(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            eng.train_batch()
            torch.cuda.synchronize()
        out["busy_ms"] = sum(
            getattr(e, "self_device_time_total",
                    getattr(e, "self_cuda_time_total", 0))
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA) / 1e3
    eng.close()
    return out


def _print_offload(tag, r, rows, T):
    bd = r["breakdown"]
    gbs = lambda b, t: b / t / 1e9 if t > 0 else float("nan")  # noqa: E731
    line = (f"[{tag}] {r['step_ms']:.1f} ms per step = "
            f"{rows * T / (r['step_ms'] / 1e3):.0f} tokens/s; peak device "
            f"memory {r['peak_mib']:.1f} MiB; {r['syncs']} synchronizing "
            f"calls in {len(r['losses']) - 1} steps")
    if bd:
        line += (f"; D2H {bd['d2h_bytes'] / 2**20:.1f} MiB in "
                 f"{bd['d2h_s'] * 1e3:.2f} ms device = "
                 f"{gbs(bd['d2h_bytes'], bd['d2h_s']):.2f} GB/s; H2D "
                 f"{bd['h2d_bytes'] / 2**20:.1f} MiB in "
                 f"{bd['h2d_s'] * 1e3:.2f} ms = "
                 f"{gbs(bd['h2d_bytes'], bd['h2d_s']):.2f} GB/s; host Adam "
                 f"{bd['cpu_adam_s'] * 1e3:.1f} ms; overlap ratio "
                 f"{bd['overlap_ratio']:.3f}; exposed H2D tail "
                 f"{bd['h2d_tail_s'] * 1e3:.2f} ms")
    if "busy_ms" in r:
        line += (f"; device busy {r['busy_ms']:.1f} ms of a profiled step "
                 f"-> idle share {1 - r['busy_ms'] / r['step_ms']:.3f}")
    print(line)
    print(f"[{tag}] losses {' '.join(f'{x:.6f}' for x in r['losses'])}")


def phase_train_offload(dev):
    """ZeRO-Offload's host tier: GPT-2 small (the pipelined, inline,
    serial and delayed arms against each other and against the plain
    stage-2 engine: losses, the fp32 master, and the uploaded compute
    copy against the host master), then GPT-2 XL."""
    import dataclasses
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.gpt2 import (GPT2_SMALL, GPT2_XL,
                                                 GPT2Model)

    cfg = dataclasses.replace(GPT2_SMALL, dropout=0.1, embd_dropout=0.1,
                              remat="block")
    rows, T = TRAIN_MICRO * TRAIN_GA, cfg.n_positions
    bf16 = {"bf16": {"enabled": True}}
    L, A = cfg.n_layer, TRAIN_GA
    want = {"flash_fwd": 2 * L * A, "flash_bwd_dq": L * A,
            "flash_bwd_dkv": L * A}
    MAIN, DPU, PLAIN = ("pipelined, prefetch 2", "delayed update",
                        "plain stage 2")
    arms = (
        (MAIN, {"cpu_offload": True}, "1"),
        ("pipelined, inline", {"cpu_offload": True}, "0"),
        ("serial, inline", {"cpu_offload": True,
                            "offload_pipeline": False}, "0"),
        (DPU, {"cpu_offload": True, "delayed_param_update": True}, "1"),
        (PLAIN, {}, "1"))
    # the fp32 master: the plain engine's at its start, after its first
    # step and after the window; the main arm's after its first step and
    # after the window; the delayed update's after its first applied
    # update (its step 1)
    snap_at = {PLAIN: (-1, 0, OFFLOAD_STEPS), MAIN: (0, OFFLOAD_STEPS),
               DPU: (1,)}
    snaps, uploads, ref = {}, {}, {}

    def probe_for(label):
        def probe(eng, k):
            if k in snap_at.get(label, ()):
                snaps[label, k] = _master_leaves(eng)
            if k == OFFLOAD_STEPS and label != PLAIN:
                uploads[label] = _upload_mismatch(eng)
            if k == OFFLOAD_STEPS and label == MAIN:
                ref["compute"] = [s.detach().cpu()
                                  for s in eng._zero.sources]
        return probe

    runs, total = {}, {k: 0 for k in want}
    problems = []
    saved = os.environ.get("DS_PREFETCH")
    try:
        for label, zero, pf in arms:
            os.environ["DS_PREFETCH"] = pf

            def build(data, zero=zero):
                conf = _offload_config(bf16, TRAIN_MICRO, TRAIN_GA, **zero)
                conf["data_prefetch"] = {"depth": 2}
                return deepspeed_tpu_torch.initialize(
                    model=GPT2Model(cfg), seed=SEED, config=conf,
                    training_data=data)[0]
            r = runs[label] = _offload_run(
                f"train_offload {label}", cfg, build, rows, OFFLOAD_STEPS,
                dev, profile=label == MAIN, probe=probe_for(label))
            if label != PLAIN:
                for name, per_step in want.items():
                    total[name] += r["launches"][name]
                    if r["launches"][name] != per_step * OFFLOAD_STEPS:
                        problems.append(
                            f"{label}: {name} launched "
                            f"{r['launches'][name]} times in "
                            f"{OFFLOAD_STEPS} steps, expected {per_step} "
                            "per step")
                if not r["native"]:
                    problems.append(f"{label}: the host Adam is not native "
                                    "(no g++ build)")
                if r["syncs"] != OFFLOAD_STEPS:
                    problems.append(
                        f"{label}: {r['syncs']} synchronizing calls in "
                        f"{OFFLOAD_STEPS} steps, expected one a step (the "
                        "overflow flag)")
                if uploads[label]:
                    problems.append(
                        f"{label}: after the window the card's compute "
                        f"copy of leaves {uploads[label][:8]} (of "
                        f"{len(uploads[label])}) differs from the host "
                        "master rounded to bf16")
            if not all(np.isfinite(r["losses"])) or r["skipped"]:
                problems.append(f"{label}: losses {r['losses']}, "
                                f"{r['skipped']} skipped steps")
            _print_offload(f"train_offload {label}", r, rows, T)
    finally:
        if saved is None:
            os.environ.pop("DS_PREFETCH", None)
        else:
            os.environ["DS_PREFETCH"] = saved
    print(f"[train_offload] host: {_host_line()}")
    a = runs[MAIN]["losses"]
    for other in ("pipelined, inline", "serial, inline"):
        if runs[other]["losses"] != a:
            problems.append(f"{other}'s losses {runs[other]['losses']} "
                            f"differ from the prefetched pipelined run's {a}")
    plain = runs[PLAIN]["losses"]
    rel = max(abs(x - y) / abs(y) for x, y in zip(a, plain))
    if rel > OFFLOAD_LOSS_RTOL:
        problems.append(f"offload losses {a} vs the plain stage-2 engine's "
                        f"{plain}: relative {rel:.3g} > {OFFLOAD_LOSS_RTOL}")
    init = snaps[PLAIN, -1]
    d_first = _master_dist(snaps[MAIN, 0], snaps[PLAIN, 0], init)
    if not d_first <= OFFLOAD_FIRST_RTOL:
        problems.append(
            f"the host master after the first step lies {d_first:.3g} of "
            "the plain engine's first step from the plain engine's master "
            f"(bar {OFFLOAD_FIRST_RTOL})")
    d_main = _master_dist(snaps[MAIN, OFFLOAD_STEPS],
                          snaps[PLAIN, OFFLOAD_STEPS], init)
    if not d_main <= OFFLOAD_MASTER_RTOL:
        problems.append(
            f"the host master after {OFFLOAD_STEPS + 1} steps lies "
            f"{d_main:.3g} of the plain engine's travel from the plain "
            f"engine's master (bar {OFFLOAD_MASTER_RTOL})")
    # the delayed update's step t runs weights with t - 1 updates on batch
    # t, a pair the plain engine never evaluates: its exact counterparts
    # are the first loss (the same weights, batch and dropout draw) and
    # the master after its first applied update (the plain engine's
    # after step 0: the same gradient, the same Adam step)
    dpu = runs[DPU]["losses"]
    rel_dpu = abs(dpu[0] - plain[0]) / abs(plain[0])
    if rel_dpu > OFFLOAD_LOSS_RTOL:
        problems.append(f"the delayed update's first loss {dpu[0]} vs the "
                        f"plain engine's {plain[0]}: relative {rel_dpu:.3g}")
    d_dpu = _master_dist(snaps[DPU, 1], snaps[PLAIN, 0], init)
    if not d_dpu <= OFFLOAD_FIRST_RTOL:
        problems.append(
            f"the delayed update's master after its first applied update "
            f"lies {d_dpu:.3g} of the plain engine's first step from the "
            f"plain engine's master after it (bar {OFFLOAD_FIRST_RTOL})")
    if runs[DPU]["adam_steps"] != OFFLOAD_STEPS:
        problems.append(f"the delayed update applied "
                        f"{runs[DPU]['adam_steps']} updates in "
                        f"{OFFLOAD_STEPS + 1} steps, expected "
                        f"{OFFLOAD_STEPS}")
    # what the disk and XLA tiers' phases hold themselves against
    ref.update(losses=a, master=snaps[MAIN, OFFLOAD_STEPS],
               plain_losses=plain, plain_init=init,
               plain_first=snaps[PLAIN, 0],
               peak_mib=runs[MAIN]["peak_mib"])
    del snaps
    if problems:
        fail("train_offload: " + "; ".join(problems))
    r = runs[MAIN]
    print(f"[train_offload] GPT-2 small bf16 ZeRO-2 cpu_offload: "
          f"prefetched pipelined == inline pipelined == inline serial "
          f"bitwise ({len(a)} steps); the plain stage-2 engine's losses "
          f"within {rel:.3g} relative (bar {OFFLOAD_LOSS_RTOL}), its fp32 "
          f"master within {d_first:.3g} of its travel after the first step "
          f"(bar {OFFLOAD_FIRST_RTOL}) and {d_main:.3g} after the window "
          f"(bar {OFFLOAD_MASTER_RTOL}); delayed update: first loss within "
          f"{rel_dpu:.3g}, master after its first update within "
          f"{d_dpu:.3g} of the plain engine's first step; every arm's "
          f"compute copy on the card == the host master in bf16, bitwise; "
          f"host Adam native, OpenMP threads {r['omp'][0]}, torch intra-op "
          f"threads {r['omp'][1]}; host master and moments "
          f"{r['host_bytes']} B; peak device MiB {r['peak_mib']:.1f} "
          f"against the plain engine's {runs[PLAIN]['peak_mib']:.1f}")
    print(f"[train_offload] launches per step: flash_fwd "
          f"{want['flash_fwd']}, flash_bwd_dq {want['flash_bwd_dq']}, "
          f"flash_bwd_dkv {want['flash_bwd_dkv']}")

    xl = dataclasses.replace(GPT2_XL, remat="block")

    def build_xl(data):
        return deepspeed_tpu_torch.initialize(
            model=GPT2Model(xl), seed=SEED, training_data=data,
            config=_offload_config(bf16, 1, 1, cpu_offload=True))[0]
    need = 12 * xl.num_params
    mem = next(int(ln.split()[1]) * 1024 for ln in open("/proc/meminfo")
               if ln.startswith("MemTotal"))
    print(f"[train_offload] GPT-2 XL: {xl.num_params} parameters, host "
          f"fp32 master + Adam moments need {need} B "
          f"({need / 2**30:.1f} GiB) of the host's {mem} B "
          f"({mem / 2**30:.1f} GiB)")
    xl_snap = {}

    def probe_xl(eng, k):
        if k == -1:
            xl_snap["init"] = _master_leaves(eng)
        elif k == OFFLOAD_XL_STEPS:
            now = eng._host_opt.master
            xl_snap["still"] = [i for i, (x, y) in enumerate(
                zip(xl_snap.pop("init"), now)) if torch.equal(x, y)]
            xl_snap["uploads"] = _upload_mismatch(eng)
    r = _offload_run("train_offload GPT-2 XL", xl, build_xl, 1,
                     OFFLOAD_XL_STEPS, dev, probe=probe_xl)
    Lx = xl.n_layer
    for name, per_step in {"flash_fwd": 2 * Lx, "flash_bwd_dq": Lx,
                           "flash_bwd_dkv": Lx}.items():
        total[name] += r["launches"][name]
        if r["launches"][name] != per_step * OFFLOAD_XL_STEPS:
            fail(f"train_offload GPT-2 XL: {name} launched "
                 f"{r['launches'][name]} times, expected {per_step} a step")
    if not all(np.isfinite(r["losses"])) or r["skipped"] \
            or r["syncs"] != OFFLOAD_XL_STEPS:
        fail(f"train_offload GPT-2 XL: losses {r['losses']}, "
             f"{r['skipped']} skipped, {r['syncs']} synchronizing calls")
    if xl_snap["still"] or xl_snap["uploads"] \
            or r["adam_steps"] != OFFLOAD_XL_STEPS + 1:
        fail(f"train_offload GPT-2 XL: master leaves {xl_snap['still']} "
             f"never moved, compute copies of leaves {xl_snap['uploads']} "
             f"differ from the host master in bf16, {r['adam_steps']} "
             f"updates in {OFFLOAD_XL_STEPS + 1} steps")
    print(f"[train_offload] GPT-2 XL bf16 ZeRO-2 cpu_offload, micro-batch "
          f"1 x {xl.n_positions}: host master and moments "
          f"{r['host_bytes']} B; every master leaf moved, {r['adam_steps']} "
          f"updates; the compute copy on the card == the host master in "
          f"bf16, bitwise")
    _print_offload("train_offload GPT-2 XL", r, 1, xl.n_positions)
    ref["xl_peak_mib"] = r["peak_mib"]
    return total, ref


DISK_IO_DEPTH = 2
#: the serial loop's counted steps: it is held to the pipelined run's
#: state after this many (the disk's write rate dominates both loops)
DISK_SERIAL_STEPS = 2


def _disk_budget(ho) -> int:
    """The disk tier's analytic window: (2 io_depth + 3) leaf states
    (read-ahead queue, the leaf being read, the one in update, the
    write-back queue, the one being written)."""
    biggest = max((3 if prom else 1) * int(np.prod(shape, dtype=np.int64))
                  * 4 for shape, _, prom in ho._meta)
    return (2 * ho.io_depth + 3) * biggest


def phase_train_offload_disk(dev, ref):
    """The disk tier on train_offload's model and batches: the pipelined
    and serial loops bitwise each other and the host tier's arm (a)."""
    import dataclasses
    import shutil
    import tempfile
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.gpt2 import GPT2_SMALL, GPT2Model

    cfg = dataclasses.replace(GPT2_SMALL, dropout=0.1, embd_dropout=0.1,
                              remat="block")
    rows, T = TRAIN_MICRO * TRAIN_GA, cfg.n_positions
    L, A = cfg.n_layer, TRAIN_GA
    want = {"flash_fwd": 2 * L * A, "flash_bwd_dq": L * A,
            "flash_bwd_dkv": L * A}
    bf16 = {"bf16": {"enabled": True}}
    root = tempfile.mkdtemp(prefix="ds_disk_tier_")
    keys = ("DS_PREFETCH", "DS_DISK_FSYNC", "DS_DISK_OFFLOAD_PIPELINE")
    saved = {k: os.environ.get(k) for k in keys}
    runs, finals, total, problems = {}, {}, {k: 0 for k in want}, []
    try:
        df = _run_lines(["df", "-B1", "-T", root])
        os.environ.update({"DS_PREFETCH": "1", "DS_DISK_FSYNC": "1"})
        for label, pipe, steps in (("pipelined", "1", OFFLOAD_STEPS),
                                   ("serial", "0", DISK_SERIAL_STEPS)):
            os.environ["DS_DISK_OFFLOAD_PIPELINE"] = pipe
            state_dir = os.path.join(root, label)

            def build(data, state_dir=state_dir):
                conf = _offload_config(bf16, TRAIN_MICRO, TRAIN_GA,
                                       cpu_offload=True)
                conf["data_prefetch"] = {"depth": 2}
                conf["offload"] = {"tier": "disk", "disk_dir": state_dir,
                                   "io_depth": DISK_IO_DEPTH, "fsync": True}
                return deepspeed_tpu_torch.initialize(
                    model=GPT2Model(cfg), seed=SEED, config=conf,
                    training_data=data)[0]

            def probe(eng, k, label=label, steps=steps):
                if k == DISK_SERIAL_STEPS and label == "pipelined":
                    finals["at_serial_end"] = [v.materialize()
                                               for v in eng._host_opt.master]
                if k == steps:
                    ho = eng._host_opt
                    finals[label] = {
                        "master": [v.materialize() for v in ho.master],
                        "compute": [x.detach().cpu()
                                    for x in eng._zero.sources],
                        "peak": ho.peak_resident_bytes,
                        "budget": _disk_budget(ho),
                        "total": ho.total_state_bytes,
                        "fsync": ho._store.fsync,
                        "kind": type(ho).__name__}
            r = runs[label] = _offload_run(
                f"train_offload_disk {label}", cfg, build, rows, steps, dev,
                probe=probe)
            f = finals[label]
            for name, per_step in want.items():
                total[name] += r["launches"][name]
                if r["launches"][name] != per_step * steps:
                    problems.append(f"{label}: {name} launched "
                                    f"{r['launches'][name]} times")
            if f["kind"] != "DiskOffloadOptimizer" or not f["fsync"]:
                problems.append(f"{label}: tier {f['kind']}, fsync "
                                f"{f['fsync']}")
            if not r["native"]:
                problems.append(f"{label}: the host Adam is not native")
            if not f["peak"] or f["peak"] > f["budget"]:
                problems.append(
                    f"{label}: resident state peaked at {f['peak']} B, the "
                    f"io_depth {DISK_IO_DEPTH} window is {f['budget']} B")
            if bool(r["breakdown"].get("disk_serial")) != (pipe == "0"):
                problems.append(f"{label}: disk_serial "
                                f"{r['breakdown'].get('disk_serial')}")
            if r["losses"] != ref["losses"][:steps + 1]:
                problems.append(f"{label}: losses {r['losses']} differ "
                                f"from the host tier's {ref['losses']}")
            if label == "pipelined":
                bad_m = [i for i, (x, y) in enumerate(zip(f["master"],
                                                          ref["master"]))
                         if not torch.equal(x, y)]
                bad_c = [i for i, (x, y) in enumerate(zip(f["compute"],
                                                          ref["compute"]))
                         if not torch.equal(x, y)]
            else:
                bad_m = [i for i, (x, y) in enumerate(zip(
                    f["master"], finals.pop("at_serial_end")))
                    if not torch.equal(x, y)]
                bad_c = []
            if bad_m or bad_c:
                problems.append(
                    f"{label}: master leaves {bad_m[:8]} and compute "
                    f"copies {bad_c[:8]} differ from the host tier's (the "
                    "pipelined run's, for the serial loop)")
            _print_offload(f"train_offload_disk {label}", r, rows, T)
            bd = r["breakdown"]
            gbs = lambda b, t: b / t / 1e9 if t > 0 else float("nan")  # noqa
            print(f"[train_offload_disk {label}] disk read "
                  f"{bd['disk_bytes_read']} B in {bd['disk_read_s']:.3f} s "
                  f"of read calls = {gbs(bd['disk_bytes_read'], bd['disk_read_s']):.2f} "
                  f"GB/s; write {bd['disk_bytes_written']} B in "
                  f"{bd['disk_write_s']:.3f} s = "
                  f"{gbs(bd['disk_bytes_written'], bd['disk_write_s']):.2f} "
                  f"GB/s (fsync on); overlap ratio "
                  f"{bd['disk_overlap_ratio']:.3f}; state on disk "
                  f"{f['total']} B, resident window peak {f['peak']} B of "
                  f"the {f['budget']} B budget")
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(root, ignore_errors=True)
    print(f"[train_offload_disk] filesystem (df -B1 -T): "
          f"{' | '.join(' '.join(ln.split()) for ln in df)}")
    del finals
    if problems:
        fail("train_offload_disk: " + "; ".join(problems))
    print(f"[train_offload_disk] GPT-2 small bf16 ZeRO-2 disk tier (fsync "
          f"on, io_depth {DISK_IO_DEPTH}): the pipelined loop == the host "
          f"tier's arm (a) bitwise over 1 + {OFFLOAD_STEPS} steps (losses, "
          f"fp32 master, compute copy on the card), the serial loop == the "
          f"pipelined one over 1 + {DISK_SERIAL_STEPS} (losses, fp32 "
          f"master); the Adam native; the resident window within its "
          f"budget")
    return total


def _xla_master(eng):
    """The XLA tier's fp32 master leaves in the master's placement, on
    the host (tree_leaves order)."""
    return eng._xla_canonical()[0]


def phase_train_offload_xla(dev, ref):
    """The XLA tier (pinned host pieces, the update on the card): the
    fused, chunked, split, delayed and ZeRO-3 arms on train_offload's
    model and batches, then GPT-2 XL with parameter streaming."""
    import dataclasses
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.gpt2 import (GPT2_SMALL, GPT2_XL,
                                                 GPT2Model)
    from deepspeed_tpu_torch.runtime.offload_xla import unpack_leaf

    cfg = dataclasses.replace(GPT2_SMALL, dropout=0.1, embd_dropout=0.1,
                              remat="block")
    rows, T = TRAIN_MICRO * TRAIN_GA, cfg.n_positions
    L, A = cfg.n_layer, TRAIN_GA
    want = {"flash_fwd": 2 * L * A, "flash_bwd_dq": L * A,
            "flash_bwd_dkv": L * A}
    bf16 = {"bf16": {"enabled": True}}
    xla = {"cpu_offload": True, "offload_impl": "xla"}
    FUSED, CHUNKS, SPLIT, DPU, Z3 = ("fused", "grad chunks 2",
                                     "split update", "delayed update",
                                     "ZeRO-3, one-rank NCCL group")
    arms = ((FUSED, {}, 1), (CHUNKS, {"offload_grad_chunks": 2}, 2),
            (SPLIT, {"offload_split_update": True}, 1),
            (DPU, {"delayed_param_update": True}, 1), (Z3, {"stage": 3}, 1))
    runs, finals, total, problems = {}, {}, {k: 0 for k in want}, []
    saved = os.environ.get("DS_PREFETCH")
    os.environ["DS_PREFETCH"] = "1"
    try:
        for label, extra, mult in arms:
            zero = {**xla, **{k: v for k, v in extra.items()
                              if k != "stage"}}

            def build(data, zero=zero, stage=extra.get("stage", 2)):
                conf = _offload_config(bf16, TRAIN_MICRO, TRAIN_GA, **zero)
                conf["zero_optimization"]["stage"] = stage
                conf["data_prefetch"] = {"depth": 2}
                eng = deepspeed_tpu_torch.initialize(
                    model=GPT2Model(cfg), seed=SEED, config=conf,
                    training_data=data)[0]
                eng._xla_timing = True
                return eng

            def probe(eng, k, label=label):
                if k == 0 and label == FUSED:
                    finals["first"] = _xla_master(eng)
                if k == OFFLOAD_STEPS:
                    m = _xla_master(eng)
                    c = [x.detach().cpu() for x in eng._zero.sources]
                    finals[label] = {
                        "master": m, "compute": c,
                        "upload": [i for i, (x, y) in enumerate(zip(m, c))
                                   if not torch.equal(x.to(y.dtype), y)],
                        "stage": eng.zero_stage, "mesh": eng.mesh.size}

            def go(label=label, build=build, probe=probe):
                return _offload_run(f"train_offload_xla {label}", cfg,
                                    build, rows, OFFLOAD_STEPS, dev,
                                    profile=label == FUSED, probe=probe)
            if label == Z3:
                with _one_rank_group():
                    r = runs[label] = go()
            else:
                r = runs[label] = go()
            f = finals[label]
            for name, per_step in want.items():
                total[name] += r["launches"][name]
                # each group runs the forward and its recompute whole; its
                # backward skips the attention input gradients no kept
                # leaf needs, so dQ and dK/dV run once to ``mult`` times
                lo = (mult if name == "flash_fwd" else 1) * per_step
                n = r["launches"][name]
                if not lo * OFFLOAD_STEPS <= n <= (mult * per_step
                                                   * OFFLOAD_STEPS):
                    problems.append(
                        f"{label}: {name} launched {n} times in "
                        f"{OFFLOAD_STEPS} steps, expected {lo} to "
                        f"{mult * per_step} per step")
            if not all(np.isfinite(r["losses"])) or r["skipped"]:
                problems.append(f"{label}: losses {r['losses']}, "
                                f"{r['skipped']} skipped")
            if f["upload"]:
                problems.append(f"{label}: compute copies of leaves "
                                f"{f['upload'][:8]} differ from the pinned "
                                "master in bf16")
            want_steps = OFFLOAD_STEPS if label == DPU else OFFLOAD_STEPS + 1
            if r["adam_steps"] != want_steps:
                problems.append(f"{label}: {r['adam_steps']} updates "
                                f"applied, expected {want_steps}")
            if label == Z3 and (f["stage"] != 3 or f["mesh"] != 1):
                problems.append(f"{label}: stage {f['stage']} on a mesh of "
                                f"{f['mesh']}")
            _print_offload(f"train_offload_xla {label}", r, rows, T)
            x = r["xla"]
            gbs = lambda b, t: b / t / 1e9 if t > 0 else float("nan")  # noqa
            if x:
                print(f"[train_offload_xla {label}] the update's H2D "
                      f"{x['h2d_bytes']} B over {x['h2d_s'] * 1e3:.2f} ms "
                      f"of its stream = {gbs(x['h2d_bytes'], x['h2d_s']):.2f}"
                      f" GB/s; its D2H {x['d2h_bytes']} B within the whole "
                      f"update's {x['window_s'] * 1e3:.2f} ms = "
                      f"{gbs(x['d2h_bytes'], x['window_s']):.2f} GB/s; "
                      f"pinned host bytes {r['host_bytes']}; {r['syncs']} "
                      f"synchronizing calls in {OFFLOAD_STEPS} steps")
    finally:
        if saved is None:
            os.environ.pop("DS_PREFETCH", None)
        else:
            os.environ["DS_PREFETCH"] = saved
    fused = runs[FUSED]["losses"]
    plain = ref["plain_losses"]
    rel = max(abs(x - y) / abs(y) for x, y in zip(fused, plain))
    if rel > OFFLOAD_LOSS_RTOL:
        problems.append(f"fused losses {fused} vs the plain stage-2 "
                        f"engine's {plain}: relative {rel:.3g} > "
                        f"{OFFLOAD_LOSS_RTOL}")
    d_first = _master_dist(finals["first"], ref["plain_first"],
                           ref["plain_init"])
    if not d_first <= OFFLOAD_FIRST_RTOL:
        problems.append(f"the pinned master after the first step lies "
                        f"{d_first:.3g} of the plain engine's first step "
                        f"from its master (bar {OFFLOAD_FIRST_RTOL})")
    for label in (CHUNKS, SPLIT, Z3):
        same = (runs[label]["losses"] == fused and all(
            torch.equal(x, y) for k in ("master", "compute")
            for x, y in zip(finals[label][k], finals[FUSED][k])))
        if not same:
            problems.append(f"{label}: losses {runs[label]['losses']} or "
                            f"its master/compute copy differ from the fused "
                            f"arm's {fused}")
    if runs[DPU]["losses"][0] != fused[0]:
        problems.append(f"the delayed update's first loss "
                        f"{runs[DPU]['losses'][0]} != the fused arm's "
                        f"{fused[0]}")
    del finals
    if problems:
        fail("train_offload_xla: " + "; ".join(problems))
    print(f"[train_offload_xla] GPT-2 small bf16 ZeRO-2 XLA tier: losses "
          f"within {rel:.3g} relative of the plain stage-2 engine (bar "
          f"{OFFLOAD_LOSS_RTOL}), the fp32 master after the first step "
          f"within {d_first:.3g} of its travel (bar {OFFLOAD_FIRST_RTOL}); "
          f"grad chunks 2, the split update and ZeRO-3 (one-rank NCCL "
          f"group) bitwise the fused arm (losses, master, compute copy); "
          f"the delayed update's first loss bitwise; every arm's compute "
          f"copy on the card == the pinned master in bf16; peak device MiB "
          f"{runs[FUSED]['peak_mib']:.1f} against the host tier's "
          f"{ref['peak_mib']:.1f}")

    xl = dataclasses.replace(GPT2_XL, remat="block", stream_scan=True)
    xl_fetch = {}

    def build_xl(data):
        eng = deepspeed_tpu_torch.initialize(
            model=GPT2Model(xl), seed=SEED, training_data=data,
            config=_offload_config(bf16, 1, 1, **xla, param_streaming=True,
                                   offload_split_update=True))[0]
        eng._xla_timing = True
        return eng

    def probe_xl(eng, k):
        st = eng._zero.streamer
        if k == 0:
            st.fetch_timing = []
        elif k == OFFLOAD_XL_STEPS:
            xl_fetch.update(st.fetch_stats() or {})
            xl_fetch["streamed"] = len(st.leaves)
            xp = eng._xla
            xp.sync()
            bad = []
            for i, m in enumerate(xp.master):
                if i in st.leaves:
                    continue
                want_c = unpack_leaf(m[None], eng._flat_layout[i])
                src = eng._zero.sources[i].cpu()
                if not torch.equal(src, want_c.to(src.dtype)):
                    bad.append(i)
            xl_fetch["bad"] = bad
    r = _offload_run("train_offload_xla GPT-2 XL streaming", xl, build_xl,
                     1, OFFLOAD_XL_STEPS, dev, probe=probe_xl)
    Lx = xl.n_layer
    for name, per_step in {"flash_fwd": 2 * Lx, "flash_bwd_dq": Lx,
                           "flash_bwd_dkv": Lx}.items():
        total[name] += r["launches"][name]
        if r["launches"][name] != per_step * OFFLOAD_XL_STEPS:
            fail(f"train_offload_xla GPT-2 XL: {name} launched "
                 f"{r['launches'][name]} times, expected {per_step} a step")
    if not all(np.isfinite(r["losses"])) or r["skipped"] \
            or r["adam_steps"] != OFFLOAD_XL_STEPS + 1 or xl_fetch["bad"]:
        fail(f"train_offload_xla GPT-2 XL: losses {r['losses']}, "
             f"{r['skipped']} skipped, {r['adam_steps']} updates, compute "
             f"copies of leaves {xl_fetch['bad']} differ from bf16 of the "
             f"pinned master")
    _print_offload("train_offload_xla GPT-2 XL streaming", r, 1,
                   xl.n_positions)
    x = r["xla"]
    if x:
        print(f"[train_offload_xla GPT-2 XL streaming] the update's H2D "
              f"{x['h2d_bytes']} B over {x['h2d_s'] * 1e3:.2f} ms of its "
              f"stream; its D2H {x['d2h_bytes']} B within the whole "
              f"update's {x['window_s'] * 1e3:.2f} ms")
    fb, fs = xl_fetch.get("bytes", 0), xl_fetch.get("seconds", 0.0)
    print(f"[train_offload_xla] GPT-2 XL bf16 XLA tier, param_streaming "
          f"({xl_fetch['streamed']} stacked leaves in pinned host memory), "
          f"split update, micro-batch 1 x {xl.n_positions}: pinned host "
          f"bytes {r['host_bytes']}; peak device MiB {r['peak_mib']:.1f} "
          f"against this run's XL host tier {ref['xl_peak_mib']:.1f}; "
          f"{r['step_ms']:.1f} ms per step; layer fetches "
          f"{fb} B in {fs * 1e3:.1f} ms of copies over "
          f"{OFFLOAD_XL_STEPS} steps = "
          f"{fb / fs / 1e9 if fs > 0 else float('nan'):.2f} GB/s; every "
          f"non-streamed leaf's compute copy on the card == bf16 of the "
          f"pinned master")
    return total


def _dir_bytes(root: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(root) for f in files)


def phase_checkpoint(dev):
    """Save, load and resume full-size GPT-2 small training with
    phase_train's config (bf16, dropout 0.1, remat block, accumulation 2):
    the resumed losses must equal the uninterrupted run's bitwise; then
    an async save drained by close, and the fallback past a flipped
    byte to the older tag."""
    import dataclasses
    import json as _json
    import shutil
    import tempfile
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.gpt2 import GPT2_SMALL, GPT2Model

    cfg = dataclasses.replace(GPT2_SMALL, dropout=0.1, embd_dropout=0.1,
                              remat="block")
    config = _train_config({"bf16": {"enabled": True}}, TRAIN_MICRO,
                           TRAIN_GA)

    def engine(seed):
        return deepspeed_tpu_torch.initialize(model=GPT2Model(cfg),
                                              seed=seed, config=config)[0]

    T, rows = cfg.n_positions, TRAIN_MICRO * TRAIN_GA
    rng = np.random.default_rng(SEED + 3)
    batches = [torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                             (rows, T + 1))).to(dev)
               for _ in range(2 * CKPT_STEPS)]
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        _zero_counts()
        eng = engine(SEED)
        for b in batches[:CKPT_STEPS]:
            eng.train_batch(b)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.save_checkpoint(root, tag="a")
        save_s = time.perf_counter() - t0
        nbytes = _dir_bytes(os.path.join(root, "a"))
        ref = [float(eng.train_batch(b)) for b in batches[CKPT_STEPS:]]
        eng.close()
        del eng
        eng = engine(SEED + 1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path, _ = eng.load_checkpoint(root)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        if not path.endswith("a") or eng.global_steps != CKPT_STEPS:
            fail(f"checkpoint: loaded {path} at step {eng.global_steps}")
        got = [float(eng.train_batch(b)) for b in batches[CKPT_STEPS:]]
        if got != ref:
            fail(f"checkpoint: resumed losses {got} differ from the "
                 f"uninterrupted run's {ref}")
        # an async save while steps continue; close drains it
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.save_checkpoint(root, tag="b", async_write=True)
        async_s = time.perf_counter() - t0
        for b in batches[:2]:
            eng.train_batch(b)
        t0 = time.perf_counter()
        eng.close()
        close_s = time.perf_counter() - t0
        with open(os.path.join(root, "latest")) as f:
            latest = f.read().strip()
        with open(os.path.join(root, "b", "meta.json")) as f:
            b_steps = _json.load(f)["global_steps"]
        if eng.last_ckpt_error is not None or latest != "b" \
                or b_steps != 2 * CKPT_STEPS:
            fail(f"checkpoint: async save left latest {latest!r} at step "
                 f"{b_steps}, error {eng.last_ckpt_error!r}")
        del eng
        # flip one byte of a leaf of the newest tag: the load falls back
        with open(os.path.join(root, "b", "optim", "manifest.json")) as f:
            entry = max(_json.load(f).values(), key=lambda e: e["nbytes"])
        leaf = os.path.join(root, "b", "optim", entry["file"])
        with open(leaf, "r+b") as f:
            f.seek(-1, os.SEEK_END)
            byte = f.read(1)
            f.seek(-1, os.SEEK_END)
            f.write(bytes([byte[0] ^ 0xFF]))
        eng = engine(SEED + 2)
        path, _ = eng.load_checkpoint(root)
        if not path.endswith("a") or eng.global_steps != CKPT_STEPS:
            fail(f"checkpoint: a corrupt latest loaded {path} at step "
                 f"{eng.global_steps}, not the older tag 'a'")
        eng.close()
        torch.cuda.synchronize()
        launches = _train_counts()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"[checkpoint] GPT-2 small bf16 (phase_train's config): "
          f"{nbytes} B per checkpoint (model plane bf16, optim plane fp32 "
          f"master + Adam moments); sync save {save_s:.3f} s, load "
          f"{load_s:.3f} s; {CKPT_STEPS} resumed steps' losses equal the "
          f"uninterrupted run's bitwise ({' '.join(f'{x:.6f}' for x in got)}"
          f"); async save returned in {async_s:.3f} s, close drained it in "
          f"{close_s:.3f} s; a flipped byte in tag 'b' ({entry['file']}) "
          f"fell back to tag 'a'; {smi()}")
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


def _sparse_layouts():
    """The sparse-kernel phase's layouts at [2, 16, 4096, 64]: name →
    (layout [16, nb, nb], block)."""
    from deepspeed_tpu_torch.ops.sparse_attention import (
        BigBirdSparsityConfig, FixedSparsityConfig)
    H, T = SPARSE_SHAPE[1], SPARSE_SHAPE[2]
    empty = FixedSparsityConfig(num_heads=H).make_layout(T)
    empty[:, 5, :] = 0            # a query block row and a key block
    empty[:, :, 9] = 0            # column with no active block
    return {
        "fixed16": (FixedSparsityConfig(num_heads=H).make_layout(T), 16),
        "bigbird64": (BigBirdSparsityConfig(num_heads=H,
                                            block=64).make_layout(T), 64),
        "bigbird32 per head": (BigBirdSparsityConfig(
            num_heads=H, block=32, different_layout_per_head=True,
            seed=SEED).make_layout(T), 32),
        "bigbird16 per head": (BigBirdSparsityConfig(
            num_heads=H, block=16, different_layout_per_head=True,
            seed=SEED).make_layout(T), 16),
        "fixed16 empty row and column": (empty, 16),
    }


def _sparse_tables(bs, layout, block, dev):
    """The four LUT arrays and the group tables of ``layout`` on
    ``dev``."""
    host = bs.build_kernel_luts(layout)
    groups = bs.build_group_luts(*host, block)
    return bs.device_luts(host, dev), bs.GroupLuts(*bs.device_luts(groups,
                                                                   dev))


def phase_sparse_kernels(dev, results):
    """The three block-sparse kernels against their plain versions at
    [2, 16, 4096, 64] (fp32 within 1e-4; bf16 within 2e-2 of the plain
    version in fp32 on the same inputs; gradients relative to their
    largest magnitude when it exceeds 1) on five layouts, then their bf16
    timings on the sparse phase's layout (Fixed, block 16) beside the
    plain versions, SDPA with the layout as a token mask, and the bounds
    of the active blocks' bytes and operations."""
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.kernels import block_sparse_attention as bs

    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 7)
    B, H, T, D = SPARSE_SHAPE
    scale = D ** -0.5
    q32, k32, v32, do32 = (torch.randn(SPARSE_SHAPE, generator=g, device=dev)
                           for _ in range(4))
    errs = {}
    for label, (layout, block) in _sparse_layouts().items():
        (cols, nvalid, rows_t, nvalid_t), groups = _sparse_tables(
            bs, layout, block, dev)
        for dtype in ("float32", "bfloat16"):
            tdt = getattr(torch, dtype)
            q, k, v, do = (t.to(tdt) for t in (q32, k32, v32, do32))
            f32 = (q.float(), k.float(), v.float())
            out, lse = bs.block_sparse_fwd_cuda(q, k, v, cols, nvalid, scale,
                                                block, groups)
            torch.cuda.synchronize()
            ref, ref_lse = bs.block_sparse_fwd_plain(*f32, cols, nvalid,
                                                     scale, block)
            err = (out.float() - ref).abs().max().item()
            lse_err = (lse - ref_lse).abs().max().item()
            ulp = _ulp_err(out, ref)
            delta = (do.float() * ref).sum(-1)
            dq = bs.block_sparse_bwd_dq_cuda(q, k, v, do, ref_lse, delta,
                                             cols, nvalid, scale, block,
                                             groups)
            dk, dv = bs.block_sparse_bwd_dkv_cuda(q, k, v, do, ref_lse, delta,
                                                  rows_t, nvalid_t, scale,
                                                  block, groups)
            torch.cuda.synchronize()
            plain = (*f32, do.float(), ref_lse, delta)
            e_dq = _rel_err(dq, bs.block_sparse_bwd_dq_plain(
                *plain, cols, nvalid, scale, block))
            rdk, rdv = bs.block_sparse_bwd_dkv_plain(*plain, rows_t, nvalid_t,
                                                     scale, block)
            e_dkv = max(_rel_err(dk, rdk), _rel_err(dv, rdv))
            del rdk, rdv
            print(f"[sparse kernels] {label} (block {block}, "
                  f"{cols.shape[0]} LUT plane(s), density "
                  f"{layout.mean():.3f}) {dtype}: fwd err "
                  f"{err:.3g} (lse {lse_err:.3g}; {ulp:.3g} of one bf16 ulp "
                  f"+ 1e-4), dq err {e_dq:.3g}, dk/dv err {e_dkv:.3g}")
            if not (max(err, lse_err, e_dq, e_dkv) <= TOL[dtype]
                    and (dtype == "float32" or ulp <= 1.0)):
                fail(f"block-sparse kernels {label} {dtype}: errors {err} / "
                     f"{lse_err} / {e_dq} / {e_dkv} above {TOL[dtype]}, or "
                     f"forward {ulp} ulp-relative above 1")
            if not all(torch.isfinite(t).all() for t in (out, dq, dk, dv)):
                fail(f"block-sparse kernels {label} {dtype}: non-finite")
            if "empty" in label:
                rows = slice(5 * block, 6 * block)
                keys = slice(9 * block, 10 * block)
                if not ((out[:, :, rows] == 0).all()
                        and (lse[:, :, rows] == -1e30).all()
                        and (dq[:, :, rows] == 0).all()
                        and (dk[:, :, keys] == 0).all()
                        and (dv[:, :, keys] == 0).all()):
                    fail("block-sparse kernels: the empty row / column is "
                         "not exact zeros")
            if label == "fixed16" and dtype == "bfloat16":
                errs = {"fwd": err, "dq": e_dq, "dkv": e_dkv}
            del out, lse, dq, dk, dv, ref, ref_lse, delta
        del groups
        torch.cuda.empty_cache()

    # timings, bf16, on the sparse phase's layout
    layout, block = _sparse_layouts()["fixed16"]
    (cols, nvalid, rows_t, nvalid_t), groups = _sparse_tables(bs, layout,
                                                              block, dev)
    q, k, v, do = (t.bfloat16() for t in (q32, k32, v32, do32))
    out, lse = bs.block_sparse_fwd_cuda(q, k, v, cols, nvalid, scale, block,
                                        groups)
    delta = (do.float() * out.float()).sum(-1)
    # active (query, key) pairs: every head's layout, block x block each
    pairs = B * int(layout.sum()) * block * block
    row_b = B * H * T * D * 2            # one bf16 [B, H, T, 64] tensor
    stat_b = B * H * T * 4               # one fp32 [B, H, T] statistic
    # the tensor-core kernels read the group tables instead of the LUT
    grp_b = sum(t.numel() * 4 for t in groups[:3])
    grp_tb = sum(t.numel() * 4 for t in groups[3:])
    mask = torch.from_numpy(np.kron(layout[0], np.ones(
        (block, block), np.int64)) > 0).to(dev)[None, None]
    qs, ks, vs = (t.clone().requires_grad_(True) for t in (q, k, v))

    def lib_fwd():
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask)

    def lib_fwd_bwd():
        o = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask)
        torch.autograd.grad(o, (qs, ks, vs), do)

    lib_o = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask)

    def lib_bwd():  # the backward alone, over one saved forward
        torch.autograd.grad(lib_o, (qs, ks, vs), do, retain_graph=True)

    lib_ms = time_ms(lib_fwd, 10)
    lib_fb_ms = time_ms(lib_fwd_bwd, 10)
    lib_b_ms = time_ms(lib_bwd, 10)
    lib_dev = device_ms(lib_fwd, 10)
    lib_fb_dev = device_ms(lib_fwd_bwd, 10)
    lib_b_dev = device_ms(lib_bwd, 10)
    del lib_o
    note = ("F.scaled_dot_product_attention with the layout expanded to a "
            "[T, T] boolean token mask")
    specs = {
        "block_sparse_fwd": (
            "block_sparse_fwd.cu", 105, errs["fwd"],
            lambda: bs.block_sparse_fwd_cuda(q, k, v, cols, nvalid, scale,
                                             block, groups),
            lambda: bs.block_sparse_fwd_plain(q, k, v, cols, nvalid, scale,
                                              block),
            4 * row_b + stat_b + grp_b, 4 * D * pairs, lib_ms, lib_dev,
            note + ", forward"),
        "block_sparse_bwd_dq": (
            "block_sparse_bwd_dq.cu", 200, errs["dq"],
            lambda: bs.block_sparse_bwd_dq_cuda(q, k, v, do, lse, delta, cols,
                                                nvalid, scale, block, groups),
            lambda: bs.block_sparse_bwd_dq_plain(q, k, v, do, lse, delta,
                                                 cols, nvalid, scale, block),
            5 * row_b + 2 * stat_b + grp_b, 6 * D * pairs, lib_b_ms,
            lib_b_dev, note + ", the backward alone (all three gradients) "
            "over one saved forward"),
        "block_sparse_bwd_dkv": (
            "block_sparse_bwd_dkv.cu", 235, errs["dkv"],
            lambda: bs.block_sparse_bwd_dkv_cuda(q, k, v, do, lse, delta,
                                                 rows_t, nvalid_t, scale,
                                                 block, groups),
            lambda: bs.block_sparse_bwd_dkv_plain(q, k, v, do, lse, delta,
                                                  rows_t, nvalid_t, scale,
                                                  block),
            6 * row_b + 2 * stat_b + grp_tb, 8 * D * pairs, lib_b_ms,
            lib_b_dev, note + ", the backward alone (all three gradients) "
            "over one saved forward"),
    }
    for name, (src, line, err, run, plain, nbytes, flops, lib, lib_dev_ms,
               lib_note) in specs.items():
        bms, by = bound_ms(nbytes, flops, "bfloat16")
        results[name] = {
            "name": name, "route": "cuda",
            "source": f"deepspeed_tpu_torch/csrc/{src}",
            "replaces": ("deepspeed_tpu/ops/pallas/block_sparse_attention.py:"
                         f"{line}"),
            "max_abs_err": err, "shape": list(SPARSE_SHAPE),
            "layout": "FixedSparsityConfig(num_heads=16), block 16, density "
                      f"{layout.mean():.4f}",
            "device_ms_method": DEVICE_MS_METHOD,
            **timings(run, plain, plain_iters=5),
            "bound_ms": bms, "bound_by": by, "library_ms": lib,
            "library_device_ms": lib_dev_ms, "library_note": lib_note,
            "library_fwd_ms": lib_ms, "library_fwd_device_ms": lib_dev,
            "library_fwd_bwd_ms": lib_fb_ms,
            "library_fwd_bwd_device_ms": lib_fb_dev,
        }
        print_row("[sparse kernels]", f"{name} bf16 {SPARSE_SHAPE}",
                  results[name])
    print(f"[sparse kernels] SDPA with the token mask: forward {lib_ms:.4f} "
          f"ms (device {lib_dev:.4f}), backward alone {lib_b_ms:.4f} ms "
          f"(device {lib_b_dev:.4f}), forward plus backward "
          f"{lib_fb_ms:.4f} ms (device {lib_fb_dev:.4f})")
    torch.cuda.empty_cache()


def _sparse_layer(dev):
    """BertSparseSelfAttention at BERT-large's width (d 1024, 16 heads,
    the Fixed layout's defaults), bf16 weights from the seed, and its
    inputs: hidden states [2, 4096, 1024] and an output cotangent."""
    import torch
    from deepspeed_tpu_torch.ops.sparse_attention import (
        BertSelfAttentionConfig, BertSparseSelfAttention, FixedSparsityConfig)
    B, H, T, D = SPARSE_SHAPE
    layer = BertSparseSelfAttention(BertSelfAttentionConfig(H * D, H),
                                    FixedSparsityConfig(num_heads=H))
    params = {n: {k: t.bfloat16().requires_grad_(True) for k, t in p.items()}
              for n, p in layer.init(SEED, device=dev).items()}
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 8)
    x = torch.randn((B, T, H * D), generator=g, device=dev).bfloat16()
    cot = torch.randn((B, T, H * D), generator=g, device=dev).bfloat16()
    return layer, params, x.requires_grad_(True), cot


def phase_sparse(dev):
    """The block-sparse attention path: BertSparseSelfAttention forward and
    backward through autograd at BERT-large's width, B 2 x T 4096, bf16;
    then the gather path on the same inputs (an all-zero additive key
    padding mask) against the kernel path."""
    import torch
    layer, params, x, cot = _sparse_layer(dev)
    B, H, T, D = SPARSE_SHAPE

    def iteration():
        out = layer(params, x)
        out.backward(cot)
        return out

    for _ in range(SPARSE_WARM):
        iteration()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _zero_counts()
    t0 = time.perf_counter()
    # any host sync inside an iteration (a read-back, a LUT upload) raises
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(SPARSE_ITERS):
            out = iteration()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _counts()
    peak = torch.cuda.max_memory_allocated(dev)
    for name in ("block_sparse_fwd", "block_sparse_bwd_dq",
                 "block_sparse_bwd_dkv"):
        if launches[name] != SPARSE_ITERS:
            fail(f"{name} launched {launches[name]} times in {SPARSE_ITERS} "
                 "iterations, expected one per iteration")
    if not torch.isfinite(out).all() or not all(
            torch.isfinite(p.grad).all() for sub in params.values()
            for p in sub.values()):
        fail("sparse: non-finite output or gradients")
    ms = wall / SPARSE_ITERS * 1e3
    print(f"[sparse] BertSparseSelfAttention d {H * D}, {H} heads, Fixed "
          f"layout block 16, B {B} x T {T}, bf16, forward + backward: "
          f"{ms:.3f} ms per iteration = {B * T / (wall / SPARSE_ITERS):.0f} "
          f"tokens/s over {SPARSE_ITERS} iterations; peak memory "
          f"{peak / 2**20:.1f} MiB; launches per iteration: 1 of each "
          "block-sparse kernel; no host sync (torch.cuda sync debug mode "
          "'error')")
    with torch.no_grad():
        _zero_counts()
        kern = layer(params, x)
        kp = torch.zeros((B, T), device=dev)
        gathered = layer(params, x, kp)
        torch.cuda.synchronize()
        counts = _counts()
    if counts["block_sparse_fwd"] != 1 or any(
            counts[n] for n in ("block_sparse_bwd_dq", "block_sparse_bwd_dkv")):
        fail(f"sparse: the kernel and gather calls launched {counts}, "
             "expected one block_sparse_fwd (the kernel path) and nothing "
             "from the gather path")
    err = (gathered.float() - kern.float()).abs().max().item()
    top = kern.float().abs().max().item()
    print(f"[sparse] gather path (all-zero additive key padding mask, no "
          f"sparse kernel launched) vs kernel path: max abs diff {err:.3g} "
          f"= {err / top:.3g} of the largest output magnitude {top:.3g}")
    # both paths round bf16: held to 2e-2 of what they compare
    if not err <= TOL["bfloat16"] * top:
        fail(f"sparse: the gather path differs from the kernel path by {err}"
             f", above {TOL['bfloat16']} x {top}")
    _sparse_composition(dev)
    return launches


def _sparse_composition(dev):
    """The standalone ops composed as the reference's attention composes
    them — ``MatMul(sdd, trans_b)`` → ``Softmax(scale)`` → ``MatMul(dsd)``
    — in bf16 at ``SPARSE_SHAPE`` on the Fixed layout's first head (the
    layout is the same for every head), against the block-sparse forward
    kernel (row 8) on the same inputs, within its bf16 tolerance of the
    largest output magnitude; both times printed.  These launches
    compare and time: they are not counted."""
    import torch
    from deepspeed_tpu_torch.ops.kernels import block_sparse_attention as bs
    from deepspeed_tpu_torch.ops.sparse_attention import (
        FixedSparsityConfig, MatMul, Softmax)
    B, H, T, D = SPARSE_SHAPE
    block = 16
    layout = FixedSparsityConfig(num_heads=H).make_layout(T)
    if not (layout == layout[:1]).all():
        fail("sparse composition: the Fixed layout differs across heads")
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 9)
    q, k, v = (torch.randn(SPARSE_SHAPE, generator=g, device=dev).bfloat16()
               for _ in range(3))
    scale = D ** -0.5
    sdd = MatMul(layout[0], block, "sdd", trans_b=True)
    dsd = MatMul(layout[0], block, "dsd")
    softmax = Softmax(layout[0], block)
    (cols, nvalid, _, _), groups = _sparse_tables(bs, layout, block, dev)

    def composed():
        return dsd(softmax(sdd(q, k), scale=scale), v)

    def kernel():
        return bs.block_sparse_fwd_cuda(q, k, v, cols, nvalid, scale, block,
                                        groups)[0]

    with torch.no_grad():
        got, want = composed(), kernel()
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        top = want.float().abs().max().item()
        # CUDA events around back-to-back calls: both keep the card busy
        # (the kernel's 0.3 ms against its wrapper's tens of µs), and the
        # profiler, read by every phase before this one, is left alone
        ms_k, ms_c = time_ms(kernel, 10), time_ms(composed, 10)
    print(f"[sparse] sdd -> softmax -> dsd from the standalone ops (Fixed "
          f"layout's first head, block {block}, {sdd.index.nnz} active "
          f"blocks of {sdd.index.nb_r ** 2}), bf16 {list(SPARSE_SHAPE)}: "
          f"against the block-sparse forward kernel max abs diff {err:.3g} "
          f"= {err / top:.3g} of the largest output magnitude {top:.3g} "
          f"(bar {TOL['bfloat16']}); ms a call (CUDA events, 10 calls "
          f"back to back): composition {ms_c:.4f}, kernel {ms_k:.4f} "
          f"({ms_c / ms_k:.1f}x) [{smi()}]")
    if not (torch.isfinite(got).all() and err <= TOL["bfloat16"] * top):
        fail(f"sparse: the composition differs from the kernel by {err}, "
             f"above {TOL['bfloat16']} x {top}")


def mlm_batch(rows, seq, vocab, seed):
    """An MLM + NSP batch by BERT's masking recipe (15 % of the live
    positions selected; 80 % [MASK], 10 % a random token, 10 % kept), a
    quarter of the rows right-padded so the key mask is real."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(2, vocab, (rows, seq))
    mask = np.ones((rows, seq), np.int64)
    for r in range(0, rows, 4):
        mask[r, int(rng.integers(seq // 4, 3 * seq // 4)):] = 0
    selected = (rng.random((rows, seq)) < 0.15) & (mask > 0)
    roll = rng.random((rows, seq))
    corrupted = np.where(selected & (roll < 0.8), MASK_TOKEN, ids)
    corrupted = np.where(selected & (roll >= 0.8) & (roll < 0.9),
                         rng.integers(2, vocab, (rows, seq)), corrupted)
    return {"input_ids": np.where(mask > 0, corrupted, 0),
            "attention_mask": mask,
            "token_type_ids": (np.arange(seq)[None] >= seq // 2).astype(
                np.int64).repeat(rows, 0) * mask,
            "masked_lm_labels": np.where(selected, ids, -100),
            "next_sentence_label": rng.integers(0, 2, rows)}


def lamb_config(dtype_block: dict, micro: int) -> dict:
    return {"train_micro_batch_size_per_gpu": micro,
            "gradient_accumulation_steps": 1,
            "steps_per_print": 10 ** 9,
            "optimizer": {"type": "Lamb", "params": {"lr": 1e-3}},
            **dtype_block}


def phase_bert_train(dev):
    """initialize() + train_batch on BERT-large (24 layers, d 1024, 16
    heads, vocab 30522), bf16, dropout 0.1, remat block, LAMB."""
    import dataclasses
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.bert import BERT_LARGE, BertModel

    cfg = dataclasses.replace(BERT_LARGE, remat="block")
    eng, _, _, _ = deepspeed_tpu_torch.initialize(
        model=BertModel(cfg), seed=SEED,
        config=lamb_config({"bf16": {"enabled": True}}, BERT_MICRO))
    if eng.device != dev:
        fail(f"initialize() placed the engine on {eng.device}, not {dev}")
    batch = {k: torch.from_numpy(v).to(dev) for k, v in mlm_batch(
        BERT_MICRO, BERT_SEQ, cfg.vocab_size, SEED).items()}
    losses = [eng.train_batch(batch) for _ in range(BERT_WARM)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _zero_counts()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(BERT_STEPS):
            losses.append(eng.train_batch(batch))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _counts()
    losses = [float(x) for x in losses]
    m = eng.last_metrics
    eng.close()
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"bert_train losses not finite and falling: {losses}")
    L = cfg.num_hidden_layers
    want = {"flash_fwd": 2 * L, "flash_bwd_dq": L, "flash_bwd_dkv": L}
    for name, per_step in want.items():
        if launches[name] != per_step * BERT_STEPS:
            fail(f"bert_train: {name} launched {launches[name]} times in "
                 f"{BERT_STEPS} steps, expected {per_step} per step")
    tokens = BERT_MICRO * BERT_SEQ
    print(f"[bert_train] BERT-large bf16, micro-batch {BERT_MICRO} x "
          f"{BERT_SEQ} tokens (a quarter of the rows padded), dropout 0.1, "
          f"remat block, LAMB lr 1e-3: {wall / BERT_STEPS * 1e3:.1f} ms per "
          f"step = {tokens / (wall / BERT_STEPS):.0f} tokens/s over "
          f"{BERT_STEPS} steps; peak memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**20:.1f} MiB")
    print(f"[bert_train] losses {' '.join(f'{x:.4f}' for x in losses)}; "
          f"grad norm {m.grad_norm:.4f}, lr {m.lr:.3g}")
    print(f"[bert_train] {BERT_STEPS} steps queued with no host sync "
          "(torch.cuda sync debug mode 'error')")
    print(f"[bert_train] launches per step: flash_fwd "
          f"{launches['flash_fwd'] // BERT_STEPS} (= 2 x {L}), flash_bwd_dq "
          f"{launches['flash_bwd_dq'] // BERT_STEPS}, flash_bwd_dkv "
          f"{launches['flash_bwd_dkv'] // BERT_STEPS} (= {L})")
    _bert_pld(dev, cfg, batch)
    return launches


def _bert_pld(dev, cfg, batch):
    """The bert_train model with progressive layer drop on a fast schedule
    (theta 0.5, gamma 1: keep probability 0.684 then 0.568 after the first
    step): one warm-up step at theta 1, then BERT_PLD_STEPS steps with no
    host sync; a dropped layer launches no flash kernel, forward,
    recompute or backward."""
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.bert import BertModel

    eng, _, _, _ = deepspeed_tpu_torch.initialize(
        model=BertModel(cfg), seed=SEED,
        config={**lamb_config({"bf16": {"enabled": True}}, BERT_MICRO),
                "progressive_layer_drop": {"enabled": True, "theta": 0.5,
                                           "gamma": 1.0}})
    losses = [eng.train_batch(batch)]
    torch.cuda.synchronize()
    _zero_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(BERT_PLD_STEPS):
            losses.append(eng.train_batch(batch))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    launches = _train_counts()
    eng.close()
    losses = [float(x) for x in losses]
    kept = launches["flash_bwd_dq"]
    full = cfg.num_hidden_layers * BERT_PLD_STEPS
    print(f"[bert_train] progressive layer drop (theta 0.5, gamma 1), "
          f"{BERT_PLD_STEPS} steps with no host sync: {kept} of {full} "
          f"layer passes kept; launches {launches}; losses "
          f"{' '.join(f'{x:.4f}' for x in losses)}")
    if not all(np.isfinite(losses)):
        fail(f"bert_train with PLD: non-finite losses {losses}")
    if not (0 < kept < full and launches["flash_fwd"] == 2 * kept
            and launches["flash_bwd_dkv"] == kept):
        fail(f"bert_train with PLD: launches {launches} over {full} layer "
             "passes, expected 2 x kept / kept / kept with some layers "
             "dropped")


def phase_bert_parity(dev):
    """fp32 (TF32 off), width 1024 at 4 layers, dropout 0: the flash
    kernel path against the dense path on the same params and padded
    batch."""
    import dataclasses
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.bert import BERT_LARGE, BertModel
    from deepspeed_tpu_torch.runtime.utils import tree_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    base = dataclasses.replace(BERT_LARGE, num_hidden_layers=PARITY_LAYERS,
                               hidden_dropout_prob=0.0,
                               attention_probs_dropout_prob=0.0, remat=None)
    models = {impl: BertModel(dataclasses.replace(base, attn_impl=impl))
              for impl in ("flash", "dense")}
    params = models["flash"].init(SEED, device=dev)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in mlm_batch(
        2, BERT_SEQ, base.vocab_size, SEED + 1).items()}
    batch["attention_mask"][1, BERT_SEQ // 3:] = 0    # a padded row for sure
    grads = {}
    for impl, model in models.items():
        p = {k: (v if not isinstance(v, dict) else dict(v))
             for k, v in params.items()}
        for leaf in tree_leaves(p):
            leaf.requires_grad_(True)
        model.loss_fn(p, batch, None, train=True).backward()
        grads[impl] = {n: p["layers"][n].grad.clone()
                       for n in ("attn_qkvw", "attn_ow")}
        for leaf in tree_leaves(p):
            leaf.grad = None
            leaf.requires_grad_(False)
    for n in ("attn_qkvw", "attn_ow"):
        a, b = grads["flash"][n], grads["dense"][n]
        rel = ((a - b).abs().max() / b.abs().max()).item()
        print(f"[bert parity] first-step grad {n}: max rel diff {rel:.3g}")
        if not rel <= 1e-3:
            fail(f"bert parity: {n} gradients differ by {rel} (max rel)")
    losses = {}
    for impl, model in models.items():
        eng, _, _, _ = deepspeed_tpu_torch.initialize(
            model=model, params=params, seed=SEED,
            config=lamb_config({}, 2))
        _zero_counts()
        losses[impl] = [float(eng.train_batch(batch))
                        for _ in range(PARITY_STEPS)]
        n = PARITY_STEPS * PARITY_LAYERS if impl == "flash" else 0
        if _train_counts() != dict.fromkeys(_train_counts(), n):
            fail(f"bert parity: the {impl} path launched "
                 f"{_train_counts()}, expected {n} of each")
    worst = max(abs(a - b) / abs(b)
                for a, b in zip(losses["flash"], losses["dense"]))
    print(f"[bert parity] fp32 kernel vs dense, {PARITY_LAYERS} layers at "
          f"width {base.hidden_size}, 2 x {BERT_SEQ} tokens with a padded "
          f"row, LAMB, {PARITY_STEPS} steps: losses "
          f"{' '.join(f'{x:.6f}' for x in losses['flash'])} vs "
          f"{' '.join(f'{x:.6f}' for x in losses['dense'])}; max rel diff "
          f"{worst:.3g}")
    if not worst <= 1e-4:
        fail(f"bert parity: losses differ by {worst} (relative)")


def phase_train_telemetry(dev):
    """phase_train's engine and config, three runs of TEL_STEPS steps on
    the same batches from one seed: (a) telemetry off; (b) telemetry,
    tensorboard and the heartbeat on, an async save after step 2; (c) (b)
    plus wall_clock_breakdown and a profiler window over steps 2-3.  The
    losses of (b) and (c) must equal (a)'s bitwise; (b)'s train_batch
    calls must make as many synchronizing calls as (a)'s (sync debug mode
    'warn'); summarize must report the steps and samples trained and one
    checkpoint save; trace.json must hold checkpoint/* and train/* spans,
    the profiler's Chrome trace the three flash kernels, and an on-demand
    flight record must parse."""
    import dataclasses
    import shutil
    import tempfile
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.gpt2 import GPT2_SMALL, GPT2Model
    from deepspeed_tpu_torch.telemetry.cli import summarize

    cfg = dataclasses.replace(GPT2_SMALL, dropout=0.1, embd_dropout=0.1,
                              remat="block")
    T, rows = cfg.n_positions, TRAIN_MICRO * TRAIN_GA
    rng = np.random.default_rng(SEED + 7)
    batches = [torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                             (rows, T + 1))).to(dev)
               for _ in range(TEL_STEPS)]
    root = tempfile.mkdtemp(prefix="chip_smoke_train_tel_")
    runs = {}
    try:
        _zero_counts()
        for run in ("a", "b", "c"):
            out = os.path.join(root, run)
            extra = {}
            if run != "a":
                extra = {"telemetry": {"enabled": True, "output_path": out,
                                       "heartbeat": True},
                         "tensorboard": {"enabled": True,
                                         "output_path": out,
                                         "job_name": "tb"}}
            if run == "c":
                extra["wall_clock_breakdown"] = True
                extra["profiler"] = {"enabled": True, "start_step": 2,
                                     "num_steps": 2,
                                     "output_path": os.path.join(out,
                                                                 "prof")}
            eng = deepspeed_tpu_torch.initialize(
                model=GPT2Model(cfg), seed=SEED,
                config={**_train_config({"bf16": {"enabled": True}},
                                        TRAIN_MICRO, TRAIN_GA), **extra})[0]
            losses, syncs, walls, timer_ms = [], 0, [], {}
            for step, b in enumerate(batches):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                loss, n = _sync_count(lambda b=b: eng.train_batch(b))
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                syncs += n
                losses.append(loss)
                if eng.timers is not None:
                    for name, tm in eng.timers.timers.items():
                        timer_ms.setdefault(name, []).append(
                            tm.elapsed(reset=True) * 1e3)
                if step == 1 and run != "a":
                    eng.save_checkpoint(os.path.join(out, "ckpt"),
                                        async_write=True)
            flight = (eng.dump_flight_record(reason="smoke")
                      if run != "a" else None)
            eng.close()
            runs[run] = {"losses": [float(x) for x in losses],
                         "syncs": syncs, "walls": walls,
                         "timers": timer_ms, "flight": flight,
                         "out": out, "engine": eng}
        torch.cuda.synchronize()
        launches = _train_counts()
        a, b, c = runs["a"], runs["b"], runs["c"]
        for run in ("b", "c"):
            if runs[run]["losses"] != a["losses"]:
                fail(f"train_telemetry: run ({run})'s losses "
                     f"{runs[run]['losses']} differ from the telemetry-off "
                     f"run's {a['losses']}")
        if b["syncs"] != a["syncs"]:
            fail(f"train_telemetry: {b['syncs']} synchronizing calls with "
                 f"telemetry, {a['syncs']} without")
        checks = []
        for run in ("b", "c"):
            r = runs[run]
            rep = summarize(os.path.join(r["out"], "events.jsonl"),
                            out=io.StringIO())
            with open(os.path.join(r["out"], "events.jsonl")) as f:
                recs = [json.loads(line) for line in f]
            samples = sum(x.get("samples", 0) for x in recs
                          if x["kind"] == "step")
            snap = [x for x in recs if x["kind"] == "metrics"][-1]
            counters = {m["name"]: m.get("value") for m in snap["metrics"]}
            eng = r["engine"]
            if rep["steps"] != TEL_STEPS or eng.global_steps != TEL_STEPS \
                    or samples != TEL_STEPS * rows \
                    or counters.get("train_steps_total") != TEL_STEPS \
                    or counters.get("ckpt_saves_total") != 1 \
                    or rep["bad_lines"] != 0 \
                    or eng.get_skipped_steps() != 0:
                fail(f"train_telemetry ({run}): summarize {rep['steps']} "
                     f"steps, {samples} samples, counters {counters}, "
                     f"skipped {eng.get_skipped_steps()}")
            with open(os.path.join(r["out"], "trace.json")) as f:
                names = {e["name"] for e in json.load(f)["traceEvents"]}
            want = {"train/dispatch", "train/shard_batch",
                    "checkpoint/save", "checkpoint/snapshot",
                    "checkpoint/async_write", "checkpoint/save_model_plane",
                    "checkpoint/save_optim_plane"}
            if not want <= names:
                fail(f"train_telemetry ({run}): trace.json lacks "
                     f"{sorted(want - names)}")
            with open(r["flight"]) as f:
                rec = json.load(f)
            if rec["reason"] != "smoke" or "ckpt_writer" not in \
                    rec["stages"]:
                fail(f"train_telemetry ({run}): flight record {rec}")
            checks.append(f"({run}) {rep['steps']} steps, {samples} "
                          f"samples = {samples * T} tokens, "
                          f"ckpt_saves_total 1, "
                          f"{len(names)} span names")
        prof = os.path.join(c["out"], "prof")
        traces = sorted(os.listdir(prof))
        if len(traces) != 1:
            fail(f"train_telemetry: profiler wrote {traces}")
        with open(os.path.join(prof, traces[0])) as f:
            kern = {e["name"] for e in json.load(f)["traceEvents"]
                    if e.get("cat") == "kernel"}
        for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
            if not any(k in n for n in kern):
                fail(f"train_telemetry: the profiler's trace names no "
                     f"{k} kernel ({len(kern)} kernel names)")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    ms = lambda ws: " ".join(f"{w * 1e3:.1f}" for w in ws)  # noqa: E731
    print(f"[train_telemetry] GPT-2 small bf16 (phase_train's config), "
          f"{TEL_STEPS} steps x 3 runs: losses of (b) telemetry + "
          f"tensorboard + heartbeat + async save and (c) + "
          f"wall_clock_breakdown + profiler window equal (a) telemetry "
          f"off bitwise ({' '.join(f'{x:.6f}' for x in a['losses'])})")
    print(f"[train_telemetry] synchronizing calls in train_batch (sync "
          f"debug mode 'warn'): (a) {a['syncs']}, (b) {b['syncs']}, (c) "
          f"{c['syncs']} (the timers and the profiler window sync by "
          f"design)")
    print(f"[train_telemetry] step wall ms (synchronized around each "
          f"call; a reading, not a claim): (a) {ms(a['walls'])}; (b) "
          f"{ms(b['walls'])}; (c) {ms(c['walls'])}; {smi()}")
    print("[train_telemetry] timers (c) ms per step: " + "; ".join(
        f"{n} {' '.join(f'{v:.1f}' for v in vs)}"
        for n, vs in sorted(c["timers"].items())))
    print(f"[train_telemetry] {'; '.join(checks)}; the profiler's Chrome "
          f"trace ({traces[0]}) names the flash_fwd, flash_bwd_dq and "
          f"flash_bwd_dkv kernels; flight records parse")
    return launches


def _fleet_config(serving, replicas, dtype, **fleet_over):
    """A fleet of GPT-2 small replicas with flash prefill, random weights
    from SEED, on ``serving``; the liveness timeouts sized for a replica
    that imports torch, initializes CUDA and the model and serves its warm
    request before hello."""
    from deepspeed_tpu_torch.models.gpt2 import GPT2_SMALL
    m = GPT2_SMALL
    return {"serving": dict(serving),
            "fleet": {"replicas": replicas, "min_replicas": replicas,
                      "max_replicas": replicas + 1, "slo_p99_s": 1e9,
                      "spawn_timeout_s": FLEET_SPAWN_TIMEOUT_S,
                      "heartbeat_timeout_s": FLEET_HEARTBEAT_TIMEOUT_S,
                      "backoff_base_s": 0.2, **fleet_over},
            "fleet_model": {"vocab_size": m.vocab_size,
                            "n_positions": m.n_positions,
                            "d_model": m.d_model, "n_layer": m.n_layer,
                            "n_head": m.n_head, "attn_impl": "flash",
                            "seed": SEED, "dtype": dtype}}


def _replica_launches(fleet_dir):
    """The sum of every replica's launches.json in ``fleet_dir`` (a
    replica killed by SIGKILL writes none)."""
    total = {}
    for name in sorted(os.listdir(fleet_dir)):
        path = os.path.join(fleet_dir, name, "launches.json")
        if name.startswith("replica_") and os.path.isfile(path):
            with open(path) as f:
                for k, v in json.load(f).items():
                    total[k] = total.get(k, 0) + v
    return total


def _add(total, more):
    for k, v in more.items():
        total[k] = total.get(k, 0) + v
    return total


def _ledger(fleet_dir):
    with open(os.path.join(fleet_dir, "events.jsonl")) as f:
        return [json.loads(line) for line in f]


def _bare_fleet_engine(cfg, dev):
    """The engine a replica of ``cfg`` builds, in this process."""
    import tempfile
    from deepspeed_tpu_torch.inference.replica import build_engine
    return build_engine(cfg, tempfile.gettempdir(), 99, device=dev)


def _fleet_run(cfg, fleet_dir, prompts, new, kill=None):
    """A router on ``cfg`` serving ``prompts``; ``kill`` names the role
    ('mixed' or 'decode') of a replica to SIGKILL once it streams.
    Returns the requests, the wall from submit to idle, and the victim."""
    from deepspeed_tpu_torch.inference.fleet import FleetRouter
    router = FleetRouter(cfg, fleet_dir=fleet_dir).start()
    victim = None
    try:
        t0 = time.perf_counter()
        reqs = [router.submit(p, max_new_tokens=new) for p in prompts]
        if kill is not None:
            deadline = time.monotonic() + 120
            while victim is None and time.monotonic() < deadline:
                router.poll(0.01)
                cands = [r for r in router.replicas.values()
                         if r.role == kill and r.state == "ready"
                         and any(q.started and q.replica == r.id
                                 for q in reqs)]
                if cands:
                    victim = max(cands, key=lambda r: len(r.outstanding)).id
            if victim is None:
                fail(f"fleet: no {kill} replica streamed within 120 s")
            router.kill_replica(victim)
        router.run_until_idle(max_s=600)
        wall = time.perf_counter() - t0
        if kill is not None:
            # the role floor respawns the victim's replacement
            deadline = time.monotonic() + FLEET_SPAWN_TIMEOUT_S
            while time.monotonic() < deadline and not any(
                    r.id > victim and r.role == kill and r.state == "ready"
                    for r in router.replicas.values()):
                router.poll(0.05)
            if not any(r.id > victim and r.role == kill
                       and r.state == "ready"
                       for r in router.replicas.values()):
                fail(f"fleet: replica {victim} ({kill}) was not respawned")
        migrations = router.migrations
    finally:
        router.close()
    return reqs, wall, victim, migrations


def _fleet_stats(reqs, fleet_dir):
    """(tokens/s is computed by the caller) TTFT p50/p99 and per-request
    TPOT p50/p99 (decode time over tokens after the first) from the
    router's events.jsonl records."""
    recs = {r["rid"]: r for r in _ledger(fleet_dir)
            if r["kind"] == "fleet_request"}
    ttft = [recs[q.rid]["ttft_s"] for q in reqs]
    tpot = [(recs[q.rid]["total_s"] - recs[q.rid]["ttft_s"])
            / max(len(q.tokens) - 1, 1) for q in reqs]
    return ttft, tpot


def _check_kill(label, reqs, fleet_dir, new):
    from deepspeed_tpu_torch.inference.fleet import ReplicaFailure
    failed = [r for r in reqs if r.error is not None]
    if not all(r.started and isinstance(r.error, ReplicaFailure)
               for r in failed):
        fail(f"{label}: a failed request was unstarted or untyped: "
             f"{[(r.rid, r.started, repr(r.error)) for r in failed]}")
    ok = [r for r in reqs if r.error is None]
    if not ok or not all(len(r.tokens) == new for r in ok):
        fail(f"{label}: survivors incomplete")
    recs = _ledger(fleet_dir)
    submits = {r["rid"] for r in recs if r["kind"] == "fleet_submit"}
    dones = {r["rid"] for r in recs if r["kind"] == "fleet_request"}
    if submits != dones:
        fail(f"{label}: requests lost from the ledger: "
             f"{sorted(submits - dones)}")
    return len(ok), len(failed), sum(r.failovers for r in reqs)


def phase_fleet(dev):
    """The serving fleet of GPT-2 small replicas (flash prefill, the
    slot cache of phase_serve).  fp32: a 1-replica fleet's streams equal
    a bare engine's of the same seed (near-tie rule).  bf16: 2 replicas,
    the serve phase's 12 requests twice: the JSQ split, tokens/s and
    TTFT/TPOT beside the bare engine's.  kill: a replica killed once it
    streams: unstarted requests fail over, started ones fail typed, none
    is lost, the replica respawns.  Launches: the replicas' launches.json
    (their warm requests included)."""
    import shutil
    import tempfile
    import torch
    from deepspeed_tpu_torch.models.gpt2 import GPT2_SMALL

    prompts = _load()
    root = tempfile.mkdtemp(prefix="chip_smoke_fleet_")
    launches = {}
    try:
        # fp32 parity: one replica against a bare engine of the seed
        cfg = _fleet_config(SLOT_CFG, 1, "float32", max_replicas=1)
        eng = _bare_fleet_engine(cfg, dev)
        bare = [eng.submit(p, max_new_tokens=NEW_TOKENS) for p in prompts]
        eng.run_until_idle()
        eng.close()
        _check_requests("fleet bare fp32", bare)
        d = os.path.join(root, "fp32")
        reqs, _, _, _ = _fleet_run(cfg, d, prompts, NEW_TOKENS)
        _check_requests("fleet fp32", reqs)
        _add(launches, _replica_launches(d))
        params = eng.params
        dense_cfg = GPT2_SMALL
        _compare_streams("1-replica fleet vs bare engine (fp32)", reqs,
                         bare, prompts, dense_cfg, params)
        del eng, params
        torch.cuda.empty_cache()
        # bf16: 2 replicas against the bare engine
        load = prompts + prompts
        cfg = _fleet_config(SLOT_CFG, 2, "bfloat16")
        eng = _bare_fleet_engine(cfg, dev)
        warm = eng.submit(list(range(16)), max_new_tokens=2)
        eng.run_until_idle()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bare = [eng.submit(p, max_new_tokens=NEW_TOKENS) for p in load]
        eng.run_until_idle()
        torch.cuda.synchronize()
        bare_wall = time.perf_counter() - t0
        eng.close()
        del eng, warm
        torch.cuda.empty_cache()
        _check_requests("fleet bare bf16", bare)
        d = os.path.join(root, "bf16")
        reqs, wall, _, _ = _fleet_run(cfg, d, load, NEW_TOKENS)
        _check_requests("fleet bf16", reqs)
        _add(launches, _replica_launches(d))
        split = {}
        for r in reqs:
            split[r.replica] = split.get(r.replica, 0) + 1
        ttft, tpot = _fleet_stats(reqs, d)
        b_ttft = [r.token_times[0] for r in bare]
        b_tpot = [sum(r.token_times[1:]) / (len(r.tokens) - 1)
                  for r in bare]
        tok = NEW_TOKENS * len(load)
        # kill: 2 bf16 replicas, one killed once it streams
        d = os.path.join(root, "kill")
        kreqs, _, victim, _ = _fleet_run(cfg, d, load, NEW_TOKENS,
                                         kill="mixed")
        ok, failed, failovers = _check_kill("fleet kill", kreqs, d,
                                            NEW_TOKENS)
        _add(launches, _replica_launches(d))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    f = lambda xs: (f"p50 {_pct(xs, 0.5) * 1e3:.1f} ms p99 "  # noqa: E731
                    f"{_pct(xs, 0.99) * 1e3:.1f} ms")
    print(f"[fleet] fp32 1-replica fleet of GPT-2 small (flash prefill, "
          f"slot cache, {N_REQ} requests x {NEW_TOKENS} tokens): streams "
          f"against a bare engine of seed {SEED} under the near-tie rule")
    print(f"[fleet] bf16 2 replicas, {len(load)} requests: JSQ split "
          f"{dict(sorted(split.items()))}; {tok / wall:.1f} tokens/s "
          f"(submit to idle, {wall:.2f} s) vs the bare engine's "
          f"{tok / bare_wall:.1f} tokens/s ({bare_wall:.2f} s); TTFT "
          f"{f(ttft)} vs {f(b_ttft)}; TPOT (per-request mean) {f(tpot)} "
          f"vs {f(b_tpot)}; {smi()}")
    print(f"[fleet] kill: replica {victim} killed once it streamed: "
          f"{ok} requests completed ({failovers} failovers), {failed} "
          f"started ones failed typed ReplicaFailure, none lost; the "
          f"replica respawned")
    print(f"[fleet] replica launches (launches.json, warm requests "
          f"included): " + ", ".join(f"{k} {v}" for k, v in
                                     sorted(launches.items()) if v))
    if not launches.get("flash_fwd") or not launches.get("decode_attention"):
        fail(f"fleet: replicas launched {launches}")
    return launches


def _migration_rate(dev, cfg, prompt):
    """One engine of ``cfg`` in this process: a detach_kv prefill of
    ``prompt``, its pages exported (device to host) and adopted back
    (host to device), each timed: (bytes of one page, pages, export MB/s,
    import MB/s)."""
    import torch
    eng = _bare_fleet_engine(cfg, dev)
    times = []
    for _ in range(3):
        req = eng.submit(prompt, max_new_tokens=1, detach_kv=True)
        eng.run_until_idle()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        payloads = eng.export_pages(req)
        t1 = time.perf_counter()
        eng.release_detached(req)
        adopted = eng.adopt_request(prompt, req.tokens[0], 1, None,
                                    payloads)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        eng.run_until_idle()
        times.append((t1 - t0, t2 - t1))
        if adopted is None:
            fail("fleet_disagg: adoption found no room")
    eng.close()
    nbytes = sum(len(p) for p in payloads)
    exp = min(t for t, _ in times)
    imp = min(t for _, t in times)
    return len(payloads[0]), len(payloads), nbytes / exp / 1e6, \
        nbytes / imp / 1e6


def phase_fleet_disagg(dev):
    """The disaggregated fleet: a prefill replica and a decode replica of
    GPT-2 small on the serve_paged phase's pool (page_len 16, chunks of
    128).  fp32: the serve phase's 12 requests stream a bare paged
    engine's tokens (near-tie rule), every one migrates, and the custody
    ledger has one router and one decode record a request.  decode kill:
    the decode replica killed mid-stream loses no request and respawns.
    Then one page's bytes and the engine-level migration rate (export,
    adopt) of a 512-token prompt."""
    import shutil
    import tempfile
    import torch
    from deepspeed_tpu_torch.models.gpt2 import GPT2_SMALL

    prompts = _load()
    root = tempfile.mkdtemp(prefix="chip_smoke_disagg_")
    launches = {}
    roles = {"roles": {"prefill": 1, "decode": 1}, "max_replicas": 3}
    try:
        cfg = _fleet_config(PAGED_CFG, 2, "float32", **roles)
        eng = _bare_fleet_engine(cfg, dev)
        bare = [eng.submit(p, max_new_tokens=NEW_TOKENS) for p in prompts]
        eng.run_until_idle()
        params = eng.params
        eng.close()
        _check_requests("fleet_disagg bare fp32", bare)
        d = os.path.join(root, "fp32")
        reqs, wall, _, migrations = _fleet_run(cfg, d, prompts,
                                               NEW_TOKENS)
        _check_requests("fleet_disagg fp32", reqs)
        _add(launches, _replica_launches(d))
        _compare_streams("disaggregated fleet vs bare paged engine (fp32)",
                         reqs, bare, prompts, GPT2_SMALL, params)
        del eng, params
        torch.cuda.empty_cache()
        recs = _ledger(d)
        mig = [r for r in recs if r["kind"] == "migration"]
        rids = sorted(r.rid for r in reqs)
        for custody in ("router", "decode"):
            got = sorted(m["rid"] for m in mig if m["custody"] == custody)
            if got != rids:
                fail(f"fleet_disagg: {custody} custody records {got}, "
                     f"requests {rids}")
        if migrations != len(prompts) or not all(r.migrated for r in reqs):
            fail(f"fleet_disagg: {migrations} migrations for "
                 f"{len(prompts)} requests")
        mbytes = sum(m["bytes"] for m in mig if m["custody"] == "router")
        mpages = sum(m["pages"] for m in mig if m["custody"] == "router")
        # decode kill
        d = os.path.join(root, "kill")
        kreqs, _, victim, _ = _fleet_run(cfg, d, prompts, NEW_TOKENS,
                                         kill="decode")
        ok, failed, failovers = _check_kill("fleet_disagg kill", kreqs, d,
                                            NEW_TOKENS)
        _add(launches, _replica_launches(d))
        # one page's bytes and the migration rate at the engine, fp32 and
        # bf16, on a 512-token prompt
        long_prompt = [int(t) for t in np.random.default_rng(SEED).integers(
            0, GPT2_SMALL.vocab_size, PROMPT_MAX)]
        rates = {dt: _migration_rate(dev, _fleet_config(
            PAGED_CFG, 2, dt, **roles), long_prompt)
            for dt in ("float32", "bfloat16")}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"[fleet_disagg] fp32 prefill 1 + decode 1 (page_len "
          f"{PAGED_CFG['page_len']}, chunks of "
          f"{PAGED_CFG['prefill_chunk_len']}), {N_REQ} requests x "
          f"{NEW_TOKENS} tokens in "
          f"{wall:.2f} s: {migrations} migrations ({mpages} pages, "
          f"{mbytes} B over the wire), custody ledger balanced (one "
          f"router and one decode record a request)")
    print(f"[fleet_disagg] decode kill: replica {victim} killed mid-stream:"
          f" {ok} requests completed ({failovers} failovers), {failed} "
          f"started ones failed typed ReplicaFailure, none lost; a decode "
          f"replica respawned")
    for dt, (page, n, exp, imp) in rates.items():
        print(f"[fleet_disagg] {dt} migration of a {PROMPT_MAX}-token "
              f"prompt at the engine: {n} pages of {page} B; export "
              f"(device to host) {exp:.1f} MB/s, adopt (host to device) "
              f"{imp:.1f} MB/s; {smi()}")
    print(f"[fleet_disagg] replica launches (launches.json, warm requests "
          f"included): " + ", ".join(f"{k} {v}" for k, v in
                                     sorted(launches.items()) if v))
    if not launches.get("flash_fwd") or not launches.get("decode_paged"):
        fail(f"fleet_disagg: replicas launched {launches}")
    return launches


def timed(phase, *args, **kwargs):
    """Run one phase and print its wall time."""
    t0 = time.perf_counter()
    out = phase(*args, **kwargs)
    print(f"[wall] {phase.__name__[len('phase_'):]}: "
          f"{time.perf_counter() - t0:.1f} s")
    return out


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
    timed(phase_build)
    kernels = timed(phase_kernels, dev)
    timed(phase_decode_kernels, dev, kernels)
    timed(phase_train_kernels, dev, kernels)
    timed(phase_sparse_kernels, dev, kernels)
    timed(phase_sampler, dev)
    by_phase = {}
    by_phase["serve"], greedy = timed(phase_serve, dev)
    by_phase["fleet"] = timed(phase_fleet, dev)
    by_phase["serve_paged"], paged_memory, paged_ref = timed(
        phase_serve_paged, dev)
    by_phase["fleet_disagg"] = timed(phase_fleet_disagg, dev)
    by_phase["serve_spec"] = timed(phase_serve_spec, dev)
    by_phase["serve_quant"], _, quant_ref = timed(phase_serve_paged, dev,
                                                  paged_memory)
    by_phase["serve_quant_capacity"] = timed(phase_serve_quant_capacity, dev)
    by_phase["serve_quant_spec"] = timed(phase_serve_spec, dev, quant=True)
    by_phase["serve_kv_tier"], kv_ref = timed(phase_serve_kv_tier, dev)
    by_phase["serve_sample"] = timed(phase_serve_sample, dev, greedy)
    by_phase["serve_lora"], lora_ref = timed(phase_serve_lora, dev,
                                             paged_ref, quant_ref)
    by_phase["serve_telemetry"] = timed(phase_serve_telemetry, dev,
                                        lora_ref, kv_ref["bf16"])
    timed(phase_parity, dev)
    by_phase["train"] = timed(phase_train, dev)
    timed(phase_train_parity, dev)
    by_phase["checkpoint"] = timed(phase_checkpoint, dev)
    by_phase["train_telemetry"] = timed(phase_train_telemetry, dev)
    by_phase["sparse"] = timed(phase_sparse, dev)
    by_phase["bert_train"] = timed(phase_bert_train, dev)
    timed(phase_bert_parity, dev)
    by_phase["train_zero"] = timed(phase_train_zero, dev)
    by_phase["train_pipe"] = timed(phase_train_pipe, dev, card)
    by_phase["train_seq"] = timed(phase_train_seq, dev, card)
    by_phase["train_moe"] = timed(phase_train_moe, dev, card)
    by_phase["train_onebit"] = timed(phase_train_onebit, dev, card)
    by_phase["serve_mesh"] = timed(phase_serve_mesh, dev)
    by_phase["train_offload"], offload_ref = timed(phase_train_offload, dev)
    by_phase["train_offload_disk"] = timed(phase_train_offload_disk, dev,
                                           offload_ref)
    by_phase["train_offload_xla"] = timed(phase_train_offload_xla, dev,
                                          offload_ref)
    for name, r in kernels.items():
        r["launches_by_phase"] = {ph: c.get(name, 0)
                                  for ph, c in by_phase.items()}
        r["launches"] = sum(r["launches_by_phase"].values())
    print(card)
    print(json.dumps({"kernels": [kernels[n] for n in KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
