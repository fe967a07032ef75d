"""Smoke run of the PyTorch/CUDA port (``hivedscheduler_tpu_torch``) on one
NVIDIA H100.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases, each of which must pass or the script exits non-zero:

(a) print the card's name and power limit; build the port's CUDA kernels
    ``hivedscheduler_tpu_torch/ops/csrc/flash_fwd.cu`` (K1) and
    ``flash_bwd.cu`` (K2, K3) with nvcc (sm_90a), both compilers at once,
    and print ptxas's register and spill lines and any warning that it
    serialized wgmma, for every instantiation (padded widths 64, 128, 256);
(b) hold the flash-forward kernel against its plain PyTorch version on the
    card: the flagship shape (B=8, T=2048, H=16, H_kv=8, D=128, bf16,
    causal), full attention, H_kv = H, T=192 (a multiple of the 64-key
    tile, not of the 128-row one) and a ragged D=64 case; show that two
    runs are bit-identical and that the check sees a planted fault (one
    swapped pair of V keys);
(c) time the kernel, its plain version and PyTorch's
    ``scaled_dot_product_attention`` (a yardstick only: the port never
    calls it) with CUDA events, beside the least time the card could take;
(d) run the port's ``eval`` entry point at the flagship width (6 layers,
    random seeded weights, the synthetic corpus, 4 windows) with
    ``--attn flash``, count the kernel's launches (6 layers x 4 windows),
    and hold its loss to the same windows run with ``--attn xla`` on the
    same weights; then time eval windows of both, as ``eval`` reports them;
(e) hold the final-norm hidden states of one flagship window, flash
    against xla on the same weights, and show that the check sees a
    planted fault (the last layer's attention output zeroed);
(f) hold the backward kernels (K2: dq, K3: dk and dv) against their plain
    PyTorch version on the card at the flagship shape causal, full, with
    H_kv = H, at T=192 (a multiple of the 64-row tiles, not of K2's
    128-row block), with a GQA group of 4 (K3's head walk crosses three
    boundaries), and ragged (T=200, D=64, MQA); show that each output's
    check sees a planted fault (K keys T-2 and T-1 swapped, which moves
    only those rows of dq, dk and dv), and that the backward is
    bit-reproducible;
(g) time K2 and K3 with CUDA events at the flagship shape, beside their
    plain version, the least time the card could take, and the backward of
    ``scaled_dot_product_attention`` (a yardstick only: the port never
    calls it);
(h) run the port's ``train`` entry point at the flagship width (6 layers,
    ``--attn flash --remat dots --ce-chunk 512``, random seeded weights, the
    synthetic corpus, 3 steps), count each kernel's launches per step (K1
    twice a layer, since "dots" recomputes the forward; K2 and K3 once),
    require finite losses, and time steps of ``--attn flash`` and
    ``--attn xla`` from ``train``'s own timeline after a warm-up step; then
    hold the gradients of one flagship step, flash against xla on the same
    weights and batch, by leaf group, and show that the check sees a planted
    fault (the last layer's dq zeroed); print the device time of one flash
    step by kernel group (torch.profiler);
(i) checkpoint and resume at the flagship width (train's flags of (h)):
    save the 6-layer train state after one step (511.7 M f32 parameters
    and their AdamW moments, ~6.1 GB), restore it into zeroed templates on
    the card and require every parameter and moment bit-identical, and show
    that the check sees one flipped bit; then, at 2 layers, run ``train`` 4 steps twice
    uninterrupted (A, A2), then 2 steps with ``--checkpoint-dir
    --checkpoint-every 2 --goodput-file`` (B) and the same command with
    ``--steps 4`` (B', which resumes), and hold B''s steps 3-4 to A's
    (bit-identical when A and A2 are, else within a relative 1e-3); resume
    again with the loader state dropped from the marker (fast-forward,
    which must pass) and with the loader restarted at position 0 (which
    must fail the same check); SIGTERM a ``python -m
    hivedscheduler_tpu_torch.train`` process on the card (8 steps) after its
    step 2 and require exit 0 within the 60 s grace period with a committed
    marker at the step it stopped on, then a resumed incarnation that
    finishes; print the save and restore seconds, GB/s and B + B''s
    goodput phase seconds, and require the goodput spool's audit to be
    clean. The temp directory's free space is printed first, and the phase
    fails if it cannot hold two checkpoints.
(j) decode and generate at the flagship width (3 layers, cut from 6 for the
    script's time limit; bf16 weights cast from seed 0; bench_model.py's
    decode shape: batch 16, prompt 128, 64 new
    tokens): hold the decode logits (``advance``: one prefill, then one
    token a step) to the full forward on the same sequence, per position,
    and show that the check sees a planted fault (K/V one position off);
    require greedy ``generate``'s tokens to be the argmax of that advance
    sequence, and the full forward's argmax wherever its top-1 margin is
    decisive, with no flash kernel launched; measure int8 logit noise
    against bf16 and hold the argmax at decisive positions; run
    speculative decoding (a 1-layer draft from ``derive_draft_config``,
    gamma 4), print its acceptance and agreement with greedy, and hold its
    tokens to the target's argmax at decisive positions; require sampling
    with top_k=1 to draw a top-1 token at every step (so it equals greedy
    up to the first tie at the top) and a seeded sampled run to repeat; time
    generate (bf16, int8, speculative) beside bench_model.py's HBM
    roofline, the prefill and the decode step, with the device-busy share
    of decode steps (torch.profiler); run ``python -m
    hivedscheduler_tpu_torch.generate`` once as a subprocess.
(k) the continuous-batching serving engine at the flagship width (6
    layers, bf16 weights from seed 0; bench_model.py's ``bench_serving``
    trace: 16 requests, prompts of 4-64 tokens, budget 32, max_batch 16,
    max_len 160, one arrival every 2 steps): dense and paged (page 16),
    eager and with decode windows of 8 replayed from a CUDA graph, must
    serve token-identical streams, with no K1-K3 launch, every window
    through the graph and a clean pool check; the streams must be the
    teacher-forced full forward's argmax at decisive positions, and the
    check must see a planted fault (row lengths one off), as the pool check
    must see a swapped table entry; int8 KV logits against bf16 KV within
    a relative 5e-2, int8 dense and paged token-identical; chunked prefill
    (chunk 32) and the prefix cache over a 24-token system prompt part from
    the plain engine only at ties; ``drain(deadline_s=0)`` on a busy paged
    engine returns every block; then the times (tokens/s, occupancy, TTFT,
    TPOT of the four runs; the eager step against a graph step and the
    device-busy share of one graph window beside the bound; the paged A/B
    at equal KV bytes of ``bench_serving_paged_ab``; float against int8 KV
    at ``bench_serving_kv_int8``'s long context) and ``python -m
    hivedscheduler_tpu_torch.serve`` as a subprocess, plain and with
    ``HIVED_FAULT_SERVE_PREEMPT_AT`` (drain, exit 0).
(l) the mesh path on one card: the gang handoff (a bind info of one pod
    with ``NVIDIA_VISIBLE_DEVICES=0``) through ``initialize_from_gang``
    must give rank 0 of world 1 on ``cuda:0`` over NCCL; K1, K2 and K3 at
    the local shapes a tp=2 shard of the flagship launches (q [8,2048,8,128],
    k/v [8,2048,4,128]) against their plain versions with the limits and
    planted faults of (b) and (f), timed beside their bound and
    ``scaled_dot_product_attention`` at the same shape, taken in turns; 3
    flagship train steps (the train flags of (h)) through
    ``make_sharded_train_step`` on a six-axis ``DeviceMesh`` of the one GPU
    (DTensor state), with K1-K3's launches counted, held to the
    single-device ``make_train_step`` from the same seed and batches and to
    (h)'s losses (equal, or within a relative 1e-3), with both steps' ms by
    CUDA events beside (h)'s, then both timed in turns (single, mesh, mesh,
    single, 3 rounds); and a world-1 DTensor train state at the
    flagship width and 2 layers (~3.1 GB) saved with the multi-rank commit
    protocol, restored bit-identically into fresh templates, one flipped
    bit caught, with the save and restore seconds (free space printed
    first).
(m) sequence-parallel attention (the ring family) on one card: K1, K2 and
    K3's f32 forms (o, dq, dk, dv stored in f32, as each ring hop needs)
    against their plain versions at the main path's shape (the flagship,
    causal: sp = 1) and at one sp = 4 rank's hop (q [1,2048,16,128], k/v
    [1,2048,8,128]), diagonal and unmasked, with (b)'s and (f)'s limits;
    rounded once to bf16 their outputs must equal the bf16 kernels' bit for
    bit; run twice, bit-identical; (b)'s and (f)'s planted faults caught;
    each timed against its bf16 form in turns, beside its bound, the plain
    version and the library's bf16 call; every rank's hop schedule of a
    4-rank ``ring_flash`` and ``ring_zigzag_flash`` over one sequence of
    8192 replayed on the card through the port's per-hop functions, the
    merged o and the gradients held to K1-K3 over the whole sequence
    (relative 5e-3 and 1e-2); ``train`` with (h)'s flags and ``--attn
    ring_flash`` (losses equal to (h)'s flash, within 1e-5 required; K1-f32
    12, K2-f32 6 and K3-f32 6 launches a step and no bf16 launch) and
    ``--attn ring_zigzag_flash`` (within 1e-3; three quarter-blocks a
    layer), ``eval --attn ring_flash`` against flash (1e-5), ``--attn
    ring`` and ``ulysses`` at 2 layers against xla (1e-3, no kernel); then
    the steps of flash, ring_flash and ring_zigzag_flash timed in turns by
    CUDA events on the world-1 mesh.
(n) the mixture-of-experts model (8 experts, top-2) at the flagship width
    through train, eval, generate and serve, and a 1-layer MoE checkpoint.
(o) LoRA fine-tuning at the flagship width: ``train`` with (h)'s flags and
    ``--lora-rank 16 --lora-alpha 32 --lora-mlp`` (3 steps, committing a
    checkpoint), with K1/K2/K3 launched 36/18/18 times; its first loss
    equal to (h)'s dense first loss bit for bit (zero-init adapters); the
    checkpoint's base bit-identical to the seed-0 init, its adapters moved;
    the LoRA step against the dense step in turns by CUDA events, tokens/s,
    the peak device memory of each run; the checkpoint restored and merged
    through ``restore_serving_params(lora_rank=16, ...)``, equal to
    ``merge_lora`` of the restored tree; with random nonzero adapters, the
    merged model's logits on one window against the adapter forward, and a
    planted fault (the adapters dropped at the merge) caught.
(p) speculative serving on (k)'s trace and target (bf16): the CLI's draft
    (``derive_draft_config(cfg, 2)``, random weights from seed 3) and the
    target as its own draft, gamma 4, dense and paged: every stream parts
    from (k)'s plain greedy streams only at a near-tie of the full
    forward (margin <= 2 x (k)'s noise), dense and paged self-draft
    streams token-identical, the acceptance and the share of differing
    tokens printed; tokens/s, TTFT and TPOT against the plain engine eager
    and with graph windows of 8, in turns; sampled with the perfect draft,
    the share of tokens equal to the plain sampled engine's and two runs
    identical; then ``python -m hivedscheduler_tpu_torch.serve --lora-rank
    16 --spec-decode`` on (o)'s checkpoint, which must exit 0 with its
    merge and acceptance lines.
(q) head dims other than 64 and 128: K1, K2, K3 and their f32 forms at D =
    32, 80, 96 and 112 (each run at its padded width, 64 or 128), causal
    and not, with a GQA group of 4 at a ragged T, against their plain
    versions with the limits of (b), (f) and (m), the f32 forms rounded
    once equal to the bf16 kernels; every output stored through a view
    into a 128-wide buffer whose other columns hold a sentinel, which must
    stay; two planted faults caught: a kernel that reads the next head's
    columns (neighbouring heads differ twofold) and one that stores past
    D; K1-K3 at Phi-3-mini's shape (B=8, T=2048, H=H_kv=32, D=96, causal)
    against their plain versions, then timed in turns against the same
    kernels at D = 128 (``ops/kernel_ab.py``), beside their bound at the
    real D, the plain version and ``scaled_dot_product_attention``; then
    Phi-3-mini's width (microsoft/Phi-3-mini-4k-instruct: vocab 32064,
    d_model 3072, 32 heads, MHA, d_ff 8192, random weights from seed 0)
    through ``eval`` at all 32 layers (K1 32 launches a window; flash
    against xla, losses 1e-3, one window's hidden states 5e-2 with (e)'s
    planted fault), ``train`` at 6 layers with (h)'s flags (K1/K2/K3
    36/18/18; losses flash against xla within 1e-3, one step's gradients
    by leaf group with (h)'s limits and planted fault; step ms, tokens/s,
    peak memory), greedy ``generate`` at (j)'s shape and (k)'s serving
    trace (dense/paged, eager/graph, int8 KV: token-identical, decisive
    positions the full forward's argmax; TPOT p50).
(r) head dims past 128: K1, K2, K3 and their f32 forms at D = 136, 192 and
    256 (each run at the padded width 256), causal and not, with MQA and a
    GQA group of 4 at a ragged T, held as in (q) with sentinel columns in a
    256-wide buffer and the same two planted faults; K1-K3 at Gemma-2B's
    training shape (B=8, T=2048, H=8, H_kv=1, D=256, causal: the flagship's
    FLOPs) against their plain versions, run twice bit-identical, then timed
    in turns against the flagship's D = 128 shape, beside their bound, the
    plain version and ``scaled_dot_product_attention`` (its backend named);
    the f32 forms at one sp = 4 hop of Gemma's heads (q [1,2048,8,256]),
    against their plain versions and bf16 forms, timed in turns; then
    Gemma-2B's width (google/gemma-2b: vocab 256000, d_model 2048, 8 heads,
    one kv head, d_ff 16384, random weights from seed 0) through ``eval``
    at all 18 layers (K1 18 launches a window; losses 1e-3, hidden states
    5e-2 with (e)'s planted fault), ``train`` at 6 layers with (h)'s flags
    (K1/K2/K3 36/18/18; losses 1e-3 of xla; gradients with (h)'s limits and
    planted fault; step ms, tokens/s, peak memory) and with ``--attn
    ring_flash`` (the f32 forms 36/18/18, losses 1e-5 of flash's), greedy
    ``generate`` at (j)'s shape and (k)'s serving trace (as in (q), with no
    flash launch).
(s) observability at the flagship width: ``train`` with (h)'s flags, 5
    steps, ``--journal-file --goodput-file --timeline --profile-dir``: the
    journal and goodput audits (``check_journal``, ``check_goodput``, the
    goodput spool's ``check_spool``) clean, the merged Chrome trace valid
    with one ``train/step`` span a step and the goodput lane, the profiler
    trace of steps 2-4 holding K1/K2/K3 36/18/18 times as CUDA kernel
    events, its size and each traced step's device time by group (K1-K3,
    cuBLAS, the element-wise work split by the ops that launched it into
    AdamW, CE, SiLU, RMSNorm, RoPE, casts and the rest) beside its host
    gaps; ``train`` 2 then 4 steps (2 layers) over one checkpoint
    directory: one ``train_resume`` at step 2 and the resume counter +1;
    the step with and without ``--journal-file --goodput-file`` in turns;
    ``serve`` on (k)'s load (16 requests, graph windows of 8, paged, every
    4th request at priority 10) with ``--metrics-dump --journal-file
    --slo-ttft-p99 0.5``: the exposition's requests and TTFT samples by
    priority equal to the finished requests, its fused windows to the
    engine's count, one ``request/decode`` span a request in the valid
    trace, every flight one terminal with legs that tile its TTFT, the SLO
    lines logged, the streams equal to a run without the flags; tokens/s
    and TPOT p50 of (k)'s paged graph engine with the journal, flights and
    tracer on and off in turns; and planted faults caught (a dropped leg, a
    duplicated terminal, a trace recorded without CUDA activity).

(t) the serving fleet at the flagship width on (k)'s engine settings
    (paged, page 16, graph windows of 8, ``max_batch`` 16, prefix cache 4),
    bf16 params from seed 0 shared by every replica: ``python -m
    hivedscheduler_tpu_torch.serve --fleet 3 --disaggregate
    --prefill-replicas 1 --route-policy prefix_affinity`` on (k)'s load with
    a 24-token system prompt, under ``HIVED_FLEET_KV_SHIP=1`` and ``=0``,
    beside the single-engine CLI and ``--fleet-config
    example/config/design/fleet.yaml``, as subprocesses started together:
    each exits 0 and launches no flash kernel, check_fleet (and
    check_requests) is clean on its router, every handoff ships (or
    re-prefills), the streams part from the single engine's only at
    near-ties of the teacher-forced full forward, every journal flight has
    one terminal and legs that sum to its TTFT within 1e-6 s, and the
    config run logs its parsed knobs and the autoscaler's line; then in
    this process: each of (k)'s system-prompt requests exported from a
    prefill engine and imported into a graph-warmed decode engine, bf16 and
    int8 KV, the imported blocks equal to the exported bytes, the pool's
    and params' addresses unmoved, a flipped byte caught, ms per export
    and per import and bytes per handoff; a warmed disaggregated fleet
    (ship and re-prefill, journal on, check_fleet after every step) serving
    fresh prompts of the same shapes under ``compileguard.budget(0)``; a
    decode replica killed with decode legs in flight, each stream retried
    to its end; planted faults (a prefill leg's journal mark dropped, a
    request with two live attempts) caught; and tokens/s, TTFT and TPOT of
    the single engine and the ship and re-prefill fleets in turns.

(u) elastic training and the serving mesh on the one card: ``train
    --elastic --min-chips 1 --tp 2 --fsdp 2`` at (h)'s shape (2 layers, 3
    steps) in turns with the run without the flags: the warning names the
    derived one-card mesh, K1-K3 launch, the losses are bit for bit the
    plain run's, step ms of both; ``--min-chips 2`` exits with the floor
    message and leaves the card's allocation as it was. A 2-rank gloo
    gang on the machine's CPU trains the elastic harness's tiny model to a
    dp = 2 commit; ``train --elastic --device cuda`` resumes it on the card
    (the journal's ``train_resume`` has ``crossTopology`` true, the
    cross-topology counter reads 1, the new commit records dp 1 and the
    elastic metadata, the restore seconds from the goodput spool), its
    losses within the harness's 0.02 of an uninterrupted 2-rank CPU run,
    and a planted resume that skips a step is caught. ``generate`` and
    ``serve`` as subprocesses placed in a one-GPU gang take the CLIs' mesh
    branch at world 1 and print what they print alone (tp or dp above 1
    needs more GPUs: the CPU gangs of the tests hold it). The decode
    step of a tp = 2 rank's shard of the flagship (8 heads, 4 kv heads,
    d_ff / 2, vocab / 2; no all-reduce or gather: one card) in turns with
    the whole model at (j)'s B 16, eager and as a CUDA-graph replay. On a world-1 NCCL serving mesh:
    ``make_sharded_generate`` equals ``generate`` at (j)'s shape;
    ``ServingEngine(mesh=)`` on (k)'s trace, dense and paged graph
    windows, serves the mesh-less engine's streams, replays its windows
    and captures nothing new under ``compileguard.budget(0)`` once warm;
    planted faults (two vocab shards swapped in the logits gather, the dp
    rows gathered out of order) are caught; tokens/s and TPOT p50 of the
    mesh and mesh-less engines in turns.

(v) the pipeline and MoE under sequence parallelism on the one card (pp
    and sp above 1 need more GPUs: the CPU gangs of the tests hold them).
    Two 2-rank gloo gangs on the machine's CPU train
    ``tests/test_pipeline_moe.py``'s tiny model at ``--pp 2 --microbatches
    2`` and at ``--sp 2 --n-experts 4`` to a step-2 commit, beside two that
    run uninterrupted to step 4; ``train --device cuda`` resumes each
    commit on the card at pp 1 and sp 1: the state restored on the card
    equals the checkpoint read on the CPU, the losses lie within the
    elastic harness's 0.02 of the uninterrupted gang, and a planted restore
    that swaps the two stages' layer blocks is caught (the state check
    always, the losses for the dense model). Then, on the world-1 NCCL
    mesh, (h)'s train step (6 layers, flash, remat dots, ce_chunk 512)
    through the one-stage GPipe schedule at n_micro 2 and 4 against the
    plain step from seed 0: K1-K3 launched n_micro times (h)'s per-step
    counts, the first step's loss within (d)'s 1e-3 (the same weights and
    batch) and every step's within (l)'s relative 1e-3 (the updates part in
    bf16 rounding), first-step gradients by leaf group
    within (h)'s limits, step ms by CUDA events and the step's peak memory
    in turns; the same for the MoE model of (n) at 2 layers (n_micro 2),
    its cross-entropy within 1e-3 and its aux printed beside the plain one
    (they differ by design: per-microbatch statistics); and one pp = 2
    stage's work (3 of the 6 layers, 4 microbatches, forward and backward,
    no transfer) in turns with the whole 6-layer step, beside the GPipe
    bubble (pp - 1) / (n_micro + pp - 1).

(w) overlapped tensor parallelism on the one card (tp above 1 needs more
    GPUs: NCCL refuses two ranks on one device, and the CPU gangs of the
    tests hold the real pipelines): a tp = 2 rank pair of the flagship
    (each rank 8 heads, 4 kv heads, d_ff / 2; bf16, ``--attn flash``)
    replayed in this process through ``shard_utils``' per-hop functions,
    one rank's transfer being the other rank's tensor read in the hop's
    order. (1) The whole 6-layer stack on both ranks' token blocks, joined,
    against the one-device forward's final-norm hidden states (relative
    (e)'s 5e-2), K1 launched 12 times on the ranks' local heads, and a
    planted fault (each chunk's products at the other chunk's position)
    caught; (2) one layer's backward on both ranks (the collective
    matmuls' backward schedules, the rest by autograd on each rank, K1/K2/K3
    2/2/2) against autograd of the one-device layer, by group with (h)'s
    limits (the norms' gradients summed over the ranks), and a planted
    fault (the dx accumulator's last add dropped) caught; (4) rank 0's
    projection GEMMs of one layer, forward and backward, chunked over the
    two hops against the whole gathered sequence's, in turns by CUDA
    events (the transfers and their overlap cannot be seen on one card);
    (5) ``train --overlap`` at world 1 exits with the JAX CLI's usage error
    ("tp axis is 1"), and a 2-layer eval on the world-1 NCCL mesh with
    ``overlap`` None runs the reference body (the overlapped-stack counter
    unmoved, K1 launched).

It prints one ``{"kernels": [...]}`` JSON line, the card's name and power
limit, and, last, ``{"ok": true, "device": {...}}``. Without a CUDA card,
or without the rest of the repository beside it, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import logging
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# Kernel o against the f32 plain version, normalised: bf16 rounds to a
# relative 2^-9 = 2.0e-3 at most, and the kernel also rounds p to bf16 for
# the p*v product. Over the whole tensor, ||o - o_ref||_F / ||o_ref||_F; for
# every row (b, t, h) of D values, ||o_i - o_ref_i|| / ||o_ref_i||, so a
# fault confined to a few rows cannot hide in the mean. The max |o err| is
# reported only: it is about one bf16 ulp of the largest |o|. On an H100
# the flagship read 2.1e-3 and 4.2e-3; with the planted swap of (b) 2.1e-3
# (the whole-tensor reading cannot see it) and 0.17.
O_REL = 5e-3
O_ROW_REL = 1e-2
# lse is computed in f32 from bf16 inputs on both sides
LSE_ATOL = 5e-3
# flagship eval loss, flash vs xla on the same weights and windows: a mean
# over 65k tokens of ~10.9, so it mostly shows that both routes ran;
# phase (e) is what holds the main path's numbers
LOSS_ATOL = 1e-3
# final-norm hidden states of one flagship window, flash vs xla:
# ||h_flash - h_xla||_F / ||h_xla||_F. Both run bf16 activations and differ
# in how attention rounds; the difference grows through 6 residual layers.
# On an H100 this read 1.35e-2, and 0.375 with the planted fault of (e):
# the limit sits 3.7x above the one and 7.5x below the other.
HIDDEN_REL = 5e-2

# K2/K3 dq, dk, dv against the f32 plain backward, normalised as o is in
# (b): whole-tensor relative Frobenius, and worst row (b, t, h) along D,
# where a row whose reference is below 1e-3 of the largest row is measured
# against that floor (row 0 of a causal dq is 0 in exact arithmetic, so its
# reference is rounding noise). The kernels round p and ds to bf16 for
# their products and the outputs to bf16. On an H100 the first readings
# were 2.5-2.7e-3 Frobenius and 3.7-5.2e-3 worst row over seven shapes.
GRAD_REL = 1e-2
GRAD_ROW_REL = 2e-2
# gradients of one flagship train step, flash vs xla, per leaf group:
# sqrt(sum ||g_flash - g_xla||^2 / sum ||g_xla||^2) over the group's leaves,
# and the worst single (leaf, layer) slice; set from the first readings
TRAIN_GRAD_REL = 5e-2
TRAIN_GRAD_SLICE_REL = 1e-1

PEAK_BF16_FLOPS = 989e12  # H100 SXM, dense
PEAK_HBM_BYTES = 3.35e12

FLAGSHIP = dict(b=8, t=2048, h=16, h_kv=8, d=128)
EVAL_MODEL = dict(vocab_size=32768, d_model=2048, n_heads=16, n_kv_heads=8,
                  n_layers=6, d_ff=8192)
EVAL_SEQ, EVAL_BATCH, EVAL_CE_CHUNK = 2048, 8, 512
EVAL_WINDOWS, TIMED_WINDOWS = 4, 8
EVAL_ARGS = [a for k, v in EVAL_MODEL.items()
             for a in (f"--{k.replace('_', '-')}", str(v))] + [
    "--seq-len", str(EVAL_SEQ), "--batch", str(EVAL_BATCH),
    "--ce-chunk", str(EVAL_CE_CHUNK), "--device", "cuda"]
# the train path: bench_model.py's flagship training configuration
TRAIN_STEPS = 3  # the first is the warm-up, left out of the step time
TRAIN_ARGS = EVAL_ARGS + ["--remat", "dots", "--log-every", "1"]


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def rel_errs(x, ref, floor: float = 0.0):
    """(||x - ref||_F / ||ref||_F, max over rows of ||x_i - ref_i|| /
    max(||ref_i||, floor * max_j ||ref_j||)), rows along the last axis, in
    f32."""
    x, ref = x.float(), ref.float()
    diff = x - ref
    fro = float(diff.norm() / ref.norm())
    norms = ref.norm(dim=-1)
    row = float((diff.norm(dim=-1) / norms.clamp_min(floor * float(norms.max()))).max())
    return fro, row


KERNEL_LIBS = ("flash_fwd", "flash_bwd")


def phase_build():
    from hivedscheduler_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.build_all(KERNEL_LIBS)
    for name in KERNEL_LIBS:
        _build.load(name)
    print(f"[a] built and loaded {', '.join(KERNEL_LIBS)} in "
          f"{time.perf_counter() - t0:.1f}s")
    for name in KERNEL_LIBS:
        for line in _build.BUILD_LOGS.get(name, "").splitlines():
            if any(k in line for k in ("Compiling entry", "registers", "spill",
                                       "Performance Loss")):
                print(f"[a] {name}: {line.strip()}")


def make_qkv(b, t, h, h_kv, d, seed):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda",
                           dtype=torch.float32).to(torch.bfloat16)

    return randn(b, t, h, d), randn(b, t, h_kv, d), randn(b, t, h_kv, d)


def phase_kernel_check() -> float:
    """Kernel against plain version; returns max |o err| at the flagship."""
    import torch

    from hivedscheduler_tpu_torch.ops import attention as attn

    f = FLAGSHIP
    cases = [
        ("flagship_causal_gqa", f["b"], f["t"], f["h"], f["h_kv"], f["d"], True),
        ("flagship_full_gqa", f["b"], f["t"], f["h"], f["h_kv"], f["d"], False),
        ("flagship_causal_mha", f["b"], f["t"], f["h"], f["h"], f["d"], True),
        ("t192_causal_gqa", 2, 192, f["h"], f["h_kv"], f["d"], True),
        ("ragged_d64_mqa", 2, 200, 4, 1, 64, True),
    ]
    flagship_err = None
    for i, (name, b, t, h, h_kv, d, causal) in enumerate(cases):
        q, k, v = make_qkv(b, t, h, h_kv, d, seed=i)
        o, lse = attn.flash_forward(q, k, v, causal=causal)
        o_ref, lse_ref = attn.flash_attention_plain(q, k, v, causal=causal)
        torch.cuda.synchronize()
        check(o.shape == q.shape and o.dtype == torch.bfloat16, f"{name}: o {o.shape} {o.dtype}")
        check(lse.shape == (b * h, t), f"{name}: lse {lse.shape}")
        check(bool(torch.isfinite(o).all()) and bool(torch.isfinite(lse).all()),
              f"{name}: non-finite output")
        o_err = float((o.float() - o_ref.float()).abs().max())
        o_fro, o_row = rel_errs(o, o_ref)
        lse_err = float((lse - lse_ref).abs().max())
        print(f"[b] {name} B={b} T={t} H={h} H_kv={h_kv} D={d} causal={causal}: "
              f"o rel {o_fro:.3e} (<= {O_REL}), o worst row rel {o_row:.3e} "
              f"(<= {O_ROW_REL}), max|o err| {o_err:.3e}, "
              f"max|lse err| {lse_err:.3e} (<= {LSE_ATOL})")
        check(o_fro <= O_REL and o_row <= O_ROW_REL and lse_err <= LSE_ATOL,
              f"{name}: kernel disagrees with its plain version")
        if i == 0:
            flagship_err = o_err
            again = attn.flash_forward(q, k, v, causal=causal)
            same = torch.equal(o, again[0]) and torch.equal(lse, again[1])
            print(f"[b] {name} run twice: bit-identical {same}")
            check(same, "the forward is not bit-reproducible")
            del again
            # planted fault: the last two keys' values swapped, which moves
            # only the last two rows of each sequence
            v_bad = v.clone()
            v_bad[:, [t - 2, t - 1]] = v[:, [t - 1, t - 2]]
            o_bad, _ = attn.flash_forward(q, k, v_bad, causal=causal)
            bad_fro, bad_row = rel_errs(o_bad, o_ref)
            print(f"[b] {name} planted fault (V keys {t - 2}, {t - 1} swapped): "
                  f"o rel {bad_fro:.3e}, o worst row rel {bad_row:.3e}")
            check(bad_row > O_ROW_REL, "the o check does not see a swapped V key pair")
            del v_bad, o_bad
        del q, k, v, o, lse, o_ref, lse_ref
    torch.cuda.empty_cache()
    return flagship_err


def phase_kernel_time() -> dict:
    import torch
    import torch.nn.functional as F

    from hivedscheduler_tpu_torch.ops import attention as attn

    f = FLAGSHIP
    q, k, v = make_qkv(f["b"], f["t"], f["h"], f["h_kv"], f["d"], seed=0)
    kernel_ms = time_ms(lambda: attn.flash_forward(q, k, v, causal=True), iters=50, warmup=5)
    plain_ms = time_ms(lambda: attn.flash_attention_plain(q, k, v, causal=True), iters=3, warmup=1)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    library_ms = time_ms(
        lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True),
        iters=50, warmup=5)
    flops = attn.attention_flops(f["b"], f["t"], f["h"], f["d"], causal=True)
    nbytes = attn.attention_bytes(f["b"], f["t"], f["h"], f["h_kv"], f["d"])
    ops_ms = flops / PEAK_BF16_FLOPS * 1e3
    bytes_ms = nbytes / PEAK_HBM_BYTES * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    bound_by = "operations" if ops_ms >= bytes_ms else "bytes"
    print(f"[c] flash_fwd at the flagship shape: kernel_ms {kernel_ms:.4f} "
          f"plain_ms {plain_ms:.3f} library_ms {library_ms:.4f} "
          f"bound_ms {bound_ms:.4f} ({bound_by}: {flops / 1e9:.1f} GFLOP, "
          f"{nbytes / 1e6:.1f} MB) -> {flops / kernel_ms / 1e9:.1f} TFLOP/s, "
          f"{bound_ms / kernel_ms:.1%} of the bound")
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    return dict(ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by)


class _LogArgs(logging.Handler):
    """Keeps the arguments of every record logged with one format: the
    timing lines of ``eval`` and ``train`` themselves."""

    def __init__(self, fmt: str):
        super().__init__()
        self.fmt = fmt
        self.args = []

    def emit(self, record):
        if record.msg == self.fmt:
            self.args.append(record.args)


def run_eval(attn_impl: str, windows: int, args=EVAL_ARGS):
    """``eval.main`` with ``args`` -> (loss, window ms, tokens/s) as it
    reports them."""
    from hivedscheduler_tpu_torch import eval as port_eval

    timing = _LogArgs(port_eval.WINDOWS_LOG)
    logger = logging.getLogger(port_eval.__name__)
    logger.addHandler(timing)
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            rc = port_eval.main(args + ["--attn", attn_impl,
                                        "--max-steps", str(windows)])
    finally:
        logger.removeHandler(timing)
    out = buf.getvalue()
    print(out, end="")
    check(rc == 0, f"eval --attn {attn_impl} exited {rc}")
    line = [l for l in out.splitlines() if l.startswith("loss ")][-1].split()
    loss, ppl = float(line[1]), float(line[3])
    check(math.isfinite(loss) and math.isfinite(ppl), f"eval --attn {attn_impl}: loss {loss}")
    check(len(timing.args) == 1, f"eval --attn {attn_impl} logged no window timing")
    n_steps, tokens, seconds, _ = timing.args[0]
    check(n_steps == windows, f"eval ran {n_steps} windows, asked {windows}")
    return loss, seconds / n_steps * 1e3, tokens / seconds


def phase_eval() -> int:
    from hivedscheduler_tpu_torch.ops import attention as attn

    attn.FLASH_FWD_LAUNCHES = 0
    loss_flash, _, _ = run_eval("flash", EVAL_WINDOWS)
    launches = attn.FLASH_FWD_LAUNCHES
    layers = EVAL_MODEL["n_layers"]
    print(f"[d] eval --attn flash: loss {loss_flash:.6f}, flash_fwd launches "
          f"{launches} (want {layers} layers x {EVAL_WINDOWS} windows)")
    check(launches == layers * EVAL_WINDOWS,
          f"flash_fwd launched {launches} times on the eval path")
    loss_xla, _, _ = run_eval("xla", EVAL_WINDOWS)
    print(f"[d] eval --attn xla: loss {loss_xla:.6f}; |flash - xla| "
          f"{abs(loss_flash - loss_xla):.3e} (<= {LOSS_ATOL})")
    check(abs(loss_flash - loss_xla) <= LOSS_ATOL, "flash and xla eval losses disagree")
    # the runs above warmed the process; these are timed as eval reports it
    for impl in ("flash", "xla"):
        _, window_ms, tokens_per_s = run_eval(impl, TIMED_WINDOWS)
        print(f"[d] eval window --attn {impl} (B={EVAL_BATCH}, T={EVAL_SEQ}, "
              f"{layers} layers, ce_chunk {EVAL_CE_CHUNK}, {TIMED_WINDOWS} "
              f"windows): {window_ms} ms, {tokens_per_s} tokens/s")
    return launches


def phase_hidden_check(model=EVAL_MODEL, tag="[e]", what="one flagship window") -> None:
    import numpy as np
    import torch

    from hivedscheduler_tpu_torch.models import transformer as tm
    from hivedscheduler_tpu_torch.ops import attention as attn
    from hivedscheduler_tpu_torch.parallel import data as data_lib

    # the weights and first window of eval's run
    cfg_f = tm.TransformerConfig(max_seq_len=EVAL_SEQ, attn_impl="flash", **model)
    cfg_x = dataclasses.replace(cfg_f, attn_impl="xla")
    params = tm.init_params(cfg_f, torch.Generator(device="cuda").manual_seed(0), "cuda")
    corpus = data_lib.synthetic_dataset(cfg_f.vocab_size).tokens
    tokens = torch.from_numpy(np.asarray(
        corpus[:EVAL_BATCH * EVAL_SEQ], dtype=np.int32).reshape(EVAL_BATCH, EVAL_SEQ)).cuda()

    real = attn.flash_attention
    calls = []

    def zero_last_layer(q, k, v, causal=True, **kw):
        out = real(q, k, v, causal=causal, **kw)
        calls.append(1)
        return torch.zeros_like(out) if len(calls) == cfg_f.n_layers else out

    with torch.inference_mode():
        h_x = tm.forward_with_aux(params, tokens, cfg_x, return_hidden=True)[0]
        h_f = tm.forward_with_aux(params, tokens, cfg_f, return_hidden=True)[0]
        attn.flash_attention = zero_last_layer
        try:
            h_bad = tm.forward_with_aux(params, tokens, cfg_f, return_hidden=True)[0]
        finally:
            attn.flash_attention = real
    torch.cuda.synchronize()
    check(h_f.shape == (EVAL_BATCH, EVAL_SEQ, cfg_f.d_model), f"hidden {h_f.shape}")
    check(bool(torch.isfinite(h_f).all()), "non-finite hidden states")
    fro, row = rel_errs(h_f, h_x)
    max_abs = float((h_f.float() - h_x.float()).abs().max())
    bad_fro, bad_row = rel_errs(h_bad, h_x)
    print(f"{tag} final-norm hidden states, flash vs xla, {what}: "
          f"rel {fro:.3e} (<= {HIDDEN_REL}), worst token rel {row:.3e}, "
          f"max|err| {max_abs:.3e}; planted fault (last layer's attention "
          f"zeroed): rel {bad_fro:.3e}, worst token rel {bad_row:.3e}")
    check(len(calls) == cfg_f.n_layers, f"planted run made {len(calls)} attention calls")
    check(fro <= HIDDEN_REL, "flash and xla hidden states disagree")
    check(bad_fro > HIDDEN_REL, "the hidden-state check does not see the planted fault")
    del params, h_x, h_f, h_bad
    torch.cuda.empty_cache()


def phase_backward_check() -> dict:
    """K2/K3 against the plain backward; returns the flagship max |err| of
    dq (K2) and of dk, dv (K3)."""
    import torch

    from hivedscheduler_tpu_torch.ops import attention as attn

    f = FLAGSHIP
    cases = [
        ("flagship_causal_gqa", f["b"], f["t"], f["h"], f["h_kv"], f["d"], True),
        ("flagship_full_gqa", f["b"], f["t"], f["h"], f["h_kv"], f["d"], False),
        ("flagship_causal_mha", f["b"], f["t"], f["h"], f["h"], f["d"], True),
        ("t192_causal_gqa", 2, 192, f["h"], f["h_kv"], f["d"], True),
        ("t320_causal_gqa4", 2, 320, f["h"], 4, f["d"], True),
        ("ragged_d64_mqa", 2, 200, 4, 1, 64, True),
    ]
    max_err = {}
    for i, (name, b, t, h, h_kv, d, causal) in enumerate(cases):
        q, k, v = make_qkv(b, t, h, h_kv, d, seed=10 + i)
        do = make_qkv(b, t, h, h_kv, d, seed=20 + i)[0]
        o, lse = attn.flash_forward(q, k, v, causal=causal)
        got = attn.flash_backward(q, k, v, o, lse, do, causal=causal)
        ref = attn.flash_backward_plain(q, k, v, o, lse, do, causal=causal)
        torch.cuda.synchronize()
        errs = []
        for x, r, like, out in zip(got, ref, (q, k, v), ("dq", "dk", "dv")):
            check(x.shape == like.shape and x.dtype == torch.bfloat16,
                  f"{name}: {out} {x.shape} {x.dtype}")
            check(bool(torch.isfinite(x).all()), f"{name}: non-finite {out}")
            fro, row = rel_errs(x, r, floor=1e-3)
            errs.append((out, fro, row, float((x.float() - r.float()).abs().max())))
        print(f"[f] {name} B={b} T={t} H={h} H_kv={h_kv} D={d} causal={causal}: "
              + ", ".join(f"{out} rel {fro:.3e} worst row {row:.3e} max|err| {mx:.3e}"
                          for out, fro, row, mx in errs)
              + f" (limits {GRAD_REL}, {GRAD_ROW_REL})")
        check(all(fro <= GRAD_REL and row <= GRAD_ROW_REL for _, fro, row, _ in errs),
              f"{name}: the backward kernels disagree with their plain version")
        if i == 0:
            max_err = {"dq": errs[0][3], "dkv": max(errs[1][3], errs[2][3])}
            again = attn.flash_backward(q, k, v, o, lse, do, causal=causal)
            same = all(torch.equal(a, b_) for a, b_ in zip(got, again))
            print(f"[f] {name} run twice: bit-identical {same}")
            check(same, "the backward is not bit-reproducible")
            # planted fault: K keys T-2 and T-1 swapped (o and lse kept),
            # which moves only rows T-2 and T-1 of dq, dk and dv
            k_bad = k.clone()
            k_bad[:, [t - 2, t - 1]] = k[:, [t - 1, t - 2]]
            bad = attn.flash_backward(q, k_bad, v, o, lse, do, causal=causal)
            for x, r, out in zip(bad, ref, ("dq", "dk", "dv")):
                fro, row = rel_errs(x, r, floor=1e-3)
                print(f"[f] {name} planted fault (K keys {t - 2}, {t - 1} swapped): "
                      f"{out} rel {fro:.3e}, worst row {row:.3e}")
                check(row > GRAD_ROW_REL, f"the {out} check does not see a swapped K key pair")
            del again, k_bad, bad
        del q, k, v, do, o, lse, got, ref
        torch.cuda.empty_cache()
    return max_err


def phase_backward_time() -> dict:
    import torch
    import torch.nn.functional as F

    from hivedscheduler_tpu_torch.ops import attention as attn

    f = FLAGSHIP
    q, k, v = make_qkv(f["b"], f["t"], f["h"], f["h_kv"], f["d"], seed=10)
    do = make_qkv(f["b"], f["t"], f["h"], f["h_kv"], f["d"], seed=20)[0]
    o, lse = attn.flash_forward(q, k, v, causal=True)
    _, delta = attn.flash_backward_dq_cuda(q, k, v, o, lse, do)
    k2_ms = time_ms(lambda: attn.flash_backward_dq_cuda(q, k, v, o, lse, do),
                    iters=20, warmup=3)
    k3_ms = time_ms(lambda: attn.flash_backward_dkv_cuda(q, k, v, lse, delta, do),
                    iters=20, warmup=3)
    plain_ms = time_ms(lambda: attn.flash_backward_plain(q, k, v, o, lse, do),
                       iters=3, warmup=1)
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True) for x in (q, k, v))
    out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
    dout = do.transpose(1, 2).contiguous()
    library_ms = time_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), dout,
                                                     retain_graph=True),
                         iters=20, warmup=3)
    flops = attn.attention_bwd_flops(f["b"], f["t"], f["h"], f["d"], causal=True)
    nbytes = attn.attention_bwd_bytes(f["b"], f["t"], f["h"], f["h_kv"], f["d"])
    least_ms = flops["least"] / PEAK_BF16_FLOPS * 1e3
    timing = {}
    for key, name, ms in (("dq", "K2 flash_bwd_dq", k2_ms), ("dkv", "K3 flash_bwd_dkv", k3_ms)):
        ops_ms = flops[key] / PEAK_BF16_FLOPS * 1e3
        bytes_ms = nbytes[key] / PEAK_HBM_BYTES * 1e3
        bound_ms = max(ops_ms, bytes_ms)
        bound_by = "operations" if ops_ms >= bytes_ms else "bytes"
        print(f"[g] {name} at the flagship shape: kernel_ms {ms:.4f} "
              f"plain_ms {plain_ms:.3f} library_ms {library_ms:.4f} "
              f"bound_ms {bound_ms:.4f} ({bound_by}: {flops[key] / 1e9:.1f} GFLOP, "
              f"{nbytes[key] / 1e6:.1f} MB) -> {flops[key] / ms / 1e9:.1f} TFLOP/s, "
              f"{bound_ms / ms:.1%} of the bound")
        timing[key] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                           bound_ms=bound_ms, bound_by=bound_by)
    print(f"[g] whole backward: K2 + K3 {k2_ms + k3_ms:.4f} ms against the "
          f"least backward's bound {least_ms:.4f} ms ({flops['least'] / 1e9:.1f} "
          f"GFLOP, 5 products) and the library backward {library_ms:.4f} ms; "
          f"plain_ms and library_ms are of the whole backward (dq, dk and dv)")
    del q, k, v, do, o, lse, delta, qt, kt, vt, out, dout
    torch.cuda.empty_cache()
    return timing


def run_train(attn_impl: str, steps: int, args=TRAIN_ARGS):
    """``train.main`` with ``args`` -> (its timeline records, checked; the
    peak device memory of the run in bytes)."""
    import torch

    from hivedscheduler_tpu_torch import train as port_train

    lines = _LogArgs(port_train.STEP_LOG)
    logger = logging.getLogger(port_train.__name__)
    logger.addHandler(lines)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "timeline.jsonl")
        try:
            rc = port_train.main(args + ["--attn", attn_impl, "--steps",
                                         str(steps), "--timeline", path])
        finally:
            logger.removeHandler(lines)
        with open(path) as f:
            records = [json.loads(line) for line in f]
    check(rc == 0, f"train --attn {attn_impl} exited {rc}")
    check([r["step"] for r in records] == list(range(1, steps + 1)),
          f"train --attn {attn_impl} timeline has steps {[r['step'] for r in records]}")
    check([a[0] for a in lines.args] == list(range(1, steps + 1)),
          f"train --attn {attn_impl} logged {len(lines.args)} step lines")
    check(all(math.isfinite(r["loss"]) for r in records),
          f"train --attn {attn_impl}: non-finite loss {[r['loss'] for r in records]}")
    return records, torch.cuda.max_memory_allocated()


def phase_train() -> dict:
    from hivedscheduler_tpu_torch.ops import attention as attn

    attn.FLASH_FWD_LAUNCHES = 0
    attn.FLASH_BWD_DQ_LAUNCHES = 0
    attn.FLASH_BWD_DKV_LAUNCHES = 0
    records, peak = run_train("flash", TRAIN_STEPS)
    launches = {"fwd": attn.FLASH_FWD_LAUNCHES, "dq": attn.FLASH_BWD_DQ_LAUNCHES,
                "dkv": attn.FLASH_BWD_DKV_LAUNCHES}
    layers = EVAL_MODEL["n_layers"]
    want = {"fwd": 2 * layers * TRAIN_STEPS, "dq": layers * TRAIN_STEPS,
            "dkv": layers * TRAIN_STEPS}
    print(f"[h] train --attn flash --remat dots: losses "
          f"{[r['loss'] for r in records]}; launches over {TRAIN_STEPS} steps "
          f"{launches} (want {want}: K1 twice a layer, K2 and K3 once)")
    check(launches == want, f"train launched {launches}, want {want}")
    flash = {"losses": [r["loss"] for r in records]}
    for impl in ("flash", "xla"):
        if impl == "xla":
            records, peak = run_train("xla", TRAIN_STEPS)
        timed = [r for r in records if not r["compile"]]
        step_ms = sum(r["wall_s"] for r in timed) / len(timed) * 1e3
        if impl == "flash":
            flash["step_ms"] = step_ms
            flash["peak"] = peak
        tokens_per_s = EVAL_BATCH * EVAL_SEQ / (step_ms / 1e3)
        print(f"[h] train step --attn {impl} (B={EVAL_BATCH}, T={EVAL_SEQ}, "
              f"{layers} layers, remat dots, ce_chunk {EVAL_CE_CHUNK}, mean of "
              f"{len(timed)} steps after the warm-up): {step_ms} ms, "
              f"{tokens_per_s} tokens/s, peak device memory {peak / 1e9:.2f} GB")
    return launches, flash


# kernel-name fragments of each part of a train step's device time
PROFILE_GROUPS = (
    ("K1 flash_fwd", ("flash_fwd_kernel",)),
    ("K2 flash_bwd_dq", ("flash_bwd_dq_kernel",)),
    ("K3 flash_bwd_dkv", ("flash_bwd_dkv_kernel",)),
    ("matmuls", ("gemm", "xmma", "cutlass", "nvjet", "cublas")),
)
OTHER_GROUP = "other (elementwise, norms, CE, optimizer)"


def profile_group(kernel_name: str, groups=PROFILE_GROUPS) -> str:
    """The part of the step a device kernel's time is counted in."""
    key = kernel_name.lower()
    return next((name for name, frags in groups
                 if any(f.lower() in key for f in frags)), OTHER_GROUP)


def _step_profile(step, params, opt, batch, groups=PROFILE_GROUPS):
    """One ``step`` under torch.profiler -> (its wall ms, device-busy ms,
    {group: device ms}), each device kernel counted in the first of
    ``groups`` whose name fragments it holds, else in OTHER_GROUP."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        float(step(params, opt, batch)[2])
        wall_ms = (time.perf_counter() - t0) * 1e3
    parts = {name: 0.0 for name, _ in groups}
    parts[OTHER_GROUP] = 0.0
    total = 0.0
    for event in prof.key_averages():
        # device-side events only (kernels, copies): a host op's self device
        # time is its kernels' again, and so is the device-side range of a
        # user annotation (the optimizer's ``Optimizer.step#AdamW.step``)
        if event.device_type != DeviceType.CUDA or getattr(
                event, "is_user_annotation", False):
            continue
        us = event.self_device_time_total
        total += us
        parts[profile_group(event.key, groups)] += us
    return wall_ms, total / 1e3, {k: v / 1e3 for k, v in parts.items()}


def phase_train_profile() -> None:
    """Device time of one flagship flash train step by kernel group, from
    torch.profiler, beside the step's wall time."""
    import torch

    from hivedscheduler_tpu_torch.models import transformer as tm
    from hivedscheduler_tpu_torch.parallel import data as data_lib
    from hivedscheduler_tpu_torch.parallel import train as port_train

    cfg = tm.TransformerConfig(max_seq_len=EVAL_SEQ, attn_impl="flash",
                               remat="dots", **EVAL_MODEL)
    step, init_fn = port_train.make_train_step(cfg, "cuda", ce_chunk=EVAL_CE_CHUNK)
    params, opt = init_fn(torch.Generator(device="cuda").manual_seed(0))
    loader = data_lib.CheckpointableBatches(
        data_lib.synthetic_dataset(cfg.vocab_size), EVAL_BATCH, EVAL_SEQ)
    batches = [torch.from_numpy(next(loader)).cuda() for _ in range(2)]
    step(params, opt, batches[0])  # warm-up
    wall_ms, total, parts = _step_profile(step, params, opt, batches[1])
    if total == 0:
        print("[h] profiler: no device time recorded (not measured)")
    else:
        print(f"[h] profile of one flash train step: wall {wall_ms:.1f} ms, device "
              f"busy {total:.1f} ms ({1 - total / wall_ms:.1%} idle); "
              + ", ".join(f"{k} {v:.1f} ms ({v / total:.1%})"
                          for k, v in parts.items()))
    del params, opt, batches
    torch.cuda.empty_cache()


# phase (i): checkpoint, resume, preemption and goodput at the flagship
# width; the round trip holds the whole 6-layer state, the train runs that
# resume and preempt are cut to 2 layers (the script's time limit)
CKPT_ARGS = TRAIN_ARGS + ["--attn", "flash"]
RESUME_ARGS = CKPT_ARGS + ["--n-layers", "2"]
RESUME_STEPS, RESUME_SPLIT = 4, 2
# resumed losses against the uninterrupted run's when two uninterrupted runs
# are not bit-identical: the loss limit the port uses flash vs xla, relative
RESUME_REL = 1e-3
PREEMPT_STEPS, PREEMPT_AT, GRACE_SECS = 8, 2, 60.0


def _train_main(tmp: str, name: str, *extra: str, args=CKPT_ARGS) -> dict:
    """``train.main`` with ``args`` (the flagship train flags) and ``extra``
    -> {step: loss} of its timeline (the last record of a step wins)."""
    import torch

    from hivedscheduler_tpu_torch import train as port_train

    torch.cuda.empty_cache()
    path = os.path.join(tmp, f"{name}.jsonl")
    rc = port_train.main(args + ["--timeline", path] + list(extra))
    check(rc == 0, f"train ({name}) exited {rc}")
    with open(path) as f:
        losses = {r["step"]: r["loss"] for r in map(json.loads, f)}
    check(all(math.isfinite(v) for v in losses.values()),
          f"train ({name}): non-finite loss {losses}")
    return losses


def _close_goodput() -> None:
    """End one in-process incarnation's goodput ledger as a process exit
    would (the summary record), so the next run spools as a new one."""
    from hivedscheduler_tpu_torch.obs import goodput

    goodput.GOODPUT.close()
    goodput.disable()
    goodput.GOODPUT.clear()


def _state_mismatches(params, opt, params2, opt2) -> list:
    """Names of the parameters and AdamW state entries that are not
    bit-identical (or not on the same device and dtype); DTensors are held
    shard for shard."""
    import torch

    from hivedscheduler_tpu_torch.parallel import checkpoint as ckpt
    from hivedscheduler_tpu_torch.parallel.sharding import local

    def same(x, y):
        x, y = local(x.detach()), local(y.detach())
        return (x.device, x.dtype) == (y.device, y.dtype) and torch.equal(x, y)

    bad = []
    a_named, b_named = ckpt.named_leaves(params), ckpt.named_leaves(params2)
    for name, a in a_named.items():
        b = b_named[name]
        if not same(a, b):
            bad.append(name)
        sa, sb = opt.state[a], opt2.state.get(b, {})
        for key, x in sa.items():
            y = sb.get(key)
            if y is None or not same(x, y):
                bad.append(f"{name}.{key}")
    return bad


def _round_trip(tmp: str) -> dict:
    """Save the flagship train state after one step and restore it into
    zeroed templates on the card; bit-identical, with a planted fault."""
    import numpy as np
    import torch

    from hivedscheduler_tpu_torch.models import transformer as tm
    from hivedscheduler_tpu_torch.parallel import checkpoint as ckpt
    from hivedscheduler_tpu_torch.parallel import data as data_lib
    from hivedscheduler_tpu_torch.parallel import train as port_train

    cfg = tm.TransformerConfig(max_seq_len=EVAL_SEQ, attn_impl="flash",
                               remat="dots", **EVAL_MODEL)
    step, init_fn = port_train.make_train_step(cfg, "cuda", ce_chunk=EVAL_CE_CHUNK)
    params, opt = init_fn(torch.Generator(device="cuda").manual_seed(0))
    loader = data_lib.CheckpointableBatches(
        data_lib.synthetic_dataset(cfg.vocab_size), EVAL_BATCH, EVAL_SEQ)
    params, opt, _ = step(params, opt, torch.from_numpy(np.asarray(next(loader))).cuda())
    torch.cuda.synchronize()
    d = os.path.join(tmp, "round-trip")
    t0 = time.perf_counter()
    ckpt.save(d, 1, params, opt)
    save_s = time.perf_counter() - t0
    nbytes = sum(os.path.getsize(os.path.join(d, "1", n)) for n in os.listdir(os.path.join(d, "1")))
    params2, opt2 = init_fn(torch.Generator(device="cuda").manual_seed(1))
    with torch.no_grad():
        for leaf in ckpt.named_leaves(params2).values():
            leaf.zero_()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    restored = ckpt.restore(d, params2, opt2)[0]
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    check(restored == 1, f"restored step {restored}")
    n_params = sum(t.numel() for t in ckpt.named_leaves(params).values())
    moments = sum(x.numel() for s in opt2.state.values() for x in s.values() if x.dim())
    check(moments == 2 * n_params, f"restored {moments} moment values for {n_params} parameters")
    bad = _state_mismatches(params, opt, params2, opt2)
    print(f"[i] round trip: {n_params / 1e6:.1f} M f32 parameters and their AdamW "
          f"moments, {nbytes / 1e9:.3f} GB written; save {save_s:.2f} s "
          f"({nbytes / save_s / 1e9:.2f} GB/s), restore into zeroed templates "
          f"{restore_s:.2f} s ({nbytes / restore_s / 1e9:.2f} GB/s); "
          f"not bit-identical: {bad}")
    check(not bad, f"the restored state differs in {bad}")
    # planted fault: one element of one restored moment flipped in its
    # lowest bit
    moment = opt2.state[ckpt.named_leaves(params2)["layers.w_up"]]["exp_avg_sq"]
    moment.view(-1)[12345:12346].view(torch.int32).bitwise_xor_(1)
    planted = _state_mismatches(params, opt, params2, opt2)
    print(f"[i] planted fault (one bit of one element of layers.w_up's "
          f"exp_avg_sq): not bit-identical {planted}")
    check(planted == ["layers.w_up.exp_avg_sq"], "the round-trip check does not see the planted fault")
    shutil.rmtree(d)
    return dict(gb=nbytes / 1e9, save_s=save_s, restore_s=restore_s)


def phase_checkpoint() -> dict:
    """(i): the round trip, resume against the uninterrupted run,
    preemption by SIGTERM and the goodput ledger, at the flagship width."""
    import torch

    from hivedscheduler_tpu_torch.obs import goodput
    from hivedscheduler_tpu_torch.parallel import checkpoint as ckpt

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip-smoke-ckpt-")
    try:
        # the phase holds at most two flagship checkpoints on disk at once
        n_params = _flagship_params()
        need = 2 * 3 * 4 * n_params
        free = shutil.disk_usage(tmp).free
        print(f"[i] {tmp}: {free / 1e9:.1f} GB free; the phase writes at most "
              f"{need / 1e9:.1f} GB at once")
        check(free > 1.1 * need, f"{tmp} has {free / 1e9:.1f} GB free, the phase "
              f"needs {need / 1e9:.1f} GB")
        report = _round_trip(tmp)
        torch.cuda.empty_cache()

        # resume against the uninterrupted run
        a = _train_main(tmp, "A", "--steps", str(RESUME_STEPS), args=RESUME_ARGS)
        a2 = _train_main(tmp, "A2", "--steps", str(RESUME_STEPS), args=RESUME_ARGS)
        spread = max(abs(a[s] - a2[s]) / abs(a[s]) for s in a)
        exact = a == a2
        print(f"[i] uninterrupted runs A and A2, {RESUME_STEPS} steps: losses "
              f"{list(a.values())}; bit-identical {exact}, largest relative "
              f"spread {spread:.3e}")

        def resumed_err(b):
            steps = range(RESUME_SPLIT + 1, RESUME_STEPS + 1)
            check(sorted(b) == list(steps), f"resumed run took steps {sorted(b)}")
            return max(abs(b[s] - a[s]) / abs(a[s]) for s in steps), all(b[s] == a[s] for s in steps)

        def within(err, same):
            return same if exact else err <= RESUME_REL

        limit = "bit-identical" if exact else f"relative {RESUME_REL}"
        ck = os.path.join(tmp, "resume-ck")
        gp = os.path.join(tmp, "goodput.jsonl")
        common = ["--checkpoint-dir", ck, "--checkpoint-every", str(RESUME_SPLIT),
                  "--goodput-file", gp]
        _close_goodput()
        b = _train_main(tmp, "B", "--steps", str(RESUME_SPLIT), *common, args=RESUME_ARGS)
        _close_goodput()
        if exact:
            check(b == {s: a[s] for s in range(1, RESUME_SPLIT + 1)},
                  "run B's first steps differ from run A's")
        b1 = _train_main(tmp, "B1", "--steps", str(RESUME_STEPS), *common,
                         args=RESUME_ARGS)
        _close_goodput()
        err, same = resumed_err(b1)
        print(f"[i] B: {RESUME_SPLIT} steps with --checkpoint-every {RESUME_SPLIT}; "
              f"B': the same command with --steps {RESUME_STEPS} resumed from step "
              f"{RESUME_SPLIT}: steps {sorted(b1)} against A: largest relative "
              f"error {err:.3e}, bit-identical {same} (limit: {limit})")
        check(within(err, same), "the resumed steps disagree with the uninterrupted run")
        check(ckpt.latest_step(ck) == RESUME_STEPS, f"B' committed {ckpt.latest_step(ck)}")

        # planted faults on the resume: the loader state dropped from the
        # marker (fast-forward by skip(start_step), which is right), then
        # the loader restarted at position 0 (which is wrong)
        marker = os.path.join(ck, str(RESUME_SPLIT), "hived_complete.json")
        with open(marker) as f:
            saved = json.load(f)
        from hivedscheduler_tpu_torch.parallel import data as data_lib

        fresh = data_lib.CheckpointableBatches(
            data_lib.synthetic_dataset(EVAL_MODEL["vocab_size"]), EVAL_BATCH,
            EVAL_SEQ).to_dict()
        outcomes = {}
        for case, loader in (("no loader state (skip)", None),
                             ("loader restarted at 0", fresh)):
            shutil.rmtree(os.path.join(ck, str(RESUME_STEPS)))
            extra = {k: v for k, v in saved["extra"].items() if k != "loader"}
            if loader is not None:
                extra["loader"] = loader
            ckpt.atomic_write_bytes(marker, json.dumps(dict(saved, extra=extra)).encode())
            got = _train_main(tmp, case.split()[0], "--steps", str(RESUME_STEPS),
                              "--checkpoint-dir", ck, "--checkpoint-every", str(RESUME_SPLIT),
                              args=RESUME_ARGS)
            outcomes[case] = resumed_err(got)
            print(f"[i] resume with {case}: largest relative error "
                  f"{outcomes[case][0]:.3e}, bit-identical {outcomes[case][1]}")
        check(within(*outcomes["no loader state (skip)"]),
              "a resume that fast-forwards the loader disagrees")
        check(not within(*outcomes["loader restarted at 0"]),
              "the resume check does not see a loader restarted at position 0")
        shutil.rmtree(ck)

        # goodput of B + B'
        records = goodput.read_spool(gp)
        agg = goodput.aggregate_spool(records)
        violations = goodput.check_spool(gp) + goodput.check_rework_classification(records)
        shown = ("checkpoint_save", "checkpoint_restore", "compile", "step_compute",
                 "data_wait", "init", "idle")
        print(f"[i] goodput of B + B' ({agg['incarnations']} incarnations, "
              f"{agg['steps']} steps): " + ", ".join(
                  f"{p} {agg['phases'].get(p, 0.0):.3f} s" for p in shown)
              + f"; goodput fraction {agg['goodput_fraction']:.4f}; "
              f"check_spool violations {violations}")
        check(agg["incarnations"] == 2 and agg["torn"] == 0, f"goodput spool {agg}")
        check(not violations, "the goodput spool has violations")
        report["goodput"] = {p: agg["phases"].get(p, 0.0) for p in shown}

        # preemption: SIGTERM to a training process on the card
        report["preempt"] = _preemption(tmp)
        report["spread"], report["exact"] = spread, exact
        report["resume_err"] = err
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    report["phase_s"] = time.perf_counter() - t_phase
    print(f"[i] phase wall time {report['phase_s']:.1f} s")
    return report


def _flagship_params(m=EVAL_MODEL) -> int:
    d, f, v, n = m["d_model"], m["d_ff"], m["vocab_size"], m["n_layers"]
    hd = d // m["n_heads"]
    layer = 2 * d + d * d * 2 + 2 * d * m["n_kv_heads"] * hd + 3 * d * f
    return 2 * v * d + d + n * layer


def _preemption(tmp: str) -> dict:
    """SIGTERM to ``python -m hivedscheduler_tpu_torch.train`` once its
    timeline shows step PREEMPT_AT: exit 0 within the grace period with a
    committed marker at the step it stopped on; then a second incarnation
    resumes and finishes."""
    import signal

    import torch

    from hivedscheduler_tpu_torch.parallel import checkpoint as ckpt

    torch.cuda.empty_cache()
    ck = os.path.join(tmp, "preempt-ck")
    tl = os.path.join(tmp, "preempt.jsonl")
    cmd = [sys.executable, "-m", "hivedscheduler_tpu_torch.train"] + RESUME_ARGS + [
        "--steps", str(PREEMPT_STEPS), "--checkpoint-dir", ck,
        "--checkpoint-every", "100", "--grace-secs", str(GRACE_SECS),
        "--timeline", tl, "--log-every", "100"]
    log_path = os.path.join(tmp, "preempt.log")
    with open(log_path, "w") as log_f:
        proc = subprocess.Popen(cmd, cwd=REPO, stdout=log_f, stderr=subprocess.STDOUT)
        try:
            deadline = time.monotonic() + 300
            steps = []
            while time.monotonic() < deadline and proc.poll() is None:
                if os.path.exists(tl):
                    with open(tl) as f:
                        steps = [json.loads(l)["step"] for l in f if l.endswith("\n")]
                if PREEMPT_AT in steps:
                    break
                time.sleep(0.05)
            check(proc.poll() is None and PREEMPT_AT in steps,
                  f"the training process reached steps {steps} and exit {proc.poll()}")
            t_sig = time.monotonic()
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=GRACE_SECS + 30)
            exit_s = time.monotonic() - t_sig
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    with open(tl) as f:
        stopped = [json.loads(l)["step"] for l in f][-1]
    committed = ckpt.latest_step(ck)
    print(f"[i] preemption: SIGTERM after step {PREEMPT_AT} -> exit {rc} in "
          f"{exit_s:.2f} s (grace {GRACE_SECS:.0f} s), stopped after step "
          f"{stopped}, committed step {committed}")
    if rc != 0:
        with open(log_path) as f:
            print(f.read()[-4000:])
    check(rc == 0 and exit_s <= GRACE_SECS, "SIGTERM did not lead to exit 0 within the grace period")
    check(committed == stopped < PREEMPT_STEPS, "no committed marker at the step it stopped on")
    rest = _train_main(tmp, "after-preempt", "--steps", str(PREEMPT_STEPS),
                       "--checkpoint-dir", ck, "--checkpoint-every", "100", args=RESUME_ARGS)
    print(f"[i] second incarnation resumed from step {committed} and ran steps "
          f"{sorted(rest)}, committed step {ckpt.latest_step(ck)}")
    check(sorted(rest) == list(range(committed + 1, PREEMPT_STEPS + 1))
          and ckpt.latest_step(ck) == PREEMPT_STEPS, "the resumed incarnation did not finish")
    return dict(exit_s=exit_s, stopped=stopped)


GRAD_GROUPS = {
    "embed": ("embed",),
    "attention": ("wq", "wk", "wv", "wo"),
    "mlp": ("w_gate", "w_up", "w_down"),
    "norms": ("attn_norm", "mlp_norm", "final_norm"),
    "lm_head": ("lm_head",),
}
TOP_LEAVES = ("embed", "final_norm", "lm_head")  # the rest have a layer axis


def _named_grads(cfg, params, tokens):
    """(loss, {leaf name: gradient}) of one step; layer leaves keep their
    [n_layers] axis."""
    import torch

    from hivedscheduler_tpu_torch.parallel import train as port_train

    named = {n: x for n, x in params.items() if n != "layers"}
    named.update(params["layers"])
    for leaf in named.values():
        leaf.requires_grad_(True)
    loss = port_train.loss_fn(params, tokens, cfg, ce_chunk=EVAL_CE_CHUNK)
    grads = torch.autograd.grad(loss, list(named.values()))
    return float(loss.detach()), dict(zip(named, grads))


def _group_errs(grads, ref):
    """({group: relative Frobenius over its leaves}, worst relative error of
    one (leaf, layer) slice)."""
    out = {}
    for group, names in GRAD_GROUPS.items():
        num = sum(float((grads[n] - ref[n]).norm()) ** 2 for n in names)
        den = sum(float(ref[n].norm()) ** 2 for n in names)
        out[group] = (num / den) ** 0.5
    worst = 0.0
    for n, g in grads.items():
        pairs = [(g, ref[n])] if n in TOP_LEAVES else zip(g, ref[n])
        for a, b in pairs:
            worst = max(worst, float((a - b).norm() / b.norm()))
    return out, worst


def phase_train_grads(model=EVAL_MODEL, tag="[h]", what="one flagship step") -> None:
    import numpy as np
    import torch

    from hivedscheduler_tpu_torch.models import transformer as tm
    from hivedscheduler_tpu_torch.ops import attention as attn
    from hivedscheduler_tpu_torch.parallel import data as data_lib

    # the weights and first batch of train's run
    cfg_f = tm.TransformerConfig(max_seq_len=EVAL_SEQ, attn_impl="flash",
                                 remat="dots", **model)
    cfg_x = dataclasses.replace(cfg_f, attn_impl="xla")
    params = tm.init_params(cfg_f, torch.Generator(device="cuda").manual_seed(0), "cuda")
    loader = data_lib.CheckpointableBatches(
        data_lib.synthetic_dataset(cfg_f.vocab_size), EVAL_BATCH, EVAL_SEQ)
    tokens = torch.from_numpy(np.asarray(next(loader))).cuda()
    loss_x, g_x = _named_grads(cfg_x, params, tokens)
    loss_f, g_f = _named_grads(cfg_f, params, tokens)

    real = attn.flash_backward
    calls = []

    def zero_last_layer_dq(*a, **kw):
        dq, dk, dv = real(*a, **kw)
        calls.append(1)
        # the backward meets the last layer first
        return (torch.zeros_like(dq) if len(calls) == 1 else dq), dk, dv

    attn.flash_backward = zero_last_layer_dq
    try:
        _, g_bad = _named_grads(cfg_f, params, tokens)
    finally:
        attn.flash_backward = real
    torch.cuda.synchronize()
    check(all(bool(torch.isfinite(g).all()) for g in g_f.values()), "non-finite flash gradients")
    groups, worst = _group_errs(g_f, g_x)
    bad_groups, bad_worst = _group_errs(g_bad, g_x)
    print(f"{tag} {what}, loss flash {loss_f:.6f} xla {loss_x:.6f}; "
          f"gradients flash vs xla by group: "
          + ", ".join(f"{k} {v:.3e}" for k, v in groups.items())
          + f" (<= {TRAIN_GRAD_REL}); worst (leaf, layer) {worst:.3e} (<= {TRAIN_GRAD_SLICE_REL})")
    print(f"{tag} planted fault (last layer's dq zeroed): "
          + ", ".join(f"{k} {v:.3e}" for k, v in bad_groups.items())
          + f"; worst (leaf, layer) {bad_worst:.3e}")
    check(len(calls) == cfg_f.n_layers, f"planted run made {len(calls)} backward calls")
    check(abs(loss_f - loss_x) <= LOSS_ATOL, "flash and xla train losses disagree")
    check(all(v <= TRAIN_GRAD_REL for v in groups.values()) and worst <= TRAIN_GRAD_SLICE_REL,
          "flash and xla gradients disagree")
    check(bad_groups["attention"] > TRAIN_GRAD_REL or bad_worst > TRAIN_GRAD_SLICE_REL,
          "the gradient check does not see the planted fault")
    del params, g_x, g_f, g_bad
    torch.cuda.empty_cache()


# phase (j): decode and generate at the flagship width, bench_model.py's
# decode shape (its line 997): batch 16, prompt 128, 64 new tokens
DEC_BATCH, DEC_PROMPT, DEC_NEW, DEC_GAMMA = 16, 128, 64, 4
# the flagship's width at 3 of its 6 layers (the script's time limit)
DEC_MODEL = dict(EVAL_MODEL, n_layers=3)
DEC_ARGS = [a for k, v in DEC_MODEL.items()
            for a in (f"--{k.replace('_', '-')}", str(v))] + [
    "--batch", str(DEC_BATCH), "--prompt-len", str(DEC_PROMPT),
    "--new-tokens", str(DEC_NEW), "--device", "cuda"]
# decode logits (advance: the prompt, then one token a step) against the
# full forward (attn xla) on the same sequence, per position:
# ||l_inc - l_full||_F / ||l_full||_F over batch and vocab. Both are bf16
# through 6 layers with f32 attention; they differ in the matmuls' shapes
# (S = 1 against S = 192), so in rounding only. The limit is HIDDEN_REL's,
# set before the first reading.
DEC_LOGIT_REL = 5e-2
DEC_TIMED = 2  # timed runs of each generate, after one warm-up run
DEC_PROFILED_STEPS = DEC_NEW - 1  # every decode step of one generate


def _decode_sequence(params, cfg, prompt, toks, attention=None):
    """Logits [B, T + N - 1, V] of the prompt and the first N - 1 tokens
    through ``advance``: one prefill of the prompt, then one token a step,
    as ``generate`` runs them. ``attention`` replaces ``_cached_attention``
    (a planted fault)."""
    import torch

    from hivedscheduler_tpu_torch.models import decode as dec

    real = dec._cached_attention
    if attention is not None:
        dec._cached_attention = attention
    try:
        cache = dec.init_kv_cache(cfg, prompt.shape[0], prompt.shape[1] + toks.shape[1], "cuda")
        logits, cache = dec.advance(params, cache, prompt, cfg)
        out = [logits]
        for i in range(toks.shape[1] - 1):
            logits, cache = dec.advance(params, cache, toks[:, i:i + 1], cfg)
            out.append(logits)
    finally:
        dec._cached_attention = real
    return torch.cat(out, dim=1)


def _per_position_rel(x, ref):
    """max over positions t of ||x[:, t] - ref[:, t]||_F / ||ref[:, t]||_F."""
    diff = (x.float() - ref.float()).norm(dim=(0, 2))
    return float((diff / ref.float().norm(dim=(0, 2))).max())


def _decisive(logits_ref, noise: float):
    """Positions whose top-1 margin exceeds twice ``noise``, and the
    reference argmax there (tests/test_quant.py's rule)."""
    top2 = logits_ref.topk(2, dim=-1).values
    return (top2[..., 0] - top2[..., 1]) > 2 * noise, logits_ref.argmax(-1)


def _first_divergence(a, b):
    """First column where two [B, N] token tensors differ in any row, or None."""
    cols = (a != b).any(dim=0).nonzero()
    return int(cols[0]) if len(cols) else None


def _host_ms(fn, reps: int):
    """Host-clock ms of ``fn`` ending in a device sync, ``reps`` times."""
    import torch

    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def _tree_bytes(tree) -> int:
    from hivedscheduler_tpu_torch.parallel import checkpoint as ckpt

    return sum(t.numel() * t.element_size() for t in ckpt.named_leaves(tree).values())


def _decode_rates(name: str, wall_ms: list, weight_bytes: float, kv_bytes: float) -> None:
    """generate's wall time -> tokens/s and bench_model.py's decode roofline
    (its lines 1084-1086): DEC_NEW steps, each streaming every weight byte
    once, over the wall time, against the card's HBM rate."""
    med = sorted(wall_ms)[len(wall_ms) // 2]
    tps = DEC_BATCH * DEC_NEW / (med / 1e3)
    frac = DEC_NEW * weight_bytes / (med / 1e3) / PEAK_HBM_BYTES
    print(f"[j] {name}: generate wall {', '.join(f'{t:.2f}' for t in wall_ms)} ms "
          f"(median {med:.2f}, {med / DEC_NEW:.3f} ms a new token), {tps:.1f} "
          f"tokens/s, HBM roofline fraction "
          f"{frac:.4f} ({DEC_NEW} x {weight_bytes / 1e9:.4f} GB of weights; "
          f"the whole static KV cache the step scores, {kv_bytes / 1e6:.1f} MB, "
          f"is left out as the formula leaves it)")


def _profile_steps(params, cfg, prompt, toks) -> dict:
    """DEC_PROFILED_STEPS decode steps after a prefill: their mean time by
    CUDA events, then the same steps again under torch.profiler (the
    prefill left out of the trace) for the device time they keep busy."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from hivedscheduler_tpu_torch.models import decode as dec

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)

    def steps(prof=None) -> float:
        cache = dec.init_kv_cache(cfg, DEC_BATCH, DEC_PROMPT + DEC_NEW, "cuda")
        _, cache = dec.advance(params, cache, prompt, cfg)
        torch.cuda.synchronize()
        if prof is not None:
            prof.start()
        start.record()
        for i in range(DEC_PROFILED_STEPS):
            _, cache = dec.advance(params, cache, toks[:, i:i + 1], cfg)
        end.record()
        torch.cuda.synchronize()
        if prof is not None:
            prof.stop()
        return start.elapsed_time(end) / DEC_PROFILED_STEPS

    step_ms = steps()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    profiled_ms = steps(prof)
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    parts = {}
    for e in events:
        group = profile_group(e.key)
        parts[group] = parts.get(group, 0.0) + e.self_device_time_total / 1e3 / DEC_PROFILED_STEPS
    return dict(step_ms=step_ms, profiled_step_ms=profiled_ms, busy_ms=sum(parts.values()),
                parts=parts, kernels=sum(e.count for e in events) / DEC_PROFILED_STEPS)


def phase_decode() -> None:
    """Decode and generate at the flagship width: incremental logits against
    the full forward (with a planted fault), greedy tokens against the
    teacher-forced argmax, speculative and int8 agreement, sampling, the
    timings and the CLI."""
    import torch

    from hivedscheduler_tpu_torch.models import decode as dec
    from hivedscheduler_tpu_torch.models import quant
    from hivedscheduler_tpu_torch.models import speculative as spec
    from hivedscheduler_tpu_torch.models import transformer as tm
    from hivedscheduler_tpu_torch.ops import attention as attn

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    cfg = tm.TransformerConfig(max_seq_len=DEC_PROMPT + DEC_NEW, **DEC_MODEL)
    f32 = tm.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    params = tm.cast_params(f32, cfg.dtype)
    q_params = quant.quantize_params(f32, cfg)
    del f32
    prompt = torch.randint(0, cfg.vocab_size, (DEC_BATCH, DEC_PROMPT), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(1))
    weight_bytes = {"bf16": _tree_bytes(params), "int8": _tree_bytes(q_params)}
    check(weight_bytes["bf16"] == 2 * _flagship_params(DEC_MODEL), "bf16 weight bytes")
    kv_bytes = 2.0 * 2 * cfg.n_layers * DEC_BATCH * (DEC_PROMPT + DEC_NEW) * cfg.kv_heads * cfg.head_dim

    # greedy tokens; the flash kernels must not run on the decode path
    attn.FLASH_FWD_LAUNCHES = attn.FLASH_BWD_DQ_LAUNCHES = attn.FLASH_BWD_DKV_LAUNCHES = 0
    toks = dec.generate(params, prompt, cfg, DEC_NEW)
    torch.cuda.synchronize()
    flash = (attn.FLASH_FWD_LAUNCHES, attn.FLASH_BWD_DQ_LAUNCHES, attn.FLASH_BWD_DKV_LAUNCHES)
    check(toks.shape == (DEC_BATCH, DEC_NEW) and int(toks.min()) >= 0
          and int(toks.max()) < cfg.vocab_size, f"generate gave {tuple(toks.shape)}")
    check(flash == (0, 0, 0), f"the decode path launched the flash kernels {flash}")

    # incremental logits against the full forward on the same sequence
    seq = torch.cat([prompt, toks], dim=1)
    with torch.inference_mode():
        full = tm.forward(params, seq[:, :-1], cfg)[:, DEC_PROMPT - 1:]
    inc = _decode_sequence(params, cfg, prompt, toks)[:, DEC_PROMPT - 1:]

    real_attention = dec._cached_attention

    def one_off(q, ck, cv, pos0, scale):
        # every key and value one position late, as if written at pos + 1
        return real_attention(q, ck.roll(1, dims=1), cv.roll(1, dims=1), pos0, scale)

    bad = _decode_sequence(params, cfg, prompt, toks, attention=one_off)[:, DEC_PROMPT - 1:]
    rel, bad_rel = _per_position_rel(inc, full), _per_position_rel(bad, full)
    noise = float((inc - full).abs().max())
    check(bool(torch.isfinite(inc).all()), "non-finite decode logits")
    print(f"[j] decode logits vs the full forward, {DEC_NEW} positions after a "
          f"{DEC_PROMPT}-token prefill (B={DEC_BATCH}): worst position rel "
          f"{rel:.3e} (<= {DEC_LOGIT_REL}), max|err| {noise:.3e}; planted fault "
          f"(K/V one position off): worst position rel {bad_rel:.3e}")
    check(rel <= DEC_LOGIT_REL, "decode logits disagree with the full forward")
    check(bad_rel > DEC_LOGIT_REL, "the decode-logit check does not see the planted fault")

    # greedy tokens: exactly the argmax of the same advance sequence, and the
    # full forward's argmax wherever its top-1 margin is decisive
    exact = int((inc.argmax(-1) != toks).sum())
    decisive, ref_tok = _decisive(full, noise)
    wrong = int((decisive & (ref_tok != toks)).sum())
    first = _first_divergence(ref_tok, toks)
    print(f"[j] greedy generate: {exact} tokens differ from the argmax of the "
          f"same advance sequence; {int(decisive.sum())} of {toks.numel()} "
          f"positions decisive (margin > 2 x {noise:.3e}), {wrong} of them "
          f"differ from the full forward's argmax; first column where any row "
          f"differs from it: {first}")
    check(exact == 0 and wrong == 0, "greedy tokens disagree with the argmax")
    check(bool(decisive.any()), "no decisive position: the greedy check does not bite")

    # int8 weights: logit noise against bf16 on the same sequence, argmax
    # agreement at decisive positions
    inc_q = _decode_sequence(q_params, cfg, prompt, toks)[:, DEC_PROMPT - 1:]
    q_noise = float((inc_q - inc).abs().max())
    q_rel = _per_position_rel(inc_q, inc)
    q_dec, bf_tok = _decisive(inc, q_noise)
    q_wrong = int((q_dec & (inc_q.argmax(-1) != bf_tok)).sum())
    toks_q = dec.generate(q_params, prompt, cfg, DEC_NEW)
    print(f"[j] int8 vs bf16 logits: max|err| {q_noise:.3e}, worst position rel "
          f"{q_rel:.3e}; {int(q_dec.sum())} decisive positions, {q_wrong} argmax "
          f"disagreements there; int8 generate agrees with bf16 on "
          f"{float((toks_q == toks).float().mean()):.3f} of tokens, first "
          f"divergence at column {_first_divergence(toks_q, toks)}")
    check(q_wrong == 0 and bool(torch.isfinite(inc_q).all()), "int8 argmax disagrees at decisive positions")

    # speculative decoding with a 1-layer draft
    d_cfg = spec.derive_draft_config(cfg, 1)
    d_params = tm.cast_params(tm.init_params(
        d_cfg, torch.Generator(device="cuda").manual_seed(3), "cuda"), d_cfg.dtype)
    toks_s, stats = spec.generate_speculative(params, d_params, prompt, cfg, d_cfg,
                                              DEC_NEW, gamma=DEC_GAMMA)
    with torch.inference_mode():
        full_s = tm.forward(params, torch.cat([prompt, toks_s], 1)[:, :-1], cfg)[:, DEC_PROMPT - 1:]
    s_dec, s_ref = _decisive(full_s, noise)
    s_wrong = int((s_dec & (s_ref != toks_s)).sum())
    acc_rate = stats.accepted / max(1, stats.drafted)
    print(f"[j] speculative (draft: 1 layer, d_model {d_cfg.d_model}, gamma "
          f"{DEC_GAMMA}): {stats.rounds} rounds, {stats.accepted}/{stats.drafted} "
          f"accepted ({acc_rate:.3f}); agrees with greedy generate on "
          f"{float((toks_s == toks).float().mean()):.3f} of tokens, first "
          f"divergence at column {_first_divergence(toks_s, toks)}; {s_wrong} of "
          f"{int(s_dec.sum())} decisive positions differ from the target's argmax")
    check(s_wrong == 0 and bool(s_dec.any()), "speculative tokens disagree with the target's argmax")

    # sampling: top_k=1 draws a top-1 token at every step, so it equals
    # greedy up to the first tie at the top (bf16 logits tie often); a
    # fixed generator repeats
    def sampled(seed, **kw):
        return dec.generate(params, prompt, cfg, DEC_NEW, generator=torch.Generator(
            device="cuda").manual_seed(seed), **kw)

    top1 = sampled(2, temperature=1.0, top_k=1)
    top1_logits = _decode_sequence(params, cfg, prompt, top1)[:, DEC_PROMPT - 1:]
    all_top1 = bool((top1_logits.gather(-1, top1[..., None])[..., 0]
                     == top1_logits.amax(-1)).all())
    div = _first_divergence(top1, toks)
    tie_at_div = True
    if div is not None:
        rows = top1[:, div] != toks[:, div]
        at = inc[rows, div]  # greedy's logits there, on the shared prefix
        tie_at_div = bool((at.gather(-1, top1[rows, div][:, None])[:, 0] == at.amax(-1)).all())
    s_a = sampled(2, temperature=0.8, top_p=0.9)
    s_b = sampled(2, temperature=0.8, top_p=0.9)
    print(f"[j] sampling: top_k=1 drew a top-1 token at every step: {all_top1}; "
          f"equals greedy up to column {div} (a tie at the top there: {tie_at_div}); "
          f"two runs from one seed (temperature 0.8, top_p 0.9) equal: "
          f"{torch.equal(s_a, s_b)}; agreement with greedy "
          f"{float((s_a == toks).float().mean()):.3f}")
    check(all_top1 and tie_at_div, "top_k=1 sampling drew a token that is not top-1")
    check(torch.equal(s_a, s_b), "a seeded sampled run does not repeat")

    # timings, after the warm-up runs above
    _decode_rates("bf16", _host_ms(
        lambda: dec.generate(params, prompt, cfg, DEC_NEW), DEC_TIMED), weight_bytes["bf16"], kv_bytes)
    _decode_rates("int8", _host_ms(
        lambda: dec.generate(q_params, prompt, cfg, DEC_NEW), DEC_TIMED), weight_bytes["int8"], kv_bytes)
    _decode_rates("speculative", _host_ms(
        lambda: spec.generate_speculative(params, d_params, prompt, cfg, d_cfg, DEC_NEW,
                                          gamma=DEC_GAMMA), DEC_TIMED), weight_bytes["bf16"], kv_bytes)
    prefill_ms = _host_ms(lambda: dec.advance(
        params, dec.init_kv_cache(cfg, DEC_BATCH, DEC_PROMPT + DEC_NEW, "cuda"), prompt, cfg), 3)
    for name, p in (("bf16", params), ("int8", q_params)):
        step_bound_ms = (weight_bytes[name] + kv_bytes) / PEAK_HBM_BYTES * 1e3
        prof = _profile_steps(p, cfg, prompt, toks)
        print(f"[j] {name} decode step (B={DEC_BATCH}, cache {DEC_PROMPT + DEC_NEW}): "
              f"{prof['step_ms']:.3f} ms by CUDA events over {DEC_PROFILED_STEPS} "
              f"steps, {DEC_BATCH / prof['step_ms'] * 1e3:.1f} tokens/s; bound "
              f"{step_bound_ms:.4f} ms (weights and KV at {PEAK_HBM_BYTES / 1e12} "
              f"TB/s), {step_bound_ms / prof['step_ms']:.4f} of it; under the "
              f"profiler {prof['profiled_step_ms']:.3f} ms a step, "
              + (f"device busy {prof['busy_ms']:.3f} ms a step "
                 f"({prof['busy_ms'] / prof['step_ms']:.1%} of the unprofiled step: "
                 + ", ".join(f"{k} {v:.3f} ms" for k, v in prof["parts"].items())
                 + f"), {prof['kernels']:.0f} kernels a step" if prof["busy_ms"] > 0 else
                 "device busy not measured (the profiler recorded no device time)"))
    print(f"[j] prefill of {DEC_BATCH} x {DEC_PROMPT} tokens: "
          f"{', '.join(f'{t:.2f}' for t in prefill_ms)} ms")

    # the CLI, once, as a subprocess on the card
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "hivedscheduler_tpu_torch.generate"] + DEC_ARGS,
                          cwd=REPO, capture_output=True, text=True, timeout=300)
    cli_s = time.perf_counter() - t0
    rows = [line.split() for line in proc.stdout.splitlines()]
    ok = (proc.returncode == 0 and len(rows) == DEC_BATCH
          and all(len(r) == DEC_NEW and all(t.isdigit() for t in r) for r in rows))
    timing = [l for l in proc.stderr.splitlines() if "generated" in l]
    print(f"[j] python -m hivedscheduler_tpu_torch.generate (flagship, B={DEC_BATCH}): "
          f"exit {proc.returncode} in {cli_s:.1f} s, {len(rows)} rows; "
          f"{timing[-1].split('] ')[-1] if timing else 'no timing line'}")
    if not ok:
        print(proc.stderr[-4000:])
    check(ok, "the generate CLI did not print its rows")
    del params, q_params, d_params
    torch.cuda.empty_cache()
    print(f"[j] phase wall time {time.perf_counter() - t_phase:.1f} s")


# phase (k): the serving engine at the flagship width, bench_model.py's
# serving trace (bench_serving, its lines 236-283, at its real arguments,
# lines 1111-1118): 16 requests, prompts of 4-64 tokens, budget 32,
# max_batch 16, max_len 128 + budget, one arrival every 2 engine steps
SRV_REQUESTS, SRV_BATCH, SRV_BUDGET, SRV_ARRIVAL = 16, 16, 32, 2
SRV_MAX_LEN = 128 + SRV_BUDGET
SRV_STEPS, SRV_PAGE, SRV_CHUNK, SRV_SYSTEM = 8, 16, 32, 24
SRV_TIMED = 3  # timed runs of each engine, after the checked run
SRV_NOISE_ROWS = 4  # requests whose engine-path logits set the noise
SRV_RUNS = {  # the four runs that must be token-identical
    "dense eager": {},
    "dense graph": dict(decode_steps=SRV_STEPS),
    "paged eager": dict(page_size=SRV_PAGE),
    "paged graph": dict(page_size=SRV_PAGE, decode_steps=SRV_STEPS),
}
# bench_serving_paged_ab's real shape (bench_model.py:1099-1107): 32
# mixed-length requests, max_len 512, page 16, budget 16; dense with 4
# slots against paged with 16 slots over 4 * 32 + 1 blocks (equal KV bytes)
AB_REQUESTS, AB_MAX_LEN, AB_BUDGET, AB_DENSE, AB_PAGED = 32, 512, 16, 4, 16
# bench_serving_kv_int8's long-context shape: batch 8, context 1024, 48 new
KV8_BATCH, KV8_CTX, KV8_NEW = 8, 1024, 48
SRV_CLI_ARGS = [a for k, v in EVAL_MODEL.items()
                for a in (f"--{k.replace('_', '-')}", str(v))] + [
    "--page-size", str(SRV_PAGE), "--decode-steps", str(SRV_STEPS),
    "--prefix-cache", "4", "--device", "cuda"]
# (k)'s load through the CLI: its request count, slots, arena, budget and
# arrivals (the CLI's own prompts, after a 24-token system prompt)
SRV_LOAD_ARGS = SRV_CLI_ARGS + [
    "--requests", str(SRV_REQUESTS), "--max-batch", str(SRV_BATCH),
    "--max-len", str(SRV_MAX_LEN), "--max-new-tokens", str(SRV_BUDGET),
    "--arrival-every", str(SRV_ARRIVAL)]


def _srv_prompts(vocab: int, n: int, seed: int, lo: int = 4, hi: int = 65,
                 system=()) -> list:
    import numpy as np

    rng = np.random.default_rng(seed)
    return [list(system) + [int(t) for t in rng.integers(0, vocab, int(rng.integers(lo, hi)))]
            for _ in range(n)]


def _serve(eng, prompts, budget: int, arrival_every: int = SRV_ARRIVAL, burst: int = 1):
    """The bench's loop: ``burst`` arrivals every ``arrival_every`` engine
    steps until the trace is in, then steps until every request is done.
    Returns the requests, the ms between CUDA events around the loop (it
    ends in a device sync: every step reads its tokens), the decode steps
    and slot steps it ran, and the most streams resident at once."""
    import torch

    steps0, slot_steps0 = eng.steps, eng.slot_steps
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    pending, reqs, step, peak = list(prompts), [], 0, 0
    torch.cuda.synchronize()
    start.record()
    while pending or any(not r.done for r in reqs):
        if pending and step % arrival_every == 0:
            for _ in range(min(burst, len(pending))):
                reqs.append(eng.submit(list(pending.pop(0)), budget))
        eng.step()
        peak = max(peak, sum(s is not None for s in eng.slots))
        step += 1
    end.record()
    torch.cuda.synchronize()
    return dict(reqs=reqs, ms=start.elapsed_time(end), steps=eng.steps - steps0,
                slot_steps=eng.slot_steps - slot_steps0, peak=peak)


def _serve_stats(run: dict, max_batch: int) -> dict:
    reqs = run["reqs"]
    toks = sum(len(r.tokens_out) for r in reqs)
    ttft = sorted(r.ttft_s * 1e3 for r in reqs)
    tpot = sorted(r.tpot_s * 1e3 for r in reqs if r.tpot_s is not None)
    return dict(tps=toks / (run["ms"] / 1e3), rps=len(reqs) / (run["ms"] / 1e3),
                occ=run["slot_steps"] / (run["steps"] * max_batch) if run["steps"] else 0.0,
                ttft_p50=ttft[len(ttft) // 2], ttft_max=ttft[-1],
                tpot_p50=tpot[len(tpot) // 2], tpot_max=tpot[-1], peak=run["peak"])


def _streams(run: dict) -> list:
    return [r.tokens_out for r in run["reqs"]]


def _teacher_forced(params, cfg, prompts, streams):
    """Full-forward logits at the positions that emitted each stream's
    tokens: the prompt's last position, then each fed-back token. [N_i, V]
    per request."""
    import torch

    from hivedscheduler_tpu_torch.models import transformer as tm

    out = []
    with torch.inference_mode():
        for p, s in zip(prompts, streams):
            seq = torch.tensor([p + s[:-1]], device="cuda")
            out.append(tm.forward(params, seq, cfg)[0, len(p) - 1:].float())
    return out


def _decisive_misses(full, streams, noise: float):
    """(decisive positions, of which the stream's token is not the full
    forward's argmax)."""
    n = miss = 0
    for logits, s in zip(full, streams):
        dec, ref = _decisive(logits, noise)
        tok = logits.new_tensor(s, dtype=ref.dtype)
        n += int(dec.sum())
        miss += int((dec & (ref != tok)).sum())
    return n, miss


def _parts_at_ties(full, streams_a, streams_b, noise: float):
    """Requests where two streams part at a decisive position of a's full
    forward (parting at a near-tie, margin <= 2 x noise, is rounding), and
    the number of requests that part at all."""
    bad = parted = 0
    for logits, a, b in zip(full, streams_a, streams_b):
        p = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if p is None:
            continue
        parted += 1
        dec, _ = _decisive(logits[p:p + 1], noise)
        bad += int(dec.any())
    return bad, parted


def _engine_logits(params, cfg, prompt, stream, kv_dtype=None):
    """The engine path's logits for one request, teacher-forced: a bucketed
    prefill into row 0 of a SRV_BATCH-row ragged cache, then one decode
    step a token with the other rows idle, as the engine runs them."""
    import torch

    from hivedscheduler_tpu_torch.models import serving as srv

    cache = srv.init_ragged_cache(cfg, SRV_BATCH, SRV_MAX_LEN, kv_dtype, "cuda")
    bucket = min(SRV_MAX_LEN, 1 << max(1, (len(prompt) - 1).bit_length()))
    toks = torch.tensor([prompt + [0] * (bucket - len(prompt))], device="cuda")
    logits, _ = srv.advance_ragged(params, cache, toks, cfg, row=0, start=0)
    out = [logits[0, len(prompt) - 1]]
    cache.lengths[0] = len(prompt)
    last = torch.zeros((SRV_BATCH, 1), dtype=torch.long, device="cuda")
    for t in stream[:-1]:
        last[0, 0] = t
        logits, _ = srv.advance_ragged(params, cache, last, cfg)
        out.append(logits[0, 0])
    return torch.stack(out).float()


def _graph_window_profile(eng) -> dict:
    """One window of the engine's captured graph (SRV_STEPS replays): its
    ms by CUDA events, then the same window under torch.profiler for the
    device time it keeps busy."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    graph = eng._window.graph
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(3):
        start.record()
        for _ in range(SRV_STEPS):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    for _ in range(SRV_STEPS):
        graph.replay()
    torch.cuda.synchronize()
    prof.stop()
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    parts = {}
    for e in events:
        group = profile_group(e.key)
        parts[group] = parts.get(group, 0.0) + e.self_device_time_total / 1e3 / SRV_STEPS
    return dict(window_ms=sorted(times)[1], busy_ms=sum(parts.values()) * SRV_STEPS,
                parts=parts, kernels=sum(e.count for e in events) / SRV_STEPS)


def phase_serving() -> dict:
    """The continuous-batching engine at the flagship width: four runs of
    one trace (dense and paged, eager and graph) token-identical and held to
    the full forward at decisive positions, with planted faults; int8 KV;
    chunked prefill and the prefix cache; drain; the times; the CLI.
    Returns the trace's prompts, the dense eager streams, their
    teacher-forced full-forward logits and the engine path's noise, which
    (p) holds the speculative engine to."""
    import torch

    from hivedscheduler_tpu_torch.chaos import invariants as inv
    from hivedscheduler_tpu_torch.models import serving as srv
    from hivedscheduler_tpu_torch.models import transformer as tm
    from hivedscheduler_tpu_torch.ops import attention as attn

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    cfg = tm.TransformerConfig(max_seq_len=SRV_MAX_LEN, **EVAL_MODEL)
    params = tm.cast_params(tm.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda"), cfg.dtype)
    weight_bytes = _tree_bytes(params)
    prompts = _srv_prompts(cfg.vocab_size, SRV_REQUESTS, seed=2)

    def engine(**kw):
        kw = dict(dict(max_batch=SRV_BATCH, max_len=SRV_MAX_LEN), **kw)
        return srv.ServingEngine(params, cfg, **kw)

    # the four runs: token-identical, K1-K3 never launched, the pool clean,
    # the graph used and never bypassed
    attn.FLASH_FWD_LAUNCHES = attn.FLASH_BWD_DQ_LAUNCHES = attn.FLASH_BWD_DKV_LAUNCHES = 0
    engines, runs = {}, {}
    for name, kw in SRV_RUNS.items():
        engines[name] = engine(**kw)
        runs[name] = _serve(engines[name], prompts, SRV_BUDGET)
        if engines[name].paged:
            inv.check_block_pool(engines[name], name)
            check(engines[name].blocks_in_use == 0, f"{name}: blocks left in use")
        if engines[name].decode_steps > 1:
            check(engines[name].graph_windows == engines[name].fused_windows > 0,
                  f"{name}: windows did not run through the CUDA graph")
    flash = (attn.FLASH_FWD_LAUNCHES, attn.FLASH_BWD_DQ_LAUNCHES, attn.FLASH_BWD_DKV_LAUNCHES)
    ref = _streams(runs["dense eager"])
    same = {name: sum(a != b for a, b in zip(_streams(run), ref)) for name, run in runs.items()}
    check(all(len(s) == SRV_BUDGET for s in ref), "a stream fell short of its budget")
    print(f"[k] four runs of {SRV_REQUESTS} requests (prompts "
          f"{min(map(len, prompts))}-{max(map(len, prompts))}, budget {SRV_BUDGET}, "
          f"max_batch {SRV_BATCH}, max_len {SRV_MAX_LEN}): requests whose stream differs "
          f"from dense eager: {same}; K1-K3 launches {flash}; windows through the graph: "
          + ", ".join(f"{n} {e.graph_windows}/{e.fused_windows}"
                      for n, e in engines.items() if e.decode_steps > 1))
    check(all(v == 0 for v in same.values()), "dense/paged, eager/graph streams differ")
    check(flash == (0, 0, 0), f"the serving path launched the flash kernels {flash}")

    # each stream against a teacher-forced full forward, at decisive
    # positions; noise = the engine path's logits against the full forward
    full = _teacher_forced(params, cfg, prompts, ref)
    eng_logits = [_engine_logits(params, cfg, prompts[i], ref[i]) for i in range(SRV_NOISE_ROWS)]
    noise = max(float((e - f).abs().max()) for e, f in zip(eng_logits, full))
    n_dec, miss = _decisive_misses(full, ref, noise)

    class OffByOne(srv.ServingEngine):
        """Planted fault: every row's length one too long after its prefill."""

        def _set_row_length(self, slot, n):
            super()._set_row_length(slot, min(n + 1, self.max_len - 1))

    bad_run = _serve(OffByOne(params, cfg, max_batch=SRV_BATCH, max_len=SRV_MAX_LEN),
                     prompts, SRV_BUDGET)
    bad_n, bad_miss = _decisive_misses(_teacher_forced(params, cfg, prompts, _streams(bad_run)),
                                       _streams(bad_run), noise)
    print(f"[k] streams vs the teacher-forced full forward: {miss} of {n_dec} decisive "
          f"positions differ (margin > 2 x {noise:.3e}, the engine path's max |logit err| "
          f"on requests 0-{SRV_NOISE_ROWS - 1}); planted fault (row lengths one off): {bad_miss} of {bad_n}")
    check(miss == 0 and n_dec > 0, "engine streams disagree with the full forward")
    check(bad_miss > 0, "the stream check does not see the planted length fault")
    probe = engine(page_size=SRV_PAGE)
    for p in prompts[:4]:
        probe.submit(p, SRV_BUDGET)
    probe.step()
    row = next(s for s in range(SRV_BATCH) if len(probe._slot_bids[s]) > 1)
    probe._table[row, [0, 1]] = probe._table[row, [1, 0]]
    try:
        inv.check_block_pool(probe, "planted")
        caught = "not caught"
    except inv.InvariantViolation as err:
        caught = str(err)
    print(f"[k] planted swapped table entry: {caught}")
    check(caught != "not caught", "the pool check does not see a swapped table entry")
    del probe

    # int8 KV: logits against bf16 KV on the engine path, and dense
    # against paged token for token
    q_logits = _engine_logits(params, cfg, prompts[0], ref[0], kv_dtype="int8")
    q_err = float((q_logits - eng_logits[0]).abs().max())
    q_rel = float(((q_logits - eng_logits[0]).norm(dim=-1) / eng_logits[0].norm(dim=-1)).max())
    q_runs = {}
    for name, kw in (("dense", {}), ("paged", dict(page_size=SRV_PAGE))):
        q_runs[name] = _serve(engine(kv_dtype="int8", decode_steps=SRV_STEPS, **kw),
                              prompts, SRV_BUDGET)
    q_same = sum(a != b for a, b in zip(_streams(q_runs["dense"]), _streams(q_runs["paged"])))
    q_bad, q_parted = _parts_at_ties(full, ref, _streams(q_runs["dense"]), noise + q_err)
    print(f"[k] int8 KV vs bf16 KV logits (request 0, {len(ref[0])} positions): max|err| "
          f"{q_err:.3e}, worst position rel {q_rel:.3e} (<= {DEC_LOGIT_REL}); int8 dense "
          f"vs int8 paged (graph): {q_same} requests differ; int8 streams part from bf16 "
          f"in {q_parted} requests, {q_bad} of them at a decisive position (margin > 2 x "
          f"{noise + q_err:.3e})")
    check(q_rel <= DEC_LOGIT_REL, "int8 KV logits too far from bf16 KV")
    check(q_same == 0, "int8 dense and int8 paged streams differ")
    check(q_bad == 0, "int8 KV streams part from bf16 at a decisive position")

    # chunked prefill and the prefix cache over a shared system prompt
    system = _srv_prompts(cfg.vocab_size, 1, seed=7, lo=SRV_SYSTEM, hi=SRV_SYSTEM + 1)[0]
    sys_prompts = _srv_prompts(cfg.vocab_size, SRV_REQUESTS, seed=8, system=system)
    plain = _serve(engine(), sys_prompts, SRV_BUDGET)
    sys_full = _teacher_forced(params, cfg, sys_prompts, _streams(plain))
    sys_dec, sys_miss = _decisive_misses(sys_full, _streams(plain), noise)
    chunked = {}
    for name, kw in (("chunked dense", dict(prefill_chunk=SRV_CHUNK, prefix_cache_size=4)),
                     ("chunked paged graph", dict(prefill_chunk=SRV_CHUNK, prefix_cache_size=4,
                                                  page_size=SRV_PAGE, decode_steps=SRV_STEPS))):
        eng = engine(**kw)
        run = _serve(eng, sys_prompts, SRV_BUDGET)
        bad, parted = _parts_at_ties(sys_full, _streams(plain), _streams(run), noise)
        chunked[name] = (eng, bad, parted)
        if eng.paged:
            inv.check_block_pool(eng, name)
    print(f"[k] system prompt {SRV_SYSTEM} tokens + tails 4-64, chunk {SRV_CHUNK}: plain "
          f"streams vs the full forward {sys_miss} of {sys_dec} decisive positions differ; "
          + "; ".join(f"{n}: {e.prefix_hits} prefix hits, {e.prefix_tokens_reused} tokens "
                      f"reused, {e.prefill_chunks_done} chunks, {parted} requests part from "
                      f"plain, {bad} of them at a decisive position"
                      for n, (e, bad, parted) in chunked.items()))
    check(sys_miss == 0, "plain streams disagree with the full forward")
    check(all(bad == 0 and e.prefix_hits > 0 for e, bad, _ in chunked.values()),
          "chunked or prefix-cached streams part from plain at a decisive position")

    # drain: a busy paged engine, deadline 0
    busy = engine(page_size=SRV_PAGE, decode_steps=SRV_STEPS)
    for p in prompts:
        busy.submit(p, SRV_BUDGET)
    for _ in range(2):
        busy.step()
    in_use = busy.blocks_in_use
    drained = busy.drain(deadline_s=0.0)
    inv.check_block_pool(busy, "after drain")
    print(f"[k] drain(deadline_s=0) on a busy paged engine ({in_use} blocks in use): "
          f"returned {drained}, {busy.blocks_in_use} blocks in use after, pool check clean")
    check(drained is False and busy.blocks_in_use == 0, "drain left work or blocks behind")
    del busy

    # times: the four runs, median of SRV_TIMED after the checked run
    for name, eng in engines.items():
        timed = [_serve(eng, prompts, SRV_BUDGET) for _ in range(SRV_TIMED)]
        check(all(_streams(t) == ref for t in timed), f"{name}: a timed run's streams differ")
        stats = sorted((_serve_stats(t, SRV_BATCH) for t in timed), key=lambda s: s["tps"])
        st = stats[len(stats) // 2]
        print(f"[k] {name}: {', '.join(f'{s['tps']:.1f}' for s in stats)} tokens/s (median "
              f"{st['tps']:.1f}), occupancy {st['occ']:.3f}, TTFT p50 {st['ttft_p50']:.2f} ms "
              f"max {st['ttft_max']:.2f} ms, TPOT p50 {st['tpot_p50']:.3f} ms max "
              f"{st['tpot_max']:.3f} ms")

    # the decode step, eager against graph, on a full batch
    eng = engines["dense graph"]
    for p in prompts:
        eng.submit(p, SRV_BUDGET)
    eng.step()
    eager_ms = min(time_ms(eng._decode_once, 10) for _ in range(3))
    graph_ms = min(time_ms(eng._window.graph.replay, 40) for _ in range(3))
    prof = _graph_window_profile(eng)
    kv_bytes = 2.0 * 2 * cfg.n_layers * SRV_BATCH * SRV_MAX_LEN * cfg.kv_heads * cfg.head_dim
    bound_ms = (weight_bytes + kv_bytes) / PEAK_HBM_BYTES * 1e3
    print(f"[k] decode step (B={SRV_BATCH}, cache {SRV_MAX_LEN}): eager {eager_ms:.3f} ms, "
          f"graph {graph_ms:.3f} ms a step ({eager_ms / graph_ms:.2f}x; with every slot busy "
          f"{SRV_BATCH / eager_ms * 1e3:.1f} against {SRV_BATCH / graph_ms * 1e3:.1f} "
          f"tokens/s); bound {bound_ms:.4f} "
          f"ms ({weight_bytes / 1e9:.4f} GB weights + {kv_bytes / 1e6:.1f} MB KV at "
          f"{PEAK_HBM_BYTES / 1e12} TB/s), graph step at {bound_ms / graph_ms:.3f} of it; one "
          f"graph window of {SRV_STEPS}: {prof['window_ms']:.3f} ms, "
          + (f"device busy {prof['busy_ms']:.3f} ms ({prof['busy_ms'] / prof['window_ms']:.1%}; "
             "a step: " + ", ".join(f"{k} {v:.3f} ms" for k, v in prof["parts"].items())
             + f"), {prof['kernels']:.0f} kernels a step" if prof["busy_ms"] > 0 else
             "device busy not measured (the profiler recorded no device time)"))
    del engines, eng

    # the paged A/B at equal KV bytes
    rng_prompts = []
    import numpy as np

    rng = np.random.default_rng(11)
    for i in range(AB_REQUESTS):
        u = i % 20
        if u < 12:
            plen = int(rng.integers(4, 13))
        elif u < 17:
            plen = max(4, AB_MAX_LEN // 4 + int(rng.integers(-4, 5)))
        else:
            plen = max(8, AB_MAX_LEN // 2 + int(rng.integers(-4, 5)))
        plen = min(plen, AB_MAX_LEN - AB_BUDGET - 1)
        rng_prompts.append([int(t) for t in rng.integers(0, cfg.vocab_size, plen)])
    nbs = -(-AB_MAX_LEN // SRV_PAGE)
    ab = {}
    for name, kw in (("dense", dict(max_batch=AB_DENSE)),
                     ("paged", dict(max_batch=AB_PAGED, page_size=SRV_PAGE,
                                    num_blocks=AB_DENSE * nbs + 1))):
        eng = srv.ServingEngine(params, cfg, max_len=AB_MAX_LEN, decode_steps=SRV_STEPS, **kw)
        _serve(eng, rng_prompts[:4], 2, arrival_every=1, burst=4)  # warm: the graph
        runs_ab = [_serve(eng, rng_prompts, AB_BUDGET, arrival_every=1, burst=3)
                   for _ in range(SRV_TIMED)]
        ab[name] = (eng, sorted((_serve_stats(r, eng.max_batch) for r in runs_ab),
                                key=lambda s: s["rps"]))
        if eng.paged:
            inv.check_block_pool(eng, "A/B")
    kv_ab = {n: sum(t.numel() * t.element_size() for t in srv._kv_tensors(e.cache or e.pool))
             for n, (e, _) in ab.items()}
    print(f"[k] paged A/B ({AB_REQUESTS} mixed-length requests, max_len {AB_MAX_LEN}, page "
          f"{SRV_PAGE}, budget {AB_BUDGET}, 3 arrivals a step, decode_steps {SRV_STEPS}): "
          + "; ".join(f"{n} ({e.max_batch} slots, {kv_ab[n] / 1e6:.1f} MB KV): "
                      f"{', '.join(f'{s['rps']:.2f}' for s in st)} requests/s, peak "
                      f"{st[1]['peak']} streams, TTFT p50 {st[1]['ttft_p50']:.1f} ms"
                      for n, (e, st) in ab.items()))
    del ab, eng

    # float against int8 KV, long context
    kv8_prompts = _srv_prompts(cfg.vocab_size, KV8_BATCH, seed=9, lo=KV8_CTX, hi=KV8_CTX + 1)
    kv8 = {}
    for kv_dtype in (None, "int8"):
        eng = srv.ServingEngine(params, cfg, max_batch=KV8_BATCH,
                                max_len=KV8_CTX + KV8_NEW + 1, kv_dtype=kv_dtype,
                                decode_steps=SRV_STEPS)
        rates = []
        for _ in range(1 + SRV_TIMED):
            reqs = [eng.submit(list(p), KV8_NEW) for p in kv8_prompts]
            eng.step()  # admit and prefill every row, then the first window
            eng.step()
            before = sum(len(r.tokens_out) for r in reqs)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            eng.run_until_drained()
            end.record()
            torch.cuda.synchronize()
            rates.append((sum(len(r.tokens_out) for r in reqs) - before) /
                         (start.elapsed_time(end) / 1e3))
        kv8["int8" if kv_dtype else "bf16"] = (
            sorted(rates[1:]), sum(t.numel() * t.element_size() for t in srv._kv_tensors(eng.cache)))
        del eng
    print(f"[k] long-context decode (batch {KV8_BATCH}, context {KV8_CTX}, {KV8_NEW} new, "
          f"decode_steps {SRV_STEPS}, after 2 warm steps, CUDA events): "
          + "; ".join(f"{n} KV ({b / 1e6:.1f} MB): {', '.join(f'{r:.1f}' for r in rs)} tokens/s"
                      for n, (rs, b) in kv8.items())
          + f"; weights {weight_bytes / 1e9:.4f} GB")
    del params
    torch.cuda.empty_cache()

    # the CLI, plain and under an injected preemption
    for label, env in (("plain", {}), ("preempted", {"HIVED_FAULT_SERVE_PREEMPT_AT": "3"})):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "hivedscheduler_tpu_torch.serve"]
                              + SRV_CLI_ARGS, cwd=REPO, capture_output=True, text=True,
                              timeout=300, env=dict(os.environ, **env))
        cli_s = time.perf_counter() - t0
        rows = [l for l in proc.stdout.splitlines() if l.startswith("[")]
        said = [l.split("] ", 1)[-1] for l in proc.stderr.splitlines()
                if "tok/s" in l or "preemption drain" in l]
        print(f"[k] python -m hivedscheduler_tpu_torch.serve ({label}): exit "
              f"{proc.returncode} in {cli_s:.1f} s, {len(rows)} request lines; "
              + " | ".join(said))
        ok = proc.returncode == 0 and rows and any("tok/s" in l for l in said)
        if env:
            ok = ok and any("preemption drain" in l for l in said)
        if not ok:
            print(proc.stderr[-4000:])
        check(ok, f"the serve CLI ({label}) did not finish as it should")
    print(f"[k] phase wall time {time.perf_counter() - t_phase:.1f} s")
    return dict(prompts=prompts, ref=ref, full=full, noise=noise)


# phase (l): the mesh path on one card. A tp=2 shard of the flagship holds
# half its heads: q [8, 2048, 8, 128], k/v [8, 2048, 4, 128]
TP_LOCAL = dict(b=8, t=2048, h=8, h_kv=4, d=128)
# mesh losses against the single-device ones when they are not equal: the
# loss limit of (i)'s resume, relative
MESH_LOSS_REL = 1e-3
MESH_CKPT_LAYERS = 2
# rounds of (single, mesh, mesh, single) steps timed in turns
MESH_TURNS = 3


def _tp_local_kernels() -> dict:
    """K1-K3 at the tp-local shapes against their plain versions, with
    (b)'s and (f)'s limits and planted faults, then timed in turns with the
    library at the same shape -> {"fwd", "dq", "dkv": the kernels line's
    max_abs_err and times at that shape (medians of the turns; the plain and
    library backward are the whole backward's)}."""
    import torch
    import torch.nn.functional as F

    from hivedscheduler_tpu_torch.ops import attention as attn

    f = TP_LOCAL
    b, t, h, h_kv, d = f["b"], f["t"], f["h"], f["h_kv"], f["d"]
    q, k, v = make_qkv(b, t, h, h_kv, d, seed=40)
    do = make_qkv(b, t, h, h_kv, d, seed=41)[0]
    o, lse = attn.flash_forward(q, k, v, causal=True)
    o_ref, lse_ref = attn.flash_attention_plain(q, k, v, causal=True)
    got = attn.flash_backward(q, k, v, o, lse, do, causal=True)
    ref = attn.flash_backward_plain(q, k, v, o, lse, do, causal=True)
    torch.cuda.synchronize()
    o_fro, o_row = rel_errs(o, o_ref)
    lse_err = float((lse - lse_ref).abs().max())
    errs = {name: rel_errs(x, r, floor=1e-3) for name, x, r in zip(("dq", "dk", "dv"), got, ref)}
    max_abs = {"fwd": float((o.float() - o_ref.float()).abs().max())}
    max_abs["dq"] = float((got[0].float() - ref[0].float()).abs().max())
    max_abs["dkv"] = max(float((x.float() - r.float()).abs().max())
                         for x, r in zip(got[1:], ref[1:]))
    print(f"[l] K1 at the tp-local shape q [{b},{t},{h},{d}] k/v [{b},{t},{h_kv},{d}] causal: "
          f"o rel {o_fro:.3e} (<= {O_REL}), worst row {o_row:.3e} (<= {O_ROW_REL}), "
          f"max|lse err| {lse_err:.3e} (<= {LSE_ATOL}); K2/K3: "
          + ", ".join(f"{n} rel {fr:.3e} worst row {rw:.3e}" for n, (fr, rw) in errs.items())
          + f" (limits {GRAD_REL}, {GRAD_ROW_REL})")
    check(o_fro <= O_REL and o_row <= O_ROW_REL and lse_err <= LSE_ATOL,
          "K1 disagrees with its plain version at the tp-local shape")
    check(all(fr <= GRAD_REL and rw <= GRAD_ROW_REL for fr, rw in errs.values()),
          "K2/K3 disagree with their plain version at the tp-local shape")
    # planted faults: (b)'s swapped V keys for K1, (f)'s swapped K keys for
    # K2/K3 (o and lse kept)
    v_bad = v.clone()
    v_bad[:, [t - 2, t - 1]] = v[:, [t - 1, t - 2]]
    bad_row = rel_errs(attn.flash_forward(q, k, v_bad, causal=True)[0], o_ref)[1]
    k_bad = k.clone()
    k_bad[:, [t - 2, t - 1]] = k[:, [t - 1, t - 2]]
    bad = attn.flash_backward(q, k_bad, v, o, lse, do, causal=True)
    bad_rows = {n: rel_errs(x, r, floor=1e-3)[1] for n, x, r in zip(("dq", "dk", "dv"), bad, ref)}
    print(f"[l] planted faults at the tp-local shape: K1 (V keys swapped) worst row "
          f"{bad_row:.3e}; K2/K3 (K keys swapped) worst rows "
          + ", ".join(f"{n} {x:.3e}" for n, x in bad_rows.items()))
    check(bad_row > O_ROW_REL, "the tp-local o check does not see a swapped V key pair")
    check(all(x > GRAD_ROW_REL for x in bad_rows.values()),
          "the tp-local gradient checks do not see a swapped K key pair")
    del v_bad, k_bad, bad, o_ref, lse_ref, ref
    torch.cuda.empty_cache()

    _, delta = attn.flash_backward_dq_cuda(q, k, v, o, lse, do)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    qg, kg, vg = (x.clone().requires_grad_(True) for x in (qt, kt, vt))
    out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True, enable_gqa=True)
    dout = do.transpose(1, 2).contiguous()
    timed = {
        "K1": (lambda: attn.flash_forward(q, k, v, causal=True),
               lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                      enable_gqa=True)),
        "K2": (lambda: attn.flash_backward_dq_cuda(q, k, v, o, lse, do), None),
        "K3": (lambda: attn.flash_backward_dkv_cuda(q, k, v, lse, delta, do),
               lambda: torch.autograd.grad(out, (qg, kg, vg), dout, retain_graph=True)),
    }
    flops_f = attn.attention_flops(b, t, h, d, causal=True)
    flops_b = attn.attention_bwd_flops(b, t, h, d, causal=True)
    bytes_f = attn.attention_bytes(b, t, h, h_kv, d)
    bytes_b = attn.attention_bwd_bytes(b, t, h, h_kv, d)
    work = {"K1": (flops_f, bytes_f), "K2": (flops_b["dq"], bytes_b["dq"]),
            "K3": (flops_b["dkv"], bytes_b["dkv"])}
    plain_ms = {"K1": time_ms(lambda: attn.flash_attention_plain(q, k, v, causal=True),
                              iters=2, warmup=1)}
    plain_ms["K2"] = plain_ms["K3"] = time_ms(
        lambda: attn.flash_backward_plain(q, k, v, o, lse, do, causal=True), iters=2, warmup=1)
    # in turns: kernel, library, kernel, library
    readings = {name: ([], []) for name in timed}
    for _ in range(2):
        for name, (kernel, library) in timed.items():
            readings[name][0].append(time_ms(kernel, iters=20, warmup=3))
            if library is not None:
                readings[name][1].append(time_ms(library, iters=20, warmup=3))
    rows = {}
    for name, (kernel_ms, library_ms) in readings.items():
        flops, nbytes = work[name]
        ops_ms, bytes_ms = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
        bound_ms = max(ops_ms, bytes_ms)
        key = {"K1": "fwd", "K2": "dq", "K3": "dkv"}[name]
        rows[key] = dict(max_abs_err=max_abs[key], ms=statistics.median(kernel_ms),
                         plain_ms=plain_ms[name], bound_ms=bound_ms,
                         bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                         library_ms=statistics.median(library_ms or readings["K3"][1]))
        lib = ("library (the whole backward) " if name == "K3" else "library ") + (
            ", ".join(f"{x:.4f}" for x in library_ms) + " ms" if library_ms else
            "(see K3: the library backward computes dq, dk and dv together)")
        print(f"[l] {name} at the tp-local shape: kernel_ms "
              f"{', '.join(f'{x:.4f}' for x in kernel_ms)} (two turns) bound_ms {bound_ms:.4f} "
              f"({'operations' if ops_ms >= bytes_ms else 'bytes'}: {flops / 1e9:.1f} GFLOP, "
              f"{nbytes / 1e6:.1f} MB) -> {bound_ms / min(kernel_ms):.1%} of the bound; "
              f"plain_ms {plain_ms[name]:.3f}{' (the whole backward)' if name != 'K1' else ''}; {lib}")
    del q, k, v, do, o, lse, delta, qt, kt, vt, qg, kg, vg, out, dout
    torch.cuda.empty_cache()
    return rows


def _steps_by_events(step, params, opt, batches) -> tuple:
    """Run ``step`` over ``batches`` -> (losses, ms of each step by CUDA
    events; each step ends in the loss's host read)."""
    import torch

    losses, ms = [], []
    for tokens in batches:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        params, opt, loss = step(params, opt, tokens)
        losses.append(float(loss))
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
    return losses, ms


def _mesh_train(mesh, h_flash: dict) -> None:
    """3 flagship steps on the world-1 mesh against the single-device step
    from the same seed and batches, and against (h)'s CLI losses."""
    import numpy as np
    import torch

    from hivedscheduler_tpu_torch.models import transformer as tm
    from hivedscheduler_tpu_torch.ops import attention as attn
    from hivedscheduler_tpu_torch.parallel import data as data_lib
    from hivedscheduler_tpu_torch.parallel import train as port_train

    cfg = tm.TransformerConfig(max_seq_len=EVAL_SEQ, attn_impl="flash",
                               remat="dots", **EVAL_MODEL)
    loader = data_lib.CheckpointableBatches(
        data_lib.synthetic_dataset(cfg.vocab_size), EVAL_BATCH, EVAL_SEQ)
    host = [np.asarray(next(loader)) for _ in range(TRAIN_STEPS)]

    step, init_fn = port_train.make_train_step(cfg, "cuda", ce_chunk=EVAL_CE_CHUNK)
    params, opt = init_fn(torch.Generator(device="cuda").manual_seed(0))
    plain_tokens = [torch.from_numpy(x).cuda() for x in host]
    single, single_ms = _steps_by_events(step, params, opt, plain_tokens)

    mstep, minit, token_sharding = port_train.make_sharded_train_step(
        cfg, mesh, ce_chunk=EVAL_CE_CHUNK)
    mparams, mopt = minit(torch.Generator(device="cuda").manual_seed(0))
    check(all(type(t).__name__ == "DTensor" for t in port_train._leaves(mparams)),
          "the mesh state is not DTensors")
    tokens = [data_lib.device_put_global(x, token_sharding, EVAL_BATCH) for x in host]
    attn.FLASH_FWD_LAUNCHES = attn.FLASH_BWD_DQ_LAUNCHES = attn.FLASH_BWD_DKV_LAUNCHES = 0
    mesh_losses, mesh_ms = _steps_by_events(mstep, mparams, mopt, tokens)
    launches = {"fwd": attn.FLASH_FWD_LAUNCHES, "dq": attn.FLASH_BWD_DQ_LAUNCHES,
                "dkv": attn.FLASH_BWD_DKV_LAUNCHES}
    layers = EVAL_MODEL["n_layers"]
    want = {"fwd": 2 * layers * TRAIN_STEPS, "dq": layers * TRAIN_STEPS,
            "dkv": layers * TRAIN_STEPS}
    print(f"[l] mesh train (make_sharded_train_step, world 1, NCCL, mesh (1,1,1,1,1,1)): "
          f"losses {mesh_losses}; launches over {TRAIN_STEPS} steps {launches} (want {want})")
    check(launches == want, f"the mesh step launched {launches}, want {want}")
    check(all(math.isfinite(x) for x in mesh_losses), f"non-finite mesh losses {mesh_losses}")
    for name, ref in (("single-device make_train_step", single),
                      ("(h)'s train CLI", h_flash["losses"])):
        equal = mesh_losses == ref
        rel = max(abs(a - b) / abs(b) for a, b in zip(mesh_losses, ref))
        print(f"[l] mesh losses against {name} {ref}: "
              + ("equal" if equal else f"within relative {rel:.3e} (<= {MESH_LOSS_REL})"))
        check(equal or rel <= MESH_LOSS_REL, f"mesh losses disagree with {name}")
    print(f"[l] step ms by CUDA events (B={EVAL_BATCH}, T={EVAL_SEQ}, {layers} layers): mesh "
          f"{', '.join(f'{x:.3f}' for x in mesh_ms)}, single-device "
          f"{', '.join(f'{x:.3f}' for x in single_ms)} (the first of each is the warm-up); "
          f"(h)'s train CLI {h_flash['step_ms']:.3f} ms (its timeline, after the warm-up)")
    # both states stay resident and step in turns (single, mesh, mesh,
    # single), so the two are timed under the same conditions
    turns = {"single-device": [], "mesh": []}
    for _ in range(MESH_TURNS):
        for name in ("single-device", "mesh", "mesh", "single-device"):
            if name == "mesh":
                turns[name] += _steps_by_events(mstep, mparams, mopt, tokens[:1])[1]
            else:
                turns[name] += _steps_by_events(step, params, opt, plain_tokens[:1])[1]
    med = {name: sorted(ms)[len(ms) // 2] for name, ms in turns.items()}
    print(f"[l] step ms in turns ({MESH_TURNS} x single, mesh, mesh, single): "
          + "; ".join(f"{name} {', '.join(f'{x:.3f}' for x in ms)} (median {med[name]:.3f})"
                      for name, ms in turns.items())
          + f"; mesh - single-device {med['mesh'] - med['single-device']:.3f} ms")
    del params, opt, step, mparams, mopt, mstep, tokens, plain_tokens
    torch.cuda.empty_cache()


def _mesh_checkpoint(mesh, model=None, tag="[l]") -> None:
    """A world-1 DTensor train state (flagship width, ``MESH_CKPT_LAYERS``
    layers; ``model`` overrides the flagship's fields) through the
    multi-rank save and restore: bit-identical, with a planted fault."""
    import numpy as np
    import torch
    from torch.distributed.tensor import DTensor

    from hivedscheduler_tpu_torch.models import transformer as tm
    from hivedscheduler_tpu_torch.parallel import checkpoint as ckpt
    from hivedscheduler_tpu_torch.parallel import data as data_lib
    from hivedscheduler_tpu_torch.parallel import topology
    from hivedscheduler_tpu_torch.parallel import train as port_train

    model = {**EVAL_MODEL, "n_layers": MESH_CKPT_LAYERS, **(model or {})}
    cfg = tm.TransformerConfig(max_seq_len=EVAL_SEQ, attn_impl="flash", remat="dots", **model)
    step, init_fn, token_sharding = port_train.make_sharded_train_step(
        cfg, mesh, ce_chunk=EVAL_CE_CHUNK)
    params, opt = init_fn(torch.Generator(device="cuda").manual_seed(0))
    loader = data_lib.CheckpointableBatches(
        data_lib.synthetic_dataset(cfg.vocab_size), EVAL_BATCH, EVAL_SEQ)
    params, opt, _ = step(params, opt, data_lib.device_put_global(
        np.asarray(next(loader)), token_sharding, EVAL_BATCH))
    torch.cuda.synchronize()
    tmp = tempfile.mkdtemp(prefix="chip-smoke-mesh-ckpt-")
    try:
        n_params = sum(t.numel() for t in ckpt.named_leaves(params).values())
        need = 3 * 4 * n_params
        free = shutil.disk_usage(tmp).free
        print(f"{tag} {tmp}: {free / 1e9:.1f} GB free; the round trip writes {need / 1e9:.2f} GB")
        check(free > 1.1 * need, f"{tmp} has {free / 1e9:.1f} GB free, needs {need / 1e9:.1f} GB")
        t0 = time.perf_counter()
        ckpt.save(tmp, 1, params, opt, extra=ckpt.train_metadata(
            topology.mesh_axes(mesh), cfg, global_batch=EVAL_BATCH, seq_len=EVAL_SEQ))
        save_s = time.perf_counter() - t0
        nbytes = sum(os.path.getsize(os.path.join(tmp, "1", n)) for n in os.listdir(os.path.join(tmp, "1")))
        params2, opt2 = init_fn(torch.Generator(device="cuda").manual_seed(1))
        with torch.no_grad():
            for leaf in ckpt.named_leaves(params2).values():
                leaf.to_local().zero_()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        restored = ckpt.restore(tmp, params2, opt2)[0]
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        check(restored == 1, f"restored step {restored}")
        check(all(isinstance(t, DTensor) for t in ckpt.named_leaves(params2).values()),
              "the restored params are not DTensors")
        moments = sum(x.numel() for s_ in opt2.state.values() for x in s_.values() if x.dim())
        check(moments == 2 * n_params, f"restored {moments} moment values for {n_params} parameters")
        bad = _state_mismatches(params, opt, params2, opt2)
        print(f"{tag} sharded round trip ({cfg.n_layers} layers, {n_params / 1e6:.1f} M f32 "
              f"parameters and their AdamW moments as DTensors, {nbytes / 1e9:.3f} GB written; "
              f"marker mesh {ckpt.read_metadata(tmp)['mesh']}): save {save_s:.2f} s "
              f"({nbytes / save_s / 1e9:.2f} GB/s), restore {restore_s:.2f} s "
              f"({nbytes / restore_s / 1e9:.2f} GB/s); not bit-identical: {bad}")
        check(not bad, f"the restored sharded state differs in {bad}")
        with torch.no_grad():
            moment = opt2.state[ckpt.named_leaves(params2)["layers.w_up"]]["exp_avg_sq"]
            flat = moment.to_local().view(-1)
            at = 12345 % flat.numel()
            flat[at:at + 1].view(torch.int32).bitwise_xor_(1)
        planted = _state_mismatches(params, opt, params2, opt2)
        print(f"{tag} planted fault (one bit of one element of layers.w_up's exp_avg_sq): "
              f"not bit-identical {planted}")
        check(planted == ["layers.w_up.exp_avg_sq"],
              "the sharded round-trip check does not see the planted fault")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del params, opt, params2, opt2
    torch.cuda.empty_cache()


@contextlib.contextmanager
def _world_1_gang():
    """The process group of a one-pod gang on GPU 0, from the scheduler's
    handoff (a bind info, ``NVIDIA_VISIBLE_DEVICES=0``), through
    ``initialize_from_gang``; yields (rank, world) and shuts it down."""
    from hivedscheduler_tpu_torch.parallel import distributed

    bind_info = {"node": "chip-smoke/127.0.0.1", "leafCellIsolation": [0],
                 "cellChain": "h100-rack", "affinityGroupBindInfo": [{"podPlacements": [
                     {"physicalNode": "chip-smoke/127.0.0.1", "physicalLeafCellIndices": [0]}]}]}
    handoff = {"POD_BIND_INFO": json.dumps(bind_info), "NODE_NAME": "chip-smoke/127.0.0.1",
               "NVIDIA_VISIBLE_DEVICES": "0", "LOCAL_RANK": "0"}
    saved = {k: os.environ.get(k) for k in handoff}
    os.environ.update(handoff)
    try:
        rank, world = distributed.initialize_from_gang(device="cuda")
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    try:
        yield rank, world
    finally:
        distributed.shutdown()


def phase_mesh(h_flash: dict) -> dict:
    """(l): the gang handoff, the tp-local kernels, world-1 mesh training
    and the sharded checkpoint, on one NCCL process group -> the tp-local
    kernels' errors and times (``_tp_local_kernels``)."""
    import torch
    import torch.distributed as dist

    from hivedscheduler_tpu_torch.parallel import topology

    t_phase = time.perf_counter()
    with _world_1_gang() as (rank, world):
        print(f"[l] gang handoff (one pod, NVIDIA_VISIBLE_DEVICES=0): rank {rank} of world "
              f"{world}, cuda:{torch.cuda.current_device()}, backend {dist.get_backend()}")
        check((rank, world) == (0, 1) and torch.cuda.current_device() == 0,
              "the gang handoff did not give rank 0 of world 1 on cuda:0")
        check(dist.get_backend() == "nccl", f"backend {dist.get_backend()}, want nccl")
        mesh = topology.make_mesh(topology.MeshAxes(), "cuda")
        tp_local = _tp_local_kernels()
        _mesh_train(mesh, h_flash)
        _mesh_checkpoint(mesh)
    print(f"[l] phase wall time {time.perf_counter() - t_phase:.1f} s")
    return tp_local


# phase (m): sequence-parallel attention. One sp = 4 rank's hop of a long
# context at the flagship heads, q [1, 2048, 16, 128], k/v [1, 2048, 8, 128];
# the replayed ring is 4 such ranks over one sequence of 8192
RING_HOP = dict(b=1, t=2048, h=16, h_kv=8, d=128)
RING_SP, RING_T = 4, 8192
# ring_zigzag_flash at sp = 1 on the main path: (h)'s sequence in two halves,
# each hop causal (a half against itself) or unmasked (the second against the
# first)
ZIGZAG_HALF = dict(FLAGSHIP, t=FLAGSHIP["t"] // 2)
# the f32 forms must keep f32 precision: the share of their outputs that a
# bf16 holds exactly (a store rounded to bf16 and widened gives 1; a true f32
# store only the exact zeros and values, such as o's first row under a causal
# mask, a small share)
F32_EXACT_BF16_MAX = 0.1
# the replay's merged o and gradients against the whole-sequence kernels,
# relative Frobenius: both sides round to bf16, and the replay merges f32
# partials where the kernels keep one online softmax
RING_O_REL = 5e-3
RING_GRAD_REL = 1e-2
# ring_zigzag_flash splits each row's softmax over quarter-blocks merged in
# f32, so its losses part from flash's by rounding (the loss limit of (d));
# ring_flash's one diagonal hop merges exactly, and eval is held to 1e-5
ZIGZAG_LOSS_ATOL = 1e-3
RING_LOSS_ATOL = 1e-5
# the einsum ring and Ulysses run no kernel: this depth, held to xla's
RING_EINSUM_LAYERS = 2
# rounds of (flash, ring_flash, zigzag, zigzag, ring_flash, flash) steps
RING_TURNS = 2
RING_IMPLS = ("flash", "ring_flash", "ring_zigzag_flash")


def ring_replay(q, k, v, do, n: int, zigzag: bool):
    """Every rank's hop schedule of an ``n``-rank ``ring_flash`` (or
    ``ring_zigzag_flash``) over one whole sequence, replayed in one process
    through the port's per-hop functions (``_ring_hop``/``_zigzag_hops``,
    ``_flash_block``, ``_merge_flash_partial``, ``_flash_block_grad``) ->
    (out [B, T, H, D] in q's dtype, dq, dk, dv f32), in the sequence's
    order. Rank r holds rows [r T/n, (r + 1) T/n), or in the zigzag layout
    the half-chunks r and 2n-1-r; its step s attends the blocks of rank r -
    s, in the ring's order."""
    import torch

    from hivedscheduler_tpu_torch.parallel import ring_attention as ra

    b, t, h, d = q.shape
    if zigzag:
        half = t // (2 * n)
        spans = [[(r * half, half), ((2 * n - 1 - r) * half, half)] for r in range(n)]
    else:
        spans = [[(r * (t // n), t // n)] for r in range(n)]

    def hops(src, r):
        if zigzag:
            return ra._zigzag_hops(src, r)
        hop = ra._ring_hop(src, r, True)
        return [] if hop is None else [(0, 0, hop)]

    def part(x, r, j):
        start, length = spans[r][j]
        return x[:, start:start + length].contiguous()

    out = torch.empty_like(q)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    for r in range(n):
        acc = [ra._zero_flash_partial(b, h, length, d, q.device) for _, length in spans[r]]
        for step in range(n):
            src = (r - step) % n
            for qj, kj, diag in hops(src, r):
                acc[qj] = ra._merge_flash_partial(acc[qj], ra._flash_block(
                    part(q, r, qj), part(k, src, kj), part(v, src, kj), diag))
        for (start, length), (o_acc, lse_acc) in zip(spans[r], acc):
            out[:, start:start + length] = o_acc.permute(0, 2, 1, 3).to(q.dtype)
            lse[:, :, start:start + length] = lse_acc
    dq = torch.zeros(q.shape, device=q.device)
    dk = torch.zeros(k.shape, device=q.device)
    dv = torch.zeros_like(dk)
    for r in range(n):
        for step in range(n):
            src = (r - step) % n
            for qj, kj, diag in hops(src, r):
                (qs, ql), (ks, kl) = spans[r][qj], spans[src][kj]
                dq_blk, dk_blk, dv_blk = ra._flash_block_grad(
                    part(q, r, qj), part(k, src, kj), part(v, src, kj), part(out, r, qj),
                    lse[:, :, qs:qs + ql].reshape(b * h, ql).contiguous(), part(do, r, qj),
                    diag)
                dq[:, qs:qs + ql] += dq_blk
                dk[:, ks:ks + kl] += dk_blk
                dv[:, ks:ks + kl] += dv_blk
    return out, dq, dk, dv


def _f32_kernel_checks(cases=None, tag: str = "[m]", seed: int = 60) -> dict:
    """K1-K3's f32 forms against their plain versions at ``cases`` (name,
    shape, causal), by default the shapes the main path gives them (sp = 1:
    ring_flash's flagship causal hop, ring_zigzag_flash's causal and
    unmasked half-sequence hops) and one sp = 4 ring hop's (diagonal and
    unmasked), against their bf16 forms (the f32 outputs rounded once to
    bf16 must equal them bit for bit: only the epilogue's store differs),
    for f32 precision (few outputs a bf16 holds exactly), run twice, and
    with (b)'s and (f)'s planted faults at the first case; returns the first
    case's max |err| of each."""
    import torch

    from hivedscheduler_tpu_torch.ops import attention as attn

    if cases is None:
        cases = [("main_path_causal", FLAGSHIP, True), ("zigzag_half_causal", ZIGZAG_HALF, True),
                 ("zigzag_half_unmasked", ZIGZAG_HALF, False), ("hop_diagonal", RING_HOP, True),
                 ("hop_unmasked", RING_HOP, False)]
    f32 = torch.float32

    def exact_bf16(x):
        return float((x == x.to(torch.bfloat16).float()).float().mean())
    max_err = {}
    for i, (name, s, causal) in enumerate(cases):
        b, t, h, h_kv, d = (s[n] for n in ("b", "t", "h", "h_kv", "d"))
        q, k, v = make_qkv(b, t, h, h_kv, d, seed=seed + i)
        do = make_qkv(b, t, h, h_kv, d, seed=seed + 10 + i)[0]
        o, lse = attn.flash_forward(q, k, v, causal=causal, out_dtype=f32)
        o16, lse16 = attn.flash_forward(q, k, v, causal=causal)
        o_ref, lse_ref = attn.flash_attention_plain(q, k, v, causal=causal, out_dtype=f32)
        # K2/K3 read the merged out in bf16, as the ring hands it
        got = attn.flash_backward(q, k, v, o16, lse, do, causal=causal, grad_dtype=f32)
        got16 = attn.flash_backward(q, k, v, o16, lse, do, causal=causal)
        ref = attn.flash_backward_plain(q, k, v, o16, lse, do, causal=causal, grad_dtype=f32)
        torch.cuda.synchronize()
        check(o.dtype == f32 and all(x.dtype == f32 for x in got),
              f"{name}: f32 forms returned {o.dtype}, {[x.dtype for x in got]}")
        check(all(bool(torch.isfinite(x).all()) for x in (o, lse, *got)),
              f"{name}: non-finite f32 output")
        o_fro, o_row = rel_errs(o, o_ref)
        lse_err = float((lse - lse_ref).abs().max())
        errs = {n: rel_errs(x, r, floor=1e-3) for n, x, r in zip(("dq", "dk", "dv"), got, ref)}
        same = (torch.equal(o.to(torch.bfloat16), o16) and torch.equal(lse, lse16)
                and all(torch.equal(x.to(torch.bfloat16), y) for x, y in zip(got, got16)))
        exact = {n: exact_bf16(x) for n, x in zip(("o", "dq", "dk", "dv"), (o, *got))}
        print(f"{tag} {name} q [{b},{t},{h},{d}] k/v [{b},{t},{h_kv},{d}] causal={causal}: "
              f"K1-f32 o rel {o_fro:.3e} (<= {O_REL}), worst row {o_row:.3e} "
              f"(<= {O_ROW_REL}), max|lse err| {lse_err:.3e} (<= {LSE_ATOL}); K2/K3-f32 "
              + ", ".join(f"{n} rel {fr:.3e} worst row {rw:.3e}" for n, (fr, rw) in errs.items())
              + f" (limits {GRAD_REL}, {GRAD_ROW_REL}); rounded to bf16 equal to the bf16 "
              f"kernels' outputs: {same}; share a bf16 holds exactly "
              + ", ".join(f"{n} {x:.3e}" for n, x in exact.items())
              + f" (<= {F32_EXACT_BF16_MAX})")
        check(o_fro <= O_REL and o_row <= O_ROW_REL and lse_err <= LSE_ATOL,
              f"{name}: K1-f32 disagrees with its plain version")
        check(all(fr <= GRAD_REL and rw <= GRAD_ROW_REL for fr, rw in errs.values()),
              f"{name}: K2/K3-f32 disagree with their plain version")
        check(same, f"{name}: the f32 forms, rounded to bf16, differ from the bf16 kernels")
        check(all(x <= F32_EXACT_BF16_MAX for x in exact.values()),
              f"{name}: the f32 forms' outputs are bf16 values widened: {exact}")
        again = attn.flash_forward(q, k, v, causal=causal, out_dtype=f32)
        again_g = attn.flash_backward(q, k, v, o16, lse, do, causal=causal, grad_dtype=f32)
        twice = (torch.equal(o, again[0]) and torch.equal(lse, again[1])
                 and all(torch.equal(x, y) for x, y in zip(got, again_g)))
        print(f"{tag} {name} f32 forms run twice: bit-identical {twice}")
        check(twice, f"{name}: the f32 forms are not bit-reproducible")
        del again, again_g
        if i == 0:
            max_err = {"fwd": float((o - o_ref).abs().max()),
                       "dq": float((got[0] - ref[0]).abs().max()),
                       "dkv": max(float((x - r).abs().max()) for x, r in zip(got[1:], ref[1:]))}
            v_bad = v.clone()
            v_bad[:, [t - 2, t - 1]] = v[:, [t - 1, t - 2]]
            bad_row = rel_errs(attn.flash_forward(q, k, v_bad, causal=causal,
                                                  out_dtype=f32)[0], o_ref)[1]
            k_bad = k.clone()
            k_bad[:, [t - 2, t - 1]] = k[:, [t - 1, t - 2]]
            bad = attn.flash_backward(q, k_bad, v, o16, lse, do, causal=causal, grad_dtype=f32)
            bad_rows = {n: rel_errs(x, r, floor=1e-3)[1]
                        for n, x, r in zip(("dq", "dk", "dv"), bad, ref)}
            widened = exact_bf16(o16.float())
            print(f"{tag} {name} planted faults: K1-f32 (V keys swapped) worst row "
                  f"{bad_row:.3e}; K2/K3-f32 (K keys swapped) worst rows "
                  + ", ".join(f"{n} {x:.3e}" for n, x in bad_rows.items())
                  + f"; the bf16 o widened to f32: share a bf16 holds exactly {widened:.3e}")
            check(bad_row > O_ROW_REL, "the K1-f32 check does not see a swapped V key pair")
            check(all(x > GRAD_ROW_REL for x in bad_rows.values()),
                  "the K2/K3-f32 checks do not see a swapped K key pair")
            check(widened > F32_EXACT_BF16_MAX,
                  "the precision check does not see a bf16 output widened to f32")
            del v_bad, k_bad, bad
        del q, k, v, do, o, lse, o16, lse16, o_ref, lse_ref, got, got16, ref
        torch.cuda.empty_cache()
    return max_err


def _f32_kernel_times(shapes=None, tag: str = "[m]", main: str = "main_path_causal") -> dict:
    """Each f32 form against its bf16 form in turns (bf16, f32, f32, bf16)
    at ``shapes`` (name, shape, causal), by default the main path's shape
    and a hop's, beside the bound, the plain version and the library's bf16
    call (the nearest: no library call returns f32); returns the readings at
    ``main`` for the kernels line."""
    import torch
    import torch.nn.functional as F

    from hivedscheduler_tpu_torch.ops import attention as attn

    if shapes is None:
        shapes = [("main_path_causal", FLAGSHIP, True), ("hop_diagonal", RING_HOP, True),
                  ("hop_unmasked", RING_HOP, False)]
    f32 = torch.float32
    timing = {}
    for name, s, causal in shapes:
        b, t, h, h_kv, d = s["b"], s["t"], s["h"], s["h_kv"], s["d"]
        q, k, v = make_qkv(b, t, h, h_kv, d, seed=80)
        do = make_qkv(b, t, h, h_kv, d, seed=81)[0]
        o, lse = attn.flash_forward(q, k, v, causal=causal)
        _, delta = attn.flash_backward_dq_cuda(q, k, v, o, lse, do, causal)
        forms = {
            "fwd": (lambda dt: lambda: attn.flash_forward(q, k, v, causal=causal, out_dtype=dt)),
            "dq": (lambda dt: lambda: attn.flash_backward_dq_cuda(q, k, v, o, lse, do, causal, dt)),
            "dkv": (lambda dt: lambda: attn.flash_backward_dkv_cuda(q, k, v, lse, delta, do,
                                                                    causal, dt)),
        }
        iters = 20 if b > 1 else 50
        readings = {key: {"bf16": [], "f32": []} for key in forms}
        for _ in range(2):
            for key, make in forms.items():
                for dtype in ("bf16", "f32", "f32", "bf16"):
                    fn = make(f32 if dtype == "f32" else None)
                    readings[key][dtype].append(time_ms(fn, iters=iters, warmup=3))
        plain = {"fwd": time_ms(lambda: attn.flash_attention_plain(q, k, v, causal, f32),
                                iters=2, warmup=1)}
        plain["dq"] = plain["dkv"] = time_ms(
            lambda: attn.flash_backward_plain(q, k, v, o, lse, do, causal, f32),
            iters=2, warmup=1)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        qg, kg, vg = (x.clone().requires_grad_(True) for x in (qt, kt, vt))
        lib_out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal, enable_gqa=True)
        dout = do.transpose(1, 2).contiguous()
        library = {"fwd": time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True), iters=iters, warmup=3)}
        library["dq"] = library["dkv"] = time_ms(
            lambda: torch.autograd.grad(lib_out, (qg, kg, vg), dout, retain_graph=True),
            iters=iters, warmup=3)
        flops_f = attn.attention_flops(b, t, h, d, causal)
        flops_b = attn.attention_bwd_flops(b, t, h, d, causal)
        work = {"fwd": (flops_f, attn.attention_bytes(b, t, h, h_kv, d, out_bytes=4)),
                "dq": (flops_b["dq"], attn.attention_bwd_bytes(b, t, h, h_kv, d, 4)["dq"]),
                "dkv": (flops_b["dkv"], attn.attention_bwd_bytes(b, t, h, h_kv, d, 4)["dkv"])}
        for key, (flops, nbytes) in work.items():
            ops_ms, bytes_ms = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
            bound_ms = max(ops_ms, bytes_ms)
            bound_by = "operations" if ops_ms >= bytes_ms else "bytes"
            r32, r16 = readings[key]["f32"], readings[key]["bf16"]
            ms = sorted(r32)[len(r32) // 2]
            print(f"{tag} {key}-f32 at {name} q [{b},{t},{h},{d}]: kernel_ms "
                  f"{', '.join(f'{x:.4f}' for x in r32)} (median {ms:.4f}) against the bf16 "
                  f"form {', '.join(f'{x:.4f}' for x in r16)} (median "
                  f"{sorted(r16)[len(r16) // 2]:.4f}), in turns; bound_ms {bound_ms:.4f} "
                  f"({bound_by}: {flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB) -> "
                  f"{bound_ms / ms:.1%} of the bound; plain_ms {plain[key]:.3f}; library_ms "
                  f"(bf16 {'forward' if key == 'fwd' else 'backward, dq, dk and dv'}) "
                  f"{library[key]:.4f}")
            if name == main:
                timing[key] = dict(ms=ms, plain_ms=plain[key], library_ms=library[key],
                                   bound_ms=bound_ms, bound_by=bound_by)
        del q, k, v, do, o, lse, delta, qt, kt, vt, qg, kg, vg, lib_out, dout
        torch.cuda.empty_cache()
    return timing


def _ring_replay_check() -> None:
    """(m) 2: a 4-rank ring's hop schedules replayed on the one card at
    T = 8192, for ring_flash and ring_zigzag_flash, against K1-K3 over the
    whole sequence."""
    import torch

    from hivedscheduler_tpu_torch.ops import attention as attn

    hp = RING_HOP
    q, k, v = make_qkv(1, RING_T, hp["h"], hp["h_kv"], hp["d"], seed=90)
    do = make_qkv(1, RING_T, hp["h"], hp["h_kv"], hp["d"], seed=91)[0]
    o_ref, lse_ref = attn.flash_forward(q, k, v, causal=True)
    ref = attn.flash_backward(q, k, v, o_ref, lse_ref, do, causal=True)
    for zigzag in (False, True):
        name = "ring_zigzag_flash" if zigzag else "ring_flash"
        t0 = time.perf_counter()
        out, *grads = ring_replay(q, k, v, do, RING_SP, zigzag)
        torch.cuda.synchronize()
        o_fro = rel_errs(out, o_ref)[0]
        g_fro = {n: rel_errs(x, r)[0] for n, x, r in zip(("dq", "dk", "dv"), grads, ref)}
        print(f"[m] {RING_SP}-rank {name} replayed over T={RING_T} (q [1,{RING_T},{hp['h']},"
              f"{hp['d']}], {time.perf_counter() - t0:.2f} s): merged o rel {o_fro:.3e} "
              f"(<= {RING_O_REL}); " + ", ".join(f"{n} rel {x:.3e}" for n, x in g_fro.items())
              + f" (<= {RING_GRAD_REL}), against K1-K3 over the whole sequence")
        check(out.dtype == torch.bfloat16 and bool(torch.isfinite(out).all())
              and all(bool(torch.isfinite(x).all()) for x in grads),
              f"{name} replay: non-finite or wrongly typed outputs")
        check(o_fro <= RING_O_REL, f"the {name} replay's merged o disagrees with K1")
        check(all(x <= RING_GRAD_REL for x in g_fro.values()),
              f"the {name} replay's gradients disagree with K2/K3")
        del out, grads
    del q, k, v, do, o_ref, lse_ref, ref
    torch.cuda.empty_cache()


def _count_launches(attn) -> dict:
    return {"fwd": attn.FLASH_FWD_LAUNCHES, "dq": attn.FLASH_BWD_DQ_LAUNCHES,
            "dkv": attn.FLASH_BWD_DKV_LAUNCHES, "fwd_f32": attn.FLASH_FWD_F32_LAUNCHES,
            "dq_f32": attn.FLASH_BWD_DQ_F32_LAUNCHES,
            "dkv_f32": attn.FLASH_BWD_DKV_F32_LAUNCHES}


def _zero_launches(attn) -> None:
    attn.FLASH_FWD_LAUNCHES = attn.FLASH_BWD_DQ_LAUNCHES = attn.FLASH_BWD_DKV_LAUNCHES = 0
    attn.FLASH_FWD_F32_LAUNCHES = attn.FLASH_BWD_DQ_F32_LAUNCHES = 0
    attn.FLASH_BWD_DKV_F32_LAUNCHES = 0


def _ring_entry_points(h_flash: dict) -> dict:
    """(m) 3: ``train`` and ``eval`` through the ring family at sp = 1 on the
    world-1 mesh; returns the f32 kernels' launches of the ring_flash
    train run."""
    from hivedscheduler_tpu_torch.ops import attention as attn

    layers = EVAL_MODEL["n_layers"]
    results = {}
    for impl, per_layer in (("ring_flash", 1), ("ring_zigzag_flash", 3)):
        _zero_launches(attn)
        records, peak = run_train(impl, TRAIN_STEPS)
        launches = _count_launches(attn)
        n = layers * TRAIN_STEPS * per_layer
        want = {"fwd": 0, "dq": 0, "dkv": 0, "fwd_f32": 2 * n, "dq_f32": n, "dkv_f32": n}
        losses = [r["loss"] for r in records]
        diff = max(abs(a - b) for a, b in zip(losses, h_flash["losses"]))
        limit = RING_LOSS_ATOL if impl == "ring_flash" else ZIGZAG_LOSS_ATOL
        print(f"[m] train --attn {impl} --remat dots at sp=1 (world-1 mesh): losses {losses}; "
              f"(h)'s flash {h_flash['losses']}: "
              + ("equal" if losses == h_flash["losses"] else f"max |diff| {diff:.3e}")
              + f" (<= {limit}); launches over {TRAIN_STEPS} steps {launches} (want {want}); "
              f"peak device memory {peak / 1e9:.2f} GB")
        check(launches == want, f"train --attn {impl} launched {launches}, want {want}")
        check(diff <= limit, f"train --attn {impl} losses part from flash's by {diff}")
        results[impl] = launches
    loss_ring, _, _ = run_eval("ring_flash", 1)
    loss_flash, _, _ = run_eval("flash", 1)
    print(f"[m] eval --attn ring_flash, one window: loss {loss_ring:.6f}; --attn flash "
          f"{loss_flash:.6f}; |diff| {abs(loss_ring - loss_flash):.3e} (<= {RING_LOSS_ATOL})")
    check(abs(loss_ring - loss_flash) <= RING_LOSS_ATOL, "eval ring_flash and flash disagree")
    shallow = [a for a in TRAIN_ARGS]
    shallow[shallow.index("--n-layers") + 1] = str(RING_EINSUM_LAYERS)
    _zero_launches(attn)
    einsum = {impl: [r["loss"] for r in run_train(impl, TRAIN_STEPS, shallow)[0]]
              for impl in ("xla", "ring", "ulysses")}
    launches = _count_launches(attn)
    for impl in ("ring", "ulysses"):
        diff = max(abs(a - b) for a, b in zip(einsum[impl], einsum["xla"]))
        print(f"[m] train --attn {impl} at sp=1, {RING_EINSUM_LAYERS} layers: losses "
              f"{einsum[impl]}; xla {einsum['xla']}: max |diff| {diff:.3e} (<= {LOSS_ATOL})")
        check(diff <= LOSS_ATOL, f"train --attn {impl} parts from xla by {diff}")
    check(not any(launches.values()), f"the einsum ring and Ulysses launched {launches}")
    return results["ring_flash"]


def _ring_step_times() -> None:
    """(m) 3: the step of flash, ring_flash and ring_zigzag_flash at sp = 1
    on the world-1 mesh, by CUDA events, in turns."""
    import numpy as np
    import torch

    from hivedscheduler_tpu_torch.models import transformer as tm
    from hivedscheduler_tpu_torch.parallel import data as data_lib
    from hivedscheduler_tpu_torch.parallel import distributed, topology
    from hivedscheduler_tpu_torch.parallel import train as port_train

    distributed.initialize_from_gang(device="cuda")
    try:
        mesh = topology.make_mesh(topology.MeshAxes(), "cuda")
        loader = data_lib.CheckpointableBatches(
            data_lib.synthetic_dataset(EVAL_MODEL["vocab_size"]), EVAL_BATCH, EVAL_SEQ)
        host = np.asarray(next(loader))
        runs = {}
        for impl in RING_IMPLS:
            cfg = tm.TransformerConfig(max_seq_len=EVAL_SEQ, attn_impl=impl, remat="dots",
                                       **EVAL_MODEL)
            step, init_fn, token_sharding = port_train.make_sharded_train_step(
                cfg, mesh, ce_chunk=EVAL_CE_CHUNK)
            params, opt = init_fn(torch.Generator(device="cuda").manual_seed(0))
            tokens = [data_lib.device_put_global(host, token_sharding, EVAL_BATCH)]
            _steps_by_events(step, params, opt, tokens)  # warm-up
            runs[impl] = (step, params, opt, tokens)
        turns = {impl: [] for impl in RING_IMPLS}
        for _ in range(RING_TURNS):
            for impl in RING_IMPLS + RING_IMPLS[::-1]:
                turns[impl] += _steps_by_events(*runs[impl])[1]
        med = {impl: sorted(ms)[len(ms) // 2] for impl, ms in turns.items()}
        print(f"[m] step ms at sp=1 (B={EVAL_BATCH}, T={EVAL_SEQ}, {EVAL_MODEL['n_layers']} "
              f"layers, remat dots, ce_chunk {EVAL_CE_CHUNK}) by CUDA events in turns "
              f"({RING_TURNS} x {', '.join(RING_IMPLS + RING_IMPLS[::-1])}): "
              + "; ".join(f"{impl} median {med[impl]:.3f} (spread {min(ms):.3f}-{max(ms):.3f})"
                          for impl, ms in turns.items())
              + "; " + ", ".join(f"{impl} - flash {med[impl] - med['flash']:.3f} ms"
                                 for impl in RING_IMPLS[1:]))
        del runs
    finally:
        distributed.shutdown()


def phase_ring(h_flash: dict) -> dict:
    """(m): the f32 kernels, the replayed 4-rank ring and the ring family's
    entry points at sp = 1; returns the kernels line's entries of the f32
    forms."""
    import torch

    t_phase = time.perf_counter()
    walls = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        walls[name] = time.perf_counter() - t0
        return out

    max_err = timed("f32 kernel checks", _f32_kernel_checks)
    timing = timed("f32 kernel times", _f32_kernel_times)
    timed("ring replay", _ring_replay_check)
    launches = timed("entry points", _ring_entry_points, h_flash)
    timed("step times", _ring_step_times)
    torch.cuda.empty_cache()
    print(f"[m] phase wall time {time.perf_counter() - t_phase:.1f} s ("
          + ", ".join(f"{name} {s:.1f} s" for name, s in walls.items()) + ")")
    return {key: dict(launches=launches[f"{key}_f32"], max_abs_err=max_err[key], **timing[key])
            for key in ("fwd", "dq", "dkv")}


# phase (n): the mixture-of-experts model at the flagship width: 8 experts
# with renormalised top-2 routing (Mixtral 8x7B's, arXiv:2401.04088 2.1),
# capacity factor 1.25, load-balance weight 0.01, no z-loss
MOE_MODEL = dict(EVAL_MODEL, n_experts=8, moe_top_k=2)
MOE_FLAGS = ["--n-experts", "8", "--moe-top-k", "2"]
MOE_TRAIN_ARGS = TRAIN_ARGS + MOE_FLAGS + ["--ep", "1"]
MOE_EVAL_ARGS = EVAL_ARGS + MOE_FLAGS
# _moe_mlp in bf16 against the same function in f32 (f32 weights, the same
# bf16-valued input): ||out_bf16 - out_f32||_F / ||out_f32||_F over the
# tokens whose dispatch agrees (the same experts chosen and kept); set in
# PERF.md before the first reading
MOE_OUT_REL = 3e-2
MOE_ROUTE_AGREE = 0.9  # least share of tokens whose top-2 set agrees
MOE_TURNS = 2  # rounds of (dense, moe, moe, dense) timed steps
MOE_DEC_TIMED = 2  # timed generate runs of each weight format
# kernel-name fragments of the routing and dispatch (sort for the top-2,
# scan for the slot positions, scatter for the one-hot and the combine);
# the embedding's backward sorts and scatters too and lands here
MOE_PROFILE_GROUPS = PROFILE_GROUPS + (
    ("routing/dispatch", ("sort", "scan", "scatter")),)


@contextlib.contextmanager
def _moe_routes(record=None, replay=None):
    """Record the experts every ``_moe_route`` call chooses into the list
    ``record``, or make each call choose ``replay``'s, in order (the same
    calls in the same order: layers, then windows or steps); a replayed
    call keeps its own probabilities as the gates."""
    from hivedscheduler_tpu_torch.models import transformer as tm

    real = tm._top_k
    chosen = iter(replay) if replay is not None else None

    def top_k(probs, k):
        values, idx = real(probs, k)
        if record is not None:
            record.append(idx)
        if chosen is not None:
            idx = next(chosen)
            values = probs.gather(-1, idx)
        return values, idx

    tm._top_k = top_k
    try:
        yield
    finally:
        tm._top_k = real


def _route_flips(a, b) -> float:
    """The share of (layer, token) routes whose expert set differs."""
    return sum(int((x.sort(-1).values != y.sort(-1).values).any(-1).sum())
               for x, y in zip(a, b)) / sum(x[..., 0].numel() for x in a)


def _moe_layer_check() -> None:
    """``_moe_mlp`` at the flagship shape in bf16 against f32 on the card:
    the routes, the output on agreeing tokens with a planted fault, and the
    layer's forward ms."""
    import torch

    from hivedscheduler_tpu_torch.models import transformer as tm

    cfg = tm.TransformerConfig(max_seq_len=EVAL_SEQ, **dict(MOE_MODEL, n_layers=1))
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    g = torch.Generator(device="cuda").manual_seed(0)
    lp = {k: v[0] for k, v in tm.init_params(cfg, g, "cuda")["layers"].items()}
    h = torch.randn(EVAL_BATCH, EVAL_SEQ, cfg.d_model, generator=g, device="cuda").to(torch.bfloat16)
    w16 = {k: v.to(torch.bfloat16) for k, v in lp.items()}
    with torch.inference_mode():
        comb16, disp16, idx16, aux16 = tm._moe_route(h, w16["router"], cfg)
        _, disp32, idx32, aux32 = tm._moe_route(h.float(), lp["router"], cfg32)
        route_same = (idx16.sort(-1).values == idx32.sort(-1).values).all(-1)
        # the same experts hold a slot for the token
        agree = route_same & (disp16.amax(-1) == disp32.amax(-1)).all(-1)
        out16 = tm._moe_mlp(h, w16.__getitem__, cfg)[0].float()
        out32 = tm._moe_mlp(h.float(), lp.__getitem__, cfg32)[0]
        rel = float((out16 - out32)[agree].norm() / out32[agree].norm())
        bad_w = dict(w16, w_down=w16["w_down"][[1, 0] + list(range(2, cfg.n_experts))])
        bad = tm._moe_mlp(h, bad_w.__getitem__, cfg)[0].float()
        bad_rel = float((bad - out32)[agree].norm() / out32[agree].norm())
        capacity = comb16.shape[-1]
        kept = float(disp16.sum()) / (EVAL_BATCH * EVAL_SEQ * cfg.moe_top_k)
        ms = time_ms(lambda: tm._moe_mlp(h, w16.__getitem__, cfg), 5)
        route_ms = time_ms(lambda: tm._moe_route(h, w16["router"], cfg), 5)
    flops = 2 * cfg.n_experts * EVAL_BATCH * capacity * cfg.d_model * cfg.d_ff * 3
    flops += 2 * 2 * EVAL_BATCH * EVAL_SEQ * cfg.n_experts * capacity * cfg.d_model
    print(f"[n] _moe_mlp at B={EVAL_BATCH}, T={EVAL_SEQ}, D={cfg.d_model}, F={cfg.d_ff}, "
          f"E={cfg.n_experts}, top-{cfg.moe_top_k}, capacity {capacity}: top-2 set agrees "
          f"bf16 vs f32 on {float(route_same.float().mean()):.4f} of tokens (>= "
          f"{MOE_ROUTE_AGREE}), dispatch on {float(agree.float().mean()):.4f}; output rel "
          f"{rel:.3e} on those (<= {MOE_OUT_REL}); planted fault (experts 0 and 1's "
          f"w_down swapped): {bad_rel:.3e}; aux bf16 {float(aux16):.6f} f32 "
          f"{float(aux32):.6f}; {kept:.4f} of the chosen slots kept")
    print(f"[n] _moe_mlp forward (bf16) {ms:.3f} ms, of it the routing {route_ms:.3f} ms; "
          f"{flops / 1e9:.1f} GFLOP in the expert and dispatch products, "
          f"{flops / (ms / 1e3) / 1e12:.1f} TFLOP/s")
    check(float(route_same.float().mean()) >= MOE_ROUTE_AGREE, "bf16 and f32 routes disagree")
    check(rel <= MOE_OUT_REL and math.isfinite(rel), "bf16 _moe_mlp disagrees with f32")
    check(bad_rel > MOE_OUT_REL, "the MoE output check does not see the planted fault")
    del lp, w16, bad_w, h, out16, out32, bad, comb16, disp16, disp32
    torch.cuda.empty_cache()


def _moe_train() -> dict:
    """``train`` with the MoE model on the world-1 mesh (``--ep 1``): its
    launches, losses, step ms, tokens/s and peak memory."""
    from hivedscheduler_tpu_torch.ops import attention as attn

    attn.FLASH_FWD_LAUNCHES = attn.FLASH_BWD_DQ_LAUNCHES = attn.FLASH_BWD_DKV_LAUNCHES = 0
    records, peak = run_train("flash", TRAIN_STEPS, args=MOE_TRAIN_ARGS)
    launches = {"fwd": attn.FLASH_FWD_LAUNCHES, "dq": attn.FLASH_BWD_DQ_LAUNCHES,
                "dkv": attn.FLASH_BWD_DKV_LAUNCHES}
    layers = MOE_MODEL["n_layers"]
    want = {"fwd": 2 * layers * TRAIN_STEPS, "dq": layers * TRAIN_STEPS,
            "dkv": layers * TRAIN_STEPS}
    timed = [r for r in records if not r["compile"]]
    step_ms = sum(r["wall_s"] for r in timed) / len(timed) * 1e3
    print(f"[n] train {' '.join(MOE_FLAGS)} --ep 1 --attn flash --remat dots (world-1 "
          f"mesh): losses {[r['loss'] for r in records]}; launches over {TRAIN_STEPS} "
          f"steps {launches} (want {want}); step {step_ms} ms (mean of {len(timed)} "
          f"after the warm-up), {EVAL_BATCH * EVAL_SEQ / (step_ms / 1e3)} tokens/s, "
          f"peak device memory {peak / 1e9:.2f} GB")
    check(launches == want, f"the MoE train run launched {launches}, want {want}")
    return dict(losses=[r["loss"] for r in records], step_ms=step_ms, peak=peak)


def _moe_steps(cli: dict) -> None:
    """The first step's loss against xla on the same weights and batch; the
    single-device step against the CLI's mesh step, bit for bit; step ms in
    turns against the dense flagship step; one step's device time by part."""
    import numpy as np
    import torch

    from hivedscheduler_tpu_torch.models import transformer as tm
    from hivedscheduler_tpu_torch.parallel import data as data_lib
    from hivedscheduler_tpu_torch.parallel import train as port_train

    cfg = tm.TransformerConfig(max_seq_len=EVAL_SEQ, attn_impl="flash", remat="dots",
                               **MOE_MODEL)
    loader = data_lib.CheckpointableBatches(
        data_lib.synthetic_dataset(cfg.vocab_size), EVAL_BATCH, EVAL_SEQ)
    tokens = [torch.from_numpy(np.asarray(next(loader))).cuda() for _ in range(TRAIN_STEPS)]
    step, init_fn = port_train.make_train_step(cfg, "cuda", ce_chunk=EVAL_CE_CHUNK)
    params, opt = init_fn(torch.Generator(device="cuda").manual_seed(0))
    def first_loss(impl, **routes):
        with torch.no_grad(), _moe_routes(**routes):
            return float(port_train.loss_fn(params, tokens[0], dataclasses.replace(
                cfg, attn_impl=impl), ce_chunk=EVAL_CE_CHUNK))

    flash_routes, xla_routes = [], []
    loss_f = first_loss("flash", record=flash_routes)
    loss_x = first_loss("xla", record=xla_routes)
    # xla attention on flash's expert choices: the attention's own difference
    loss_xr = first_loss("xla", replay=flash_routes)
    print(f"[n] first step's loss (with the aux) on the CLI's weights and batch: flash "
          f"{loss_f:.6f} (the CLI's {cli['losses'][0]:.6f}), xla {loss_x:.6f}: |flash - "
          f"xla| {abs(loss_f - loss_x):.3e} with each routing its own way "
          f"({_route_flips(flash_routes, xla_routes):.4%} of layer-token routes differ); "
          f"xla on flash's routes {loss_xr:.6f}: |flash - xla| {abs(loss_f - loss_xr):.3e} "
          f"(<= {LOSS_ATOL})")
    check(abs(loss_f - loss_xr) <= LOSS_ATOL, "MoE flash and xla losses disagree")
    # the same weights, batch and kernels; only the remat wrappers differ
    check(abs(cli["losses"][0] - loss_f) <= 1e-5, "the MoE CLI's first loss is not this step's")
    single, single_ms = _steps_by_events(step, params, opt, tokens)
    print(f"[n] single-device make_train_step from the same seed and batches: losses "
          f"{single}; the CLI's world-1 mesh step (make_sharded_train_step, --ep 1): "
          f"{'equal' if single == cli['losses'] else 'NOT equal'}; step ms "
          f"{', '.join(f'{x:.3f}' for x in single_ms)} (the first is the warm-up)")
    check(single == cli["losses"], "the MoE mesh step is not the single-device step")

    dense_cfg = tm.TransformerConfig(max_seq_len=EVAL_SEQ, attn_impl="flash", remat="dots",
                                     **EVAL_MODEL)
    dstep, dinit = port_train.make_train_step(dense_cfg, "cuda", ce_chunk=EVAL_CE_CHUNK)
    dparams, dopt = dinit(torch.Generator(device="cuda").manual_seed(0))
    _steps_by_events(dstep, dparams, dopt, tokens[:1])  # warm-up
    turns = {"dense": [], "moe": []}
    torch.cuda.reset_peak_memory_stats()
    for _ in range(MOE_TURNS):
        for name in ("dense", "moe", "moe", "dense"):
            if name == "moe":
                turns[name] += _steps_by_events(step, params, opt, tokens[:1])[1]
            else:
                turns[name] += _steps_by_events(dstep, dparams, dopt, tokens[:1])[1]
    med = {name: sorted(ms)[len(ms) // 2] for name, ms in turns.items()}
    print(f"[n] step ms in turns ({MOE_TURNS} x dense, moe, moe, dense; B={EVAL_BATCH}, "
          f"T={EVAL_SEQ}): "
          + "; ".join(f"{name} {', '.join(f'{x:.3f}' for x in ms)} (median {med[name]:.3f}, "
                      f"{EVAL_BATCH * EVAL_SEQ / (med[name] / 1e3):.1f} tokens/s)"
                      for name, ms in turns.items())
          + f"; moe / dense {med['moe'] / med['dense']:.3f}; peak device memory with "
          f"both states resident {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del dparams, dopt, dstep
    torch.cuda.empty_cache()
    wall_ms, total, parts = _step_profile(step, params, opt, tokens[0], MOE_PROFILE_GROUPS)
    if total == 0:
        print("[n] profiler: no device time recorded (not measured)")
    else:
        print(f"[n] profile of one MoE train step: wall {wall_ms:.1f} ms, device busy "
              f"{total:.1f} ms ({1 - total / wall_ms:.1%} idle); "
              + ", ".join(f"{k} {v:.1f} ms ({v / total:.1%})" for k, v in parts.items()))
    del params, opt, step
    torch.cuda.empty_cache()


def _moe_eval() -> None:
    """``eval`` with the MoE model: flash against xla, and the window ms."""
    from hivedscheduler_tpu_torch.ops import attention as attn

    attn.FLASH_FWD_LAUNCHES = 0
    flash_routes, xla_routes = [], []
    with _moe_routes(record=flash_routes):
        loss_f, _, _ = run_eval("flash", EVAL_WINDOWS, MOE_EVAL_ARGS)
    launches = attn.FLASH_FWD_LAUNCHES
    with _moe_routes(record=xla_routes):
        loss_x, _, _ = run_eval("xla", EVAL_WINDOWS, MOE_EVAL_ARGS)
    with _moe_routes(replay=flash_routes):
        loss_xr, _, _ = run_eval("xla", EVAL_WINDOWS, MOE_EVAL_ARGS)
    print(f"[n] eval {' '.join(MOE_FLAGS)}: loss flash {loss_f:.6f} (flash_fwd launches "
          f"{launches}), xla {loss_x:.6f}: |flash - xla| {abs(loss_f - loss_x):.3e} with "
          f"each routing its own way ({_route_flips(flash_routes, xla_routes):.4%} of "
          f"layer-token routes differ); xla on flash's routes {loss_xr:.6f}: |flash - xla| "
          f"{abs(loss_f - loss_xr):.3e} (<= {LOSS_ATOL})")
    check(launches == MOE_MODEL["n_layers"] * EVAL_WINDOWS, f"MoE eval launched K1 {launches} times")
    check(abs(loss_f - loss_xr) <= LOSS_ATOL, "MoE flash and xla eval losses disagree")
    for impl in ("flash", "xla"):
        _, window_ms, tokens_per_s = run_eval(impl, TIMED_WINDOWS, MOE_EVAL_ARGS)
        print(f"[n] eval window --attn {impl} (B={EVAL_BATCH}, T={EVAL_SEQ}, "
              f"{TIMED_WINDOWS} windows): {window_ms} ms, {tokens_per_s} tokens/s")


def _decode_replay(full_routes, n_prompt: int, n_steps: int) -> list:
    """The experts the full forward chose (one [B, T, K] per layer), cut
    into the order ``_decode_sequence`` asks for them: the prompt's
    prefill, then one position a step, layer by layer."""
    out = [r[:, :n_prompt] for r in full_routes]
    for i in range(n_steps):
        out += [r[:, n_prompt + i:n_prompt + i + 1] for r in full_routes]
    return out


def _moe_generate() -> None:
    """``generate`` with the MoE model: greedy tokens against the argmax of
    their own advance sequence; the decode logits against the full forward,
    on the full forward's expert choices (with a planted fault) and on
    their own; int8 against bf16; tokens/s."""
    import torch

    from hivedscheduler_tpu_torch.models import decode as dec
    from hivedscheduler_tpu_torch.models import quant
    from hivedscheduler_tpu_torch.models import transformer as tm

    cfg = tm.TransformerConfig(max_seq_len=DEC_PROMPT + DEC_NEW, **MOE_MODEL)
    f32 = tm.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    params = tm.cast_params(f32, cfg.dtype)
    q_params = quant.quantize_params(f32, cfg)
    del f32
    torch.cuda.empty_cache()
    prompt = torch.randint(0, cfg.vocab_size, (DEC_BATCH, DEC_PROMPT), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(1))
    weight_bytes = {"bf16": _tree_bytes(params), "int8": _tree_bytes(q_params)}
    kv_bytes = 2.0 * 2 * cfg.n_layers * DEC_BATCH * (DEC_PROMPT + DEC_NEW) * cfg.kv_heads * cfg.head_dim
    toks = dec.generate(params, prompt, cfg, DEC_NEW)
    # the full forward routes with the inference capacity, as advance does
    full_routes, free_routes = [], []
    with torch.inference_mode(), _moe_routes(record=full_routes):
        full = tm.forward(params, torch.cat([prompt, toks], 1)[:, :-1],
                          dec.inference_moe_cfg(cfg))[:, DEC_PROMPT - 1:]
    with _moe_routes(record=free_routes):
        inc = _decode_sequence(params, cfg, prompt, toks)[:, DEC_PROMPT - 1:]
    exact = int((inc.argmax(-1) != toks).sum())
    # a route that flips between the S = 1 and S = 191 products moves its
    # token's logits by O(1): hold the rounding on the same expert choices
    replay = _decode_replay(full_routes, DEC_PROMPT, DEC_NEW - 1)
    flips = _route_flips(
        [torch.cat(free_routes[i::cfg.n_layers], 1) for i in range(cfg.n_layers)], full_routes)
    with _moe_routes(replay=replay):
        inc_r = _decode_sequence(params, cfg, prompt, toks)[:, DEC_PROMPT - 1:]
    real_attention = dec._cached_attention

    def one_off(q, ck, cv, pos0, scale):
        return real_attention(q, ck.roll(1, dims=1), cv.roll(1, dims=1), pos0, scale)

    with _moe_routes(replay=replay):
        bad = _decode_sequence(params, cfg, prompt, toks, attention=one_off)[:, DEC_PROMPT - 1:]
    rel, bad_rel = _per_position_rel(inc_r, full), _per_position_rel(bad, full)
    noise = float((inc_r - full).abs().max())
    decisive, ref_tok = _decisive(full, noise)
    wrong = int((decisive & (ref_tok != inc_r.argmax(-1))).sum())
    free_agree = float((full.argmax(-1) == toks).float().mean())
    print(f"[n] greedy generate (B={DEC_BATCH}, prompt {DEC_PROMPT}, {DEC_NEW} new): "
          f"{exact} tokens differ from the argmax of the same advance sequence; "
          f"{flips:.4%} of layer-token routes differ between it and the full forward "
          f"(worst position rel {_per_position_rel(inc, full):.3e}); on the full "
          f"forward's routes the decode logits' worst position rel {rel:.3e} (<= "
          f"{DEC_LOGIT_REL}), max|err| {noise:.3e}, planted fault (K/V one position "
          f"off) {bad_rel:.3e}; there {int(decisive.sum())} of {toks.numel()} positions "
          f"decisive, {wrong} of them differ from the full forward's argmax; the "
          f"greedy tokens are the full forward's argmax at {free_agree:.4f} of positions")
    check(exact == 0, "MoE greedy tokens disagree with their advance sequence")
    check(rel <= DEC_LOGIT_REL and bad_rel > DEC_LOGIT_REL,
          "MoE decode logits disagree with the full forward, or miss the fault")
    check(wrong == 0 and bool(decisive.any()), "MoE decode argmax disagrees at decisive positions")
    with _moe_routes(replay=replay):
        inc_q = _decode_sequence(q_params, cfg, prompt, toks)[:, DEC_PROMPT - 1:]
    q_noise = float((inc_q - inc_r).abs().max())
    q_dec, bf_tok = _decisive(inc_r, q_noise)
    q_wrong = int((q_dec & (inc_q.argmax(-1) != bf_tok)).sum())
    toks_q = dec.generate(q_params, prompt, cfg, DEC_NEW)
    print(f"[n] int8 vs bf16 logits on the same routes: max|err| {q_noise:.3e}, worst "
          f"position rel {_per_position_rel(inc_q, inc_r):.3e}; {int(q_dec.sum())} decisive "
          f"positions, {q_wrong} argmax disagreements there; int8 generate agrees with "
          f"bf16 on {float((toks_q == toks).float().mean()):.3f} of tokens")
    check(q_wrong == 0 and bool(torch.isfinite(inc_q).all()),
          "MoE int8 argmax disagrees at decisive positions")
    for name, p in (("bf16", params), ("int8", q_params)):
        wall = _host_ms(lambda: dec.generate(p, prompt, cfg, DEC_NEW), MOE_DEC_TIMED)
        med = sorted(wall)[len(wall) // 2]
        print(f"[n] generate {name}: wall {', '.join(f'{t:.2f}' for t in wall)} ms, "
              f"{DEC_BATCH * DEC_NEW / (med / 1e3):.1f} tokens/s, {med / DEC_NEW:.3f} ms a "
              f"new token; bound {(weight_bytes[name] + kv_bytes) / PEAK_HBM_BYTES * 1e3:.4f} "
              f"ms a step ({weight_bytes[name] / 1e9:.3f} GB of weights, every expert "
              f"read each step)")
    del params, q_params
    torch.cuda.empty_cache()


def _engine_replay(full_routes, n_prompt: int, bucket: int, n_steps: int) -> list:
    """The full forward's expert choices for one request (one [1, T, K] per
    layer) in the order ``_engine_logits`` asks for them: the bucketed
    prefill (its padding on experts 0..K-1), then each decode step's
    SRV_BATCH rows, the request in row 0 and the idle rows on 0..K-1."""
    import torch

    k = full_routes[0].shape[-1]

    def filler(rows, n):
        return torch.arange(k, device="cuda").expand(rows, n, k).clone()

    out = [torch.cat([r[:, :n_prompt], filler(1, bucket - n_prompt)], 1) for r in full_routes]
    for i in range(n_steps):
        for r in full_routes:
            step = filler(SRV_BATCH, 1)
            step[0, 0] = r[0, n_prompt + i]
            out.append(step)
    return out


def _moe_serve() -> None:
    """The serving engine with the MoE model: dense/paged and eager/graph
    streams token-identical; the engine path's logits against the full
    forward on its expert choices; tokens/s, TTFT and TPOT."""
    import torch

    from hivedscheduler_tpu_torch.models import decode as dec
    from hivedscheduler_tpu_torch.models import serving as srv
    from hivedscheduler_tpu_torch.models import transformer as tm

    cfg = tm.TransformerConfig(max_seq_len=SRV_MAX_LEN, **MOE_MODEL)
    params = tm.cast_params(tm.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda"), cfg.dtype)
    torch.cuda.empty_cache()
    prompts = _srv_prompts(cfg.vocab_size, SRV_REQUESTS, seed=2)
    engines, runs = {}, {}
    for name, kw in SRV_RUNS.items():
        engines[name] = srv.ServingEngine(params, cfg, max_batch=SRV_BATCH,
                                          max_len=SRV_MAX_LEN, **kw)
        runs[name] = _serve(engines[name], prompts, SRV_BUDGET)
        if engines[name].decode_steps > 1:
            check(engines[name].graph_windows == engines[name].fused_windows > 0,
                  f"MoE {name}: windows did not run through the CUDA graph")
    ref = _streams(runs["dense eager"])
    same = {name: sum(a != b for a, b in zip(_streams(run), ref)) for name, run in runs.items()}
    full = _teacher_forced(params, dec.inference_moe_cfg(cfg), prompts, ref)
    agree = sum(int((f.argmax(-1).cpu() == torch.tensor(s)).sum()) for f, s in zip(full, ref))
    rels = []
    for p, s in zip(prompts[:SRV_NOISE_ROWS], ref):
        routes = []
        with torch.inference_mode(), _moe_routes(record=routes):
            want = tm.forward(params, torch.tensor([p + s[:-1]], device="cuda"),
                              dec.inference_moe_cfg(cfg))[0, len(p) - 1:].float()
        bucket = min(SRV_MAX_LEN, 1 << max(1, (len(p) - 1).bit_length()))
        with _moe_routes(replay=_engine_replay(routes, len(p), bucket, len(s) - 1)):
            got = _engine_logits(params, cfg, p, s)
        rels.append(float(((got - want).norm(dim=-1) / want.norm(dim=-1)).max()))
    print(f"[n] serve, four runs of {SRV_REQUESTS} requests (budget {SRV_BUDGET}, max_batch "
          f"{SRV_BATCH}): requests whose stream differs from dense eager: {same}; windows "
          f"through the graph: " + ", ".join(f"{n} {e.graph_windows}/{e.fused_windows}"
                                          for n, e in engines.items() if e.decode_steps > 1)
          + f"; the engine path's logits on the teacher-forced full forward's routes, "
          f"requests 0-{SRV_NOISE_ROWS - 1}: worst position rel {max(rels):.3e} (<= "
          f"{DEC_LOGIT_REL}); the streams are the full forward's argmax at {agree} of "
          f"{sum(map(len, ref))} positions")
    check(all(v == 0 for v in same.values()), "MoE dense/paged, eager/graph streams differ")
    check(max(rels) <= DEC_LOGIT_REL, "the MoE engine path's logits disagree with the full forward")
    for name, kw in SRV_RUNS.items():
        st = _serve_stats(_serve(engines[name], prompts, SRV_BUDGET), SRV_BATCH)
        print(f"[n] serve {name}: {st['tps']:.1f} tokens/s, occupancy {st['occ']:.3f}, TTFT "
              f"p50 {st['ttft_p50']:.2f} ms (max {st['ttft_max']:.2f}), TPOT p50 "
              f"{st['tpot_p50']:.3f} ms (max {st['tpot_max']:.3f})")
    del engines, runs, params
    torch.cuda.empty_cache()


def phase_moe() -> None:
    """(n): the mixture-of-experts model through train, eval, generate and
    serve at the flagship width, and a 1-layer MoE checkpoint."""
    from hivedscheduler_tpu_torch.parallel import topology

    t_phase = time.perf_counter()
    walls = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        walls[name] = time.perf_counter() - t0
        return out

    timed("layer", _moe_layer_check)
    cli = timed("train", _moe_train)
    timed("steps", _moe_steps, cli)
    timed("eval", _moe_eval)
    timed("generate", _moe_generate)
    timed("serve", _moe_serve)
    with _world_1_gang():
        mesh = topology.make_mesh(topology.MeshAxes(), "cuda")
        timed("checkpoint", _mesh_checkpoint, mesh, dict(n_experts=8, moe_top_k=2, n_layers=1),
              "[n]")
    print(f"[n] phase wall time {time.perf_counter() - t_phase:.1f} s ("
          + ", ".join(f"{name} {s:.1f} s" for name, s in walls.items()) + ")")


# phase (o): LoRA at the flagship width
LORA_RANK, LORA_ALPHA = 16, 32.0
LORA_FLAGS = ["--lora-rank", str(LORA_RANK), "--lora-alpha", str(LORA_ALPHA), "--lora-mlp"]
LORA_TURNS = 3  # rounds of (dense, lora, lora, dense) timed steps
# the random nonzero B factors of the merge check (std), and the merged
# model's logits on one window against the adapter forward, relative
# Frobenius: both run bf16 activations, the merged weights rounded once,
# the adapter terms rounded per product
LORA_B_STD = 0.02
LORA_MERGE_REL = 5e-2


def _lora_cfg(**over):
    from hivedscheduler_tpu_torch.models import transformer as tm

    kw = dict(max_seq_len=EVAL_SEQ, attn_impl="flash", remat="dots", lora_rank=LORA_RANK,
              lora_alpha=LORA_ALPHA, lora_mlp=True, **EVAL_MODEL)
    kw.update(over)
    return tm.TransformerConfig(**kw)


def _lora_train(ckdir: str, h_flash: dict) -> None:
    """``train`` with LoRA through ``train.main``: launches, losses against
    (h)'s, the checkpoint's base and adapters."""
    import torch

    from hivedscheduler_tpu_torch.models import transformer as tm
    from hivedscheduler_tpu_torch.ops import attention as attn
    from hivedscheduler_tpu_torch.parallel import checkpoint as ckpt

    attn.FLASH_FWD_LAUNCHES = attn.FLASH_BWD_DQ_LAUNCHES = attn.FLASH_BWD_DKV_LAUNCHES = 0
    records, peak = run_train("flash", TRAIN_STEPS,
                              args=TRAIN_ARGS + LORA_FLAGS + ["--checkpoint-dir", ckdir])
    launches = {"fwd": attn.FLASH_FWD_LAUNCHES, "dq": attn.FLASH_BWD_DQ_LAUNCHES,
                "dkv": attn.FLASH_BWD_DKV_LAUNCHES}
    layers = EVAL_MODEL["n_layers"]
    want = {"fwd": 2 * layers * TRAIN_STEPS, "dq": layers * TRAIN_STEPS,
            "dkv": layers * TRAIN_STEPS}
    losses = [r["loss"] for r in records]
    timed = [r for r in records if not r["compile"]]
    cli_ms = sum(r["wall_s"] for r in timed) / len(timed) * 1e3
    print(f"[o] train {' '.join(LORA_FLAGS)} --attn flash --remat dots: losses {losses} "
          f"(dense (h): {h_flash['losses']}); launches over {TRAIN_STEPS} steps {launches} "
          f"(want {want}); step {cli_ms} ms from the timeline (mean of {len(timed)} after "
          f"the warm-up); peak device memory {peak / 1e9:.2f} GB (dense (h): "
          f"{h_flash['peak'] / 1e9:.2f} GB)")
    check(launches == want, f"the LoRA train run launched {launches}, want {want}")
    check(losses[0] == h_flash["losses"][0],
          "the LoRA run's first loss is not the dense model's (zero-init adapters)")
    check(losses[1:] != h_flash["losses"][1:], "the LoRA run trained like the dense run")

    cfg = _lora_cfg()
    fresh = tm.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    saved = tm.init_params(cfg, torch.Generator(device="cuda").manual_seed(1), "cuda")
    step_no, _ = ckpt.restore_params(ckdir, saved)
    base_same = all(torch.equal(saved["layers"][k], t) for k, t in fresh["layers"].items()
                    if not k.startswith("lora_"))
    base_same &= all(torch.equal(saved[k], fresh[k]) for k in ("embed", "final_norm", "lm_head"))
    moved = {k: float((saved["layers"][k] - t).abs().max())
             for k, t in fresh["layers"].items() if k.startswith("lora_")}
    size = sum(os.path.getsize(os.path.join(root, f))
               for root, _, files in os.walk(ckdir) for f in files)
    print(f"[o] checkpoint step {step_no} ({size / 1e9:.3f} GB on disk: the base, the "
          f"adapters and their AdamW moments): base bit-identical to the seed-0 init "
          f"{base_same}; the adapters' max |change| {min(moved.values()):.3e} (least) to "
          f"{max(moved.values()):.3e} over {len(moved)} leaves")
    check(base_same, "the LoRA run changed its frozen base")
    check(min(moved.values()) > 0.0, "an adapter did not move")


def _lora_steps() -> None:
    """The LoRA step against the dense step, in turns by CUDA events."""
    import numpy as np
    import torch

    from hivedscheduler_tpu_torch.parallel import data as data_lib
    from hivedscheduler_tpu_torch.parallel import train as port_train

    cfg = _lora_cfg()
    loader = data_lib.CheckpointableBatches(
        data_lib.synthetic_dataset(cfg.vocab_size), EVAL_BATCH, EVAL_SEQ)
    tokens = [torch.from_numpy(np.asarray(next(loader))).cuda() for _ in range(2)]
    lstep, linit = port_train.make_lora_train_step(cfg, "cuda", ce_chunk=EVAL_CE_CHUNK)
    base, lora, lopt = linit(torch.Generator(device="cuda").manual_seed(0))
    dense_cfg = _lora_cfg(lora_rank=0, lora_mlp=False)
    dstep, dinit = port_train.make_train_step(dense_cfg, "cuda", ce_chunk=EVAL_CE_CHUNK)
    params, dopt = dinit(torch.Generator(device="cuda").manual_seed(0))

    def lora_step(_params, opt, toks):
        lora_out, opt, loss = lstep(base, lora, opt, toks)
        return _params, opt, loss

    _steps_by_events(lora_step, None, lopt, tokens)  # warm-up
    _steps_by_events(dstep, params, dopt, tokens[:1])
    runs = {"dense": (dstep, params, dopt), "lora": (lora_step, None, lopt)}
    turns = {"dense": [], "lora": []}
    # each step's own device memory: its peak above what was allocated
    # before it (both states stay resident)
    own = {}
    for _ in range(LORA_TURNS):
        for name in ("dense", "lora", "lora", "dense"):
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            turns[name] += _steps_by_events(*runs[name], tokens[:1])[1]
            own[name] = torch.cuda.max_memory_allocated() - before
    med = {name: sorted(ms)[len(ms) // 2] for name, ms in turns.items()}
    n_lora = sum(t.numel() for t in port_train._leaves(lora))
    print(f"[o] step ms in turns ({LORA_TURNS} x dense, lora, lora, dense; B={EVAL_BATCH}, "
          f"T={EVAL_SEQ}): "
          + "; ".join(f"{name} {', '.join(f'{x:.3f}' for x in ms)} (median {med[name]:.3f}, "
                      f"{EVAL_BATCH * EVAL_SEQ / (med[name] / 1e3):.1f} tokens/s)"
                      for name, ms in turns.items())
          + f"; lora / dense {med['lora'] / med['dense']:.3f}; {n_lora / 1e6:.3f} M adapter "
          f"parameters in {len(port_train._leaves(lora))} leaves; each step's peak above "
          f"its resident state: dense {own['dense'] / 1e9:.2f} GB, lora "
          f"{own['lora'] / 1e9:.2f} GB")
    for name, run in runs.items():
        wall_ms, total, parts = _step_profile(*run, tokens[0])
        if total == 0:
            print(f"[o] profiler: no device time recorded for the {name} step (not measured)")
            continue
        print(f"[o] profile of one {name} step: wall {wall_ms:.1f} ms, device busy "
              f"{total:.1f} ms; " + ", ".join(f"{k} {v:.1f} ms ({v / total:.1%})"
                                             for k, v in parts.items()))
    del base, lora, lopt, params, dopt, runs
    torch.cuda.empty_cache()


def _lora_merge(ckdir: str) -> None:
    """The checkpoint through ``restore_serving_params``; the merge against
    the adapter forward with random nonzero B, and its planted fault."""
    import dataclasses as dc

    import numpy as np
    import torch

    from hivedscheduler_tpu_torch.models import transformer as tm
    from hivedscheduler_tpu_torch.parallel import checkpoint as ckpt
    from hivedscheduler_tpu_torch.parallel import data as data_lib

    cfg = _lora_cfg()
    base_cfg = _lora_cfg(lora_rank=0, lora_mlp=False)
    merged, step_no = ckpt.restore_serving_params(
        dc.replace(base_cfg, remat="full"), ckdir, torch.Generator(device="cuda").manual_seed(0),
        lora_rank=LORA_RANK, lora_alpha=LORA_ALPHA, lora_mlp=True)
    tree = tm.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    ckpt.restore_params(ckdir, tree)
    want = tm.merge_lora(tree, cfg)
    same = all(torch.equal(merged["layers"][k], t) for k, t in want["layers"].items())
    check(same and not any(k.startswith("lora_") for k in merged["layers"]),
          "restore_serving_params did not merge the checkpoint's adapters")
    del merged, want
    gen = torch.Generator(device="cuda").manual_seed(2)
    for name, t in tree["layers"].items():
        if name.startswith("lora_") and name.endswith("_b"):
            t.normal_(0.0, LORA_B_STD, generator=gen)
    loader = data_lib.CheckpointableBatches(
        data_lib.synthetic_dataset(cfg.vocab_size), 2, EVAL_SEQ, seed=5)
    window = torch.from_numpy(np.asarray(next(loader))).cuda()
    with torch.inference_mode():
        adapted = tm.forward(tree, window, cfg)
        merged = tm.forward(tm.merge_lora(tree, cfg), window, base_cfg)
        dropped = tm.forward(tm.split_lora_params(tree)[0], window, base_cfg)
    errs = {name: rel_errs(x, adapted) for name, x in (("merged", merged),
                                                       ("dropped", dropped))}
    print(f"[o] restore_serving_params(lora_rank={LORA_RANK}, ...) of step {step_no}: "
          f"equal to merge_lora of the restored tree; with random B (std {LORA_B_STD}) "
          f"the merged model's logits on one window (B=2, T={EVAL_SEQ}) against the adapter "
          f"forward: relative Frobenius {errs['merged'][0]:.3e}, worst position "
          f"{errs['merged'][1]:.3e} (<= {LORA_MERGE_REL}); planted fault (adapters dropped "
          f"at the merge): {errs['dropped'][0]:.3e}, worst position {errs['dropped'][1]:.3e}")
    check(errs["merged"][0] <= LORA_MERGE_REL, "the merged model does not compute the adapters'")
    check(errs["dropped"][0] > LORA_MERGE_REL, "the merge check does not see dropped adapters")
    del tree, adapted, merged, dropped
    torch.cuda.empty_cache()


def phase_lora(h_flash: dict) -> str:
    """(o): LoRA fine-tuning at the flagship width. Returns the directory of
    its checkpoint, which (p) serves; the caller removes it."""
    t_phase = time.perf_counter()
    ckdir = tempfile.mkdtemp(prefix="chip-smoke-lora-")
    walls = {}
    try:
        for name, fn, args in (("train", _lora_train, (ckdir, h_flash)),
                               ("steps", _lora_steps, ()), ("merge", _lora_merge, (ckdir,))):
            t0 = time.perf_counter()
            fn(*args)
            walls[name] = time.perf_counter() - t0
    except BaseException:
        shutil.rmtree(ckdir, ignore_errors=True)
        raise
    print(f"[o] phase wall time {time.perf_counter() - t_phase:.1f} s ("
          + ", ".join(f"{name} {s:.1f} s" for name, s in walls.items()) + ")")
    return ckdir


# phase (p): speculative serving on (k)'s trace
SPEC_GAMMA = 4
SPEC_SAMPLING = dict(temperature=0.8, top_k=40, seed=5)
SPEC_CLI_ARGS = [a for k, v in EVAL_MODEL.items()
                 for a in (f"--{k.replace('_', '-')}", str(v))] + LORA_FLAGS + [
    "--spec-decode", "--requests", "8", "--max-batch", "8", "--max-len", "128",
    "--max-new-tokens", "16", "--device", "cuda"]


def _differing_share(a: list, b: list) -> float:
    n = sum(len(x) for x in a)
    return sum(x != y for s, t in zip(a, b) for x, y in zip(s, t)) / n


def phase_spec(srv: dict, lora_dir: str) -> None:
    """(p): the speculative engine on (k)'s trace: the CLI's draft and the
    target as its own draft, dense and paged, greedy and sampled; times in
    turns against the plain engine; the serve CLI on (o)'s checkpoint."""
    import torch

    from hivedscheduler_tpu_torch.chaos import invariants as inv
    from hivedscheduler_tpu_torch.models import serving as srv_lib
    from hivedscheduler_tpu_torch.models import transformer as tm
    from hivedscheduler_tpu_torch.models.speculative import (
        SpecDecodeConfig,
        derive_draft_config,
    )
    from hivedscheduler_tpu_torch.ops import attention as attn

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    cfg = tm.TransformerConfig(max_seq_len=SRV_MAX_LEN, **EVAL_MODEL)
    params = tm.cast_params(tm.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda"), cfg.dtype)
    prompts, ref, full, noise = srv["prompts"], srv["ref"], srv["full"], srv["noise"]
    dcfg = derive_draft_config(cfg, 2, 0)
    dparams = tm.cast_params(tm.init_params(
        dcfg, torch.Generator(device="cuda").manual_seed(3), "cuda"), dcfg.dtype)

    def engine(draft=None, **kw):
        if draft is not None:
            kw["spec_decode"] = SpecDecodeConfig(draft_params=draft[0], draft_cfg=draft[1],
                                                 gamma=SPEC_GAMMA)
        return srv_lib.ServingEngine(params, cfg, max_batch=SRV_BATCH, max_len=SRV_MAX_LEN,
                                     **kw)

    attn.FLASH_FWD_LAUNCHES = attn.FLASH_BWD_DQ_LAUNCHES = attn.FLASH_BWD_DKV_LAUNCHES = 0
    runs, engines = {}, {}
    for name, draft, kw in (("cli draft", (dparams, dcfg), {}),
                            ("self draft dense", (params, cfg), {}),
                            ("self draft paged", (params, cfg), dict(page_size=SRV_PAGE))):
        engines[name] = engine(draft, **kw)
        runs[name] = _serve(engines[name], prompts, SRV_BUDGET)
        if engines[name].paged:
            inv.check_block_pool(engines[name], name)
            check(engines[name].blocks_in_use == 0, f"{name}: blocks left in use")
    flash = (attn.FLASH_FWD_LAUNCHES, attn.FLASH_BWD_DQ_LAUNCHES, attn.FLASH_BWD_DKV_LAUNCHES)
    check(flash == (0, 0, 0), f"speculative serving launched the flash kernels {flash}")
    for name, run in runs.items():
        eng, streams = engines[name], _streams(run)
        bad, parted = _parts_at_ties(full, ref, streams, noise)
        st = _serve_stats(run, SRV_BATCH)
        print(f"[p] {name} (gamma {SPEC_GAMMA}, {len(prompts)} requests, budget "
              f"{SRV_BUDGET}): acceptance {eng.acceptance:.4f} ({eng.accepted}/{eng.drafted}), "
              f"{eng.steps} rounds; {parted} requests part from the plain greedy streams of "
              f"(k), {bad} of them at a decisive position (margin > 2 x {noise:.3e}); "
              f"{_differing_share(ref, streams):.4f} of tokens differ; this first run "
              f"{st['tps']:.1f} tokens/s, TTFT p50 {st['ttft_p50']:.2f} ms, TPOT p50 "
              f"{st['tpot_p50']:.3f} ms")
        check(all(len(s) == SRV_BUDGET for s in streams), f"{name}: a stream fell short")
        check(bad == 0, f"{name}: a stream parts from greedy at a decisive position")
    same = sum(a != b for a, b in zip(_streams(runs["self draft dense"]),
                                      _streams(runs["self draft paged"])))
    print(f"[p] self draft dense against paged: {same} requests differ")
    check(same == 0, "the self-draft engine's dense and paged streams differ")
    check(engines["self draft dense"].acceptance > 0.5, "the perfect draft accepts too little")

    # times in turns: the plain engine eager and with graph windows, the
    # self-draft engine dense and paged
    engines["plain eager"] = engine()
    engines["plain graph"] = engine(decode_steps=SRV_STEPS)
    _serve(engines["plain graph"], prompts, SRV_BUDGET)  # warm: captures the graph
    order = ("plain eager", "plain graph", "self draft dense", "self draft paged")
    timed = {name: [] for name in order}
    for name in order + order[::-1]:
        run = _serve(engines[name], prompts, SRV_BUDGET)
        if name.startswith("plain"):
            check(_streams(run) == ref, f"{name}: a timed run's streams differ")
        else:
            check(_streams(run) == _streams(runs[name]), f"{name}: a timed run's streams differ")
        timed[name].append(_serve_stats(run, SRV_BATCH))
    print("[p] in turns (plain eager, plain graph, self dense, self paged, then reversed; "
          f"one arrival every {SRV_ARRIVAL} engine steps, so a round's length spaces the "
          "arrivals too): "
          + "; ".join(f"{n}: {', '.join(f'{s['tps']:.1f}' for s in st)} tokens/s, TTFT p50 "
                      f"{', '.join(f'{s['ttft_p50']:.2f}' for s in st)} ms, TPOT p50 "
                      f"{', '.join(f'{s['tpot_p50']:.3f}' for s in st)} ms"
                      for n, st in timed.items()))
    # the whole trace at once: every slot busy from the first step
    burst = {name: [] for name in order[:3]}
    for name in order[:3] + order[2::-1]:
        run = _serve(engines[name], prompts, SRV_BUDGET, arrival_every=1, burst=SRV_REQUESTS)
        burst[name].append(_serve_stats(run, SRV_BATCH))
    print("[p] the trace's 16 requests at once, in turns (plain eager, plain graph, self "
          "dense, then reversed): "
          + "; ".join(f"{n}: {', '.join(f'{s['tps']:.1f}' for s in st)} tokens/s, TPOT p50 "
                      f"{', '.join(f'{s['tpot_p50']:.3f}' for s in st)} ms"
                      for n, st in burst.items()))
    del engines, runs

    # sampled with the perfect draft, against the plain sampled engine
    plain = _streams(_serve(engine(**SPEC_SAMPLING), prompts, SRV_BUDGET))
    sampled = []
    for _ in range(2):
        eng = engine((params, cfg), **SPEC_SAMPLING)
        sampled.append(_streams(_serve(eng, prompts, SRV_BUDGET)))
    print(f"[p] sampled (temperature {SPEC_SAMPLING['temperature']}, top_k "
          f"{SPEC_SAMPLING['top_k']}) with the perfect draft: acceptance {eng.acceptance:.4f}; "
          f"{1 - _differing_share(plain, sampled[0]):.4f} of tokens equal to the plain sampled "
          f"engine's ({sum(a == b for a, b in zip(plain, sampled[0]))} of {len(plain)} streams "
          f"whole); two runs identical: {sampled[0] == sampled[1]}")
    check(sampled[0] == sampled[1], "two sampled speculative runs differ")
    check(all(0 <= t < cfg.vocab_size and len(s) == SRV_BUDGET
              for s in sampled[0] for t in s), "a sampled stream is short or out of vocab")
    del params, dparams, eng
    torch.cuda.empty_cache()

    # fine-tune, then serve: the serve CLI on (o)'s checkpoint
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "hivedscheduler_tpu_torch.serve"]
                          + SPEC_CLI_ARGS + ["--checkpoint-dir", lora_dir], cwd=REPO,
                          capture_output=True, text=True, timeout=600)
    cli_s = time.perf_counter() - t0
    rows = [line for line in proc.stdout.splitlines() if line.startswith("[")]
    said = [line.split("] ", 1)[-1] for line in proc.stderr.splitlines()
            if "speculation:" in line or "merged rank" in line or "tok/s" in line]
    print(f"[p] python -m hivedscheduler_tpu_torch.serve {' '.join(LORA_FLAGS)} --spec-decode "
          f"on (o)'s checkpoint: exit {proc.returncode} in {cli_s:.1f} s, {len(rows)} request "
          f"lines; " + " | ".join(said))
    ok = (proc.returncode == 0 and len(rows) == 8 and any("speculation:" in l for l in said)
          and any("merged rank-16" in l for l in said))
    if not ok:
        print(proc.stderr[-4000:])
    check(ok, "serve --lora-rank --spec-decode did not finish as it should")
    print(f"[p] phase wall time {time.perf_counter() - t_phase:.1f} s")


# phases (q) and (r): public model widths whose head dim is neither 64 nor
# 128, each written as the CLI flags both packages accept, with random
# weights from seed 0, driven through eval, train, generate and serve.
#
# (q) Phi-3-mini's width, as microsoft/Phi-3-mini-4k-instruct's published
# config.json gives it: vocab 32064, d_model 3072, 32 heads, 32 kv heads
# (MHA), d_ff 8192, rope theta 10000 (both packages' default): head dim 96,
# which K1-K3 run at their padded width 128. SwiGLU, RMSNorm, RoPE, an
# untied lm_head and no biases are the repo's own architecture. Departures:
# RMSNorm eps is 1e-6 in both packages (Phi-3: 1e-5; no flag sets it); the
# config's sliding_window (2047) is absent from the repo's model (at seq 2048
# it would change at most the last row's first key). Cut to size: eval runs
# all 32 layers (15.3 GB of f32 weights), train 6 (0.877 B parameters x 16 B
# of weights, gradients and AdamW moments = 14.0 GB; 32 layers would need
# 3.82 B x 16 B = 61 GB before activations), generate and serve 6.
#
# (r) Gemma-2B's width, as google/gemma-2b's published config.json gives it:
# vocab 256000, d_model 2048, 8 heads, 1 kv head (MQA), d_ff 16384, rope
# theta 10000, RMSNorm eps 1e-6 (both packages'): head dim 256 (d_model /
# n_heads, as both packages derive it), which K1-K3 run at their padded
# width 256. Departures from Gemma: SwiGLU, not GeGLU; an untied lm_head
# (524 M parameters more); no sqrt(d_model) scaling of the embedding; the
# plain RMSNorm weight, not (1 + w); seq 2048, not 8192. Cut to size: eval
# runs all 18 layers (3.03 B parameters, 12.1 GB of f32 weights), train 6
# (1.71 B x 16 B = 27.3 GB; 18 layers would need 48.5 GB before
# activations), generate and serve 6. Its 8 x 256 query columns a token
# equal the flagship's 16 x 128, so K1-K3 at its training shape do the
# flagship's work exactly, and the two are timed in turns.
@dataclasses.dataclass(frozen=True)
class Width:
    tag: str  # the phase's tag in the output
    name: str
    model: dict  # vocab_size, d_model, n_heads, n_kv_heads, d_ff
    eval_layers: int  # eval runs every layer
    layers: int  # train, generate and serve

    @property
    def d(self) -> int:
        return self.model["d_model"] // self.model["n_heads"]

    @property
    def shape(self) -> dict:
        """K1-K3's shape on the eval and train path."""
        return dict(b=EVAL_BATCH, t=EVAL_SEQ, h=self.model["n_heads"],
                    h_kv=self.model["n_kv_heads"], d=self.d)

    def args(self, layers: int, train: bool) -> list:
        flags = [a for k, v in self.model.items() for a in (f"--{k.replace('_', '-')}", str(v))]
        flags += ["--n-layers", str(layers)]
        if train:
            flags += ["--rope-theta", "10000"]
        flags += ["--seq-len", str(EVAL_SEQ), "--batch", str(EVAL_BATCH),
                  "--ce-chunk", str(EVAL_CE_CHUNK), "--device", "cuda"]
        if train:
            flags += ["--remat", "dots", "--log-every", "1"]
        return flags


PHI3 = Width("[q]", "Phi-3-mini", dict(vocab_size=32064, d_model=3072, n_heads=32,
                                       n_kv_heads=32, d_ff=8192),
             eval_layers=32, layers=6)
GEMMA = Width("[r]", "Gemma-2B", dict(vocab_size=256000, d_model=2048, n_heads=8,
                                      n_kv_heads=1, d_ff=16384),
              eval_layers=18, layers=6)
# the head dims the kernels run at a padded width, each checked causal and
# not at a ragged T: (q) 32 at 64; 80, 96 and 112 at 128, with GQA (a group
# of 4); (r) 136, 192 and 256 at 256, with MQA and a GQA group of 4
PADDED_DIMS = (32, 80, 96, 112)
PADDED_CASES = (dict(b=2, t=200, h=8, h_kv=2),)
WIDE_DIMS = (136, 192, 256)
WIDE_CASES = (dict(b=2, t=200, h=8, h_kv=1), dict(b=2, t=200, h=8, h_kv=2))
SENTINEL = -7777.0  # the columns past D of a wider output buffer
WIDTH_TIMED_WINDOWS = 4  # eval windows timed for each attention
PAD_TURNS = 2  # rounds of (reference shape, width's, width's, reference) kernel timings
# one sp = 4 rank's ring hop at Gemma-2B's heads, for K1-K3's f32 forms
GEMMA_HOP = dict(b=1, t=2048, h=8, h_kv=1, d=256)


def _padded(d: int) -> int:
    return 64 if d <= 64 else 128 if d <= 128 else 256


def _work_factor(key: str, dp: int) -> float:
    """The work the kernel ``key`` does at the padded width ``dp``, over the
    work of its products at that width: at 256 K1 computes s twice (3/2), K2
    its two score products (5/3) and K3 its two (3/2), as flash_fwd.cu and
    flash_bwd.cu say."""
    if dp <= 128:
        return 1.0
    return 5 / 3 if key == "dq" else 3 / 2


def _spread_heads(x):
    """Odd heads doubled: neighbouring heads hold very different values, so
    a kernel that read the next head's columns would be far off."""
    import torch

    scale = 1.0 + torch.arange(x.shape[2], device=x.device, dtype=torch.float32) % 2
    return (x.float() * scale[:, None]).to(x.dtype)


def _over_read(x, dp: int):
    """[B, T, H, dp] of what a kernel that read dp columns of a contiguous
    [B, T, H, D] tensor would see: each head's D columns, then the next
    head's first dp - D (zeros past the tensor's end)."""
    import torch

    b, t, h, d = x.shape
    flat = torch.cat([x.reshape(-1), x.new_zeros(dp)])
    return flat.as_strided((b, t, h, dp), (t * h * d, h * d, d, 1)).contiguous()


def _zero_padded(x, dp: int):
    import torch.nn.functional as F

    return F.pad(x, (0, dp - x.shape[-1])).contiguous()


def _wide_outputs(shapes, d: int, dtype, width: int):
    """For each shape [B, T, H, D]: a [B, T, H, width] buffer of SENTINEL and
    its view of the first ``d`` columns, which a kernel stores through its
    strides."""
    import torch

    out = []
    for shape in shapes:
        buf = torch.full((*shape[:3], width), SENTINEL, dtype=dtype, device="cuda")
        out.append((buf, buf[..., :d]))
    return out


def _launch_all(q, k, v, do, lse, o16, d_launch: int, causal: bool, f32: bool, outs):
    """K1, K2 and K3 (their f32 forms if ``f32``) through their C entry
    points into the views ``outs`` = (o, dq, dk, dv), at head dim
    ``d_launch``; returns K1's lse and K2's delta. Checks only: nothing is
    counted."""
    import torch

    from hivedscheduler_tpu_torch.ops import attention as attn

    sfx = "_f32" if f32 else ""
    b, t, h, _ = q.shape
    dims = (b, t, h, k.shape[2], d_launch, int(causal))
    stream = torch.cuda.current_stream().cuda_stream
    o, dq, dk, dv = outs
    lse2, delta = torch.empty_like(lse), torch.empty_like(lse)
    attn._launch("hived_flash_fwd" + sfx, (q, k, v, o, lse2), dims, (q, k, v, o), stream)
    attn._launch("hived_flash_bwd_dq" + sfx, (q, k, v, o16, do, lse, delta, dq), dims,
                 (q, k, v, o16, do, dq), stream)
    attn._launch("hived_flash_bwd_dkv" + sfx, (q, k, v, do, lse, delta, dk, dv), dims,
                 (q, k, v, do, dk, dv), stream)
    torch.cuda.synchronize()
    return lse2, delta


def _padded_case(tag: str, d: int, case: dict, causal: bool, seed: int, plant: bool) -> None:
    """K1-K3 and their f32 forms at head dim ``d`` against their plain
    versions (the limits of (b), (f) and (m)); the f32 outputs rounded once
    to bf16 equal to the bf16 kernels'; every output stored through a view
    into a buffer at least 128 wide (the padded width) whose other columns
    must keep their sentinel (64 columns past D where D is the padded width
    itself); with ``plant``, the two faults the padding invites: a kernel
    that reads the next head's columns, and one that stores past D."""
    import torch

    from hivedscheduler_tpu_torch.ops import attention as attn

    f32 = torch.float32
    b, t, h, h_kv, dp = case["b"], case["t"], case["h"], case["h_kv"], _padded(d)
    width = max(128, dp) if dp > d else d + 64
    q, k, v = (_spread_heads(x) for x in make_qkv(b, t, h, h_kv, d, seed=seed))
    do = _spread_heads(make_qkv(b, t, h, h_kv, d, seed=seed + 1)[0])
    o16, lse = attn.flash_forward(q, k, v, causal=causal)
    o32, lse32 = attn.flash_forward(q, k, v, causal=causal, out_dtype=f32)
    g16 = attn.flash_backward(q, k, v, o16, lse, do, causal=causal)
    g32 = attn.flash_backward(q, k, v, o16, lse, do, causal=causal, grad_dtype=f32)
    o_ref, lse_ref = attn.flash_attention_plain(q, k, v, causal=causal, out_dtype=f32)
    g_ref = attn.flash_backward_plain(q, k, v, o16, lse, do, causal=causal, grad_dtype=f32)
    torch.cuda.synchronize()
    errs = {}
    for form, o, grads in (("bf16", o16, g16), ("f32", o32, g32)):
        errs[form] = [("o",) + rel_errs(o, o_ref)] + [
            (n,) + rel_errs(x, r, floor=1e-3) for n, x, r in zip(("dq", "dk", "dv"), grads, g_ref)]
    lse_err = float((lse - lse_ref).abs().max())
    same = (torch.equal(o32.to(torch.bfloat16), o16) and torch.equal(lse32, lse)
            and all(torch.equal(x.to(torch.bfloat16), y) for x, y in zip(g32, g16)))
    # every kernel into wide buffers: the sentinels stay, the views equal the
    # wrappers' outputs bit for bit
    kept, equal = True, True
    for dtype, o, grads in ((torch.bfloat16, o16, g16), (f32, o32, g32)):
        wide = _wide_outputs((q.shape, q.shape, k.shape, v.shape), d, dtype, width)
        _launch_all(q, k, v, do, lse, o16, d, causal, dtype == f32, [w[1] for w in wide])
        kept &= all(bool((buf[..., d:] == SENTINEL).all()) for buf, _ in wide)
        equal &= all(torch.equal(view, x) for (_, view), x in zip(wide, (o, *grads)))
    print(f"{tag} D={d} (run at {dp}) B={b} T={t} H={h} H_kv={h_kv} causal={causal}: "
          + "; ".join(f"{form} " + ", ".join(f"{n} rel {fr:.3e} worst row {rw:.3e}"
                                            for n, fr, rw in e) for form, e in errs.items())
          + f"; max|lse err| {lse_err:.3e} (limits o {O_REL}/{O_ROW_REL}, gradients "
          f"{GRAD_REL}/{GRAD_ROW_REL}, lse {LSE_ATOL}); f32 forms rounded equal to bf16: "
          f"{same}; sentinel columns {d}-{width - 1} untouched: {kept}; views equal the "
          f"outputs: {equal}")
    for form, e in errs.items():
        fo, ro = e[0][1:]
        check(fo <= O_REL and ro <= O_ROW_REL, f"D={d} {form}: K1 disagrees with its plain version")
        check(all(fr <= GRAD_REL and rw <= GRAD_ROW_REL for _, fr, rw in e[1:]),
              f"D={d} {form}: K2/K3 disagree with their plain version")
    check(lse_err <= LSE_ATOL, f"D={d}: K1's lse disagrees with its plain version")
    check(same, f"D={d}: the f32 forms, rounded to bf16, differ from the bf16 kernels")
    check(kept, f"D={d}: a kernel stored past the head dim")
    check(equal, f"D={d}: a kernel's output through a strided view differs")
    if not plant or dp == d:  # no padding columns to read or store
        return
    # planted fault 1: a kernel that reads the next head's columns, i.e. the
    # kernel at the padded width on over-read inputs (q rescaled so that the
    # scale is the real D's)
    qo = (_over_read(q, dp).float() * (dp / d) ** 0.5).to(torch.bfloat16)
    ko, vo, doo = (_over_read(x, dp) for x in (k, v, do))
    oo, lseo = attn.flash_forward(qo, ko, vo, causal=causal)
    go = attn.flash_backward(qo, ko, vo, oo, lseo, doo, causal=causal)
    bad_o = rel_errs(oo[..., :d], o_ref)[1]
    bad_g = [rel_errs(x[..., :d], r, floor=1e-3)[1] for x, r in zip(go, g_ref)]
    # planted fault 2: a kernel that stores every padded column, i.e. the
    # kernel at the padded width on zero-padded inputs into the same buffers
    wide = _wide_outputs((q.shape, q.shape, k.shape, v.shape), dp, torch.bfloat16, width)
    qz, kz, vz, doz, oz = (_zero_padded(x, dp) for x in (q, k, v, do, o16))
    _launch_all((qz.float() * (dp / d) ** 0.5).to(torch.bfloat16), kz, vz, doz, lse, oz, dp,
                causal, False, [w[1] for w in wide])
    overwritten = [not bool((buf[..., d:] == SENTINEL).all()) for buf, _ in wide]
    print(f"{tag} D={d} planted faults: the next head's columns read: worst rows o "
          f"{bad_o:.3e}, " + ", ".join(f"{n} {x:.3e}" for n, x in zip(("dq", "dk", "dv"), bad_g))
          + f"; every padded column stored: sentinels overwritten in o, dq, dk, dv "
          f"{overwritten}")
    check(bad_o > O_ROW_REL and all(x > GRAD_ROW_REL for x in bad_g),
          f"D={d}: the checks do not see a kernel that reads the next head's columns")
    check(all(overwritten), f"D={d}: the sentinel check does not see a store past D")


def _width_kernel_check(w: Width, dims, cases, seed0: int) -> dict:
    """1: every head dim of ``dims`` at each of ``cases``, causal (with the
    planted faults at the first case, where D is padded) and not; then K1-K3
    at the width's shape against their plain versions, run twice
    bit-identical; returns that shape's max |err|."""
    import torch

    from hivedscheduler_tpu_torch.ops import attention as attn

    for i, d in enumerate(dims):
        for j, case in enumerate(cases):
            for causal in (True, False):
                _padded_case(w.tag, d, case, causal, seed=seed0 + 2 * (i * len(cases) + j),
                             plant=causal and j == 0)
    p = w.shape
    q, k, v = make_qkv(p["b"], p["t"], p["h"], p["h_kv"], p["d"], seed=100)
    do = make_qkv(p["b"], p["t"], p["h"], p["h_kv"], p["d"], seed=101)[0]
    o, lse = attn.flash_forward(q, k, v)
    o_ref, lse_ref = attn.flash_attention_plain(q, k, v)
    o_fro, o_row = rel_errs(o, o_ref)
    got = attn.flash_backward(q, k, v, o, lse, do)
    ref = attn.flash_backward_plain(q, k, v, o, lse, do)
    again = (*attn.flash_forward(q, k, v), *attn.flash_backward(q, k, v, o, lse, do))
    torch.cuda.synchronize()
    twice = all(torch.equal(x, y) for x, y in zip((o, lse, *got), again))
    g_errs = [rel_errs(x, r, floor=1e-3) for x, r in zip(got, ref)]
    max_err = {"fwd": float((o.float() - o_ref.float()).abs().max()),
               "dq": float((got[0].float() - ref[0].float()).abs().max()),
               "dkv": max(float((x.float() - r.float()).abs().max())
                          for x, r in zip(got[1:], ref[1:]))}
    print(f"{w.tag} {w.name} shape q [{p['b']},{p['t']},{p['h']},{p['d']}] k/v "
          f"[{p['b']},{p['t']},{p['h_kv']},{p['d']}] causal: K1 o rel {o_fro:.3e} worst row "
          f"{o_row:.3e}, max|lse err| {float((lse - lse_ref).abs().max()):.3e}; K2/K3 "
          + ", ".join(f"{n} rel {fr:.3e} worst row {rw:.3e}"
                      for n, (fr, rw) in zip(("dq", "dk", "dv"), g_errs))
          + f"; max|err| {max_err}; run twice bit-identical {twice}")
    check(o_fro <= O_REL and o_row <= O_ROW_REL, f"K1 at the {w.name} shape disagrees")
    check(float((lse - lse_ref).abs().max()) <= LSE_ATOL,
          f"K1's lse at the {w.name} shape disagrees")
    check(all(fr <= GRAD_REL and rw <= GRAD_ROW_REL for fr, rw in g_errs),
          f"K2/K3 at the {w.name} shape disagree")
    check(twice, f"K1-K3 at the {w.name} shape are not bit-reproducible")
    del q, k, v, do, o, lse, o_ref, lse_ref, got, ref, again
    torch.cuda.empty_cache()
    return max_err


def _sdpa_backend(q, k, v, enable_gqa: bool) -> str:
    """The backend ``scaled_dot_product_attention`` picks for these
    [B, H, T, D] inputs, causal (PyTorch's own choice function)."""
    import torch
    from torch.nn.attention import SDPBackend

    choice = int(torch._fused_sdp_choice(q, k, v, None, 0.0, True, enable_gqa=enable_gqa))
    return {int(b.value): n for n, b in SDPBackend.__members__.items()}.get(choice, str(choice))


def _bound(key: str, s: dict):
    """(bound ms, what bounds it, flops, bytes) of kernel ``key`` at the
    causal shape ``s``: its products at the real D, each input read once and
    each output written once."""
    from hivedscheduler_tpu_torch.ops import attention as attn

    b, t, h, h_kv, d = s["b"], s["t"], s["h"], s["h_kv"], s["d"]
    if key == "fwd":
        flops, nbytes = attn.attention_flops(b, t, h, d, True), attn.attention_bytes(b, t, h, h_kv, d)
    else:
        flops = attn.attention_bwd_flops(b, t, h, d, True)[key]
        nbytes = attn.attention_bwd_bytes(b, t, h, h_kv, d)[key]
    ops_ms, bytes_ms = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
    return max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms else "bytes", flops, nbytes


def _width_kernel_times(w: Width, ref: dict, ref_name: str) -> dict:
    """2: K1, K2 and K3 at the width's shape against the same kernels at
    ``ref``'s, in turns (``ops/kernel_ab.py``'s inputs and launches); each
    beside its bound at the real D, the plain version and
    ``scaled_dot_product_attention``."""
    import torch
    import torch.nn.functional as F

    from hivedscheduler_tpu_torch.ops import attention as attn
    from hivedscheduler_tpu_torch.ops import kernel_ab

    shapes = {"this": w.shape, "ref": ref}
    x = {name: kernel_ab.inputs(s["b"], s["t"], s["h"], s["h_kv"], s["d"], seed=110)
         for name, s in shapes.items()}
    readings = {key: {"this": [], "ref": []} for key in kernel_ab.KERNELS}
    for _ in range(PAD_TURNS):
        for key in kernel_ab.KERNELS:
            for name in ("ref", "this", "this", "ref"):
                fn = kernel_ab.runner(None, x[name], {}, key)
                readings[key][name].append(time_ms(fn, iters=20, warmup=3))
    q, k, v, o, lse, do = (x["this"][n] for n in ("q", "k", "v", "o", "lse", "do"))
    plain = {"fwd": time_ms(lambda: attn.flash_attention_plain(q, k, v), iters=2, warmup=1)}
    plain["dq"] = plain["dkv"] = time_ms(
        lambda: attn.flash_backward_plain(q, k, v, o, lse, do), iters=2, warmup=1)
    gqa = k.shape[2] != q.shape[2]
    qt, kt, vt = (y.transpose(1, 2).contiguous() for y in (q, k, v))
    qg, kg, vg = (y.clone().requires_grad_(True) for y in (qt, kt, vt))
    backend = _sdpa_backend(qt, kt, vt, gqa)
    lib_out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True, enable_gqa=gqa)
    dout = do.transpose(1, 2).contiguous()
    library = {"fwd": time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=gqa), iters=20, warmup=3)}
    library["dq"] = library["dkv"] = time_ms(
        lambda: torch.autograd.grad(lib_out, (qg, kg, vg), dout, retain_graph=True),
        iters=20, warmup=3)
    s, r = shapes["this"], shapes["ref"]
    timing = {}
    for key in kernel_ab.KERNELS:
        bound = {name: _bound(key, sh) for name, sh in shapes.items()}
        med = {name: sorted(rd)[len(rd) // 2] for name, rd in readings[key].items()}
        real = bound["this"][2] / bound["ref"][2]
        done = {name: _padded(sh["d"]) / sh["d"] * _work_factor(key, _padded(sh["d"]))
                for name, sh in shapes.items()}
        print(f"{w.tag} {key} at the {w.name} shape [{s['b']},{s['t']},{s['h']}/{s['h_kv']},"
              f"{s['d']}] against the {ref_name} [{r['b']},{r['t']},{r['h']}/{r['h_kv']},"
              f"{r['d']}], causal, in turns: "
              + "; ".join(f"{'D=%d' % shapes[n]['d']}: kernel_ms "
                          f"{', '.join(f'{t:.4f}' for t in readings[key][n])} (median "
                          f"{med[n]:.4f}), bound_ms {bound[n][0]:.4f} ({bound[n][1]}: "
                          f"{bound[n][2] / 1e9:.1f} GFLOP, {bound[n][3] / 1e6:.1f} MB) -> "
                          f"{bound[n][0] / med[n]:.1%} of the bound" for n in ("this", "ref"))
              + f"; time ratio {med['this'] / med['ref']:.3f} (the real work "
              f"{real:.3f}, the work done {real * done['this'] / done['ref']:.3f}); plain_ms "
              f"{plain[key]:.3f}, library_ms {library[key]:.4f} "
              f"({'forward' if key == 'fwd' else 'whole backward'}, SDPA backend {backend})")
        timing[key] = dict(ms=med["this"], plain_ms=plain[key], library_ms=library[key],
                           bound_ms=bound["this"][0], bound_by=bound["this"][1])
    del x, q, k, v, o, lse, do, qt, kt, vt, qg, kg, vg, lib_out, dout
    torch.cuda.empty_cache()
    return timing


def _width_eval(w: Width) -> int:
    """3: eval at every layer, flash against xla; K1's launches."""
    from hivedscheduler_tpu_torch.ops import attention as attn

    args = w.args(w.eval_layers, train=False)
    attn.FLASH_FWD_LAUNCHES = 0
    loss_f, _, _ = run_eval("flash", EVAL_WINDOWS, args)
    launches = attn.FLASH_FWD_LAUNCHES
    loss_x, _, _ = run_eval("xla", EVAL_WINDOWS, args)
    print(f"{w.tag} eval at {w.name}'s width ({w.eval_layers} layers): loss flash "
          f"{loss_f:.6f} (K1 launches {launches}, want {w.eval_layers} x {EVAL_WINDOWS}), "
          f"xla {loss_x:.6f}: |flash - xla| {abs(loss_f - loss_x):.3e} (<= {LOSS_ATOL})")
    check(launches == w.eval_layers * EVAL_WINDOWS, f"{w.name} eval launched K1 {launches} times")
    check(abs(loss_f - loss_x) <= LOSS_ATOL, f"{w.name} flash and xla eval losses disagree")
    for impl in ("flash", "xla"):
        _, window_ms, tokens_per_s = run_eval(impl, WIDTH_TIMED_WINDOWS, args)
        print(f"{w.tag} eval window --attn {impl} (B={EVAL_BATCH}, T={EVAL_SEQ}, "
              f"{w.eval_layers} layers, {WIDTH_TIMED_WINDOWS} windows): {window_ms} ms, "
              f"{tokens_per_s} tokens/s")
    phase_hidden_check(dict(w.model, n_layers=w.eval_layers), w.tag,
                       f"one {w.name} window, {w.eval_layers} layers")
    return launches


def _width_train(w: Width, ring: bool = False) -> dict:
    """4: train, flash against xla; the launches, step ms, tokens/s and
    peak memory, then one step's gradients by leaf group. With ``ring``,
    also ``--attn ring_flash`` at sp = 1, whose losses must equal flash's
    (the f32 forms' launches are returned under "*_f32")."""
    from hivedscheduler_tpu_torch.ops import attention as attn

    args = w.args(w.layers, train=True)
    _zero_launches(attn)
    runs = {"flash": run_train("flash", TRAIN_STEPS, args)}
    launches = _count_launches(attn)
    runs["xla"] = run_train("xla", TRAIN_STEPS, args)
    n = w.layers * TRAIN_STEPS
    want = {"fwd": 2 * n, "dq": n, "dkv": n, "fwd_f32": 0, "dq_f32": 0, "dkv_f32": 0}
    losses = {impl: [r["loss"] for r in records] for impl, (records, _) in runs.items()}
    diff = max(abs(a - b) for a, b in zip(losses["flash"], losses["xla"]))
    print(f"{w.tag} train at {w.name}'s width ({w.layers} layers, remat dots, ce_chunk "
          f"{EVAL_CE_CHUNK}): losses flash {losses['flash']}, xla {losses['xla']}: max |flash - "
          f"xla| {diff:.3e} (<= {LOSS_ATOL}); launches over {TRAIN_STEPS} steps {launches} "
          f"(want {want})")
    check(launches == want, f"the {w.name} train run launched {launches}, want {want}")
    check(diff <= LOSS_ATOL, f"{w.name} flash and xla train losses disagree")
    for impl, (records, peak) in runs.items():
        timed = [r for r in records if not r["compile"]]
        step_ms = sum(r["wall_s"] for r in timed) / len(timed) * 1e3
        print(f"{w.tag} train step --attn {impl} (B={EVAL_BATCH}, T={EVAL_SEQ}, {w.layers} "
              f"layers, mean of {len(timed)} steps after the warm-up): {step_ms} ms, "
              f"{EVAL_BATCH * EVAL_SEQ / (step_ms / 1e3)} tokens/s, peak device memory "
              f"{peak / 1e9:.2f} GB")
    del runs
    if ring:
        _zero_launches(attn)
        records, peak = run_train("ring_flash", TRAIN_STEPS, args)
        ring_launches = _count_launches(attn)
        want = {"fwd": 0, "dq": 0, "dkv": 0, "fwd_f32": 2 * n, "dq_f32": n, "dkv_f32": n}
        got = [r["loss"] for r in records]
        rdiff = max(abs(a - b) for a, b in zip(got, losses["flash"]))
        print(f"{w.tag} train --attn ring_flash at sp=1 ({w.layers} layers): losses {got}; "
              f"flash's: max |diff| {rdiff:.3e} (<= {RING_LOSS_ATOL}); launches over "
              f"{TRAIN_STEPS} steps {ring_launches} (want {want}); peak device memory "
              f"{peak / 1e9:.2f} GB")
        check(ring_launches == want, f"the {w.name} ring_flash run launched {ring_launches}")
        check(rdiff <= RING_LOSS_ATOL, f"{w.name} ring_flash losses part from flash's")
        launches.update({k: v for k, v in ring_launches.items() if k.endswith("_f32")})
    phase_train_grads(dict(w.model, n_layers=w.layers), w.tag,
                      f"one {w.name} step, {w.layers} layers")
    return launches


def _width_generate(w: Width) -> None:
    """5: greedy generate at (j)'s shape: its tokens the argmax of their own
    advance sequence, no K1-K3 launch; tokens/s."""
    import torch

    from hivedscheduler_tpu_torch.models import decode as dec
    from hivedscheduler_tpu_torch.models import transformer as tm
    from hivedscheduler_tpu_torch.ops import attention as attn

    cfg = tm.TransformerConfig(max_seq_len=DEC_PROMPT + DEC_NEW,
                               **dict(w.model, n_layers=w.layers))
    params = tm.cast_params(tm.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda"), cfg.dtype)
    torch.cuda.empty_cache()
    prompt = torch.randint(0, cfg.vocab_size, (DEC_BATCH, DEC_PROMPT), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(1))
    attn.FLASH_FWD_LAUNCHES = 0
    toks = dec.generate(params, prompt, cfg, DEC_NEW)
    inc = _decode_sequence(params, cfg, prompt, toks)[:, DEC_PROMPT - 1:]
    exact = int((inc.argmax(-1) != toks).sum())
    with torch.inference_mode():
        full = tm.forward(params, torch.cat([prompt, toks], 1)[:, :-1], cfg)[:, DEC_PROMPT - 1:]
    rel = _per_position_rel(inc, full)
    wall = _host_ms(lambda: dec.generate(params, prompt, cfg, DEC_NEW), 2)
    med = sorted(wall)[len(wall) // 2]
    print(f"{w.tag} generate at {w.name}'s width ({w.layers} layers, B={DEC_BATCH}, prompt "
          f"{DEC_PROMPT}, {DEC_NEW} new): {exact} tokens differ from the argmax of their "
          f"advance sequence; decode logits against the full forward, worst position rel "
          f"{rel:.3e} (<= {DEC_LOGIT_REL}); K1 launches {attn.FLASH_FWD_LAUNCHES}; wall "
          f"{', '.join(f'{t:.2f}' for t in wall)} ms, {DEC_BATCH * DEC_NEW / (med / 1e3):.1f} "
          f"tokens/s")
    check(exact == 0 and bool(torch.isfinite(inc).all()),
          f"{w.name} greedy tokens disagree with their advance sequence")
    check(rel <= DEC_LOGIT_REL, f"{w.name} decode logits disagree with the full forward")
    check(attn.FLASH_FWD_LAUNCHES == 0, f"{w.name} decode launched a flash kernel")
    del params
    torch.cuda.empty_cache()


def _width_serve(w: Width) -> None:
    """6: (k)'s trace: dense and paged, eager and graph windows,
    token-identical and at decisive positions the full forward's argmax;
    int8 KV (per-head scales) dense and paged token-identical; no flash
    launch; TPOT p50."""
    import torch

    from hivedscheduler_tpu_torch.chaos import invariants as inv
    from hivedscheduler_tpu_torch.models import serving as srv
    from hivedscheduler_tpu_torch.models import transformer as tm
    from hivedscheduler_tpu_torch.ops import attention as attn

    cfg = tm.TransformerConfig(max_seq_len=SRV_MAX_LEN, **dict(w.model, n_layers=w.layers))
    params = tm.cast_params(tm.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda"), cfg.dtype)
    torch.cuda.empty_cache()
    prompts = _srv_prompts(cfg.vocab_size, SRV_REQUESTS, seed=2)
    runs = dict(SRV_RUNS, **{f"int8 KV {name}": dict(kw, kv_dtype="int8")
                             for name, kw in SRV_RUNS.items() if "graph" in name})
    engines, out = {}, {}
    _zero_launches(attn)
    for name, kw in runs.items():
        engines[name] = srv.ServingEngine(params, cfg, max_batch=SRV_BATCH,
                                          max_len=SRV_MAX_LEN, **kw)
        out[name] = _serve(engines[name], prompts, SRV_BUDGET)
        if engines[name].paged:
            inv.check_block_pool(engines[name], name)
        if engines[name].decode_steps > 1:
            check(engines[name].graph_windows == engines[name].fused_windows > 0,
                  f"{w.name} {name}: windows did not run through the CUDA graph")
    launches = _count_launches(attn)
    ref, ref8 = _streams(out["dense eager"]), _streams(out["int8 KV dense graph"])
    same = {name: sum(a != b for a, b in zip(_streams(run), ref8 if "int8" in name else ref))
            for name, run in out.items()}
    full = _teacher_forced(params, cfg, prompts, ref)
    eng_logits = [_engine_logits(params, cfg, prompts[i], ref[i]) for i in range(SRV_NOISE_ROWS)]
    noise = max(float((e - f).abs().max()) for e, f in zip(eng_logits, full))
    n_dec, miss = _decisive_misses(full, ref, noise)
    print(f"{w.tag} serve at {w.name}'s width ({w.layers} layers, {SRV_REQUESTS} requests, "
          f"budget {SRV_BUDGET}, max_batch {SRV_BATCH}): requests whose stream differs from "
          f"dense eager (int8 KV: from int8 KV dense graph): {same}; {miss} of {n_dec} "
          f"decisive positions differ from the full forward's argmax (margin > 2 x "
          f"{noise:.3e}); flash launches {launches}")
    check(all(v == 0 for v in same.values()), f"{w.name} dense/paged, eager/graph streams differ")
    check(miss == 0 and n_dec > 0, f"{w.name} engine streams disagree with the full forward")
    check(not any(launches.values()), f"{w.name} serving launched {launches}")
    for name in runs:
        st = _serve_stats(_serve(engines[name], prompts, SRV_BUDGET), SRV_BATCH)
        print(f"{w.tag} serve {name}: {st['tps']:.1f} tokens/s, TTFT p50 {st['ttft_p50']:.2f} ms, "
              f"TPOT p50 {st['tpot_p50']:.3f} ms (max {st['tpot_max']:.3f})")
    del engines, out, params
    torch.cuda.empty_cache()


def _timed_parts(tag: str, parts) -> list:
    """Runs each (name, fn) of ``parts`` and prints the phase's wall time by
    part; returns their results."""
    t_phase = time.perf_counter()
    walls, out = {}, []
    for name, fn in parts:
        t0 = time.perf_counter()
        out.append(fn())
        walls[name] = time.perf_counter() - t0
    print(f"{tag} phase wall time {time.perf_counter() - t_phase:.1f} s ("
          + ", ".join(f"{name} {s:.1f} s" for name, s in walls.items()) + ")")
    return out


def phase_phi3() -> dict:
    """(q): K1-K3 and their f32 forms at the padded head dims up to 128,
    then Phi-3-mini's width (head dim 96) through eval, train, generate and
    serve. Returns the D = 96 rows of the kernels line."""
    max_err, timing, eval_k1, launches, _, _ = _timed_parts(PHI3.tag, [
        ("kernel checks", lambda: _width_kernel_check(PHI3, PADDED_DIMS, PADDED_CASES, 90)),
        ("kernel times", lambda: _width_kernel_times(PHI3, dict(PHI3.shape, d=128),
                                                     "same heads at D 128")),
        ("eval", lambda: _width_eval(PHI3)),
        ("train", lambda: _width_train(PHI3)),
        ("generate", lambda: _width_generate(PHI3)),
        ("serve", lambda: _width_serve(PHI3))])
    # launches: K1 over the eval run (4 windows) and the train run (3 steps);
    # K2 and K3 over the train run
    launches["fwd"] += eval_k1
    return {key: dict(launches=launches[key], max_abs_err=max_err[key], **timing[key])
            for key in ("fwd", "dq", "dkv")}


def _gemma_f32_hop() -> dict:
    """The f32 forms at one sp = 4 ring hop of Gemma-2B's heads, diagonal
    and unmasked: against their plain versions and their bf16 forms (equal
    once rounded), then timed in turns with the bf16 forms."""
    hops = [("gemma_hop_diagonal", GEMMA_HOP, True), ("gemma_hop_unmasked", GEMMA_HOP, False)]
    checks = _f32_kernel_checks(hops, tag=GEMMA.tag, seed=130)
    timing = _f32_kernel_times(hops, tag=GEMMA.tag, main="gemma_hop_diagonal")
    return {key: dict(max_abs_err=checks[key], **timing[key]) for key in timing}


def phase_gemma() -> tuple:
    """(r): K1-K3 and their f32 forms at the head dims past 128, then
    Gemma-2B's width (head dim 256, one kv head) through eval, train (with
    ring_flash, which runs the f32 forms), generate and serve. Returns the
    D = 256 rows of the kernels line: K1-K3, and their f32 forms."""
    max_err, timing, hop, eval_k1, launches, _, _ = _timed_parts(GEMMA.tag, [
        ("kernel checks", lambda: _width_kernel_check(GEMMA, WIDE_DIMS, WIDE_CASES, 120)),
        ("kernel times", lambda: _width_kernel_times(GEMMA, FLAGSHIP, "flagship")),
        ("f32 hop", _gemma_f32_hop),
        ("eval", lambda: _width_eval(GEMMA)),
        ("train", lambda: _width_train(GEMMA, ring=True)),
        ("generate", lambda: _width_generate(GEMMA)),
        ("serve", lambda: _width_serve(GEMMA))])
    launches["fwd"] += eval_k1
    rows = {key: dict(launches=launches[key], max_abs_err=max_err[key], **timing[key])
            for key in ("fwd", "dq", "dkv")}
    f32 = {key: dict(launches=launches[f"{key}_f32"], **hop[key]) for key in ("fwd", "dq", "dkv")}
    return rows, f32


# phase (s): observability at the flagship width. The train flags of (h)
# with the journal, goodput, timeline and profiler; (k)'s serving load
# through the serve CLI with the metrics dump, the journal and an SLO
OBS_TRAIN_STEPS = 5  # the profiler records steps 2-4
OBS_TRAIN_ARGS = TRAIN_ARGS + ["--attn", "flash"]
# the resume check at 2 layers: its two checkpoints take ~3 GB each
OBS_RESUME_ARGS = [a for k, v in dict(EVAL_MODEL, n_layers=2).items()
                   for a in (f"--{k.replace('_', '-')}", str(v))] + [
    "--seq-len", str(EVAL_SEQ), "--batch", str(EVAL_BATCH), "--ce-chunk",
    str(EVAL_CE_CHUNK), "--device", "cuda", "--remat", "dots", "--attn", "flash"]
OBS_COST_STEPS, OBS_TURNS = 4, 2  # flag-cost runs: steps each, rounds of 4
OBS_SLO_TTFT = 0.5
OBS_SERVE_ARGS = SRV_LOAD_ARGS + ["--high-priority-every", "4"]
# the kernels of one traced step, by the name fragments of (h)'s profile
TRACE_KERNELS = {"K1": "flash_fwd_kernel", "K2": "flash_bwd_dq_kernel",
                 "K3": "flash_bwd_dkv_kernel"}
# the element-wise split: the first group one of whose fragments is in the
# name of the op that launched a kernel or of an op around it (the
# optimizer's own range, the autograd node of a backward kernel)
ELEMENTWISE_GROUPS = (
    ("AdamW", ("optimizer.step", "_foreach_", "adamw")),
    ("CE", ("cross_entropy", "log_softmax", "logsoftmax", "nll_loss", "nllloss")),
    ("SiLU", ("silu",)),
    ("RMSNorm", ("rsqrt", "aten::mean", "meanbackward")),
    ("RoPE", ("aten::cos", "aten::sin", "aten::exp", "aten::stack", "stackbackward")),
    ("casts", ("aten::_to_copy", "aten::copy_", "tocopybackward")),
)
OTHER_ELEMENTWISE = "other element-wise (mul, add, embedding, ...)"


def validate_chrome_trace(obj) -> list:
    """The events of a Chrome trace Perfetto loads: a traceEvents array of
    events with a name, ph, numeric ts, int pid and tid, and a non-negative
    dur on complete events; fails otherwise."""
    events = obj.get("traceEvents") if isinstance(obj, dict) else None
    check(isinstance(events, list), "the trace has no traceEvents array")
    for ev in events:
        ok = (isinstance(ev.get("name"), str) and ev["name"] and isinstance(ev.get("ph"), str)
              and isinstance(ev.get("ts"), (int, float)) and isinstance(ev.get("pid"), int)
              and isinstance(ev.get("tid"), int)
              and (ev["ph"] != "X" or (isinstance(ev.get("dur"), (int, float))
                                       and ev["dur"] >= 0)))
        check(ok, f"malformed trace event {ev}")
    return events


def flight_faults(flights: dict) -> list:
    """What breaks the request flights' invariants: a flight without
    exactly one terminal, a leg that does not start where the previous
    ended (the first at submit), or legs that do not tile the TTFT."""
    out = []
    for key, fl in flights.items():
        if fl["terminals"] != 1:
            out.append(f"{key}: {fl['terminals']} terminals")
        mark = fl["t0"]
        for leg, start, end in fl["legs"]:
            if abs(start - mark) > 1e-9:
                out.append(f"{key}: leg {leg} starts {start - mark:+.3e} s off the mark")
            mark = end
        if fl["first_token_t"] is not None and (fl["ttft_gap"] is None
                                                or abs(fl["ttft_gap"]) > 1e-9):
            out.append(f"{key}: the legs miss the TTFT by {fl['ttft_gap']} s")
    return out


def trace_kernel_counts(events: list) -> dict:
    """Launches of K1-K3 among a profiler trace's CUDA kernel events."""
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    return {k: sum(frag in name for name in kernels) for k, frag in TRACE_KERNELS.items()}


def _enclosing_ops(events: list, launches: dict) -> dict:
    """For each launch (correlation -> (ts, tid)), the names of the host
    ranges around it on its thread (ops and user ranges), outermost
    first: a sweep over each thread's properly nested ranges."""
    ranges = {}
    for e in events:
        if e.get("cat") in ("cpu_op", "user_annotation") and e.get("ph") == "X":
            ranges.setdefault(e["tid"], []).append((e["ts"], e["ts"] + e["dur"], e["name"]))
    points = {}
    for corr, (ts, tid) in launches.items():
        points.setdefault(tid, []).append((ts, corr))
    out = {}
    for tid, pts in points.items():
        spans = sorted(ranges.get(tid, []), key=lambda r: (r[0], -r[1]))
        stack, i = [], 0
        for ts, corr in sorted(pts):
            while i < len(spans) and spans[i][0] <= ts:
                while stack and stack[-1][1] < spans[i][0]:
                    stack.pop()
                stack.append(spans[i])
                i += 1
            while stack and stack[-1][1] < ts:
                stack.pop()
            out[corr] = [name for _, end, name in stack if end >= ts]
    return out


def _kernel_group(name: str, ops: list) -> str:
    for group, frag in TRACE_KERNELS.items():
        if frag in name:
            return group
    if profile_group(name) == "matmuls":
        return "cuBLAS"
    chain = " ".join(ops).lower()
    return next((g for g, frags in ELEMENTWISE_GROUPS if any(f in chain for f in frags)),
                OTHER_ELEMENTWISE)


def _launching_op(ops: list) -> str:
    """The innermost op around a launch, with the autograd node it runs
    for in a backward pass."""
    node = next((o.split(": ", 1)[1] for o in reversed(ops)
                 if o.startswith("autograd::engine::evaluate_function: ")), "")
    inner = ops[-1] if ops else "?"
    return f"{inner} in {node}" if node else inner


def trace_step_breakdown(events: list) -> dict:
    """{step: (wall ms of its train/step range, device busy ms, host-gap
    ms, {group: device ms}, {launching op: device ms} of the group the
    split leaves over)} from a profiler trace: each device event (a
    kernel, copy or memset) counts in the step whose range holds its
    launch, and in the group of its kernel name or, for element-wise work,
    of the ops that launched it."""
    steps = {int(e["name"].split()[-1]): (e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("cat") == "user_annotation" and e["name"].startswith("train/step ")}
    launches = {e["args"]["correlation"]: (e["ts"], e["tid"]) for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    ops = _enclosing_ops(events, launches)
    device = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
              and e.get("args", {}).get("correlation") in launches]
    out = {}
    for step, (lo, hi) in sorted(steps.items()):
        mine = [e for e in device if lo <= launches[e["args"]["correlation"]][0] <= hi]
        groups, rest = {}, {}
        for e in mine:
            chain = ops.get(e["args"]["correlation"], [])
            g = _kernel_group(e["name"], chain)
            groups[g] = groups.get(g, 0.0) + e["dur"] / 1e3
            if g == OTHER_ELEMENTWISE:
                op = _launching_op(chain)
                rest[op] = rest.get(op, 0.0) + e["dur"] / 1e3
        busy, end = 0.0, lo
        for s, d in sorted((e["ts"], e["dur"]) for e in mine):
            s, f = max(s, end), min(s + d, hi)
            if f > s:
                busy += f - s
                end = f
        out[step] = ((hi - lo) / 1e3, busy / 1e3, (hi - lo - busy) / 1e3, groups, rest)
    return out


def _registry_counts() -> dict:
    from hivedscheduler_tpu_torch.runtime.metrics import REGISTRY

    with REGISTRY._lock:
        out = dict(REGISTRY._counters)
        out.update({(f"{n}_count", labels): c
                    for (n, labels), (_, _, c) in REGISTRY._histograms.items()})
    return out


def _exposition(text: str) -> dict:
    """{series: value} of a Prometheus exposition's sample lines."""
    out = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            series, value = line.rsplit(" ", 1)
            out[series] = float(value)
    return out


def _obs_off() -> None:
    """Every observability singleton disabled and cleared, as a fresh
    process has them."""
    from hivedscheduler_tpu_torch.obs import journal, trace

    _close_goodput()
    journal.disable()
    journal.JOURNAL.clear()
    trace.disable()
    trace.TRACER.clear()


def _obs_train(tmp: str) -> dict:
    """1: the flagship step with every train flag: journal and goodput
    audits, the merged Chrome trace, the profiler trace's kernels and the
    step's device time by group. Returns the breakdown of step 3."""
    from hivedscheduler_tpu_torch.chaos import invariants as inv
    from hivedscheduler_tpu_torch.obs import goodput, trace

    spool, gp = os.path.join(tmp, "journal.jsonl"), os.path.join(tmp, "goodput.jsonl")
    prof_dir = os.path.join(tmp, "profile")
    trace.enable()
    losses = _train_main(tmp, "obs", "--steps", str(OBS_TRAIN_STEPS), "--journal-file", spool,
                         "--goodput-file", gp, "--profile-dir", prof_dir)
    check(sorted(losses) == list(range(1, OBS_TRAIN_STEPS + 1)), f"[s] train steps {losses}")
    inv.check_journal()
    inv.check_goodput()
    events = validate_chrome_trace(json.loads(json.dumps(trace.to_chrome_trace())))
    spans = [e for e in events if e["name"] == "train/step"]
    lane = [e for e in events if e.get("cat") == "goodput"]
    check([e["args"]["step"] for e in spans] == list(range(1, OBS_TRAIN_STEPS + 1)),
          f"[s] train/step spans {[e['args'] for e in spans]}")
    check(any(e["name"] == "phase:step_compute" for e in lane), "[s] no goodput lane")
    _obs_off()
    with open(spool) as f:
        records = [json.loads(line) for line in f]
    violations = goodput.check_spool(gp)
    check(not violations, f"[s] goodput spool violations {violations}")
    files = [os.path.join(prof_dir, n) for n in os.listdir(prof_dir)]
    check(len(files) == 1 and files[0].endswith(".pt.trace.json"), f"[s] trace files {files}")
    size = os.path.getsize(files[0])
    with open(files[0]) as f:
        prof_events = json.load(f)["traceEvents"]
    counts = trace_kernel_counts(prof_events)
    layers = EVAL_MODEL["n_layers"]
    want = {"K1": 3 * 2 * layers, "K2": 3 * layers, "K3": 3 * layers}
    breakdown = trace_step_breakdown(prof_events)
    print(f"[s] train with --journal-file --goodput-file --timeline --profile-dir "
          f"({OBS_TRAIN_STEPS} steps): journal {len(records)} records, goodput spool "
          f"clean, Chrome trace {len(events)} events with {len(spans)} train/step spans and "
          f"{len(lane)} goodput spans; profiler trace {os.path.basename(files[0])} "
          f"{size / 1e6:.1f} MB, kernel events {counts} (want {want}), traced steps "
          f"{sorted(breakdown)}")
    check(counts == want, f"[s] the profiler trace holds {counts}, want {want}")
    check(sorted(breakdown) == [2, 3, 4], f"[s] traced steps {sorted(breakdown)}")
    for step, (wall, busy, gap, groups, rest) in breakdown.items():
        elementwise = sum(v for k, v in groups.items()
                          if k not in ("K1", "K2", "K3", "cuBLAS"))
        print(f"[s] traced step {step}: wall {wall:.2f} ms, device busy {busy:.2f} ms, host "
              f"gaps {gap:.2f} ms ({gap / wall:.1%}); K1-K3 "
              f"{sum(groups.get(k, 0.0) for k in TRACE_KERNELS):.2f} ms, cuBLAS "
              f"{groups.get('cuBLAS', 0.0):.2f} ms, element-wise {elementwise:.2f} ms: "
              + ", ".join(f"{g} {groups.get(g, 0.0):.2f}"
                          for g, _ in ELEMENTWISE_GROUPS + ((OTHER_ELEMENTWISE, ()),)))
    rest = sorted(breakdown[3][4].items(), key=lambda kv: -kv[1])
    print("[s] traced step 3, the rest of the element-wise work by launching op: "
          + ", ".join(f"{op} {ms:.2f}" for op, ms in rest[:8]))
    lo, hi = next((e["ts"], e["ts"] + e["dur"]) for e in prof_events
                  if e.get("cat") == "user_annotation" and e["name"] == "train/step 3")
    ranges = [f"{e['name']} {e['dur'] / 1e3:.2f} ms" for e in prof_events
              if e.get("cat") == "gpu_user_annotation" and lo <= e["ts"] <= hi]
    print(f"[s] traced step 3, device-side ranges of user annotations (kernel time that "
          f"a sum over key_averages() counts twice): {ranges}")
    return dict(size_mb=size / 1e6, step3=breakdown[3])


def _obs_resume(tmp: str) -> None:
    """2: 2 steps, then 4, over one checkpoint directory: exactly one
    ``train_resume`` at step 2, one count of the resume counter."""
    ck, spool = os.path.join(tmp, "ck"), os.path.join(tmp, "resume.jsonl")
    before = _registry_counts()
    for steps in (2, 4):
        rc = _train_cli(OBS_RESUME_ARGS + ["--steps", str(steps), "--checkpoint-dir", ck,
                                "--checkpoint-every", "100", "--journal-file", spool])
        check(rc == 0, f"[s] resume run of {steps} steps exited {rc}")
        _obs_off()
    after = _registry_counts()
    with open(spool) as f:
        records = [json.loads(line) for line in f]
    resumes = [r for r in records if r["type"] == "train_resume"]
    n = after.get(("tpu_hive_train_resumes_total", ()), 0) - before.get(
        ("tpu_hive_train_resumes_total", ()), 0)
    print(f"[s] train 2 then 4 steps (2 layers) with --checkpoint-dir "
          f"--journal-file: train_resume events {[r['args'] for r in resumes]}, "
          f"tpu_hive_train_resumes_total +{n}")
    check(len(resumes) == 1 and resumes[0]["args"] == {"step": 2, "crossTopology": False},
          "[s] the resume was not journaled once at step 2")
    check(n == 1, f"[s] the resume counter moved by {n}")
    shutil.rmtree(ck, ignore_errors=True)


def _train_cli(args: list) -> int:
    import torch

    from hivedscheduler_tpu_torch import train as port_train

    torch.cuda.empty_cache()
    return port_train.main(args)


def _obs_train_cost(tmp: str) -> dict:
    """3: step ms with and without --journal-file --goodput-file, both with
    --timeline, in turns (plain, flags, flags, plain)."""
    out = {"plain": [], "flags": []}
    for turn in range(OBS_TURNS):
        for mode in ("plain", "flags", "flags", "plain"):
            extra = ["--steps", str(OBS_COST_STEPS)]
            if mode == "flags":
                extra += ["--journal-file", os.path.join(tmp, f"cost{turn}.jsonl"),
                          "--goodput-file", os.path.join(tmp, f"cost{turn}-gp.jsonl")]
            path = os.path.join(tmp, "cost.jsonl")
            check(_train_cli(OBS_TRAIN_ARGS + extra + ["--timeline", path]) == 0,
                  "[s] a flag-cost run failed")
            _obs_off()
            with open(path) as f:
                walls = [r["wall_s"] for r in map(json.loads, f) if not r["compile"]]
            out[mode].append(sum(walls) / len(walls) * 1e3)
    ratio = sum(out["flags"]) / sum(out["plain"])
    print(f"[s] train step ms in turns (mean of steps 2-{OBS_COST_STEPS} each run): "
          f"plain {', '.join(f'{v:.2f}' for v in out['plain'])}; with --journal-file "
          f"--goodput-file {', '.join(f'{v:.2f}' for v in out['flags'])}; ratio {ratio:.4f}")
    return dict(out, ratio=ratio)


def _obs_serve_cli(tmp: str) -> list:
    """4: the serve CLI with --metrics-dump --journal-file --slo-ttft-p99 on
    (k)'s load: the exposition, the trace, the flights, the SLO lines and
    the streams, which must equal a run without the flags."""
    from hivedscheduler_tpu_torch import serve as port_serve
    from hivedscheduler_tpu_torch.chaos import invariants as inv
    from hivedscheduler_tpu_torch.obs import journal

    dump, spool = os.path.join(tmp, "metrics.txt"), os.path.join(tmp, "serve.jsonl")
    runs = {}
    for mode in ("flags", "plain"):
        extra = (["--metrics-dump", dump, "--journal-file", spool, "--slo-ttft-p99",
                  str(OBS_SLO_TTFT)] if mode == "flags" else [])
        lines = _Lines()
        logger = logging.getLogger(port_serve.__name__)
        logger.addHandler(lines)
        before = _registry_counts()
        out = io.StringIO()
        try:
            with contextlib.redirect_stdout(out):
                rc = port_serve.main(OBS_SERVE_ARGS + extra)
        finally:
            logger.removeHandler(lines)
        check(rc == 0, f"[s] serve ({mode}) exited {rc}")
        streams = [line for line in out.getvalue().splitlines() if line.startswith("[")]
        if mode == "flags":
            flights = journal.JOURNAL.flights()
            inv.check_journal()
        runs[mode] = (streams, lines.messages, before)
        _obs_off()
    streams, messages, before = runs["flags"]
    with open(dump) as f:
        expo = _exposition(f.read())
    finished = {p: expo.get(f'tpu_hive_serve_requests_total{{priority="{p}"}}', 0.0)
                - before.get(("tpu_hive_serve_requests_total", (("priority", p),)), 0)
                for p in ("0", "10")}
    ttft = {p: expo.get(f'tpu_hive_serve_ttft_seconds_count{{priority="{p}"}}', 0.0)
            - before.get(("tpu_hive_serve_ttft_seconds_count", (("priority", p),)), 0)
            for p in ("0", "10")}
    windows = expo.get("tpu_hive_serve_fused_decode_windows_total", 0.0) - before.get(
        ("tpu_hive_serve_fused_decode_windows_total", ()), 0)
    fused = [m for m in messages if m.startswith("fused decode:")]
    engine_windows = int(fused[0].split()[2]) if fused else -1
    with open(dump + ".trace.json") as f:
        events = validate_chrome_trace(json.load(f))
    decode_spans = sum(e["name"] == "request/decode" for e in events)
    slo = [m for m in messages if m.startswith("slo")]
    faults = flight_faults(flights)
    print(f"[s] serve --metrics-dump --journal-file --slo-ttft-p99 {OBS_SLO_TTFT} "
          f"({SRV_REQUESTS} requests, graph windows of {SRV_STEPS}): requests_total by "
          f"priority {finished}, TTFT samples {ttft}, fused windows {windows} (the engine's "
          f"{engine_windows}), request/decode spans {decode_spans}, {len(flights)} flights, "
          f"flight faults {faults}; SLO lines: {slo}")
    check(sum(finished.values()) == len(streams) == SRV_REQUESTS and all(finished.values()),
          f"[s] requests_total {finished} for {len(streams)} streams")
    check(ttft == finished, f"[s] TTFT samples {ttft} != finished {finished}")
    check(windows == engine_windows > 0, f"[s] fused windows {windows} != {engine_windows}")
    check(decode_spans == SRV_REQUESTS, f"[s] {decode_spans} request/decode spans")
    check(len(flights) == SRV_REQUESTS and not faults, f"[s] flight faults {faults}")
    check(len(slo) == 2 and "slo objective ttft_p99" in slo[1], f"[s] SLO lines {slo}")
    check(streams == runs["plain"][0], "[s] the flags changed the served streams")
    return streams


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__()
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def _obs_serve_cost() -> dict:
    """5: tokens/s and TPOT p50 of (k)'s paged graph engine with the
    journal, its flights and the tracer on, against all off, in turns."""
    import torch

    from hivedscheduler_tpu_torch.models import serving as srv
    from hivedscheduler_tpu_torch.models import transformer as tm
    from hivedscheduler_tpu_torch.obs import journal, trace

    cfg = tm.TransformerConfig(max_seq_len=SRV_MAX_LEN, **EVAL_MODEL)
    params = tm.cast_params(tm.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda"), cfg.dtype)
    prompts = _srv_prompts(cfg.vocab_size, SRV_REQUESTS, seed=2)
    eng = srv.ServingEngine(params, cfg, max_batch=SRV_BATCH, max_len=SRV_MAX_LEN,
                            **SRV_RUNS["paged graph"])
    _serve(eng, prompts, SRV_BUDGET)  # capture the graph
    out = {"plain": [], "flags": []}
    streams = {}
    for _ in range(OBS_TURNS):
        for mode in ("plain", "flags", "flags", "plain"):
            if mode == "flags":
                journal.enable()
                trace.enable()
            eng.record_flights = mode == "flags"
            run = _serve(eng, prompts, SRV_BUDGET)
            streams.setdefault(mode, _streams(run))
            if mode == "flags":
                check(not flight_faults(journal.JOURNAL.flights()), "[s] flight faults")
            _obs_off()
            out[mode].append(_serve_stats(run, SRV_BATCH))
    eng.record_flights = False
    check(streams["flags"] == streams["plain"], "[s] the engine's streams moved with the flags")
    tps = {m: [s["tps"] for s in v] for m, v in out.items()}
    tpot = {m: [s["tpot_p50"] for s in v] for m, v in out.items()}
    print(f"[s] serving in turns (paged graph engine, {SRV_REQUESTS} requests): tokens/s plain "
          f"{', '.join(f'{v:.1f}' for v in tps['plain'])}, with the journal, flights and "
          f"tracer {', '.join(f'{v:.1f}' for v in tps['flags'])}; TPOT p50 ms plain "
          f"{', '.join(f'{v:.3f}' for v in tpot['plain'])}, with "
          f"{', '.join(f'{v:.3f}' for v in tpot['flags'])}")
    del eng, params
    torch.cuda.empty_cache()
    return dict(tps=tps, tpot=tpot)


def _obs_planted(tmp: str) -> None:
    """6: the checks see planted faults: a dropped leg, a duplicated
    terminal, and a profile without CUDA activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    from hivedscheduler_tpu_torch import train as port_train
    from hivedscheduler_tpu_torch.chaos import invariants as inv
    from hivedscheduler_tpu_torch.obs import journal
    from hivedscheduler_tpu_torch.ops import attention as attn

    j = journal.Journal(metrics=False)
    j.enabled = True
    j.note_request_submit("serve/0", at=0.0)
    j.note_leg("serve/0", "admission_wait", at=1.0)  # the prefill leg dropped
    j.note_request_done("serve/0", "length", first_token_at=2.5, at=3.0)
    j.emit("serve_submit", "serve/1", at=0.0)
    j.emit("serve_finish", "serve/1", at=1.0)
    j.emit("serve_finish", "serve/1", at=1.0)  # a second terminal
    j.note_request_done("serve/1", "length", at=1.0)
    j.note_request_done("serve/1", "length", at=1.0)
    faults = flight_faults(j.flights())
    try:
        inv.check_journal(journal=j)
        dup = None
    except inv.InvariantViolation as err:
        dup = str(err)
    prof_dir = os.path.join(tmp, "cpu-only")
    q, k, v = make_qkv(1, 256, 2, 2, 128, seed=3)
    prof = profile(activities=[ProfilerActivity.CPU],
                   on_trace_ready=tensorboard_trace_handler(prof_dir, worker_name="rank0"))
    prof.start()
    attn.flash_forward(q, k, v, causal=True)
    try:
        port_train.stop_profile(prof, torch.device("cuda"))
        refused = None
    except RuntimeError as err:
        refused = str(err)
    name = os.listdir(prof_dir)[0]
    with open(os.path.join(prof_dir, name)) as f:
        counts = trace_kernel_counts(json.load(f)["traceEvents"])
    print(f"[s] planted: dropped leg -> {faults[:1]}; duplicated terminal -> "
          f"{[f for f in faults if 'terminals' in f]} and check_journal: {dup}; a trace "
          f"without CUDA activity: kernel events {counts}, train's check: {refused}")
    check(any("miss the TTFT" in f for f in faults), "[s] the dropped leg passed")
    check(any("2 terminals" in f for f in faults) and dup and "duplicate terminal" in dup,
          "[s] the duplicated terminal passed")
    check(refused is not None and counts["K1"] == 0,
          "[s] a trace without CUDA activity passed the kernel check")


def phase_obs() -> None:
    """(s): observability at the flagship width (journal, goodput, the
    Chrome trace and the profiler through train; resume events; the cost
    of the flags; the serve CLI's dump, flights and SLO; planted faults)."""
    from hivedscheduler_tpu_torch.ops import attention as attn

    tmp = tempfile.mkdtemp(prefix="chip_smoke_obs_")
    try:
        _zero_launches(attn)
        _timed_parts("[s]", [
            ("train", lambda: _obs_train(tmp)),
            ("resume", lambda: _obs_resume(tmp)),
            ("train cost", lambda: _obs_train_cost(tmp)),
            ("serve", lambda: _obs_serve_cli(tmp)),
            ("serve cost", _obs_serve_cost),
            ("planted", lambda: _obs_planted(tmp))])
    finally:
        _obs_off()
        shutil.rmtree(tmp, ignore_errors=True)


# phase (t): the serving fleet at the flagship width on (k)'s engine settings
# (paged, page 16, graph windows of 8, max_batch 16, max_len 160, prefix
# cache 4), bf16 params from seed 0 shared by every replica
FLEET_CLI = ["--fleet", "3", "--disaggregate", "--prefill-replicas", "1",
             "--route-policy", "prefix_affinity"]
FLEET_YAML = "example/config/design/fleet.yaml"
FLEET_TURNS = 2  # rounds of (single, ship, re-prefill, re-prefill, ship, single)
# runs the serve CLI's main in a subprocess and reports, on one line, what
# only that process can see: its exit code, K1-K3's launches, and
# check_fleet (with check_requests) on every router the CLI published
FLEET_WRAPPER = (
    "import json, sys\n"
    "from hivedscheduler_tpu_torch import fleet, serve\n"
    "from hivedscheduler_tpu_torch.chaos import invariants as inv\n"
    "from hivedscheduler_tpu_torch.ops import attention as attn\n"
    "routers, publish = [], fleet.publish\n"
    "def spy(r):\n"
    "    if r is not None:\n"
    "        routers.append(r)\n"
    "    publish(r)\n"
    "fleet.publish = spy\n"
    "rc = serve.main(sys.argv[1:])\n"
    "for r in routers:\n"
    "    inv.check_fleet(r, 'cli')\n"
    "print('FLEET_SMOKE ' + json.dumps(dict(rc=rc, checked=len(routers), flash=[\n"
    "    attn.FLASH_FWD_LAUNCHES, attn.FLASH_BWD_DQ_LAUNCHES, attn.FLASH_BWD_DKV_LAUNCHES,\n"
    "    attn.FLASH_FWD_F32_LAUNCHES, attn.FLASH_BWD_DQ_F32_LAUNCHES,\n"
    "    attn.FLASH_BWD_DKV_F32_LAUNCHES],\n"
    "    handoffs=[r.handoffs for r in routers], retried=[r.retried for r in routers])))\n"
    "sys.exit(rc)\n")


def _fleet_cli(tmp: str, noise: float) -> None:
    """1: the serve CLI as subprocesses, all started at once: the single
    engine, the disaggregated prefix-affinity fleet of 3 in ship and
    re-prefill mode (each with --journal-file), and --fleet-config
    example/config/design/fleet.yaml. Each exits 0 and launches no flash
    kernel; the fleets' streams part from the single engine's only at
    near-ties of the teacher-forced full forward; every handoff ships (or
    re-prefills); every flight has one terminal and legs that sum to its
    TTFT; check_fleet is clean on every router."""
    import torch

    from hivedscheduler_tpu_torch import serve as port_serve
    from hivedscheduler_tpu_torch.models import transformer as tm
    from hivedscheduler_tpu_torch.parallel import checkpoint as ckpt

    runs = {
        "single": ([], {}),
        "ship": (FLEET_CLI + ["--journal-file", os.path.join(tmp, "ship.jsonl")],
                 {"HIVED_FLEET_KV_SHIP": "1"}),
        "re-prefill": (FLEET_CLI + ["--journal-file", os.path.join(tmp, "reprefill.jsonl")],
                       {"HIVED_FLEET_KV_SHIP": "0"}),
        "fleet-config": (["--fleet-config", FLEET_YAML], {"HIVED_FLEET_KV_SHIP": "1"}),
    }
    procs = {}
    for name, (extra, env) in runs.items():
        out, err = (open(os.path.join(tmp, f"{name}.{s}"), "w+") for s in ("out", "err"))
        procs[name] = (subprocess.Popen(
            [sys.executable, "-c", FLEET_WRAPPER] + SRV_LOAD_ARGS + extra, cwd=REPO,
            stdout=out, stderr=err, text=True, env=dict(os.environ, **env)), out, err,
            time.perf_counter())
    res = {}
    for name, (proc, out, err, t0) in procs.items():
        try:
            rc = proc.wait(timeout=300)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        out.seek(0)
        err.seek(0)
        stdout, stderr = out.read(), err.read()
        out.close()
        err.close()
        rows = {int(l[1:].split("]")[0]): [int(t) for t in l.split("] ", 1)[1].split()]
                for l in stdout.splitlines() if l.startswith("[")}
        smoke = [json.loads(l.split(" ", 1)[1]) for l in stdout.splitlines()
                 if l.startswith("FLEET_SMOKE ")]
        logs = [l.split("] ", 1)[-1] for l in stderr.splitlines()]
        res[name] = dict(rc=rc, rows=rows, smoke=smoke[0] if smoke else None, logs=logs,
                         s=time.perf_counter() - t0)
        if rc != 0 or not smoke:
            print(stderr[-4000:])
        check(rc == 0 and smoke and smoke[0]["rc"] == 0, f"[t] serve CLI ({name}) exit {rc}")
        check(not any(smoke[0]["flash"]), f"[t] {name}: flash launches {smoke[0]['flash']}")
        check(len(rows) == SRV_REQUESTS, f"[t] {name}: {len(rows)} request lines")

    # the single engine's streams against the teacher-forced full forward
    cfg = tm.TransformerConfig(max_seq_len=SRV_MAX_LEN, **EVAL_MODEL)
    params, _ = ckpt.restore_serving_params(cfg, "", torch.Generator(device="cuda").manual_seed(0))
    params = tm.cast_params(params, cfg.dtype)
    prompts = [p for p, _ in port_serve.synthetic_trace(1, SRV_REQUESTS, cfg.vocab_size,
                                                        SRV_BUDGET, 24)]
    single = [res["single"]["rows"][i] for i in range(SRV_REQUESTS)]
    full = _teacher_forced(params, cfg, prompts, single)
    n_dec, miss = _decisive_misses(full, single, noise)
    del params
    torch.cuda.empty_cache()
    check(miss == 0 and n_dec > 0, "[t] the single-engine CLI disagrees with the full forward")
    for name in ("ship", "re-prefill", "fleet-config"):
        r = res[name]
        streams = [r["rows"][i] for i in range(SRV_REQUESTS)]
        bad, parted = _parts_at_ties(full, single, streams, noise)
        handoffs = r["smoke"]["handoffs"][0]
        said = [l for l in r["logs"] if l.startswith(("fleet", "slo"))]
        print(f"[t] serve CLI {name}: exit 0 in {r['s']:.1f} s, K1-K3 launches "
              f"{r['smoke']['flash']}, handoffs {handoffs}, check_fleet clean on "
              f"{r['smoke']['checked']} router(s); streams part from the single engine's in "
              f"{parted} of {SRV_REQUESTS} requests, {bad} at a decisive position (margin > "
              f"2 x {noise:.3e}); " + " | ".join(said))
        check(bad == 0, f"[t] {name}: a stream parts from the single engine at a decisive position")
        check(r["smoke"]["checked"] == 1, f"[t] {name}: no router was checked")
        if name == "ship":
            check(handoffs == {"ship": SRV_REQUESTS, "miss": 0, "reprefill": 0},
                  f"[t] ship: not every handoff shipped: {handoffs}")
        elif name == "re-prefill":
            check(handoffs == {"ship": 0, "miss": 0, "reprefill": SRV_REQUESTS},
                  f"[t] re-prefill: {handoffs}")
        else:
            knobs = [l for l in r["logs"] if l.startswith(f"fleet config {FLEET_YAML}: ")]
            action = [l for l in r["logs"] if l.startswith("fleet autoscaler: ")]
            check(knobs and "replicas=3" in knobs[0] and action,
                  "[t] --fleet-config: no knobs line or no autoscaler line")
        if name != "fleet-config":
            with open(runs[name][0][-1]) as f:
                records = [json.loads(l) for l in f]
            done = [x for x in records if x["type"] == "request_done"]
            gangs = sorted(x["gang"] for x in done)
            worst = max(abs(x["args"]["ttftGapS"]) for x in done)
            print(f"[t] {name} journal: {len(records)} records, {len(done)} terminals over "
                  f"{len(set(gangs))} flights, worst |TTFT gap| {worst:.3e} s")
            check(gangs == sorted(f"fleet/{i}" for i in range(SRV_REQUESTS)),
                  f"[t] {name}: terminals {gangs}")
            check(worst <= 1e-6, f"[t] {name}: the legs miss a TTFT by {worst} s")


def _fleet_engine(params, cfg, **kw):
    from hivedscheduler_tpu_torch.models import serving as srv

    kw = dict(dict(max_batch=SRV_BATCH, max_len=SRV_MAX_LEN, page_size=SRV_PAGE,
                   decode_steps=SRV_STEPS, prefix_cache_size=4), **kw)
    return srv.ServingEngine(params, cfg, **kw)


def _fleet(params, cfg, ship: bool, decode: int = 2):
    from hivedscheduler_tpu_torch import fleet

    # least blocks: the decode legs spread over every decode replica (prefix
    # affinity would send every request of one system prompt to one)
    r = fleet.FleetRouter(disaggregate=True, kv_ship=ship)
    r.add_replica("p0", _fleet_engine(params, cfg), role="prefill")
    for i in range(decode):
        r.add_replica(f"d{i}", _fleet_engine(params, cfg), role="decode")
    return r


def _serve_fleet(router, prompts, budget: int, check_each=None):
    """``_serve``'s loop through a router: an arrival every SRV_ARRIVAL
    router steps, CUDA events around the loop (each step ends in host reads
    of its tokens)."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    pending, reqs, step = list(prompts), [], 0
    torch.cuda.synchronize()
    start.record()
    while pending or any(not f.done for f in reqs):
        if pending and step % SRV_ARRIVAL == 0:
            reqs.append(router.submit(list(pending.pop(0)), budget))
        router.step()
        if check_each is not None:
            check_each(router, step)
        step += 1
    end.record()
    torch.cuda.synchronize()
    return dict(reqs=reqs, ms=start.elapsed_time(end))


def _fleet_stats(run: dict) -> dict:
    reqs = run["reqs"]
    toks = sum(len(f.tokens_out) for f in reqs)
    ttft = sorted(f.ttft_s * 1e3 for f in reqs)
    tpot = sorted(f.tpot_s * 1e3 for f in reqs if f.tpot_s is not None)
    return dict(tps=toks / (run["ms"] / 1e3), ttft_p50=ttft[len(ttft) // 2],
                ttft_max=ttft[-1], tpot_p50=tpot[len(tpot) // 2])


def _same_bytes(a, b) -> bool:
    """Equal bit for bit (a NaN equals itself)."""
    import torch

    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


def _held_blocks(eng, key) -> list:
    """The pool's blocks of a prefix-cache entry, k, v (and scales), on
    the host."""
    import torch

    from hivedscheduler_tpu_torch.models import serving as srv

    idx = torch.tensor(list(eng._entry_bids(eng._prefix_cache[tuple(key)][0])),
                       device=eng.device)
    return [t.index_select(1, idx).cpu() for t in srv._kv_tensors(eng.pool)]


def _pointers(eng) -> list:
    from hivedscheduler_tpu_torch.models import serving as srv
    from hivedscheduler_tpu_torch.parallel import checkpoint as ckpt

    return ([t.data_ptr() for t in srv._kv_tensors(eng.pool)]
            + [t.data_ptr() for t in ckpt.named_leaves(eng.params).values()])


def _fleet_handoff(params, cfg, prompts) -> None:
    """2: the handoff itself, bf16 and int8 KV: each of (k)'s system-prompt
    requests prefilled on one engine, exported, imported into a
    graph-warmed decode engine, whose blocks must equal the exported bytes;
    the pool's and params' addresses unmoved; ms per export and import,
    bytes per handoff; a flipped byte caught by the block compare."""
    import torch

    for kv_dtype in (None, "int8"):
        pre = _fleet_engine(params, cfg, kv_dtype=kv_dtype)
        dec = _fleet_engine(params, cfg, kv_dtype=kv_dtype)
        _serve(dec, prompts[:4], SRV_BUDGET)  # capture the decode graph
        check(dec._window is not None and dec._window.graph is not None,
              "[t] the decode engine has no graph")
        before = _pointers(dec)
        export_ms, import_ms, sizes, equal = [], [], [], 0
        sample = None
        for p in prompts:
            pre.submit(list(p), 1)
            pre.run_until_drained()
            t0 = time.perf_counter()
            key, plen, data = pre.export_prefix(p)  # ends in its host copies
            t1 = time.perf_counter()
            check(dec.import_prefix(key, plen, data) is True, "[t] the import wrote nothing")
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            export_ms.append((t1 - t0) * 1e3)
            import_ms.append((t2 - t1) * 1e3)
            sizes.append(sum(t.numel() * t.element_size() for t in data.values()))
            want = [data[n] for n in ("k", "v", "k_scale", "v_scale") if n in data]
            equal += all(_same_bytes(h, w) for h, w in zip(_held_blocks(dec, key), want))
            sample = (key, plen, data)
        moved = _pointers(dec) != before
        # planted fault: one byte of a shipped payload flipped in transit
        key, plen, data = sample
        bad = {n: t.clone() for n, t in data.items()}
        flat = bad["k"].view(torch.uint8).view(-1)
        flat[flat.numel() // 2] ^= 1
        other = _fleet_engine(params, cfg, kv_dtype=kv_dtype)
        other.import_prefix(key, plen, bad)
        caught = not all(_same_bytes(h, data[n]) for h, n in zip(_held_blocks(other, key),
                                                                 ("k", "v", "k_scale", "v_scale")))
        med = lambda xs: sorted(xs)[len(xs) // 2]  # noqa: E731
        print(f"[t] handoff ({kv_dtype or 'bf16'} KV): {equal}/{len(prompts)} imports equal "
              f"the exported blocks byte for byte; pool and params moved: {moved}; export "
              f"{med(export_ms):.3f} ms (median; {min(export_ms):.3f}-{max(export_ms):.3f}), "
              f"import {med(import_ms):.3f} ms ({min(import_ms):.3f}-{max(import_ms):.3f}), "
              f"{med(sizes) / 1e6:.3f} MB a handoff (median; {min(sizes) / 1e6:.3f}-"
              f"{max(sizes) / 1e6:.3f}); a flipped byte caught: {caught}")
        check(equal == len(prompts), "[t] an import differs from its export")
        check(not moved, "[t] the import moved the pool or the params")
        check(caught, "[t] the block compare does not see a flipped byte")
        del pre, dec, other


def _fleet_steady(params, cfg, prompts, fresh) -> dict:
    """3: a warmed disaggregated fleet (ship mode, journal on) serves fresh
    prompts of the same shapes under compileguard.budget(0); check_fleet
    after every step; then the same in re-prefill mode. Returns the warmed
    fleets."""
    from hivedscheduler_tpu_torch.chaos import invariants as inv
    from hivedscheduler_tpu_torch.common import compileguard
    from hivedscheduler_tpu_torch.obs import journal
    from hivedscheduler_tpu_torch.ops import attention as attn

    def audit(router, step):
        inv.check_fleet(router, f"step {step}")

    fleets = {}
    old = os.environ.get("HIVED_COMPILE_GUARD")
    os.environ["HIVED_COMPILE_GUARD"] = "1"
    try:
        for mode, ship in (("ship", True), ("re-prefill", False)):
            _zero_launches(attn)
            compileguard.reset()
            journal.enable()
            r = _fleet(params, cfg, ship)
            _serve_fleet(r, prompts, SRV_BUDGET, audit)
            warm = compileguard.counts()
            with compileguard.budget(0):
                run = _serve_fleet(r, fresh, SRV_BUDGET, audit)
            faults = flight_faults(journal.JOURNAL.flights())
            gaps = max(abs(fl["ttft_gap"]) for fl in journal.JOURNAL.flights().values())
            launches = _count_launches(attn)
            print(f"[t] {mode} fleet (1 prefill + 2 decode, journal on): warm-up captures "
                  f"{warm}, captures serving {len(fresh)} fresh prompts of the same shapes "
                  f"under budget(0): {compileguard.total() - sum(warm.values())}; handoffs "
                  f"{r.handoffs}; check_fleet clean after each of the steps; flight faults "
                  f"{faults[:3]} (worst |TTFT gap| {gaps:.3e} s); flash launches {launches}")
            check(all(len(f.tokens_out) == SRV_BUDGET for f in run["reqs"]),
                  f"[t] {mode}: a stream fell short")
            graphs = sum(rep.engine._window is not None and rep.engine._window.graph is not None
                         for rep in r.replicas.values())
            check(warm.get("serve.decode_window", 0) == graphs >= 2,
                  f"[t] {mode}: {warm} captures for {graphs} decode graphs")
            check(gaps <= 1e-6 and not [f for f in faults if "miss the TTFT" not in f],
                  f"[t] {mode}: flight faults {faults[:3]}")
            check(not any(launches.values()), f"[t] {mode}: flash launches {launches}")
            _obs_off()
            fleets[mode] = r
    finally:
        if old is None:
            os.environ.pop("HIVED_COMPILE_GUARD", None)
        else:
            os.environ["HIVED_COMPILE_GUARD"] = old
        compileguard.reset()
        _obs_off()
    return fleets


def _fleet_kill(params, cfg, prompts) -> None:
    """4: a decode replica killed while its decode legs are in flight (the
    handoff done): each stream retries on the surviving decode replica and
    finishes; check_fleet after every step."""
    from hivedscheduler_tpu_torch.chaos import invariants as inv

    r = _fleet(params, cfg, True)
    reqs = [r.submit(list(p), SRV_BUDGET) for p in prompts[:6]]
    victim = None
    for _ in range(200):
        r.step()
        live = [f for f in reqs if f.handoff is None and f.attempts and not f.done]
        if live:
            victim = live[0].replica
            break
    check(victim is not None, "[t] no decode leg came into flight")
    on_victim = sum(1 for f in reqs if not f.done and f.replica == victim)
    r.kill(victim)
    steps = 0
    while r.step():
        inv.check_fleet(r, f"after the kill, step {steps}")
        steps += 1
    inv.check_fleet(r, "drained")
    reasons = sorted({f.finish_reason for f in reqs})
    print(f"[t] killed decode replica {victim} with {on_victim} stream(s) on it: {r.retried} "
          f"retried, finish reasons {reasons}, lengths {sorted({len(f.tokens_out) for f in reqs})}; "
          "check_fleet clean after every step")
    check(r.retried >= on_victim >= 1 and reasons == ["length"]
          and all(len(f.tokens_out) == SRV_BUDGET for f in reqs),
          "[t] a stream on the lost replica did not finish")


def _fleet_planted(params, cfg, prompts) -> None:
    """5: the checks see planted faults: a prefill leg's journal mark
    dropped (the TTFT gap) and a request with two live attempts."""
    from hivedscheduler_tpu_torch.chaos import invariants as inv
    from hivedscheduler_tpu_torch.obs import journal

    note_leg = journal.note_leg
    journal.enable()
    try:
        journal.note_leg = lambda req, leg, **kw: (None if leg == "prefill"
                                                    else note_leg(req, leg, **kw))
        r = _fleet(params, cfg, True, decode=1)
        _serve_fleet(r, prompts[:2], 4)
    finally:
        journal.note_leg = note_leg
    try:
        inv.check_requests(r, "dropped leg")
        gap = "not caught"
    except inv.InvariantViolation as err:
        gap = str(err)
    _obs_off()
    f = r.submit(list(prompts[2]), SRV_BUDGET)
    r.step()
    stray = r.replicas["d0"].engine.submit(list(prompts[2]), SRV_BUDGET)
    f.attempts.insert(0, ("d0", stray))
    try:
        inv.check_fleet(r, "two attempts")
        double = "not caught"
    except inv.InvariantViolation as err:
        double = str(err)
    print(f"[t] planted: the prefill leg's mark dropped -> {gap}; two live attempts -> {double}")
    check("TTFT legs sum differs" in gap, "[t] the dropped leg passed")
    check("double-routed" in double, "[t] two live attempts passed")


def _fleet_turns(params, cfg, prompts, fleets) -> None:
    """6: tokens/s, TTFT and TPOT of the single engine and the warmed ship
    and re-prefill fleets on (k)'s system-prompt trace, in turns."""
    single = _fleet_engine(params, cfg)
    _serve(single, prompts, SRV_BUDGET)  # capture
    out = {"single": [], "ship": [], "re-prefill": []}
    for _ in range(FLEET_TURNS):
        for name in ("single", "ship", "re-prefill", "re-prefill", "ship", "single"):
            if name == "single":
                run = _serve(single, prompts, SRV_BUDGET)
                st = _serve_stats(run, SRV_BATCH)
            else:
                st = _fleet_stats(_serve_fleet(fleets[name], prompts, SRV_BUDGET))
            out[name].append(st)
    for name, stats in out.items():
        print(f"[t] {name} in turns ({SRV_REQUESTS} requests, budget {SRV_BUDGET}): tokens/s "
              f"{', '.join(f'{s['tps']:.1f}' for s in stats)}; TTFT p50 ms "
              f"{', '.join(f'{s['ttft_p50']:.2f}' for s in stats)}, max "
              f"{', '.join(f'{s['ttft_max']:.2f}' for s in stats)}; TPOT p50 ms "
              f"{', '.join(f'{s['tpot_p50']:.3f}' for s in stats)}")
    ratio = [f / s["tps"] for f, s in zip((x["tps"] for x in out["ship"]), out["single"])]
    print(f"[t] ship fleet tokens/s over the single engine's, turn by turn: "
          + ", ".join(f"{x:.3f}" for x in ratio))


def phase_fleet(srv: dict) -> None:
    """(t): the serving fleet (router, KV handoff, autoscaler) at the
    flagship width through the serve CLI and in-process."""
    import numpy as np
    import torch

    from hivedscheduler_tpu_torch.models import transformer as tm

    tmp = tempfile.mkdtemp(prefix="chip_smoke_fleet_")
    try:
        cfg = tm.TransformerConfig(max_seq_len=SRV_MAX_LEN, **EVAL_MODEL)
        system = _srv_prompts(cfg.vocab_size, 1, seed=7, lo=SRV_SYSTEM, hi=SRV_SYSTEM + 1)[0]
        prompts = _srv_prompts(cfg.vocab_size, SRV_REQUESTS, seed=8, system=system)
        rng = np.random.default_rng(12)
        fresh = [system + [int(t) for t in rng.integers(0, cfg.vocab_size, len(p) - SRV_SYSTEM)]
                 for p in prompts]

        def in_process():
            params = tm.cast_params(tm.init_params(
                cfg, torch.Generator(device="cuda").manual_seed(0), "cuda"), cfg.dtype)
            _fleet_handoff(params, cfg, prompts)
            fleets = _fleet_steady(params, cfg, prompts, fresh)
            _fleet_kill(params, cfg, prompts)
            _fleet_planted(params, cfg, prompts)
            _fleet_turns(params, cfg, prompts, fleets)
            del params, fleets
            torch.cuda.empty_cache()

        _timed_parts("[t]", [("serve CLI", lambda: _fleet_cli(tmp, srv["noise"])),
                             ("in-process", in_process)])
    finally:
        _obs_off()
        shutil.rmtree(tmp, ignore_errors=True)


# phase (u): elastic training and the serving mesh on the one card. The
# elastic run is (h)'s step at 2 layers: the CLI asked for tp 2 x fsdp 2
# derives the one-card mesh
ELASTIC_ARGS = CKPT_ARGS + ["--n-layers", "2", "--steps", str(TRAIN_STEPS)]
ELASTIC_FLAGS = ["--elastic", "--min-chips", "1", "--tp", "2", "--fsdp", "2"]
# the cross-device resume: the harness's tiny model trains 2 steps on a
# 2-rank gloo gang on the machine's CPU, then resumes on the card to 4,
# held to an uninterrupted 2-rank CPU run within JAX's LOSS_ATOL
XRESUME_SPLIT, XRESUME_STEPS = 2, 4
# the world-1 serving mesh: rounds of (plain, mesh, mesh, plain) timed runs
MESH_SRV_TURNS = 2


class _TpLocal:
    """The collectives of a tp = 2 rank with the all-reduce and the logits
    gather left out, so that the decode step times one rank's own work."""

    tp, dp = 2, 1

    @staticmethod
    def tp_sum(x):
        return x

    @staticmethod
    def vocab_gather(x):
        return x

    @staticmethod
    def gather_rows(x):
        return x


def _elastic_train(tmp: str) -> dict:
    """1: train --elastic at (h)'s shape in turns with the plain run
    (plain, elastic, elastic, plain): the derived mesh in its warning,
    K1-K3 launched, losses bit for bit those of the run without
    --elastic, the step times; then the floor."""
    import torch

    from hivedscheduler_tpu_torch import train as port_train
    from hivedscheduler_tpu_torch.ops import attention as attn

    warnings = []

    class Warn(logging.Handler):
        def emit(self, record):
            if record.levelno >= logging.WARNING:
                warnings.append(record.getMessage())

    handler = Warn()
    logging.getLogger(port_train.__name__).addHandler(handler)
    losses, walls, launches = {"plain": [], "elastic": []}, {"plain": [], "elastic": []}, []
    try:
        for i, name in enumerate(("plain", "elastic", "elastic", "plain")):
            _zero_launches(attn)
            flags = ELASTIC_FLAGS if name == "elastic" else []
            losses[name].append(_train_main(tmp, f"u-{name}-{i}", "--n-layers", "2",
                                            "--steps", str(TRAIN_STEPS), *flags))
            if name == "elastic":
                launches.append(_count_launches(attn))
            with open(os.path.join(tmp, f"u-{name}-{i}.jsonl")) as f:
                recs = [json.loads(line) for line in f]
            # the steps after the first, which warms up
            walls[name].append(1e3 * sum(r["wall_s"] for r in recs[1:]) / (len(recs) - 1))
    finally:
        logging.getLogger(port_train.__name__).removeHandler(handler)
    derived = [w for w in warnings if w.startswith("elastic: requested")]
    print(f"[u] train {' '.join(ELASTIC_FLAGS)} at (h)'s shape, 2 layers: warnings "
          f"{derived[:1]} (x{len(derived)}); K1/K2/K3 launches "
          f"{[(n['fwd'], n['dq'], n['dkv']) for n in launches]}; losses {losses['elastic'][0]} "
          f"vs without --elastic {losses['plain'][0]}; step ms in turns ({card_line()}): "
          f"plain {', '.join(f'{v:.2f}' for v in walls['plain'])}, elastic "
          f"{', '.join(f'{v:.2f}' for v in walls['elastic'])}")
    check(len(derived) == 2 and all(
        w.endswith("derived mesh MeshAxes(dp=1, fsdp=1, pp=1, ep=1, tp=1, sp=1)")
        for w in derived), f"[u] derived-mesh warnings {derived}")
    check(all(min(n["fwd"], n["dq"], n["dkv"]) > 0 for n in launches),
          f"[u] the elastic step launched {launches}")
    check(all(run == losses["plain"][0] for run in losses["plain"] + losses["elastic"]),
          "[u] elastic losses differ from the run without --elastic")

    # the floor: exits before any weight reaches the card
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    try:
        port_train.main(ELASTIC_ARGS + ["--elastic", "--min-chips", "2"])
        floor = None
    except SystemExit as err:
        floor = str(err.code)
    after = torch.cuda.memory_allocated()
    print(f"[u] --elastic --min-chips 2 on one card: {floor!r}; device bytes "
          f"allocated {before} -> {after}")
    check(floor == "elastic job floor not met: offered 1 chip(s), --min-chips 2",
          f"[u] floor: {floor!r}")
    check(after == before, "[u] the floor exit left weights on the card")
    return {"elastic_ms": walls["elastic"], "plain_ms": walls["plain"]}


def _start_cpu_gangs(tmp: str) -> dict:
    """2a: the elastic harness's tiny model on two 2-rank gloo gangs on the
    machine's CPU, started now and awaited by :func:`_cross_device_resume`:
    one commits a dp = 2 checkpoint at step 2, the other runs
    uninterrupted to step 4."""
    from hivedscheduler_tpu_torch.chaos import workload as chaos

    h = chaos.ElasticWorkloadHarness(0, tmp)
    ck, ref_ck = os.path.join(tmp, "x-ck"), os.path.join(tmp, "x-ref-ck")
    ref_tl = os.path.join(tmp, "x-ref.jsonl")
    gangs = [h.spawn(ck, os.path.join(tmp, "x-cpu.jsonl"), 2, paced=False,
                     steps=XRESUME_SPLIT),
             h.spawn(ref_ck, ref_tl, 2, paced=False, steps=XRESUME_STEPS)]
    return dict(harness=h, gangs=gangs, ck=ck, ref_tl=ref_tl)


def _cross_device_resume(tmp: str, started: dict) -> dict:
    """2b: the CPU gang's dp = 2 checkpoint resumed by train --elastic on
    the card: crossTopology in the journal, the cross-topology counter, the
    new commit's mesh, losses within LOSS_ATOL of the uninterrupted 2-rank
    CPU run, and a planted resume that skips a step caught."""
    from hivedscheduler_tpu_torch import train as port_train
    from hivedscheduler_tpu_torch.chaos import workload as chaos
    from hivedscheduler_tpu_torch.obs import goodput, journal
    from hivedscheduler_tpu_torch.parallel import checkpoint as ckpt
    from hivedscheduler_tpu_torch.parallel import data as data_lib

    h, ck, ref_tl = started["harness"], started["ck"], started["ref_tl"]
    rcs = [h.wait(g, name) for g, name in zip(started["gangs"],
                                              ("cpu gang", "reference gang"))]
    check(rcs == [0, 0], f"[u] the CPU gangs exited {rcs}: {h.violations}")
    saved = ckpt.read_metadata(ck)
    bad_ck = os.path.join(tmp, "x-bad-ck")
    shutil.copytree(ck, bad_ck)

    def on_card(ckdir, name, *extra):
        tl = os.path.join(tmp, f"{name}.jsonl")
        args = h.train_args(ckdir, tl, steps=XRESUME_STEPS)
        args[args.index("--device") + 1] = "cuda"
        rc = port_train.main(args + list(extra))
        check(rc == 0, f"[u] {name} exited {rc}")
        return chaos.read_timeline(tl)

    jf, gp = os.path.join(tmp, "x-journal.jsonl"), os.path.join(tmp, "x-goodput.jsonl")
    _obs_off()
    counts0 = _registry_counts()
    got = on_card(ck, "x-card", "--journal-file", jf, "--goodput-file", gp)
    counts = _registry_counts()
    _close_goodput()
    journal.disable()
    journal.JOURNAL.clear()
    with open(jf) as f:
        resumes = [e for e in map(json.loads, f) if e["type"] == "train_resume"]
    restore_s = goodput.aggregate_spool(goodput.read_spool(gp))["phases"].get(
        "checkpoint_restore", 0.0)
    key = ("tpu_hive_train_cross_topology_resumes_total", ())
    cross = counts.get(key, 0) - counts0.get(key, 0)
    after = ckpt.read_metadata(ck)
    ref = chaos.read_timeline(ref_tl)
    err = max(abs(got[s] - ref[s]) for s in got)

    orig = data_lib.CheckpointableBatches.__dict__["from_dict"]

    def skipping(*a, **kw):
        loader = orig.__get__(None, data_lib.CheckpointableBatches)(*a, **kw)
        loader.skip(1)  # planted: the resume skips one step of data
        return loader

    data_lib.CheckpointableBatches.from_dict = staticmethod(skipping)
    try:
        bad = on_card(bad_ck, "x-card-skip")
    finally:
        data_lib.CheckpointableBatches.from_dict = orig
    bad_err = max(abs(bad[s] - ref[s]) for s in bad)
    print(f"[u] cross-device resume: a 2-rank gloo gang on the CPU committed step "
          f"{XRESUME_SPLIT} on mesh {saved['mesh']}; train --elastic --device cuda resumed "
          f"it to step {XRESUME_STEPS}: train_resume {[e['args'] for e in resumes]}, "
          f"cross-topology resumes counted {cross}, new commit mesh {after['mesh']}, "
          f"restore {restore_s:.3f} s; losses {got} vs the uninterrupted 2-rank CPU run "
          f"{ref}: max |diff| {err:.3e} (limit {chaos.ElasticWorkloadHarness.LOSS_ATOL}); "
          f"planted resume that skips a step: max |diff| {bad_err:.3e}")
    check(saved["mesh"]["dp"] == 2, f"[u] the gang committed mesh {saved['mesh']}")
    check(len(resumes) == 1 and resumes[0]["args"]["crossTopology"] is True
          and resumes[0]["args"]["step"] == XRESUME_SPLIT, f"[u] resume events {resumes}")
    check(cross == 1, f"[u] cross-topology resumes counted {cross}")
    check(after["mesh"]["dp"] == 1 and ckpt.latest_step(ck) == XRESUME_STEPS,
          f"[u] the card's commit records {after['mesh']}")
    check(after["elastic"] == {"min_chips": 1, "requested": dict(
        tp=1, sp=1, fsdp=1, pp=1, ep=1)}, f"[u] elastic metadata {after['elastic']}")
    check(sorted(got) == list(range(XRESUME_SPLIT + 1, XRESUME_STEPS + 1)),
          f"[u] the card ran steps {sorted(got)}")
    check(err <= chaos.ElasticWorkloadHarness.LOSS_ATOL,
          f"[u] resumed losses {err:.3e} off the reference")
    check(bad_err > chaos.ElasticWorkloadHarness.LOSS_ATOL,
          "[u] the loss check does not see a resume that skips a step")
    return {"restore_s": restore_s}


def _mesh_engines(mesh) -> dict:
    """3: ServingEngine(mesh=) at world 1 on (k)'s trace: streams equal
    the mesh-less engine's, dense and paged graph windows captured and
    replayed, no new capture once warm; planted vocab-shard and dp-row
    faults caught; tokens/s and TPOT p50 in turns with the mesh-less
    engine."""
    import numpy as np
    import torch

    from hivedscheduler_tpu_torch.common import compileguard
    from hivedscheduler_tpu_torch.models import serving as srv
    from hivedscheduler_tpu_torch.models import transformer as tm
    from hivedscheduler_tpu_torch.parallel import sharding

    cfg = tm.TransformerConfig(max_seq_len=SRV_MAX_LEN, **EVAL_MODEL)
    params = tm.cast_params(tm.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda"), cfg.dtype)
    prompts = _srv_prompts(cfg.vocab_size, SRV_REQUESTS, seed=2)
    # fresh prompts of the same lengths, served once the engines are warm
    rng = np.random.default_rng(21)
    fresh = [[int(t) for t in rng.integers(0, cfg.vocab_size, len(p))] for p in prompts]

    def engine(with_mesh, **kw):
        kw = dict(dict(max_batch=SRV_BATCH, max_len=SRV_MAX_LEN), **kw)
        return srv.ServingEngine(params, cfg, mesh=mesh if with_mesh else None, **kw)

    old = os.environ.get("HIVED_COMPILE_GUARD")
    os.environ["HIVED_COMPILE_GUARD"] = "1"
    engines, refs, lines = {}, {}, []
    try:
        for name in ("dense graph", "paged graph"):
            kw = SRV_RUNS[name]
            compileguard.reset()
            plain = engine(False, **kw)
            meshed = engine(True, **kw)
            ref = _streams(_serve(plain, prompts, SRV_BUDGET))
            got = _streams(_serve(meshed, prompts, SRV_BUDGET))
            warm = compileguard.counts()
            with compileguard.budget(0):
                ref2 = _streams(_serve(plain, fresh, SRV_BUDGET))
                got2 = _streams(_serve(meshed, fresh, SRV_BUDGET))
            new = compileguard.total() - sum(warm.values())
            differ = sum(a != b for a, b in zip(got + got2, ref + ref2))
            lines.append(f"{name}: requests whose stream differs from the mesh-less "
                         f"engine's {differ} of {2 * len(prompts)}; windows through the "
                         f"graph {meshed.graph_windows}/{meshed.fused_windows}; warm-up "
                         f"captures {warm}, new captures once warm {new}")
            check(differ == 0, f"[u] {name}: mesh streams differ from the mesh-less engine's")
            check(meshed.graph_windows == meshed.fused_windows > 0,
                  f"[u] {name}: the mesh engine's windows bypassed the graph")
            check(warm.get("serve.decode_window", 0) == 2 and new == 0,
                  f"[u] {name}: captures {warm}, {new} new once warm")
            engines[name] = (plain, meshed)
            refs[name] = ref
    finally:
        if old is None:
            os.environ.pop("HIVED_COMPILE_GUARD", None)
        else:
            os.environ["HIVED_COMPILE_GUARD"] = old
        compileguard.reset()
    print("[u] world-1 serving mesh (NCCL) on (k)'s trace: " + "; ".join(lines))

    # planted faults on the eager mesh engine: two vocab shards swapped in
    # the logits gather, and the dp rows gathered in the wrong order; the
    # reference is the mesh-less dense graph run's streams ((k): eager and
    # graph streams are token-identical)
    ref = refs["dense graph"]
    planted = {}
    for fault, attr, fn in (
            ("vocab shards swapped", "vocab_gather",
             lambda self, x: torch.cat(x.chunk(2, -1)[::-1], -1)),
            ("dp rows to the wrong rank", "gather_rows",
             lambda self, x: torch.roll(x, 1, 0))):
        orig = getattr(sharding.ServingShards, attr)
        setattr(sharding.ServingShards, attr, fn)
        try:
            bad = _streams(_serve(engine(True), prompts, SRV_BUDGET))
        finally:
            setattr(sharding.ServingShards, attr, orig)
        planted[fault] = sum(a != b for a, b in zip(bad, ref))
    print(f"[u] planted faults, requests whose stream differs: {planted}")
    check(all(v > 0 for v in planted.values()), f"[u] a planted fault was missed {planted}")

    # tokens/s and TPOT p50 of the dense graph engines in turns
    plain, meshed = engines["dense graph"]
    stats = {"plain": [], "mesh": []}
    for _ in range(MESH_SRV_TURNS):
        for name, eng in (("plain", plain), ("mesh", meshed), ("mesh", meshed),
                          ("plain", plain)):
            stats[name].append(_serve_stats(_serve(eng, prompts, SRV_BUDGET), SRV_BATCH))
    out = {name: dict(tps=[s["tps"] for s in runs], tpot=[s["tpot_p50"] for s in runs])
           for name, runs in stats.items()}
    print(f"[u] dense graph engine (decode_steps {SRV_STEPS}) in turns, {card_line()}: "
          + "; ".join(f"{name}: tokens/s {', '.join(f'{v:.1f}' for v in o['tps'])}, TPOT "
                      f"p50 ms {', '.join(f'{v:.3f}' for v in o['tpot'])}"
                      for name, o in out.items()))
    del engines, plain, meshed, params
    torch.cuda.empty_cache()
    return out


def _mesh_generate(mesh) -> None:
    """4: make_sharded_generate at world 1 equals generate at (j)'s shape."""
    import torch

    from hivedscheduler_tpu_torch.models import decode as dec
    from hivedscheduler_tpu_torch.models import transformer as tm

    cfg = tm.TransformerConfig(max_seq_len=DEC_PROMPT + DEC_NEW, **EVAL_MODEL)
    params = tm.cast_params(tm.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda"), cfg.dtype)
    prompt = torch.randint(0, cfg.vocab_size, (DEC_BATCH, DEC_PROMPT), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(1))
    run, layout, rows = dec.make_sharded_generate(cfg, mesh, DEC_NEW)
    got = run(layout(params), rows(prompt))
    want = dec.generate(params, prompt, cfg, DEC_NEW)
    print(f"[u] make_sharded_generate at world 1 (B {DEC_BATCH}, prompt {DEC_PROMPT}, "
          f"{DEC_NEW} new): equal to generate: {bool(torch.equal(got, want))}")
    check(torch.equal(got, want), "[u] make_sharded_generate differs from generate")
    del params
    torch.cuda.empty_cache()


def _tp_local_decode() -> dict:
    """5: the decode step of a tp = 2 rank's shard of the flagship (8
    heads, 4 kv heads, d_ff / 2, vocab / 2) in turns with the whole model,
    B 16 at (j)'s context, eager and as a CUDA-graph replay; the
    all-reduce and the logits gather are not issued (one card)."""
    import torch

    from hivedscheduler_tpu_torch.models import decode as dec
    from hivedscheduler_tpu_torch.models import transformer as tm
    from hivedscheduler_tpu_torch.parallel import sharding

    cfg = tm.TransformerConfig(max_seq_len=DEC_PROMPT + DEC_NEW, **EVAL_MODEL)
    params = tm.cast_params(tm.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda"), cfg.dtype)
    specs = tm.sharding_specs(cfg)

    def walk(node, spec):
        if isinstance(node, dict):
            return {k: walk(v, spec[k]) for k, v in node.items()}
        return sharding._local_leaf(node, spec, {"tp": 2}, {"tp": 0})

    local = walk(params, specs)
    prompt = torch.randint(0, cfg.vocab_size, (DEC_BATCH, DEC_PROMPT), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(1))
    tok = prompt[:, -1:]
    caches = {}
    for name, p, kv, shards in (("full", params, None, None),
                                ("tp-local", local, cfg.kv_heads // 2, _TpLocal())):
        cache = dec.init_kv_cache(cfg, DEC_BATCH, DEC_PROMPT + DEC_NEW, "cuda", kv)
        _, cache = dec.advance(p, cache, prompt, cfg, shards)
        caches[name] = (p, cache, shards)

    def step(name):
        p, cache, shards = caches[name]
        # one token at the prompt's end, rewritten in place each call
        return dec.advance(p, dec.KVCache(cache.k, cache.v, DEC_PROMPT), tok, cfg, shards)

    def graphed(name):
        # the step captured once, so that a replay times the device's work
        # without the eager step's host dispatch
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            step(name)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            step(name)
        return graph

    graphs = {name: graphed(name) for name in caches}
    ms = {"full": [], "tp-local": []}
    graph_ms = {"full": [], "tp-local": []}
    for _ in range(2):
        for name in ("full", "tp-local", "tp-local", "full"):
            ms[name].append(time_ms(lambda: step(name), 20))
            graph_ms[name].append(time_ms(graphs[name].replay, 50))

    def line(d):
        return "; ".join(f"{name} {', '.join(f'{v:.3f}' for v in vals)} ms"
                         for name, vals in d.items())

    print(f"[u] decode step, B {DEC_BATCH} at position {DEC_PROMPT}, the whole model "
          f"against a tp = 2 rank's shard (8 heads, 4 kv heads, d_ff {cfg.d_ff // 2}, vocab "
          f"{cfg.vocab_size // 2}) in turns ({card_line()}): eager {line(ms)} (best ratio "
          f"{min(ms['tp-local']) / min(ms['full']):.3f}); CUDA-graph replay "
          f"{line(graph_ms)} (best ratio "
          f"{min(graph_ms['tp-local']) / min(graph_ms['full']):.3f}); the all-reduce and the "
          f"logits gather are not measured (one card)")
    del graphs, caches, params, local
    torch.cuda.empty_cache()
    return {"eager": ms, "graph": graph_ms}


def _mesh_clis() -> None:
    """6: generate and serve as subprocesses, each twice: placed in a
    one-GPU gang (the scheduler's handoff in the environment), which takes
    the CLIs' mesh branch at world 1 (the gang's NCCL group, the
    ``("dp", "tp")`` mesh, rank-0 printing, the serve loop's agreed
    step), and alone, which does not. Both exit 0 and print the same
    tokens. The mesh branch at tp or dp above 1 needs more than one GPU:
    it is held on CPU gangs by the tests."""
    from hivedscheduler_tpu_torch.chaos import workload as chaos

    small = [a for k, v in dict(EVAL_MODEL, n_layers=2).items()
             for a in (f"--{k.replace('_', '-')}", str(v))] + ["--device", "cuda"]
    cmds = {
        "generate": small + ["--batch", "2", "--prompt-len", "16", "--new-tokens", "8"],
        "serve": small + ["--requests", "4", "--max-batch", "2", "--max-len", "64",
                          "--max-new-tokens", "8"],
    }
    alone = {k: v for k, v in os.environ.items() if k not in chaos._GANG_VARS}
    gang = dict(alone, **chaos.gang_env(1, 0))
    procs = {(name, how): subprocess.Popen(
        [sys.executable, "-m", f"hivedscheduler_tpu_torch.{name}"] + argv, cwd=REPO,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name, argv in cmds.items() for how, env in (("gang", gang), ("alone", alone))}
    outs = {}
    try:
        for (name, how), p in procs.items():
            out, err = p.communicate(timeout=300)
            check(p.returncode == 0,
                  f"[u] {name} ({how}) exited {p.returncode}: {err[-2000:]}")
            meshed = "serving mesh dp=1 tp=1: rank 0 of 1" in err
            check(meshed == (how == "gang"),
                  f"[u] {name} ({how}) took the mesh branch: {meshed}")
            outs[name, how] = out
    finally:
        _stop(procs.values())
    for name in cmds:
        rows = len(outs[name, "gang"].splitlines())
        check(rows > 0 and outs[name, "gang"] == outs[name, "alone"],
              f"[u] {name} in a one-GPU gang printed other tokens than alone")
        print(f"[u] {name} in a one-GPU gang (the mesh branch at world 1): exit 0, "
              f"{rows} rows equal to the run alone")


def phase_elastic_mesh() -> None:
    """(u): elastic training through the CLI, a cross-topology and
    cross-device resume, the serving mesh at world 1, sharded generate,
    the tp-local decode step and the CLIs' mesh branch at world 1."""
    from hivedscheduler_tpu_torch.parallel import topology

    tmp = tempfile.mkdtemp(prefix="chip_smoke_elastic_")
    started = {}
    try:
        # the CPU gangs run beside the CLIs, which only report exit codes;
        # every timed part runs with neither
        parts = _timed_parts("[u]", [
            ("elastic train", lambda: _elastic_train(tmp)),
            ("tp-local decode", _tp_local_decode),
            ("CLIs beside the CPU gangs",
             lambda: (started.update(_start_cpu_gangs(tmp)), _mesh_clis())),
            ("cross-device resume", lambda: _cross_device_resume(tmp, started)),
        ])
        with _world_1_gang():
            mesh = topology.serving_mesh(1, 1, "cuda")
            _mesh_generate(mesh)
            srv = _mesh_engines(mesh)
        train, decode_ms, resume = parts[0], parts[1], parts[3]
        print(f"[u] numbers ({card_line()}): elastic step "
              f"{', '.join(f'{v:.2f}' for v in train['elastic_ms'])} ms (without --elastic, "
              f"in turns: {', '.join(f'{v:.2f}' for v in train['plain_ms'])} ms); "
              f"cross-device restore "
              f"{resume['restore_s']:.3f} s; world-1 mesh engine tokens/s "
              f"{max(srv['mesh']['tps']):.1f} (mesh-less {max(srv['plain']['tps']):.1f}), "
              f"TPOT p50 {min(srv['mesh']['tpot']):.3f} ms (mesh-less "
              f"{min(srv['plain']['tpot']):.3f} ms); tp-local decode step eager "
              f"{min(decode_ms['eager']['tp-local']):.3f} ms (full "
              f"{min(decode_ms['eager']['full']):.3f} ms), graph "
              f"{min(decode_ms['graph']['tp-local']):.3f} ms (full "
              f"{min(decode_ms['graph']['full']):.3f} ms)")
    finally:
        _stop(p for gang in started.get("gangs", []) for p in gang)
        shutil.rmtree(tmp, ignore_errors=True)


# phase (v): the pipeline and MoE under sequence parallelism. One card, so
# pp = 1: the GPipe schedule at one stage on the world-1 mesh, at (h)'s
# shape, and one pp = 2 stage's work; pp = 2 and sp = 2 run on CPU gangs
PIPE_MICRO = (2, 4)
PIPE_MOE_LAYERS = 2  # two MoE train states stay resident (~11 GB each)
PIPE_TURNS = 2  # rounds of (plain, pipelined..., pipelined..., plain) steps
PIPE_STAGE = dict(pp=2, n_micro=4)  # one stage: 3 of the 6 layers
# the cross-layout resumes: tests/test_pipeline_moe.py's tiny model, 2 steps
# on a 2-rank gloo gang, resumed on the card to 4, held to an uninterrupted
# 2-rank run within the elastic harness's 0.02
XLAYOUT_MODEL = ["--batch", "4", "--seq-len", "16", "--vocab-size", "64",
                 "--d-model", "32", "--n-layers", "4", "--n-heads", "4", "--d-ff", "64",
                 "--log-every", "100", "--checkpoint-every", "2"]
# name: (the gang's flags, the card's flags)
XLAYOUT_GANGS = {"pp2": (["--pp", "2", "--microbatches", "2"], []),
                 "sp2-moe": (["--sp", "2", "--n-experts", "4"], ["--n-experts", "4"])}
XLAYOUT_SPLIT, XLAYOUT_STEPS = 2, 4


def _pipe_cfg(n_micro: int, **over):
    from hivedscheduler_tpu_torch.models import transformer as tm

    return tm.TransformerConfig(max_seq_len=EVAL_SEQ, attn_impl="flash", remat="dots",
                                pipeline_microbatches=n_micro, **dict(EVAL_MODEL, **over))


def _short_grads(params, grads) -> dict:
    """{leaf name without ``layers.``: its whole gradient} (world 1)."""
    from hivedscheduler_tpu_torch.parallel import sharding
    from hivedscheduler_tpu_torch.parallel.checkpoint import named_leaves

    return {name.split(".")[-1]: sharding.local(g)
            for name, g in zip(named_leaves(params), grads)}


def _pipe_states(mesh, host, micro, **over) -> dict:
    """{n_micro (0: the plain step): (step, params, opt, tokens)} from
    seed 0 on the world-1 mesh."""
    import torch

    from hivedscheduler_tpu_torch.parallel import data as data_lib
    from hivedscheduler_tpu_torch.parallel import train as port_train

    states = {}
    for n in (0,) + tuple(micro):
        step, init_fn, tok_sh = port_train.make_sharded_train_step(
            _pipe_cfg(n, **over), mesh, ce_chunk=EVAL_CE_CHUNK)
        params, opt = init_fn(torch.Generator(device="cuda").manual_seed(0))
        tokens = [data_lib.device_put_global(x, tok_sh, EVAL_BATCH) for x in host]
        states[n] = (step, params, opt, tokens)
    return states


def _pipe_turns(states, tag: str) -> dict:
    """Steps of each state timed in turns by CUDA events, with the peak
    device memory each step adds to what is resident."""
    import torch

    names = list(states)
    order = names + names[::-1]
    ms = {n: [] for n in names}
    peak = {n: 0 for n in names}
    for _ in range(PIPE_TURNS):
        for n in order:
            step, params, opt, tokens = states[n]
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            ms[n] += _steps_by_events(step, params, opt, tokens[:1])[1]
            peak[n] = max(peak[n], torch.cuda.max_memory_allocated() - base)
    label = {n: "plain" if n == 0 else f"pipeline n_micro {n}" for n in names}
    print(f"{tag} step ms in turns ({PIPE_TURNS} x {', '.join(label[n] for n in order)}; "
          f"{card_line()}): " + "; ".join(
              f"{label[n]} {', '.join(f'{x:.3f}' for x in ms[n])} (median "
              f"{sorted(ms[n])[len(ms[n]) // 2]:.3f}), step peak over the resident "
              f"states {peak[n] / 1e9:.2f} GB" for n in names))
    return {n: dict(ms=ms[n], peak_gb=peak[n] / 1e9) for n in names}


def _pipe_dense(mesh, h_flash: dict) -> dict:
    """1: the flagship step through the one-stage pipeline (n_micro 2 and
    4) in turns with the plain step: launches, losses, gradients by group,
    step ms and peak memory. Returns the n_micro 2 run's launches."""
    import numpy as np
    import torch

    from hivedscheduler_tpu_torch.ops import attention as attn
    from hivedscheduler_tpu_torch.parallel import data as data_lib
    from hivedscheduler_tpu_torch.parallel import train as port_train

    loader = data_lib.CheckpointableBatches(
        data_lib.synthetic_dataset(EVAL_MODEL["vocab_size"]), EVAL_BATCH, EVAL_SEQ)
    host = [np.asarray(next(loader)) for _ in range(TRAIN_STEPS)]
    states = _pipe_states(mesh, host, PIPE_MICRO)
    # the first step's gradients, before any update, each from seed 0
    grads = {}
    for n, (_, params, _, tokens) in states.items():
        _, g = port_train.value_and_grad(params, tokens[0], _pipe_cfg(n), mesh,
                                         ce_chunk=EVAL_CE_CHUNK)
        grads[n] = _short_grads(params, g)
    layers = EVAL_MODEL["n_layers"]
    per_step = {"fwd": 2 * layers, "dq": layers, "dkv": layers}
    losses, launches = {}, {}
    for n, (step, params, opt, tokens) in states.items():
        _zero_launches(attn)
        losses[n], _ = _steps_by_events(step, params, opt, tokens)
        launches[n] = {k: v for k, v in _count_launches(attn).items() if k in per_step}
    for n in PIPE_MICRO:
        groups, worst = _group_errs(grads[n], grads[0])
        want = {k: n * v * TRAIN_STEPS for k, v in per_step.items()}
        first = abs(losses[n][0] - losses[0][0])
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses[n], losses[0]))
        print(f"[v] one-stage pipeline, n_micro {n}, at (h)'s shape (world-1 mesh, flash, "
              f"remat dots, ce_chunk {EVAL_CE_CHUNK}): K1/K2/K3 launches over "
              f"{TRAIN_STEPS} steps {launches[n]} (want {want}: n_micro x (h)'s per-step "
              f"{per_step}); losses {losses[n]} vs plain {losses[0]}: the first step's "
              f"|diff| {first:.3e} (<= {LOSS_ATOL}), every step's relative |diff| <= "
              f"{rel:.3e} (<= {MESH_LOSS_REL}); first-step gradients vs plain by group: "
              + ", ".join(f"{k} {v:.3e}" for k, v in groups.items())
              + f" (<= {TRAIN_GRAD_REL}), worst (leaf, layer) {worst:.3e} "
              f"(<= {TRAIN_GRAD_SLICE_REL})")
        check(launches[n] == want, f"[v] n_micro {n} launched {launches[n]}, want {want}")
        check(first <= LOSS_ATOL and rel <= MESH_LOSS_REL,
              f"[v] n_micro {n} losses off the plain step's")
        check(all(v <= TRAIN_GRAD_REL for v in groups.values())
              and worst <= TRAIN_GRAD_SLICE_REL, f"[v] n_micro {n} gradients off")
    check(all(math.isfinite(x) for x in losses[0]), "[v] non-finite plain losses")
    print(f"[v] the plain mesh step's losses {losses[0]} vs (h)'s CLI {h_flash['losses']}")
    timing = _pipe_turns(states, "[v] dense")
    # whether the pipelined steps wait on the host: one traced step of each
    for n, (step, params, opt, tokens) in states.items():
        wall, busy, parts = _step_profile(step, params, opt, tokens[0])
        timing[n].update(wall_ms=wall, busy_ms=busy)
        print(f"[v] one traced step, {'plain' if n == 0 else f'pipeline n_micro {n}'}: "
              f"wall {wall:.3f} ms, device busy {busy:.3f} ms (idle "
              f"{1 - busy / wall:.1%}): " + ", ".join(f"{k} {v:.3f}" for k, v in parts.items()))
    del states, grads
    torch.cuda.empty_cache()
    return {"launches": launches[PIPE_MICRO[0]], "timing": timing}


def _pipe_moe(mesh) -> None:
    """2: the MoE model ([n]'s 8 experts, top-2, 2 layers) through the
    one-stage pipeline (n_micro 2) against the plain step: the
    cross-entropy within (d)'s limit, the aux beside the plain one (they
    differ by design), step ms in turns."""
    import numpy as np
    import torch

    from hivedscheduler_tpu_torch.models import transformer as tm
    from hivedscheduler_tpu_torch.parallel import data as data_lib
    from hivedscheduler_tpu_torch.parallel import train as port_train

    over = dict(n_layers=PIPE_MOE_LAYERS, n_experts=MOE_MODEL["n_experts"],
                moe_top_k=MOE_MODEL["moe_top_k"])
    loader = data_lib.CheckpointableBatches(
        data_lib.synthetic_dataset(EVAL_MODEL["vocab_size"]), EVAL_BATCH, EVAL_SEQ)
    host = [np.asarray(next(loader))]
    states = _pipe_states(mesh, host, PIPE_MICRO[:1], **over)
    out = {}
    with torch.no_grad():
        for n, (_, params, _, tokens) in states.items():
            cfg = _pipe_cfg(n, **over)
            _, aux = tm.forward_with_aux(params, tokens[0], cfg, mesh)
            ce = port_train.loss_fn(params, tokens[0], cfg, mesh, ce_chunk=EVAL_CE_CHUNK,
                                    include_aux=False)
            out[n] = (float(ce), float(aux))
    n = PIPE_MICRO[0]
    diff = abs(out[n][0] - out[0][0])
    print(f"[v] MoE (8 experts, top-2, {PIPE_MOE_LAYERS} layers) through the one-stage "
          f"pipeline, n_micro {n}: cross-entropy {out[n][0]:.6f} vs plain {out[0][0]:.6f} "
          f"(|diff| {diff:.3e} <= {LOSS_ATOL}); aux {out[n][1]:.6e} vs plain "
          f"{out[0][1]:.6e}: they differ by design (the pipeline takes each "
          f"microbatch's routing statistics, the JAX package's stage body; the plain "
          f"step the whole batch's)")
    check(diff <= LOSS_ATOL, "[v] the pipelined MoE cross-entropy is off the plain one")
    _pipe_turns(states, "[v] MoE")
    del states
    torch.cuda.empty_cache()


def _pipe_stage(mesh) -> dict:
    """3: one pp = 2 stage's work, 3 of the 6 layers on 4 microbatches
    forward and backward with no transfer, in turns with the whole
    6-layer plain step; with the GPipe bubble."""
    import numpy as np
    import torch

    from hivedscheduler_tpu_torch.models import transformer as tm
    from hivedscheduler_tpu_torch.ops import attention as attn
    from hivedscheduler_tpu_torch.parallel import data as data_lib
    from hivedscheduler_tpu_torch.parallel import pipeline

    pp, n_micro = PIPE_STAGE["pp"], PIPE_STAGE["n_micro"]
    layers = EVAL_MODEL["n_layers"] // pp
    cfg = _pipe_cfg(n_micro, n_layers=layers)
    params = tm.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    for leaf in params["layers"].values():
        leaf.requires_grad_(True)
    shards = tm.mesh_shards(mesh, cfg)
    stage = pipeline.Stage(cfg, tm._resolve_attn_fn(cfg, mesh), shards)
    mb = EVAL_BATCH // n_micro
    gen = torch.Generator(device="cuda").manual_seed(1)
    xs = [torch.randn(mb, EVAL_SEQ, cfg.d_model, device="cuda", dtype=cfg.dtype,
                      generator=gen) for _ in range(n_micro)]
    dys = [torch.randn_like(x) for x in xs]
    positions = tm.token_positions(torch.zeros(mb, EVAL_SEQ, device="cuda"), shards)
    leaves = list(params["layers"].values())

    def work():
        outs = []
        for x in xs:
            outs.append(stage.run(x.requires_grad_(True), positions, params["layers"])[0])
        for x, y, dy in zip(reversed(xs), reversed(outs), reversed(dys)):
            torch.autograd.grad([y], leaves + [x], [dy])

    _zero_launches(attn)
    work()
    torch.cuda.synchronize()
    got = {k: v for k, v in _count_launches(attn).items() if k in ("fwd", "dq", "dkv")}
    want = {"fwd": 2 * layers * n_micro, "dq": layers * n_micro, "dkv": layers * n_micro}
    check(got == want, f"[v] one stage launched {got}, want {want}")
    # the whole 6-layer plain step on the same card, in turns
    loader = data_lib.CheckpointableBatches(
        data_lib.synthetic_dataset(EVAL_MODEL["vocab_size"]), EVAL_BATCH, EVAL_SEQ)
    whole = _pipe_states(mesh, [np.asarray(next(loader))], ())[0]
    _steps_by_events(*whole)  # the warm-up: the optimizer's state is made
    ms = {"stage": [], "whole": []}
    for _ in range(PIPE_TURNS):
        for name in ("whole", "stage", "stage", "whole"):
            if name == "whole":
                ms[name] += _steps_by_events(*whole)[1]
            else:
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                work()
                end.record()
                torch.cuda.synchronize()
                ms[name].append(start.elapsed_time(end))
    med = {k: sorted(v)[len(v) // 2] for k, v in ms.items()}
    bubble = pipeline.bubble(pp, n_micro)
    print(f"[v] one pp = {pp} stage's work ({layers} of {EVAL_MODEL['n_layers']} layers, "
          f"{n_micro} microbatches of {mb} rows, forward and backward, no transfer; "
          f"launches {got}) in turns with the whole {EVAL_MODEL['n_layers']}-layer plain "
          f"step ({card_line()}): stage {', '.join(f'{x:.3f}' for x in ms['stage'])} ms "
          f"(median {med['stage']:.3f}), whole step {', '.join(f'{x:.3f}' for x in ms['whole'])}"
          f" ms (median {med['whole']:.3f}); GPipe bubble (pp - 1) / (n_micro + pp - 1) = "
          f"{bubble:.3f}, so a pp = {pp} step would take at least {med['stage']:.3f} / "
          f"(1 - {bubble:.3f}) = {med['stage'] / (1 - bubble):.3f} ms of each stage's time "
          f"before transfers, embedding and loss")
    del params, stage, whole, xs, dys
    torch.cuda.empty_cache()
    return {"stage_ms": med["stage"], "whole_ms": med["whole"], "bubble": bubble}


def _start_layout_gangs(tmp: str) -> dict:
    """4a: for each of ``XLAYOUT_GANGS``, a 2-rank gloo gang on the
    machine's CPU that commits step 2 and one that runs uninterrupted to
    step 4; awaited by :func:`_layout_resumes`."""
    from hivedscheduler_tpu_torch.chaos import workload as chaos
    from hivedscheduler_tpu_torch.parallel import distributed

    started = {}
    for name, (flags, _) in XLAYOUT_GANGS.items():
        for run, steps in (("ck", XLAYOUT_SPLIT), ("ref", XLAYOUT_STEPS)):
            port = str(distributed._free_local_port())
            argv = XLAYOUT_MODEL + flags + [
                "--device", "cpu", "--steps", str(steps),
                "--checkpoint-dir", os.path.join(tmp, f"v-{name}-{run}"),
                "--timeline", os.path.join(tmp, f"v-{name}-{run}.jsonl")]
            started[(name, run)] = [subprocess.Popen(
                [sys.executable, "-c", chaos._GANG_LAUNCH, port] + argv, cwd=REPO,
                env=chaos.cpu_only_env(gang=(2, rank)), stdout=subprocess.DEVNULL,
                stderr=subprocess.DEVNULL) for rank in range(2)]
    return started


def _swapped_stages(real_restore):
    """A restore that swaps the two halves of every stacked layer leaf
    (the two pp = 2 stages' blocks) after loading: the planted fault."""
    import torch

    def restore(directory, params, opt_state, step=None):
        out = real_restore(directory, params, opt_state, step)
        with torch.no_grad():
            for leaf in params["layers"].values():
                half = leaf.shape[0] // 2
                leaf.copy_(torch.cat([leaf[half:], leaf[:half]]))
        return out

    return restore


def _layout_resumes(tmp: str, started: dict) -> dict:
    """4b: each gang's commit resumed on the card by ``train --device cuda``
    at pp 1 and sp 1: the restored state equal to the checkpoint read on
    the CPU, the losses within the harness's 0.02 of the uninterrupted
    gang, the restore seconds; the stages' layer blocks swapped on restore
    caught."""
    import torch

    from hivedscheduler_tpu_torch import train as port_train
    from hivedscheduler_tpu_torch.chaos import workload as chaos
    from hivedscheduler_tpu_torch.models import transformer as tm
    from hivedscheduler_tpu_torch.parallel import checkpoint as ckpt
    from hivedscheduler_tpu_torch.parallel import train as ptrain

    for key, procs in started.items():
        rcs = [p.wait(timeout=600) for p in procs]
        check(rcs == [0, 0], f"[v] the {key} CPU gang exited {rcs}")
    def mismatches(params, opt, params2, opt2) -> int:
        """Parameters and AdamW entries of a card state that differ from a
        CPU state's."""
        a, b = ckpt.named_leaves(params), ckpt.named_leaves(params2)
        bad = 0
        for name, x in a.items():
            y = b[name]
            pairs = [(x, y)] + [(m, opt2.state[y].get(k)) for k, m in opt.state[x].items()]
            bad += sum(1 for u, v in pairs
                       if v is None or not torch.equal(u.detach().cpu(), v.detach().cpu()))
        return bad

    out = {}
    for name, (flags, card_flags) in XLAYOUT_GANGS.items():
        ck = os.path.join(tmp, f"v-{name}-ck")
        saved = ckpt.read_metadata(ck)
        experts = 4 if "--n-experts" in flags else 0
        cfg = tm.TransformerConfig(vocab_size=64, d_model=32, n_heads=4, n_layers=4,
                                   d_ff=64, max_seq_len=16, n_experts=experts)

        def restored(device, restore):
            _, init_fn = ptrain.make_train_step(cfg, device)
            params, opt = init_fn(torch.Generator(device=device).manual_seed(1))
            t0 = time.perf_counter()
            restore(ck, params, opt)
            if device == "cuda":
                torch.cuda.synchronize()
            return params, opt, time.perf_counter() - t0

        cpu_params, cpu_opt, _ = restored("cpu", ckpt.restore)
        faults = {}
        seconds = None
        for planted in (False, True):
            restore = _swapped_stages(ckpt.restore) if planted else ckpt.restore
            params, opt, s = restored("cuda", restore)
            seconds = seconds if planted else s
            faults[planted] = mismatches(cpu_params, cpu_opt, params, opt)
            del params, opt
            bad = os.path.join(tmp, f"v-{name}-{'bad' if planted else 'card'}")
            shutil.copytree(ck, bad)
            args = XLAYOUT_MODEL + card_flags + [
                "--device", "cuda", "--steps", str(XLAYOUT_STEPS), "--checkpoint-dir", bad,
                "--timeline", os.path.join(tmp, f"v-{name}-{planted}.jsonl")]
            real = ckpt.restore
            ckpt.restore = restore
            try:
                rc = port_train.main(args)
            finally:
                ckpt.restore = real
            check(rc == 0, f"[v] the {name} resume on the card exited {rc}")
            got = chaos.read_timeline(os.path.join(tmp, f"v-{name}-{planted}.jsonl"))
            ref = chaos.read_timeline(os.path.join(tmp, f"v-{name}-ref.jsonl"))
            err = max(abs(got[s] - ref[s]) for s in got)
            after = ckpt.read_metadata(bad)
            out[(name, planted)] = err
            print(f"[v] {name} gang commit (mesh {saved['mesh']}) resumed on the card "
                  f"{'with the stages swapped on restore (planted)' if planted else ''}: "
                  f"state mismatches against the checkpoint read on the CPU "
                  f"{faults[planted]}, losses {got} vs the uninterrupted gang "
                  f"{ {s: ref[s] for s in got} }: max |diff| {err:.3e} (limit "
                  f"{chaos.ElasticWorkloadHarness.LOSS_ATOL}); new commit mesh "
                  f"{after['mesh']}" + ("" if planted else f"; restore {seconds:.3f} s"))
            check(sorted(got) == list(range(XLAYOUT_SPLIT + 1, XLAYOUT_STEPS + 1)),
                  f"[v] the {name} resume ran steps {sorted(got)}")
        check(faults[False] == 0, f"[v] the {name} state restored on the card differs")
        check(faults[True] > 0, f"[v] the {name} state check does not see the planted swap")
        check(out[(name, False)] <= chaos.ElasticWorkloadHarness.LOSS_ATOL,
              f"[v] the {name} resumed losses are off the uninterrupted gang's")
        out[name] = seconds
    # the dense pipeline's swap moves the loss past the limit as well
    check(out[("pp2", True)] > chaos.ElasticWorkloadHarness.LOSS_ATOL,
          "[v] the loss check does not see the pp2 stages swapped")
    return out


def phase_pipeline(h_flash: dict) -> dict:
    """(v): the pipeline at one stage and one pp = 2 stage's work on the
    world-1 NCCL mesh, then the pp = 2 and sp = 2 MoE gangs' checkpoints
    resumed on the card."""
    from hivedscheduler_tpu_torch.parallel import topology

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip-smoke-v-")
    try:
        # the CPU gangs run beside the untimed checks only
        started = _start_layout_gangs(tmp)
        try:
            resumes = _layout_resumes(tmp, started)
        finally:
            _stop([p for procs in started.values() for p in procs])
        with _world_1_gang():
            mesh = topology.make_mesh(topology.MeshAxes(), "cuda")
            dense = _pipe_dense(mesh, h_flash)
            _pipe_moe(mesh)
            stage = _pipe_stage(mesh)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[v] phase wall time {time.perf_counter() - t_phase:.1f} s")
    return dict(dense, stage=stage, resumes=resumes)


# phase (w): overlapped tensor parallelism. A tp = 2 rank pair of the
# flagship (each rank 8 of the 16 heads, 4 of the 8 kv heads, half of d_ff)
# replayed in this process through shard_utils' per-hop functions: a rank's
# transfer is the other rank's tensor read in the hop's order
OVERLAP_TP = 2
OVERLAP_TURNS = 3  # rounds of (chunked, whole, whole, chunked) GEMM timings
_GATHER_QKV, _GATHER_MLP = "btd,dhk->bthk", "btd,df->btf"
_SCATTER_O, _SCATTER_MLP = "bthk,hkd->btd", "btf,fd->btd"


def _tp_shards(lp: dict, dtype) -> list:
    """Each tp rank's shards of one layer's projections in ``dtype``, cut as
    ``sharding_specs`` lays them over tp: heads, or the MLP hidden dim."""
    dims = dict(wq=1, wk=1, wv=1, wo=0, w_gate=1, w_up=1, w_down=0)
    return [{name: lp[name].detach().to(dtype).chunk(OVERLAP_TP, dim)[j].contiguous()
             for name, dim in dims.items()} for j in range(OVERLAP_TP)]


def _ring_gather(xs, wss, eq, plant=False):
    """``allgather_matmul`` on every rank: at hop s rank j holds the chunk of
    rank (j + s) % n (sent i -> i - 1) and places its products at that
    position (``place_hop``); ``plant`` puts them one position off."""
    from hivedscheduler_tpu_torch.parallel import shard_utils as su

    n = len(xs)
    outs = [None] * n
    for s in range(n):
        for j in range(n):
            src = (j + s) % n
            outs[j] = su.place_hop(outs[j], xs[src], wss[j], eq, (src + plant) % n, n)
    return outs


def _ring_gather_grad(xs, wss, dys, eq, plant=False):
    """The backward of :func:`_ring_gather` as ``_AllGatherMatmul`` runs it:
    hops in reverse, each rank's dx accumulator sent i -> i + 1 and added to
    the hop's part (``place_hop_grad``) -> (dx, each weight's gradient) per
    rank; ``plant`` drops the last hop's accumulator add."""
    from hivedscheduler_tpu_torch.parallel import shard_utils as su

    n = len(xs)
    dx, dws = [None] * n, [None] * n
    for s in reversed(range(n)):
        arrived = [dx[(j - 1) % n] for j in range(n)]
        for j in range(n):
            part, parts = su.place_hop_grad(dys[j], xs[(j + s) % n], wss[j], eq, (j + s) % n)
            dws[j] = parts if dws[j] is None else [a + b for a, b in zip(dws[j], parts)]
            keep = arrived[j] is not None and not (plant and s == 0)
            dx[j] = part + arrived[j] if keep else part
    return dx, dws


def _ring_scatter(xs, ws, eq):
    """``matmul_reducescatter`` on every rank: at step s rank j adds its part
    of chunk (j + s + 1) % n to the accumulator that arrived from rank j + 1
    (``accumulate_hop``)."""
    from hivedscheduler_tpu_torch.parallel import shard_utils as su

    n = len(xs)
    acc = [None] * n
    for s in range(n):
        arrived = [acc[(j + 1) % n] for j in range(n)]
        acc = [su.accumulate_hop(arrived[j], xs[j], ws[j], eq, (j + s + 1) % n, n)
               for j in range(n)]
    return acc


def _ring_scatter_grad(xs, ws, dys, eq):
    """The backward of :func:`_ring_scatter` as ``_MatmulReduceScatter`` runs
    it: dy all-gathered hop by hop (sent i -> i + 1), each hop giving one
    chunk of dx (``accumulate_hop_grad``), and dw x^T against the gathered
    dy -> (dx, dw) per rank."""
    import torch

    from hivedscheduler_tpu_torch.parallel import shard_utils as su

    n, t = len(xs), dys[0].shape[1]
    x_s, w_s, o_s = su._operands(eq)
    g = list(dys)
    dx = [x.new_empty(x.shape) for x in xs]
    dy_all = [d.new_empty((d.shape[0], t * n) + tuple(d.shape[2:])) for d in dys]
    for s in reversed(range(n)):
        for j in range(n):
            c = (j + s + 1) % n
            dx[j][:, c * t:(c + 1) * t].copy_(su.accumulate_hop_grad(g[j], ws[j], eq))
            dy_all[j][:, c * t:(c + 1) * t].copy_(g[j])
        g = [g[(j - 1) % n] for j in range(n)]
    return dx, [torch.einsum(f"{x_s},{o_s}->{w_s}", x, d) for x, d in zip(xs, dy_all)]


def _replay_layer(xs, lp, ws, positions, cfg, attn_fn, plant=False):
    """One dense layer of ``_apply_layer_overlapped`` on every replayed rank:
    ``xs`` are the ranks' token blocks, ``ws`` their projection shards."""
    import torch.nn.functional as F

    from hivedscheduler_tpu_torch.models import transformer as tm

    th = cfg.rope_theta
    h = [tm._rms_norm(x, lp["attn_norm"]) for x in xs]
    qkv = _ring_gather(h, [[w["wq"], w["wk"], w["wv"]] for w in ws], _GATHER_QKV, plant)
    att = [attn_fn(tm._rope(q, positions, th), tm._rope(k, positions, th), v, causal=True)
           for q, k, v in qkv]
    xs = [x + o for x, o in zip(xs, _ring_scatter(att, [w["wo"] for w in ws], _SCATTER_O))]
    h = [tm._rms_norm(x, lp["mlp_norm"]) for x in xs]
    gate_up = _ring_gather(h, [[w["w_gate"], w["w_up"]] for w in ws], _GATHER_MLP, plant)
    mid = [F.silu(g) * u for g, u in gate_up]
    return [x + d for x, d in zip(xs, _ring_scatter(mid, [w["w_down"] for w in ws],
                                                    _SCATTER_MLP))]


def _replay_stack(params, tokens, cfg, attn_fn, plant=False):
    """The overlapped stack of a tp = 2 rank pair, replayed: every layer on
    both ranks' token blocks, then the blocks joined -> final-norm hidden
    states."""
    import torch

    from hivedscheduler_tpu_torch.models import transformer as tm

    positions = tm.token_positions(tokens)
    xs = list(tm.embed_tokens(params, tokens, cfg).chunk(OVERLAP_TP, dim=1))
    for lp in tm.layer_leaves(params["layers"]):
        xs = _replay_layer(xs, lp, _tp_shards(lp, cfg.dtype), positions, cfg, attn_fn, plant)
    return tm._rms_norm(torch.cat(xs, dim=1), params["final_norm"])


def _replay_layer_grad(x, lp, dy, positions, cfg, attn_fn, plant=False) -> dict:
    """One layer's backward on a replayed tp = 2 rank pair: the rank-local
    pieces (norms, RoPE, attention through K1-K3, SiLU, the residual adds)
    by autograd on each rank, the collective matmuls by their hand-written
    backward schedules -> {"x", each layer leaf: the whole gradient}, the
    weights' from the ranks' shards joined and the norms' summed over the
    ranks."""
    import torch
    import torch.nn.functional as F

    from hivedscheduler_tpu_torch.models import transformer as tm

    n, th = OVERLAP_TP, cfg.rope_theta
    ws = _tp_shards(lp, cfg.dtype)

    def leaf(t):
        return t.detach().requires_grad_(True)

    def grad(outs, ins, gs):
        return torch.autograd.grad(outs, ins, gs)

    xs = [leaf(b) for b in x.chunk(n, dim=1)]
    n1 = [leaf(lp["attn_norm"]) for _ in range(n)]
    n2 = [leaf(lp["mlp_norm"]) for _ in range(n)]
    h1 = [tm._rms_norm(xj, nj) for xj, nj in zip(xs, n1)]
    h1_in = [h.detach() for h in h1]
    w_qkv = [[w["wq"], w["wk"], w["wv"]] for w in ws]
    qkv = [[leaf(t) for t in r] for r in _ring_gather(h1_in, w_qkv, _GATHER_QKV)]
    att = [attn_fn(tm._rope(q, positions, th), tm._rope(k, positions, th), v, causal=True)
           for q, k, v in qkv]
    a_in = [a.detach() for a in att]
    o = [leaf(t) for t in _ring_scatter(a_in, [w["wo"] for w in ws], _SCATTER_O)]
    x2 = [xj + oj for xj, oj in zip(xs, o)]
    h2 = [tm._rms_norm(x2j, nj) for x2j, nj in zip(x2, n2)]
    h2_in = [h.detach() for h in h2]
    w_gu = [[w["w_gate"], w["w_up"]] for w in ws]
    gate_up = [[leaf(t) for t in r] for r in _ring_gather(h2_in, w_gu, _GATHER_MLP)]
    mid = [F.silu(g) * u for g, u in gate_up]
    dys = list(dy.chunk(n, dim=1))
    # y = x2 + the down projection's reduce-scatter of mid
    d_mid, d_down = _ring_scatter_grad([m.detach() for m in mid], [w["w_down"] for w in ws],
                                       dys, _SCATTER_MLP)
    d_gu = [grad(mid[j], gate_up[j], d_mid[j]) for j in range(n)]
    d_h2, d_wgu = _ring_gather_grad(h2_in, w_gu, d_gu, _GATHER_MLP, plant)
    g_mid = [grad((x2[j], h2[j]), (xs[j], o[j], n2[j]), (dys[j], d_h2[j])) for j in range(n)]
    d_att, d_wo = _ring_scatter_grad(a_in, [w["wo"] for w in ws], [g[1] for g in g_mid],
                                     _SCATTER_O)
    d_qkv = [grad(att[j], qkv[j], d_att[j]) for j in range(n)]  # K2, K3
    d_h1, d_wqkv = _ring_gather_grad(h1_in, w_qkv, d_qkv, _GATHER_QKV, plant)
    g_in = [grad(h1[j], (xs[j], n1[j]), d_h1[j]) for j in range(n)]
    out = {"x": torch.cat([g_mid[j][0] + g_in[j][0] for j in range(n)], dim=1),
           "attn_norm": sum(g[1] for g in g_in), "mlp_norm": sum(g[2] for g in g_mid),
           "wo": torch.cat(d_wo, dim=0), "w_down": torch.cat(d_down, dim=0)}
    for i, name in enumerate(("wq", "wk", "wv")):
        out[name] = torch.cat([d[i] for d in d_wqkv], dim=1)
    for i, name in enumerate(("w_gate", "w_up")):
        out[name] = torch.cat([d[i] for d in d_wgu], dim=1)
    return out


OVERLAP_GRAD_GROUPS = {"input": ("x",), "attention": ("wq", "wk", "wv", "wo"),
                       "mlp": ("w_gate", "w_up", "w_down"), "norms": ("attn_norm", "mlp_norm")}


def _layer_grad_errs(got: dict, ref: dict):
    """({group: relative Frobenius over its leaves}, the worst leaf's)."""
    def sq(t):
        return float(t.float().norm()) ** 2

    groups = {g: (sum(sq(got[n] - ref[n]) for n in names) / sum(sq(ref[n]) for n in names)) ** 0.5
              for g, names in OVERLAP_GRAD_GROUPS.items()}
    worst = max((sq(got[n] - ref[n]) / sq(ref[n])) ** 0.5 for n in ref)
    return groups, worst


def _overlap_gemm_turns(params, cfg) -> dict:
    """(4): rank 0's projection GEMMs of one layer, forward and backward, as
    the collective matmuls chunk them (two hops, the products placed and the
    accumulators added) against the same rank's GEMMs on the whole gathered
    sequence, by CUDA events in turns; the transfers cannot be seen on one
    card."""
    import torch
    import torch.nn.functional as F

    from hivedscheduler_tpu_torch.models import transformer as tm
    from hivedscheduler_tpu_torch.parallel import shard_utils as su

    lp = tm.layer_leaves(params["layers"])[0]
    w = _tp_shards(lp, cfg.dtype)[0]
    gen = torch.Generator(device="cuda").manual_seed(71)
    b, t, d = EVAL_BATCH, EVAL_SEQ, cfg.d_model
    hl, hk, f = cfg.n_heads // OVERLAP_TP, cfg.kv_heads // OVERLAP_TP, cfg.d_ff // OVERLAP_TP

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(cfg.dtype)

    h, att, mid = randn(b, t, d), randn(b, t, hl, cfg.head_dim), randn(b, t, f)
    # contiguous, as a rank holds them: its own block and the received ones
    chunks = [c.contiguous() for c in h.chunk(OVERLAP_TP, dim=1)]
    other = randn(b, t // OVERLAP_TP, d)  # the accumulator rank 1 sends
    dq, dk = randn(b, t, hl, cfg.head_dim), randn(b, t, hk, cfg.head_dim)
    dg, dy = randn(b, t, f), randn(b, t // OVERLAP_TP, d)
    dy_whole = torch.cat([dy] * OVERLAP_TP, dim=1)
    qkv, gu = [w["wq"], w["wk"], w["wv"]], [w["w_gate"], w["w_up"]]

    def chunked_fwd():
        for ws, eq in ((qkv, _GATHER_QKV), (gu, _GATHER_MLP)):
            outs = None
            for s in range(OVERLAP_TP):
                outs = su.place_hop(outs, chunks[s], ws, eq, s, OVERLAP_TP)
        for x, wt, eq in ((att, w["wo"], _SCATTER_O), (mid, w["w_down"], _SCATTER_MLP)):
            acc = None
            for s in range(OVERLAP_TP):
                acc = su.accumulate_hop(other if s else None, x, wt, eq, (s + 1) % OVERLAP_TP,
                                        OVERLAP_TP)

    def whole_fwd():
        for wt in qkv:
            torch.einsum(_GATHER_QKV, h, wt)
        for wt in gu:
            torch.einsum(_GATHER_MLP, h, wt)
        torch.einsum(_SCATTER_O, att, w["wo"])
        torch.einsum(_SCATTER_MLP, mid, w["w_down"])

    def chunked_bwd():
        for ws, eq, dys in ((qkv, _GATHER_QKV, [dq, dk, dk]), (gu, _GATHER_MLP, [dg, dg])):
            dx = None
            for s in reversed(range(OVERLAP_TP)):
                part, _ = su.place_hop_grad(dys, chunks[s], ws, eq, s)
                dx = part if dx is None else part + dx
        for x, wt, eq in ((att, w["wo"], _SCATTER_O), (mid, w["w_down"], _SCATTER_MLP)):
            x_s, w_s, o_s = su._operands(eq)
            dx, dy_all = x.new_empty(x.shape), dy_whole.new_empty(dy_whole.shape)
            n = dy.shape[1]
            for s in reversed(range(OVERLAP_TP)):
                c = (s + 1) % OVERLAP_TP
                dx[:, c * n:(c + 1) * n].copy_(su.accumulate_hop_grad(dy, wt, eq))
                dy_all[:, c * n:(c + 1) * n].copy_(dy)
            torch.einsum(f"{x_s},{o_s}->{w_s}", x, dy_all)

    def whole_bwd():
        for ws, eq, dys in ((qkv, _GATHER_QKV, [dq, dk, dk]), (gu, _GATHER_MLP, [dg, dg])):
            x_s, w_s, o_s = su._operands(eq)
            dx = None
            for wt, g in zip(ws, dys):
                part = torch.einsum(f"{o_s},{w_s}->{x_s}", g, wt)
                dx = part if dx is None else dx + part
                torch.einsum(f"{x_s},{o_s}->{w_s}", h, g)
        for x, wt, eq in ((att, w["wo"], _SCATTER_O), (mid, w["w_down"], _SCATTER_MLP)):
            x_s, w_s, o_s = su._operands(eq)
            torch.einsum(f"{o_s},{w_s}->{x_s}", dy_whole, wt)
            torch.einsum(f"{x_s},{o_s}->{w_s}", x, dy_whole)

    readings = {k: [] for k in ("chunked_fwd", "whole_fwd", "chunked_bwd", "whole_bwd")}
    fns = dict(chunked_fwd=chunked_fwd, whole_fwd=whole_fwd, chunked_bwd=chunked_bwd,
               whole_bwd=whole_bwd)
    for _ in range(OVERLAP_TURNS):
        for order in (("chunked", "whole"), ("whole", "chunked")):
            for way in order:
                for part in ("fwd", "bwd"):
                    readings[f"{way}_{part}"].append(time_ms(fns[f"{way}_{part}"], iters=10))
    rows = b * t
    flops_fwd = 2 * rows * d * (hl + 2 * hk) * cfg.head_dim + 2 * rows * hl * cfg.head_dim * d \
        + 2 * 2 * rows * d * f + 2 * rows * f * d
    med = {k: statistics.median(v) for k, v in readings.items()}
    for part, flops in (("fwd", flops_fwd), ("bwd", 2 * flops_fwd)):
        print(f"[w] (4) rank 0's projection GEMMs of one layer, {part}: chunked (2 hops) "
              f"{', '.join(f'{x:.4f}' for x in readings[f'chunked_{part}'])} ms, whole gathered "
              f"{', '.join(f'{x:.4f}' for x in readings[f'whole_{part}'])} ms in turns; medians "
              f"{med[f'chunked_{part}']:.4f} / {med[f'whole_{part}']:.4f} = "
              f"{med[f'chunked_{part}'] / med[f'whole_{part}']:.3f}x "
              f"({flops / 1e9:.1f} GFLOP: {flops / med[f'chunked_{part}'] / 1e9:.1f} / "
              f"{flops / med[f'whole_{part}'] / 1e9:.1f} TFLOP/s)")
    del h, att, mid, chunks, other, dq, dk, dg, dy, dy_whole
    torch.cuda.empty_cache()
    return med


def _overlap_world_1() -> None:
    """(5): at world 1 ``train --overlap`` exits with the JAX CLI's usage
    error, and with ``overlap`` None the world-1 mesh runs the reference
    body (the counter unmoved, K1 launched)."""
    import numpy as np
    import torch

    from hivedscheduler_tpu_torch import train as port_train
    from hivedscheduler_tpu_torch.models import transformer as tm
    from hivedscheduler_tpu_torch.ops import attention as attn
    from hivedscheduler_tpu_torch.parallel import data as data_lib
    from hivedscheduler_tpu_torch.parallel import topology
    from hivedscheduler_tpu_torch.parallel import train as ptrain

    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        try:
            port_train.main(["--steps", "1", "--overlap", "--device", "cuda"])
            code = 0
        except SystemExit as exc:
            code = exc.code
    want = "--overlap requested but inapplicable: tp axis is 1: no tensor collectives to overlap"
    print(f"[w] (5) train --overlap at world 1: exit {code}; "
          f"{[l for l in err.getvalue().splitlines() if 'error' in l]}")
    check(code == 2 and want in err.getvalue(), "train --overlap at world 1 is not JAX's usage error")
    cfg = tm.TransformerConfig(max_seq_len=EVAL_SEQ, attn_impl="flash",
                               **dict(EVAL_MODEL, n_layers=2))
    with _world_1_gang():
        mesh = topology.make_mesh(topology.MeshAxes(), "cuda")
        ok, reason = tm.overlap_applicable(cfg, mesh, EVAL_SEQ, EVAL_BATCH)
        eval_step, init_fn, sharding = ptrain.make_sharded_eval_step(cfg, mesh, EVAL_CE_CHUNK)
        params = init_fn(torch.Generator(device="cuda").manual_seed(0))
        corpus = data_lib.synthetic_dataset(cfg.vocab_size).tokens
        batch = np.asarray(corpus[:EVAL_BATCH * EVAL_SEQ], dtype=np.int32).reshape(
            EVAL_BATCH, EVAL_SEQ)
        stacks, attn.FLASH_FWD_LAUNCHES = tm.OVERLAPPED_STACKS, 0
        loss = float(eval_step(params, data_lib.device_put_global(batch, sharding, EVAL_BATCH)))
        launched = attn.FLASH_FWD_LAUNCHES
        del params
    torch.cuda.empty_cache()
    print(f"[w] (5) world-1 mesh, overlap None: gate ({ok}, {reason!r}); eval loss "
          f"{loss:.6f}, overlapped stacks run {tm.OVERLAPPED_STACKS - stacks}, K1 {launched}")
    check(not ok and tm.OVERLAPPED_STACKS == stacks and launched == cfg.n_layers
          and math.isfinite(loss), "the world-1 mesh did not run the reference body")


def phase_overlap(tp_local: dict) -> dict:
    """(w): a tp = 2 rank pair of overlapped tensor parallelism replayed on
    the one card -> K1-K3's launches in the replay and their rows of the
    kernels line (errors and times at the tp-local shape, from (l))."""
    import numpy as np
    import torch

    from hivedscheduler_tpu_torch.models import transformer as tm
    from hivedscheduler_tpu_torch.ops import attention as attn
    from hivedscheduler_tpu_torch.parallel import data as data_lib

    t_phase = time.perf_counter()
    cfg = tm.TransformerConfig(max_seq_len=EVAL_SEQ, attn_impl="flash", **EVAL_MODEL)
    attn_fn = tm._resolve_attn_fn(cfg)
    params = tm.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    corpus = data_lib.synthetic_dataset(cfg.vocab_size).tokens
    tokens = torch.from_numpy(np.asarray(
        corpus[:EVAL_BATCH * EVAL_SEQ], dtype=np.int32).reshape(EVAL_BATCH, EVAL_SEQ)).cuda()
    positions = tm.token_positions(tokens)

    def zero_launches():
        attn.FLASH_FWD_LAUNCHES = attn.FLASH_BWD_DQ_LAUNCHES = attn.FLASH_BWD_DKV_LAUNCHES = 0

    def read_launches():
        return dict(fwd=attn.FLASH_FWD_LAUNCHES, dq=attn.FLASH_BWD_DQ_LAUNCHES,
                    dkv=attn.FLASH_BWD_DKV_LAUNCHES)

    # (1) the whole stack, both ranks, against the one-device forward
    with torch.inference_mode():
        h_ref = tm.forward_with_aux(params, tokens, cfg, return_hidden=True)[0]
        zero_launches()
        t0 = time.perf_counter()
        h_rep = _replay_stack(params, tokens, cfg, attn_fn)
        torch.cuda.synchronize()
        fwd_s = time.perf_counter() - t0
        launches = read_launches()
        h_bad = _replay_stack(params, tokens, cfg, attn_fn, plant=True)
    check(h_rep.shape == h_ref.shape and bool(torch.isfinite(h_rep).all()),
          f"replayed hidden states {tuple(h_rep.shape)}")
    fro, row = rel_errs(h_rep, h_ref)
    bad_fro, _ = rel_errs(h_bad, h_ref)
    print(f"[w] (1) a tp = 2 rank pair replayed through the overlapped stack "
          f"({cfg.n_layers} layers, q [{EVAL_BATCH},{EVAL_SEQ},{cfg.n_heads // OVERLAP_TP},"
          f"{cfg.head_dim}] a rank): final-norm hidden states against the one-device forward "
          f"rel {fro:.3e} (<= {HIDDEN_REL}), worst token rel {row:.3e}, max|err| "
          f"{float((h_rep.float() - h_ref.float()).abs().max()):.3e}; K1 {launches['fwd']} "
          f"launches; {fwd_s:.2f} s; planted fault (each chunk's products at the other "
          f"chunk's position): rel {bad_fro:.3e}")
    check(launches["fwd"] == OVERLAP_TP * cfg.n_layers, f"the replay launched K1 {launches}")
    check(fro <= HIDDEN_REL, "the replayed overlapped stack disagrees with the one-device forward")
    check(bad_fro > HIDDEN_REL, "the hidden-state check does not see the misplaced chunks")
    del h_ref, h_rep, h_bad

    # (2) one layer's backward, both ranks, against autograd of the layer
    lp = tm.layer_leaves(params["layers"])[0]
    with torch.no_grad():
        x = tm.embed_tokens(params, tokens, cfg)
    dy = torch.randn(x.shape, generator=torch.Generator(device="cuda").manual_seed(72),
                     device="cuda").to(cfg.dtype)
    leaves = {name: lp[name].detach().requires_grad_(True) for name in
              ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "w_gate", "w_up", "w_down")}
    x_leaf = x.detach().requires_grad_(True)
    y, _ = tm._apply_layer(x_leaf, leaves, positions, cfg, attn_fn)
    ref = dict(zip(["x", *leaves], torch.autograd.grad(y, [x_leaf, *leaves.values()], dy)))
    del y
    zero_launches()
    got = _replay_layer_grad(x, lp, dy, positions, cfg, attn_fn)
    torch.cuda.synchronize()
    grad_launches = read_launches()
    bad = _replay_layer_grad(x, lp, dy, positions, cfg, attn_fn, plant=True)
    check(all(bool(torch.isfinite(g).all()) for g in got.values()), "non-finite replayed gradients")
    groups, worst = _layer_grad_errs(got, ref)
    bad_groups, bad_worst = _layer_grad_errs(bad, ref)
    print(f"[w] (2) one layer's backward on the replayed pair against autograd of the "
          f"one-device layer, by group: " + ", ".join(f"{k} {v:.3e}" for k, v in groups.items())
          + f" (<= {TRAIN_GRAD_REL}); worst leaf {worst:.3e} (<= {TRAIN_GRAD_SLICE_REL}); "
          f"K1/K2/K3 {grad_launches['fwd']}/{grad_launches['dq']}/{grad_launches['dkv']}; "
          f"planted fault (the dx accumulator's last add dropped): "
          + ", ".join(f"{k} {v:.3e}" for k, v in bad_groups.items())
          + f", worst leaf {bad_worst:.3e}")
    check(all(v <= TRAIN_GRAD_REL for v in groups.values()) and worst <= TRAIN_GRAD_SLICE_REL,
          "the replayed gradients disagree with the one-device layer's")
    check(bad_groups["input"] > TRAIN_GRAD_REL or bad_worst > TRAIN_GRAD_SLICE_REL,
          "the gradient check does not see the dropped add")
    check(grad_launches == dict(fwd=OVERLAP_TP, dq=OVERLAP_TP, dkv=OVERLAP_TP),
          f"the replayed backward launched {grad_launches}")
    for key in launches:
        launches[key] += grad_launches[key]
    del ref, got, bad, x, dy, leaves, x_leaf, lp

    # (4) the GEMMs' cost of chunking, (5) the world-1 gate
    gemms = _overlap_gemm_turns(params, cfg)
    del params
    torch.cuda.empty_cache()
    _overlap_world_1()
    print(f"[w] phase wall time {time.perf_counter() - t_phase:.1f} s")
    source = "hivedscheduler_tpu_torch/ops/csrc/"
    rows = [dict(name=f"{name}_overlap", route="cuda", source=source + lib,
                 replaces=f"hivedscheduler_tpu/ops/attention.py:{line}",
                 launches=launches[key], **tp_local[key])
            for name, key, lib, line in (("flash_fwd", "fwd", "flash_fwd.cu", 98),
                                         ("flash_bwd_dq", "dq", "flash_bwd.cu", 143),
                                         ("flash_bwd_dkv", "dkv", "flash_bwd.cu", 179))]
    return dict(rows=rows, gemms=gemms)


def _stop(procs) -> None:
    """Kill and reap every process of ``procs`` still running."""
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    try:
        import hivedscheduler_tpu_torch  # noqa: F401
    except ImportError as err:
        print(f"chip_smoke: the port package is missing: {err}", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    print(f"[a] card: {card}")
    phase_build()
    max_err = phase_kernel_check()
    timing = phase_kernel_time()
    phase_eval()
    phase_hidden_check()
    bwd_err = phase_backward_check()
    bwd_timing = phase_backward_time()
    launches, train_flash = phase_train()
    phase_train_grads()
    phase_train_profile()
    phase_checkpoint()
    phase_decode()
    srv = phase_serving()
    tp_local = phase_mesh(train_flash)
    ring = phase_ring(train_flash)
    phase_moe()
    lora_dir = phase_lora(train_flash)
    try:
        phase_spec(srv, lora_dir)
    finally:
        shutil.rmtree(lora_dir, ignore_errors=True)
    phi3 = phase_phi3()
    gemma, gemma_f32 = phase_gemma()
    phase_obs()
    phase_fleet(srv)
    phase_elastic_mesh()
    pipe = phase_pipeline(train_flash)
    overlap = phase_overlap(tp_local)

    # launches are those of the training path, the train run of (h)
    source = "hivedscheduler_tpu_torch/ops/csrc/"
    kernels = [
        dict(name="flash_fwd", route="cuda", source=source + "flash_fwd.cu",
             replaces="hivedscheduler_tpu/ops/attention.py:98",
             launches=launches["fwd"], max_abs_err=max_err, **timing),
        dict(name="flash_bwd_dq", route="cuda", source=source + "flash_bwd.cu",
             replaces="hivedscheduler_tpu/ops/attention.py:143",
             launches=launches["dq"], max_abs_err=bwd_err["dq"], **bwd_timing["dq"]),
        dict(name="flash_bwd_dkv", route="cuda", source=source + "flash_bwd.cu",
             replaces="hivedscheduler_tpu/ops/attention.py:179",
             launches=launches["dkv"], max_abs_err=bwd_err["dkv"], **bwd_timing["dkv"]),
    ]
    # the f32 forms: launches of (m)'s ring_flash train run, times at its shape
    kernels += [
        dict(name=f"{name}_f32", route="cuda", source=source + lib,
             replaces=f"hivedscheduler_tpu/ops/attention.py:{line}", **ring[key])
        for name, key, lib, line in (("flash_fwd", "fwd", "flash_fwd.cu", 98),
                                     ("flash_bwd_dq", "dq", "flash_bwd.cu", 143),
                                     ("flash_bwd_dkv", "dkv", "flash_bwd.cu", 179))]
    # the same kernels at Phi-3-mini's head dim 96 (run at 128): launches of
    # (q)'s eval and train runs, times at its shape
    kernels += [
        dict(name=f"{name}_d96", route="cuda", source=source + lib,
             replaces=f"hivedscheduler_tpu/ops/attention.py:{line}", **phi3[key])
        for name, key, lib, line in (("flash_fwd", "fwd", "flash_fwd.cu", 98),
                                     ("flash_bwd_dq", "dq", "flash_bwd.cu", 143),
                                     ("flash_bwd_dkv", "dkv", "flash_bwd.cu", 179))]
    # and at Gemma-2B's head dim 256: launches of (r)'s eval and train runs,
    # times at its shape; the f32 forms' launches of (r)'s ring_flash run,
    # times at one sp = 4 hop of its heads
    kernels += [
        dict(name=f"{name}{form}_d256", route="cuda", source=source + lib,
             replaces=f"hivedscheduler_tpu/ops/attention.py:{line}", **rows[key])
        for form, rows in (("", gemma), ("_f32", gemma_f32))
        for name, key, lib, line in (("flash_fwd", "fwd", "flash_fwd.cu", 98),
                                     ("flash_bwd_dq", "dq", "flash_bwd.cu", 143),
                                     ("flash_bwd_dkv", "dkv", "flash_bwd.cu", 179))]
    # and through (v)'s one-stage pipeline at n_micro 2: its launches over
    # (h)'s steps, the errors and times of (b)-(c) and (f)-(g) at that shape
    measured = {"fwd": (max_err, timing), "dq": (bwd_err["dq"], bwd_timing["dq"]),
                "dkv": (bwd_err["dkv"], bwd_timing["dkv"])}
    kernels += [
        dict(name=f"{name}_pipeline", route="cuda", source=source + lib,
             replaces=f"hivedscheduler_tpu/ops/attention.py:{line}",
             launches=pipe["launches"][key], max_abs_err=measured[key][0], **measured[key][1])
        for name, key, lib, line in (("flash_fwd", "fwd", "flash_fwd.cu", 98),
                                     ("flash_bwd_dq", "dq", "flash_bwd.cu", 143),
                                     ("flash_bwd_dkv", "dkv", "flash_bwd.cu", 179))]
    # and through (w)'s replayed tp = 2 rank pair: its launches, the errors
    # and times of (l) at a tp = 2 rank's shape
    kernels += overlap["rows"]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
