"""Smoke run of the PyTorch/CUDA port (``hivedscheduler_tpu_torch``) on one
NVIDIA H100.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases, each of which must pass or the script exits non-zero:

(a) print the card's name and power limit; build the port's CUDA kernels
    ``hivedscheduler_tpu_torch/ops/csrc/flash_fwd.cu`` (K1) and
    ``flash_bwd.cu`` (K2, K3) with nvcc (sm_90a), both compilers at once,
    and print ptxas's register and spill lines and any warning that it
    serialized wgmma;
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
(i) checkpoint and resume at the flagship width (6 layers, train's flags of
    (h)): save the train state after one step (511.7 M f32 parameters and
    their AdamW moments, ~6.1 GB), restore it into zeroed templates on the
    card and require every parameter and moment bit-identical, and show
    that the check sees one flipped bit; run ``train`` 4 steps twice
    uninterrupted (A, A2), then 2 steps with ``--checkpoint-dir
    --checkpoint-every 2 --goodput-file`` (B) and the same command with
    ``--steps 4`` (B', which resumes), and hold B''s steps 3-4 to A's
    (bit-identical when A and A2 are, else within a relative 1e-3); resume
    again with the loader state dropped from the marker (fast-forward,
    which must pass) and with the loader restarted at position 0 (which
    must fail the same check); SIGTERM a ``python -m
    hivedscheduler_tpu_torch.train`` process on the card after its step 2
    and require exit 0 within the 60 s grace period with a committed
    marker at the step it stopped on, then a resumed incarnation that
    finishes; print the save and restore seconds, GB/s and B + B''s
    goodput phase seconds, and require the goodput spool's audit to be
    clean. The temp directory's free space is printed first, and the phase
    fails if it cannot hold two checkpoints.
(j) decode and generate at the flagship width (6 layers, bf16 weights cast
    from seed 0; bench_model.py's decode shape: batch 16, prompt 128, 64 new
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


def phase_hidden_check() -> None:
    import numpy as np
    import torch

    from hivedscheduler_tpu_torch.models import transformer as tm
    from hivedscheduler_tpu_torch.ops import attention as attn
    from hivedscheduler_tpu_torch.parallel import data as data_lib

    # the weights and first window of eval's run
    cfg_f = tm.TransformerConfig(max_seq_len=EVAL_SEQ, attn_impl="flash", **EVAL_MODEL)
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
    print(f"[e] final-norm hidden states, flash vs xla, one flagship window: "
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
        # time is its kernels' again
        if event.device_type != DeviceType.CUDA:
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


# phase (i): checkpoint, resume, preemption and goodput at the flagship width
CKPT_ARGS = TRAIN_ARGS + ["--attn", "flash"]
RESUME_STEPS, RESUME_SPLIT = 4, 2
# resumed losses against the uninterrupted run's when two uninterrupted runs
# are not bit-identical: the loss limit the port uses flash vs xla, relative
RESUME_REL = 1e-3
PREEMPT_STEPS, PREEMPT_AT, GRACE_SECS = 8, 2, 60.0


def _train_main(tmp: str, name: str, *extra: str) -> dict:
    """``train.main`` with the flagship train flags -> {step: loss} of its
    timeline (the last record of a step wins)."""
    import torch

    from hivedscheduler_tpu_torch import train as port_train

    torch.cuda.empty_cache()
    path = os.path.join(tmp, f"{name}.jsonl")
    rc = port_train.main(CKPT_ARGS + ["--timeline", path] + list(extra))
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
        a = _train_main(tmp, "A", "--steps", str(RESUME_STEPS))
        a2 = _train_main(tmp, "A2", "--steps", str(RESUME_STEPS))
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
        b = _train_main(tmp, "B", "--steps", str(RESUME_SPLIT), *common)
        _close_goodput()
        if exact:
            check(b == {s: a[s] for s in range(1, RESUME_SPLIT + 1)},
                  "run B's first steps differ from run A's")
        b1 = _train_main(tmp, "B1", "--steps", str(RESUME_STEPS), *common)
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
                              "--checkpoint-dir", ck, "--checkpoint-every", str(RESUME_SPLIT))
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


def _flagship_params() -> int:
    m = EVAL_MODEL
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
    cmd = [sys.executable, "-m", "hivedscheduler_tpu_torch.train"] + CKPT_ARGS + [
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
                       "--checkpoint-dir", ck, "--checkpoint-every", "100")
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


def phase_train_grads() -> None:
    import numpy as np
    import torch

    from hivedscheduler_tpu_torch.models import transformer as tm
    from hivedscheduler_tpu_torch.ops import attention as attn
    from hivedscheduler_tpu_torch.parallel import data as data_lib

    # the weights and first batch of train's run
    cfg_f = tm.TransformerConfig(max_seq_len=EVAL_SEQ, attn_impl="flash",
                                 remat="dots", **EVAL_MODEL)
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
    print(f"[h] one flagship step, loss flash {loss_f:.6f} xla {loss_x:.6f}; "
          f"gradients flash vs xla by group: "
          + ", ".join(f"{k} {v:.3e}" for k, v in groups.items())
          + f" (<= {TRAIN_GRAD_REL}); worst (leaf, layer) {worst:.3e} (<= {TRAIN_GRAD_SLICE_REL})")
    print(f"[h] planted fault (last layer's dq zeroed): "
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
DEC_ARGS = [a for k, v in EVAL_MODEL.items()
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
DEC_TIMED = 3  # timed runs of each generate, after one warm-up run
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
    cfg = tm.TransformerConfig(max_seq_len=DEC_PROMPT + DEC_NEW, **EVAL_MODEL)
    f32 = tm.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    params = tm.cast_params(f32, cfg.dtype)
    q_params = quant.quantize_params(f32, cfg)
    del f32
    prompt = torch.randint(0, cfg.vocab_size, (DEC_BATCH, DEC_PROMPT), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(1))
    weight_bytes = {"bf16": _tree_bytes(params), "int8": _tree_bytes(q_params)}
    check(weight_bytes["bf16"] == 2 * _flagship_params(), "bf16 weight bytes")
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


def phase_serving() -> None:
    """The continuous-batching engine at the flagship width: four runs of
    one trace (dense and paged, eager and graph) token-identical and held to
    the full forward at decisive positions, with planted faults; int8 KV;
    chunked prefill and the prefix cache; drain; the times; the CLI."""
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


# phase (l): the mesh path on one card. A tp=2 shard of the flagship holds
# half its heads: q [8, 2048, 8, 128], k/v [8, 2048, 4, 128]
TP_LOCAL = dict(b=8, t=2048, h=8, h_kv=4, d=128)
# mesh losses against the single-device ones when they are not equal: the
# loss limit of (i)'s resume, relative
MESH_LOSS_REL = 1e-3
MESH_CKPT_LAYERS = 2
# rounds of (single, mesh, mesh, single) steps timed in turns
MESH_TURNS = 3


def _tp_local_kernels() -> None:
    """K1-K3 at the tp-local shapes against their plain versions, with
    (b)'s and (f)'s limits and planted faults, then timed in turns with the
    library at the same shape."""
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
    for name, (kernel_ms, library_ms) in readings.items():
        flops, nbytes = work[name]
        ops_ms, bytes_ms = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
        bound_ms = max(ops_ms, bytes_ms)
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
    """A world-1 DTensor train state (flagship width, 2 layers; ``model``
    overrides the flagship's fields) through the multi-rank save and
    restore: bit-identical, with a planted fault."""
    import numpy as np
    import torch
    from torch.distributed.tensor import DTensor

    from hivedscheduler_tpu_torch.models import transformer as tm
    from hivedscheduler_tpu_torch.parallel import checkpoint as ckpt
    from hivedscheduler_tpu_torch.parallel import data as data_lib
    from hivedscheduler_tpu_torch.parallel import topology
    from hivedscheduler_tpu_torch.parallel import train as port_train

    model = dict(EVAL_MODEL, n_layers=MESH_CKPT_LAYERS, **(model or {}))
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
        print(f"{tag} sharded round trip ({MESH_CKPT_LAYERS} layers, {n_params / 1e6:.1f} M f32 "
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


def phase_mesh(h_flash: dict) -> None:
    """(l): the gang handoff, the tp-local kernels, world-1 mesh training
    and the sharded checkpoint, on one NCCL process group."""
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
        _tp_local_kernels()
        _mesh_train(mesh, h_flash)
        _mesh_checkpoint(mesh)
    print(f"[l] phase wall time {time.perf_counter() - t_phase:.1f} s")


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


def _f32_kernel_checks() -> dict:
    """K1-K3's f32 forms against their plain versions at the shapes the
    main path gives them (sp = 1: ring_flash's flagship causal hop,
    ring_zigzag_flash's causal and unmasked half-sequence hops) and at one
    sp = 4 ring hop's (diagonal and unmasked), against their bf16 forms (the
    f32 outputs rounded once to bf16 must equal them bit for bit: only the
    epilogue's store differs), for f32 precision (few outputs a bf16 holds
    exactly), run twice, and with (b)'s and (f)'s planted faults; returns
    the main path's max |err| of each."""
    import torch

    from hivedscheduler_tpu_torch.ops import attention as attn

    f, zz, hp = FLAGSHIP, ZIGZAG_HALF, RING_HOP
    cases = [
        ("main_path_causal", f["b"], f["t"], f["h"], f["h_kv"], f["d"], True),
        ("zigzag_half_causal", zz["b"], zz["t"], zz["h"], zz["h_kv"], zz["d"], True),
        ("zigzag_half_unmasked", zz["b"], zz["t"], zz["h"], zz["h_kv"], zz["d"], False),
        ("hop_diagonal", hp["b"], hp["t"], hp["h"], hp["h_kv"], hp["d"], True),
        ("hop_unmasked", hp["b"], hp["t"], hp["h"], hp["h_kv"], hp["d"], False),
    ]
    f32 = torch.float32

    def exact_bf16(x):
        return float((x == x.to(torch.bfloat16).float()).float().mean())
    max_err = {}
    for i, (name, b, t, h, h_kv, d, causal) in enumerate(cases):
        q, k, v = make_qkv(b, t, h, h_kv, d, seed=60 + i)
        do = make_qkv(b, t, h, h_kv, d, seed=70 + i)[0]
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
        print(f"[m] {name} q [{b},{t},{h},{d}] k/v [{b},{t},{h_kv},{d}] causal={causal}: "
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
        print(f"[m] {name} f32 forms run twice: bit-identical {twice}")
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
            print(f"[m] {name} planted faults: K1-f32 (V keys swapped) worst row "
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


def _f32_kernel_times() -> dict:
    """Each f32 form against its bf16 form in turns (bf16, f32, f32, bf16)
    at the main path's shape and at a hop's, beside the bound, the plain
    version and the library's bf16 call (the nearest: no library call
    returns f32); returns the main path's readings for the kernels line."""
    import torch
    import torch.nn.functional as F

    from hivedscheduler_tpu_torch.ops import attention as attn

    f, hp = FLAGSHIP, RING_HOP
    shapes = [("main_path_causal", f, True), ("hop_diagonal", hp, True),
              ("hop_unmasked", hp, False)]
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
            print(f"[m] {key}-f32 at {name} q [{b},{t},{h},{d}]: kernel_ms "
                  f"{', '.join(f'{x:.4f}' for x in r32)} (median {ms:.4f}) against the bf16 "
                  f"form {', '.join(f'{x:.4f}' for x in r16)} (median "
                  f"{sorted(r16)[len(r16) // 2]:.4f}), in turns; bound_ms {bound_ms:.4f} "
                  f"({bound_by}: {flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB) -> "
                  f"{bound_ms / ms:.1%} of the bound; plain_ms {plain[key]:.3f}; library_ms "
                  f"(bf16 {'forward' if key == 'fwd' else 'backward, dq, dk and dv'}) "
                  f"{library[key]:.4f}")
            if name == "main_path_causal":
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
MOE_TURNS = 3  # rounds of (dense, moe, moe, dense) timed steps
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
    serve at the flagship width, and a 2-layer MoE checkpoint."""
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
        timed("checkpoint", _mesh_checkpoint, mesh, dict(n_experts=8, moe_top_k=2), "[n]")
    print(f"[n] phase wall time {time.perf_counter() - t_phase:.1f} s ("
          + ", ".join(f"{name} {s:.1f} s" for name, s in walls.items()) + ")")


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
    phase_serving()
    phase_mesh(train_flash)
    ring = phase_ring(train_flash)
    phase_moe()

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
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
