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
    step by kernel group (torch.profiler).

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


def run_eval(attn_impl: str, windows: int):
    """``eval.main`` -> (loss, window ms, tokens/s) as it reports them."""
    from hivedscheduler_tpu_torch import eval as port_eval

    timing = _LogArgs(port_eval.WINDOWS_LOG)
    logger = logging.getLogger(port_eval.__name__)
    logger.addHandler(timing)
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            rc = port_eval.main(EVAL_ARGS + ["--attn", attn_impl,
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


def run_train(attn_impl: str, steps: int):
    """``train.main`` -> (its timeline records, checked; the peak device
    memory of the run in bytes)."""
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
            rc = port_train.main(TRAIN_ARGS + ["--attn", attn_impl, "--steps",
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
    for impl in ("flash", "xla"):
        if impl == "xla":
            records, peak = run_train("xla", TRAIN_STEPS)
        timed = [r for r in records if not r["compile"]]
        step_ms = sum(r["wall_s"] for r in timed) / len(timed) * 1e3
        tokens_per_s = EVAL_BATCH * EVAL_SEQ / (step_ms / 1e3)
        print(f"[h] train step --attn {impl} (B={EVAL_BATCH}, T={EVAL_SEQ}, "
              f"{layers} layers, remat dots, ce_chunk {EVAL_CE_CHUNK}, mean of "
              f"{len(timed)} steps after the warm-up): {step_ms} ms, "
              f"{tokens_per_s} tokens/s, peak device memory {peak / 1e9:.2f} GB")
    return launches


# kernel-name fragments of each part of a train step's device time
PROFILE_GROUPS = (
    ("K1 flash_fwd", ("flash_fwd_kernel",)),
    ("K2 flash_bwd_dq", ("flash_bwd_dq_kernel",)),
    ("K3 flash_bwd_dkv", ("flash_bwd_dkv_kernel",)),
    ("matmuls", ("gemm", "xmma", "cutlass", "nvjet", "cublas")),
)
OTHER_GROUP = "other (elementwise, norms, CE, optimizer)"


def profile_group(kernel_name: str) -> str:
    """The part of the step a device kernel's time is counted in."""
    key = kernel_name.lower()
    return next((name for name, frags in PROFILE_GROUPS
                 if any(f.lower() in key for f in frags)), OTHER_GROUP)


def phase_train_profile() -> None:
    """Device time of one flagship flash train step by kernel group, from
    torch.profiler, beside the step's wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

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
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        float(step(params, opt, batches[1])[2])
        wall_ms = (time.perf_counter() - t0) * 1e3
    parts = {name: 0.0 for name, _ in PROFILE_GROUPS}
    parts[OTHER_GROUP] = 0.0
    total = 0.0
    for event in prof.key_averages():
        # device-side events only (kernels, copies): a host op's self device
        # time is its kernels' again
        if event.device_type != DeviceType.CUDA:
            continue
        us = event.self_device_time_total
        total += us
        parts[profile_group(event.key)] += us
    if total == 0:
        print("[h] profiler: no device time recorded (not measured)")
    else:
        print(f"[h] profile of one flash train step: wall {wall_ms:.1f} ms, device "
              f"busy {total / 1e3:.1f} ms ({1 - total / 1e3 / wall_ms:.1%} idle); "
              + ", ".join(f"{k} {v / 1e3:.1f} ms ({v / total:.1%})"
                          for k, v in parts.items()))
    del params, opt, batches
    torch.cuda.empty_cache()


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
    launches = phase_train()
    phase_train_grads()
    phase_train_profile()

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
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
