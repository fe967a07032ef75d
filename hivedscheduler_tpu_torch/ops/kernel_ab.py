"""Time this tree's flash kernels against another checkout's, in turns, in
one process on one CUDA card.

    python -m hivedscheduler_tpu_torch.ops.kernel_ab --other DIR [--kernels fwd,dq,dkv]
        [--d D] [--heads H] [--kv-heads H_KV]

``DIR`` is the root of another copy of the repository, for example the
parent commit unpacked with ``git archive``. Its
``hivedscheduler_tpu_torch/ops/csrc/*.cu`` are built with this tree's nvcc
flags into ``DIR/hivedscheduler_tpu_torch/_build/`` and called through the
same C entry points (``attention._KERNELS``) on the same inputs, by
default at the flagship shape (B=8, T=2048, H=16, H_kv=8, D=128, bf16,
causal); ``--d``, ``--heads`` and ``--kv-heads`` change the head dim (any
multiple of 8 up to 256) and the head counts (Gemma-2B's shape: ``--d 256
--heads 8 --kv-heads 1``). Each
kernel is timed with CUDA events in the order other, this, this, other, so
a drift of the card's clock falls on both alike. It prints each reading,
the ratio of the means, and the largest difference between the two trees'
outputs. Without a card it exits non-zero. :func:`inputs` and
:func:`runner` time one tree's kernels at two shapes the same way
(``chip_smoke.py`` [q]: D = 96 against D = 128; [r]: D = 256 against the
flagship's D = 128).
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

import torch

from hivedscheduler_tpu_torch.ops import _build
from hivedscheduler_tpu_torch.ops import attention as attn

FLAGSHIP = dict(b=8, t=2048, h=16, h_kv=8, d=128)
KERNELS = ("fwd", "dq", "dkv")


def libraries():
    """Names of the libraries the C entry points live in."""
    return sorted({lib for lib, *_ in attn._KERNELS.values()})


def build_other(root: str) -> dict:
    """{library name: CDLL} of the other tree's sources, all compilers at
    once."""
    csrc = os.path.join(root, "hivedscheduler_tpu_torch", "ops", "csrc")
    out = os.path.join(root, "hivedscheduler_tpu_torch", "_build")
    os.makedirs(out, exist_ok=True)
    procs = {n: subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-o", os.path.join(out, f"lib{n}_ab.so"),
         os.path.join(csrc, f"{n}.cu")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for n in libraries()}
    for n, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the other tree's {n}.cu:\n{log}")
    return {n: ctypes.CDLL(os.path.join(out, f"lib{n}_ab.so")) for n in procs}


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean ms of ``fn`` over ``iters`` launches, by CUDA events."""
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


def inputs(b: int, t: int, h: int, h_kv: int, d: int, seed: int = 0) -> dict:
    """bf16 q, k, v, do from ``seed`` and the forward's o, lse and K2's
    delta at [B, T, H(_kv), D], causal, with the launch dims."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)

    x = dict(q=randn(b, t, h, d), do=randn(b, t, h, d), k=randn(b, t, h_kv, d),
             v=randn(b, t, h_kv, d), dims=(b, t, h, h_kv, d, 1))
    x["o"], x["lse"] = attn.flash_forward(x["q"], x["k"], x["v"], causal=True)
    _, x["delta"] = attn.flash_backward_dq_cuda(x["q"], x["k"], x["v"], x["o"], x["lse"],
                                                x["do"])
    return x


def runner(libs, x: dict, res: dict, kernel: str):
    """A launch of ``kernel`` ("fwd", "dq" or "dkv") from ``libs`` (None:
    this tree's) on ``inputs``' tensors, its outputs kept in ``res``; it
    goes through ``attention._launch`` and counts no launch."""
    q, k, v, o, do, lse, delta = (x[n] for n in ("q", "k", "v", "o", "do", "lse", "delta"))
    if kernel == "fwd":
        res["o"], res["lse"] = torch.empty_like(q), torch.empty_like(lse)
        launch = ("hived_flash_fwd", (q, k, v, res["o"], res["lse"]), x["dims"],
                  (q, k, v, res["o"]))
    elif kernel == "dq":
        res["dq"], res["delta"] = torch.empty_like(q), torch.empty_like(lse)
        launch = ("hived_flash_bwd_dq", (q, k, v, o, do, lse, res["delta"], res["dq"]),
                  x["dims"], (q, k, v, o, do, res["dq"]))
    else:
        res["dk"], res["dv"] = torch.empty_like(k), torch.empty_like(v)
        launch = ("hived_flash_bwd_dkv", (q, k, v, do, lse, delta, res["dk"], res["dv"]),
                  x["dims"], (q, k, v, do, res["dk"], res["dv"]))
    stream = torch.cuda.current_stream().cuda_stream
    return lambda: attn._launch(*launch, stream, libs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True, help="root of the other checkout")
    ap.add_argument("--kernels", default=",".join(KERNELS))
    ap.add_argument("--d", type=int, default=FLAGSHIP["d"], help="head dim")
    ap.add_argument("--heads", type=int, default=FLAGSHIP["h"])
    ap.add_argument("--kv-heads", type=int, default=FLAGSHIP["h_kv"])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device is available", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    trees = {"other": build_other(args.other),
             "this": {n: _build.load(n) for n in libraries()}}

    f = FLAGSHIP
    x = inputs(f["b"], f["t"], args.heads, args.kv_heads, args.d)
    for kernel in args.kernels.split(","):
        outs = {tree: {} for tree in trees}
        fns = {tree: runner(trees[tree], x, outs[tree], kernel) for tree in trees}
        readings = {tree: [] for tree in trees}
        for tree in ("other", "this", "this", "other"):
            readings[tree].append(time_ms(fns[tree]))
        mean = {tree: sum(r) / len(r) for tree, r in readings.items()}
        diff = max(float((outs["this"][key].float() - outs["other"][key].float()).abs().max())
                   for key in outs["this"])
        print(f"{kernel} at D={args.d}, H={args.heads}, H_kv={args.kv_heads}: other "
              f"{readings['other']} ms, this {readings['this']} ms; "
              f"other/this {mean['other'] / mean['this']:.3f}; max |this - other| "
              f"over its outputs {diff:.3e} ({card})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
