"""Time this tree's flash kernels against another checkout's, in turns, in
one process on one CUDA card.

    python -m hivedscheduler_tpu_torch.ops.kernel_ab --other DIR [--kernels fwd,dq,dkv]
        [--d D] [--heads H] [--kv-heads H_KV] [--batch B] [--dtype bf16|fp16|f32] [--f32-out]
        [--sdpa]
    python -m hivedscheduler_tpu_torch.ops.kernel_ab --other DIR --sass

``DIR`` is the root of another copy of the repository, for example the
parent commit unpacked with ``git archive``. Its
``hivedscheduler_tpu_torch/ops/csrc/*.cu`` are built with this tree's nvcc
flags into ``DIR/hivedscheduler_tpu_torch/_build/`` and called through the
same C entry points (``attention._KERNELS``, the one
``attention.kernel_entry`` picks for the dtype and head dim) on the same
inputs, by default at the flagship shape (B=8, T=2048, H=16, H_kv=8,
D=128, bf16, causal); ``--d``, ``--heads``, ``--kv-heads`` and
``--batch`` change the head dim (any multiple of 8: past 256 K1-K3 run on
the cluster kernels, past 1024 on the CUDA-core family), the head counts
and the batch (Gemma-2B's shape: ``--d 256 --heads 8 --kv-heads 1``; one sp
= 4 ring hop of its heads adds ``--batch 1``), ``--dtype`` the inputs'
dtype (fp16: the wgmma kernels' fp16 forms; f32: K1-K3 in 3xTF32 up to D
128, past it on clusters up to D 1024), and ``--f32-out`` times the
f32-output forms (the ring's per-hop calls). Where the other tree lacks the
entry point this tree picks, it runs the one it routes the same call to: a tree
without ``csrc/flash_fwd_wide.cu`` or ``csrc/flash_bwd_wide.cu`` ran K1,
or K2 and K3, past D 256 on the CUDA-core family, so ``--d 512 --heads 4
--kv-heads 2`` times those against the cluster kernels; a tree without
``csrc/flash_fwd_tf32.cu`` or ``csrc/flash_bwd_tf32.cu`` ran f32 K1, or K2
and K3, there too, so ``--dtype f32 --kernels fwd`` (or ``dq,dkv``) times
them against the 3xTF32 kernels, and a tree without
``csrc/flash_bwd_tf32_wide.cu`` ran f32 K2 and K3 past D 128 there, so
``--dtype f32 --d 256 --heads 8 --kv-heads 1 --kernels dq,dkv`` times those
against the 3xTF32 cluster kernels, and a tree without
``csrc/flash_fwd_tf32_wide.cu`` ran f32 K1 past D 128 there, so ``--kernels
fwd`` at that shape times it against the 3xTF32 cluster K1. Both trees' K2
and K3 read the o and lse of this tree's K1. Each
kernel is timed with CUDA events in the order other, this, this, other, so
a drift of the card's clock falls on both alike. It prints each reading,
the ratio of the means, and the largest difference between the two trees'
outputs. With ``--sdpa`` it also times the pair, K2 then K3, of each
tree against ``scaled_dot_product_attention``'s backward (causal, the
backend PyTorch picks, named) on the same inputs, in the order other, this,
SDPA, SDPA, this, other: a yardstick only. With ``--sass`` it times nothing and compares the two trees'
machine code instead: each library both trees build, function by function
(``cuobjdump -sass``, each source's anonymous-namespace hash masked), and
prints which functions differ. Without a card it exits non-zero.
:func:`inputs` and :func:`runner` time one tree's kernels at two shapes the
same way
(``chip_smoke.py`` [q]: D = 96 against D = 128; [r]: D = 256 against the
flagship's D = 128).
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys

import torch

from hivedscheduler_tpu_torch.ops import _build
from hivedscheduler_tpu_torch.ops import attention as attn

FLAGSHIP = dict(b=8, t=2048, h=16, h_kv=8, d=128)
KERNELS = ("fwd", "dq", "dkv")
DTYPES = {"bf16": torch.bfloat16, "fp16": torch.float16, "f32": torch.float32}


def libraries():
    """Names of the libraries the C entry points live in."""
    return sorted({lib for lib, *_ in attn._KERNELS.values()})


def build_other(root: str) -> dict:
    """{library name: CDLL} of the other tree's sources (those of
    :func:`libraries` it has), all compilers at once; a library newer than
    every file of the other tree's ``csrc/`` is kept from an earlier run."""
    csrc = os.path.join(root, "hivedscheduler_tpu_torch", "ops", "csrc")
    out = os.path.join(root, "hivedscheduler_tpu_torch", "_build")
    os.makedirs(out, exist_ok=True)
    newest = max(os.path.getmtime(os.path.join(csrc, f)) for f in os.listdir(csrc))
    have = [n for n in libraries() if os.path.exists(os.path.join(csrc, f"{n}.cu"))]
    procs = {n: subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-o", os.path.join(out, f"lib{n}_ab.so"),
         os.path.join(csrc, f"{n}.cu")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
        for n in have if not (os.path.exists(os.path.join(out, f"lib{n}_ab.so")) and
                              os.path.getmtime(os.path.join(out, f"lib{n}_ab.so")) > newest)}
    for n, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the other tree's {n}.cu:\n{log}")
    return {n: ctypes.CDLL(os.path.join(out, f"lib{n}_ab.so")) for n in have}


# the anonymous namespace of a source in a mangled name: a hash of the file
# that changes with any edit, code or not
_ANON = re.compile(r"_GLOBAL__N__[0-9a-f]{8}_(\d+_\w+?_cu)_[0-9a-f]{8}")


def sass_functions(text: str) -> dict:
    """{mangled name, anonymous-namespace hash masked: its SASS} of
    ``cuobjdump -sass`` output ``text``."""
    out, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = _ANON.sub(r"_GLOBAL__N__\1", m.group(1))
            out[name] = []
        elif name:
            out[name].append(line.strip())
    return {n: "\n".join(body) for n, body in out.items()}


def sass_diff(paths: dict) -> dict:
    """{library: (functions in both trees, names whose SASS differs or is
    in one tree only)} for ``paths`` = {library: (other's .so, this .so)}."""
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    result = {}
    for lib, pair in sorted(paths.items()):
        other, this = (sass_functions(subprocess.run(
            [tool, "-sass", p], capture_output=True, text=True, check=True,
            timeout=300).stdout) for p in pair)
        differ = sorted(n for n in set(other) | set(this) if other.get(n) != this.get(n))
        result[lib] = (len(set(other) & set(this)), differ)
    return result


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


def inputs(b: int, t: int, h: int, h_kv: int, d: int, seed: int = 0,
           dtype=torch.bfloat16) -> dict:
    """q, k, v, do of ``dtype`` from ``seed`` and the forward's o, lse and
    K2's delta at [B, T, H(_kv), D], causal, with the launch dims."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    x = dict(q=randn(b, t, h, d), do=randn(b, t, h, d), k=randn(b, t, h_kv, d),
             v=randn(b, t, h_kv, d), dims=(b, t, h, h_kv, d, 1))
    x["o"], x["lse"] = attn.flash_forward(x["q"], x["k"], x["v"], causal=True)
    _, x["delta"] = attn.flash_backward_dq_cuda(x["q"], x["k"], x["v"], x["o"], x["lse"],
                                                x["do"])
    return x


def entry_in(libs, symbol: str) -> str:
    """``symbol``, or where ``libs`` (another tree's libraries) lack its
    library, the entry point that tree routed the call to: a cluster or
    3xTF32 kernel's CUDA-core counterpart, which takes the same arguments."""
    if libs is None or attn._KERNELS[symbol][0] in libs:
        return symbol
    generic = symbol
    for family in ("hived_flash_tf32_wide", "hived_flash_wide", "hived_flash_tf32"):
        generic = generic.replace(family, "hived_flash_generic")
    if generic == symbol or attn._KERNELS[generic][0] not in libs:
        raise RuntimeError(f"the other tree has no {symbol}")
    return generic


def runner(libs, x: dict, res: dict, kernel: str, out_f32: bool = False, symbol: str = None):
    """A launch of ``kernel`` ("fwd", "dq" or "dkv") from ``libs`` (None:
    this tree's) on ``inputs``' tensors, through ``symbol`` (default: the
    entry point ``attention.kernel_entry`` picks for their dtype and head
    dim, or the one ``libs``' tree routed it to: :func:`entry_in`), outputs
    in the inputs' dtype, or in f32 with ``out_f32``, kept in ``res``; it
    goes through ``attention._launch`` and counts no launch."""
    q, k, v, o, do, lse, delta = (x[n] for n in ("q", "k", "v", "o", "do", "lse", "delta"))
    symbol = symbol or entry_in(libs, attn.kernel_entry(q.dtype, q.shape[3], out_f32, kernel))
    dims = attn.launch_dims(symbol, x["dims"], q.dtype, out_f32)
    out = torch.float32 if out_f32 else q.dtype
    if kernel == "fwd":
        res["o"], res["lse"] = torch.empty_like(q, dtype=out), torch.empty_like(lse)
        launch = ((q, k, v, res["o"], res["lse"]), (q, k, v, res["o"]))
    elif kernel == "dq":
        res["dq"], res["delta"] = torch.empty_like(q, dtype=out), torch.empty_like(lse)
        launch = ((q, k, v, o, do, lse, res["delta"], res["dq"]), (q, k, v, o, do, res["dq"]))
    else:
        res["dk"], res["dv"] = torch.empty_like(k, dtype=out), torch.empty_like(v, dtype=out)
        launch = ((q, k, v, do, lse, delta, res["dk"], res["dv"]),
                  (q, k, v, do, res["dk"], res["dv"]))
    stream = torch.cuda.current_stream().cuda_stream
    return lambda: attn._launch(symbol, launch[0], dims, launch[1], stream, libs)


def sdpa_backward(x: dict):
    """(a call of ``scaled_dot_product_attention``'s backward on ``inputs``'
    q, k, v and do, causal, the backend's name)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend

    gqa = x["k"].shape[2] != x["q"].shape[2]
    q, k, v = (x[n].transpose(1, 2).contiguous().requires_grad_(True) for n in ("q", "k", "v"))
    choice = int(torch._fused_sdp_choice(q, k, v, None, 0.0, True, enable_gqa=gqa))
    backend = {int(b.value): n for n, b in SDPBackend.__members__.items()}.get(choice, str(choice))
    out = F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=gqa)
    dout = x["do"].transpose(1, 2).contiguous()
    return lambda: torch.autograd.grad(out, (q, k, v), dout, retain_graph=True), backend


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True, help="root of the other checkout")
    ap.add_argument("--kernels", default=",".join(KERNELS))
    ap.add_argument("--d", type=int, default=FLAGSHIP["d"], help="head dim")
    ap.add_argument("--heads", type=int, default=FLAGSHIP["h"])
    ap.add_argument("--kv-heads", type=int, default=FLAGSHIP["h_kv"])
    ap.add_argument("--batch", type=int, default=FLAGSHIP["b"])
    ap.add_argument("--dtype", choices=sorted(DTYPES), default="bf16",
                    help="the inputs' dtype")
    ap.add_argument("--f32-out", action="store_true", help="the f32-output forms")
    ap.add_argument("--sdpa", action="store_true",
                    help="also time K2 + K3 against scaled_dot_product_attention's backward")
    ap.add_argument("--sass", action="store_true",
                    help="compare the two trees' machine code instead of timing")
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
    if args.sass:
        out = os.path.join(args.other, "hivedscheduler_tpu_torch", "_build")
        paths = {n: (os.path.join(out, f"lib{n}_ab.so"), _build.library_path(n))
                 for n in trees["other"]}
        for lib, (same, differ) in sass_diff(paths).items():
            print(f"SASS {lib}: {same} functions in both trees; differ: "
                  + (", ".join(differ) if differ else "none"))
        return 0

    f = FLAGSHIP
    x = inputs(args.batch, f["t"], args.heads, args.kv_heads, args.d, dtype=DTYPES[args.dtype])
    for kernel in args.kernels.split(","):
        outs = {tree: {} for tree in trees}
        fns = {tree: runner(trees[tree], x, outs[tree], kernel, args.f32_out) for tree in trees}
        readings = {tree: [] for tree in trees}
        for tree in ("other", "this", "this", "other"):
            readings[tree].append(time_ms(fns[tree]))
        mean = {tree: sum(r) / len(r) for tree, r in readings.items()}
        diff = max(float((outs["this"][key].float() - outs["other"][key].float()).abs().max())
                   for key in outs["this"])
        symbols = {tree: entry_in(trees[tree] if tree == "other" else None,
                                  attn.kernel_entry(DTYPES[args.dtype], args.d, args.f32_out,
                                                    kernel))
                   for tree in trees}
        print(f"{kernel} at B={args.batch}, D={args.d}, H={args.heads}, H_kv={args.kv_heads}, "
              f"{args.dtype}{' (f32 out)' if args.f32_out else ''} "
              f"(other {symbols['other']}, this {symbols['this']}): other "
              f"{readings['other']} ms, this {readings['this']} ms; "
              f"other/this {mean['other'] / mean['this']:.3f}; max |this - other| "
              f"over its outputs {diff:.3e} ({card})")
    if args.sdpa:
        calls = {tree: [runner(trees[tree], x, {}, kernel, args.f32_out)
                        for kernel in ("dq", "dkv")] for tree in trees}
        fns = {tree: (lambda c=c: [f() for f in c]) for tree, c in calls.items()}
        fns["sdpa"], backend = sdpa_backward(x)
        readings = {name: [] for name in fns}
        for name in ("other", "this", "sdpa", "sdpa", "this", "other"):
            readings[name].append(time_ms(fns[name]))
        mean = {name: sum(r) / len(r) for name, r in readings.items()}
        print(f"K2 + K3 at B={args.batch}, D={args.d}, H={args.heads}, H_kv={args.kv_heads}, "
              f"{args.dtype}: other {readings['other']} ms, this {readings['this']} ms, SDPA's "
              f"backward ({backend}) {readings['sdpa']} ms; this/SDPA "
              f"{mean['this'] / mean['sdpa']:.3f}, other/SDPA {mean['other'] / mean['sdpa']:.3f} "
              f"({card})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
