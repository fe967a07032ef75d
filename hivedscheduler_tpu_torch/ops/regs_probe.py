"""How many registers ptxas gives the Dp 256 kernels' consumers, by block
shape and tile, and the Dp 96 K2's and K3's.

    python -m hivedscheduler_tpu_torch.ops.regs_probe [--kernel K1|K2|K3|K2-96|K3-96 ...]

K1 at Dp 256 (``flash_fwd_kernel_d256`` in ``csrc/flash_fwd.cu``) needs
~200 registers a consumer thread: o's 128 f32 accumulators beside s and p.
It ships as a block of 256 threads, its two consumer warpgroups alone. The
other wgmma kernels run 384 threads, a producer warpgroup that gives up
registers with ``setmaxnreg.dec`` and two consumer warpgroups that ask for
more with ``setmaxnreg.inc`` (``regs_dec`` / ``regs_inc`` in
``csrc/hopper.cuh``). This compiles ``csrc/flash_fwd.cu`` (copies of
``csrc/`` under ``hivedscheduler_tpu_torch/_build/regs_probe/``) as it
ships and with the Dp 256 kernel's block changed (:data:`VARIANTS`):

- 288 threads: one idle warp more, no ``setmaxnreg``;
- 384 threads, setmaxnreg 168 or 240 after the block's barrier and the
  early return of a consumer whose rows are all past T (a third warpgroup
  gives up its registers and leaves; the consumers still load the tiles);
- 384 threads, setmaxnreg 240 in FlashAttention-3's order: the warpgroup
  index made warp-uniform with ``__shfl_sync``, the third warpgroup alone
  loading every tile and the consumers asking for registers before
  anything else they do.

K2 and K3 at Dp 256 (``flash_bwd_dq_kernel_d256`` and
``flash_bwd_dkv_kernel_d256`` in ``csrc/flash_bwd.cu``) run the same block
of two consumer warpgroups alone, each consumer holding a whole-width f32
accumulator (128 registers a thread: K2's dq, K3's dv or dk) beside its
score tiles. ``--kernel K2`` compiles ``csrc/flash_bwd.cu`` and
``csrc/flash_bwd_f16.cu`` in K2's forms (:data:`DQ_VARIANTS`): (b)
64-key K/V tiles, K in two stages and V in one (as built: 192 accumulators
a consumer), and (a) 32-key tiles (160 accumulators) in two stages or three;
``--kernel K3`` the same two files as built
(:data:`DKV_VARIANTS`: 64-key blocks streaming 64-row q/do tiles, 160
accumulators a consumer).

K2 and K3 at Dp 96 (``flash_bwd_dq_kernel<96>`` and
``flash_bwd_dkv_kernel<96>``, the instances of the Dp 64/128 templates on
tiles of three 32-column panels) keep the producer warpgroup; each
consumer's dq, dv or dk is 48 f32 registers a thread, not 64.
``--kernel K2-96`` and ``--kernel K3-96`` compile them as built.

The variants are for ptxas's allocation only: they are not launched. It
prints nvcc's version and what ``-Xptxas -v`` reports for each instance of
the chosen kernels (all three by default; bf16 and fp16 inputs where both
files are compiled, causal or not, 16-bit or f32 outputs): the registers,
the spill stores and loads, and whether ptxas serialized its wgmma for want
of registers (its C7512 note). A consumer that holds more than the block's
launch count (65536 / 384 -> 168) without spilling means ptxas allocates its
code at the count setmaxnreg asks. It needs ``nvcc``, not a card.
"""

from __future__ import annotations

import argparse
import os
import re
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

from hivedscheduler_tpu_torch.ops import _build

FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-cubin",
         "-Xptxas", "-v")
KERNEL = "flash_fwd_kernel_d256"
THREADS = "constexpr int kD256Threads = 256;"
LEAVE = "  const int c = threadIdx.x / 128;\n  if (c >= n_cons) return;  // every row of this consumer is past T\n"
FIRST_LOADS = """    mbar_expect_tx(q_full, n_cons * L::kTile);
    for (int half = 0; half < n_cons; ++half) {
      tma_load_tile<D, 64>(sQ + half * 64 * D, &a.tq, q_full, h, q0 + 64 * half, b);
    }
    for (int j = 0; j < min(kStages, n_kv); ++j) load_kv(j);
"""
TICKET_LOAD = "      load_kv(j + kStages);\n"


def _threads(n: int) -> tuple:
    return (THREADS, f"constexpr int kD256Threads = {n};")


def _late(regs: int) -> tuple:
    """384 threads, setmaxnreg ``regs`` where the consumers' code starts."""
    return (_threads(384),
            (LEAVE, "  const int c = threadIdx.x / 128;\n"
                    "  if (c == 2) {\n    regs_dec<kProducerRegs>();\n    return;\n  }\n"
                    f"  if (c >= n_cons) return;\n  regs_inc<{regs}>();\n"))


# FlashAttention-3's order: a warp-uniform warpgroup index, the third
# warpgroup alone loading q and every K/V tile (no stage waits: the variant
# is compiled, never run), and setmaxnreg the consumers' first instruction
FA3_ORDER = (
    _threads(384),
    (FIRST_LOADS, ""),
    (TICKET_LOAD, "      tickets[stage] = 0;\n"),
    (LEAVE, "  const int c = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);\n"
            "  if (c == 2) {\n    regs_dec<kProducerRegs>();\n"
            "    if (threadIdx.x == 256) {\n" + FIRST_LOADS.replace("min(kStages, n_kv)", "n_kv")
            + "    }\n    return;\n  }\n"
            "  regs_inc<kConsumerRegs>();\n  if (c >= n_cons) return;\n"),
)

VARIANTS = {
    "256 threads (as built)": (),
    "288 threads": (_threads(288),),
    "384 threads, setmaxnreg 168": _late(168),
    "384 threads, setmaxnreg 240": _late(240),
    "384 threads, setmaxnreg 240 in FA3's order": FA3_ORDER,
}

# K2 at Dp 256: its tile forms
DQ_KEYS_32 = ("constexpr int kDq256Keys = 64;", "constexpr int kDq256Keys = 32;")
DQ_VARIANTS = {
    "(b) 64-key tiles, K in 2 stages, V in 1 (as built)": (),
    "(a) 32-key tiles, 2 stages": (DQ_KEYS_32,),
    "(a) 32-key tiles, 3 stages": (DQ_KEYS_32, ("  static constexpr int kKStages = 2;\n",
                                                "  static constexpr int kKStages = 3;\n")),
}
DKV_VARIANTS = {"64-row q/do tiles, 2 stages (as built)": ()}

# K2 and K3 at Dp 96
DQ96_VARIANTS = {"64-key K/V tiles, 2 stages (as built)": ()}
DKV96_VARIANTS = {"64-row q/do tiles, 3 stages (as built)": ()}

# kernel: (the edited source, the files compiled, the kernel's name, variants)
PROBES = {
    "K1": ("flash_fwd.cu", ("flash_fwd.cu",), KERNEL, VARIANTS),
    "K2": ("flash_bwd.cu", ("flash_bwd.cu", "flash_bwd_f16.cu"), "flash_bwd_dq_kernel_d256",
           DQ_VARIANTS),
    "K3": ("flash_bwd.cu", ("flash_bwd.cu", "flash_bwd_f16.cu"), "flash_bwd_dkv_kernel_d256",
           DKV_VARIANTS),
    "K2-96": ("flash_bwd.cu", ("flash_bwd.cu", "flash_bwd_f16.cu"), "flash_bwd_dq_kernel",
              DQ96_VARIANTS),
    "K3-96": ("flash_bwd.cu", ("flash_bwd.cu", "flash_bwd_f16.cu"), "flash_bwd_dkv_kernel",
              DKV96_VARIANTS),
}
# the instances of a probe's template that it reports (in the mangled name)
INSTANCES = {"K2-96": "ILi96E", "K3-96": "ILi96E"}


def apply(text: str, changes: tuple, source: str) -> str:
    """``text`` with each (old, new) of ``changes`` made; each old must be
    there once."""
    for old, new in changes:
        if text.count(old) != 1:
            raise RuntimeError(f"csrc/{source} no longer holds {old!r} once")
        text = text.replace(old, new)
    return text


def compile_variant(label: str, changes: tuple, source: str = "flash_fwd.cu",
                    files: tuple = ("flash_fwd.cu",)) -> str:
    """ptxas's report of ``csrc/`` ``files`` with ``changes`` made to
    ``csrc/<source>``."""
    root = os.path.join(_build.BUILD_DIR, "regs_probe", re.sub(r"\W+", "_", label))
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(_build.CSRC, root)
    path = os.path.join(root, source)
    with open(path) as f:
        text = apply(f.read(), changes, source)
    with open(path, "w") as f:
        f.write(text)
    logs = []
    for name in files:
        src = os.path.join(root, name)
        proc = subprocess.run([_build._nvcc(), *FLAGS, "-o", src + ".cubin", src],
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({label}, {name}):\n{proc.stdout}{proc.stderr}")
        logs.append(proc.stdout + proc.stderr)
    return "\n".join(logs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", action="append", choices=sorted(PROBES),
                    help="the kernel to probe (repeatable; default all)")
    args = ap.parse_args(argv)
    version = subprocess.run([_build._nvcc(), "--version"], capture_output=True, text=True)
    print(version.stdout.strip().splitlines()[-2])
    jobs = [(f"{key} {label}", changes, source, files, kernel + INSTANCES.get(key, ""))
            for key in (args.kernel or sorted(PROBES))
            for source, files, kernel, variants in [PROBES[key]]
            for label, changes in variants.items()]
    with ThreadPoolExecutor(len(jobs)) as pool:
        logs = list(pool.map(lambda j: compile_variant(*j[:4]), jobs))
    for (label, _, _, _, kernel), log in zip(jobs, logs):
        for line in log.splitlines():
            if "setmaxnreg" in line:
                print(f"{label}: {line.strip()}")
        for name, (used, stores, loads, serial) in sorted(_build.ptxas_report(log).items()):
            if kernel in name:
                print(f"{label}: {name}: {used} registers, {stores} bytes spill stores, "
                      f"{loads} bytes spill loads" + (", wgmma serialized (C7512)"
                                                      if serial else ""))
    return 0


if __name__ == "__main__":
    sys.exit(main())
