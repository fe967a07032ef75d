"""How fast a thread-block cluster exchanges data through distributed shared
memory on the card: the rate and the per-round latency behind the cluster
kernels (``csrc/flash_fwd_wide.cu``, ``csrc/flash_bwd_wide.cu``), for four
ways to send
(``ops/dsmem_rate.cu`` says which).

    python -m hivedscheduler_tpu_torch.ops.dsmem_rate [--clusters N]

Builds ``ops/dsmem_rate.cu`` with the kernels' nvcc flags into
``hivedscheduler_tpu_torch/_build/``, runs clusters of 2, 4 and 8 blocks
(as many clusters as the card holds at 4, by default) at several message
sizes, and prints each one's cycles a round and the bytes a cycle each SM
sends, beside the card's name and power limit. Without a card it exits
non-zero.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

import torch

from hivedscheduler_tpu_torch.ops import _build

MODES = ("st.async", "remote stores + fence", "bulk copy", "remote loads")
ROUNDS = 200


def build() -> ctypes.CDLL:
    src = os.path.join(os.path.dirname(_build.CSRC), "dsmem_rate.cu")
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    out = os.path.join(_build.BUILD_DIR, "libdsmem_rate.so")
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", out, src],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on dsmem_rate.cu:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(out)
    lib.hived_dsmem_rate.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2
    lib.hived_dsmem_rate.restype = ctypes.c_int
    return lib


def run(lib, mode: int, p: int, clusters: int, per: int) -> float:
    """Median cycles a round over every warpgroup of the run."""
    cycles = torch.zeros(clusters * p * 2, dtype=torch.int64, device="cuda")
    sink = torch.zeros(1, device="cuda")
    err = lib.hived_dsmem_rate(mode, p, clusters, per, ROUNDS, cycles.data_ptr(),
                               sink.data_ptr())
    if err != 0:
        raise RuntimeError(f"dsmem_rate mode {mode} P {p} per {per}: CUDA error {err}")
    return float(cycles.float().median()) / ROUNDS


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--clusters", type=int, default=30,
                    help="clusters of 4 at once (half as many of 8, twice as many of 2)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("dsmem_rate: no CUDA device is available", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    lib = build()
    for p, pers in ((2, (1, 2, 4, 6)), (4, (1, 2, 4, 6)), (8, (1, 2, 3))):
        clusters = args.clusters * 4 // p
        for per in pers:
            for mode, name in enumerate(MODES):
                cyc = run(lib, mode, p, clusters, per)
                sent = 2 * (p - 1) * per * 128 * 16  # both warpgroups, a round
                print(f"P={p} clusters={clusters} {per * 16} B a thread to each other block: "
                      f"{name}: {cyc:.0f} cycles a round, {sent / cyc:.2f} bytes a cycle out "
                      f"of each SM ({card})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
