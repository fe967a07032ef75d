"""The port's kernel build (hivedscheduler_tpu_torch.ops._build) and the
refusals of chip_smoke.py, on a machine without nvcc or a CUDA card."""

import os
import re
import shutil
import subprocess
import sys

import pytest
import torch

from hivedscheduler_tpu_torch.ops import _build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def scratch_build(tmp_path, monkeypatch):
    """Build into a temporary directory, never into the package's."""
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "BUILD_LOGS", {})
    return tmp_path


def test_library_name_carries_a_source_hash():
    p = _build.library_path("flash_fwd")
    assert os.path.dirname(p) == _build.BUILD_DIR
    assert os.path.basename(p).startswith("libflash_fwd_")
    assert p == _build.library_path("flash_fwd")


def test_build_dir_is_ignored_by_git():
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert "hivedscheduler_tpu_torch/_build/" in f.read().split()


def test_missing_nvcc_raises(scratch_build, monkeypatch):
    monkeypatch.setattr(shutil, "which", lambda name: None)
    from torch.utils import cpp_extension

    monkeypatch.setattr(cpp_extension, "CUDA_HOME", None)
    with pytest.raises(RuntimeError) as err:
        _build.build("flash_fwd")
    assert "nvcc not found" in str(err.value)


def test_failed_build_raises_with_compiler_output(scratch_build, monkeypatch):
    fake = scratch_build / "nvcc"
    fake.write_text("#!/bin/sh\necho 'flash_fwd.cu(1): error: bad token' >&2\nexit 3\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
    with pytest.raises(RuntimeError) as err:
        _build.build("flash_fwd")
    assert "bad token" in str(err.value) and "exit 3" in str(err.value)
    assert not os.path.exists(_build.library_path("flash_fwd"))


def test_build_runs_one_compiler_per_missing_source(scratch_build, monkeypatch):
    fake = scratch_build / "nvcc"
    # writes its -o target and reports a register count, as nvcc -Xptxas -v
    fake.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\n'
                    'echo "ptxas info: Used 128 registers"\ntouch "$2"\n')
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
    path = _build.build("flash_fwd")
    assert os.path.exists(path)
    assert "128 registers" in _build.BUILD_LOGS["flash_fwd"]
    # a built library is not rebuilt
    monkeypatch.setattr(_build, "_nvcc", lambda: pytest.fail("rebuilt"))
    assert _build.build("flash_fwd") == path


def test_build_keeps_the_compiler_report_beside_the_library(scratch_build, monkeypatch):
    fake = scratch_build / "nvcc"
    calls = scratch_build / "calls"
    fake.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\n'
                    f'echo x >> {calls}\n'
                    'echo "ptxas info: Used 128 registers"\ntouch "$2"\n')
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
    path = _build.build("flash_fwd")
    # a later process, which did not build it, still reads the report
    monkeypatch.setattr(_build, "BUILD_LOGS", {})
    assert "128 registers" in _build.build_log("flash_fwd")
    assert _build.build_log("flash_bwd") == ""
    # a library whose report is gone is built again
    os.remove(_build.log_path(path))
    assert _build.build("flash_fwd") == path
    assert len(calls.read_text().split()) == 2
    assert "128 registers" in _build.build_log("flash_fwd")


def test_ptxas_report_reads_registers_spill_and_serialized_wgmma():
    log = "\n".join([
        "ptxas info    : (C7512) Potential Performance Loss: wgmma.mma_async instructions are "
        "serialized due to insufficient register resources for the wgmma pipeline in the "
        "function '_Z4slowv'",
        "ptxas info    : Compiling entry function '_Z4fastv' for 'sm_90a'",
        "ptxas info    : Function properties for _Z4fastv",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 205 registers, used 16 barriers",
        "ptxas info    : Compiling entry function '_Z4slowv' for 'sm_90a'",
        "ptxas info    : Function properties for _Z4slowv",
        "    600 bytes stack frame, 548 bytes spill stores, 308 bytes spill loads",
        "ptxas info    : Used 168 registers, used 1 barriers",
    ])
    assert _build.ptxas_report(log) == {"_Z4fastv": [205, 0, 0, False],
                                        "_Z4slowv": [168, 548, 308, True]}


def test_regs_probe_variants_apply_to_the_source():
    # each variant edits text of its kernel's source (csrc/flash_fwd.cu for
    # K1, csrc/flash_bwd.cu for K2 and K3 at Dp 256) that must be there once,
    # and each probe's first variant is the kernel as built
    from hivedscheduler_tpu_torch.ops import regs_probe

    assert regs_probe.VARIANTS["256 threads (as built)"] == ()
    assert regs_probe.PROBES["K1"][2:] == (regs_probe.KERNEL, regs_probe.VARIANTS)
    for key, (source, files, kernel, variants) in regs_probe.PROBES.items():
        with open(os.path.join(_build.CSRC, source)) as f:
            text = f.read()
        assert source in files and all(os.path.exists(os.path.join(_build.CSRC, n))
                                       for n in files), key
        assert next(iter(variants.values())) == (), key
        for label, changes in variants.items():
            variant = regs_probe.apply(text, changes, source)
            assert (f" {kernel}(" in variant) and (variant != text or not changes), (key, label)


def _run(cmd, cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run(cmd, cwd=cwd, capture_output=True, text=True,
                          timeout=120, env=env)


def test_chip_smoke_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    proc = _run([sys.executable, "chip_smoke.py"], REPO)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "no CUDA device" in proc.stderr


def test_chip_smoke_refuses_without_the_repository(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    # pretend a card is present, so the missing package is what stops it
    code = ("import runpy, sys, torch\n"
            "torch.cuda.is_available = lambda: True\n"
            "sys.argv = ['chip_smoke.py']\n"
            "runpy.run_path('chip_smoke.py', run_name='__main__')\n")
    proc = _run([sys.executable, "-c", code], str(tmp_path))
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "port package is missing" in proc.stderr


def test_kernel_ab_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from hivedscheduler_tpu_torch.ops import kernel_ab

    assert kernel_ab.libraries() == sorted(_build.LIBRARIES) == [
        "flash_bwd", "flash_bwd_f16", "flash_bwd_tf32", "flash_bwd_tf32_wide", "flash_bwd_wide",
        "flash_fwd", "flash_fwd_f16", "flash_fwd_tf32", "flash_fwd_tf32_wide", "flash_fwd_wide",
        "flash_generic"]
    assert kernel_ab.main(["--other", str(tmp_path)]) != 0
    assert not os.listdir(tmp_path)  # nothing was built


def test_kernel_ab_masks_the_anonymous_namespace():
    # --sass compares two trees' kernels function by function: the hash in a
    # source's anonymous namespace changes with any edit of the file, so it
    # is masked, and the rest of the name and every instruction still count
    from hivedscheduler_tpu_torch.ops import kernel_ab

    def dump(tag, body):
        return (f"\tcode for sm_90a\n\t\tFunction : _ZN55_GLOBAL__N__{tag}_22_flash_fwd_tf32_"
                f"wide_cu_{tag[::-1]}20tf32_wide_fwd_kernelENS_7FwdArgsE\n"
                f"        /*0000*/  {body} ;\n")

    a = kernel_ab.sass_functions(dump("86c67ed1", "MOV R1, c[0x0][0x28]"))
    b = kernel_ab.sass_functions(dump("0a1b2c3d", "MOV R1, c[0x0][0x28]"))
    c = kernel_ab.sass_functions(dump("0a1b2c3d", "MOV R1, c[0x0][0x30]"))
    assert a == b and len(a) == 1
    (name,) = a
    assert "20tf32_wide_fwd_kernel" in name and "86c67ed1" not in name
    assert a.keys() == c.keys() and a != c


def test_kernel_ab_times_the_other_trees_route():
    # a tree without a cluster kernel's library ran it past D 256 on the
    # CUDA-core family (a tree without flash_fwd_wide.cu K1, one without
    # flash_bwd_wide.cu as well K2 and K3): the comparison calls that, with
    # the same arguments; a symbol the other tree lacks otherwise is refused
    from hivedscheduler_tpu_torch.ops import attention as tattn
    from hivedscheduler_tpu_torch.ops import kernel_ab

    for lacks in (("flash_fwd_wide",), ("flash_fwd_wide", "flash_bwd_wide")):
        parent = {n: None for n in _build.LIBRARIES if n not in lacks}
        for kernel, stem in (("fwd", "fwd"), ("dq", "bwd_dq"), ("dkv", "bwd_dkv")):
            symbol = tattn.kernel_entry(torch.bfloat16, 512, False, kernel)
            assert symbol == f"hived_flash_wide_{stem}"
            other = kernel_ab.entry_in(parent, symbol)
            assert other == (f"hived_flash_generic_{stem}" if tattn._KERNELS[symbol][0] in lacks
                             else symbol)
            assert kernel_ab.entry_in(None, symbol) == symbol
            assert tattn._KERNELS[other][1:] == tattn._KERNELS[symbol][1:]
    assert kernel_ab.entry_in(parent, "hived_flash_bwd_dq") == "hived_flash_bwd_dq"
    # a tree without flash_bwd_tf32.cu ran f32 K2 and K3 on the CUDA-core
    # family at every D: --dtype f32 times the 3xTF32 kernels against those
    parent = {n: None for n in _build.LIBRARIES if n != "flash_bwd_tf32"}
    for kernel, stem in (("dq", "bwd_dq"), ("dkv", "bwd_dkv")):
        symbol = tattn.kernel_entry(torch.float32, 128, False, kernel)
        assert symbol == f"hived_flash_tf32_{stem}"
        assert kernel_ab.entry_in(parent, symbol) == f"hived_flash_generic_{stem}"
        assert kernel_ab.entry_in({**parent, "flash_bwd_tf32": None}, symbol) == symbol
        assert tattn._KERNELS[f"hived_flash_generic_{stem}"][1:] == tattn._KERNELS[symbol][1:]
    assert kernel_ab.entry_in(parent, "hived_flash_generic_fwd") == "hived_flash_generic_fwd"
    # a tree without flash_fwd_tf32.cu (this one's parent) ran f32 K1 on the
    # CUDA-core family at every D: --dtype f32 --kernels fwd times the
    # 3xTF32 K1 against that, and its K2 and K3 against the parent's own
    for lacks in (("flash_fwd_tf32",), ("flash_fwd_tf32", "flash_bwd_tf32")):
        parent = {n: None for n in _build.LIBRARIES if n not in lacks}
        symbol = tattn.kernel_entry(torch.float32, 128, False, "fwd")
        assert symbol == "hived_flash_tf32_fwd"
        assert kernel_ab.entry_in(parent, symbol) == "hived_flash_generic_fwd"
        assert tattn._KERNELS["hived_flash_generic_fwd"][1:] == tattn._KERNELS[symbol][1:]
        for kernel, stem in (("dq", "bwd_dq"), ("dkv", "bwd_dkv")):
            symbol = tattn.kernel_entry(torch.float32, 128, False, kernel)
            assert kernel_ab.entry_in(parent, symbol) == (
                f"hived_flash_generic_{stem}" if "flash_bwd_tf32" in lacks else symbol)
    # a tree without flash_bwd_tf32_wide.cu (this one's parent) ran f32 K2
    # and K3 past D 128 on the CUDA-core family: --dtype f32 --d 256 times
    # the cluster pair against that
    parent = {n: None for n in _build.LIBRARIES if n != "flash_bwd_tf32_wide"}
    for kernel, stem in (("dq", "bwd_dq"), ("dkv", "bwd_dkv")):
        symbol = tattn.kernel_entry(torch.float32, 256, False, kernel)
        assert symbol == f"hived_flash_tf32_wide_{stem}"
        assert kernel_ab.entry_in(parent, symbol) == f"hived_flash_generic_{stem}"
        assert kernel_ab.entry_in({**parent, "flash_bwd_tf32_wide": None}, symbol) == symbol
        assert tattn._KERNELS[f"hived_flash_generic_{stem}"][1:] == tattn._KERNELS[symbol][1:]
    assert kernel_ab.entry_in(parent, "hived_flash_tf32_bwd_dq") == "hived_flash_tf32_bwd_dq"
    # a tree without flash_fwd_tf32_wide.cu (this one's parent) ran f32 K1
    # past D 128 on the CUDA-core family: --dtype f32 --d 256 --kernels fwd
    # times the 3xTF32 cluster K1 against that, and its K2 and K3 against
    # the parent's own cluster pair
    parent = {n: None for n in _build.LIBRARIES if n != "flash_fwd_tf32_wide"}
    symbol = tattn.kernel_entry(torch.float32, 256, False, "fwd")
    assert symbol == "hived_flash_tf32_wide_fwd"
    assert kernel_ab.entry_in(parent, symbol) == "hived_flash_generic_fwd"
    assert kernel_ab.entry_in({**parent, "flash_fwd_tf32_wide": None}, symbol) == symbol
    assert tattn._KERNELS["hived_flash_generic_fwd"][1:] == tattn._KERNELS[symbol][1:]
    for kernel, stem in (("dq", "bwd_dq"), ("dkv", "bwd_dkv")):
        symbol = tattn.kernel_entry(torch.float32, 256, False, kernel)
        assert kernel_ab.entry_in(parent, symbol) == f"hived_flash_tf32_wide_{stem}"
    with pytest.raises(RuntimeError) as info:
        kernel_ab.entry_in({"flash_generic": None}, "hived_flash_fwd")
    assert "hived_flash_fwd" in str(info.value)


def test_dsmem_rate_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from hivedscheduler_tpu_torch.ops import dsmem_rate

    assert dsmem_rate.main([]) != 0
    assert os.path.exists(os.path.join(os.path.dirname(_build.CSRC), "dsmem_rate.cu"))


def test_library_hash_covers_included_headers(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", str(csrc))
    assert sorted(os.path.basename(p) for p in _build.sources("flash_bwd")) == [
        "flash_bwd.cu", "flash_common.cuh", "hopper.cuh"]
    before = {n: _build.library_path(n) for n in ("flash_fwd", "flash_bwd")}
    with open(csrc / "flash_common.cuh", "a") as f:
        f.write("\n// edited\n")
    after = {n: _build.library_path(n) for n in ("flash_fwd", "flash_bwd")}
    # an edited header names new libraries for every source that includes it
    assert all(before[n] != after[n] for n in before)
    # the 3xTF32 cluster K1, and K2 and K3, include both the cluster and the
    # 3xTF32 headers: an edit of either, or of hopper.cuh, names a new library
    for wide in ("flash_fwd_tf32_wide", "flash_bwd_tf32_wide"):
        assert sorted(os.path.basename(p) for p in _build.sources(wide)) == sorted([
            f"{wide}.cu", "flash_cluster.cuh", "flash_common.cuh", "flash_strides.cuh",
            "flash_tf32.cuh", "hopper.cuh"])
    for header in ("flash_cluster.cuh", "flash_tf32.cuh", "hopper.cuh", "flash_strides.cuh"):
        names = ("flash_fwd_tf32_wide", "flash_bwd_tf32_wide", "flash_bwd_wide", "flash_bwd_tf32",
                 "flash_generic")
        before = {n: _build.library_path(n) for n in names}
        with open(csrc / header, "a") as f:
            f.write("\n// edited\n")
        rebuilt = [n for n in names if _build.library_path(n) != before[n]]
        includes = [n for n in names
                    if header in [os.path.basename(p) for p in _build.sources(n)]]
        assert rebuilt[:2] == ["flash_fwd_tf32_wide", "flash_bwd_tf32_wide"], (header, rebuilt)
        assert rebuilt == includes, (header, rebuilt)


def test_build_all_runs_the_compilers_together(scratch_build, monkeypatch):
    fake = scratch_build / "nvcc"
    events = scratch_build / "events"
    # logs its start, waits, logs its end, then writes its -o target
    fake.write_text('#!/bin/sh\nsrc=""; out=""\n'
                    'while [ $# -gt 0 ]; do case "$1" in -o) out="$2"; shift;; '
                    '*.cu) src="$1";; esac; shift; done\n'
                    f'echo "start $src" >> {events}\nsleep 0.3\n'
                    f'echo "end $src" >> {events}\ntouch "$out"\n')
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
    paths = _build.build_all(["flash_fwd", "flash_bwd"])
    assert all(os.path.exists(p) for p in paths)
    kinds = [line.split()[0] for line in events.read_text().splitlines()]
    assert kinds == ["start", "start", "end", "end"]
    assert set(_build.BUILD_LOGS) == {"flash_fwd", "flash_bwd"}


def test_tf32_libraries_rebuild_on_a_tf32_header_edit(tmp_path, monkeypatch):
    # the 3xTF32 K1 and K2/K3 share flash_tf32.cuh: an edit names new
    # libraries for both, and for no library that does not include it
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", str(csrc))
    names = ("flash_fwd_tf32", "flash_bwd_tf32", "flash_bwd_tf32_wide", "flash_fwd_tf32_wide",
             "flash_fwd", "flash_generic", "flash_bwd_wide")
    for name in names[:2]:
        assert sorted(os.path.basename(p) for p in _build.sources(name)) == sorted([
            f"{name}.cu", "flash_tf32.cuh", "flash_strides.cuh", "flash_common.cuh",
            "hopper.cuh"])
    before = {n: _build.library_path(n) for n in names}
    with open(csrc / "flash_tf32.cuh", "a") as f:
        f.write("\n// edited\n")
    after = {n: _build.library_path(n) for n in names}
    assert [before[n] != after[n] for n in names] == [True] * 4 + [False] * 3


def test_both_libraries_rebuild_on_a_hopper_header_edit():
    # K1 and K2 are built from hopper.cuh: its edits must name new libraries
    for name in ("flash_fwd", "flash_bwd"):
        assert "hopper.cuh" in [os.path.basename(p) for p in _build.sources(name)]


_GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(")


def test_profile_groups_follow_the_kernel_names():
    # chip_smoke.py files a train step's device time under K1, K2 and K3 by
    # kernel-name fragments: a renamed kernel must not fall into "other"
    sys.path.insert(0, REPO)
    import chip_smoke

    names = set()
    for src in os.listdir(_build.CSRC):
        if src.endswith(".cu"):
            with open(os.path.join(_build.CSRC, src)) as f:
                names.update(_GLOBAL.findall(f.read()))
    groups = {name: chip_smoke.profile_group(name) for name in names}
    # each of K1-K3 has a wgmma kernel, a CUDA-core one (flash_generic.cu),
    # a cluster one (flash_fwd_wide.cu, flash_bwd_wide.cu), a 3xTF32 one
    # (flash_fwd_tf32.cu, flash_bwd_tf32.cu) and a 3xTF32 cluster one
    # (flash_fwd_tf32_wide.cu, flash_bwd_tf32_wide.cu); each also a wgmma one
    # of its own at the padded width 256 (flash_fwd_kernel_d256,
    # flash_bwd_dq_kernel_d256, flash_bwd_dkv_kernel_d256)
    assert sorted(groups.values()) == ["K1 flash_fwd"] * 6 + ["K2 flash_bwd_dq"] * 6 + [
        "K3 flash_bwd_dkv"] * 6
    # as the profiler shows them: mangled, inside their anonymous namespace
    for name, group in groups.items():
        mangled = f"_ZN45_GLOBAL__N__0123_12_x{len(name)}{name}ILi128ELb1EEEvNS_4ArgsE"
        assert chip_smoke.profile_group(mangled) == group


def _trace_events():
    """A Kineto-shaped trace of one step: a SiLU kernel launched in the
    forward, a mul under an RsqrtBackward0 node on the autograd thread, K1,
    an overlapping GEMM and an AdamW kernel under the optimizer's range."""
    def x(cat, name, tid, ts, dur, corr=None):
        ev = {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": tid, "ts": ts, "dur": dur}
        if corr is not None:
            ev["args"] = {"correlation": corr}
        return ev

    return [
        x("user_annotation", "train/step 2", 1, 0, 1000),
        x("user_annotation", "Optimizer.step#AdamW.step", 1, 800, 100),
        x("cpu_op", "aten::_foreach_mul_", 1, 810, 10),
        x("cuda_runtime", "cudaLaunchKernel", 1, 812, 2, corr=5),
        x("kernel", "multi_tensor_apply_kernel", 7, 850, 40, corr=5),
        x("cpu_op", "aten::silu", 1, 100, 10),
        x("cuda_runtime", "cudaLaunchKernel", 1, 105, 2, corr=1),
        x("kernel", "vectorized_elementwise_kernel", 7, 120, 30, corr=1),
        x("cpu_op", "autograd::engine::evaluate_function: RsqrtBackward0", 2, 300, 50),
        x("cpu_op", "aten::mul", 2, 310, 10),
        x("cuda_runtime", "cudaLaunchKernel", 2, 312, 2, corr=2),
        x("kernel", "elementwise_kernel", 7, 320, 20, corr=2),
        x("cpu_op", "aten::mul", 2, 355, 4),
        x("cuda_runtime", "cudaLaunchKernel", 2, 356, 2, corr=6),
        x("kernel", "elementwise_kernel", 7, 357, 3, corr=6),
        x("cuda_runtime", "cudaLaunchKernel", 2, 360, 2, corr=3),
        x("kernel", "void flash_fwd_kernel<128>", 7, 365, 100, corr=3),
        x("cuda_runtime", "cudaLaunchKernel", 1, 470, 2, corr=4),
        x("kernel", "sm90_xmma_gemm_bf16", 8, 460, 100, corr=4),
        x("cuda_runtime", "cudaLaunchKernel", 1, 1500, 2, corr=9),  # after the step
        x("kernel", "flash_fwd_kernel", 7, 1510, 10, corr=9),
    ]


def test_chip_smoke_splits_a_traced_step_by_group():
    sys.path.insert(0, REPO)
    import chip_smoke

    events = _trace_events()
    assert chip_smoke.trace_kernel_counts(events) == {"K1": 2, "K2": 0, "K3": 0}
    (step, (wall, busy, gap, groups, rest)), = chip_smoke.trace_step_breakdown(events).items()
    assert step == 2 and wall == 1.0
    # the union of the device intervals: 30 + 20 + 3 + (365..560) + 40 us
    assert busy == pytest.approx(0.288) and gap == pytest.approx(0.712)
    assert groups == pytest.approx({"AdamW": 0.04, "SiLU": 0.03, "RMSNorm": 0.02,
                                    "K1": 0.1, "cuBLAS": 0.1,
                                    chip_smoke.OTHER_ELEMENTWISE: 0.003})
    assert rest == pytest.approx({"aten::mul": 0.003})


def test_chip_smoke_flight_check_sees_planted_faults():
    sys.path.insert(0, REPO)
    import chip_smoke

    from hivedscheduler_tpu_torch.obs import journal

    j = journal.Journal(metrics=False)
    j.enabled = True
    j.note_request_submit("serve/0", at=0.0)
    j.note_leg("serve/0", "admission_wait", at=1.0)
    j.note_leg("serve/0", "prefill", at=2.5)
    j.note_request_done("serve/0", "length", first_token_at=2.5, at=3.0)
    assert chip_smoke.flight_faults(j.flights()) == []
    j.note_request_submit("serve/1", at=0.0)
    j.note_leg("serve/1", "admission_wait", at=1.0)  # no prefill leg
    j.note_request_done("serve/1", "length", first_token_at=2.5, at=3.0)
    j.note_request_done("serve/1", "length", at=3.0)
    faults = chip_smoke.flight_faults(j.flights())
    assert faults == ["serve/1: 2 terminals", "serve/1: the legs miss the TTFT by -1.5 s"]
    events = chip_smoke.validate_chrome_trace({"traceEvents": [
        {"name": "a", "ph": "X", "ts": 0, "dur": 1, "pid": 1, "tid": 1}]})
    assert len(events) == 1
    with pytest.raises(chip_smoke.SmokeFailure):
        chip_smoke.validate_chrome_trace({"traceEvents": [
            {"name": "a", "ph": "X", "ts": 0, "dur": -1, "pid": 1, "tid": 1}]})
