"""The port's sharded decode and serving on gloo gangs, against the JAX
package's on its forced CPU devices.

Each port run is a gang of processes (``tests/torch_mesh_worker.py`` with
a ``serve`` job, or the CLIs) on a ``("dp", "tp")`` serving mesh: dp 2 x
tp 2 (world 4) and tp 2 (world 2, the paged pool, which refuses dp). The
gangs start first and the JAX references are built while they run, on the
same weights (JAX's ``init_params``, carried across as numpy) at the JAX
tests' sizes, in f32:

- greedy streams token for token against JAX's ``make_sharded_generate``,
  ``make_sharded_speculative`` and ``ServingEngine(mesh=)``: dense, MoE
  (ep 1), int8 weights, LoRA merged before the layout, int8 KV, the prefix
  cache with chunked prefill, fused windows, speculative with a sharded
  and a replicated draft, and the paged pool at tp 2;
- sampled streams against the port's own single-device run with the same
  seed (the port's draws are not JAX's bits): the mesh samples as one
  device does;
- every JAX error message (heads, vocab/d_ff, ``max_batch`` vs dp, paged
  with dp), equal to JAX's text;
- a clock skewed on one rank (another offset and rate): every rank sheds
  and streams alike, as a one-rank mesh engine on the unskewed clock does
  (a mesh engine's host decisions read one agreed reading a step);
- memory: each rank's engine keeps 1/tp of every tp-cut leaf in storage of
  its own, so dropping the whole tree frees it;
- the CLIs as gangs: ``generate --tp 2`` and ``serve --dp 2 --tp 2`` print
  on rank 0 what the one-process CLI prints for the same flags (in bf16: a
  row may part only where the one-process logits tie at the top within 2
  bf16 ulps, since tp rounds its partial sums at other points), and the
  other ranks print nothing; rank 0's rows are held the same way to
  JAX's ``decode.generate`` and ``ServingEngine`` on the CLI's bf16
  weights and inputs. A process placed in a one-GPU gang takes the mesh
  path at world 1 and prints exactly what the one-process CLI prints. (JAX's CLIs draw their weights and prompts with
  ``jax.random``, so their own output cannot be the port's.)
"""

import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hivedscheduler_tpu.models import decode as jdec
from hivedscheduler_tpu.models import quant as jquant
from hivedscheduler_tpu.models import serving as jsrv
from hivedscheduler_tpu.models import speculative as jspec
from hivedscheduler_tpu.models import transformer as jtm
from hivedscheduler_tpu.parallel import topology as jtopo
from hivedscheduler_tpu_torch import bridge
from hivedscheduler_tpu_torch.models import decode as tdec
from hivedscheduler_tpu_torch.models import serving as tsrv
from hivedscheduler_tpu_torch.models import transformer as ttm

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_mesh_worker import drive_engine, gang_env  # noqa: E402

WORKER = os.path.join(ROOT, "tests", "torch_mesh_worker.py")
JOB_TIMEOUT = 240

# the JAX serving tests' model (tests/test_serving.py cfg_of)
MODEL = dict(vocab_size=128, d_model=64, n_heads=4, n_kv_heads=2, n_layers=2,
             d_ff=128, max_seq_len=128)
MOE = dict(MODEL, n_experts=4, moe_top_k=2)
LORA = dict(lora_rank=4, lora_alpha=8.0, lora_mlp=True)
# a draft whose heads divide tp = 2 (it shards), and one whose single head
# does not (it is replicated)
DRAFT_TP = dict(MODEL, n_layers=1, d_model=32, n_heads=2, n_kv_heads=2, d_ff=64)
DRAFT_REP = dict(MODEL, n_layers=1, d_model=16, n_heads=1, n_kv_heads=0, d_ff=32)
PROMPT = [[5, 9, 2, 77, 31], [17, 3, 88, 41, 7], [1, 120, 64, 8, 8], [99, 0, 12, 5, 60]]
NEW = 6
SYSTEM = [7, 11, 23, 42, 5, 9, 81, 2]
# [prompt, budget, submit-at-step]
REQUESTS = [[[5, 9, 2], 6, 0], [[17, 3, 88, 41, 7], 4, 0], [[1], 7, 1],
            [[64, 2, 99, 100, 3, 3], 5, 2], [[8, 120], 6, 4]]
PREFIX_REQUESTS = [[SYSTEM + t, n, at] for t, n, at in
                   ([[3, 4], 5, 0], [[9, 1, 77], 6, 0], [[3, 4, 5, 6, 7], 4, 3],
                    [[50], 5, 5])]
ENGINE = dict(max_batch=2, max_len=64)
# the clock-skew case: every request at step 0 into 2 slots, a queue
# deadline of 15 clock reads; rank 1's clock runs 3x fast, 1000 s ahead
SKEW_REQUESTS = [[[5, 9, 2], 6, 0], [[17, 3, 88], 6, 0], [[1, 2], 6, 0],
                 [[64, 2, 99], 6, 0], [[8, 120], 6, 0], [[4, 4, 4], 6, 0]]
SKEW_ENGINE = dict(ENGINE, queue_timeout_s=0.15)
SKEW_CLOCK = dict(tick=0.01, skew={"1": 1000.0}, rate={"1": 3.0})
SAMPLING = dict(temperature=0.8, top_k=20, top_p=0.95)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _named(tree) -> dict:
    return {jax.tree_util.keystr(p, simple=True, separator="."): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


class Gang:
    """The processes of one port run, started at once; each rank's output
    goes to its own log."""

    def __init__(self, tmp, name, world, argv_of_rank, env_of_rank=None):
        self.name, self.logs, self.procs = name, [], []
        for rank in range(world):
            log = open(os.path.join(tmp, f"{name}.{rank}.log"), "w+")
            env = dict(os.environ, **(env_of_rank(rank) if env_of_rank else {}))
            self.logs.append(log)
            self.procs.append(subprocess.Popen(
                argv_of_rank(rank), cwd=ROOT, env=env, stdout=log,
                stderr=subprocess.PIPE if env_of_rank else subprocess.STDOUT))

    def wait(self):
        """The exit codes; each rank's stdout (and stderr, for the CLIs)."""
        rcs, errs = [], []
        for p in self.procs:
            try:
                _, err = p.communicate(timeout=JOB_TIMEOUT)
            except subprocess.TimeoutExpired:
                p.kill()
                _, err = p.communicate()
            rcs.append(p.returncode)
            errs.append(err.decode() if err else "")
        outs = []
        for log in self.logs:
            log.seek(0)
            outs.append(log.read())
            log.close()
        return rcs, outs, errs


def _serve_gang(tmp, name, dp, tp, cases):
    job = dict(world=dp * tp, port=_free_port(), serve=True, dp=dp, tp=tp,
               out=os.path.join(tmp, name), cases=cases)
    path = os.path.join(tmp, f"{name}.json")
    with open(path, "w") as f:
        json.dump(job, f)
    return Gang(tmp, name, dp * tp, lambda rank: [sys.executable, WORKER, path, str(rank)])


def _cli_gang(tmp, name, world, module, argv):
    """``module.main(argv)`` in each rank of a one-pod gang, its
    coordinator on a free port so that gangs running at once do not meet."""
    code = (f"import sys; sys.path.insert(0, {ROOT!r}); "
            "from hivedscheduler_tpu_torch.parallel import distributed; "
            f"distributed.DEFAULT_COORDINATOR_PORT = {_free_port()}; "
            f"from hivedscheduler_tpu_torch import {module}; "
            f"sys.exit({module}.main({argv!r}))")
    return Gang(tmp, name, world, lambda rank: [sys.executable, "-c", code],
                lambda rank: gang_env(world, rank))


def _rank_results(tmp, name, world):
    out = []
    for rank in range(world):
        with open(os.path.join(tmp, f"{name}.{rank}.json")) as f:
            out.append(json.load(f))
    return out


class Weights:
    """JAX-initialised weights of every config, saved for the gangs."""

    def __init__(self, tmp):
        self.tmp, self.jax, self.files = tmp, {}, {}

    def add(self, name, model, seed, lora=None):
        cfg = jtm.TransformerConfig(dtype=jnp.float32, **dict(model, **(lora or {})))
        params = jax.device_get(jtm.init_params(cfg, jax.random.PRNGKey(seed)))
        if lora:
            # nonzero adapters, so that the merge changes the weights
            rng = np.random.default_rng(seed)
            params["layers"] = {
                k: (rng.normal(0.0, 0.05, v.shape).astype(np.float32)
                    if k.startswith("lora_") else v)
                for k, v in params["layers"].items()}
        self.files[name] = os.path.join(self.tmp, f"{name}.npz")
        np.savez(self.files[name], **_named(params))
        self.jax[name] = jax.tree.map(jnp.asarray, params)
        return self.files[name]


CLI_MODEL = ["--vocab-size", "128", "--d-model", "64", "--n-heads", "4",
             "--n-kv-heads", "2", "--n-layers", "2", "--d-ff", "128",
             "--device", "cpu", "--seed", "3"]
GEN_CLI = CLI_MODEL + ["--batch", "4", "--prompt-len", "6", "--new-tokens", "8"]
SERVE_CLI = CLI_MODEL + ["--requests", "6", "--max-batch", "4", "--max-len", "64",
                         "--max-new-tokens", "8", "--arrival-every", "1"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("sharded-serving"))
    w = Weights(tmp)
    dense = w.add("dense", MODEL, 0)
    moe = w.add("moe", MOE, 1)
    lora = w.add("lora", MODEL, 2, lora=LORA)
    dtp = w.add("draft-tp", DRAFT_TP, 8)
    drep = w.add("draft-rep", DRAFT_REP, 9)
    spec_tp = dict(draft_cfg=DRAFT_TP, draft_params=dtp)
    spec_rep = dict(draft_cfg=DRAFT_REP, draft_params=drep)
    gen = dict(kind="generate", cfg=MODEL, params=dense, prompt=PROMPT, new=NEW)
    eng = dict(kind="engine", cfg=MODEL, params=dense, engine=ENGINE, requests=REQUESTS)
    cases = {
        "gen-dense": gen,
        "gen-moe": dict(gen, cfg=MOE, params=moe),
        "gen-int8": dict(gen, quantize=True),
        "gen-lora": dict(gen, params=lora, lora=LORA),
        "gen-sampled": dict(gen, seed=3, **SAMPLING),
        "spec-tp-draft": dict(gen, kind="speculative", new=9, gamma=3, **spec_tp),
        "spec-rep-draft": dict(gen, kind="speculative", gamma=2, **spec_rep),
        "spec-int8": dict(gen, kind="speculative", new=7, gamma=2, quantize=True,
                          **spec_tp),
        "eng-dense": eng,
        "eng-int8kv": dict(eng, engine=dict(ENGINE, kv_dtype="int8")),
        "eng-prefix-chunked": dict(eng, requests=PREFIX_REQUESTS,
                                   engine=dict(ENGINE, max_len=48, prefix_cache_size=4,
                                               prefill_chunk=4)),
        "eng-window": dict(eng, engine=dict(ENGINE, decode_steps=4)),
        "eng-moe": dict(eng, cfg=MOE, params=moe),
        "eng-spec-tp-draft": dict(eng, gamma=3, **spec_tp),
        "eng-spec-rep-draft": dict(eng, gamma=2, **spec_rep),
        "eng-sampled": dict(eng, engine=dict(ENGINE, seed=5, **SAMPLING)),
        "eng-clock-skew": dict(eng, engine=SKEW_ENGINE, requests=SKEW_REQUESTS,
                               clock=SKEW_CLOCK),
        "param-bytes": dict(kind="param-bytes", cfg=MODEL, params=dense,
                            engine=ENGINE),
        "err-heads": dict(kind="layout", cfg=dict(MODEL, n_kv_heads=1),
                          expect_error=True),
        "err-vocab": dict(kind="layout", cfg=dict(MODEL, vocab_size=127),
                          expect_error=True),
        "err-max-batch": dict(eng, engine=dict(ENGINE, max_batch=3), expect_error=True),
        "err-paged-dp": dict(eng, engine=dict(ENGINE, page_size=8), expect_error=True),
    }
    paged = dict(eng, engine=dict(ENGINE, page_size=8, prefix_cache_size=4),
                 requests=PREFIX_REQUESTS)
    tp_cases = {
        "gen-dense": dict(gen, prompt=PROMPT[:2]),
        "eng-paged": paged,
        "eng-paged-int8kv": dict(paged, engine=dict(paged["engine"], kv_dtype="int8")),
        "eng-paged-spec": dict(paged, gamma=3, **spec_tp),
        "param-bytes": cases["param-bytes"],
    }
    skew = dict(cases["eng-clock-skew"], clock=dict(tick=SKEW_CLOCK["tick"]))
    gangs = {
        "dp2tp2": (_serve_gang(tmp, "dp2tp2", 2, 2,
                               [dict(c, name=n) for n, c in cases.items()]), 4),
        "tp2": (_serve_gang(tmp, "tp2", 1, 2,
                            [dict(c, name=n) for n, c in tp_cases.items()]), 2),
        # the clock-skew case's reference: one rank, the unskewed clock
        "dp1tp1": (_serve_gang(tmp, "dp1tp1", 1, 1, [dict(skew, name="eng-clock-skew")]),
                   1),
    }
    clis = {
        "generate": _cli_gang(tmp, "cli-generate", 2, "generate", GEN_CLI + ["--tp", "2"]),
        "serve": _cli_gang(tmp, "cli-serve", 4, "serve",
                           SERVE_CLI + ["--dp", "2", "--tp", "2"]),
        # one-GPU gangs: the mesh path at world 1, no --tp/--dp
        "generate-world1": _cli_gang(tmp, "cli-generate-world1", 1, "generate", GEN_CLI),
        "serve-world1": _cli_gang(tmp, "cli-serve-world1", 1, "serve", SERVE_CLI),
    }

    # the JAX references, on its CPU devices, while the gangs run
    def mesh(dp, tp):
        return jtopo.make_mesh(jtopo.MeshAxes(dp=dp, tp=tp), jtopo.get_devices(dp * tp))

    def jcfg(model):
        return jtm.TransformerConfig(dtype=jnp.float32, **model)

    prompt = jnp.asarray(PROMPT, jnp.int32)

    def jgen(model, params, m, new=NEW, quantized=False, rows=prompt):
        run, psh, prsh = jdec.make_sharded_generate(jcfg(model), m, new,
                                                    quantized=quantized)
        return np.asarray(run(jax.device_put(params, psh),
                              jax.device_put(rows, prsh))).tolist()

    def jspecrun(params, draft, dmodel, m, new, gamma, quantized=False):
        run, tsh, dsh, prsh = jspec.make_sharded_speculative(
            jcfg(MODEL), jcfg(dmodel), m, new, gamma=gamma, quantized_target=quantized)
        out, _ = run(jax.device_put(params, tsh), jax.device_put(draft, dsh),
                     jax.device_put(prompt, prsh))
        return np.asarray(out).tolist()

    def jeng(model, params, m, engine, requests, draft=None, dmodel=None, gamma=0):
        if draft is not None:
            e = jsrv.SpeculativeServingEngine(params, jcfg(model), draft, jcfg(dmodel),
                                              gamma=gamma, mesh=m, **engine)
        else:
            e = jsrv.ServingEngine(params, jcfg(model), mesh=m, **engine)
        return drive_engine(e, requests)

    def jerr(fn):
        try:
            fn()
        except ValueError as err:
            return str(err)
        return None

    m22, m2 = mesh(2, 2), mesh(1, 2)
    jw = w.jax
    qdense = jquant.quantize_params(jw["dense"], jcfg(MODEL))
    lcfg = jtm.TransformerConfig(dtype=jnp.float32, **dict(MODEL, **LORA))
    ref = {
        "gen-dense": jgen(MODEL, jw["dense"], m22),
        "gen-moe": jgen(MOE, jw["moe"], m22),
        "gen-int8": jgen(MODEL, qdense, m22, quantized=True),
        "gen-lora": jgen(MODEL, jtm.merge_lora(jw["lora"], lcfg), m22),
        "spec-tp-draft": jspecrun(jw["dense"], jw["draft-tp"], DRAFT_TP, m22, 9, 3),
        "spec-rep-draft": jspecrun(jw["dense"], jw["draft-rep"], DRAFT_REP, m22, NEW, 2),
        "spec-int8": jspecrun(qdense, jw["draft-tp"], DRAFT_TP, m22, 7, 2,
                              quantized=True),
        "eng-dense": jeng(MODEL, jw["dense"], m22, ENGINE, REQUESTS),
        "eng-int8kv": jeng(MODEL, jw["dense"], m22, dict(ENGINE, kv_dtype="int8"),
                           REQUESTS),
        "eng-prefix-chunked": jeng(MODEL, jw["dense"], m22,
                                   cases["eng-prefix-chunked"]["engine"], PREFIX_REQUESTS),
        "eng-window": jeng(MODEL, jw["dense"], m22, dict(ENGINE, decode_steps=4),
                           REQUESTS),
        "eng-moe": jeng(MOE, jw["moe"], m22, ENGINE, REQUESTS),
        "eng-spec-tp-draft": jeng(MODEL, jw["dense"], m22, ENGINE, REQUESTS,
                                  jw["draft-tp"], DRAFT_TP, 3),
        "eng-spec-rep-draft": jeng(MODEL, jw["dense"], m22, ENGINE, REQUESTS,
                                   jw["draft-rep"], DRAFT_REP, 2),
        "err-heads": jerr(lambda: jdec.serving_shardings(jcfg(dict(MODEL, n_kv_heads=1)),
                                                         m22)),
        "err-vocab": jerr(lambda: jdec.serving_shardings(jcfg(dict(MODEL, vocab_size=127)),
                                                         m22)),
        "err-max-batch": jerr(lambda: jsrv.ServingEngine(
            jw["dense"], jcfg(MODEL), mesh=m22, **dict(ENGINE, max_batch=3))),
        "err-paged-dp": jerr(lambda: jsrv.ServingEngine(
            jw["dense"], jcfg(MODEL), mesh=m22, **dict(ENGINE, page_size=8))),
    }
    tp_ref = {
        "gen-dense": jgen(MODEL, jw["dense"], m2, rows=prompt[:2]),
        "eng-paged": jeng(MODEL, jw["dense"], m2, paged["engine"], PREFIX_REQUESTS),
        "eng-paged-int8kv": jeng(MODEL, jw["dense"], m2,
                                 dict(paged["engine"], kv_dtype="int8"), PREFIX_REQUESTS),
        "eng-paged-spec": jeng(MODEL, jw["dense"], m2, paged["engine"], PREFIX_REQUESTS,
                               jw["draft-tp"], DRAFT_TP, 3),
    }

    # the port's own single-device runs of the sampled cases
    tcfg = ttm.TransformerConfig(dtype=torch.float32, **MODEL)
    tparams = bridge.from_numpy_tree(jax.device_get(jw["dense"]))
    single = {
        "gen-sampled": tdec.generate(
            tparams, torch.tensor(PROMPT), tcfg, NEW, generator=torch.Generator().manual_seed(3),
            **SAMPLING).tolist(),
        "eng-sampled": drive_engine(tsrv.ServingEngine(
            tparams, tcfg, **dict(ENGINE, seed=5, **SAMPLING)), REQUESTS),
    }
    out = {}
    for name, (gang, world) in gangs.items():
        rcs, logs, _ = gang.wait()
        assert rcs == [0] * world, f"{name} exited {rcs}:\n" + "\n".join(logs)
        out[name] = _rank_results(tmp, name, world)
    cli = {name: gang.wait() for name, gang in clis.items()}
    return dict(out=out, ref=ref, tp_ref=tp_ref, single=single, cli=cli)


GREEDY_CASES = ["gen-dense", "gen-moe", "gen-int8", "gen-lora", "spec-tp-draft",
                "spec-rep-draft", "spec-int8", "eng-dense", "eng-int8kv",
                "eng-prefix-chunked", "eng-window", "eng-moe", "eng-spec-tp-draft",
                "eng-spec-rep-draft"]


@pytest.mark.parametrize("case", GREEDY_CASES)
def test_dp2_tp2_greedy_streams_equal_jax(runs, case):
    ranks = runs["out"]["dp2tp2"]
    # every rank holds the same whole result (tokens gathered over dp and tp)
    for rank in ranks[1:]:
        assert rank[case] == ranks[0][case]
    assert ranks[0][case] == runs["ref"][case]


@pytest.mark.parametrize("case", ["gen-dense", "eng-paged", "eng-paged-int8kv",
                                  "eng-paged-spec"])
def test_tp2_greedy_streams_equal_jax(runs, case):
    ranks = runs["out"]["tp2"]
    assert ranks[1][case] == ranks[0][case]
    assert ranks[0][case] == runs["tp_ref"][case]


@pytest.mark.parametrize("case", ["gen-sampled", "eng-sampled"])
def test_sampled_streams_equal_the_single_device_run(runs, case):
    ranks = runs["out"]["dp2tp2"]
    for rank in ranks[1:]:
        assert rank[case] == ranks[0][case]
    assert ranks[0][case] == runs["single"][case]
    # not greedy: the draws moved some token off the argmax stream
    greedy = "gen-dense" if case.startswith("gen") else "eng-dense"
    assert ranks[0][case] != ranks[0][greedy]


@pytest.mark.parametrize("case", ["err-heads", "err-vocab", "err-max-batch",
                                  "err-paged-dp"])
def test_errors_are_jax_messages(runs, case):
    got = runs["out"]["dp2tp2"][0][case]
    want = runs["ref"][case]
    assert want is not None
    assert got == {"error": want}


def test_clock_skew_on_one_rank_changes_nothing(runs):
    ranks = runs["out"]["dp2tp2"]
    got = [r["eng-clock-skew"] for r in ranks]
    assert all(g == got[0] for g in got[1:])
    assert got[0] == runs["out"]["dp1tp1"][0]["eng-clock-skew"]
    reasons = [reason for _, reason in got[0]]
    # the case is not vacuous: the deadline shed some waiters, others ran
    assert "shed" in reasons and "length" in reasons, reasons


@pytest.mark.parametrize("gang,tp", [("dp2tp2", 2), ("tp2", 2)])
def test_each_rank_keeps_its_slice_of_the_params(runs, gang, tp):
    for rank in runs["out"][gang]:
        leaves = rank["param-bytes"]
        assert any(cut for _, _, cut, _ in leaves.values())
        for name, (whole, local, cut, shared) in leaves.items():
            if cut:
                # a copy of the rank's block: the whole leaf can be freed
                assert (local, shared) == (whole // tp, False), name
            else:
                assert local == whole, name
        sharded = sum(w for w, _, cut, _ in leaves.values() if cut)
        replicated = sum(w for w, _, cut, _ in leaves.values() if not cut)
        held = sum(local for _, local, _, _ in leaves.values())
        assert held == replicated + sharded // tp


def _cli_rows(out: str) -> list:
    """Token rows of a CLI's stdout (``serve``'s ``[rid]`` tag dropped)."""
    return [[int(t) for t in line.split("] ")[-1].split()]
            for line in out.splitlines() if line.strip()]


def _bf16_ulp(x: float) -> float:
    return 2.0 ** (np.floor(np.log2(abs(x))) - 7)


def _parts_only_at_ties(got, want, prompts, params, cfg):
    """Each row of ``got`` equals ``want`` up to its first difference, and
    there the one-process model's logits (teacher-forced on ``want``) tie
    within 2 bf16 ulps at the top: the bf16 logits tie often, and tp
    rounds its partial sums at other points than one device does. Returns
    the number of rows that part."""
    assert len(got) == len(want)
    parted = 0
    for g, w, p in zip(got, want, prompts):
        assert len(g) == len(w)
        j = next((i for i, (a, b) in enumerate(zip(g, w)) if a != b), None)
        if j is None:
            continue
        parted += 1
        seq = torch.tensor([list(p) + list(w[:j])])
        cache = tdec.init_kv_cache(cfg, 1, seq.shape[1])
        logits, _ = tdec.advance(params, cache, seq, cfg)
        top = torch.topk(logits[0, -1], 2).values.tolist()
        assert top[0] - top[1] <= 2 * _bf16_ulp(top[0]), (j, top, g, w)
        # the token the gang took is one of the tied ones
        assert logits[0, -1, g[j]].item() >= top[1], (j, g[j], top)
    return parted


def _cli_inputs(module: str):
    """The one-process CLI's bf16 weights, prompts and budgets, rebuilt as
    it builds them from ``--seed 3``."""
    from hivedscheduler_tpu_torch import serve as tserve_cli
    from hivedscheduler_tpu_torch.parallel import checkpoint as tckpt

    max_len = 64 if module == "serve" else 6 + 8
    cfg = ttm.TransformerConfig(**dict(MODEL, max_seq_len=max_len))
    params, _ = tckpt.restore_serving_params(cfg, "", torch.Generator().manual_seed(3))
    params = ttm.cast_params(params, cfg.dtype)
    if module == "generate":
        prompts = torch.randint(0, cfg.vocab_size, (4, 6),
                                generator=torch.Generator().manual_seed(4)).tolist()
        budgets = [8] * len(prompts)
    else:
        trace = tserve_cli.synthetic_trace(4, 6, cfg.vocab_size, 8)
        prompts, budgets = [p for p, _ in trace], [b for _, b in trace]
    return params, cfg, prompts, budgets


def _jax_cli_rows(module, params, cfg, prompts, budgets):
    """JAX's decode (``generate``) or engine (``serve``, driven as the CLI
    drives it: one arrival a step) on the CLI's bf16 weights and inputs."""
    jparams = jax.tree.map(lambda t: jnp.asarray(t.float().numpy(), jnp.bfloat16),
                           params)
    jcfg = jtm.TransformerConfig(**dict(MODEL, max_seq_len=cfg.max_seq_len))
    if module == "generate":
        return np.asarray(jdec.generate(jparams, jnp.asarray(prompts, jnp.int32), jcfg,
                                        budgets[0])).tolist()
    eng = jsrv.ServingEngine(jparams, jcfg, max_batch=4, max_len=64)
    out = drive_engine(eng, [[p, b, i] for i, (p, b) in enumerate(zip(prompts, budgets))])
    return [tokens for tokens, _ in out]


@pytest.mark.parametrize("module,argv", [("generate", GEN_CLI), ("serve", SERVE_CLI)])
def test_cli_in_a_one_gpu_gang_takes_the_mesh_path(runs, module, argv, capsys):
    import importlib

    rcs, outs, errs = runs["cli"][f"{module}-world1"]
    assert rcs == [0], errs
    assert "serving mesh dp=1 tp=1: rank 0 of 1" in errs[0]
    mod = importlib.import_module(f"hivedscheduler_tpu_torch.{module}")
    capsys.readouterr()
    assert mod.main(argv) == 0
    # a world-1 mesh issues no collective and computes what one device does
    assert outs[0] == capsys.readouterr().out


@pytest.mark.parametrize("name,module,argv", [
    ("generate", "generate", GEN_CLI),
    ("serve", "serve", SERVE_CLI),
])
def test_cli_gang_rank0_prints_the_one_process_output(runs, name, module, argv, capsys):
    import importlib

    rcs, outs, errs = runs["cli"][name]
    assert rcs == [0] * len(rcs), errs
    assert all(o == "" for o in outs[1:]), outs
    mod = importlib.import_module(f"hivedscheduler_tpu_torch.{module}")
    capsys.readouterr()
    assert mod.main(argv) == 0
    want = _cli_rows(capsys.readouterr().out)
    got = _cli_rows(outs[0])
    assert want and len(got) == len(want)
    params, cfg, prompts, budgets = _cli_inputs(module)
    parted = _parts_only_at_ties(got, want, prompts, params, cfg)
    assert parted < len(want)  # ties are the exception
    # and JAX's decode or engine on the same bf16 weights and inputs
    jax_rows = _jax_cli_rows(module, params, cfg, prompts, budgets)
    assert _parts_only_at_ties(got, jax_rows, prompts, params, cfg) < len(want)
