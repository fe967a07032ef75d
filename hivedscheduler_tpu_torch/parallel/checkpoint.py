"""Train-state checkpointing with crash-atomic commits.

Counterpart of ``hivedscheduler_tpu/parallel/checkpoint.py``. The payload
is written with ``torch.distributed.checkpoint`` (DCP): over the open
process group, every rank writing its own shards of DTensor state into the
same directory (on a filesystem the gang's nodes share), or in one process
when there is none. The on-disk commit protocol is the JAX
package's, so its ``_committed_steps``, ``latest_step`` and
``read_metadata`` read a directory the port wrote:

- each step has a directory ``<dir>/<step>/``;
- the step is committed only once ``hived_complete.json`` lands in it,
  written by :func:`atomic_write_bytes` strictly after the payload is
  fully written and synced: every rank syncs its files, all meet at a
  barrier, then rank 0 writes the marker;
- the marker holds ``{"step", "format", "extra"}``, and ``extra`` carries
  the loader state and :func:`train_metadata`, so they commit with the
  tensors they belong to.

A process killed mid-save leaves a step directory without a marker:
``latest_step`` and the restores skip it. A restore also survives a
committed step whose payload is unreadable by walking down the committed
steps. The payload format is the port's own (:data:`FORMAT`); a marker of
another format (the JAX package's orbax checkpoints) raises rather than
being guessed at. The three newest committed steps are kept, as orbax's
``max_to_keep=3`` keeps them.

The state is the port's: ``params`` is the tree of tensors
(``models/transformer.init_params``) and ``opt_state`` the torch optimizer
over its leaves. Both are keyed by the leaf's path in the tree
(``layers.wq``), never by the optimizer's positional index, so a tree of
another geometry cannot load by shape luck. Restores load in place into
the given tensors and the given optimizer, whose references to the
parameters stay valid. A template of DTensors takes the saved state in its
own layout: DCP reshards on load, so a checkpoint saved on one mesh
restores onto another (or onto plain tensors on one device).
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import shutil
import tempfile
import warnings
from typing import Any, Callable, Dict, List, Optional, Tuple

log = logging.getLogger(__name__)

_COMPLETE_MARKER = "hived_complete.json"
# the payload format this module writes and reads
FORMAT = "torch-dcp-v1"
# committed steps kept after a save, oldest pruned first (orbax's default
# in the JAX package)
MAX_TO_KEEP = 3

# TransformerConfig fields that determine the parameter-tree SHAPES: they
# must match exactly or the restore would be loading a different model.
GEOMETRY_FIELDS = (
    "vocab_size", "d_model", "n_heads", "n_kv_heads", "n_layers", "d_ff",
    "n_experts", "lora_rank", "lora_mlp",
)


def train_metadata(axes, cfg, *, global_batch: int, seq_len: int,
                   elastic: Optional[dict] = None) -> dict:
    """The resume sidecar persisted inside the commit marker: the SOURCE
    mesh axes, the model geometry the tensors encode, and the data-stream
    identity (global batch x seq len, the two numbers that define the
    loader's sample plan). ``elastic`` carries a job's declared shape
    ladder."""
    out = {
        "mesh": {name: size for name, size in zip(axes.names, axes.shape)},
        "model": {f: getattr(cfg, f) for f in GEOMETRY_FIELDS},
        "data": {"global_batch": global_batch, "seq_len": seq_len},
    }
    if elastic:
        out["elastic"] = elastic
    return out


def validate_resume_metadata(meta: dict, axes, cfg, *, global_batch: int,
                             seq_len: int) -> Optional[dict]:
    """Gate a resume against the checkpoint's recorded identity.

    Returns the SOURCE mesh dict when the checkpoint was written on a
    different (dp, fsdp, pp, ep, tp, sp) layout, ``None`` when the
    topology matches or the checkpoint predates the metadata. Raises
    ``ValueError`` when the checkpoint encodes a different model geometry,
    or a different data stream: silently resuming either would double-train
    or skip samples, or load a differently-shaped model."""
    model = meta.get("model")
    if model:
        mismatched = {
            f: (model[f], getattr(cfg, f))
            for f in GEOMETRY_FIELDS
            if f in model and model[f] != getattr(cfg, f)
        }
        if mismatched:
            raise ValueError(
                "checkpoint model geometry mismatch: "
                + ", ".join(f"{k}: saved {s} != current {c}"
                            for k, (s, c) in sorted(mismatched.items()))
            )
    data = meta.get("data")
    if data:
        saved = (data.get("global_batch"), data.get("seq_len"))
        if saved != (global_batch, seq_len):
            raise ValueError(
                f"checkpoint data stream mismatch: the loader's sample plan "
                f"is defined by (global batch, seq len) = {saved}; resuming "
                f"with {(global_batch, seq_len)} would silently change the "
                f"training stream"
            )
    saved_mesh = meta.get("mesh")
    if saved_mesh:
        current = {name: size for name, size in zip(axes.names, axes.shape)}
        if saved_mesh != current:
            return saved_mesh
    return None


def atomic_write_bytes(path: str, data: bytes) -> None:
    """Crash-atomic file write: temp file in the SAME directory (rename
    must not cross filesystems), flush + fsync, ``os.rename`` over the
    destination, then best-effort fsync of the directory so the rename
    itself is durable. Readers see either the old content or the new,
    never a torn write."""
    d = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(prefix=".tmp-", dir=d)
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.rename(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    _fsync_dir(d)


def _fsync_dir(d: str) -> None:
    try:
        dirfd = os.open(d, os.O_RDONLY)
        try:
            os.fsync(dirfd)
        finally:
            os.close(dirfd)
    except OSError:
        pass  # some filesystems refuse directory fsync; rename still atomic


def _step_dir(directory: str, step: int) -> str:
    return os.path.join(os.path.abspath(directory), str(step))


def _marker_path(directory: str, step: int) -> str:
    return os.path.join(os.path.abspath(directory), str(step), _COMPLETE_MARKER)


def _committed_steps(directory: str) -> Optional[List[int]]:
    """Descending committed steps, or None when NO step carries a marker
    (what the JAX package reads as a legacy, pre-marker directory; the port
    never wrote one, so it has nothing committed)."""
    directory = os.path.abspath(directory)
    steps: List[int] = []
    any_step_dir = False
    try:
        entries = os.listdir(directory)
    except OSError:
        return None
    for name in entries:
        if not name.isdigit():
            continue
        any_step_dir = True
        if os.path.exists(os.path.join(directory, name, _COMPLETE_MARKER)):
            steps.append(int(name))
    if not steps:
        return None if any_step_dir else []
    return sorted(steps, reverse=True)


def named_leaves(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """``{"embed": t, "layers.wq": t, ...}``: every leaf of a nested-dict
    tree under its dotted path, in insertion order."""
    if isinstance(tree, dict):
        out: Dict[str, Any] = {}
        for k, v in tree.items():
            out.update(named_leaves(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: tree}


def _param_paths(params: Any, optimizer) -> List[Tuple[str, Any]]:
    """(path, parameter) for each parameter the optimizer updates, in its
    order; every one must be a leaf of ``params``."""
    by_id = {id(t): name for name, t in named_leaves(params).items()}
    out = []
    for group in optimizer.param_groups:
        for p in group["params"]:
            if id(p) not in by_id:
                raise ValueError("the optimizer updates a tensor that is not "
                                 "a leaf of the parameter tree")
            out.append((by_id[id(p)], p))
    return out


def _opt_state_dict(params: Any, optimizer) -> Dict[str, Dict[str, Any]]:
    """The optimizer's per-parameter state keyed by the parameter's path
    (a parameter never stepped has no entry, as in the optimizer)."""
    out: Dict[str, Dict[str, Any]] = {}
    for name, p in _param_paths(params, optimizer):
        state = optimizer.state.get(p)
        if not state:
            continue
        for key, value in state.items():
            if not hasattr(value, "detach"):
                raise TypeError(f"optimizer state {name}.{key} is a "
                                f"{type(value).__name__}, not a tensor")
        out[name] = {key: value.detach() for key, value in state.items()}
    return out


def _distributed() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def _is_rank0() -> bool:
    import torch.distributed as dist

    return not _distributed() or dist.get_rank() == 0


def _barrier() -> None:
    import torch.distributed as dist

    if _distributed():
        dist.barrier()


def _all_ranks(ok: bool) -> bool:
    """True when ``ok`` holds on every rank (``ok`` itself without a
    process group)."""
    import torch.distributed as dist

    if not _distributed():
        return ok
    oks = [None] * dist.get_world_size()
    dist.all_gather_object(oks, ok)
    return all(oks)


@contextlib.contextmanager
def _single_process():
    """Without a process group ``torch.distributed.checkpoint`` runs alone
    in the process and warns that it does so on every call; this hides
    that one warning. With a group it is not needed and hides nothing."""
    if _distributed():
        yield
        return
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="torch.distributed is disabled")
        yield


def save(directory: str, step: int, params: Any, opt_state: Any,
         extra: Optional[dict] = None) -> None:
    """Save one checkpoint (blocking): ``params`` (the tensor tree) and
    ``opt_state`` (the optimizer over its leaves). The step is committed,
    visible to ``latest_step`` and the restores, only once its completion
    marker is atomically in place; the payload files are synced first.
    With a process group every rank calls this: each writes and syncs its
    shards, all meet at a barrier, and rank 0 writes the marker and
    prunes; a last barrier keeps every rank from going on before the
    commit.

    ``extra``: JSON-serializable sidecar state of record (data-loader
    position, :func:`train_metadata`) stored INSIDE the commit marker, so
    it commits atomically with the step. Read it back with
    :func:`read_metadata`. After the commit the oldest committed steps
    beyond :data:`MAX_TO_KEEP` are removed."""
    import torch.distributed.checkpoint as dcp

    from hivedscheduler_tpu_torch.obs import goodput as _goodput

    with _goodput.span("checkpoint_save"):
        path = _step_dir(directory, step)
        if _is_rank0():
            os.makedirs(directory, exist_ok=True)
            if os.path.isdir(path):
                # a step saved again: uncommit it first, so no reader can
                # pair its marker with a half-written payload
                if os.path.exists(_marker_path(directory, step)):
                    os.unlink(_marker_path(directory, step))
                    _fsync_dir(path)
                shutil.rmtree(path)
        _barrier()
        state = {
            "params": {n: t.detach() for n, t in named_leaves(params).items()},
            "opt_state": _opt_state_dict(params, opt_state),
        }
        writer = dcp.FileSystemWriter(path, sync_files=True,
                                      thread_count=min(8, os.cpu_count() or 1))
        with _single_process():
            dcp.save(state, storage_writer=writer)
        _barrier()  # every rank's payload is written and synced
        if _is_rank0():
            marker = {"step": step, "format": FORMAT}
            if extra:
                marker["extra"] = extra
            atomic_write_bytes(
                _marker_path(directory, step), json.dumps(marker).encode(),
            )
            _prune(directory)
        _barrier()


def _prune(directory: str) -> None:
    """Remove the committed steps beyond the newest :data:`MAX_TO_KEEP`,
    each uncommitted (marker first) before its payload goes."""
    for step in (_committed_steps(directory) or [])[MAX_TO_KEEP:]:
        os.unlink(_marker_path(directory, step))
        shutil.rmtree(_step_dir(directory, step), ignore_errors=True)


def read_metadata(directory: str, step: Optional[int] = None) -> dict:
    """The commit marker's sidecar dict for ``step`` (default: the newest
    committed step). ``{}`` for markers without ``extra``, steps without a
    marker, or unreadable markers: metadata is best-effort by contract;
    the tensors are the source of truth."""
    if step is None:
        committed = _committed_steps(directory)
        if not committed:
            return {}
        step = committed[0]
    try:
        with open(_marker_path(directory, step)) as f:
            return json.load(f).get("extra", {}) or {}
    except (OSError, ValueError):
        return {}


def latest_step(directory: str) -> Optional[int]:
    """The newest committed step, or None (a read never creates the
    directory)."""
    if not os.path.isdir(directory):
        return None
    committed = _committed_steps(directory)
    return committed[0] if committed else None


def _check_format(directory: str, step: int) -> None:
    """Raise on a marker that names another payload format; a marker that
    cannot be read leaves the decision to the payload."""
    try:
        with open(_marker_path(directory, step)) as f:
            fmt = json.load(f).get("format")
    except (OSError, ValueError):
        return
    if fmt != FORMAT:
        raise ValueError(
            f"checkpoint step {step} under {directory} has payload format "
            f"{fmt!r}; this package reads {FORMAT!r} only (a checkpoint of "
            f"the JAX package is not loaded by guesswork)")


def _restore_ladder(directory: str, step: Optional[int],
                    do_restore: Callable[[int], Any]):
    """Shared restore core: resolve the step ladder and walk it.

    An explicit ``step`` is restored exactly (failure raises: the caller
    asked for that step). With ``step=None`` the newest *committed* step
    is tried first; if its payload is unreadable (torn or truncated
    storage past the commit marker), the ladder falls back to the next
    committed step, so a resume always lands on the newest complete
    checkpoint. A marker of another format raises at once. With a process
    group the ranks agree on each step: if any rank cannot read it, all
    fall back together. Returns ``(step, restored)``."""
    if not os.path.isdir(directory):
        raise FileNotFoundError(f"no checkpoint found under {directory}")
    if step is not None:
        _check_format(directory, step)
        return step, do_restore(step)
    candidates = _committed_steps(directory) or []
    if not candidates:
        raise FileNotFoundError(f"no checkpoint found under {directory}")
    last_exc: Optional[Exception] = None
    for s in candidates:
        _check_format(directory, s)
        try:
            restored = do_restore(s)
            ok = True
        except Exception as e:  # torn payload despite the marker
            last_exc, ok = e, False
        if _all_ranks(ok):
            return s, restored
        log.warning(
            "checkpoint step %d under %s is unreadable (%s); "
            "falling back to the previous complete checkpoint",
            s, directory, last_exc or "on another rank",
        )
    raise RuntimeError(
        f"every checkpoint under {directory} is unreadable "
        f"(tried steps {candidates})"
    ) from last_exc


def _dcp_load(state: dict, reader) -> None:
    """``torch.distributed.checkpoint.load`` of ``state`` in place. Its
    failures derive from ``BaseException``; they are raised as a
    ``RuntimeError`` here, so the restore ladder can fall back past a torn
    payload without catching interrupts."""
    import torch.distributed.checkpoint as dcp
    from torch.distributed.checkpoint.api import CheckpointException

    try:
        with _single_process():
            dcp.load(state, storage_reader=reader)
    except CheckpointException as e:
        raise RuntimeError(f"reading {reader.path}: {e}") from e


def _load_params(path: str, params: Any) -> None:
    """Load the step's parameters in place into the tree's tensors."""
    import torch.distributed.checkpoint as dcp

    state = {"params": {n: t.detach() for n, t in named_leaves(params).items()}}
    _dcp_load(state, dcp.FileSystemReader(path))


def _load_opt_state(path: str, params: Any, optimizer) -> None:
    """Load the step's optimizer state into ``optimizer``. The templates
    come from the checkpoint's own listing: a moment of a parameter's
    shape is read straight into a tensor like the parameter (its device,
    or its layout for a DTensor), anything else (AdamW's ``step`` count)
    onto the CPU, and ``load_state_dict`` then places each entry as the
    optimizer keeps it."""
    import torch
    import torch.distributed.checkpoint as dcp

    reader = dcp.FileSystemReader(path)
    listing = reader.read_metadata().state_dict_metadata
    named = _param_paths(params, optimizer)
    templates: Dict[str, Dict[str, Any]] = {}
    for name, p in named:
        prefix = f"opt_state.{name}."
        entries = {}
        for key, meta in listing.items():
            if not key.startswith(prefix) or "." in key[len(prefix):]:
                continue
            size, dtype = tuple(meta.size), meta.properties.dtype
            if size == tuple(p.shape):
                template = torch.empty_like(p.detach(), dtype=dtype)
            else:
                template = torch.empty(size, dtype=dtype, device="cpu")
            entries[key[len(prefix):]] = template
        if entries:
            templates[name] = entries
    _dcp_load({"opt_state": templates}, reader)
    groups = optimizer.state_dict()["param_groups"]
    state = {i: templates[name] for i, (name, _) in enumerate(named)
             if name in templates}
    optimizer.load_state_dict({"state": state, "param_groups": groups})


def restore_params(directory: str, params_template: Any,
                   step: Optional[int] = None) -> Tuple[int, Any]:
    """Restore (step, params) only, in place into ``params_template``; any
    optimizer is left untouched. For evaluation and for warm starts
    (``train --init-from``: a fresh optimizer on restored weights)."""
    from hivedscheduler_tpu_torch.obs import goodput as _goodput

    with _goodput.span("checkpoint_restore"):
        step, _ = _restore_ladder(directory, step, lambda s: _load_params(
            _step_dir(directory, s), params_template))
    return step, params_template


def restore_serving_params(cfg: Any, checkpoint_dir: str, generator, *,
                           lora_rank: int = 0) -> Tuple[Any, Optional[int]]:
    """The generate CLI's loading path: init a param tree from
    ``generator`` on its device, then restore it in place from
    ``checkpoint_dir`` when one is given (parameters only: serving needs
    no optimizer moments). Returns (params, restored_step_or_None); raises
    FileNotFoundError like :func:`restore_params`. A LoRA checkpoint
    (``lora_rank`` > 0) is refused: merging adapters is not yet ported."""
    from hivedscheduler_tpu_torch.models import transformer as tm

    if lora_rank > 0:
        raise tm._not_yet_ported("LoRA (lora_rank > 0)")
    params = tm.init_params(cfg, generator, generator.device)
    step = None
    if checkpoint_dir:
        step, params = restore_params(checkpoint_dir, params)
    return params, step


def restore(directory: str, params_template: Any, opt_state_template: Any,
            step: Optional[int] = None) -> Tuple[int, Any, Any]:
    """Restore (step, params, opt_state): the parameters in place into
    ``params_template``'s tensors and the optimizer state into
    ``opt_state_template`` (the optimizer over those tensors), each
    parameter's step count included."""
    from hivedscheduler_tpu_torch.obs import goodput as _goodput

    def do_restore(s):
        path = _step_dir(directory, s)
        _load_params(path, params_template)
        _load_opt_state(path, params_template, opt_state_template)

    with _goodput.span("checkpoint_restore"):
        step, _ = _restore_ladder(directory, step, do_restore)
    return step, params_template, opt_state_template
