"""LM loss, the training step and the forward-only evaluation step.

Counterpart of ``hivedscheduler_tpu/parallel/train.py``: ``loss_fn``,
``make_optimizer``, ``train_step`` (with gradient accumulation), the
remat-policy override, ``_shardings``, ``make_sharded_train_step``,
``make_sharded_eval_step`` and ``make_sharded_lora_train_step`` over a
six-axis ``DeviceMesh`` (dp, fsdp, pp, ep, tp and sp; a pipelined model
trains through ``parallel/pipeline.value_and_grad``), and their
one-device cousins ``make_train_step``,
``make_eval_step`` and ``make_lora_train_step``. The LoRA steps train the
adapters alone: the base takes no gradient and AdamW holds moments for
the adapters only.

The parameter tree is the JAX package's: a dict of f32 leaves, plain
tensors on one device and DTensors laid out by
``models.transformer.sharding_specs`` over a mesh. PyTorch updates in
place, so a step returns the same tree and optimizer it was given,
updated, where the JAX step returns new ones.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
from typing import Any, Callable, List, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as torch_checkpoint

from hivedscheduler_tpu_torch import bridge, resolve_device
from hivedscheduler_tpu_torch.models import transformer as tm
from hivedscheduler_tpu_torch.parallel import data as data_lib
from hivedscheduler_tpu_torch.parallel import sharding
from hivedscheduler_tpu_torch.parallel.checkpoint import named_leaves

log = logging.getLogger(__name__)


def make_optimizer(lr: float = 3e-4, weight_decay: float = 0.01) -> Callable:
    """AdamW as the JAX package's ``optax.adamw(lr, b1=0.9, b2=0.95,
    weight_decay=...)``: eps 1e-8, decay on every leaf. Returns the
    constructor to call on the parameter leaves, since a torch optimizer is
    built over the tensors it updates."""
    return functools.partial(torch.optim.AdamW, lr=lr, betas=(0.9, 0.95),
                             eps=1e-8, weight_decay=weight_decay)


def _chunk_ce(hidden_c, head, targets_c, mask_c):
    """Summed masked cross-entropy of one sequence chunk."""
    logits_c = torch.einsum("bcd,dv->bcv", hidden_c, head).float()
    ce = F.cross_entropy(logits_c.reshape(-1, logits_c.shape[-1]),
                         targets_c.reshape(-1), reduction="none")
    return torch.sum(ce * mask_c.reshape(-1))


def loss_fn(params, tokens: torch.Tensor, cfg: tm.TransformerConfig,
            mesh=None, ce_chunk: int = 0, include_aux: bool = True) -> torch.Tensor:
    """Next-token LM loss: predict tokens[:, 1:] from tokens[:, :-1] with a
    full-length forward; the rolled-in last position is masked out.

    ``ce_chunk > 0`` applies the lm_head and the cross-entropy in sequence
    chunks of that size, each checkpointed where autograd records, so the
    backward recomputes one chunk's logits at a time and the [B, T, vocab]
    f32 logits never exist at once; the result is the same sum.
    ``include_aux`` adds the MoE layers' weighted aux losses (load balance
    and z-loss; 0 for the dense model); evaluation leaves them out, so that
    ``exp(loss)`` is the perplexity.

    Under a ``mesh``, ``tokens`` are this rank's rows, whole sequences,
    of which the rank computes its sp slice (see ``forward_with_aux``), and
    the loss is the global mean over every rank's part, the same number on
    every rank; each rank's gradient of it is its own part's contribution
    (``MeshShards.data_sum``), which ``train_step`` sums over
    ``sharding.GRAD_AXES``. The roll is over the whole sequence, so a
    slice's last target is the next slice's first token."""
    shards = tm.mesh_shards(mesh, cfg)
    tokens = sharding.local(tokens)
    targets, mask = _lm_targets(tokens, shards, ce_chunk)
    hidden, aux = tm.forward_with_aux(params, tokens, cfg, mesh=mesh,
                                      return_hidden=True)
    loss = _lm_loss(hidden, params, cfg, shards, targets, mask, ce_chunk)
    if include_aux:
        loss = loss + aux
    return loss


def _lm_targets(tokens: torch.Tensor, shards: Optional[sharding.MeshShards],
                ce_chunk: int):
    """(targets, mask) of ``loss_fn``: the next tokens of the whole rows,
    the last position masked out, at this rank's sp slice."""
    targets = torch.roll(tokens, -1, dims=1).long()
    mask = torch.ones(tokens.shape, dtype=torch.float32, device=tokens.device)
    mask[:, -1] = 0.0
    if shards is not None:
        targets, mask = shards.seq_part(targets), shards.seq_part(mask)
    t = targets.shape[1]
    if ce_chunk > 0 and t % ce_chunk:
        sp = 1 if shards is None else shards.sizes["sp"]
        raise ValueError(
            f"seq len {t}{' (a rank slice of sp)' if sp > 1 else ''} not "
            f"divisible by ce_chunk {ce_chunk}"
        )
    return targets, mask


def _lm_loss(hidden: torch.Tensor, params, cfg: tm.TransformerConfig,
             shards: Optional[sharding.MeshShards], targets: torch.Tensor,
             mask: torch.Tensor, ce_chunk: int) -> torch.Tensor:
    """The global mean of the masked cross-entropy of the final-norm
    ``hidden`` states (in sequence chunks of ``ce_chunk``, each
    checkpointed, when it is above 0)."""
    b, t = targets.shape
    head = tm.lm_head_weight(params, cfg, shards)
    if ce_chunk <= 0:
        logits = torch.einsum("btd,dv->btv", hidden, head).float()
        per_tok = F.cross_entropy(
            logits.reshape(b * t, -1), targets.reshape(-1), reduction="none"
        ).reshape(b, t)
        total = torch.sum(per_tok * mask)
    else:
        total = torch.zeros((), dtype=torch.float32, device=hidden.device)
        for s in range(0, t, ce_chunk):
            chunk = (hidden[:, s:s + ce_chunk], head,
                     targets[:, s:s + ce_chunk], mask[:, s:s + ce_chunk])
            if torch.is_grad_enabled():
                part = torch_checkpoint.checkpoint(_chunk_ce, *chunk,
                                                   use_reentrant=False)
            else:
                part = _chunk_ce(*chunk)
            total = total + part
    if shards is None:
        return total / torch.sum(mask)
    return shards.data_sum(total / shards.data_sum(torch.sum(mask)))


def _pipeline_value_and_grad(params, tokens: torch.Tensor,
                             cfg: tm.TransformerConfig, mesh,
                             leaves: List[torch.Tensor], ce_chunk: int):
    """(loss, grads) of ``loss_fn`` for a pipelined model: the schedule of
    ``parallel/pipeline.value_and_grad``, whose last stage takes the
    final norm and this cross-entropy."""
    from hivedscheduler_tpu_torch.parallel import pipeline

    shards = tm.mesh_shards(mesh, cfg)
    tokens = sharding.local(tokens)
    targets, mask = _lm_targets(tokens, shards, ce_chunk)

    def head_loss(hidden):
        hidden = tm._rms_norm(hidden, sharding.local(params["final_norm"]))
        return _lm_loss(hidden, params, cfg, shards, targets, mask, ce_chunk)

    return pipeline.value_and_grad(params, tokens, cfg, mesh, leaves, head_loss)


def _leaves(params) -> List[torch.Tensor]:
    """The tree's tensor leaves in a fixed (insertion) order."""
    return list(named_leaves(params).values())


def _accumulated_value_and_grad(grad_fn, params, tokens: torch.Tensor,
                                grad_accum: int,
                                shards: Optional[sharding.MeshShards] = None):
    """(loss, grads) of ``grad_fn(params, micro_tokens)`` averaged over
    ``grad_accum`` equal slices of the batch, one slice's activations alive
    at a time. For the dense model the average equals the full-batch
    gradient: the LM loss is a mean over equal slices. The MoE aux losses
    are nonlinear batch statistics, so, as in the JAX package, each slice
    computes its own and they are averaged.

    Under a mesh with data axes above 1 the slices are the JAX package's:
    slice i holds global rows [i B/n, (i+1) B/n), split over the data ranks
    as ``activation_spec`` splits a batch, so each rank takes its part of
    every slice from the whole token batch (a few KB, gathered once). Where
    a slice does not split over dp x fsdp every rank runs it whole,
    replicated over the data axes, logged: JAX's fallback (the global-mean
    loss keeps the sum of the ranks' gradients exact)."""
    if grad_accum <= 1:
        return grad_fn(params, tokens)
    part, n_parts = (0, 1) if shards is None else data_lib.data_split(shards.mesh)
    if n_parts > 1:
        tokens = shards.whole_rows(tokens)
    b = tokens.shape[0]
    if b % grad_accum:
        raise ValueError(f"batch {b} not divisible by grad_accum {grad_accum}")
    slices = tokens.reshape(grad_accum, b // grad_accum, *tokens.shape[1:])
    if n_parts > 1:
        if slices.shape[1] % n_parts:
            log.info("a grad_accum slice of %s rows does not split over %s "
                     "data-parallel ranks: each slice runs replicated over "
                     "the data axes", slices.shape[1], n_parts)
        else:
            n = slices.shape[1] // n_parts
            slices = slices[:, part * n:(part + 1) * n]
    loss_sum, grad_sum = None, None
    for micro in slices:
        loss, grads = grad_fn(params, micro)
        if grad_sum is None:
            loss_sum, grad_sum = loss, list(grads)
        else:
            loss_sum = loss_sum + loss
            # on the local shards: DTensor arithmetic would pay its
            # sharding propagation for every leaf's shape
            for acc, g in zip(grad_sum, grads):
                sharding.local(acc).add_(sharding.local(g))
    for g in grad_sum:
        sharding.local(g).div_(grad_accum)
    return loss_sum / grad_accum, grad_sum


def train_step(params, optimizer: torch.optim.Optimizer, tokens: torch.Tensor,
               cfg: tm.TransformerConfig, mesh=None, grad_accum: int = 1,
               ce_chunk: int = 0, skip_nonfinite: bool = False,
               trainable: Optional[List[torch.Tensor]] = None):
    """One optimizer update -> (params, optimizer, loss). ``params`` are
    updated in place; see ``_accumulated_value_and_grad`` for
    ``grad_accum > 1`` and ``loss_fn`` for ``ce_chunk``. ``trainable``:
    the leaves to differentiate and update (every leaf by default; the
    LoRA steps pass the adapters), the ones ``optimizer`` holds.

    ``skip_nonfinite``: when the loss comes out non-finite, params and the
    optimizer state (its step count included) are left untouched and the
    loss is still returned, for the caller's divergence accounting. Under
    a mesh the loss is global, so every rank decides the same way.

    Under a ``mesh`` ``params`` are DTensors and ``tokens`` this rank's
    rows (over sp, its slice of their sequence); each gradient is summed
    over the ``sharding.GRAD_AXES`` (and pp) along which its parameter is
    replicated before the update. A pipelined model takes its gradients
    from the GPipe schedule (``parallel/pipeline.value_and_grad``)."""
    leaves = _leaves(params) if trainable is None else trainable
    loss, grads = value_and_grad(params, tokens, cfg, mesh, grad_accum=grad_accum,
                                 ce_chunk=ce_chunk, trainable=leaves)
    if skip_nonfinite and not bool(torch.isfinite(loss)):
        return params, optimizer, loss
    for leaf, g in zip(leaves, grads):
        leaf.grad = g
    optimizer.step()
    optimizer.zero_grad(set_to_none=True)
    return params, optimizer, loss


def value_and_grad(params, tokens: torch.Tensor, cfg: tm.TransformerConfig,
                   mesh=None, grad_accum: int = 1, ce_chunk: int = 0,
                   trainable: Optional[List[torch.Tensor]] = None):
    """(loss, gradients of ``trainable``, every leaf by default) of
    ``train_step``'s update, before the optimizer: under a mesh each
    gradient is already summed over the axes its leaf is replicated along,
    so it is the whole gradient on every rank."""
    leaves = _leaves(params) if trainable is None else trainable
    shards = tm.mesh_shards(mesh, cfg)
    if cfg.pipeline_microbatches > 0:
        def grad_fn(p, micro):
            return _pipeline_value_and_grad(p, micro, cfg, mesh, leaves, ce_chunk)
    else:
        def grad_fn(p, micro):
            loss = loss_fn(p, micro, cfg, mesh, ce_chunk=ce_chunk)
            return loss.detach(), torch.autograd.grad(loss, leaves)

    loss, grads = _accumulated_value_and_grad(
        grad_fn, params, sharding.local(tokens), grad_accum, shards)
    if shards is not None:
        with torch.no_grad():
            for leaf, g in zip(leaves, grads):
                shards.sync_grad(sharding.local(g), leaf)
    return loss, grads


REMAT_POLICIES = tm.REMAT_POLICIES


def _apply_remat_policy(cfg: tm.TransformerConfig, remat_policy):
    """``None`` keeps ``cfg.remat``; anything else replaces it. The policy
    only changes what the backward recomputes: "full" whole layers, "dots"
    all but the matmul outputs, "none" nothing. Loss and gradients are the
    same under every policy."""
    if remat_policy is None:
        return cfg
    if remat_policy not in REMAT_POLICIES:
        raise ValueError(
            f"unknown remat_policy {remat_policy!r}; expected one of "
            f"{REMAT_POLICIES}"
        )
    return dataclasses.replace(cfg, remat=remat_policy)


def make_train_step(cfg: tm.TransformerConfig, device: str | torch.device = "cuda",
                    optimizer: Optional[Callable] = None, grad_accum: int = 1,
                    ce_chunk: int = 0, skip_nonfinite: bool = False,
                    remat_policy: Optional[str] = None):
    """The one-device training step, counterpart of
    ``make_sharded_train_step``. Returns ``(step, init_fn)``:

    - ``init_fn(generator) -> (params, opt_state)``: f32 params on
      ``device`` that require grad, and ``opt_state``, the optimizer over
      their leaves (``optimizer`` is a constructor as
      :func:`make_optimizer` returns; AdamW by default);
    - ``step(params, opt_state, tokens) -> (params, opt_state, loss)``,
      one update in place; ``loss`` is a 0-d f32 tensor on the device.
      Every leaf of ``params`` must require grad."""
    cfg = _apply_remat_policy(cfg, remat_policy)
    tm.check_supported(cfg)
    dev = resolve_device(device)
    make_opt = optimizer or make_optimizer()

    def init_fn(generator: torch.Generator):
        params = tm.init_params(cfg, generator, dev)
        for leaf in _leaves(params):
            leaf.requires_grad_(True)
        return params, make_opt(_leaves(params))

    def step(params, opt_state, tokens: torch.Tensor):
        return train_step(params, opt_state, tokens.to(dev), cfg,
                          grad_accum=grad_accum, ce_chunk=ce_chunk,
                          skip_nonfinite=skip_nonfinite)

    return step, init_fn


def make_eval_step(cfg: tm.TransformerConfig, device: str | torch.device = "cuda",
                   ce_chunk: int = 0):
    """Forward-only LM loss on one device, the counterpart of
    ``make_sharded_eval_step``. Returns ``(eval_step, init_fn)``:
    ``init_fn(generator) -> params`` on ``device``, and
    ``eval_step(params, tokens) -> mean next-token CE`` (a 0-d f32 tensor on
    the device; no host sync) under ``torch.inference_mode()``, so
    ``exp(loss)`` is the model's perplexity."""
    dev = resolve_device(device)
    tm.check_supported(cfg)

    def init_fn(generator: torch.Generator):
        return tm.init_params(cfg, generator, dev)

    def eval_step(params, tokens: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return loss_fn(params, tokens.to(dev), cfg, ce_chunk=ce_chunk,
                           include_aux=False)

    return eval_step, init_fn


class TokenSharding(NamedTuple):
    """Where a global [batch, seq] token batch lives: the mesh and the
    DTensor placements of ``activation_spec``'s rows (the counterpart of
    JAX's token ``NamedSharding``). The sequence is not split: every sp
    rank holds whole rows, a few KB, and computes its own slice of them."""

    mesh: Any
    placements: list


def _shardings(cfg: tm.TransformerConfig, mesh) -> TokenSharding:
    """Check ``cfg``'s layout over ``mesh`` and return the token sharding,
    the one home of the setup shared by the train and eval factories (the
    parameters are placed by ``sharding_specs``, on
    ``sharding.param_mesh(mesh)``). Raises ``ValueError`` when heads do not
    divide tp (as the JAX package's does) or a sharded weight dim does not
    split evenly or the experts do not split over ep, and the JAX
    package's pipeline errors for a pipelined model's mesh
    (``models.transformer.check_mesh``)."""
    sizes = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    tm.check_mesh(cfg, sizes)
    shapes = {name: tuple(t.shape) for name, t in named_leaves(
        tm.init_params(cfg, None, "meta")).items()}
    for name, spec in named_leaves(tm.sharding_specs(cfg)).items():
        sharding.check_divisible(shapes[name], spec, sizes, name)
    return TokenSharding(mesh, sharding.placements(tm.activation_spec()[:1], mesh))


def _init_on_mesh(cfg: tm.TransformerConfig, mesh, generator: torch.Generator):
    """Params from ``generator`` (the same seed on every rank), each leaf
    laid out by ``sharding_specs`` on ``mesh``. Every rank draws the whole
    tree once and keeps its shards."""
    full = tm.init_params(cfg, generator, mesh.device_type)
    return bridge.distribute_tree(full, mesh, tm.sharding_specs(cfg))


def make_sharded_train_step(
    cfg: tm.TransformerConfig,
    mesh,
    optimizer: Optional[Callable] = None,
    grad_accum: int = 1,
    ce_chunk: int = 0,
    skip_nonfinite: bool = False,
    remat_policy: Optional[str] = None,
):
    """The training step over a six-axis ``DeviceMesh``
    (``parallel/topology.make_mesh``). Returns ``(step, init_fn,
    token_sharding)``:

    - ``init_fn(generator) -> (params, opt_state)``: f32 DTensor params
      laid out by ``sharding_specs`` that require grad (every rank passes a
      generator with the same seed), and ``opt_state``, the optimizer
      (AdamW by default) over those DTensor leaves; its moments are made at
      the first update as zeros like their parameter, with its placements,
      as the JAX package's ``opt_shardings`` places them;
    - ``step(params, opt_state, tokens) -> (params, opt_state, loss)``, one
      update in place; ``tokens`` is the global batch as a DTensor
      (``parallel/data.device_put_global``) and ``loss`` the global mean, a
      0-d f32 tensor, the same on every rank;
    - ``token_sharding``: the mesh and placements of the token batch.

    ``grad_accum``, ``ce_chunk``, ``skip_nonfinite`` and ``remat_policy``
    are those of :func:`make_train_step`. Even on a mesh of one device the
    state is DTensors: the one-GPU path is the same code as the N-GPU
    one."""
    cfg = _apply_remat_policy(cfg, remat_policy)
    tm.check_supported(cfg)
    token_sharding = _shardings(cfg, mesh)
    make_opt = optimizer or make_optimizer()

    def init_fn(generator: torch.Generator):
        params = _init_on_mesh(cfg, mesh, generator)
        for leaf in _leaves(params):
            leaf.requires_grad_(True)
        return params, make_opt(_leaves(params))

    def step(params, opt_state, tokens):
        return train_step(params, opt_state, tokens, cfg, mesh=mesh,
                          grad_accum=grad_accum, ce_chunk=ce_chunk,
                          skip_nonfinite=skip_nonfinite)

    return step, init_fn, token_sharding


def make_sharded_eval_step(cfg: tm.TransformerConfig, mesh, ce_chunk: int = 0):
    """Forward-only LM loss under the training layout, for the ``eval``
    CLI. Returns ``(eval_step, init_fn, token_sharding)``: ``init_fn(
    generator) -> params`` laid out by ``sharding_specs`` (a
    checkpoint-restore template), and ``eval_step(params, tokens) -> mean
    next-token CE`` over the global batch, the same on every rank, under
    ``torch.inference_mode()``."""
    tm.check_supported(cfg)
    token_sharding = _shardings(cfg, mesh)

    def init_fn(generator: torch.Generator):
        return _init_on_mesh(cfg, mesh, generator)

    def eval_step(params, tokens) -> torch.Tensor:
        with torch.inference_mode():
            return loss_fn(params, tokens, cfg, mesh, ce_chunk=ce_chunk,
                           include_aux=False)

    return eval_step, init_fn, token_sharding


def _check_lora(cfg: tm.TransformerConfig) -> None:
    if cfg.lora_rank <= 0:
        raise ValueError("the LoRA step needs cfg.lora_rank > 0")


def _trainable_adapters(lora):
    """Set the adapter leaves to require grad; the base keeps none."""
    for leaf in _leaves(lora):
        leaf.requires_grad_(True)
    return lora


def make_lora_train_step(cfg: tm.TransformerConfig,
                         device: str | torch.device = "cuda",
                         optimizer: Optional[Callable] = None, grad_accum: int = 1,
                         ce_chunk: int = 0, remat_policy: Optional[str] = None):
    """LoRA fine-tuning on one device, the counterpart of
    ``make_sharded_lora_train_step``. The base is frozen: it does not
    require grad, so the backward takes no base gradient, and the
    optimizer (AdamW by default) holds the adapters alone. Returns
    ``(step, init_fn)``:

    - ``init_fn(generator) -> (base, lora, opt_state)``: the
      ``init_params`` tree split by ``split_lora_params``;
    - ``step(base, lora, opt_state, tokens) -> (lora, opt_state, loss)``,
      the adapters updated in place.

    ``grad_accum``, ``ce_chunk`` and ``remat_policy`` are those of
    :func:`make_train_step`."""
    cfg = _apply_remat_policy(cfg, remat_policy)
    tm.check_supported(cfg)
    _check_lora(cfg)
    dev = resolve_device(device)
    make_opt = optimizer or make_optimizer()

    def init_fn(generator: torch.Generator):
        base, lora = tm.split_lora_params(tm.init_params(cfg, generator, dev))
        lora = _trainable_adapters(lora)
        return base, lora, make_opt(_leaves(lora))

    def step(base, lora, opt_state, tokens: torch.Tensor):
        _, opt_state, loss = train_step(
            tm.combine_lora_params(base, lora), opt_state, tokens.to(dev), cfg,
            grad_accum=grad_accum, ce_chunk=ce_chunk, trainable=_leaves(lora))
        return lora, opt_state, loss

    return step, init_fn


def make_sharded_lora_train_step(
    cfg: tm.TransformerConfig,
    mesh,
    optimizer: Optional[Callable] = None,
    grad_accum: int = 1,
    ce_chunk: int = 0,
    remat_policy: Optional[str] = None,
):
    """LoRA fine-tuning over a six-axis ``DeviceMesh``, the JAX package's
    ``make_sharded_lora_train_step``: the base and the adapters are
    DTensors laid out by ``sharding_specs``, the base frozen (no
    gradient, so its fsdp gathers run no reduce-scatter), and the
    optimizer's moments are made for the adapters alone. Returns
    ``(step, init_fn, token_sharding)``: ``init_fn(generator) -> (base,
    lora, opt_state)`` and ``step(base, lora, opt_state, tokens) -> (lora,
    opt_state, loss)``, as :func:`make_lora_train_step`'s, with the tokens
    and loss of :func:`make_sharded_train_step`."""
    cfg = _apply_remat_policy(cfg, remat_policy)
    tm.check_supported(cfg)
    _check_lora(cfg)
    token_sharding = _shardings(cfg, mesh)
    make_opt = optimizer or make_optimizer()

    def init_fn(generator: torch.Generator):
        base, lora = tm.split_lora_params(_init_on_mesh(cfg, mesh, generator))
        lora = _trainable_adapters(lora)
        return base, lora, make_opt(_leaves(lora))

    def step(base, lora, opt_state, tokens):
        _, opt_state, loss = train_step(
            tm.combine_lora_params(base, lora), opt_state, tokens, cfg, mesh=mesh,
            grad_accum=grad_accum, ce_chunk=ce_chunk, trainable=_leaves(lora))
        return lora, opt_state, loss

    return step, init_fn, token_sharding
