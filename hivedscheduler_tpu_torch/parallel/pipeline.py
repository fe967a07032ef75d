"""Pipeline parallelism: GPipe microbatches over the ``pp`` mesh axis.

Counterpart of ``hivedscheduler_tpu/parallel/pipeline.py``
(``_pipeline_local``, ``pipeline_apply``) and of the pipeline branch of
its ``forward_with_aux``. Stage s of pp holds the contiguous block of
layers [s L/pp, (s+1) L/pp): the stacked layer leaves are DTensors
sharded over pp on their leading axis (``models/transformer.
sharding_specs``), so a rank's local leaves are its stage's layers.
The rank's rows split into ``cfg.pipeline_microbatches`` microbatches;
stage 0 embeds each, every stage runs its layers (``_apply_layer`` with
the mesh's fsdp, tp, ep and sp collectives, each layer under
``cfg.remat``) and sends the result to stage s + 1, and the last stage
banks the outputs.

The JAX package's semantics are kept: the result on every pp rank is the
last stage's output (its psum over pp), and the MoE aux is summed over
the stages and microbatches, divided by the microbatches and averaged
over the data shards. Inside a stage the MoE statistics are each
microbatch's and data shard's, meaned over sp only
(``MeshShards.in_stage``), as the JAX package's manual stage body takes
them; this is not the aux of the model without the pipeline. JAX's scan
also computes the bubble steps on garbage and masks them out; eager
PyTorch runs only the real steps, with the same results.

Training differentiates the schedule itself (:func:`value_and_grad`):
every microbatch's forward, then every microbatch's backward in reverse
order. Each stage keeps its microbatches' (input, output) pairs, runs
``torch.autograd.grad`` from the gradient the next stage sent (the last
stage: from the loss, which it alone computes) and sends its input's
gradient to the previous stage. The transfers are paired
``batch_isend_irecv`` calls (``ring_attention._Transfer``), matched by
tag, in an order every stage agrees on, never left to autograd's
traversal order. ``embed`` is used by stage 0 only and ``final_norm`` and
``lm_head`` by the last stage; the other stages give them a zero
gradient, which ``MeshShards.sync_grad`` sums over pp.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import torch
import torch.distributed as dist

from hivedscheduler_tpu_torch.models import transformer as tm
from hivedscheduler_tpu_torch.parallel import sharding
from hivedscheduler_tpu_torch.parallel.ring_attention import SeqAxis, _Transfer


def bubble(pp: int, n_micro: int) -> float:
    """The GPipe bubble: the share of a stage's steps that are idle,
    (pp - 1) / (n_micro + pp - 1)."""
    return (pp - 1) / (n_micro + pp - 1)


class Stage:
    """One rank's pipeline stage: its place along pp, how it runs its
    layers, and the transfers to its neighbours."""

    def __init__(self, cfg: tm.TransformerConfig, attn_fn,
                 shards: sharding.MeshShards):
        self.cfg, self.attn_fn = cfg, attn_fn
        self.axis = SeqAxis.from_mesh(shards.mesh, "pp")
        self.first = self.axis.index == 0
        self.last = self.axis.index == self.axis.size - 1
        self.n_micro = cfg.pipeline_microbatches
        self.mesh_shards = shards
        self.shards = shards.in_stage()

    def split(self, tokens: torch.Tensor) -> List[torch.Tensor]:
        """The rank's rows in ``n_micro`` equal microbatches."""
        b = tokens.shape[0]
        if b % self.n_micro:
            raise ValueError(f"local batch {b} not divisible by {self.n_micro} "
                             "microbatches")
        return list(torch.split(tokens, b // self.n_micro))

    def run(self, x: torch.Tensor, positions: torch.Tensor,
            layers: Dict[str, Any]):
        """This stage's ``layers`` (the stacked leaves, the rank's local
        block of them) on one microbatch -> (h, their aux)."""
        return tm.apply_layers(x, tm.layer_leaves(layers), positions, self.cfg,
                               self.attn_fn, self.shards)

    def _like(self, tokens: torch.Tensor) -> torch.Tensor:
        return torch.empty(tokens.shape + (self.cfg.d_model,), dtype=self.cfg.dtype,
                           device=tokens.device)

    def send(self, x: torch.Tensor, step: int, forward: bool = True) -> None:
        """``x`` to the next stage (forward) or the previous (backward)."""
        peer = self.axis.index + (1 if forward else -1)
        _Transfer(self.axis, [(peer, self._tag(step, forward), x)], []).wait()

    def recv(self, tokens: torch.Tensor, step: int, forward: bool = True) -> torch.Tensor:
        """A microbatch of ``tokens``' hidden states (or their gradient)
        from the previous stage (forward) or the next (backward)."""
        peer = self.axis.index + (-1 if forward else 1)
        return _Transfer(self.axis, [], [(peer, self._tag(step, forward),
                                          self._like(tokens))]).wait()[0]

    def _tag(self, step: int, forward: bool) -> int:
        return step if forward else self.n_micro + step

    def aux_total(self, aux_stages: torch.Tensor) -> torch.Tensor:
        """The JAX package's pipelined aux from the stages' sum of their
        microbatches' aux: divided by the microbatches and averaged over the
        data shards (over sp every rank already holds the same value); the
        sum's gradient passes unchanged."""
        aux = aux_stages / self.n_micro
        return self.mesh_shards.sum_over(aux, sharding.DATA_AXES) / _data_count(
            self.mesh_shards)


def _data_count(shards: sharding.MeshShards) -> int:
    return shards.sizes.get("dp", 1) * shards.sizes.get("fsdp", 1)


def forward(params: Dict[str, Any], tokens: torch.Tensor,
            cfg: tm.TransformerConfig, attn_fn,
            shards: sharding.MeshShards):
    """The pipelined layers of ``models.transformer.forward_with_aux``:
    ``tokens`` [B, T] are this rank's rows (its sp slice) -> (the last
    stage's hidden states [B, T, D] before the final norm, on every pp
    rank; the JAX package's pipelined aux). At one stage it is
    differentiable; above one, the stages meet through sends that autograd
    does not see, so it refuses parameters that require grad."""
    stage = Stage(cfg, attn_fn, shards)
    if stage.axis.size > 1 and torch.is_grad_enabled() and any(
            leaf.requires_grad for leaf in params["layers"].values()):
        raise RuntimeError(
            "the pipelined forward over more than one stage is not "
            "differentiable by autograd; differentiate the schedule with "
            "parallel/pipeline.value_and_grad (the train step does)")
    positions = tm.token_positions(tokens, shards)
    outs = []
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for m, micro in enumerate(stage.split(tokens)):
        if stage.first:
            x = tm.embed_tokens(params, micro, cfg, shards)
        else:
            x = stage.recv(micro, m)
        h, layer_aux = stage.run(x, positions, params["layers"])
        aux = aux + layer_aux
        if stage.last:
            outs.append(h)
        else:
            stage.send(h, m)
    if stage.axis.size == 1:
        hidden = torch.cat(outs)
    else:
        hidden = torch.cat(outs) if stage.last else stage._like(tokens)
        dist.broadcast(hidden, src=stage.axis.global_rank(stage.axis.size - 1),
                       group=stage.axis.group)
    return hidden, stage.aux_total(shards.sum_over(aux, ("pp",)))


def value_and_grad(params: Dict[str, Any], tokens: torch.Tensor,
                   cfg: tm.TransformerConfig, mesh, leaves: List[torch.Tensor],
                   head_loss: Callable[[torch.Tensor], torch.Tensor]):
    """(loss, the gradients of ``leaves``) of a pipelined model on this
    rank's rows ``tokens`` (whole sequences; over sp the rank takes its
    slice). ``head_loss(hidden)`` is the cross-entropy, the global mean, of
    the last stage's hidden states [B, T, D] before the final norm, which
    the last stage alone computes. The loss is that mean plus the JAX
    package's pipelined aux, the same on every rank; each gradient is this
    rank's part, which ``MeshShards.sync_grad`` sums over the axes its
    leaf is replicated along (a leaf this stage does not use gets zeros).

    The microbatches' gradients are taken and summed on the leaves' local
    tensors, and each is wrapped as its leaf's DTensor once: DTensor
    arithmetic on the four-dim parameter mesh costs seconds per shape the
    first time (``parallel/sharding.py``)."""
    attn_fn = tm._resolve_attn_fn(cfg, mesh)
    shards = tm.mesh_shards(mesh, cfg)
    tokens = shards.seq_part(sharding.local(tokens))
    stage = Stage(cfg, attn_fn, shards)
    positions = tm.token_positions(tokens, shards)
    by_id = {id(leaf): i for i, leaf in enumerate(leaves)}
    grads: List[Optional[torch.Tensor]] = [None] * len(leaves)

    def add(i: int, g: Optional[torch.Tensor]) -> None:
        if g is not None:
            g = sharding.local(g)
            grads[i] = g if grads[i] is None else grads[i] + g

    # the trainable leaves this stage uses in each microbatch: its layers,
    # and on stage 0 the embedding
    own = [(name, by_id[id(leaf)]) for name, leaf in params["layers"].items()
           if id(leaf) in by_id]
    embed_id = by_id.get(id(params["embed"])) if stage.first else None

    # every microbatch's forward, its graph kept
    records = []
    micros = stage.split(tokens)
    aux_sum = torch.zeros((), dtype=torch.float32, device=tokens.device)
    with torch.enable_grad():
        for m, micro in enumerate(micros):
            # local views whose gradients autograd gives as plain tensors
            layers = {name: sharding.local(leaf)
                      for name, leaf in params["layers"].items()}
            inputs = [layers[name] for name, _ in own]
            if stage.first:
                h_in = None
                embed = sharding.local(params["embed"])
                x = tm.embed_tokens({"embed": embed}, micro, cfg, shards)
                if embed_id is not None:
                    inputs.append(embed)
            else:
                h_in = stage.recv(micro, m).requires_grad_(True)
                x = h_in
                inputs.append(h_in)
            h, aux = stage.run(x, positions, layers)
            aux_sum = aux_sum + aux.detach()
            if not stage.last:
                stage.send(h.detach(), m)
            records.append((inputs, h, aux))
        if stage.last:
            outs = [h for _, h, _ in records]
            ce = head_loss(torch.cat(outs))
            head = [by_id[id(params[k])] for k in ("final_norm", "lm_head")
                    if id(params[k]) in by_id]
            got = torch.autograd.grad(ce, [leaves[i] for i in head] + outs,
                                      allow_unused=True)
            for i, g in zip(head, got):
                add(i, g)
            out_grads = got[len(head):]
    # every microbatch's backward, in reverse order; the aux of each
    # (data shard, microbatch) enters the loss over n_micro x the data
    # shards
    aux_scale = 1.0 / (stage.n_micro * _data_count(shards))
    targets = [i for _, i in own] + ([embed_id] if embed_id is not None else [])
    for m in reversed(range(stage.n_micro)):
        inputs, h, aux = records[m]
        records[m] = None
        g_out = out_grads[m] if stage.last else stage.recv(micros[m], m, forward=False)
        outputs, grad_outputs = [h], [g_out]
        if aux.requires_grad:
            outputs.append(aux)
            grad_outputs.append(torch.full_like(aux, aux_scale))
        got = torch.autograd.grad(outputs, inputs, grad_outputs, allow_unused=True)
        for i, g in zip(targets, got):
            add(i, g)
        if not stage.first:
            stage.send(got[-1], m, forward=False)
    # the loss, the same on every rank: the last stage's cross-entropy
    # (already the global mean) and the pipelined aux
    with torch.no_grad():
        ce_val = ce.detach().float() if stage.last else torch.zeros_like(aux_sum)
        packed = shards.sum_over(torch.stack([ce_val, aux_sum]), ("pp",))
        loss = packed[0] + stage.aux_total(packed[1])
        out = [sharding.like_param(
            g if g is not None else torch.zeros_like(sharding.local(leaf)), leaf)
            for g, leaf in zip(grads, leaves)]
    return loss, out
