"""Continuous-batching serving engine: ragged or paged KV cache, slot
recycling, chunked prefill, prefix cache, int8 KV and fused decode windows.

Counterpart of ``hivedscheduler_tpu/models/serving.py``'s single-engine
path, with its choices kept:

- **Static shapes, ragged content**: one [L, max_batch, max_len, H_kv, D]
  KV cache allocated up front; each row carries its own length in an int32
  device tensor [B], and RoPE and the causal mask take their positions
  from it, so rows at different depths share one batched decode step.
- **Bucketed prefill**: prompts are right-padded to power-of-two buckets,
  the reference's prefill shapes; a prefill writes one row in place.
- **Slot recycling**, **chunked prefill** (``prefill_chunk``) and the
  **prefix cache** (``prefix_cache_size``) as in the reference.
- **Paged KV cache** (``page_size > 0``): one block pool [L, n_blocks,
  block, H_kv, D] shared by every stream, a host-side block table,
  free-list allocator and refcounts; admission gated on free blocks,
  copy-on-write of a shared block, block-boundary prefix entries, and pool
  exhaustion handled by reclaiming cached blocks, then preempting the
  youngest lowest-priority stream. Block 0 is the trash block.
  ``HIVED_PAGED_KV=0`` forces the dense path.
- **int8 KV** (``kv_dtype="int8"``): per-(position, head) absmax scales
  beside the int8 values, carried with their blocks.
- **Fused decode windows** (``decode_steps > 1``): where JAX scans k decode
  iterations in one jitted program, the port captures ONE decode iteration
  (advance, pick, feed the token back, advance the lengths and the
  sampling counts) as a ``torch.cuda.CUDAGraph`` over static buffers and
  replays it k times, then copies the [B, k] tokens to the host once. On
  the CPU the same iteration runs k times eagerly. ``decode_steps == 1`` is
  the eager step, the reference the graph is held to.

Where JAX donates the cache to each jitted program and gets a new one
back, the port writes into the cache's (or pool's) own tensors in place
and never rebinds them: a captured graph holds their addresses, so prefix
restores, copy-on-write and slot bookkeeping all write into the same
tensors.

Sampling draws each token with Gumbel-max (the algorithm of
``jax.random.categorical``) from uniforms made by a counter-based integer
hash of (seed, request id, emitted position, purpose tag, vocabulary
index): a request's sampled stream is a pure function of those and its
logits, independent of its slot, the batch, arrival order and the window
size, as the reference's ``fold_in`` keys make it. The bits differ from
JAX's. Tag 0 draws the tokens; the speculative engine's accept and
residual draws take tags 1 and 2, as JAX's ``_stream_key`` tags them.

**Speculative serving** (``ServingEngine(spec_decode=SpecDecodeConfig(...))``
constructs :class:`SpeculativeServingEngine`): each round a draft model
proposes ``gamma`` tokens a row, the target verifies them in one pass of
``gamma + 1`` tokens at per-row offsets, and each row keeps its own
accepted prefix and correction token. It composes with the paged target,
chunked prefill, the prefix cache and int8 KV, and runs eager.

MoE models serve with the no-drop inference capacity
(``decode.inference_moe_cfg``), so every stream routes as single-request
decode does; the routing has static shapes, so the decode graph captures
it.

The engine reports as the reference does: counters, gauges and
per-priority histograms into ``runtime.metrics.REGISTRY``, ``request/*``
spans on each request's lane while ``obs.trace`` is on, and ``serve_*``
journal events while ``obs.journal`` is on, with a ``serve/<rid>`` request
flight (``record_flights``: admission_wait and prefill legs, one terminal)
for single-engine serving. Every call sits in host code that runs once for
each event: none is inside the fused window's captured iteration, so a
replayed window counts once. Request times are the engine clock's, read
after the host read of the token they stamp.

Left out: the fleet's prefix export and import, and the ``mesh`` layout
(MoE on a mesh with it).
"""

from __future__ import annotations

import dataclasses
import math
import time
from collections import OrderedDict
from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from hivedscheduler_tpu_torch.common import envflags
from hivedscheduler_tpu_torch.models.decode import (
    _layer_params,
    embed_tokens,
    filter_logits,
    final_logits,
    inference_moe_cfg,
    mlp_block,
    qkv_proj,
)
from hivedscheduler_tpu_torch.models.transformer import (
    TransformerConfig,
    _not_yet_ported,
    _rms_norm,
    is_quantized_leaf,
    load_weight,
)
from hivedscheduler_tpu_torch.obs import goodput as obs_goodput
from hivedscheduler_tpu_torch.obs import journal as obs_journal
from hivedscheduler_tpu_torch.obs import trace as obs_trace
from hivedscheduler_tpu_torch.ops.attention import NEG_INF, block_coords, gather_block_kv
from hivedscheduler_tpu_torch.runtime.metrics import REGISTRY as metrics

# -- the counter-based sampler ----------------------------------------------
# 32-bit values held in int64 tensors. Every product below stays under
# 2^49, so no int64 arithmetic overflows and the hash is the same on the
# CPU and on the card.
_MASK32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9
# spreads the small purpose tags over 32 bits (an odd multiplier)
_TAG_MUL = 0x85EBCA77


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for x in [0, 2^32), in 16-bit halves of c."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _MASK32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """MurmurHash3's 32-bit finalizer, a bijection on [0, 2^32)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def stream_uniforms(seed: int, rids: torch.Tensor, counts: torch.Tensor,
                    vocab: int, tag: int = 0) -> torch.Tensor:
    """Uniforms in (0, 1), f32 [B, vocab]: entry (b, j) is a hash of
    (seed, tag, rids[b], counts[b], j) alone. ``tag`` names the draw's
    purpose: tag 0 (the tokens) hashes no tag at all, so its draws are
    those of an untagged sampler. Built from int64 tensor ops, so a CUDA
    graph can capture it."""
    h = _mix32(torch.full_like(rids, ((seed & _MASK32) ^ _GOLDEN)))
    if tag:
        h = _mix32(h ^ ((tag * _TAG_MUL) & _MASK32))
    h = _mix32(h ^ (rids & _MASK32))
    h = _mix32(h ^ (counts & _MASK32))
    j = torch.arange(vocab, dtype=torch.long, device=rids.device)
    x = _mix32(_mix32(h[:, None] ^ j[None, :]) ^ _GOLDEN)
    # 23 bits: (n + 0.5) / 2^23 is exact in f32 and never 0 or 1
    return ((x >> 9).float() + 0.5) * (1.0 / 8388608.0)


def sample_rows(logits: torch.Tensor, rids: torch.Tensor, counts: torch.Tensor,
                seed: int, temperature: float, top_k: int,
                top_p: float) -> torch.Tensor:
    """One token per row of ``logits`` [B, V] by Gumbel-max over the
    filtered logits: argmax(filtered + g), g = -log(-log(u)) with ``u``
    from :func:`stream_uniforms`. The row's draw is a pure function of
    (seed, rid, count, its logits)."""
    filtered = filter_logits(
        logits / temperature if temperature > 0.0 else logits, top_k, top_p)
    return gumbel_argmax(filtered, rids, counts, seed)


def gumbel_argmax(logits: torch.Tensor, rids: torch.Tensor, counts: torch.Tensor,
                  seed: int, tag: int = 0) -> torch.Tensor:
    """argmax(logits + g) over the last dim, g = -log(-log(u)) with ``u``
    from :func:`stream_uniforms` under ``tag``: one categorical draw a row
    from ``logits`` [B, V], which may hold NEG_INF entries."""
    u = stream_uniforms(seed, rids, counts, logits.shape[-1], tag)
    return torch.argmax(logits + -torch.log(-torch.log(u)), dim=-1)


# -- the dense ragged cache ---------------------------------------------------
class RaggedCache(NamedTuple):
    """KV cache with a per-row length: k/v [L, B, M, H_kv, D], lengths int32
    [B] on the cache's device. With int8 KV, k/v hold the quantized values
    and ``k_scale``/``v_scale`` [L, B, M, H_kv] the per-(position, head)
    absmax scales, which factor out of both attention einsums. The tensors
    are written in place."""

    k: torch.Tensor
    v: torch.Tensor
    lengths: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None


def _check_kv_dtype(kv_dtype: Optional[str]) -> None:
    if kv_dtype not in (None, "int8"):
        raise ValueError(f"kv_dtype must be None or 'int8', got {kv_dtype!r}")


def init_ragged_cache(cfg: TransformerConfig, max_batch: int, max_len: int,
                      kv_dtype: Optional[str] = None,
                      device: str | torch.device = "cpu") -> RaggedCache:
    _check_kv_dtype(kv_dtype)
    shape = (cfg.n_layers, max_batch, max_len, cfg.kv_heads, cfg.head_dim)
    lengths = torch.zeros((max_batch,), dtype=torch.int32, device=device)
    if kv_dtype == "int8":
        return RaggedCache(
            k=torch.zeros(shape, dtype=torch.int8, device=device),
            v=torch.zeros(shape, dtype=torch.int8, device=device),
            lengths=lengths,
            k_scale=torch.zeros(shape[:-1], dtype=torch.float32, device=device),
            v_scale=torch.zeros(shape[:-1], dtype=torch.float32, device=device),
        )
    return RaggedCache(k=torch.zeros(shape, dtype=cfg.dtype, device=device),
                       v=torch.zeros(shape, dtype=cfg.dtype, device=device),
                       lengths=lengths)


def _extract_rows(cache: RaggedCache, slot: int, pb: int):
    """A copy of row ``slot``'s [0:pb] KV (values and scales): cloned,
    since a slice is a view of the row the next prefill overwrites."""
    return tuple(t[:, slot, :pb].clone() for t in _kv_tensors(cache))


def _restore_rows(cache: RaggedCache, slot: int, payload) -> None:
    """Write a payload of :func:`_extract_rows` back into row ``slot``."""
    for t, part in zip(_kv_tensors(cache), payload):
        t[:, slot, :part.shape[1]].copy_(part)


def _quant_kv(x: torch.Tensor):
    """Symmetric per-(token, head) absmax int8: x [..., H_kv, D] -> (int8
    values, f32 scales [..., H_kv]). ``torch.round`` rounds half to even,
    as ``jnp.round`` does."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1), min=1e-8) / 127.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale


def _ragged_attention(q, ck, cv, positions, scale, ck_scale=None, cv_scale=None):
    """q [B, S, H, D] at absolute per-row positions [B, S]; ck/cv [B, M,
    H_kv, D]. Causal mask per row: key_pos <= position. Scores and p·v in
    f32, as JAX's ``preferred_element_type=f32``; with int8 KV the per-key
    scales multiply the score rows (k) and weight the probability columns
    (v), which is dequantization without a dequantized copy."""
    b, s_len, h, d = q.shape
    m_len, h_kv = ck.shape[1], ck.shape[2]
    qg = q.reshape(b, s_len, h_kv, h // h_kv, d)
    s = torch.einsum("bshgd,bmhd->bhgsm", qg.float(), ck.float()) * scale
    if ck_scale is not None:
        s = s * ck_scale.permute(0, 2, 1)[:, :, None, None, :]
    key_pos = torch.arange(m_len, device=q.device)
    mask = key_pos[None, None, :] <= positions[:, :, None]  # [B, S, M]
    s = torch.where(mask[:, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    if cv_scale is not None:
        p = p * cv_scale.permute(0, 2, 1)[:, :, None, None, :]
    o = torch.einsum("bhgsm,bmhd->bshgd", p, cv.float())
    return o.reshape(b, s_len, h, d).to(q.dtype)


def _layer_tail(x, lp, attn, cfg):
    """Output projection and the MLP block of one layer (``cfg`` with the
    no-drop inference capacity for MoE)."""
    x = x + torch.einsum("bshk,hkd->bsd", attn, load_weight(lp["wo"], cfg.dtype))
    return x + mlp_block(lp, _rms_norm(x, lp["mlp_norm"]), cfg)


def _project(lp, x, positions, cfg, quantized):
    """Norm, q/k/v with RoPE, and the values to store (int8 and scales
    when the cache is quantized)."""
    h = _rms_norm(x, lp["attn_norm"])
    q, k_new, v_new = qkv_proj(lp, h, positions, cfg.rope_theta, cfg.dtype)
    if quantized:
        return q, _quant_kv(k_new), _quant_kv(v_new)
    return q, (k_new, None), (v_new, None)


@torch.no_grad()
def advance_ragged(
    params: Dict[str, Any],
    cache: RaggedCache,
    tokens: torch.Tensor,
    cfg: TransformerConfig,
    row: Optional[int] = None,
    start: Optional[int] = None,
):
    """Absorb ``tokens`` and return (logits [B_t, S, vocab] f32, cache).

    - decode (``row is None``): tokens [B, S], every row at its own
      ``cache.lengths[b]``; the lengths then advance by S, clamped at
      max_len;
    - prefill (``row`` given): tokens [1, S] written into row ``row`` from
      position ``start`` (0 when omitted); the caller sets the row's length.

    The cache's tensors are written in place and the same cache comes back.

    The arena edge: idle rows advance with every decode step and their
    lengths clamp at max_len, where JAX's scatter drops the one
    out-of-bounds index. Torch would raise on the CPU and assert on the
    card, so the decode scatter index is clamped at max_len - 1 instead.
    The entry it overwrites is dead: a real query sits at a position <=
    prompt + budget - 2 <= max_len - 2 (the last emitted token is never
    fed back), so position max_len - 1 is only ever attended by padded or
    idle rows, whose outputs are discarded; the reference's parked rows
    write their garbage at max_len - 1 too.
    """
    cfg = inference_moe_cfg(cfg)  # routing-exact: no-drop capacity
    _, s_len = tokens.shape
    m_len = cache.k.shape[2]
    dev = tokens.device
    steps = torch.arange(s_len, device=dev)
    if row is None:
        positions = cache.lengths[:, None].long() + steps[None, :]
        widx = torch.clamp(positions, max=m_len - 1)
        rows = torch.arange(cache.k.shape[1], device=dev)[:, None]
    else:
        off = 0 if start is None else int(start)
        if off + s_len > m_len:
            raise ValueError(f"prefill of {s_len} tokens at {off} overruns the "
                             f"{m_len}-position arena")
        positions = (off + steps)[None, :]
    x = embed_tokens(params, tokens, cfg.dtype)
    scale = 1.0 / math.sqrt(cfg.head_dim)
    quantized = cache.quantized
    for i in range(cfg.n_layers):
        lp = _layer_params(params["layers"], i)
        q, (k_q, k_s), (v_q, v_s) = _project(lp, x, positions, cfg, quantized)
        bufs = [cache.k[i], cache.v[i]]
        vals = [k_q, v_q]
        if quantized:
            bufs += [cache.k_scale[i], cache.v_scale[i]]
            vals += [k_s, v_s]
        for buf, val in zip(bufs, vals):
            if row is None:
                buf[rows, widx] = val.to(buf.dtype)
            else:
                buf[row, off:off + s_len] = val[0].to(buf.dtype)
        att = bufs if row is None else [t[row:row + 1] for t in bufs]
        scales = att[2:] if quantized else [None, None]
        attn = _ragged_attention(q, att[0], att[1], positions, scale, *scales)
        x = _layer_tail(x, lp, attn, cfg)
    logits = final_logits(params, x, cfg.dtype)
    if row is None:
        cache.lengths.copy_(torch.clamp(cache.lengths + s_len, max=m_len))
    return logits, cache


# -- the paged pool -----------------------------------------------------------
class PagedKVPool(NamedTuple):
    """Paged KV: one block pool per layer, k/v [L, n_blocks, block, H_kv,
    D], shared by every stream. Block 0 is the trash block: every
    unassigned block-table entry points at it, so clamped idle scatters and
    padded-prefill garbage land where no live position maps. Lengths and
    block tables are host state of the engine. With int8 KV the scale pools
    [L, n_blocks, block, H_kv] travel with their blocks."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None


def init_paged_pool(cfg: TransformerConfig, n_blocks: int, block: int,
                    kv_dtype: Optional[str] = None,
                    device: str | torch.device = "cpu") -> PagedKVPool:
    _check_kv_dtype(kv_dtype)
    shape = (cfg.n_layers, n_blocks, block, cfg.kv_heads, cfg.head_dim)
    if kv_dtype == "int8":
        return PagedKVPool(
            k=torch.zeros(shape, dtype=torch.int8, device=device),
            v=torch.zeros(shape, dtype=torch.int8, device=device),
            k_scale=torch.zeros(shape[:-1], dtype=torch.float32, device=device),
            v_scale=torch.zeros(shape[:-1], dtype=torch.float32, device=device),
        )
    return PagedKVPool(k=torch.zeros(shape, dtype=cfg.dtype, device=device),
                       v=torch.zeros(shape, dtype=cfg.dtype, device=device))


@torch.no_grad()
def advance_paged(
    params: Dict[str, Any],
    pool: PagedKVPool,
    tokens: torch.Tensor,
    cfg: TransformerConfig,
    table: torch.Tensor,
    lengths: Optional[torch.Tensor] = None,
    row: Optional[int] = None,
    start: Optional[int] = None,
):
    """Paged twin of :func:`advance_ragged`: absorb ``tokens`` through the
    block table and return (logits [B_t, S, vocab] f32, pool).

    Decode (``row is None``): tokens [B, S] at per-row positions from
    ``lengths`` [B]. Prefill (``row`` given): tokens [1, S] written through
    ``table[row]`` from ``start``. New k/v scatter at :func:`block_coords`
    (clamped); the read is :func:`gather_block_kv` over the row's table,
    whose axis 1 is the logical position, so :func:`_ragged_attention`
    applies unchanged. Length bookkeeping is the caller's."""
    cfg = inference_moe_cfg(cfg)  # routing-exact: no-drop capacity
    _, s_len = tokens.shape
    block = pool.k.shape[2]
    steps = torch.arange(s_len, device=tokens.device)
    if row is None:
        positions = lengths[:, None].long() + steps[None, :]
        tbl = table
    else:
        positions = ((0 if start is None else int(start)) + steps)[None, :]
        tbl = table[row:row + 1]
    wblk, woff = block_coords(positions, tbl, block)
    x = embed_tokens(params, tokens, cfg.dtype)
    scale = 1.0 / math.sqrt(cfg.head_dim)
    quantized = pool.quantized
    for i in range(cfg.n_layers):
        lp = _layer_params(params["layers"], i)
        q, (k_q, k_s), (v_q, v_s) = _project(lp, x, positions, cfg, quantized)
        bufs = [pool.k[i], pool.v[i]]
        vals = [k_q, v_q]
        if quantized:
            bufs += [pool.k_scale[i], pool.v_scale[i]]
            vals += [k_s, v_s]
        # scatter before the gather: the view must hold this call's tokens
        for buf, val in zip(bufs, vals):
            buf[wblk, woff] = val.to(buf.dtype)
        att = [gather_block_kv(buf, tbl) for buf in bufs]
        scales = att[2:] if quantized else [None, None]
        attn = _ragged_attention(q, att[0], att[1], positions, scale, *scales)
        x = _layer_tail(x, lp, attn, cfg)
    return final_logits(params, x, cfg.dtype), pool


# -- requests -----------------------------------------------------------------
class EngineDraining(RuntimeError):
    """Raised by ``submit()`` once ``begin_drain()`` was called: the engine
    finishes in-flight work but admits nothing new (a front end's 503 with
    ``Retry-After``)."""


@dataclasses.dataclass
class Request:
    """One serving request; ``tokens_out`` fills as the engine runs.

    ``finish_reason``: "eos", "length", "shed" (queue-wait deadline passed
    before admission; no tokens) or "preempted" (drain deadline or pool
    exhaustion; the stream is truncated). ``priority``: higher is admitted
    first, FIFO within a level; strict priority starves lower levels unless
    the engine ages waiters (``age_boost_secs``) or sheds them
    (``queue_timeout_s``). Times are the engine clock's."""

    rid: int
    prompt: List[int]
    max_new_tokens: int
    tokens_out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    finish_reason: Optional[str] = None
    priority: int = 0
    submitted_at: float = 0.0
    admitted_at: Optional[float] = None
    first_token_at: Optional[float] = None
    done_at: Optional[float] = None
    # request flight (obs/journal.py REQUEST_LEGS): the journal key the
    # admission and first-token marks attribute into. ``flight_decode``
    # names the first-token leg ``first_decode`` (a decode leg after a KV
    # handoff) instead of ``prefill``; ``flight_local`` means this engine
    # owns the terminal (set by ``record_flights``)
    flight: Optional[str] = None
    flight_decode: bool = False
    flight_local: bool = False

    @property
    def ttft_s(self) -> Optional[float]:
        if self.first_token_at is None:
            return None
        return self.first_token_at - self.submitted_at

    @property
    def queue_wait_s(self) -> Optional[float]:
        if self.admitted_at is None:
            return None
        return self.admitted_at - self.submitted_at

    @property
    def tpot_s(self) -> Optional[float]:
        """Mean seconds per output token after the first (None until done
        or when only one token was emitted)."""
        if self.done_at is None or self.first_token_at is None:
            return None
        n = len(self.tokens_out) - 1
        if n <= 0:
            return None
        return (self.done_at - self.first_token_at) / n


def _kv_tensors(store) -> List[torch.Tensor]:
    """k, v and, when quantized, their scales, of a cache or a pool."""
    return [t for t in (store.k, store.v, store.k_scale, store.v_scale)
            if t is not None]


def _params_device(params: Dict[str, Any]) -> torch.device:
    emb = params["embed"]
    return (emb["qi8"] if is_quantized_leaf(emb) else emb).device


class DecodeWindow:
    """Static buffers of the fused decode window and, on a CUDA card, the
    graph of one decode iteration over them: the last tokens, the sampling
    coordinates (rids, counts), the paged block table and lengths, and
    ``toks`` [B, decode_steps], a shift register whose last k columns hold
    a k-iteration window's tokens in order. The graph also holds the
    addresses of the engine's params and cache or pool, which is why those
    are never rebound; :meth:`check_bound` raises if they were."""

    def __init__(self, engine: "ServingEngine"):
        b = engine.max_batch
        i64 = dict(dtype=torch.long, device=engine.device)
        self.last = torch.zeros(b, **i64)
        self.rids = torch.zeros(b, **i64)
        self.counts = torch.zeros(b, **i64)
        self.toks = torch.zeros(b, engine.decode_steps, **i64)
        self.table = self.lens = None
        if engine.paged:
            self.table = torch.zeros(b, engine._blocks_per_slot, **i64)
            self.lens = torch.zeros(b, **i64)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self._bound = (engine.params, engine.cache, engine.pool)

    def check_bound(self, engine: "ServingEngine") -> None:
        now = (engine.params, engine.cache, engine.pool)
        if any(a is not b for a, b in zip(now, self._bound)):
            raise RuntimeError("the engine's params, cache or pool were rebound "
                               "after the decode graph captured their addresses")


class ServingEngine:
    """Continuous-batching engine: ``submit()`` enqueues requests at any
    time; each ``step()`` admits queued requests into free slots (bucketed
    prefill), ticks chunked prefills and advances every decoding slot by
    one token, or by a fused window of up to ``decode_steps``.
    ``run_until_drained()`` loops until every request finished. Greedy or
    temperature/top-k/top-p sampling with counter-based draws.

    Arguments as in the reference (``prefix_cache_size``,
    ``prefill_chunk``, ``kv_dtype``, ``queue_timeout_s``,
    ``age_boost_secs``, ``decode_steps``, ``page_size``/``num_blocks``,
    ``clock``). The device is the params'. ``spec_decode`` (a
    ``models.speculative.SpecDecodeConfig``) constructs the speculative
    engine, :class:`SpeculativeServingEngine`, with the same arguments.
    ``mesh`` is not yet ported and raises."""

    # single-engine request flights: submit() opens a serve/<rid> flight
    # in the journal and the engine owns its terminal (the serve CLI sets
    # this with --journal-file or HIVED_JOURNAL)
    record_flights = False

    def __new__(cls, *args, **kw):
        # speculative serving is a mode of this constructor: spec_decode=
        # routes construction to the subclass, whose __init__ then takes
        # the same arguments
        if cls is ServingEngine and kw.get("spec_decode") is not None:
            return super().__new__(SpeculativeServingEngine)
        return super().__new__(cls)

    def __init__(
        self,
        params,
        cfg: TransformerConfig,
        max_batch: int = 8,
        max_len: int = 512,
        temperature: float = 0.0,
        top_k: int = 0,
        top_p: float = 1.0,
        eos_id: Optional[int] = None,
        seed: int = 0,
        mesh=None,
        prefix_cache_size: int = 0,
        prefill_chunk: int = 0,
        kv_dtype: Optional[str] = None,
        queue_timeout_s: Optional[float] = None,
        age_boost_secs: Optional[float] = None,
        decode_steps: int = 1,
        page_size: int = 0,
        num_blocks: int = 0,
        spec_decode=None,
        clock=time.perf_counter,
    ):
        if mesh is not None:
            raise _not_yet_ported("the serving mesh layout (mesh=)")
        if decode_steps < 1:
            raise ValueError(f"decode_steps must be >= 1, got {decode_steps}")
        _check_kv_dtype(kv_dtype)
        self.params = params
        self.cfg = cfg
        self.device = _params_device(params)
        self.queue_timeout_s = queue_timeout_s
        self.age_boost_secs = age_boost_secs
        self._clock = clock
        self.max_batch = max_batch
        self.max_len = max_len
        self.temperature = temperature
        self.top_k = top_k
        self.top_p = top_p
        self.eos_id = eos_id
        self.seed = seed
        self.kv_dtype = kv_dtype
        self.page_size = max(0, page_size)
        self.paged = (self.page_size > 0
                      and envflags.get("HIVED_PAGED_KV", "1") != "0")
        if self.paged:
            self._blocks_per_slot = -(-max_len // self.page_size)
            if num_blocks <= 0:
                # capacity parity with the dense slabs (+ the trash block)
                num_blocks = max_batch * self._blocks_per_slot + 1
            if num_blocks < self._blocks_per_slot + 1:
                raise ValueError(
                    f"num_blocks {num_blocks} cannot back one max_len "
                    f"stream: need >= ceil(max_len/page_size) + 1 "
                    f"(= {self._blocks_per_slot + 1}, incl. the reserved "
                    f"trash block)")
            self.num_blocks = num_blocks
            # parked and idle rows write at the last addressable position,
            # at or past every live row's length
            self._park_pos = self._blocks_per_slot * self.page_size - 1
            self.pool = init_paged_pool(cfg, num_blocks, self.page_size,
                                        kv_dtype, self.device)
            self._table = np.zeros((max_batch, self._blocks_per_slot), np.int32)
            self._host_len = np.full((max_batch,), self._park_pos, np.int32)
            self._slot_bids: List[List[int]] = [[] for _ in range(max_batch)]
            self._free: List[int] = list(range(1, num_blocks))
            self._ref = np.zeros((num_blocks,), np.int64)
            self.blocks_cow = 0
            self.pool_preempted = 0
            self.prefix_block_hits = 0
            self.cache = None
        else:
            self.pool = None
            self.cache = init_ragged_cache(cfg, max_batch, max_len, kv_dtype,
                                           self.device)
        self.slots: List[Optional[Request]] = [None] * max_batch
        # host staging of the per-row feedback tokens: one upload a step
        self._last_host = [0] * max_batch
        self.queue: List[Request] = []
        self.draining = False
        self._next_rid = 0
        self.steps = 0  # decode steps executed (for occupancy)
        self.slot_steps = 0  # sum of active slots over decode steps
        self.prefill_chunk = max(0, prefill_chunk)
        # slot -> (tail tokens, prefix length, tokens absorbed): in-flight
        # chunked prefills; these slots are occupied but not yet decoding
        self._prefilling: Dict[int, tuple] = {}
        self.prefill_chunks_done = 0
        self.decode_steps = decode_steps
        self.fused_windows = 0  # multi-step windows executed (k > 1)
        self.graph_windows = 0  # of which replayed from the CUDA graph
        self._window: Optional[DecodeWindow] = None
        # prompt tuple -> (payload, true length), LRU order
        self.prefix_cache_size = max(0, prefix_cache_size)
        self._prefix_cache: "OrderedDict[tuple, tuple]" = OrderedDict()
        self.prefix_hits = 0
        self.prefix_tokens_reused = 0

    # -- sampling ----------------------------------------------------------
    def _sample(self, logits, rids, counts):
        return sample_rows(logits, rids, counts, self.seed, self.temperature,
                           self.top_k, self.top_p)

    def _sample_coords(self, reqs):
        """Per-row (rid, emitted count) tensors for the sampler; idle rows
        get zeros (their draws are never read)."""
        rids = np.zeros(len(reqs), np.int64)
        counts = np.zeros(len(reqs), np.int64)
        for i, r in enumerate(reqs):
            if r is not None:
                rids[i], counts[i] = r.rid, len(r.tokens_out)
        return (torch.from_numpy(rids).to(self.device),
                torch.from_numpy(counts).to(self.device))

    def _pick(self, logits_row, req: Request) -> int:
        if self.temperature == 0.0:
            return int(torch.argmax(logits_row))
        return int(self._sample(logits_row[None], *self._sample_coords([req]))[0])

    def _pick_batch(self, logits, reqs) -> List[int]:
        """A token for every row with ONE device-to-host transfer."""
        if self.temperature == 0.0:
            return torch.argmax(logits, dim=-1).tolist()
        return self._sample(logits, *self._sample_coords(reqs)).tolist()

    # -- paged block allocator (host side; the pool is the device state) ---
    #
    # Invariants (chaos.invariants.check_block_pool):
    # - block 0 (trash) is never allocated, never refcounted;
    # - every other block is either free (ref 0) or referenced, its ref the
    #   number of slot tables plus prefix-cache entries that hold it;
    # - a slot's table row is exactly its bids, then trash;
    # - a block a stream writes into has ref 1 (copy-on-write first).

    @property
    def blocks_in_use(self) -> int:
        return (self.num_blocks - 1 - len(self._free)) if self.paged else 0

    def _table_dev(self) -> torch.Tensor:
        return torch.from_numpy(self._table.astype(np.int64)).to(self.device)

    def _len_dev(self) -> torch.Tensor:
        return torch.from_numpy(self._host_len.astype(np.int64)).to(self.device)

    def _blocks_admit(self, req: Request, hit) -> bool:
        """Admission by block availability: the prompt needs ``cover -
        full_shared`` new blocks (fresh tail blocks, plus the copy of a
        partly shared boundary block) and one spare when the first decode
        token starts a fresh block. LRU cached prefix blocks are reclaimed
        for room (never the matched entry); False leaves the waiter at the
        head of the queue."""
        bs = self.page_size
        plen = hit[1][1] if hit is not None else 0
        cover = -(-len(req.prompt) // bs)
        want = cover - plen // bs
        if len(req.prompt) % bs == 0:
            want += 1
        protect = hit[0] if hit is not None else None
        while len(self._free) < want and self._reclaim_cache_block(protect):
            pass
        return len(self._free) >= want

    def _reclaim_cache_block(self, protect=None) -> bool:
        """Evict ONE LRU prefix-cache entry (never ``protect``). Its blocks
        free only when no live stream still shares them."""
        for key in list(self._prefix_cache):  # LRU first
            if key == protect:
                continue
            payload, _plen = self._prefix_cache.pop(key)
            self._drop_entry(payload)
            return True
        return False

    def _preempt_for_blocks(self, protect_slot: Optional[int]) -> bool:
        """Last resort under pool pressure: finish the youngest stream of
        the lowest priority (never ``protect_slot``) as "preempted" and
        free its blocks."""
        victims = [s for s in range(self.max_batch)
                   if s != protect_slot and self.slots[s] is not None
                   and self._slot_bids[s]]
        if not victims:
            return False
        victim = max(victims, key=lambda s: (
            -self.slots[s].priority, self.slots[s].admitted_at or 0.0))
        req = self.slots[victim]
        req.done = True
        req.done_at = self._clock()
        req.finish_reason = "preempted"
        if obs_journal.JOURNAL.enabled:
            obs_journal.emit("serve_preempt", f"serve/{req.rid}",
                             slot=victim, priority=req.priority)
        self._observe_request(req)
        metrics.inc("tpu_hive_serve_pool_preempted_total")
        self.pool_preempted += 1
        self._retire(victim)
        return True

    def _alloc_block(self, protect_slot: Optional[int] = None) -> int:
        while not self._free:
            if self._reclaim_cache_block():
                continue
            if not self._preempt_for_blocks(protect_slot):
                raise RuntimeError(
                    "paged KV pool exhausted with nothing reclaimable: "
                    "num_blocks cannot back even one stream")
        bid = self._free.pop()
        self._ref[bid] = 1
        return bid

    def _decref(self, bid: int) -> None:
        self._ref[bid] -= 1
        assert self._ref[bid] >= 0, f"negative refcount on block {bid}"
        if self._ref[bid] == 0:
            self._free.append(bid)

    def _copy_block(self, src: int, dst: int) -> None:
        """Copy-on-write: block ``src`` into ``dst`` in every layer, values
        and scales, as a real copy (never a view)."""
        for t in _kv_tensors(self.pool):
            t[:, dst].copy_(t[:, src])

    def _ensure_writable(self, slot: int, lo: int, hi: int) -> None:
        """Make positions [lo, hi] of ``slot`` writable: allocate blocks to
        hi's cover and copy any block in the range that is still shared.
        Every write path runs through this first."""
        bs = self.page_size
        bids = self._slot_bids[slot]
        hi_cover = min(hi // bs + 1, self._blocks_per_slot)
        while len(bids) < hi_cover:
            bid = self._alloc_block(slot)
            self._table[slot, len(bids)] = bid
            bids.append(bid)
        for j in range(max(0, lo // bs), hi_cover):
            if self._ref[bids[j]] > 1:
                dst = self._alloc_block(slot)
                self._copy_block(bids[j], dst)
                self._decref(bids[j])
                bids[j] = dst
                self._table[slot, j] = dst
                self.blocks_cow += 1
                metrics.inc("tpu_hive_serve_block_cow_total")

    def _trim_blocks(self, slot: int, keep_tokens: int) -> None:
        """Roll the table back past ``keep_tokens``: the blocks beyond go
        back to the pool, no copy."""
        keep = -(-keep_tokens // self.page_size)
        bids = self._slot_bids[slot]
        while len(bids) > keep:
            bid = bids.pop()
            self._table[slot, len(bids)] = 0
            self._decref(bid)

    def _release_blocks(self, slot: int) -> None:
        for bid in self._slot_bids[slot]:
            self._decref(bid)
        self._slot_bids[slot] = []
        self._table[slot, :] = 0
        self._host_len[slot] = self._park_pos

    def _retire(self, slot: int) -> None:
        """Free the slot (finished or preempted): the one home of the
        recycle, so a retired row cannot leak its blocks."""
        self.slots[slot] = None
        self._prefilling.pop(slot, None)
        if self.paged:
            self._release_blocks(slot)

    def _set_row_length(self, slot: int, n: int) -> None:
        if self.paged:
            self._host_len[slot] = n
        else:
            self.cache.lengths[slot] = n

    def _run_prefill(self, slot: int, tokens, start: int):
        """One (possibly offset) prefill through the active backend; the
        [S, vocab] logits."""
        if self.paged:
            logits, _ = advance_paged(self.params, self.pool, tokens, self.cfg,
                                      self._table_dev(), row=slot, start=start)
        else:
            logits, _ = advance_ragged(self.params, self.cache, tokens, self.cfg,
                                       row=slot, start=start)
        return logits[0]

    def _store_payload(self, slot: int, bids, plen: int):
        """The paged prefix-cache entry of ``slot``'s first ``plen`` tokens:
        its shared block ids (the speculative engine bundles a copy of the
        draft's KV beside them)."""
        return tuple(bids)

    def _drop_entry(self, payload) -> None:
        """Release one evicted prefix-cache entry's block references."""
        if self.paged:
            for bid in self._entry_bids(payload):
                self._decref(bid)

    def _entry_bids(self, payload):
        """The block ids a paged prefix-cache entry holds references on."""
        return payload

    # -- request lifecycle -------------------------------------------------
    def submit(self, prompt: List[int], max_new_tokens: int,
               priority: int = 0) -> Request:
        """Enqueue a request: higher ``priority`` is admitted first (FIFO
        within a level; running rows are never preempted for it)."""
        if self.draining:
            metrics.inc("tpu_hive_serve_drain_rejected_total")
            raise EngineDraining(
                "engine is draining (preemption requested): new requests "
                "are rejected; retry on another replica")
        if not prompt:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
        if len(prompt) + max_new_tokens > self.max_len:
            raise ValueError(f"prompt {len(prompt)} + max_new {max_new_tokens} "
                             f"exceeds max_len {self.max_len}")
        req = Request(self._next_rid, list(prompt), max_new_tokens,
                      priority=priority, submitted_at=self._clock())
        self._next_rid += 1
        if self.record_flights and obs_journal.JOURNAL.enabled:
            # single-engine flight: this engine owns the whole request path,
            # terminal included
            req.flight = f"serve/{req.rid}"
            req.flight_local = True
            obs_journal.note_request_submit(
                req.flight, at=req.submitted_at, priority=priority,
                promptTokens=len(req.prompt))
        # insert before the first strictly lower-priority waiter
        at = len(self.queue)
        for i, w in enumerate(self.queue):
            if w.priority < priority:
                at = i
                break
        self.queue.insert(at, req)
        if obs_journal.JOURNAL.enabled:
            obs_journal.emit("serve_submit", f"serve/{req.rid}",
                             priority=priority, promptTokens=len(req.prompt))
        return req

    def _bucket(self, n: int) -> int:
        return min(self.max_len, 1 << max(1, (n - 1).bit_length()))

    def _match_prefix(self, prompt: List[int]):
        """Longest cached prompt that strictly prefixes ``prompt`` and whose
        bucketed tail write stays inside the arena."""
        best = None
        for key, entry in self._prefix_cache.items():
            plen = entry[1]
            if plen >= len(prompt) or (best is not None and plen <= best[1][1]):
                continue
            if list(key) == prompt[:len(key)]:
                if plen + self._bucket(len(prompt) - plen) > self.max_len:
                    continue
                best = (key, entry)
        if best is not None:
            self._prefix_cache.move_to_end(best[0])  # LRU touch
        return best

    def _prefix_extract(self, slot: int, pb: int):
        """A copy of slot ``slot``'s [0:pb] KV, the dense prefix payload."""
        return _extract_rows(self.cache, slot, pb)

    def _prefix_restore(self, slot: int, payload) -> None:
        """Write a cached payload back into ``slot``. Paged: the payload is
        the shared block ids; the slot takes a reference on each, with no
        device copy (copy-on-write splits them on write)."""
        if self.paged:
            bids = list(payload)
            assert not self._slot_bids[slot], "restore into an occupied row"
            for j, bid in enumerate(bids):
                self._ref[bid] += 1
                self._table[slot, j] = bid
            self._slot_bids[slot] = bids
            self.prefix_block_hits += len(bids)
            metrics.inc("tpu_hive_serve_prefix_block_hits_total", len(bids))
            return
        _restore_rows(self.cache, slot, payload)

    def _store_prefix(self, slot: int, prompt: List[int]) -> None:
        """Cache the row's KV under the full prompt and under interior
        boundaries: power-of-two lengths for the dense path (each a real
        copy), every full-block boundary for the paged path (refcounts on
        the live blocks)."""
        pl = len(prompt)
        lens = {pl}
        if self.paged:
            pb = self.page_size
            while pb < pl:
                lens.add(pb)
                pb += self.page_size
        else:
            pb = 2
            while pb < pl:
                lens.add(pb)
                pb <<= 1
        # ascending and capped: the longest insert last, so LRU eviction
        # drops the short ones first
        for plen in sorted(lens)[-self.prefix_cache_size:]:
            key = tuple(prompt[:plen])
            if key in self._prefix_cache:
                self._prefix_cache.move_to_end(key)
                continue
            if self.paged:
                bids = self._slot_bids[slot][: -(-plen // self.page_size)]
                for bid in bids:
                    self._ref[bid] += 1
                payload = self._store_payload(slot, bids, plen)
            else:
                payload = self._prefix_extract(slot, self._bucket(plen))
            self._prefix_cache[key] = (payload, plen)
        while len(self._prefix_cache) > self.prefix_cache_size:
            _, (payload, _plen) = self._prefix_cache.popitem(last=False)
            self._drop_entry(payload)

    def _shed_expired(self) -> None:
        """Queue-wait deadline: finish expired waiters as "shed" before
        admission."""
        if self.queue_timeout_s is None or not self.queue:
            return
        now = self._clock()
        kept: List[Request] = []
        for req in self.queue:
            if now - req.submitted_at > self.queue_timeout_s:
                req.done = True
                req.done_at = now
                req.finish_reason = "shed"
                metrics.inc("tpu_hive_serve_shed_total", priority=str(req.priority))
                if obs_journal.JOURNAL.enabled:
                    if req.flight_local:
                        obs_journal.note_request_done(req.flight, "shed", at=now,
                                                      priority=req.priority)
                    # shed closes the request's episode (it never ran)
                    obs_journal.note_phase(f"serve/{req.rid}", "closed", "serve_shed",
                                           priority=req.priority)
            else:
                kept.append(req)
        self.queue = kept

    def _next_waiter_index(self) -> int:
        """The next request to admit: the queue head under strict priority,
        or the first waiter of the highest effective priority (priority +
        one level per ``age_boost_secs`` waited)."""
        if self.age_boost_secs is None or len(self.queue) <= 1:
            return 0
        now = self._clock()
        best_i, best_eff = 0, None
        for i, w in enumerate(self.queue):
            eff = w.priority + int((now - w.submitted_at) / self.age_boost_secs)
            if best_eff is None or eff > best_eff:
                best_i, best_eff = i, eff
        return best_i

    def _admit(self) -> None:
        self._shed_expired()
        for slot in range(self.max_batch):
            if not self.queue:
                return
            if self.slots[slot] is not None:
                continue
            at = self._next_waiter_index()
            req = self.queue[at]
            hit = self._match_prefix(req.prompt) if self._prefix_cache else None
            if self.paged and not self._blocks_admit(req, hit):
                return  # head of line until blocks free up
            self.queue.pop(at)
            req.admitted_at = self._clock()
            if obs_journal.JOURNAL.enabled:
                obs_journal.emit("serve_admit", f"serve/{req.rid}", slot=slot,
                                 priority=req.priority)
                if req.flight is not None:
                    obs_journal.note_leg(req.flight, "admission_wait",
                                         at=req.admitted_at, slot=slot)
            if hit is not None:
                payload, plen = hit[1]
                self.prefix_hits += 1
                self.prefix_tokens_reused += plen
                self._prefix_restore(slot, payload)
                tail = req.prompt[plen:]
            else:
                plen, tail = 0, req.prompt
            if self.paged:
                # the prompt's whole cover up front, and a copy of a partly
                # shared boundary block the tail writes into
                self._ensure_writable(slot, plen, len(req.prompt) - 1)
            if self.prefill_chunk > 0 and len(tail) > self.prefill_chunk:
                # chunked: occupied, parked, decoding only after its chunks
                self.slots[slot] = req
                self._prefilling[slot] = (tail, plen, 0)
                self._park(slot)
                continue
            tokens = self._padded_tokens(tail)
            logits = self._run_prefill(slot, tokens, plen)
            self._on_prefill(slot, tokens, len(req.prompt), plen)
            self.slots[slot] = req
            self._finish_prefill(req, slot, logits, len(tail) - 1)

    def _park(self, slot: int) -> None:
        """Pin the slot's length at the parked position while its chunked
        prefill is in flight: the shared decode step writes there, outside
        any prompt and rewritten before any query attends it."""
        self._set_row_length(slot, self._park_pos if self.paged else self.max_len - 1)

    def _finish_prefill(self, req: Request, slot: int, logits, last_idx: int) -> None:
        """Shared tail of the monolithic and chunked prefill: the row's
        true length, the prefix store (after ``_on_prefill`` has filled a
        subclass's caches), the first token."""
        self._set_row_length(slot, len(req.prompt))
        self._on_ready(slot, len(req.prompt))
        if self.prefix_cache_size > 0:
            self._store_prefix(slot, req.prompt)
        tok = self._pick(logits[last_idx], req)
        self._emit(req, slot, tok)
        if req.done:
            self._retire(slot)

    def _padded_tokens(self, toks: List[int]) -> torch.Tensor:
        """Right-padded to the prefill bucket: one home for the padding."""
        padded = toks + [0] * (self._bucket(len(toks)) - len(toks))
        return torch.tensor([padded], dtype=torch.long, device=self.device)

    def _prefill_chunk_tick(self, slot: Optional[int] = None) -> None:
        """Advance one in-flight chunked prefill by one chunk."""
        if not self._prefilling:
            return
        if slot is None:
            slot = next(iter(self._prefilling))  # insertion order: FIFO
        tail, plen, pos = self._prefilling[slot]
        req = self.slots[slot]
        # the padded bucket [off, off + bucket) must fit the arena: shrink
        # the chunk until it does (room >= 2: prompt + budget <= max_len)
        off = plen + pos
        room = self.max_len - off
        size = min(self.prefill_chunk, len(tail) - pos)
        while self._bucket(size) > room:
            size = self._bucket(size) // 2
        chunk = tail[pos: pos + size]
        tokens = self._padded_tokens(chunk)
        logits = self._run_prefill(slot, tokens, off)
        self._on_prefill(slot, tokens, len(req.prompt), off)
        self.prefill_chunks_done += 1
        pos += len(chunk)
        if pos < len(tail):
            self._prefilling[slot] = (tail, plen, pos)
            return
        del self._prefilling[slot]
        self._finish_prefill(req, slot, logits, len(chunk) - 1)

    def _on_prefill(self, slot: int, tokens, prompt_len: int, start: int = 0) -> None:
        """Hook for a subclass with its own per-slot caches (the speculative
        engine prefills its draft here): ``tokens`` [1, bucket] were just
        absorbed into ``slot`` from position ``start`` (a prefix hit's
        tail, or one chunk). Called once per monolithic prefill and once
        per chunk, so it writes KV only and leaves lengths to
        ``_on_ready``."""

    def _on_ready(self, slot: int, prompt_len: int) -> None:
        """Hook: ``slot``'s prefill is complete and its true length set; it
        decodes from the next step. Not ``_on_prefill``, which fires while
        a chunked slot must stay parked."""

    def _emit(self, req: Request, slot: int, tok: int) -> None:
        """Append one token, read to the host already, so the clock
        stamps a token that exists."""
        if req.first_token_at is None:
            req.first_token_at = self._clock()
            if req.flight is not None and obs_journal.JOURNAL.enabled:
                # the first-token mark closes the flight's TTFT window: new
                # request-path code between admission and here must note its
                # own leg or the legs stop summing to the TTFT
                obs_journal.note_leg(
                    req.flight, "first_decode" if req.flight_decode else "prefill",
                    at=req.first_token_at)
        req.tokens_out.append(tok)
        self._last_host[slot] = tok
        if len(req.tokens_out) >= req.max_new_tokens or tok == self.eos_id:
            req.done = True
            req.finish_reason = "eos" if tok == self.eos_id else "length"
            req.done_at = self._clock()
            self._observe_request(req)

    def _observe_request(self, req: Request) -> None:
        """Publish one finished request: its flight's terminal and the
        journal's ``serve_finish``, the per-priority histograms and
        counter, and, while tracing, queued, prefill and decode spans and a
        done instant on the request's own lane (tid = rid)."""
        prio = str(req.priority)
        metrics.inc("tpu_hive_serve_requests_total", priority=prio)
        if obs_journal.JOURNAL.enabled:
            if req.flight_local:
                obs_journal.note_request_done(
                    req.flight, req.finish_reason,
                    first_token_at=req.first_token_at, at=req.done_at,
                    tokensOut=len(req.tokens_out))
            obs_journal.note_phase(
                f"serve/{req.rid}", "closed", "serve_finish",
                finishReason=req.finish_reason, tokensOut=len(req.tokens_out))
        if req.queue_wait_s is not None:
            metrics.observe("tpu_hive_serve_queue_wait_seconds", req.queue_wait_s,
                            priority=prio)
        if req.ttft_s is not None:
            metrics.observe("tpu_hive_serve_ttft_seconds", req.ttft_s, priority=prio)
        if req.tpot_s is not None:
            metrics.observe("tpu_hive_serve_tpot_seconds", req.tpot_s, priority=prio)
        if not obs_trace.enabled():
            return
        args = {"rid": req.rid, "priority": req.priority,
                "prompt_tokens": len(req.prompt), "new_tokens": len(req.tokens_out)}
        tid = req.rid
        if req.admitted_at is not None:
            obs_trace.TRACER.complete("request/queued", req.submitted_at,
                                      req.admitted_at, cat="serving", tid=tid, args=args)
            if req.first_token_at is not None:
                obs_trace.TRACER.complete("request/prefill", req.admitted_at,
                                          req.first_token_at, cat="serving",
                                          tid=tid, args=args)
        if req.first_token_at is not None and req.done_at is not None:
            obs_trace.TRACER.complete("request/decode", req.first_token_at,
                                      req.done_at, cat="serving", tid=tid, args=args)
        obs_trace.TRACER.instant("request/done", cat="serving", tid=tid,
                                 at=req.done_at, args=args)

    # -- engine ticks ------------------------------------------------------
    def _tick_prefills(self) -> List[int]:
        """One bounded chunk while any row decodes, every in-flight prefill
        when none does. Returns the slots ready to decode."""
        decoding = any(s is not None and i not in self._prefilling
                       for i, s in enumerate(self.slots))
        if decoding:
            self._prefill_chunk_tick()
        else:
            for slot in list(self._prefilling):
                if slot in self._prefilling:  # a tick may finish the slot
                    self._prefill_chunk_tick(slot)
        return [s for s in range(self.max_batch)
                if self.slots[s] is not None and s not in self._prefilling]

    def _fused_window(self, active) -> int:
        """Decode iterations before the host looks again: ``decode_steps``,
        bounded by every active row's remaining budget, rounded down to a
        power of two below it, and 1 while chunked prefills are in flight
        or when an EOS could free a slot that queued work waits for. Rows
        that hit EOS inside a window have their surplus discarded."""
        if self.decode_steps <= 1 or self._prefilling:
            return 1
        if self.eos_id is not None and self.queue:
            return 1
        rem = min(self.slots[s].max_new_tokens - len(self.slots[s].tokens_out)
                  for s in active)
        if rem >= self.decode_steps:
            return self.decode_steps
        return 1 << (rem.bit_length() - 1)

    def _decode_once(self):
        """The eager decode step over every row: [B, vocab] logits."""
        last = torch.tensor(self._last_host, dtype=torch.long, device=self.device)
        if self.paged:
            logits, _ = advance_paged(self.params, self.pool, last[:, None], self.cfg,
                                      self._table_dev(), self._len_dev())
        else:
            logits, _ = advance_ragged(self.params, self.cache, last[:, None], self.cfg)
        return logits[:, 0]

    def _window_iteration(self, w: DecodeWindow) -> None:
        """One decode iteration over the window's buffers: advance, pick,
        feed the token back, advance the lengths and counts, shift the
        token into ``w.toks``. No host sync, so a graph can capture it."""
        if self.paged:
            logits, _ = advance_paged(self.params, self.pool, w.last[:, None],
                                      self.cfg, w.table, w.lens)
            w.lens.copy_(torch.clamp(w.lens + 1, max=self._park_pos))
        else:
            logits, _ = advance_ragged(self.params, self.cache, w.last[:, None], self.cfg)
        if self.temperature == 0.0:
            tok = torch.argmax(logits[:, 0], dim=-1)
        else:
            tok = self._sample(logits[:, 0], w.rids, w.counts)
        w.counts.add_(1)
        w.last.copy_(tok)
        w.toks.copy_(torch.roll(w.toks, -1, dims=1))
        w.toks[:, -1].copy_(tok)

    def _run_window(self, k: int) -> List[List[int]]:
        """A fused window of ``k`` iterations; the [B, k] tokens come back
        in one device-to-host copy. On a card the iteration is a CUDA
        graph: captured on the first window (after one eager iteration on a
        side stream, which is also that window's first iteration) and
        replayed after. A capture or replay error raises."""
        if self._window is None:
            self._window = DecodeWindow(self)
        w = self._window
        w.check_bound(self)
        w.last.copy_(torch.tensor(self._last_host, dtype=torch.long))
        rids, counts = self._sample_coords(self.slots)
        w.rids.copy_(rids)
        w.counts.copy_(counts)
        if self.paged:
            w.table.copy_(torch.from_numpy(self._table.astype(np.int64)))
            w.lens.copy_(torch.from_numpy(self._host_len.astype(np.int64)))
        if self.device.type != "cuda":
            for _ in range(k):
                self._window_iteration(w)
        else:
            replays = k
            if w.graph is None:
                side = torch.cuda.Stream(device=self.device)
                side.wait_stream(torch.cuda.current_stream(self.device))
                with torch.cuda.stream(side):
                    self._window_iteration(w)
                torch.cuda.current_stream(self.device).wait_stream(side)
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph):
                    self._window_iteration(w)
                w.graph = graph
                replays = k - 1
            for _ in range(replays):
                w.graph.replay()
            self.graph_windows += 1
        return w.toks[:, -k:].tolist()

    def step(self) -> bool:
        """Admit, tick chunked prefills, then one decode step (or one fused
        window) for every decoding slot. Returns whether work remains."""
        self._admit()
        active = self._tick_prefills()
        if active and self.paged:
            k_plan = self._fused_window(active)
            for slot in active:
                if self.slots[slot] is None:
                    continue  # retired by an earlier slot's pool preemption
                lo = int(self._host_len[slot])
                self._ensure_writable(slot, lo, lo + k_plan - 1)
            # a preemption may have retired an active slot: a smaller window
            # than planned is always exact, so re-filter rather than re-plan
            active = [s for s in active if self.slots[s] is not None]
        if active:
            k = k_plan if self.paged else self._fused_window(active)
            if k == 1:
                picked = self._pick_batch(self._decode_once(), self.slots)
                self.steps += 1
                self.slot_steps += len(active)
                if self.paged:
                    for slot in active:
                        self._host_len[slot] += 1
                for slot in active:
                    req = self.slots[slot]
                    self._emit(req, slot, picked[slot])
                    if req.done:
                        self._retire(slot)  # recycle immediately
            else:
                toks = self._run_window(k)
                self.fused_windows += 1
                metrics.inc("tpu_hive_serve_fused_decode_windows_total")
                self.steps += k
                self.slot_steps += len(active) * k
                if self.paged:
                    for slot in active:
                        self._host_len[slot] += k
                for slot in active:
                    req = self.slots[slot]
                    for j in range(k):
                        self._emit(req, slot, toks[slot][j])
                        if req.done:
                            break  # surplus window tokens are discarded
                    if req.done:
                        self._retire(slot)
        self._publish_pool()
        return bool(self.queue) or any(s is not None for s in self.slots)

    def _publish_pool(self) -> None:
        """The pool-occupancy gauge, once an engine step (paged only)."""
        if self.paged:
            metrics.set_gauge("tpu_hive_serve_block_pool_occupancy",
                              self.blocks_in_use / max(1, self.num_blocks - 1))

    def run_until_drained(self, max_steps: int = 100_000) -> None:
        for _ in range(max_steps):
            if not self.step():
                return
        raise RuntimeError(f"serving did not drain in {max_steps} steps")

    # -- graceful preemption -----------------------------------------------
    def begin_drain(self) -> None:
        """Admission off: every later ``submit()`` raises
        :class:`EngineDraining`; queued and decoding requests keep running."""
        self.draining = True

    def end_drain(self) -> None:
        """Re-arm admission after a completed drain; only legal once idle."""
        if self.queue or any(s is not None for s in self.slots):
            raise RuntimeError("end_drain with work still in flight: finish "
                               "the drain (step until idle) before re-arming "
                               "admission")
        self.draining = False

    def drain(self, deadline_s: Optional[float] = None,
              max_steps: int = 100_000) -> bool:
        """Finish all in-flight work, bounded by ``deadline_s``. True when
        fully drained; when the deadline expires first, every unfinished
        request ends as "preempted" (its stream truncated), its blocks go
        back, and the engine state is cleared."""
        self.begin_drain()
        obs_goodput.phase("drain")
        try:
            t0 = self._clock()
            steps = 0
            while self.step():
                steps += 1
                expired = deadline_s is not None and self._clock() - t0 > deadline_s
                if expired or steps >= max_steps:
                    now = self._clock()
                    for req in list(self.queue) + [r for r in self.slots if r is not None]:
                        req.done = True
                        req.done_at = now
                        req.finish_reason = "preempted"
                        if req.flight_local and obs_journal.JOURNAL.enabled:
                            obs_journal.note_request_done(
                                req.flight, "preempted",
                                first_token_at=req.first_token_at, at=now)
                    self.queue.clear()
                    for slot in range(self.max_batch):
                        if self.slots[slot] is not None:
                            self._retire(slot)
                    self._prefilling.clear()
                    return False
            return True
        finally:
            obs_goodput.phase("idle")

    @property
    def occupancy(self) -> float:
        """Mean fraction of slots doing useful work per decode step."""
        return self.slot_steps / (self.steps * self.max_batch) if self.steps else 0.0


class SpeculativeServingEngine(ServingEngine):
    """Continuous batching with speculative decoding and per-row
    acceptance, the JAX package's ``SpeculativeServingEngine``.

    Each engine step runs one round over every decoding row: ``gamma``
    draft steps (each an S = 1 pass of the draft over its own dense
    :class:`RaggedCache`), one more draft pass that absorbs the last
    proposal, and one target pass of S = ``gamma`` + 1 tokens (the fed-back
    token and the proposals) at each row's own offset, on the ragged cache
    or through the paged pool. Each row then keeps its own accepted prefix
    and one correction token, 1 to ``gamma`` + 1 tokens a round, and both
    caches' lengths roll back to its length before the round + 1 +
    accepted; on the paged pool ``_trim_blocks`` returns the rejected
    tail's blocks. A rolled-back tail lies inside the next round's window,
    which rewrites it before any query attends it, so greedy streams equal
    the plain engine's greedy decode.

    Sampled rounds (``temperature`` > 0) accept proposal x with probability
    min(1, p(x) / q(x)), resample a rejected position from norm(max(p - q,
    0)) and draw a bonus token from p after full acceptance, so the output
    is distributed as the target's. Proposals and the bonus token use the
    plain engine's tag-0 draws at their emitted positions, the accept and
    residual draws tags 1 and 2: a perfect draft (the target itself)
    reproduces the plain sampled engine's stream, and streams do not
    depend on interleaving.

    ``decode_steps`` is accepted and ignored: a round already spreads the
    host's round trip over up to ``gamma`` + 1 tokens, and the round runs
    eager (no CUDA graph, so no buffer of the plain engine's graph is
    shared). ``submit`` reserves ``gamma`` + 1 positions of headroom for a
    verify pass's writes. ``mesh`` is not yet ported and raises."""

    def __init__(self, params, cfg, draft_params=None, draft_cfg=None, *,
                 gamma: int = 4, spec_decode=None, **kw):
        if spec_decode is not None:
            if draft_params is not None or draft_cfg is not None:
                raise ValueError("pass either spec_decode= or explicit "
                                 "draft_params/draft_cfg, not both")
            draft_params = spec_decode.draft_params
            draft_cfg = spec_decode.draft_cfg
            gamma = spec_decode.gamma
        if draft_params is None or draft_cfg is None:
            raise ValueError("speculative serving needs a draft model: pass "
                             "spec_decode=SpecDecodeConfig(...) (or "
                             "draft_params and draft_cfg)")
        if cfg.vocab_size != draft_cfg.vocab_size:
            raise ValueError(f"target and draft vocabs must match: "
                             f"{cfg.vocab_size} vs {draft_cfg.vocab_size}")
        if gamma < 1:
            raise ValueError(f"gamma must be >= 1, got {gamma}")
        super().__init__(params, cfg, **kw)
        self.draft_params = draft_params
        self.draft_cfg = draft_cfg
        self.gamma = gamma
        # its own lengths tensor: both caches' lengths are written after
        # every round
        self.draft_cache = init_ragged_cache(draft_cfg, self.max_batch, self.max_len,
                                             self.kv_dtype, self.device)
        self.drafted = 0
        self.accepted = 0

    # -- the draft cache beside the target's --------------------------------
    def _park(self, slot: int) -> None:
        # park the draft row too: at a previous occupant's length the
        # rounds' draft writes could land inside the prompt being chunked
        # in; max_len - 1 is attended by no live query (submit's headroom)
        super()._park(slot)
        self.draft_cache.lengths[slot] = self.max_len - 1

    def _on_prefill(self, slot: int, tokens, prompt_len: int, start: int = 0) -> None:
        # KV only: the draft length stays parked until _on_ready
        advance_ragged(self.draft_params, self.draft_cache, tokens, self.draft_cfg,
                       row=slot, start=start)

    def _on_ready(self, slot: int, prompt_len: int) -> None:
        self.draft_cache.lengths[slot] = prompt_len

    def _prefix_extract(self, slot: int, pb: int):
        """Target and draft KV in one payload: a restored prefix leaves both
        caches as a full prefill would."""
        return (super()._prefix_extract(slot, pb),
                _extract_rows(self.draft_cache, slot, pb))

    def _prefix_restore(self, slot: int, payload) -> None:
        target, draft = payload
        super()._prefix_restore(slot, target)
        _restore_rows(self.draft_cache, slot, draft)

    def _store_payload(self, slot: int, bids, plen: int):
        # the draft has no pool: the entry bundles a copy of its dense KV
        # beside the target's shared block ids
        return (tuple(bids), _extract_rows(self.draft_cache, slot, self._bucket(plen)))

    def _entry_bids(self, payload):
        return payload[0]

    # the fleet's KV handoff (the plain engine's export_prefix and
    # import_prefix, not yet ported) cannot ship these payloads
    _NO_KV_SHIP = ("KV shipping across replicas does not support the speculative "
                   "engine (its prefix payloads bundle a draft-cache copy); a "
                   "replica re-prefills on a miss instead")

    def export_prefix(self, prompt):
        raise RuntimeError(self._NO_KV_SHIP)

    def import_prefix(self, key, plen: int, data) -> bool:
        raise RuntimeError(self._NO_KV_SHIP)

    def submit(self, prompt: List[int], max_new_tokens: int,
               priority: int = 0) -> Request:
        # a verify pass writes gamma positions past the accepted prefix
        # before it rolls back: reserve that headroom in the arena
        if prompt and len(prompt) + max_new_tokens + self.gamma + 1 > self.max_len:
            raise ValueError(
                f"prompt {len(prompt)} + max_new {max_new_tokens} + "
                f"speculation headroom {self.gamma + 1} exceeds max_len "
                f"{self.max_len}")
        return super().submit(prompt, max_new_tokens, priority=priority)

    # -- the round ---------------------------------------------------------
    def _draft_step(self, tok: torch.Tensor) -> torch.Tensor:
        """One S = 1 draft pass over every row: [B, vocab] logits."""
        logits, _ = advance_ragged(self.draft_params, self.draft_cache, tok[:, None],
                                   self.draft_cfg)
        return logits[:, 0]

    def _verify(self, tgt_in: torch.Tensor, table, lens) -> torch.Tensor:
        """The target's pass over [B, gamma + 1] tokens at every row's
        offset: [B, gamma + 1, vocab] logits.

        The arena edge: a parked or idle row writes all gamma + 1 positions
        at the clamped last index (max_len - 1, or the paged pool's last
        addressable position), several values onto one index of one
        ``index_put``, whose winner CUDA leaves undefined. Only such garbage
        rows write there, and submit's headroom keeps every live row's
        queries at or below max_len - 2, so nothing live reads it."""
        if self.paged:
            logits, _ = advance_paged(self.params, self.pool, tgt_in, self.cfg,
                                      table, lens)
        else:
            logits, _ = advance_ragged(self.params, self.cache, tgt_in, self.cfg)
        return logits

    @torch.no_grad()
    def _round_greedy(self, last, table, lens):
        """(proposals [B, gamma], the target's argmax [B, gamma + 1])."""
        tok, props = last, []
        for _ in range(self.gamma):
            tok = torch.argmax(self._draft_step(tok), dim=-1)
            props.append(tok)
        # the extra absorb: the draft cache then holds its last proposal
        # when a row accepts all of them
        self._draft_step(tok)
        props = torch.stack(props, dim=1)
        tlogits = self._verify(torch.cat([last[:, None], props], dim=1), table, lens)
        return props, torch.argmax(tlogits, dim=-1)

    @torch.no_grad()
    def _round_sampled(self, last, rids, counts, table, lens):
        """(tokens to emit [B, gamma + 1]: the accepted proposals with the
        correction token at the accepted count, accepted count [B])."""
        g = self.gamma

        def fdist(logits):
            return filter_logits(logits / self.temperature, self.top_k, self.top_p)

        tok, props, qf = last, [], []
        for i in range(g):
            f = fdist(self._draft_step(tok))
            # the plain engine's tag-0 draw at this emitted position
            tok = gumbel_argmax(f, rids, counts + i, self.seed)
            props.append(tok)
            qf.append(f)
        self._draft_step(tok)  # the extra absorb
        props = torch.stack(props, dim=1)  # [B, g]
        qf = torch.stack(qf, dim=1)  # [B, g, V]
        pf = fdist(self._verify(torch.cat([last[:, None], props], dim=1), table, lens))
        p = torch.softmax(pf, dim=-1)
        q = torch.softmax(qf, dim=-1)
        rows = torch.arange(props.shape[0], device=props.device)
        gidx = torch.arange(g, device=props.device)
        px = p[rows[:, None], gidx[None, :], props]
        qx = q[rows[:, None], gidx[None, :], props]
        u = torch.stack([stream_uniforms(self.seed, rids, counts + i, 1, tag=1)[:, 0]
                         for i in range(g)], dim=1)
        # u < p/q, not u q < p: with a perfect draft the ratio is exactly 1
        # and u < 1 always accepts, where u q could round up to q. q(x) > 0:
        # x was drawn from q's filtered logits
        accept = u < px / qx
        acc = torch.sum(torch.cumprod(accept.long(), dim=1), dim=1)
        p_at = p[rows, acc]
        q_at = torch.where((acc < g)[:, None], q[rows, torch.clamp(acc, max=g - 1)], 0.0)
        resid = torch.clamp(p_at - q_at, min=0.0)
        degenerate = torch.sum(resid, dim=-1, keepdim=True) <= 0.0
        resid = torch.where(degenerate, p_at, resid)
        corr_res = gumbel_argmax(torch.log(torch.clamp(resid, min=1e-30)), rids,
                                 counts + acc, self.seed, tag=2)
        # full acceptance: the bonus token with the plain tag-0 draw over
        # the target's filtered logits, as the plain engine would draw it
        corr_bonus = gumbel_argmax(pf[rows, acc], rids, counts + acc, self.seed)
        corr = torch.where(acc == g, corr_bonus, corr_res)
        emit = torch.where(torch.arange(g + 1, device=props.device)[None, :] == acc[:, None],
                           corr[:, None], torch.cat([props, props[:, -1:]], dim=1))
        return emit, acc

    def step(self) -> bool:
        """Admit, tick chunked prefills, then one speculative round for
        every decoding slot. Returns whether work remains."""
        self._admit()
        active = self._tick_prefills()
        if active and self.paged:
            # a verify pass writes [len, len + gamma]: allocate (and COW)
            # that cover first; the rejected tail's blocks go back below
            for slot in active:
                if self.slots[slot] is None:
                    continue  # retired by an earlier slot's pool preemption
                lo = int(self._host_len[slot])
                self._ensure_writable(slot, lo, lo + self.gamma)
            active = [s for s in active if self.slots[s] is not None]
        if not active:
            self._publish_pool()
            return bool(self.queue) or any(s is not None for s in self.slots)
        g = self.gamma
        last = torch.tensor(self._last_host, dtype=torch.long, device=self.device)
        if self.paged:
            lengths_before = self._host_len.copy()
            table, lens = self._table_dev(), self._len_dev()
        else:
            lengths_before = self.cache.lengths.cpu().numpy().copy()
            table = lens = None
        if self.temperature > 0.0:
            emit_d, acc_d = self._round_sampled(last, *self._sample_coords(self.slots),
                                                table, lens)
            host = torch.cat([emit_d, acc_d[:, None]], dim=1).tolist()  # one sync
            emit = [row[:g + 1] for row in host]
            accs = [row[g + 1] for row in host]
        else:
            props_d, emit_d = self._round_greedy(last, table, lens)
            host = torch.cat([props_d, emit_d], dim=1).tolist()  # one sync
            emit = [row[g:] for row in host]
            accs = []
            for row in host:
                acc = 0
                while acc < g and row[acc] == row[g + acc]:
                    acc += 1
                accs.append(acc)
        self.steps += 1
        self.slot_steps += len(active)
        # idle and parked rows keep their lengths (their absorbed garbage
        # never advances them)
        new_len = np.array(lengths_before, dtype=np.int64)
        for slot in active:
            req, acc = self.slots[slot], accs[slot]
            self.drafted += g
            self.accepted += acc
            metrics.observe("tpu_hive_serve_spec_acceptance_ratio", acc / g)
            for tok in emit[slot][:acc + 1]:
                self._emit(req, slot, int(tok))
                if req.done:
                    break
            new_len[slot] = lengths_before[slot] + 1 + acc
            if self.paged and not req.done:
                # the rollback in blocks: keep the accepted cover
                self._host_len[slot] = new_len[slot]
                self._trim_blocks(slot, int(new_len[slot]))
            if req.done:
                self._retire(slot)
        lens_new = torch.from_numpy(new_len.astype(np.int32)).to(self.device)
        if not self.paged:
            self.cache.lengths.copy_(lens_new)
        self.draft_cache.lengths.copy_(lens_new)
        self._publish_pool()
        return bool(self.queue) or any(s is not None for s in self.slots)

    @property
    def acceptance(self) -> float:
        return self.accepted / self.drafted if self.drafted else 0.0
