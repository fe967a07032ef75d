"""Token sources and the batch stream of the port's workloads.

Copies of ``hivedscheduler_tpu/parallel/data.py``: the memory-mapped token
file, the deterministic synthetic corpus, the per-step host batches, the
checkpointable batch stream and the background prefetch. Every draw is the
same numpy call as the JAX package's, so corpus and batches are
bit-identical for the same dataset and seed. The gather is the numpy one
(the JAX package's native gather is bit-identical to it).

The split of a global batch differs from the JAX package's. There one
process holds all of a host's chips and takes the rows of its process
index. Here one process is one GPU, and the tp ranks of one data-parallel
group must read the same rows, so :func:`data_split` gives the loader the
rank's data-parallel coordinate (its dp x fsdp index and their product)
in place of a process index and count; :func:`device_put_global` then
builds the global [batch, seq] token DTensor from each rank's rows.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np

# the most recently started prefetch worker thread (named "hived-prefetch"),
# for tests to join or poll
_last_prefetch_worker = None


class TokenFileDataset:
    """A flat binary token stream, memory-mapped (zero-copy reads)."""

    def __init__(self, path: str, dtype: str = "uint16"):
        self.tokens = np.memmap(path, dtype=np.dtype(dtype), mode="r")
        if len(self.tokens) == 0:
            raise ValueError(f"token file {path} is empty")

    def __len__(self) -> int:
        return len(self.tokens)

    def sample(self, rng: np.random.Generator, batch: int, seq_len: int,
               row_slice: slice = slice(None)) -> np.ndarray:
        """Random contiguous windows (with wraparound). ``row_slice`` gathers
        only those rows of the batch: the start positions are still drawn
        for the whole batch, so every host sees the same global plan."""
        n = len(self.tokens)
        starts = rng.integers(0, n, size=batch)[row_slice]
        idx = (starts[:, None] + np.arange(seq_len)[None, :]) % n
        return np.asarray(self.tokens[idx], dtype=np.int32)


def synthetic_dataset(vocab_size: int, size: int = 1 << 20, seed: int = 0):
    """In-memory stand-in with the TokenFileDataset interface."""
    rng = np.random.default_rng(seed)
    dtype = np.uint16 if vocab_size <= (1 << 16) else np.uint32
    ds = TokenFileDataset.__new__(TokenFileDataset)
    ds.tokens = rng.integers(0, vocab_size, size=size).astype(dtype)
    return ds


def host_batches(
    dataset: TokenFileDataset,
    global_batch: int,
    seq_len: int,
    *,
    process_index: int = 0,
    process_count: int = 1,
    seed: int = 0,
    start_step: int = 0,
) -> Iterator[np.ndarray]:
    """Yield this host's [global_batch / process_count, seq_len] shard, with
    the step's RNG derived from (seed, step); ``start_step`` resumes the
    stream mid-corpus."""
    if global_batch % process_count != 0:
        raise ValueError(
            f"global batch {global_batch} not divisible by {process_count} hosts"
        )
    local = global_batch // process_count
    rows = slice(process_index * local, (process_index + 1) * local)
    step = start_step
    while True:
        rng = np.random.default_rng((seed, step))
        yield dataset.sample(rng, global_batch, seq_len, row_slice=rows)
        step += 1


@dataclasses.dataclass
class LoaderState:
    """Checkpointable data-loader state of record: the stream's ``seed``,
    ``step`` (batches already emitted), ``epoch`` (full passes of the
    corpus, derived) and ``bitgen``, the numpy bit-generator state of the
    persistent stream RNG (JSON-serialisable). Serialised as the dataclass
    mapping, never a hand-rolled field list."""

    seed: int = 0
    step: int = 0
    epoch: int = 0
    bitgen: Optional[dict] = None

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "LoaderState":
        fields = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - fields
        if unknown:
            raise ValueError(f"unknown LoaderState fields: {sorted(unknown)}")
        return cls(**d)


class CheckpointableBatches:
    """Stateful host-batch stream with exact-resume checkpointing: one
    persistent generator advanced per step, whose bit-generator state
    :meth:`to_dict` / :meth:`from_dict` carry, so a restarted run
    reproduces the uninterrupted stream bit for bit. ``skip(n)`` advances
    the stream without gathering tokens."""

    def __init__(self, dataset: TokenFileDataset, global_batch: int,
                 seq_len: int, *, process_index: int = 0,
                 process_count: int = 1, seed: int = 0,
                 state: Optional[LoaderState] = None):
        if global_batch % process_count != 0:
            raise ValueError(
                f"global batch {global_batch} not divisible by "
                f"{process_count} hosts"
            )
        self.dataset = dataset
        self.global_batch = global_batch
        self.seq_len = seq_len
        local = global_batch // process_count
        self._rows = slice(process_index * local, (process_index + 1) * local)
        if state is None:
            state = LoaderState(seed=seed)
        self._state = state
        self._rng = np.random.default_rng(state.seed)
        if state.bitgen is not None:
            self._rng.bit_generator.state = state.bitgen

    @property
    def step(self) -> int:
        return self._state.step

    @property
    def epoch(self) -> int:
        # full passes of the corpus, by token count consumed
        return (self._state.step * self.global_batch * self.seq_len
                // len(self.dataset))

    def state(self) -> LoaderState:
        """Snapshot the current state of record (bitgen refreshed)."""
        return LoaderState(seed=self._state.seed, step=self._state.step,
                           epoch=self.epoch,
                           bitgen=self._rng.bit_generator.state)

    def to_dict(self) -> dict:
        return self.state().to_dict()

    @classmethod
    def from_dict(cls, d: dict, dataset: TokenFileDataset, global_batch: int,
                  seq_len: int, *, process_index: int = 0,
                  process_count: int = 1) -> "CheckpointableBatches":
        return cls(dataset, global_batch, seq_len,
                   process_index=process_index, process_count=process_count,
                   state=LoaderState.from_dict(d))

    def __iter__(self) -> "CheckpointableBatches":
        return self

    def __next__(self) -> np.ndarray:
        batch = self.dataset.sample(self._rng, self.global_batch,
                                    self.seq_len, row_slice=self._rows)
        self._state.step += 1
        return batch

    def skip(self, n: int = 1) -> None:
        """Advance the stream ``n`` batches without gathering tokens,
        consuming exactly the draws :meth:`__next__` would (one full-batch
        ``integers`` draw per step, as in ``TokenFileDataset.sample``)."""
        for _ in range(n):
            self._rng.integers(0, len(self.dataset), size=self.global_batch)
            self._state.step += 1


def prefetch(batches: Iterator[np.ndarray], depth: int = 2,
             stop=None) -> Iterator[np.ndarray]:
    """Background-thread prefetch: batch N+1 assembles while step N
    computes. ``depth`` bounds the queue; ``depth <= 0`` passes through. A
    producer exception is re-raised at the consumer's next pull. Closing
    the iterator early signals the worker, drains the staged batches so a
    producer blocked on the queue unblocks, and joins the thread briefly.
    ``stop`` (a ``threading.Event``) also wakes a consumer blocked on a
    hung producer."""
    if depth <= 0:
        yield from batches
        return
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    done = object()
    closed = threading.Event()

    def put(item) -> bool:
        while not closed.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for b in batches:
                if not put(b):
                    return
            put(done)
        except BaseException as e:  # surface in the consumer, not the log
            put(e)

    thread = threading.Thread(target=worker, daemon=True,
                              name="hived-prefetch")
    global _last_prefetch_worker
    _last_prefetch_worker = thread
    thread.start()
    try:
        while True:
            try:
                item = q.get(timeout=0.1)
            except queue.Empty:
                if stop is not None and stop.is_set():
                    return
                continue
            if item is done:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
            if stop is not None and stop.is_set():
                return
    finally:
        closed.set()
        # drain staged batches so a worker mid-put() unblocks now, then
        # reap the thread
        while True:
            try:
                q.get_nowait()
            except queue.Empty:
                break
        thread.join(timeout=2.0)


def data_split(mesh):
    """(index, count) of this rank's rows in a global batch: its position
    along the data axes, dp-major and fsdp-minor (``activation_spec``), and
    the number of data-parallel positions. Ranks that differ only along tp
    (or another model axis) get the same index, so they read the same
    rows."""
    sizes = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    return (coord["dp"] * sizes["fsdp"] + coord["fsdp"],
            sizes["dp"] * sizes["fsdp"])


def device_put_global(local_batch: np.ndarray, token_sharding, global_batch: int):
    """The global [global_batch, seq_len] token DTensor from this rank's
    rows (``data_split``'s share), placed per ``token_sharding``
    (``make_sharded_train_step``'s): sharded over dp and fsdp, replicated
    over the other axes. No data moves between ranks."""
    import torch
    from torch.distributed.tensor import DTensor

    mesh, placements = token_sharding
    _, count = data_split(mesh)
    if local_batch.shape[0] * count != global_batch:
        raise ValueError(
            f"{local_batch.shape[0]} local rows x {count} data-parallel ranks "
            f"is not the global batch {global_batch}")
    # non_blocking: a blocking copy would wait for the device to drain
    # every launch before it, and a loop that does not sync each step (eval)
    # would lose its overlap of the next batch with the device's work
    local = torch.from_numpy(np.ascontiguousarray(local_batch)).to(
        mesh.device_type, non_blocking=True)
    global_shape = (global_batch,) + tuple(local_batch.shape[1:])
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=torch.Size(global_shape),
                              stride=torch.empty(global_shape, device="meta").stride())
