"""Data loading — a copy of ``deepspeed_tpu/runtime/dataloader.py``
(``DeepSpeedTPUDataLoader`` :27), kept in the port so that it imports
nothing of the JAX package.

The loader batches a dataset or iterable into numpy global batches; the
engine moves each batch to the training device. It is checkpointable:
:meth:`state_dict` captures the data cursor ``(epoch, batches served)`` and
:meth:`load_state_dict` fast-forwards the NEXT iteration to it exactly — the
shuffle order is a pure function of ``(seed, epoch)``, so a resumed run sees
the identical remaining data order without materializing the skipped
batches.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, Iterator, Optional

import numpy as np

from ..utils.logging import logger


class DeepSpeedTPUDataLoader:
    def __init__(self, dataset: Iterable, batch_size: int,
                 shuffle: bool = True, seed: int = 0,
                 drop_last: bool = True,
                 collate_fn: Optional[Callable] = None,
                 batch_transform: Optional[Callable] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.collate_fn = collate_fn or _default_collate
        self.batch_transform = batch_transform
        self._epoch = 0
        # data cursor: batches served in the CURRENT epoch (tracked by the
        # live iterator) + a pending fast-forward target set by
        # load_state_dict and consumed by the next __iter__
        self._batches_served = 0
        self._resume_batch: Optional[int] = None

    def __len__(self) -> int:
        try:
            n = len(self.dataset)  # type: ignore[arg-type]
        except TypeError:
            raise TypeError("dataset has no __len__; iterate directly")
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch
        self._batches_served = 0

    # ------------------------------------------------------------------ #
    # checkpointable cursor (universal checkpoint v2)
    # ------------------------------------------------------------------ #
    def state_dict(self) -> Dict[str, Any]:
        """The exact data position: the next ``__iter__`` after a matching
        :meth:`load_state_dict` yields the same remaining batch sequence."""
        return {"epoch": int(self._epoch),
                "batch": int(self._batches_served),
                "seed": int(self.seed),
                "shuffle": bool(self.shuffle),
                "batch_size": int(self.batch_size)}

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        """Arm the next iteration to fast-forward to the saved cursor. The
        global batch size must match (the elasticity invariant — a resumed
        job keeps the identical effective batch, so the cursor unit is
        stable across topologies)."""
        if int(sd.get("batch_size", self.batch_size)) != self.batch_size:
            logger.warning(
                f"dataloader cursor was recorded at batch_size "
                f"{sd.get('batch_size')} but this loader batches "
                f"{self.batch_size} — the cursor unit changed; data order "
                f"will NOT replay exactly")
        if int(sd.get("seed", self.seed)) != self.seed or \
                bool(sd.get("shuffle", self.shuffle)) != self.shuffle:
            logger.warning("dataloader cursor was recorded with a different "
                           "seed/shuffle — data order will NOT replay "
                           "exactly")
        self._epoch = int(sd.get("epoch", 0))
        self._resume_batch = int(sd.get("batch", 0))

    def __iter__(self) -> Iterator[Any]:
        try:
            n = len(self.dataset)  # type: ignore[arg-type]
            indexable = True
        except TypeError:
            indexable = False

        skip = self._resume_batch or 0
        self._resume_batch = None
        self._batches_served = skip

        if indexable:
            order = np.arange(n)
            if self.shuffle:
                rng = np.random.default_rng(self.seed + self._epoch)
                rng.shuffle(order)
            starts = range(0, n - self.batch_size + 1 if self.drop_last else n,
                           self.batch_size)
            for k, start in enumerate(starts):
                if k < skip:
                    continue  # fast-forward: pure index math, nothing built
                idx = order[start:start + self.batch_size]
                items = [self.dataset[int(i)] for i in idx]
                batch = self.collate_fn(items)
                if self.batch_transform:
                    batch = self.batch_transform(batch)
                self._batches_served += 1
                yield batch
        else:
            buf = []
            skipped = 0
            for item in self.dataset:
                buf.append(item)
                if len(buf) == self.batch_size:
                    if skipped < skip:
                        # non-indexable fast-forward: the iterator must be
                        # consumed, but skipped batches are never collated
                        skipped += 1
                        buf = []
                        continue
                    batch = self.collate_fn(buf)
                    if self.batch_transform:
                        batch = self.batch_transform(batch)
                    self._batches_served += 1
                    yield batch
                    buf = []
            if buf and not self.drop_last:
                self._batches_served += 1
                yield self.collate_fn(buf)


def _default_collate(items):
    """Stack dict-of-arrays or arrays along a new leading batch dim."""
    first = items[0]
    if isinstance(first, dict):
        return {k: np.stack([np.asarray(it[k]) for it in items]) for k in first}
    return np.stack([np.asarray(it) for it in items])
