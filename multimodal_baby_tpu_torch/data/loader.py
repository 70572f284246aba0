"""Host-side batching with background prefetch (counterpart of
``multimodal_baby_tpu/data/loader.py``; the reference's torch DataLoader
workers, multimodal_data_module.py:362-403).

Threads decode and collate on the host while the device computes. Frames
stay uint8 on the host and on the copy to the device; the augment and the
normalization run on the device inside the train step
(``data/augment.py``).
"""

from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Optional

import numpy as np

from multimodal_baby_tpu_torch.parallel.mesh import local_rows


def collate(items) -> Dict[str, np.ndarray]:
    """items: (img_uint8 [H,W,3], ids [L], length, raw) tuples ->
    fixed-shape arrays (reference collate: multimodal_data_module.py:98-109,
    with static padding instead of dynamic)."""
    imgs, ids, lens, raws = zip(*items)
    return {
        "image_u8": np.stack(imgs),
        "text": np.stack(ids),
        "text_len": np.asarray(lens, np.int32),
        "raw": list(raws),
    }


class DataLoader:
    """Iterates shuffled fixed-size batches with background prefetch: the
    JAX package's batches, in its order, for a seed (a
    ``np.random.RandomState(seed)`` shuffle per iteration).

    ``sync`` makes the batches inline on the consumer's thread, with no
    executor and no prefetch (a measurement and debugging bypass; the JAX
    package reads it from ``MMB_LOADER_SYNC`` at each iteration).

    A dataset with ``batch_frames`` (random frame draws) has them drawn on
    the consumer's thread in batch order before a batch goes to a worker,
    so that the threaded loader gives the batches of the inline one. (The
    JAX package's workers draw from the shared generator in whatever order
    they run.)

    On a ``mesh`` (``parallel/mesh.py``) each batch is this rank's rows of
    the global batch the same seed gives every rank: a ragged global batch
    is padded with wrap-around rows up to ``pad_to`` or the next multiple
    of the data axis and the batch gains its rows' ``valid`` mask, as
    ``parallel.shard_batch`` would give; only the rank's rows are decoded.
    Random frame draws are made for the whole global batch, so that every
    mesh shape pairs the same frames."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        drop_last: bool = False,
        num_workers: int = 4,
        prefetch: int = 4,
        seed: int = 0,
        sync: bool = False,
        mesh=None,
        pad_to: Optional[int] = None,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.rng = np.random.RandomState(seed)
        self.sync = sync
        self.mesh = mesh
        self.pad_to = pad_to

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _batch_indices(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(order)
        for start in range(0, len(order), self.batch_size):
            idxs = order[start:start + self.batch_size]
            if self.drop_last and len(idxs) < self.batch_size:
                return
            yield idxs

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        batch_items = getattr(self.dataset, "batch_items", None)
        batch_frames = getattr(self.dataset, "batch_frames", None)

        def plan(idxs):  # on this thread, in batch order
            frames = None if batch_frames is None else batch_frames(idxs)
            valid = None
            if self.mesh is not None:
                rows, valid = local_rows(self.mesh, len(idxs), self.pad_to)
                idxs = idxs[rows]
                if frames is not None:
                    frames = [frames[int(i)] for i in rows]
            return idxs, frames, valid

        def make(idxs, frames, valid):
            if batch_items is not None:
                batch = (batch_items(idxs) if frames is None
                         else batch_items(idxs, frames))
            else:
                batch = collate([self.dataset[int(j)] for j in idxs])
            if valid is not None:
                batch["valid"] = valid
            return batch

        if self.sync:
            for idxs in self._batch_indices():
                yield make(*plan(idxs))
            return

        it = self._batch_indices()
        ex = ThreadPoolExecutor(self.num_workers)
        try:
            in_flight: deque = deque()
            for idxs in it:
                in_flight.append(ex.submit(make, *plan(idxs)))
                if len(in_flight) >= self.prefetch + self.num_workers:
                    break
            while in_flight:
                batch = in_flight.popleft().result()
                nxt = next(it, None)
                if nxt is not None:
                    in_flight.append(ex.submit(make, *plan(nxt)))
                yield batch
        finally:
            # an abandoned iterator does not wait for prefetched work; at
            # interpreter exit the queue module may be torn down already
            try:
                ex.shutdown(wait=False, cancel_futures=True)
            except Exception:
                pass
