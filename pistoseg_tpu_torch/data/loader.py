"""Host input pipeline feeding static-shape batches.

A thread-pool prefetching loader (PNG decode releases the GIL in PIL/zlib)
that collates samples into fixed-shape numpy batches.  The final ragged
batch is padded and flagged with a ``valid`` mask.  The port's own copy of
``collate``/``BatchLoader`` from ``pistoseg_tpu/data/loader.py``; batch
order is a pure function of (seed, epoch).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np


def collate(samples: Sequence[Dict], pad_to: Optional[int] = None) -> Dict:
    """Stack same-keyed arrays; strings become lists; pad batch dim."""
    batch: Dict = {}
    n = len(samples)
    total = pad_to or n
    for key in samples[0]:
        vals = [s[key] for s in samples]
        if isinstance(vals[0], (str, bytes)):
            batch[key] = list(vals) + [vals[-1]] * (total - n)
        else:
            arr = np.asarray(vals) if np.isscalar(vals[0]) else np.stack(vals)
            if total > n:
                arr = np.concatenate([arr, np.repeat(arr[-1:], total - n, 0)])
            batch[key] = arr
    batch["valid"] = np.arange(total) < n
    return batch


class BatchLoader:
    """Iterable over collated batches with thread-parallel sample loading."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = False,
        seed: int = 42,
        num_workers: int = 8,
        drop_last: bool = False,
        pad_last: bool = True,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.pad_last = pad_last

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def epoch(self, epoch: int = 0) -> Iterator[Dict]:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            np.random.RandomState(self.seed + epoch).shuffle(order)
        bs = self.batch_size
        starts = list(range(0, n, bs))
        if self.drop_last:
            starts = [s for s in starts if s + bs <= n]

        def finish(futs) -> Dict:
            samples = [f.result() for f in futs]
            pad = bs if (self.pad_last and len(samples) < bs) else None
            return collate(samples, pad_to=pad)

        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            # prefetch two batches ahead
            pending: List = []
            for start in starts:
                idxs = order[start : start + bs]
                pending.append([pool.submit(self.dataset.__getitem__, int(i))
                                for i in idxs])
                if len(pending) > 2:
                    yield finish(pending.pop(0))
            while pending:
                yield finish(pending.pop(0))

    def __iter__(self):
        return self.epoch(0)
