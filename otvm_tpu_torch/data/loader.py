"""Epoch order, the batching loader and the uint8 wire format of training
batches, counterpart of otvm_tpu/data/loader.py.

`Loader` builds batches on background threads (the reference's
DataLoader(num_workers=8) per rank, train.py:294-301).  Its workers run the
dataset's numpy and cv2 code only, never torch: batches stay numpy until
the train step copies them to the card.

A train batch is a dict of [B, S, H, W, C] arrays (fg, bg, alpha, tri;
img for the trimap stage).  `encode_wire` quantizes it on the host to
uint8, the precision its 8-bit sources had: fg, bg and alpha as bytes, the
one-hot trimap as its label.  `decode_wire` restores the floats on the
device, inside the train step.
"""
from __future__ import annotations

import threading
from typing import Dict, Iterator, List, Mapping, Sequence

import numpy as np
import torch
import torch.nn.functional as F


def epoch_indices(n_items: int, epoch: int, repeats: int = 20, seed: int = 111,
                  process_index: int = 0, process_count: int = 1) -> np.ndarray:
    """The dataset repeated `repeats` times, shuffled by a per-epoch seed
    that every process shares, padded to a multiple of `process_count`
    (DistributedSampler semantics, train.py:283-304, 475-480) and strided
    by `process_index`."""
    idx = np.tile(np.arange(n_items), repeats)
    rng = np.random.RandomState(seed + epoch)
    rng.shuffle(idx)
    pad = (-len(idx)) % process_count
    if pad:
        idx = np.concatenate([idx, idx[:pad]])
    return idx[process_index::process_count]


def _collate(samples: Sequence[Mapping[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


class Loader:
    """Iterable over collated batches ([B, S, ...] numpy) that
    `num_threads` background threads build.

    Thread-count invariant: a sample's augmentation RNG is seeded by its
    position j in `indices`, not by the thread that draws it; threads claim
    whole batches in order and a reorder buffer yields them in order, so N
    threads give batches byte-identical to 1 thread.  An exception in a
    worker is raised to the consumer."""

    def __init__(self, dataset, indices: Sequence[int], batch_size: int,
                 seed: int = 0, num_threads: int = 1, drop_last: bool = True,
                 prefetch: int = 2):
        self.dataset = dataset
        self.indices = list(indices)
        self.batch_size = batch_size
        self.seed = seed
        self.num_threads = max(1, num_threads)
        self.drop_last = drop_last
        self.prefetch = prefetch

    def __len__(self):
        n = len(self.indices) // self.batch_size
        if not self.drop_last and len(self.indices) % self.batch_size:
            n += 1
        return n

    def _sample(self, j: int):
        rnd = np.random.RandomState((self.seed * 1_000_003 + j) % (2 ** 31 - 1))
        return self.dataset.__getitem__(int(self.indices[j]), rnd)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        n_batches = len(self)
        bs = self.batch_size
        cond = threading.Condition()
        results: Dict[int, Dict[str, np.ndarray]] = {}
        error: List[BaseException] = []
        next_claim = [0]      # the next batch a worker may take
        next_yield = [0]      # the next batch the consumer wants
        # at most `prefetch` finished batches ahead, plus one in flight a thread
        max_ahead = self.prefetch + self.num_threads

        def worker():
            while True:
                with cond:
                    while (next_claim[0] - next_yield[0] >= max_ahead
                           and not error and next_claim[0] < n_batches):
                        cond.wait(0.05)
                    if error or next_claim[0] >= n_batches:
                        return
                    i = next_claim[0]
                    next_claim[0] += 1
                try:
                    lo = i * bs
                    hi = min(lo + bs, len(self.indices))
                    batch = _collate([self._sample(j) for j in range(lo, hi)])
                except BaseException as e:  # handed to the consumer, which raises it
                    with cond:
                        error.append(e)
                        cond.notify_all()
                    return
                with cond:
                    results[i] = batch
                    cond.notify_all()

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_threads)]
        for t in threads:
            t.start()
        try:
            for i in range(n_batches):
                with cond:
                    while i not in results and not error:
                        cond.wait(0.05)
                    if error:
                        raise error[0]
                    item = results.pop(i)
                    next_yield[0] = i + 1
                    cond.notify_all()
                yield item
        finally:
            with cond:  # an early exit retires the workers
                if not error:
                    error.append(GeneratorExit("loader closed"))
                next_claim[0] = n_batches
                cond.notify_all()
            for t in threads:
                t.join()


def encode_wire(sample: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """fg, bg and alpha as uint8 (rounded), the one-hot trimap as its uint8
    label; other entries unchanged.  The error is at most 0.5/255 on values
    whose sources were 8-bit."""
    out = {}
    for k, v in sample.items():
        if k in ("fg", "bg", "alpha"):
            out[k] = np.rint(v * 255.0).astype(np.uint8)
        elif k == "tri":
            out[k] = np.argmax(v, axis=-1).astype(np.uint8)
        else:
            out[k] = v
    return out


def decode_wire(batch: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """encode_wire's inverse on the batch's device; float entries pass
    unchanged."""
    out = dict(batch)
    for k in ("fg", "bg", "alpha"):
        if k in out and out[k].dtype == torch.uint8:
            out[k] = out[k].float() / 255.0
    if "tri" in out and out["tri"].dtype == torch.uint8:
        out["tri"] = F.one_hot(out["tri"].long(), 3).float()
    return out
