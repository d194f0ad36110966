"""Federated dataset container for the vmap'd simulation backend.

Stores the full sample bank once (images/labels) plus per-client index
tables (padded to the max client size, with counts).  Per round it samples
local SGD batches *with replacement* inside each client's own training
indices - this is the one documented deviation from per-epoch sequential
batching (DESIGN.md §8): every client runs the same number T of local
iterations so the federation vmaps/scans as a single SPMD program.  With
T = ceil(mean_n / batch) the expected sample usage matches the paper's
"one local epoch".
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np


@dataclass
class FederatedData:
    images: np.ndarray  # (N, H, W, C) f32 - the global sample bank
    labels: np.ndarray  # (N,) int32
    train_idx: np.ndarray  # (K, max_train) int64, padded with repeats
    train_counts: np.ndarray  # (K,) int64
    test_idx: np.ndarray  # (K, max_test) int64
    test_counts: np.ndarray  # (K,) int64

    @property
    def n_clients(self) -> int:
        return self.train_idx.shape[0]

    @classmethod
    def from_partition(
        cls,
        images: np.ndarray,
        labels: np.ndarray,
        client_indices: List[np.ndarray],
        train_frac: float = 0.8,
        seed: int = 0,
    ) -> "FederatedData":
        """80/20 per-client train/test split (paper Sec. V-A)."""
        rng = np.random.RandomState(seed)
        tr, te, ntr, nte = [], [], [], []
        for idx in client_indices:
            idx = np.asarray(idx, np.int64)
            rng.shuffle(idx)
            k = max(1, int(round(train_frac * len(idx)))) if len(idx) else 0
            tr.append(idx[:k])
            te.append(idx[k:] if len(idx) - k > 0 else idx[:1])  # >=1 test sample
            ntr.append(len(tr[-1]))
            nte.append(len(te[-1]))

        def pad(rows):
            m = max(1, max(len(r) for r in rows))
            out = np.zeros((len(rows), m), np.int64)
            for i, r in enumerate(rows):
                if len(r) == 0:
                    continue
                reps = int(np.ceil(m / len(r)))
                out[i] = np.tile(r, reps)[:m]
            return out

        return cls(
            images=np.asarray(images, np.float32),
            labels=np.asarray(labels, np.int32),
            train_idx=pad(tr),
            train_counts=np.asarray(ntr, np.int64),
            test_idx=pad(te),
            test_counts=np.asarray(nte, np.int64),
        )

    # -- per-round sampling ------------------------------------------------

    def local_iters(self, batch: int) -> int:
        """T for 'one local epoch' semantics at the mean client size."""
        mean_n = max(1.0, float(self.train_counts.mean()))
        return max(1, int(np.ceil(mean_n / batch)))

    def sample_round_batches(self, rng: np.random.RandomState, client_ids, T: int, batch: int):
        """Returns {"images": (K',T,B,H,W,C), "labels": (K',T,B)}."""
        client_ids = np.asarray(client_ids)
        kprime = len(client_ids)
        slots = rng.randint(
            0,
            np.maximum(1, self.train_counts[client_ids])[:, None, None],
            size=(kprime, T, batch),
        )
        gidx = self.train_idx[client_ids][np.arange(kprime)[:, None, None], slots]
        return {"images": self.images[gidx], "labels": self.labels[gidx]}

    def client_test_set(self, client_ids):
        """Padded per-client test sets + masks.

        Returns {"images": (K',M,H,W,C), "labels": (K',M), "mask": (K',M)}.
        """
        client_ids = np.asarray(client_ids)
        gidx = self.test_idx[client_ids]
        m = gidx.shape[1]
        mask = np.arange(m)[None, :] < self.test_counts[client_ids][:, None]
        return {
            "images": self.images[gidx],
            "labels": self.labels[gidx],
            "mask": mask.astype(np.float32),
        }
