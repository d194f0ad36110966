"""The paper's two heterogeneous partitioners (Sec. V-A).

``dirichlet_partition``   - FedDWA-style: for each class, the class's samples
                            are split across the K clients with proportions
                            drawn from Dir(alpha); alpha=0.07 in the paper.
``pathological_partition``- FedALA-style shard partitioner: samples sorted by
                            label are cut into s shards of size z; each
                            client receives b = s/K shards, so it sees ~b
                            classes (z=200/600/1000 for CIFAR10/100/Tiny).

Both return a list of K index arrays into the input label vector.
"""
from __future__ import annotations

import numpy as np


def dirichlet_partition(labels: np.ndarray, n_clients: int, alpha: float, seed: int = 0):
    rng = np.random.RandomState(seed)
    n_classes = int(labels.max()) + 1
    client_idx = [[] for _ in range(n_clients)]
    for c in range(n_classes):
        idx = np.where(labels == c)[0]
        rng.shuffle(idx)
        props = rng.dirichlet(np.full(n_clients, alpha))
        # split points from cumulative proportions
        cuts = (np.cumsum(props) * len(idx)).astype(int)[:-1]
        for i, part in enumerate(np.split(idx, cuts)):
            client_idx[i].extend(part.tolist())
    out = []
    for i in range(n_clients):
        arr = np.asarray(client_idx[i], np.int64)
        rng.shuffle(arr)
        out.append(arr)
    return out


def pathological_partition(labels: np.ndarray, n_clients: int, shard_size: int, seed: int = 0):
    """Sort-by-label -> shards of ``shard_size`` -> b shards per client."""
    rng = np.random.RandomState(seed)
    n = len(labels)
    order = np.argsort(labels, kind="stable")
    n_shards = n // shard_size
    usable = n_shards * shard_size
    shards = order[:usable].reshape(n_shards, shard_size)
    perm = rng.permutation(n_shards)
    b = n_shards // n_clients
    assert b >= 1, f"need >= {n_clients} shards, got {n_shards}"
    out = []
    for i in range(n_clients):
        take = perm[i * b : (i + 1) * b]
        idx = shards[take].reshape(-1).copy()
        rng.shuffle(idx)
        out.append(idx.astype(np.int64))
    return out
