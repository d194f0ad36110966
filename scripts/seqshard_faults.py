"""The planted faults of the sequence-parallel prefill, which the checks of
``chip_smoke.py`` (phase 20) and ``tests/test_torch_seqshard.py`` must
catch.  ``faults()`` maps each fault's name to (module, attribute, the
faulty replacement); the caller patches one in, runs a prefill and puts
the sound attribute back.  Imports only ``repro_torch``.
"""
import torch


def local_positions(rows, b, device):
    """RoPE on positions counted from this rank's first."""
    return torch.arange(rows.stop - rows.start, dtype=torch.int32, device=device)[None].expand(
        b, -1)


def own_keys(k, v, tp):
    """K/V not gathered: each rank attends its own positions only (as a
    sequence of its own)."""
    return k, v, 0


def keys_at_zero(k, v, tp):
    """The gathered keys, but K5 launched at q0 = 0."""
    from repro_torch.models import parallel

    hi = (tp.rank + 1) * k.shape[1]
    return parallel.gather(k, tp, 1)[:, :hi], parallel.gather(v, tp, 1)[:, :hi], 0


def scatter_reversed(x, tp):
    """The embedding's reduce-scatter in reversed rank order (rank r takes
    rank m - 1 - r's positions)."""
    from repro_torch.launch import collectives

    return collectives.reduce_scatter(torch.cat(x.chunk(tp.size, 1)[::-1], 1), tp.group, 1)


def last_from_rank0(x, tp):
    """The last position taken from model rank 0."""
    from repro_torch.launch import collectives

    return collectives.broadcast(x[:, -1:].contiguous(), src=0, group=tp.group)


def faults():
    """name -> (module, attribute, the faulty replacement)."""
    from repro_torch.models import attention, parallel
    from repro_torch.models import transformer as tf

    return {
        "rope_local_positions": (tf, "_seq_positions", local_positions),
        "kv_not_gathered": (attention, "_seq_keys", own_keys),
        "k5_at_q0_zero": (attention, "_seq_keys", keys_at_zero),
        "scatter_reversed": (parallel, "seq_scatter", scatter_reversed),
        "last_from_rank0": (parallel, "seq_last", last_from_rank0),
    }
