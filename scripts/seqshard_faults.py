"""The planted faults of the sequence-parallel prefill, which the checks of
``chip_smoke.py`` (phase 20) and ``tests/test_torch_seqshard.py`` must
catch.  ``faults()`` maps each fault's name to (module, attribute, the
faulty replacement); the caller patches one in, runs a prefill of the
arch ``ARCH`` names for it (``<arch>/<moe_impl>`` where the impl is not
the config's) and puts the sound attribute back.  Imports only
``repro_torch``.
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


def state_not_carried(h, a, tp):
    """The SSM state entering every rank's first position zero."""
    return torch.zeros_like(h)


def halo_zeroed(x, tp, k):
    """The conv halo zeros on every rank."""
    return x.new_zeros((x.shape[0], k) + tuple(x.shape[2:]))


def fold_reversed(h, a, tp):
    """The gathered states folded in reverse rank order: rank r folds
    ranks m - 1, m - 2, .. m - r (at m = 2, rank 1 its own)."""
    from repro_torch.launch import collectives

    parts = collectives.all_gather(torch.cat([h.flatten(2), a[..., None]], dim=-1)[None],
                                   tp.group, dim=0).flip(0)
    out = torch.zeros_like(h)
    for j in range(tp.rank):
        out = out * torch.exp(parts[j, ..., -1])[..., None, None] + \
            parts[j, ..., :-1].reshape(h.shape)
    return out


def patches_first(rows, n_patches):
    """Every rank taking the patches for its own first positions (as if
    its rows began the sequence)."""
    n = rows.stop - rows.start
    return slice(0, min(n, n_patches)), slice(0, n - min(n, n_patches))


def codebooks_rank0_only(tokens, emb, tp):
    """Only model rank 0's vocab partials summed: the tokens in the other
    ranks' vocab slices embed to zeros."""
    local = tokens.long() - tp.rank * emb.shape[0]
    inside = (local >= 0) & (local < emb.shape[0]) & (tp.rank == 0)
    rows = torch.nn.functional.embedding(local.clamp(0, emb.shape[0] - 1), emb)
    return rows * inside[..., None].to(rows.dtype)


def slots_local(c, tp):
    """The dispatch slot positions left local: no earlier rank's slots
    counted, and the earlier rows' slots this rank's only."""
    return torch.zeros_like(c, dtype=torch.int64), c.long()


# fault -> the arch (and MoE impl) it is read on
ARCH = {"rope_local_positions": "gemma3-1b", "kv_not_gathered": "gemma3-1b",
        "k5_at_q0_zero": "gemma3-1b", "scatter_reversed": "gemma3-1b",
        "last_from_rank0": "gemma3-1b", "ssm_state_not_carried": "zamba2-2.7b",
        "halo_zeroed": "zamba2-2.7b", "state_fold_reversed": "zamba2-2.7b",
        "patches_on_wrong_ranks": "internvl2-2b",
        "codebooks_rank0_only": "musicgen-large",
        "dispatch_slots_local": "granite-moe-1b-a400m/dispatch"}


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
        "ssm_state_not_carried": (parallel, "seq_state_prefix", state_not_carried),
        "halo_zeroed": (parallel, "seq_halo", halo_zeroed),
        "state_fold_reversed": (parallel, "seq_state_prefix", fold_reversed),
        "patches_on_wrong_ranks": (tf, "_frontend_rows", patches_first),
        "codebooks_rank0_only": (parallel, "vocab_partial", codebooks_rank0_only),
        "dispatch_slots_local": (parallel, "seq_counts_before", slots_local),
    }
