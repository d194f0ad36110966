"""The FL methods of the paper's comparison (Table II): the ``FLMethod``
contract, FedAvg, FedProx, FedAvg-FT, FedProx-FT, Ditto, FedRep,
LocalOnly, SCAFFOLD, FedExP and the pFedSOP adapter.  Port of
``repro/core/baselines.py``.

Client state, uploads and the broadcast are flat f32 vectors (one row per
client at rest, ``repro_torch.utils.pytree.FlatLayout``), or dicts of
them; ``loss_fn`` and ``eval`` functions take such a vector.  Local
training is plain SGD (Algorithm 2 of the paper), for the baselines too.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Protocol, runtime_checkable

import torch

from repro_torch.core import pfedsop as pf
from repro_torch.optim.reduce import cohort_mean, cohort_size, cohort_sum
from repro_torch.optim.sgd import chunked_value_and_grad, sgd_loop
from repro_torch.utils.pytree import tree_leaves, tree_map


@runtime_checkable
class FLMethod(Protocol):
    """The FL-method contract consumed by ``repro_torch.fl``.

    A method is a frozen, hashable object with these functions.
    ``round_start`` sees the whole gathered cohort; ``client_round`` and
    ``eval_params`` see ONE client and are mapped over the cohort with
    ``torch.func.vmap`` (no ``.item()``, no python branch on a tensor
    value, no data-dependent shapes).

    init_client(params) -> client_state
        Per-client state from the shared init; stacked on a leading K
        axis at rest (``repro_torch.fl.cohort_store``).
    init_server(params) -> broadcast
        What the server sends every round (shared by the cohort).
    round_start(states, broadcast) -> (states, metrics)
        The cohort-wide step before the client map, on (C, ...)-stacked
        states.  pFedSOP's round-start update runs here as ONE batched
        kernel launch pair; other methods return the states unchanged.
    client_round(loss_fn, state, broadcast, batches) ->
            (new_state, upload, metrics)
        One client's local phase; ``batches`` has a leading
        local-iteration axis T.  ``metrics`` holds at least {"loss"}.
    server_update(broadcast, uploads) -> new_broadcast
        Aggregation over the stacked upload axis.
    server_update_stale(broadcast, uploads, staleness) -> new_broadcast
        The async driver's aggregation: upload i also carries its
        staleness tau_i (int32, (B,)), the server versions applied since
        its client was dispatched.  MUST equal ``server_update`` bit for
        bit when every tau is 0, which is what makes the degenerate async
        configuration reproduce the synchronous history.  Only the async
        driver calls it, so a sync-only method may omit it.
    eval_params(state, broadcast) -> params
        The parameters a client deploys for local test accuracy.
    """

    name: str

    def init_client(self, params): ...

    def init_server(self, params): ...

    def round_start(self, states, broadcast): ...

    def client_round(self, loss_fn, state, broadcast, batches): ...

    def server_update(self, broadcast, uploads): ...

    def server_update_stale(self, broadcast, uploads, staleness): ...

    def eval_params(self, state, broadcast): ...


def _mean_like(uploads):
    """Eq.-13-style canonically associated mean, cast to the upload dtype."""
    return tree_map(lambda u, m: m.to(u.dtype), uploads, cohort_mean(uploads))


def staleness_weights(staleness, exponent):
    """Mean-one normalized polynomial staleness weights, f32 (B,):
    w_i = s_i / mean(s), s_i = (1 + tau_i)^(-exponent).  Normalized so a
    weighted mean of full parameter vectors stays an affine combination;
    an all-fresh buffer gives exactly 1.0 per upload."""
    s = pf.staleness_discount(staleness, exponent)
    return s / s.mean()


def batches_len(batches):
    """Length T of the leading local-iteration axis of a batch dict."""
    return tree_leaves(batches)[0].shape[0]


# ---------------------------------------------------------------------------
# Shared local-SGD machinery
# ---------------------------------------------------------------------------


def local_train(loss_fn: Callable, params, batches: Any, lr: float,
                mask: Optional[torch.Tensor] = None, prox: Optional[tuple] = None):
    """T SGD iterations on a flat vector; returns (final_params, mean_loss).
    ``mask`` freezes parameters (FedRep), ``prox`` = (mu, ref) adds the
    FedProx/Ditto proximal term (``repro_torch.optim.sgd.sgd_loop``)."""
    return sgd_loop(loss_fn, params, batches, lr, mask, prox)


# ---------------------------------------------------------------------------
# Method classes
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class FedAvg:
    lr: float = 0.01
    name: str = "fedavg"
    # polynomial staleness-discount exponent of the async aggregation hook
    staleness_exp: float = 0.5

    def init_client(self, params):
        return {}

    def init_server(self, params):
        return params

    def round_start(self, states, broadcast):
        return states, {}

    def client_round(self, loss_fn, state, broadcast, batches):
        trained, loss = local_train(loss_fn, broadcast, batches, self.lr)
        return state, trained, {"loss": loss}

    def server_update(self, broadcast, uploads):
        return _mean_like(uploads)

    def server_update_stale(self, broadcast, uploads, staleness):
        """The FedAvg family's staleness hook: uploads scaled by the
        normalized polynomial discount, then ``server_update`` (which the
        subclasses may override)."""
        w = staleness_weights(staleness, self.staleness_exp)
        scaled = tree_map(
            lambda u: (u.float() * w.reshape((-1,) + (1,) * (u.dim() - 1))).to(u.dtype),
            uploads)
        return self.server_update(broadcast, scaled)

    def eval_params(self, state, broadcast):
        return broadcast


@dataclass(frozen=True)
class FedProx(FedAvg):
    mu: float = 0.1
    name: str = "fedprox"

    def client_round(self, loss_fn, state, broadcast, batches):
        trained, loss = local_train(loss_fn, broadcast, batches, self.lr,
                                    prox=(self.mu, broadcast))
        return state, trained, {"loss": loss}


@dataclass(frozen=True)
class FedAvgFT(FedAvg):
    """FedAvg + per-round fine-tune: the personalized model is the global
    model fine-tuned on local data BEFORE local training (paper Sec.
    V-B2); the upload continues training from the fine-tuned point."""

    name: str = "fedavg_ft"

    def init_client(self, params):
        return {"personal": params}

    def client_round(self, loss_fn, state, broadcast, batches):
        finetuned, loss_ft = local_train(loss_fn, broadcast, batches, self.lr)
        trained, loss = local_train(loss_fn, finetuned, batches, self.lr)
        return {"personal": finetuned}, trained, {"loss": 0.5 * (loss + loss_ft)}

    def eval_params(self, state, broadcast):
        return state["personal"]


@dataclass(frozen=True)
class FedProxFT(FedAvgFT):
    mu: float = 0.1
    name: str = "fedprox_ft"

    def client_round(self, loss_fn, state, broadcast, batches):
        finetuned, loss_ft = local_train(loss_fn, broadcast, batches, self.lr)
        trained, loss = local_train(loss_fn, finetuned, batches, self.lr,
                                    prox=(self.mu, broadcast))
        return {"personal": finetuned}, trained, {"loss": 0.5 * (loss + loss_ft)}


@dataclass(frozen=True)
class Ditto(FedAvg):
    """Ditto: global track = FedAvg; personal track trained with a
    proximal pull toward the received global model (lam)."""

    lam: float = 0.1
    name: str = "ditto"

    def init_client(self, params):
        return {"personal": params}

    def client_round(self, loss_fn, state, broadcast, batches):
        trained, _ = local_train(loss_fn, broadcast, batches, self.lr)
        personal, loss_p = local_train(loss_fn, state["personal"], batches, self.lr,
                                       prox=(self.lam, broadcast))
        return {"personal": personal}, trained, {"loss": loss_p}

    def eval_params(self, state, broadcast):
        return state["personal"]


@dataclass(frozen=True)
class FedRep(FedAvg):
    """FedRep: aggregate the body (feature extractor); the head stays local.

    ``head_predicate(path) -> True`` marks head leaves, where ``path`` is
    the leaf's path string as ``repro`` forms it (``"['fc_w']"``,
    ``"['blocks']/[0]/['conv1']"``; the example uses ``"fc_" in p``).  The
    mask is a flat (N,) 0/1 vector over ``layout``'s leaves; the
    federation binds its ``FlatLayout`` at construction
    (``repro_torch.fl.runtime.bind_layout``)."""

    head_predicate: Callable = None  # set at construction
    name: str = "fedrep"
    layout: Any = field(default=None, compare=False)

    def head_mask(self, device=None) -> torch.Tensor:
        if self.layout is None:
            raise ValueError("FedRep needs the federation's FlatLayout to build "
                             "its head mask (repro_torch.fl.runtime.bind_layout)")
        return self.layout.leaf_mask(self.head_predicate, device)

    def _local_model(self, state, broadcast):
        head = self.head_mask(broadcast.device)
        return head, torch.where(head > 0, state["head"], broadcast)

    def init_client(self, params):
        return {"head": params}  # the full vector; only the head is used

    def client_round(self, loss_fn, state, broadcast, batches):
        head, params = self._local_model(state, broadcast)
        params, _ = local_train(loss_fn, params, batches, self.lr, mask=head)
        params, loss = local_train(loss_fn, params, batches, self.lr, mask=1.0 - head)
        return {"head": params}, params, {"loss": loss}

    def eval_params(self, state, broadcast):
        return self._local_model(state, broadcast)[1]


@dataclass(frozen=True)
class LocalOnly(FedAvg):
    """No communication: each client trains alone (overfitting reference)."""

    name: str = "local"

    def init_client(self, params):
        return {"personal": params}

    def client_round(self, loss_fn, state, broadcast, batches):
        personal, loss = local_train(loss_fn, state["personal"], batches, self.lr)
        return {"personal": personal}, torch.zeros_like(broadcast), {"loss": loss}

    def server_update(self, broadcast, uploads):
        return broadcast  # nothing aggregated

    def eval_params(self, state, broadcast):
        return state["personal"]


@dataclass(frozen=True)
class PFedSOP:
    """Adapter around ``repro_torch.core.pfedsop``.

    broadcast = {"delta": global delta (N,), "has_delta": bool};
    upload = local delta; client_state = ``pfedsop.ClientState``.  The
    round-start update impl is ``cfg.update_impl``; a run-level override
    (``FLRunConfig.update_impl``) is pushed in by
    ``repro_torch.fl.runtime.override_update_impl``."""

    cfg: pf.PFedSOPConfig = field(default_factory=pf.PFedSOPConfig)
    name: str = "pfedsop"

    def init_client(self, params):
        return pf.init_client_state(params)

    def init_server(self, params):
        return {"delta": torch.zeros_like(params),
                "has_delta": torch.zeros((), dtype=torch.bool,
                                         device=params.device)}

    def round_start(self, states, broadcast):
        return pf.round_start(states, broadcast["delta"],
                              broadcast["has_delta"], self.cfg)

    def client_round(self, loss_fn, state, broadcast, batches):
        return pf.local_round(loss_fn, state, batches, self.cfg)

    def server_update(self, broadcast, uploads):
        return {"delta": pf.server_aggregate(uploads),
                "has_delta": torch.ones_like(broadcast["has_delta"])}

    def server_update_stale(self, broadcast, uploads, staleness):
        """Each upload down-blended toward the current global delta with
        weight (1 - s(tau)) (1 - beta) (``pfedsop.stale_blend``), then the
        Eq. 13 mean; fresh uploads pass through bit for bit."""
        s = pf.staleness_discount(staleness, self.cfg.staleness_exp)
        blended = pf.stale_blend(uploads, broadcast["delta"], s, self.cfg.lam,
                                 self.cfg.eps)
        return {"delta": pf.server_aggregate(blended),
                "has_delta": torch.ones_like(broadcast["has_delta"])}

    def eval_params(self, state, broadcast):
        return state.params


METHODS = {
    "fedavg": FedAvg,
    "fedprox": FedProx,
    "fedavg_ft": FedAvgFT,
    "fedprox_ft": FedProxFT,
    "ditto": Ditto,
    "fedrep": FedRep,
    "local": LocalOnly,
    "pfedsop": PFedSOP,
}


@dataclass(frozen=True)
class Scaffold(FedAvg):
    """SCAFFOLD (Karimireddy et al., 2020): control variates correct the
    client drift.  The client keeps c_i; the broadcast carries (x, c).
    Option II update of c_i:

    client:  y <- y - lr * (g(y) - c_i + c)         (T iterations)
             c_i' = c_i - c + (x - y_T)/(T * lr)
             upload (y_T, c_i' - c_i)
    server:  x <- mean(y_T);  c <- c + mean(dc)
    """

    name: str = "scaffold"

    def init_client(self, params):
        return {"c_i": torch.zeros_like(params)}

    def init_server(self, params):
        return {"x": params, "c": torch.zeros_like(params)}

    def client_round(self, loss_fn, state, broadcast, batches):
        x, c = broadcast["x"], broadcast["c"]
        c_i = state["c_i"]
        correction = c.float() - c_i.float()
        grad_fn = chunked_value_and_grad(loss_fn)
        t_len = batches_len(batches)
        p, losses = x, []
        for t in range(t_len):
            loss, g = grad_fn(p, {k: v[t] for k, v in batches.items()})
            p = (p.float() - self.lr * (g.float() + correction)).to(p.dtype)
            losses.append(loss)
        new_c_i = (c_i.float() - c.float()
                   + (x.float() - p.float()) / (t_len * self.lr)).to(c_i.dtype)
        dc = new_c_i.float() - c_i.float()
        return {"c_i": new_c_i}, {"y": p, "dc": dc}, {"loss": torch.stack(losses).mean()}

    def server_update(self, broadcast, uploads):
        new_x = cohort_mean(uploads["y"]).to(broadcast["x"].dtype)
        c = broadcast["c"]
        new_c = (c.float() + cohort_mean(uploads["dc"])).to(c.dtype)
        return {"x": new_x, "c": new_c}

    def eval_params(self, state, broadcast):
        return broadcast["x"]


@dataclass(frozen=True)
class FedExP(FedAvg):
    """FedExP (Jhunjhunwala et al., ICLR 2023): server-side adaptive
    extrapolation.

        eta_g = max(1, sum_i ||d_i||^2 / (2 K' (||mean d||^2 + eps)))
        x <- x - eta_g * mean(d_i),  d_i = x - y_i

    The max is a tensor ``clamp_min``: no host sync."""

    eps: float = 1e-3
    name: str = "fedexp"

    def client_round(self, loss_fn, state, broadcast, batches):
        trained, loss = local_train(loss_fn, broadcast, batches, self.lr)
        return state, broadcast.float() - trained.float(), {"loss": loss}

    def server_update(self, broadcast, uploads):
        mean_d = cohort_mean(uploads)
        u = uploads.float()
        per_client_sq = (u * u).sum(-1)
        kprime = cohort_size(uploads.shape[0])
        mean_sq = (mean_d * mean_d).sum()
        eta_g = (cohort_sum(per_client_sq)
                 / (2.0 * kprime * (mean_sq + self.eps))).clamp_min(1.0)
        return (broadcast.float() - eta_g * mean_d).to(broadcast.dtype)


METHODS["scaffold"] = Scaffold
METHODS["fedexp"] = FedExP
