"""The multi-device slice's single-process parts against ``repro``.

- Layout functions, equal to ``repro``'s: ``MeshSpec``/``parse_mesh`` on a
  grid of spec strings (fields, roles, signature, errors),
  ``resolve_shards`` and ``resolve_client_split`` on grids (values and
  refusals), and the spec rules (``param_pspecs``,
  ``client_stacked_pspecs``, ``cache_pspecs``, ``batch_pspecs``,
  ``replicated``) leaf for leaf equal to ``tuple(P)`` of ``repro``'s on the
  CNN's tree and on reduced gemma3-1b and granite-moe-1b-a400m trees.
- The shard contexts and the gradient-chunk count; the collective census
  in ``repro``'s ``{op: {bytes, count}}`` schema, read by
  ``roofline_terms``; a collective under ``torch.func.vmap`` refused.
- ``grad_chunks=2`` computed in the body: the port's vmap history against
  ``repro``'s ``VmapBackend`` at ``grad_chunks=2`` (loss rtol 1e-5,
  accuracy atol 1e-6, parameters atol 1e-5, as
  ``tests/test_torch_pfedsop.py``).
- The tile-range plain K1/K2 (every rank's range at m = 2, 3, 4, 8, the
  zero-padded partials summed in rank order) bitwise equal to the
  whole-range plain pair.
- At one rank (an in-process gloo group): shard_map and mesh federations,
  replicated and sharded, on the device and host stores, bitwise the vmap
  history.
"""
import itertools

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch_dist_workers import federation, final

from repro.configs import get_config as j_get_config
from repro.configs.resnet_cifar import SMALL_CNN as J_CFG
from repro.core import baselines as j_bl
from repro.data import FederatedData as JData
from repro.data import dirichlet_partition, make_class_conditional_images
from repro.fl import Federation as JFederation, FLRunConfig as JRunConfig
from repro.fl import engine as j_engine
from repro.fl.runtime import masked_accuracy as j_masked_accuracy
from repro.launch import mesh as j_mesh
from repro.launch import sharding as j_sh
from repro.launch import steps as j_steps
from repro.models import cnn as j_cnn
from repro.utils.pytree import tree_flatten_to_vector
from repro_torch.configs import get_config
from repro_torch.configs.resnet_cifar import SMALL_CNN as T_CFG
from repro_torch.core import baselines as t_bl
from repro_torch.data import FederatedData as TData
from repro_torch.fl import Federation as TFederation, FLRunConfig as TRunConfig
from repro_torch.fl import StoreConfig
from repro_torch.fl import engine as t_engine
from repro_torch.fl import masked_accuracy as t_masked_accuracy
from repro_torch.kernels import dispatch
from repro_torch.kernels.pfedsop_update import ops
from repro_torch.launch import collectives, roofline
from repro_torch.launch import mesh as t_mesh
from repro_torch.launch import sharding as t_sh
from repro_torch.launch import steps as t_steps
from repro_torch.models import cnn as t_cnn
from repro_torch.utils.pytree import tree_leaves
from repro_torch.weights import params_from_jax


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def one_rank():
    """A one-rank gloo group for the test's duration."""
    collectives.init_world("cpu")
    try:
        yield
    finally:
        dist.destroy_process_group()


# -- layout functions ---------------------------------------------------------

SPECS = ["clients", "clients:0", "clients:3", "CLIENTS:8", "host", "pod:2x4", "pods:2x2x2",
         "pods:1x1x1", " pods:4x1x2 ", "pod:16x16", "pods:2x16x16",
         "clients:-1", "pod:2", "pods:2x2", "host:1", "mesh", "pod:axb", "", "pods:0x1x1"]


@pytest.mark.parametrize("text", SPECS)
def test_parse_mesh_equals_repro(text):
    try:
        want = j_mesh.parse_mesh(text)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            t_mesh.parse_mesh(text)
        assert str(got.value).split(";")[0] == str(e).split(";")[0]
        return
    got = t_mesh.parse_mesh(text)
    for f in ("shape", "axes", "client_axis", "data_axis", "model_axis", "n_devices",
              "client_size", "data_size", "model_size"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.signature() == want.signature()
    assert t_mesh.is_auto_clients(got) == j_mesh.is_auto_clients(want)


def test_mesh_spec_constructors_and_checks_equal_repro():
    for name, args in [("clients", (4,)), ("clients", (2, "c")), ("host", ()),
                       ("single_pod", (4, 2)), ("multi_pod", (2, 1, 2))]:
        got, want = getattr(t_mesh.MeshSpec, name)(*args), getattr(j_mesh.MeshSpec, name)(*args)
        assert (got.shape, got.axes, got.signature()) == (want.shape, want.axes, want.signature())
    for bad in [dict(shape=(2,), axes=("a", "b")), dict(shape=(2, 2), axes=("a", "a")),
                dict(shape=(0,), axes=("a",)), dict(shape=(2,), axes=("a",), model_axis="b")]:
        with pytest.raises(ValueError):
            j_mesh.MeshSpec(**bad)
        with pytest.raises(ValueError):
            t_mesh.MeshSpec(**bad)


def _outcome(fn, *args, **kw):
    try:
        return fn(*args, **kw)
    except ValueError:
        return "ValueError"


def test_resolve_shards_equals_repro_on_a_grid():
    for kprime, devices, requested in itertools.product(range(1, 13), (1, 2, 3, 4, 8),
                                                        (-1, 0, 1, 2, 3, 4, 6, 8)):
        assert (_outcome(t_engine.resolve_shards, kprime, devices, requested)
                == _outcome(j_engine.resolve_shards, kprime, devices, requested))


def test_resolve_client_split_equals_repro_on_a_grid():
    for kprime, text, strict in itertools.product(
            range(1, 13), ("pods:2x1x1", "pods:3x2x1", "pods:1x2x2", "pod:2x2", "clients:4",
                           "host"), (True, False)):
        assert (_outcome(t_engine.resolve_client_split, kprime, t_mesh.parse_mesh(text), strict)
                == _outcome(j_engine.resolve_client_split, kprime, j_mesh.parse_mesh(text),
                            strict)), (kprime, text, strict)


def _trees(arch):
    """(repro abstract tree, port meta tree) of a reduced arch's params."""
    return (j_steps.abstract_params(j_get_config(arch, reduced=True)),
            t_steps.abstract_params(get_config(arch, reduced=True)))


def _flat(spec, like, out):
    """The specs of a port spec tree in the leaf order of ``like``, the
    tree it was made from (a spec is a tuple: the walk follows ``like``)."""
    if isinstance(like, dict):
        for k in sorted(like):
            _flat(spec[k], like[k], out)
    elif isinstance(like, (list, tuple)):
        for s, x in zip(spec, like):
            _flat(s, x, out)
    else:
        out.append(spec)
    return out


def _equal_specs(got_tree, want_tree, like):
    want = [tuple(p) for p in jax.tree.leaves(
        want_tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))]
    got = _flat(got_tree, like, [])
    assert got == want and len(got) == len(tree_leaves(like))


@pytest.mark.parametrize("arch", ["gemma3-1b", "granite-moe-1b-a400m"])
@pytest.mark.parametrize("msize", [1, 2, 4])
def test_param_specs_equal_repro(arch, msize):
    jtree, ttree = _trees(arch)
    _equal_specs(t_sh.param_pspecs(ttree, msize), j_sh.param_pspecs(jtree, msize), ttree)
    stack = lambda t, n: jax.tree.map(  # noqa: E731
        lambda x: jax.ShapeDtypeStruct((n,) + x.shape, x.dtype), t)
    tstack = t_steps._stack_client(ttree, 4)
    _equal_specs(t_sh.client_stacked_pspecs(tstack, "pod", "model", msize),
                 j_sh.client_stacked_pspecs(stack(jtree, 4), "pod", "model", msize), tstack)
    _equal_specs(t_sh.replicated(tstack, True, "pod"),
                 j_sh.replicated(stack(jtree, 4), True, "pod"), tstack)


def test_cnn_and_cache_and_batch_specs_equal_repro():
    jp = jax.eval_shape(lambda k: j_cnn.init_params(k, J_CFG), jax.random.PRNGKey(0))
    tp = t_cnn.init_params(torch.Generator().manual_seed(0), T_CFG, device="cpu")
    for msize in (1, 2, 4):
        _equal_specs(t_sh.param_pspecs(tp, msize), j_sh.param_pspecs(jp, msize), tp)
    # the federation's flat (K', N) state: the plain client split at any model size
    flat = {"params": torch.zeros(4, 33), "delta": torch.zeros(4, 33)}
    assert t_sh.client_stacked_specs(flat, "pod", "model", 2) == [("pod", None)] * 2
    cfg = "gemma3-1b"
    jc = j_steps.abstract_caches(j_get_config(cfg, reduced=True), 4, 64)
    tc = t_steps.abstract_caches(get_config(cfg, reduced=True), 4, 64)
    _equal_specs(t_sh.cache_pspecs(tc, 2, 2), j_sh.cache_pspecs(jc, 2, 2), tc)
    batch = {"tokens": np.zeros((3, 4, 8), np.int32), "labels": np.zeros((3, 5), np.int32)}
    for idx, client in [(0, False), (1, True)]:
        _equal_specs(t_sh.batch_pspecs(batch, 2, idx, client, "pod"),
                     j_sh.batch_pspecs(batch, 2, idx, client, "pod"), batch)


# -- contexts, census, refusals -----------------------------------------------


def test_shard_contexts_nest_and_unwind():
    for ctx, cur in [(dispatch.model_shard_axis, dispatch.current_model_shard),
                     (dispatch.client_shard_axis, dispatch.current_client_shard),
                     (dispatch.data_shard_axis, dispatch.current_data_shard)]:
        assert cur() is None
        with ctx("g1", 2):
            assert cur() == ("g1", 2)
            with ctx("g2", 4):
                assert cur() == ("g2", 4)
            assert cur() == ("g1", 2)
        assert cur() is None
    assert dispatch.current_grad_chunks() == 1
    with dispatch.grad_chunk_count(2):
        assert dispatch.current_grad_chunks() == 2
    assert dispatch.current_grad_chunks() == 1


def test_census_schema_and_roofline(one_rank):
    collectives.reset_census()
    x = torch.arange(6, dtype=torch.float32).view(2, 3)
    assert torch.equal(collectives.all_gather(x), x)
    assert torch.equal(collectives.all_gather(torch.tensor([True, False])),
                       torch.tensor([True, False]))
    collectives.all_reduce(x.clone())
    collectives.broadcast(x.clone())
    collectives.barrier()
    got = collectives.census()
    assert got == {"all-gather": {"bytes": 24 + 2, "count": 2},
                   "all-reduce": {"bytes": 24, "count": 1},
                   "collective-broadcast": {"bytes": 24, "count": 1},
                   "barrier": {"bytes": 0, "count": 1}}
    terms = roofline.roofline_terms({"collectives": got}, 1)
    assert terms["collective_bytes_per_device"] == 74
    assert terms["collective_s"] == pytest.approx(74 / roofline.NVLINK_BW)


def test_a_collective_under_vmap_is_refused(one_rank):
    with pytest.raises(RuntimeError, match="under a torch.func transform"):
        torch.func.vmap(lambda v: collectives.all_gather(v))(torch.ones(3, 2))
    with pytest.raises(RuntimeError, match="under a torch.func transform"):
        torch.func.vmap(lambda v: collectives.all_reduce(torch.ones(2)) + v)(torch.ones(3, 2))


def test_resolve_mesh_lays_specs_over_the_group():
    with pytest.raises(RuntimeError, match="initialized torch.distributed"):
        t_mesh.make_host_mesh()
    collectives.init_world("cpu")
    try:
        host = t_mesh.make_host_mesh()
        assert host.mesh_dim_names == ("data", "model") and tuple(host.mesh.shape) == (1, 1)
        assert t_mesh.make_client_mesh(1).mesh_dim_names == ("clients",)
        assert t_mesh.resolve_mesh(t_mesh.MeshSpec.host()) is host  # one per group
        with pytest.raises(RuntimeError, match="needs 4 ranks.*mesh spec grammar"):
            t_mesh.resolve_mesh(t_mesh.parse_mesh("pods:2x1x2"))
    finally:
        dist.destroy_process_group()


def test_engine_factory_refusals_equal_repro(one_rank):
    for kw in [dict(backend="vmap", shards=2), dict(backend="vmap", mesh="host"),
               dict(backend="shard_map", mesh="host"), dict(backend="mesh", shards=2),
               dict(backend="mesh"), dict(backend="bogus")]:
        with pytest.raises(ValueError):
            j_engine.make_engine(kprime=4, **kw)
        with pytest.raises(ValueError):
            t_engine.make_engine(kprime=4, **kw)
    with pytest.raises(RuntimeError, match="needs 4 ranks"):
        t_engine.make_engine("mesh", 4, mesh="pods:2x1x2")
    assert t_engine.make_engine("mesh", 4, mesh="clients").describe()["shards"] == 1


# -- in-body gradient chunks against repro -------------------------------------


@pytest.fixture(scope="module")
def small_jax():
    images, labels = make_class_conditional_images(400, 10, 16, seed=0)
    jdata = JData.from_partition(images, labels, dirichlet_partition(labels, 8, alpha=0.07,
                                                                     seed=0), seed=0)
    jp = jax.jit(j_cnn.init_params, static_argnums=1)(jax.random.PRNGKey(0), J_CFG)
    return jdata, jp


@pytest.mark.parametrize("method", ["pfedsop", "fedavg"])
def test_grad_chunks_2_matches_repro_s_vmap_backend(small_jax, method):
    jdata, jp = small_jax
    j_method = j_bl.PFedSOP() if method == "pfedsop" else j_bl.FedAvg()
    extra = {"update_impl": "kernel_interpret"} if method == "pfedsop" else {}
    j_fed = JFederation(j_method, lambda p, b: j_cnn.loss_fn(p, J_CFG, b),
                        j_masked_accuracy(lambda p, t: j_cnn.apply(p, J_CFG, t["images"])),
                        jp, jdata, JRunConfig(n_clients=8, participation=0.5, rounds=2,
                                              batch=16, local_iters=2, seed=0,
                                              grad_chunks=2, **extra))
    j_hist = j_fed.run()
    # repro's init, so both start alike
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    t_fed = _port_fed(method, tp)
    t_hist = t_fed.run()
    np.testing.assert_allclose(t_hist["loss"], j_hist["loss"], rtol=1e-5)
    np.testing.assert_allclose(t_hist["acc"], j_hist["acc"], rtol=0, atol=1e-6)
    if method == "pfedsop":
        want = np.asarray(jax.vmap(tree_flatten_to_vector)(j_fed.client_states.params))
        got = t_fed.client_states.params.numpy()
    else:
        want, got = np.asarray(tree_flatten_to_vector(j_fed.broadcast)), t_fed.broadcast.numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    # and two chunks are another gradient than one (in the last bits)
    one = _port_fed(method, tp, grad_chunks=1)
    one.run()
    one = one.client_states.params if method == "pfedsop" else one.broadcast
    assert not torch.equal(torch.from_numpy(got), one)


def _port_fed(method, params, grad_chunks=2):
    images, labels = make_class_conditional_images(400, 10, 16, seed=0)
    data = TData.from_partition(images, labels,
                                dirichlet_partition(labels, 8, alpha=0.07, seed=0), seed=0)
    m = t_bl.PFedSOP() if method == "pfedsop" else t_bl.FedAvg()
    return TFederation(m, lambda p, b: t_cnn.loss_fn(p, T_CFG, b),
                       t_masked_accuracy(lambda p, t: t_cnn.apply(p, T_CFG, t["images"])),
                       params, data,
                       TRunConfig(n_clients=8, participation=0.5, rounds=2, batch=16,
                                  local_iters=2, seed=0, grad_chunks=grad_chunks),
                       device="cpu")


# -- the tile-range plain pair --------------------------------------------------


@pytest.mark.parametrize("c, n, dtype, shared", [
    (3, 4096 * 7 + 123, torch.float32, True), (2, 4096 * 5, torch.float32, False),
    (4, 4096 * 3 + 5, torch.bfloat16, True), (1, 4096 * 9 + 1, torch.float32, True)])
def test_tile_range_plain_pair_equals_the_whole_range(c, n, dtype, shared):
    g = torch.Generator().manual_seed(c)
    x = torch.randn(c, n, generator=g).to(dtype)
    di = (0.01 * torch.randn(c, n, generator=g)).to(dtype)
    dg = (0.01 * torch.randn(*((n,) if shared else (c, n)), generator=g)).to(dtype)
    want_p = ops.reduce3_batched_plain(di, dg)
    beta, ec = ops.scalars_from_partials(want_p, 0.05, 1.0, 1.0, 1e-12)
    want = ops.update_batched_plain(x, di, dg, beta, ec)
    t = ops.n_tiles(n)
    for m in (2, 3, 4, 8):
        full = sum(ops.reduce3_range(di, dg, m, s, impl="plain") for s in range(m))
        assert full.shape == (c, -(-t // m) * m, 3)
        assert torch.equal(full[:, :t], want_p), m
        out = torch.empty_like(x)
        for s in range(m):
            ops.update_range(x, di, dg, beta, ec, out, m, s, impl="plain")
        assert torch.equal(out, want), m
        spans = [ops.tile_range(n, m, s) for s in range(m)]
        assert spans[0][0] == 0 and spans[-1][1] == t
        assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    assert ops.LAUNCHES == {"reduce3": 0, "update": 0}


# -- one rank: the mesh engines give the vmap history bit for bit ------------------


@pytest.mark.parametrize("method", ["pfedsop", "fedexp"])
def test_one_rank_meshes_equal_vmap_bitwise(one_rank, tmp_path, method):
    want = final(federation(method))
    for kw in [dict(backend="shard_map"),
                            dict(backend="shard_map", output_sharding="sharded"),
                            dict(backend="mesh", mesh="pods:1x1x1"),
                            dict(backend="mesh", mesh="pods:1x1x1", output_sharding="sharded",
                                 store=StoreConfig(kind="mmap", mmap_dir=str(tmp_path))),
                            dict(backend="mesh", mesh="host", store="host")]:
        collectives.reset_census()
        h, rows, bc = final(federation(method, **kw))
        assert h == want[0], kw
        assert all(np.array_equal(a, b) for a, b in zip(rows + bc, want[1] + want[2])), kw
        if kw.get("mesh") != "host":  # a client axis of one rank still gathers
            assert collectives.census()["all-gather"]["count"] > 0, kw
