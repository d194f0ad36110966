"""``repro_torch.models.cnn`` against ``repro.models.cnn`` with carried
weights: logits, loss and every gradient leaf.

Tolerance: f32 convolutions through XLA:CPU and oneDNN sum their
3x3xCin products in different orders -> rtol 1e-4 on logits and loss,
and gradients to 1e-4 of each leaf's largest entry.  The stride-2 cases
on even sizes exercise SAME padding's asymmetric (0, 1) split; a
symmetric ``padding=1`` would shift every output pixel and miss by O(1).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.resnet_cifar import RESNET9_CIFAR100 as J_R9, SMALL_CNN as J_SMALL
from repro.models import cnn as j_cnn
from repro_torch.configs.resnet_cifar import RESNET9_CIFAR100 as T_R9, SMALL_CNN as T_SMALL
from repro_torch.models import cnn as t_cnn
from repro_torch.utils.pytree import tree_leaves
from repro_torch.weights import params_from_jax

CASES = {  # name: (repro cfg, port cfg, batch)
    "small-16": (J_SMALL, T_SMALL, 6),  # stride 2 on 16 -> pads (0, 1)
    "small-15": (J_SMALL.replace(cnn_image_size=15),
                 T_SMALL.replace(cnn_image_size=15), 4),  # odd: (1, 1)
    # ResNet-9 widths: block 0 at 64 channels, block 1 stride 2 on 32
    "resnet9-2block": (J_R9.replace(cnn_channels=(64, 128)),
                       T_R9.replace(cnn_channels=(64, 128)), 2),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_cnn_logits_loss_grads_match_repro(name):
    jcfg, tcfg, b = CASES[name]
    rng = np.random.RandomState(0)
    s = jcfg.cnn_image_size
    batch = {"images": rng.randn(b, s, s, jcfg.cnn_in_channels).astype(np.float32),
             "labels": rng.randint(0, jcfg.n_classes, b).astype(np.int32)}
    jp = jax.jit(j_cnn.init_params, static_argnums=1)(jax.random.PRNGKey(1), jcfg)
    # non-trivial GroupNorm affine params, so their gradients are exercised
    jp = jax.tree_util.tree_map_with_path(
        lambda path, x: x + 0.1 * np.sin(np.arange(x.size)).reshape(x.shape)
        if "gn" in jax.tree_util.keystr(path) else x, jp)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    jb = jax.tree.map(jnp.asarray, batch)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}

    j_logits = np.asarray(jax.jit(lambda p: j_cnn.apply(p, jcfg, jb["images"]))(jp))
    t_logits = t_cnn.apply(tp, tcfg, tb["images"]).detach().numpy()
    np.testing.assert_allclose(t_logits, j_logits, rtol=1e-4, atol=1e-5)
    j_loss, j_grads = jax.jit(jax.value_and_grad(lambda p: j_cnn.loss_fn(p, jcfg, jb)))(jp)
    t_grads, t_loss = torch.func.grad_and_value(lambda p: t_cnn.loss_fn(p, tcfg, tb))(tp)
    np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=1e-4)
    for jg, tg in zip(jax.tree.leaves(j_grads), tree_leaves(t_grads)):
        jg = np.asarray(jg)
        np.testing.assert_allclose(tg.numpy(), jg, rtol=0,
                                   atol=1e-4 * np.abs(jg).max() + 1e-8)
    assert float(t_cnn.accuracy(tp, tcfg, tb)) == np.mean(
        j_logits.argmax(-1) == batch["labels"])


def test_init_params_matches_repro_in_shape_and_scale():
    jshapes = jax.eval_shape(lambda k: j_cnn.init_params(k, J_R9), jax.random.PRNGKey(0))
    tp = t_cnn.init_params(torch.Generator().manual_seed(0), T_R9, device="cpu")
    tl = tree_leaves(tp)
    assert [x.shape for x in jax.tree.leaves(jshapes)] == [tuple(x.shape) for x in tl]
    assert sum(x.numel() for x in tl) == 1_249_956  # RESNET9_CIFAR100's N
    # He-normal convs (std sqrt(2 / fan_in)) and the fc weight (1 / sqrt(cin))
    for w in [tp["stem"]] + [b[k] for b in tp["blocks"] for k in ("conv1", "conv2")]:
        kh, kw, cin, _ = w.shape
        np.testing.assert_allclose(float(w.std()), (2.0 / (kh * kw * cin)) ** 0.5, rtol=0.1)
    np.testing.assert_allclose(float(tp["fc_w"].std()), tp["fc_w"].shape[0] ** -0.5,
                               rtol=0.1)
