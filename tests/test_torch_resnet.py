"""The port's ResNet against the JAX package's
(``ray_tpu_torch/models/resnet.py`` vs ``ray_tpu/models/resnet.py``).

The flax model is initialised from a seed, its params and batch
statistics are perturbed from numpy seeds (so no BN scale is zero and no
running statistic is trivial) and converted with
``resnet_params_from_jax``; the same NHWC images go through both on the
CPU in fp32.  Train mode: logits, the loss, the accuracy, every
parameter's gradient and the new batch statistics; eval mode: logits
from the running statistics.  Covered: ``tiny`` and ``resnet18`` (CIFAR
stem) at 32x32, whose stride-2 3x3 convs pad asymmetrically (0 before, 1
after), and the 7x7 stride-2 stem with the SAME max-pool at 64x64 (pads
2 and 3, then 0 and 1 with -inf), and ResNet-50's bottleneck blocks."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.models.resnet import ResNet as JResNet
from ray_tpu.models.resnet import ResNetConfig as JConfig
from ray_tpu.models.resnet import resnet_loss_fn as j_loss_fn
from ray_tpu_torch.models import ResNet, ResNetConfig, resnet_loss_fn
from ray_tpu_torch.models.convert import resnet_params_from_jax
from ray_tpu_torch.models.resnet import batch_stats, same_pads

# fp32 sums in other orders: logits and the loss to 1e-5 of their scale;
# batch statistics (means over B*H*W) to 1e-5 of theirs.  Gradients:
# train-mode BN's gradient subtracts two batch means of nearly equal
# size, which amplifies fp32 rounding.  Against the same port model in
# float64 the port's fp32 gradients are within 3.9e-5 (relative norm,
# worst parameter over these cases) and JAX's fp32 gradients within
# 3.6e-4; so each gradient is held to the float64 port at 1e-4 and to
# JAX's at 1e-3.
RTOL = 1e-5
GRAD_REL = 1e-4
GRAD_REL_JAX = 1e-3

CASES = {
    "tiny": (lambda m: m.tiny, {}, 32),
    "resnet18_cifar": (lambda m: m.resnet18, {"cifar_stem": True}, 32),
    "resnet18_stem7": (lambda m: m.resnet18, {"num_filters": 8}, 64),
    "resnet50_stem7": (lambda m: m.resnet50, {"num_filters": 4,
                                              "stage_sizes": (1, 1)}, 64),
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _perturbed(tree, rng, scale, positive=False):
    def f(a):
        a = np.asarray(a) + scale * rng.normal(size=np.shape(a)).astype(
            np.float32)
        return np.abs(a) if positive else a
    return jax.tree_util.tree_map(f, tree)


def _pair(case, seed=0):
    make, kw, hw = CASES[case]
    jcfg = make(JConfig)(dtype=jnp.float32, **kw)
    tcfg = make(ResNetConfig)(dtype=torch.float32, **kw)
    rng = np.random.default_rng(seed)
    images = rng.normal(size=(4, hw, hw, 3)).astype(np.float32)
    labels = rng.integers(0, 10, 4)
    jmodel = JResNet(jcfg)
    variables = jmodel.init(jax.random.PRNGKey(seed), jnp.asarray(images),
                            train=False)
    params = _perturbed(variables["params"], rng, 0.05)
    stats = _perturbed(variables["batch_stats"], rng, 0.1, positive=True)
    tmodel = ResNet(tcfg)
    tmodel.load_state_dict(resnet_params_from_jax(params, stats),
                           strict=True)
    return jmodel, params, stats, tmodel, images, labels


def _close(got, want, rtol=RTOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rtol * max(np.abs(want).max(), 1e-30))


def test_same_pads_are_flax_s():
    """XLA's SAME split: the extra pixel after; none when it fits."""
    assert same_pads(32, 3, 2) == (0, 1)
    assert same_pads(224, 7, 2) == (2, 3)
    assert same_pads(64, 7, 2) == (2, 3)
    assert same_pads(32, 3, 1) == (1, 1)
    assert same_pads(32, 1, 2) == (0, 0)
    assert same_pads(33, 3, 2) == (1, 1)


@pytest.mark.parametrize("case", sorted(CASES))
def test_eval_logits_match_jax(case):
    jmodel, params, stats, tmodel, images, _ = _pair(case)
    want = jmodel.apply({"params": params, "batch_stats": stats},
                        jnp.asarray(images), train=False)
    tmodel.eval()
    with torch.no_grad():
        got = tmodel(torch.from_numpy(images))
    assert got.dtype == torch.float32 and got.shape == (4, 10)
    _close(got.numpy(), want)


@pytest.mark.parametrize("case", sorted(CASES))
def test_train_step_matches_jax(case):
    """resnet_loss_fn in train mode: the loss, the accuracy, the new
    batch statistics (flax's momentum 0.9 with the biased batch variance)
    and every parameter's gradient against jax.value_and_grad of JAX's
    resnet_loss_fn, and the gradients against the same step in float64."""
    jmodel, params, stats, tmodel, images, labels = _pair(case, seed=1)
    batch = {"image": jnp.asarray(images), "label": jnp.asarray(labels)}
    (j_loss, (j_stats, j_acc)), j_grads = jax.value_and_grad(
        j_loss_fn, has_aux=True)(params, stats, jmodel.apply, batch)
    loss, (t_stats, acc) = resnet_loss_fn(
        tmodel, {"image": torch.from_numpy(images),
                 "label": torch.from_numpy(labels)})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=RTOL)
    assert acc.item() == float(j_acc)
    want = resnet_params_from_jax(jax.tree_util.tree_map(np.asarray, j_grads),
                                  jax.tree_util.tree_map(np.asarray, j_stats))
    assert set(t_stats) == {k for k in want if k.endswith(("running_mean",
                                                          "running_var"))}
    for name, buf in t_stats.items():
        _close(buf.numpy(), want[name])
    make, kw, _ = CASES[case]
    model64 = ResNet(make(ResNetConfig)(dtype=torch.float64, **kw)).double()
    model64.load_state_dict({k: v.double() for k, v in
                             resnet_params_from_jax(params, stats).items()})
    loss64, _ = resnet_loss_fn(model64, {
        "image": torch.from_numpy(images).double(),
        "label": torch.from_numpy(labels)})
    loss64.backward()
    exact = dict(model64.named_parameters())
    for name, p in tmodel.named_parameters():
        for w, bound in ((exact[name].grad, GRAD_REL),
                         (want[name].double(), GRAD_REL_JAX)):
            rel = ((p.grad.double() - w).norm()
                   / w.norm().clamp_min(1e-30)).item()
            assert rel <= bound, (name, rel, bound)


def test_running_variance_is_the_biased_batch_variance():
    """One train-mode forward of a lone BN from zero mean / unit variance:
    running_var = 0.9 + 0.1 * (biased variance) (torch's BatchNorm2d would
    take the unbiased one), running_mean = 0.1 * mean."""
    from ray_tpu_torch.models.resnet import BatchNorm

    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(2, 3, 2, 2)).astype(np.float32) * 2 + 1)
    bn = BatchNorm(3)
    bn(x)
    mean = x.mean((0, 2, 3))
    biased = x.var((0, 2, 3), unbiased=False)
    np.testing.assert_allclose(bn.running_mean.numpy(), 0.1 * mean.numpy(),
                               rtol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               0.9 + 0.1 * biased.numpy(), rtol=1e-5)


def test_configs_and_the_zero_scale_of_each_block_s_last_bn():
    """The presets are JAX's; a fresh model's last BN of each block has a
    zero scale, every other BN a unit scale, the head a zero bias."""
    for name in ("resnet18", "resnet50", "resnet50_cifar", "tiny"):
        j = getattr(JConfig, name)()
        t = getattr(ResNetConfig, name)()
        assert (t.stage_sizes, t.num_classes, t.num_filters, t.bottleneck,
                t.cifar_stem) == (j.stage_sizes, j.num_classes,
                                  j.num_filters, j.bottleneck, j.cifar_stem)
        assert t.dtype == torch.bfloat16
    model = ResNet(ResNetConfig.tiny(), torch.Generator().manual_seed(0))
    for block in model.blocks:
        for j in range(block.n):
            scale = getattr(block, f"bn_{j}").weight
            assert (scale == (0.0 if j == block.n - 1 else 1.0)).all()
    assert (model.head.bias == 0).all()
    assert set(batch_stats(model)) == {
        k for k, _ in model.named_buffers()}


def test_bf16_convolutions_keep_bn_and_head_in_fp32():
    """In a bf16 model the convolutions compute in bf16 and BN and the
    head in fp32: logits are fp32 and close to the fp32 model's on the
    same weights."""
    cfg32 = ResNetConfig.tiny(dtype=torch.float32)
    model32 = ResNet(cfg32, torch.Generator().manual_seed(0))
    model16 = ResNet(ResNetConfig.tiny(), torch.Generator().manual_seed(0))
    model16.load_state_dict(model32.state_dict())
    assert model16.stem(torch.zeros(1, 3, 8, 8)).dtype == torch.bfloat16
    x = torch.from_numpy(np.random.default_rng(4).normal(
        size=(2, 32, 32, 3)).astype(np.float32))
    model32.eval()
    model16.eval()
    with torch.no_grad():
        y32, y16 = model32(x), model16(x)
    assert y16.dtype == torch.float32
    assert (y16 - y32).abs().max().item() <= 0.05 * y32.abs().max().item()
