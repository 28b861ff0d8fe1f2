"""The port's RL networks against the JAX package's, on the CPU in fp32.

The flax modules are initialised from a seed, their params carried
across with ``actor_critic_from_flax``, and the same inputs (numpy, from a
seed) go through both: ``MLP``, ``NatureCNN`` on 84x84x4 uint8 frames,
``MinAtarCNN`` on 10x10x4 boards, and ``DiscreteActorCritic``'s
``forward_train`` (log-probability, value, entropy) with either trunk.

Tolerance: |port - jax| <= ATOL + RTOL * |jax|.  The two packages take
the same fp32 sums (fan-in up to 7744) in other orders; measured apart
by <= 2e-7 on outputs of size <= 1."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.models.mlp import MLP as JMLP
from ray_tpu.models.nature_cnn import MinAtarCNN as JMinAtarCNN
from ray_tpu.models.nature_cnn import NatureCNN as JNatureCNN
from ray_tpu.rllib.core.rl_module import RLModuleSpec as JSpec
from ray_tpu_torch.models import MLP, MinAtarCNN, NatureCNN
from ray_tpu_torch.models.convert import actor_critic_from_flax
from ray_tpu_torch.models.flax_layers import same_padding
from ray_tpu_torch.rllib import DiscreteActorCritic, RLModuleSpec

ATOL = RTOL = 1e-5


def _flax(module, example, seed=0):
    params = module.init(jax.random.PRNGKey(seed), jnp.asarray(example))
    return params, jax.tree_util.tree_map(np.asarray, params)


def _close(got: torch.Tensor, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


def _frames(rng, shape, binary=False):
    if binary:  # MinAtar-style boards: 0/1 planes
        return (rng.random(shape) < 0.3).astype(np.uint8)
    return rng.integers(0, 256, size=shape).astype(np.uint8)


def test_mlp_matches_flax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(5, 4)).astype(np.float32)
    jm = JMLP(features=(64, 32), out_dim=3)
    params, np_params = _flax(jm, x)
    tm = MLP(4, (64, 32), 3)
    tm.load_state_dict(actor_critic_from_flax(np_params), strict=True)
    _close(tm(torch.from_numpy(x)), jm.apply(params, jnp.asarray(x)))


@pytest.mark.parametrize("binary", [False, True], ids=["uint8", "binary"])
def test_nature_cnn_matches_flax(binary):
    rng = np.random.default_rng(1)
    x = _frames(rng, (3, 84, 84, 4), binary)
    jm = JNatureCNN()
    params, np_params = _flax(jm, x)
    tm = NatureCNN((84, 84, 4))
    tm.load_state_dict(actor_critic_from_flax(np_params), strict=True)
    _close(tm(torch.from_numpy(x)), jm.apply(params, jnp.asarray(x)))


def test_minatar_cnn_matches_flax():
    rng = np.random.default_rng(2)
    x = _frames(rng, (3, 10, 10, 4), binary=True)
    jm = JMinAtarCNN()
    params, np_params = _flax(jm, x)
    tm = MinAtarCNN((10, 10, 4))
    tm.load_state_dict(actor_critic_from_flax(np_params), strict=True)
    _close(tm(torch.from_numpy(x)), jm.apply(params, jnp.asarray(x)))


def test_nature_cnn_same_padding_and_flatten_width():
    """flax 'SAME' on 84x84: 84 -> 21 (pad 2/2), 21 -> 11 (pad 1 before, 2
    after), 11 -> 11 (1/1); the Dense takes 11*11*64 = 7744 features, as
    the flax kernel's (7744, 256) shape says."""
    assert same_padding(84, 8, 4) == (2, 2)
    assert same_padding(21, 4, 2) == (1, 2)
    assert same_padding(11, 3, 1) == (1, 1)
    tm = NatureCNN((84, 84, 4))
    assert tm.flat_dim == 7744
    assert tuple(tm.dense_0.weight.shape) == (256, 7744)
    x = torch.zeros(1, 84, 84, 4, dtype=torch.uint8)
    _, np_params = _flax(JNatureCNN(), x.numpy())
    assert np_params["params"]["Dense_0"]["kernel"].shape == (7744, 256)


@pytest.mark.parametrize("spec_kw", [
    dict(obs_shape=(84, 84, 4), num_actions=3, conv=True),
    dict(obs_shape=(10, 10, 4), num_actions=3, conv=True),
    dict(obs_dim=4, num_actions=2),
], ids=["nature_cnn", "minatar_cnn", "mlp"])
def test_actor_critic_forward_train_matches_flax(spec_kw):
    rng = np.random.default_rng(3)
    jspec, tspec = JSpec(**spec_kw), RLModuleSpec(**spec_kw)
    jm = jspec.build()
    if tspec.conv:
        obs = _frames(rng, (6,) + tspec.obs_shape,
                      binary=tspec.obs_shape[0] < 32)
    else:
        obs = rng.normal(size=(6, tspec.obs_dim)).astype(np.float32)
    actions = rng.integers(0, tspec.num_actions, size=6)
    params, np_params = _flax(jm, jspec.example_obs(2))
    tm = tspec.build()
    tm.load_state_dict(actor_critic_from_flax(np_params), strict=True)
    want = jm.forward_train(params, jnp.asarray(obs), jnp.asarray(actions))
    got = tm.forward_train(torch.from_numpy(obs), torch.from_numpy(actions))
    for g, w in zip(got, want):
        _close(g, w)
    _close(tm.forward_inference(torch.from_numpy(obs)),
           jm.forward_inference(params, jnp.asarray(obs)))


def test_breakout84_module_size_and_flax_init():
    """2,061,732 parameters on Breakout-Atari84, as the JAX module has;
    kernels drawn as flax's lecun_normal (truncated at 2 std, variance
    1 / fan_in), biases 0."""
    spec = RLModuleSpec(obs_shape=(84, 84, 4), num_actions=3, conv=True)
    tm = spec.build(torch.Generator().manual_seed(0))
    _, np_params = _flax(JSpec(obs_shape=(84, 84, 4), num_actions=3,
                               conv=True).build(), spec.example_obs(1))
    n_jax = sum(x.size for x in jax.tree_util.tree_leaves(np_params))
    assert sum(p.numel() for p in tm.parameters()) == n_jax == 2_061_732
    for name, p in tm.named_parameters():
        if name.endswith("bias"):
            assert not p.any(), name
            continue
        fan_in = p[0].numel()
        std = (1.0 / fan_in) ** 0.5
        assert p.abs().max() <= 2 * std / 0.87962566103423978 + 1e-7, name
        if p.numel() >= 4096:  # enough draws for the variance
            assert abs(p.std().item() / std - 1) < 0.05, name


def test_exploration_samples_the_policy():
    """forward_exploration draws by Gumbel-max from an explicit generator:
    the frequencies follow softmax(logits), the log-probability is that of
    the action drawn, and a seed repeats the draw."""
    spec = RLModuleSpec(obs_dim=4, num_actions=3, hiddens=(8,))
    tm = spec.build(torch.Generator().manual_seed(0))
    obs = torch.from_numpy(np.random.default_rng(4).normal(
        size=(1, 4)).astype(np.float32)).expand(40000, 4)
    with torch.no_grad():
        logits, value = tm(obs[:1])
        action, logp, v = tm.forward_exploration(
            obs, torch.Generator().manual_seed(1))
        again = tm.forward_exploration(obs, torch.Generator().manual_seed(1))
    probs = torch.softmax(logits[0], -1)
    freq = torch.bincount(action, minlength=3).double() / len(action)
    # 40k draws: the std of a frequency is <= 0.0025; 4 std.
    assert (freq - probs.double()).abs().max() < 0.01, (freq, probs)
    torch.testing.assert_close(logp, torch.log_softmax(logits, -1)[0][action])
    torch.testing.assert_close(v, value.expand(40000))
    assert torch.equal(again[0], action)


def test_converter_refuses_unknown_names():
    with pytest.raises(KeyError, match="unknown RL parameter"):
        actor_critic_from_flax({"pi": {"kernel": np.zeros((2, 3)),
                                       "bias": np.zeros(3)},
                                "lstm": {"kernel": np.zeros((2, 3)),
                                         "bias": np.zeros(3)}})


def test_module_is_an_nn_module():
    spec = RLModuleSpec(obs_dim=4, num_actions=2)
    assert isinstance(spec.build(), DiscreteActorCritic)
    assert spec.example_obs(3).shape == (3, 4)
    assert RLModuleSpec(obs_shape=(84, 84, 4), num_actions=3,
                        conv=True).example_obs(2).dtype == torch.uint8
