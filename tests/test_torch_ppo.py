"""The port's PPO against the JAX package's, on the CPU in fp32.

GAE, the clipped surrogate (value and gradients), one clip + Adam update
and one whole ``run_ppo_sgd`` iteration are held against ``ray_tpu`` on
the same inputs (numpy, from a seed) and converted weights; JAX's
permutations are handed to the port, whose own come from a
``torch.Generator``.  Then the port's ``PPO`` learns CartPole, as
``tests/test_rllib.py::test_anakin_ppo_learns_cartpole`` asks of the JAX
package."""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from ray_tpu.rllib.algorithms import ppo as jppo
from ray_tpu.rllib.core.rl_module import RLModuleSpec as JSpec
from ray_tpu.rllib.env.jax_envs import CartPole as JCartPole
from ray_tpu.rllib.env.jax_envs import vector_reset, vector_step
from ray_tpu.rllib.evaluation.postprocessing import gae_jax
from ray_tpu.rllib.utils.mesh import normalize_global as jnormalize
from ray_tpu_torch.models.convert import actor_critic_from_flax
from ray_tpu_torch.rllib import PPOConfig, RLModuleSpec
from ray_tpu_torch.rllib.algorithms import ppo as tppo
from ray_tpu_torch.rllib.evaluation.postprocessing import gae_torch
from ray_tpu_torch.rllib.utils import mesh as tmesh

COEFFS = dict(clip_param=0.2, vf_clip_param=10.0, vf_loss_coeff=0.5,
              entropy_coeff=0.01)
# GAE and the surrogate: the same fp32 operations in the same order;
# exp/log and the means' sums may round differently (a few ulp).
GAE_RTOL = SURR_RTOL = 1e-5
GAE_ATOL = SURR_ATOL = 1e-6
# One clip + Adam update: optax and torch.optim.Adam compute the same
# update in other fp32 orders, except for one term: optax forms Adam's
# bias correction 1 - 0.999^t in fp32, where it is off by 1.3e-5 relative
# (fp32 0.999 is 0.99900001), while torch forms it in double.  So the
# first step differs by ~6.4e-6 of lr = 5e-4, 3.2e-9; measured 3.3e-9
# where the parameter is 0.003 (rtol alone would allow 3e-9 there).
ADAM_RTOL, ADAM_ATOL = 1e-6, 1e-8
# One run_ppo_sgd iteration (2 epochs x 4 minibatches = 8 Adam updates of
# lr 3e-4 on the CartPole MLPs).  Adam divides each gradient by its own
# running RMS, so the update of an element is ~lr whatever its gradient's
# size, and the fp32 rounding differences of the two gradients (1e-7
# relative) come through unscaled only where a gradient is itself
# rounding noise.  Measured: max |dp| 1.2e-7 over the 9,155 parameters
# (of size ~0.1-1, each moved by up to 2.4e-3) after the 8 updates; held
# to 1e-6, 0.3% of one update.
SGD_ATOL = 1e-6


def test_gae_matches_jax():
    rng = np.random.default_rng(0)
    T, N = 64, 16
    rewards = rng.normal(size=(T, N)).astype(np.float32)
    values = rng.normal(size=(T, N)).astype(np.float32)
    dones = rng.random((T, N)) < 0.1
    last = rng.normal(size=N).astype(np.float32)
    want = gae_jax(jnp.asarray(rewards), jnp.asarray(values),
                   jnp.asarray(dones), jnp.asarray(last), 0.99, 0.95)
    got = gae_torch(torch.from_numpy(rewards), torch.from_numpy(values),
                    torch.from_numpy(dones), torch.from_numpy(last), 0.99,
                    0.95)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=GAE_RTOL,
                                   atol=GAE_ATOL)
    adv = got[0]
    np.testing.assert_allclose(
        tmesh.normalize_global(adv).numpy(),
        np.asarray(jnormalize(jnp.asarray(adv.numpy()), False)),
        rtol=GAE_RTOL, atol=GAE_ATOL)


def _surrogate_inputs(rng, n=256):
    logp = np.log(rng.uniform(0.05, 1.0, n)).astype(np.float32)
    batch = {
        # Old log-probabilities apart by up to ~0.5 nats: ratios on both
        # sides of the clip range and inside it.
        "action_logp": (logp + rng.normal(0, 0.25, n)).astype(np.float32),
        "advantages": rng.normal(size=n).astype(np.float32),
        "value_targets": rng.normal(0, 3, n).astype(np.float32),
    }
    value = rng.normal(0, 3, n).astype(np.float32)
    entropy = rng.uniform(0, 1.1, n).astype(np.float32)
    return logp, value, entropy, batch


def test_ppo_surrogate_value_and_gradients_match_jax():
    logp, value, entropy, batch = _surrogate_inputs(np.random.default_rng(1))
    ratio = np.exp(logp - batch["action_logp"])
    assert (ratio > 1.2).any() and (ratio < 0.8).any()
    assert (np.abs(ratio - 1) < 0.2).any()
    assert (np.abs(value - batch["value_targets"]) > 10).any()  # vf clip

    def jloss(lp, v, e):
        return jppo.ppo_surrogate(lp, v, e, {k: jnp.asarray(x) for k, x in
                                             batch.items()}, **COEFFS)

    (jtotal, jaux), jgrads = jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True)(
            jnp.asarray(logp), jnp.asarray(value), jnp.asarray(entropy))
    leaves = [torch.from_numpy(x).requires_grad_()
              for x in (logp, value, entropy)]
    total, aux = tppo.ppo_surrogate(
        *leaves, {k: torch.from_numpy(x) for k, x in batch.items()},
        **COEFFS)
    total.backward()
    np.testing.assert_allclose(total.item(), float(jtotal), rtol=SURR_RTOL)
    for k in ("policy_loss", "vf_loss", "entropy"):
        np.testing.assert_allclose(aux[k].item(), float(jaux[k]),
                                   rtol=SURR_RTOL, atol=SURR_ATOL)
    for leaf, g in zip(leaves, jgrads):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(g),
                                   rtol=SURR_RTOL, atol=SURR_ATOL)


class _Config:
    zero_sharding = "off"
    quantized_collectives = "off"


@pytest.mark.parametrize("scale", [10.0, 0.01], ids=["clipped", "unclipped"])
def test_clip_and_adam_update_matches_optax(scale):
    rng = np.random.default_rng(2)
    shapes = [(64, 4), (64,), (2, 64), (2,)]
    params = [rng.normal(0, 0.5, s).astype(np.float32) for s in shapes]
    grads = [(rng.normal(size=s) * scale).astype(np.float32) for s in shapes]
    norm = np.sqrt(sum((g.astype(np.float64) ** 2).sum() for g in grads))
    assert (norm > 0.5) == (scale > 1)
    tx = optax.chain(optax.clip_by_global_norm(0.5), optax.adam(5e-4))
    jp = [jnp.asarray(p) for p in params]
    updates, _ = tx.update([jnp.asarray(g) for g in grads], tx.init(jp), jp)
    want = optax.apply_updates(jp, updates)
    clipped, _ = optax.clip_by_global_norm(0.5).update(
        [jnp.asarray(g) for g in grads], None)

    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    tg = [torch.from_numpy(g) for g in grads]
    for c, w in zip(tmesh.clip_by_global_norm(tg, 0.5), clipped):
        np.testing.assert_allclose(c.numpy(), np.asarray(w), rtol=ADAM_RTOL)
    update_fn, _ = tmesh.build_update_plan(_Config(), 5e-4, 0.5, tp)
    with torch.no_grad():
        update_fn(tg)
    for p, w in zip(tp, want):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(w),
                                   rtol=ADAM_RTOL, atol=ADAM_ATOL)


def _cartpole_trajectory(T=32, N=16, seed=0):
    """A CartPole rollout by the JAX package's module and env, GAE'd and
    normalised as make_anakin_ppo does: (module, params, flat batch)."""
    env = JCartPole()
    spec = JSpec(obs_dim=4, num_actions=2)
    module = spec.build()
    rng = jax.random.PRNGKey(seed)
    rng, k_init, k_env = jax.random.split(rng, 3)
    states, obs = vector_reset(env, k_env, N)
    params = module.init(k_init, obs)
    traj = []
    for _ in range(T):
        rng, k_act, k_step = jax.random.split(rng, 3)
        action, logp, value = module.forward_exploration(params, obs, k_act)
        states, next_obs, reward, done, _ = vector_step(env, states, action,
                                                        k_step)
        traj.append((obs, action, logp, value, reward, done))
        obs = next_obs
    obs_t, act_t, logp_t, val_t, rew_t, done_t = (
        jnp.stack(x) for x in zip(*traj))
    _, last_value = module.apply(params, obs)
    adv, vtarg = gae_jax(rew_t, val_t, done_t, last_value)
    adv = jnormalize(adv, False)
    flat = {"obs": obs_t.reshape(T * N, -1), "actions": act_t.reshape(-1),
            "action_logp": logp_t.reshape(-1),
            "advantages": adv.reshape(-1), "value_targets": vtarg.reshape(-1)}
    return module, params, {k: np.asarray(v) for k, v in flat.items()}


def test_run_ppo_sgd_iteration_matches_jax():
    module, params, flat = _cartpole_trajectory()
    total, mb_size, num_mb, epochs, lr = 512, 128, 4, 2, 3e-4
    tx = optax.chain(optax.clip_by_global_norm(0.5), optax.adam(lr))
    jflat = {k: jnp.asarray(v) for k, v in flat.items()}
    loss_fn = functools.partial(jppo.ppo_loss, **COEFFS)
    rng = jax.random.PRNGKey(7)
    (jparams, _, _), (jlosses, jauxes) = jppo.run_ppo_sgd(
        params, tx.init(params), rng,
        lambda p, mb: loss_fn(p, module, mb),
        lambda idx: {k: v[idx] for k, v in jflat.items()},
        total, mb_size, num_mb, epochs, tx)
    perms = []
    for _ in range(epochs):  # run_ppo_sgd's own key schedule
        rng, k = jax.random.split(rng)
        perms.append(torch.from_numpy(
            np.asarray(jax.random.permutation(k, total)).astype(np.int64)))

    tm = RLModuleSpec(obs_dim=4, num_actions=2).build()
    tm.load_state_dict(actor_critic_from_flax(jax.tree_util.tree_map(
        np.asarray, params)), strict=True)
    tparams = list(tm.parameters())
    update_fn, _ = tmesh.build_update_plan(_Config(), lr, 0.5, tparams)
    tflat = {k: torch.from_numpy(v.copy()) for k, v in flat.items()}
    it = iter(perms)
    losses, auxes = tppo.run_ppo_sgd(
        tparams, update_fn, functools.partial(tppo.ppo_loss, tm, **COEFFS),
        lambda idx: {k: v[idx] for k, v in tflat.items()},
        total, mb_size, num_mb, epochs, lambda n: next(it))
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses),
                               rtol=1e-5)
    for k, v in auxes.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jauxes[k]),
                                   rtol=1e-5, atol=1e-6)
    want = actor_critic_from_flax(jax.tree_util.tree_map(np.asarray,
                                                         jparams))
    start = actor_critic_from_flax(jax.tree_util.tree_map(np.asarray,
                                                          params))
    for name, p in tm.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), rtol=0,
                                   atol=SGD_ATOL, err_msg=name)
        assert (p - start[name]).abs().max() > 100 * SGD_ATOL, name


def test_ppo_learns_cartpole():
    """The port's counterpart of tests/test_rllib.py:64 (the reference's
    cartpole-ppo.yaml, expected reward 150), on the CPU."""
    algo = (PPOConfig()
            .environment("CartPole-v1")
            .anakin(num_envs=32, unroll_length=64)
            .training(lr=3e-4, num_sgd_iter=4, sgd_minibatch_size=512,
                      entropy_coeff=0.01)
            .resources(device="cpu")
            .debugging(seed=0)
            .build())
    best = -1.0
    for _ in range(120):
        result = algo.train()
        r = result["episode_reward_mean"]
        if np.isfinite(r):
            best = max(best, r)
        if best >= 150:
            break
    assert best >= 150, f"PPO failed to learn CartPole: best={best}"
    assert result["num_env_steps_sampled"] == 32 * 64 * result[
        "training_iteration"]
    assert {"total_loss", "policy_loss", "vf_loss", "entropy",
            "time_this_iter_s"} <= set(result)
    algo.stop()


@pytest.mark.parametrize("knob", [
    lambda c: c.resources(num_devices=2),
    lambda c: c.resources(zero_sharding="opt"),
    lambda c: c.resources(quantized_collectives="int8"),
    lambda c: c.training(model={"use_lstm": True}).resources(num_devices=2),
    lambda c: c.training(model={"use_attention": True}).resources(
        zero_sharding="opt"),
    lambda c: c.rollouts(num_rollout_workers=2).resources(num_devices=1),
], ids=["num_devices", "zero", "int8", "lstm", "attention", "actor_mode"])
def test_paths_not_ported_yet_raise(knob):
    config = PPOConfig().anakin(num_envs=4, unroll_length=4).resources(
        device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        knob(config).build()
