"""The port's multi-agent env and shared-policy PPO (MAPPO) against the
JAX package's, on the CPU in fp32.

- ``CoordinationGame``: the reference's mechanics, and trajectories bit
  for bit over two episodes from the same numpy actions (its step draws
  nothing);
- MAPPO: the folded batch (GAE per agent stream, the game's done on each
  of its agents' streams, normalised advantages) of a trajectory the JAX
  package's own rollout step made, within 1e-5; its PPO loss; and one
  whole SGD pass on it with JAX's permutations, against the JAX train
  step's parameters after the same iteration;
- the learning gate of ``tests/test_multi_agent.py`` (team return >= 28
  within 60 iterations), on the port's own draws; chip_smoke's
  ``[mappo]`` runs it on the card."""
import functools
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.rllib.algorithms import ppo as jppo
from ray_tpu.rllib.algorithms import ppo_ma as jppo_ma
from ray_tpu.rllib.env import multi_agent as jma
from ray_tpu.rllib.evaluation.postprocessing import gae_jax
from ray_tpu_torch.models.convert import actor_critic_from_flax
from ray_tpu_torch.rllib import MAPPOConfig
from ray_tpu_torch.rllib.algorithms import ppo as tppo
from ray_tpu_torch.rllib.algorithms import ppo_ma as tppo_ma
from ray_tpu_torch.rllib.env import multi_agent as tma
from ray_tpu_torch.rllib.utils import mesh as tmesh

COEFFS = dict(clip_param=0.2, vf_clip_param=10.0, vf_loss_coeff=0.5,
              entropy_coeff=0.01)
# GAE and the normalised advantages: the same fp32 recursion, a few ulp.
FOLD_RTOL, FOLD_ATOL = 1e-5, 1e-5
# The losses: means of the same fp32 terms.
LOSS_RTOL = 1e-5
# One SGD pass (2 epochs x 8 minibatches = 16 clip + Adam updates of lr
# 1e-3): tests/test_torch_ppo.py's SGD_ATOL argument, scaled to lr 1e-3.
SGD_ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def closure(fn, name):
    fn = getattr(fn, "__wrapped__", fn)
    return fn.__closure__[fn.__code__.co_freevars.index(name)].cell_contents


def test_coordination_game_mechanics():
    """tests/test_multi_agent.py's mechanics on the port."""
    env = tma.CoordinationGame()
    g = torch.Generator()
    states, obs = tma.ma_vector_reset(env, g, 4, "cpu")
    assert obs.shape == (4, 2, env.obs_dim)
    match = torch.zeros((4, 2), dtype=torch.int64)
    states, obs, rew, done, _ = tma.ma_vector_step(env, states, match, g)
    np.testing.assert_array_equal(rew.numpy(), np.ones((4, 2)))
    mixed = torch.tensor([[0, 1]]).repeat(4, 1)
    states, obs, rew, done, _ = tma.ma_vector_step(env, states, mixed, g)
    np.testing.assert_array_equal(rew.numpy(), np.zeros((4, 2)))
    assert obs.shape[-1] == env.num_actions ** 2 + 2
    assert tma.make_ma_env("CoordinationGame-v0").num_agents == 2
    with pytest.raises(ValueError, match="unknown multi-agent env"):
        tma.make_ma_env("Nope-v0")


def test_coordination_game_trajectories_are_jaxs_bit_for_bit():
    G, steps = 6, 2 * tma.CoordinationGame.max_steps
    jenv, tenv = jma.CoordinationGame(), tma.CoordinationGame()
    key = jax.random.PRNGKey(0)
    jstates, jobs = jma.ma_vector_reset(jenv, key, G)
    g = torch.Generator()
    tstates, tobs = tma.ma_vector_reset(tenv, g, G, "cpu")
    rng = np.random.default_rng(0)
    dones = 0
    for t in range(steps):
        np.testing.assert_array_equal(tobs.numpy(), np.asarray(jobs), str(t))
        actions = rng.integers(0, 2, (G, 2))
        key, k = jax.random.split(key)
        jstates, jobs, jrew, jdone, _ = jma.ma_vector_step(
            jenv, jstates, jnp.asarray(actions, jnp.int32), k)
        tstates, tobs, trew, tdone, _ = tma.ma_vector_step(
            tenv, tstates, torch.from_numpy(actions), g)
        np.testing.assert_array_equal(trew.numpy(), np.asarray(jrew))
        np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone))
        for name in ("prev_joint", "t"):
            np.testing.assert_array_equal(tstates[name].numpy(),
                                          np.asarray(jstates[name]))
        dones += int(tdone.sum())
    assert dones == 2 * G  # two whole episodes a game


def _jax_iteration(G=8, T=16):
    """The JAX MAPPO's iteration pieces: its config, module and start
    state, the trajectory its own rollout step makes, the generator key
    after the rollout, and the train step's state after the iteration."""
    cfg = (jppo_ma.MAPPOConfig().environment("CoordinationGame-v0")
           .anakin(num_envs=G, unroll_length=T)
           .training(lr=1e-3, num_sgd_iter=2, sgd_minibatch_size=32,
                     entropy_coeff=0.01).debugging(seed=0))
    module, init_fn, train_step, steps = jppo_ma.make_anakin_mappo(cfg)
    state = init_fn(0)
    rollout_step = closure(train_step, "rollout_step")
    carry = (state.params, state.env_states, state.obs, state.rng,
             state.ep_return, state.done_return_sum, state.done_count)
    carry, traj = jax.lax.scan(rollout_step, carry, None, length=T)
    new_state, metrics = train_step(state)
    assert steps == T * G
    return cfg, module, state, carry, traj, new_state, metrics


def _port_module(params):
    from ray_tpu_torch.rllib import RLModuleSpec

    tm = RLModuleSpec(obs_dim=6, num_actions=2).build()
    tm.load_state_dict(actor_critic_from_flax(jax.tree_util.tree_map(
        np.asarray, params)), strict=True)
    return tm


def test_mappo_folded_batch_and_loss_match_jax():
    cfg, module, state, carry, traj, _, _ = _jax_iteration()
    obs_t, act_t, logp_t, val_t, rew_t, done_t = traj
    last_obs = carry[2]
    _, last_value = module.apply(state.params, last_obs.reshape(16, -1))
    adv, vtarg = gae_jax(rew_t, val_t, done_t, last_value, cfg.gamma,
                         cfg.lambda_)
    adv = (adv - adv.mean()) / (adv.std() + 1e-8)
    tm = _port_module(state.params)
    ttraj = {"obs": obs_t, "actions": act_t, "action_logp": logp_t,
             "values": val_t, "rewards": rew_t, "dones": done_t}
    ttraj = {k: torch.from_numpy(np.array(v)) for k, v in ttraj.items()}
    ttraj["actions"] = ttraj["actions"].to(torch.int64)
    flat = tppo_ma.folded_batch(tm, ttraj, torch.from_numpy(
        np.array(last_obs)), cfg.gamma, cfg.lambda_)
    np.testing.assert_allclose(flat["advantages"].numpy(),
                               np.asarray(adv).reshape(-1),
                               rtol=FOLD_RTOL, atol=FOLD_ATOL)
    np.testing.assert_allclose(flat["value_targets"].numpy(),
                               np.asarray(vtarg).reshape(-1),
                               rtol=FOLD_RTOL, atol=FOLD_ATOL)
    # The game's done reaches both of its agents' streams.
    dones = np.asarray(done_t).reshape(16, 8, 2)
    assert dones.any() and (dones[..., 0] == dones[..., 1]).all()
    jflat = {"obs": obs_t.reshape(256, -1), "actions": act_t.reshape(-1),
             "action_logp": logp_t.reshape(-1),
             "advantages": adv.reshape(-1),
             "value_targets": vtarg.reshape(-1)}
    jtotal, jaux = jppo.ppo_loss(state.params, module, jflat, **COEFFS)
    with torch.no_grad():
        total, aux = tppo.ppo_loss(tm, flat, **COEFFS)
    np.testing.assert_allclose(total.item(), float(jtotal), rtol=LOSS_RTOL)
    for k in ("policy_loss", "vf_loss", "entropy"):
        np.testing.assert_allclose(aux[k].item(), float(jaux[k]),
                                   rtol=LOSS_RTOL, atol=1e-6, err_msg=k)


def test_mappo_one_sgd_pass_matches_jax():
    cfg, module, state, carry, traj, new_state, metrics = _jax_iteration()
    obs_t, act_t, logp_t, val_t, rew_t, done_t = traj
    tm = _port_module(state.params)
    ttraj = {"obs": obs_t, "actions": act_t, "action_logp": logp_t,
             "values": val_t, "rewards": rew_t, "dones": done_t}
    ttraj = {k: torch.from_numpy(np.array(v)) for k, v in ttraj.items()}
    ttraj["actions"] = ttraj["actions"].to(torch.int64)
    flat = tppo_ma.folded_batch(tm, ttraj, torch.from_numpy(
        np.array(carry[2])), cfg.gamma, cfg.lambda_)
    total, mb = 256, 32
    rng, perms = carry[3], []
    for _ in range(cfg.num_sgd_iter):  # the train step's key schedule
        rng, k = jax.random.split(rng)
        perms.append(torch.from_numpy(np.array(
            jax.random.permutation(k, total)).astype(np.int64)))

    class Config:
        zero_sharding = quantized_collectives = "off"

    params = list(tm.parameters())
    update_fn, _ = tmesh.build_update_plan(Config(), cfg.lr, cfg.grad_clip,
                                           params)
    it = iter(perms)
    losses, _ = tppo.run_ppo_sgd(
        params, update_fn, functools.partial(tppo.ppo_loss, tm, **COEFFS),
        lambda idx: {k: v[idx] for k, v in flat.items()}, total, mb,
        total // mb, cfg.num_sgd_iter, lambda n: next(it))
    np.testing.assert_allclose(losses.mean().item(),
                               float(metrics["total_loss"]), rtol=1e-5)
    want = actor_critic_from_flax(jax.tree_util.tree_map(
        np.asarray, new_state.params))
    start = actor_critic_from_flax(jax.tree_util.tree_map(
        np.asarray, state.params))
    for name, p in tm.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), rtol=0,
                                   atol=SGD_ATOL, err_msg=name)
        assert (p - start[name]).abs().max() > 10 * SGD_ATOL, name


def test_mappo_learns_coordination():
    """tests/test_multi_agent.py's gate: best team return >= 28 within 60
    iterations (random play averages ~16)."""
    cfg = (MAPPOConfig().environment("CoordinationGame-v0")
           .anakin(num_envs=32, unroll_length=32)
           .training(lr=1e-3, num_sgd_iter=4, sgd_minibatch_size=512,
                     entropy_coeff=0.01)
           .resources(device="cpu").debugging(seed=0))
    algo = cfg.build()
    best = -1.0
    for _ in range(60):
        m = algo.train()
        r = m["episode_reward_mean"]
        if not math.isnan(r):
            best = max(best, r)
        if best >= 28:
            break
    assert best >= 28, f"shared policy failed to coordinate: best={best}"
    assert m["num_env_steps_sampled_this_iter"] == 32 * 32
    with pytest.raises(NotImplementedError, match="anakin"):
        MAPPOConfig().rollouts(num_rollout_workers=1).resources(
            device="cpu").build()
