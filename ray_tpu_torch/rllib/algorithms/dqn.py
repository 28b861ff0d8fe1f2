"""DQN (counterpart of ``ray_tpu/rllib/algorithms/dqn.py``; reference:
rllib/algorithms/dqn/ — config surface: buffer, target network, epsilon
schedule, double_q, n_step=1 here), and what the replay family (DQN,
SAC, TD3/DDPG) shares.

Anakin mode: env stepping, a circular replay ring on the device, uniform
sampling, double-Q updates and the soft target sync all run on the
device; the transitions never leave it.  The JAX package jits the whole
step into one program; the port runs it eagerly, one launch per
operation, with the ring a set of ``[capacity, ...]`` tensors that each
rollout step writes into in place.  Soft target updates (polyak ``tau``)
replace the reference's periodic hard copy, as in the JAX package.

Actor mode (``rollouts(num_rollout_workers=...)``): CPU rollout actors
(``OffPolicyRolloutWorker``) step numpy envs and feed the replay plane
(``execution/replay_plane.py``, local or sharded over the object store);
the learner samples ``[U, B, ...]`` minibatches from it onto its device
and runs the same update as the Anakin step.

What differs from the JAX package: the ring's insert cursor and size are
host integers (they advance by the same ``N * T`` every iteration, so
reading them needs no device sync), the draws come from
``torch.Generator``s (the Anakin ring's indices and the exploration from
one on the device, seeded with ``config.seed``; actor mode's update noise
from one seeded with the env-step count), and before ``learning_starts``
the updates are skipped (the JAX step computes and discards them), so
their losses read NaN.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ray_tpu_torch.air.checkpoint import Checkpoint
from ray_tpu_torch.models.mlp import MLP
from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm, make_env
from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.env.torch_envs import (
    count_episodes,
    vector_reset,
    vector_step,
)
from ray_tpu_torch.rllib.execution.replay_plane import (  # noqa: F401
    ReplayPlane,
    run_actor_replay_iter,
)
from ray_tpu_torch.rllib.utils import mesh as mesh_util
from ray_tpu_torch.rllib.utils.cuda_graphs import (
    CapturedCalls,
    capturable_adam,
)

Metrics = Dict[str, torch.Tensor]
REPLAY_COLS = ("obs", "actions", "rewards", "next_obs", "dones")


class DQNConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__(algo_class=DQN)
        self.lr = 1e-3
        # DQN-specific knobs (reference: DQNConfig.training(...))
        self.buffer_size = 50_000
        self.learning_starts = 1_000
        self.target_network_tau = 0.01
        self.epsilon_initial = 1.0
        self.epsilon_final = 0.05
        self.epsilon_decay_steps = 20_000
        self.double_q = True
        self.num_updates_per_iter = 8
        self.dqn_batch_size = 128


class QNetwork(nn.Module):
    """Q(s, ·) MLP head over the vector observation (``net``: the flax
    ``MLP``'s ``dense_{i}`` and ``out``)."""

    def __init__(self, obs_dim: int, num_actions: int,
                 hiddens: Tuple[int, ...],
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.net = MLP(obs_dim, tuple(hiddens), num_actions,
                       generator=generator)
        self.obs_dim = obs_dim
        self.num_actions = num_actions

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        return self.net(obs)


def epsilon_greedy(q: torch.Tensor, generator: torch.Generator,
                   epsilon: float) -> torch.Tensor:
    """The greedy action of ``q`` ``[N, A]``, replaced with probability
    ``epsilon`` by a uniform one."""
    greedy = q.argmax(-1)
    random_a = torch.randint(0, q.shape[-1], greedy.shape,
                             generator=generator, device=q.device)
    explore = torch.rand(greedy.shape, generator=generator,
                         device=q.device) < epsilon
    return torch.where(explore, random_a, greedy)


# ---- the device replay ring --------------------------------------------------

@dataclasses.dataclass
class ReplayState:
    """The device replay ring: ``[capacity, ...]`` columns; the cursor and
    the size are host integers."""
    obs: torch.Tensor        # [cap, obs_dim]
    actions: torch.Tensor    # [cap] int64 or [cap, action_dim] float32
    rewards: torch.Tensor    # [cap]
    next_obs: torch.Tensor   # [cap, obs_dim]
    dones: torch.Tensor      # [cap] float32
    insert_pos: int = 0
    size: int = 0

    @property
    def capacity(self) -> int:
        return self.actions.shape[0]


def make_replay_state(buffer_size: int, n_insert: int, obs_dim,
                      action_shape: Tuple[int, ...] = (),
                      action_dtype=torch.int64, device=None) -> ReplayState:
    """Device replay ring sized to a multiple of the per-iter insert so
    wrap inserts stay slice-aligned (an insert never straddles the end).
    Shared by the replay-family algorithms (DQN, SAC, TD3, Dyna-Q, and
    QMIX, whose ``obs_dim`` is the shape ``(agents, obs_dim)``)."""
    cap = max(buffer_size, n_insert)
    cap = ((cap + n_insert - 1) // n_insert) * n_insert
    obs_shape = (obs_dim,) if isinstance(obs_dim, int) else tuple(obs_dim)

    def zeros(shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return ReplayState(
        obs=zeros((cap,) + obs_shape),
        actions=zeros((cap,) + tuple(action_shape), action_dtype),
        rewards=zeros((cap,)), next_obs=zeros((cap,) + obs_shape),
        dones=zeros((cap,)))


def _replay_rows(replay: ReplayState, n: int) -> Dict[str, torch.Tensor]:
    """Views of the ``n`` rows at the cursor, column by column (``n``
    divides the capacity, so they never wrap)."""
    start = replay.insert_pos % replay.capacity
    return {k: getattr(replay, k)[start:start + n] for k in REPLAY_COLS}


def _replay_advance(replay: ReplayState, n: int) -> ReplayState:
    cap = replay.capacity
    return dataclasses.replace(replay, insert_pos=(replay.insert_pos + n)
                               % cap, size=min(replay.size + n, cap))


def _replay_insert(replay: ReplayState, batch: Dict[str, torch.Tensor]
                   ) -> ReplayState:
    """Insert [N] transitions at the circular cursor (N divides capacity)."""
    n = batch["actions"].shape[0]
    for k, rows in _replay_rows(replay, n).items():
        rows.copy_(batch[k])
    return _replay_advance(replay, n)


def replay_batch(replay: ReplayState, idx: torch.Tensor
                 ) -> Dict[str, torch.Tensor]:
    return {k: getattr(replay, k)[idx] for k in REPLAY_COLS}


# ---- Anakin: the shared state, rollout and train step ----------------------

@dataclasses.dataclass
class OffPolicyState:
    """What the JAX ``DQNState``/``SACState``/``TD3State`` carry besides
    the parameters and optimizer states, which ``learner`` holds in
    place; ``generator`` (on the device) stands for ``rng``, and
    ``env_steps`` counts rollout ticks (each ``num_envs`` env steps)."""
    learner: Any
    env_states: Dict[str, torch.Tensor]
    obs: torch.Tensor
    generator: torch.Generator
    replay: ReplayState
    ep_return: torch.Tensor        # per-env running return
    done_return_sum: torch.Tensor  # cumulative, 0-d
    done_count: torch.Tensor       # cumulative, 0-d
    env_steps: int = 0
    # The train step's updates (their draws, and on CUDA their graphs).
    updates: Optional["AnakinUpdates"] = None


@torch.no_grad()
def offpolicy_rollout(env, state: OffPolicyState, T: int,
                      act_fn: Callable) -> OffPolicyState:
    """``T`` steps of ``act_fn(obs, generator, tick) -> action`` in the
    envs (``tick`` the rollout step's count since the start), each step's
    obs, action, reward, next obs and done written straight into the
    replay ring's next ``N * T`` rows, t-major (row ``t * N + e``, as the
    JAX step flattens its ``[T, N]`` scan output).  Returns the state
    after them, its ring advanced and its episode counters counted —
    the one copy of the episode accounting all three algorithms feed into
    ``Algorithm._episode_counter_metrics``."""
    gen = state.generator
    env_states, obs, ep_ret = state.env_states, state.obs, state.ep_return
    dsum, dcnt = state.done_return_sum, state.done_count
    N = obs.shape[0]
    rows = {k: v.view((T, N) + tuple(v.shape[1:]))
            for k, v in _replay_rows(state.replay, T * N).items()}
    for t in range(T):
        action = act_fn(obs, gen, state.env_steps + t)
        env_states, next_obs, reward, done, _ = vector_step(
            env, env_states, action, gen)
        ep_ret, dsum, dcnt = count_episodes(ep_ret, dsum, dcnt, reward,
                                            done)
        for key, x in (("obs", obs), ("actions", action),
                       ("rewards", reward), ("next_obs", next_obs),
                       ("dones", done)):
            rows[key][t] = x
        obs = next_obs
    return dataclasses.replace(
        state, env_states=env_states, obs=obs, ep_return=ep_ret,
        done_return_sum=dsum, done_count=dcnt,
        replay=_replay_advance(state.replay, T * N),
        env_steps=state.env_steps + T)


def polyak_(targets, sources, tau: float) -> None:
    """``t = (1 - tau) * t + tau * p``, in place over two parameter
    lists."""
    with torch.no_grad():
        torch._foreach_mul_(targets, 1.0 - tau)
        torch._foreach_add_(targets, sources, alpha=tau)


def stack_means(metrics_list) -> Metrics:
    """The mean over updates of each metric (0-d tensors), over the
    updates that report it (TD3's policy loss: those that took a policy
    step)."""
    names = dict.fromkeys(k for m in metrics_list for k in m)
    return {k: torch.stack([m[k] for m in metrics_list if k in m]).mean()
            for k in names}


def make_anakin_offpolicy(config: AlgorithmConfig, device, env, learner,
                          act_fn: Callable, batch_size: int,
                          action_shape=(), action_dtype=torch.int64,
                          loss_names=(), obs_shape=None,
                          before_updates: Optional[
                              Callable[[OffPolicyState], Metrics]] = None):
    """The Anakin step every replay-family algorithm runs: the envs reset
    from a generator on ``device`` seeded with ``config.seed``, a ring of
    ``buffer_size`` rounded up to a multiple of ``num_envs *
    unroll_length``; each train step rolls out ``unroll_length`` steps of
    ``act_fn`` into the ring, then, once the ring holds
    ``learning_starts`` transitions, runs ``num_updates_per_iter`` updates
    on uniform draws of ``batch_size`` rows (``AnakinUpdates``: on CUDA
    each update a replayed CUDA graph).  ``before_updates(state)``, when
    given, runs after each rollout, whatever the ring's size, and its
    metrics join the step's (Dyna-Q fits its model there).  The ring's
    rows have the shape ``obs_shape`` (``env.obs_dim`` by default).
    ``on_phase`` gets "start", "rollout" and "update".  Returns ``(state,
    step(state, on_phase=None) -> (state, metrics), env steps an
    iteration)``; before ``learning_starts`` the metrics ``loss_names``
    read NaN."""
    N, T = config.num_envs, config.unroll_length
    mesh_util.setup_data_mesh(config, N)
    generator = torch.Generator(device=device).manual_seed(config.seed)
    env_states, obs = vector_reset(env, generator, N, device)
    zero = torch.zeros((), device=device)
    state = OffPolicyState(
        learner, env_states, obs, generator,
        make_replay_state(config.buffer_size, N * T,
                          obs_shape or env.obs_dim, action_shape,
                          action_dtype, device),
        torch.zeros(N, device=device), zero, zero.clone())
    state.updates = AnakinUpdates(learner, state.replay, batch_size)

    def train_step(state: OffPolicyState,
                   on_phase: Optional[Callable[[str], None]] = None
                   ) -> Tuple[OffPolicyState, Dict[str, Any]]:
        mark = on_phase or (lambda name: None)
        mark("start")
        state = offpolicy_rollout(env, state, T, act_fn)
        mark("rollout")
        replay = state.replay
        extra = before_updates(state) if before_updates else {}
        if replay.size >= config.learning_starts:
            metrics = stack_means([
                state.updates.update(replay.size, state.generator)
                for _ in range(config.num_updates_per_iter)])
        else:
            # Before learning_starts: collect only.
            metrics = {k: float("nan") for k in loss_names}
        metrics.update(extra)
        mark("update")
        metrics.update({"replay_size": replay.size,
                        "episode_return_sum": state.done_return_sum,
                        "episode_count": state.done_count})
        return state, metrics

    return state, train_step, N * T


# ---- the learners -------------------------------------------------------------

class ReplayLearner:
    """What the replay family's learners share.  An update is
    ``device_update(batch, noise, kind)``: device work only, its random
    draws given as ``noise`` (tensors of ``noise_shapes(batch_size)``)
    and its variant as ``kind`` (``step_kind()``: TD3's policy step or
    not), so that a CUDA graph can replay it (``AnakinUpdates``);
    ``after_update(kind)`` keeps the host's counts.  ``update(batch,
    generator)`` is the form actor mode runs, on batches from the replay
    plane."""

    def __init__(self, config, device):
        self.config = config
        self.device = torch.device(device)

    def _plan(self, params):
        """``clip_by_global_norm(grad_clip)`` then ``adam(lr)``; on CUDA
        with Adam's step count on the device (``capturable``), which a
        CUDA graph of the update needs."""
        c = self.config
        update_fn, optimizer = mesh_util.build_update_plan(
            c, c.lr, c.grad_clip, params)
        capturable_adam(optimizer, self.device)
        return update_fn, optimizer

    def _load_optimizer(self, optimizer, saved: Dict[str, Any]) -> None:
        """``optimizer.load_state_dict(saved)`` that keeps what a captured
        CUDA graph of the update reads and writes: the optimizer's own
        state tensors (the loaded values are copied into them; torch's
        load puts new tensors in their place) and, on CUDA,
        ``capturable`` with the step count on the device (a checkpoint
        written on the CPU says otherwise)."""
        kept = {p: dict(st) for p, st in optimizer.state.items()}
        optimizer.load_state_dict(saved)
        for group in optimizer.param_groups:
            group["capturable"] = self.device.type == "cuda"
            for p in group["params"]:
                state = optimizer.state.get(p, {})
                for key, value in state.items():
                    if not torch.is_tensor(value):
                        continue
                    old = kept.get(p, {}).get(key)
                    if old is None:
                        state[key] = value.to(p.device)
                    else:
                        old.copy_(value)
                        state[key] = old

    def noise_shapes(self, batch_size: int):
        return ()

    def draw_specs(self, batch_size: int):
        """What an Anakin update draws besides its ring rows, in order:
        ``(what, shape)``, ``what`` being "normal" (``torch.randn``),
        "uniform" (``torch.rand``), "rows" (indices into the ring's
        filled rows) or an int ``high`` (``torch.randint(0, high)``).  By
        default the normal noise of ``noise_shapes``."""
        return [("normal", shape) for shape in self.noise_shapes(batch_size)]

    def step_kind(self):
        return None

    def after_update(self, kind) -> None:
        pass

    def update(self, batch, generator: Optional[torch.Generator] = None,
               noise=None) -> Metrics:
        """One update; its noise drawn from ``generator`` unless given."""
        if noise is None:
            noise = [torch.randn(shape, generator=generator,
                                 device=self.device)
                     for shape in self.noise_shapes(
                         batch["actions"].shape[0])]
        kind = self.step_kind()
        out = self.device_update(batch, noise, kind)
        self.after_update(kind)
        return out


class AnakinUpdates(CapturedCalls):
    """The Anakin step's updates.  Each update draws its ring indices and
    what ``learner.draw_specs`` asks for from the step's generator into
    static tensors, then runs ``device_update`` over them.  On the CPU it
    runs eagerly.  On CUDA it replays a CUDA graph of ``device_update``
    (``CapturedCalls``, a graph a ``step_kind``: TD3's two replay in any
    order): one launch where the eager update makes hundreds, each costing
    the host more than the card's work.  The ring's tensors and the
    learner's never move (a checkpoint is loaded into them in place), so
    the graphs read and write their current values."""

    def __init__(self, learner: ReplayLearner, replay: ReplayState,
                 batch_size: int):
        device = learner.device
        super().__init__(device)
        self.learner, self.replay = learner, replay
        self.idx = torch.zeros(batch_size, dtype=torch.int64, device=device)
        self.specs = list(learner.draw_specs(batch_size))
        self.noise = [torch.zeros(shape, device=device,
                                  dtype=torch.float32 if kind in (
                                      "normal", "uniform") else torch.int64)
                      for kind, shape in self.specs]

    def _update(self, kind) -> Metrics:
        return self.learner.device_update(
            replay_batch(self.replay, self.idx), self.noise, kind)

    def update(self, size: int, generator: torch.Generator) -> Metrics:
        torch.randint(0, size, self.idx.shape, generator=generator,
                      device=self.idx.device, out=self.idx)
        for (what, shape), buf in zip(self.specs, self.noise):
            if what == "normal":
                torch.randn(shape, generator=generator, device=buf.device,
                            out=buf)
            elif what == "uniform":
                torch.rand(shape, generator=generator, device=buf.device,
                           out=buf)
            else:  # "rows" of the ring's filled part, or [0, what)
                torch.randint(0, size if what == "rows" else what, shape,
                              generator=generator, device=buf.device,
                              out=buf)
        kind = self.learner.step_kind()
        out = self.run(lambda: self._update(kind), kind)
        self.learner.after_update(kind)
        # A graph's outputs are overwritten by its next replay.
        return {k: v.clone() for k, v in out.items()}


class DQNLearner(ReplayLearner):
    """The Q network, its target copy and the update plan
    (``clip_by_global_norm(grad_clip)`` then ``adam(lr)``) on ``device``:
    an update is one double-Q Huber step and the polyak sync."""

    def __init__(self, config, obs_dim: int, num_actions: int, device,
                 generator: Optional[torch.Generator] = None):
        super().__init__(config, device)
        self.module = QNetwork(obs_dim, num_actions, tuple(config.hiddens),
                               generator).to(device)
        self.target = copy.deepcopy(self.module).requires_grad_(False)
        self._params = list(self.module.parameters())
        self._target_params = list(self.target.parameters())
        self._update_fn, self.optimizer = self._plan(self._params)

    def td_loss(self, batch) -> Tuple[torch.Tensor, torch.Tensor]:
        """(mean Huber TD error, |TD error| of each row) of ``batch``, the
        target without gradient; with ``batch["weights"]`` (a prioritized
        plane's IS weights) the mean is weighted."""
        q = self.module(batch["obs"])
        q_sa = q.gather(1, batch["actions"][:, None]).squeeze(1)
        with torch.no_grad():
            q_next_target = self.target(batch["next_obs"])
            if self.config.double_q:
                # Double-Q: online net picks the argmax, target net
                # evaluates.
                next_a = self.module(batch["next_obs"]).argmax(-1)
                q_next = q_next_target.gather(1, next_a[:, None]).squeeze(1)
            else:
                q_next = q_next_target.max(-1).values
            target = batch["rewards"] + self.config.gamma * (
                1.0 - batch["dones"]) * q_next
        td_abs = (q_sa - target).abs().detach()
        if "weights" in batch:
            loss = (batch["weights"] * F.huber_loss(
                q_sa, target, reduction="none", delta=1.0)).mean()
        else:
            loss = F.huber_loss(q_sa, target, delta=1.0)
        return loss, td_abs

    def device_update(self, batch, noise=(), kind=None) -> Metrics:
        loss, td_abs = self.td_loss(batch)
        self._update_fn(torch.autograd.grad(loss, self._params))
        polyak_(self._target_params, self._params,
                self.config.target_network_tau)
        out = {"total_loss": loss.detach(), "td_error_abs": td_abs.mean()}
        if "weights" in batch:
            out["priorities"] = td_abs
        return out

    def get_weights(self) -> Dict[str, torch.Tensor]:
        """The module's state dict, copied to the CPU."""
        return {k: v.detach().to("cpu", copy=True)
                for k, v in self.module.state_dict().items()}

    def checkpoint_state(self) -> Dict[str, Any]:
        # The parameters, as the JAX package's DQN checkpoint holds them.
        return self.module.state_dict()

    def load_checkpoint_state(self, state: Dict[str, Any]) -> None:
        self.module.load_state_dict(state)


def make_anakin_dqn(config: DQNConfig, device):
    """Builds the initial state (the Q network from ``config.seed``
    through a CPU generator) and the train step on ``device``: epsilon
    greedy on a schedule over env steps, double-Q Huber updates on
    uniform draws of ``dqn_batch_size``.  Returns ``(state, step, env
    steps an iteration)``."""
    env = make_env(config)
    learner = DQNLearner(config, env.obs_dim, env.num_actions, device,
                         torch.Generator().manual_seed(config.seed))
    module = learner.module
    N = config.num_envs

    def epsilon_at(tick: int) -> float:
        # Each tick advances N env steps; epsilon_decay_steps is in env
        # steps.
        frac = min(max(tick * N / config.epsilon_decay_steps, 0.0), 1.0)
        return (config.epsilon_initial
                + frac * (config.epsilon_final - config.epsilon_initial))

    def act(obs, gen, tick):
        return epsilon_greedy(module(obs), gen, epsilon_at(tick))

    state, step, steps = make_anakin_offpolicy(
        config, device, env, learner, act, config.dqn_batch_size,
        loss_names=("total_loss", "td_error_abs"))

    def train_step(state, on_phase=None):
        state, metrics = step(state, on_phase)
        metrics["epsilon"] = epsilon_at(state.env_steps)
        return state, metrics

    return state, train_step, steps


# ---- what the three algorithms share ----------------------------------------

class ReplayAlgorithm(Algorithm):
    """The replay family's common half: the learner in both modes
    (``self.learner``), its checkpoint, the refusal of ``num_devices``
    (no data-parallel step), and actor mode's workers and replay plane.
    A subclass gives ``_make_anakin`` (``make_anakin_*``), ``_batch_key``
    (the config's batch size), ``_make_learner(probe)`` and
    ``_act_factory(probe)``, and ``_explore_arg`` if it explores with
    one."""

    _data_mesh_capable = False
    _make_anakin: Callable
    _batch_key: str

    def _setup_anakin(self):
        self._anakin_state, self._train_step, self._steps_per_iter = \
            type(self)._make_anakin(self.config, self.device)
        self.learner = self._anakin_state.learner
        self.module = self.learner.module

    def _batch_size(self) -> int:
        return getattr(self.config, self._batch_key)

    def evaluate(self, num_steps: int = 1000) -> Dict[str, float]:
        raise NotImplementedError(
            f"{type(self).__name__} has no generic evaluator (the JAX "
            "package's needs an RLModule with forward_inference)")

    # ---- checkpointing: the learner's state (the JAX package's trees) ----
    def save_checkpoint(self) -> Checkpoint:
        return Checkpoint.from_state_dict(
            self.learner.checkpoint_state(),
            extra={"iteration": self.iteration})

    def load_checkpoint(self, checkpoint: Checkpoint):
        self.learner.load_checkpoint_state(
            checkpoint.to_state_dict(map_location=self.device))
        self.iteration = checkpoint.extra().get("iteration", 0)
        if self.config.mode != "anakin":
            self.workers.sync_weights(self._sync_params())

    # ---- actor mode: CPU rollout actors -> replay plane -> learner ----
    # (the Ape-X topology; reference: ApexDQN's replay-actor architecture
    # + the learner-thread consumer, multi_gpu_learner_thread.py:20,187)
    def _make_learner(self, probe):
        raise NotImplementedError

    def _act_factory(self, probe) -> Callable:
        raise NotImplementedError

    def _explore_arg(self) -> float:
        return 0.0

    def _setup_actor_mode(self):
        import cloudpickle

        from ray_tpu_torch.rllib.env.py_envs import make_py_env
        from ray_tpu_torch.rllib.evaluation.worker_set import (
            OffPolicyRolloutWorker,
            WorkerSet,
        )

        cfg = self.config
        probe = make_py_env(cfg.env)
        try:
            self.learner = self._make_learner(probe)
            blob = cloudpickle.dumps(self._act_factory(probe))
        finally:
            if hasattr(probe, "close"):  # dimension probe only
                probe.close()
        self.module = self.learner.module
        self._env_steps = 0
        self._rb = ReplayPlane.from_config(cfg)
        self._host_rng = np.random.default_rng(cfg.seed)

        def factory(i):
            return OffPolicyRolloutWorker.options(max_restarts=1).remote(
                cfg.env, blob, i, cfg.num_envs_per_worker,
                cfg.rollout_fragment_length, cfg.seed,
                env_parallelism=cfg.env_parallelism,
                env_workers=cfg.num_env_workers)

        self.workers = WorkerSet(cfg, None, worker_factory=factory)
        self.workers.sync_weights(self._sync_params())

    def _sync_params(self) -> Dict[str, torch.Tensor]:
        """The policy's weights for the workers, on the CPU."""
        return self.learner.get_weights()

    def _training_step_actor(self) -> Dict[str, Any]:
        from ray_tpu_torch.rllib.core.learner import metrics_to_host

        def do_updates(stacked, generator):
            U = next(iter(stacked.values())).shape[0]
            outs = [self.learner.update({k: v[u] for k, v in
                                         stacked.items()}, generator)
                    for u in range(U)]
            rows = [o.pop("priorities") for o in outs if "priorities" in o]
            metrics = metrics_to_host(stack_means(outs))
            if rows:
                metrics["priorities"] = torch.stack(rows).cpu().numpy()
            return metrics

        return run_actor_replay_iter(self, self._explore_arg(),
                                     self._batch_size(), do_updates)


class DQN(ReplayAlgorithm):
    _default_config_cls = DQNConfig
    _make_anakin = make_anakin_dqn
    _batch_key = "dqn_batch_size"

    def _make_learner(self, probe):
        cfg = self.config
        if probe.num_actions is None:
            raise ValueError(f"DQN needs a discrete action env; {cfg.env!r} "
                             "is continuous")
        # Actor-mode update count: keep a replay ratio of ~4 gradient
        # samples per env step (the classic DQN regime: batch 32 every 4
        # steps).  num_updates_per_iter's default (8) is the anakin
        # path's; at actor-mode throughput (workers*envs*fragment steps
        # per iter) it under-trains.
        steps_per_iter = (cfg.num_rollout_workers * cfg.num_envs_per_worker
                          * cfg.rollout_fragment_length)
        self._actor_updates = max(cfg.num_updates_per_iter,
                                  (4 * steps_per_iter) // cfg.dqn_batch_size)
        return DQNLearner(cfg, probe.obs_dim, probe.num_actions, self.device,
                          torch.Generator().manual_seed(cfg.seed))

    def _act_factory(self, probe) -> Callable:
        obs_dim, num_actions = probe.obs_dim, probe.num_actions
        hiddens = tuple(self.config.hiddens)

        def act_factory():
            from ray_tpu_torch.rllib.algorithms.dqn import (
                QNetwork,
                epsilon_greedy,
            )

            module = QNetwork(obs_dim, num_actions, hiddens)

            def act(obs, generator, epsilon):
                return epsilon_greedy(module(obs), generator, epsilon)

            return module, act

        return act_factory

    def _epsilon_now(self) -> float:
        cfg = self.config
        frac = min(1.0, self._env_steps / max(1, cfg.epsilon_decay_steps))
        return cfg.epsilon_initial + frac * (cfg.epsilon_final
                                             - cfg.epsilon_initial)

    def _explore_arg(self) -> float:
        return self._epsilon_now()

    def _training_step_actor(self) -> Dict[str, Any]:
        eps = self._epsilon_now()
        metrics = super()._training_step_actor()
        metrics["epsilon"] = eps
        return metrics
