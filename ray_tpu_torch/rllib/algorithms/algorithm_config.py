"""AlgorithmConfig: fluent configuration (reference:
rllib/algorithms/algorithm_config.py — .environment/.rollouts/.training/
.resources/.framework chain, 2.9k LoC there; the essentials here).

A copy of ``ray_tpu/rllib/algorithms/algorithm_config.py``, which the port
may not import although it needs no JAX.  What differs: ``framework_str``
is ``"torch"``, ``framework()`` takes ``"torch"``, and ``resources()``
takes the port's ``device`` (None means CUDA, resolved by
``ray_tpu_torch.resolve_device`` when the algorithm is built, which raises
where there is no CUDA)."""
from __future__ import annotations

import copy
from typing import Any, Dict, Optional, Type


class AlgorithmConfig:
    def __init__(self, algo_class: Optional[Type] = None):
        self.algo_class = algo_class
        # environment
        self.env: Any = "CartPole-v1"
        self.env_config: Dict[str, Any] = {}
        # rollouts
        self.num_rollout_workers = 0
        self.num_envs_per_worker = 1
        self.rollout_fragment_length = 200
        self.mode = "anakin"  # "anakin" (on-device envs) | "actor" (CPU actors)
        # streaming rollout plane (actor mode; see evaluation/sample_stream.py)
        self.sample_streaming = True          # PPO/IMPALA actor samplers
        self.max_in_flight_per_worker = 2     # fragment futures per worker
        # Consumption gate: fragments acted under weights older than this
        # many published versions are dropped before the learner sees
        # them.  None disables the gate.
        self.max_weight_staleness: Optional[int] = 4
        # Distributed replay plane (replay-family actor modes; see
        # rllib/execution/replay_plane.py).  0 shards = learner-local
        # single-shard mode (the historical HostReplay path); > 0 shards
        # stores fragments on the object plane behind shard actors.
        self.replay_num_shards = 0
        self.replay_prioritized = False   # priority-proportional sampling
        self.replay_alpha = 0.6           # priority exponent (when on)
        self.replay_beta = 0.4            # IS-weight exponent
        self.n_step = 1                   # n-step returns folded at insert
        self.replay_prefetch = 0          # gathered batches kept in flight
        # Staleness gate on SAMPLED rows (vs the rollout-plane gate below):
        # rows acted under weights older than this many versions get
        # importance weight 0.  None disables.
        self.replay_max_weight_staleness: Optional[int] = None
        # VectorEnv stepping: "serial" | "thread" | "subprocess" | "auto"
        # (auto: subprocess when the actor's host has >= 4 cores).
        self.env_parallelism = "serial"
        self.num_env_workers: Optional[int] = None  # per rollout actor
        # anakin-specific
        self.num_envs = 64
        self.unroll_length = 128
        # training
        self.lr = 3e-4
        self.gamma = 0.99
        self.lambda_ = 0.95
        self.clip_param = 0.2
        self.vf_clip_param = 10.0
        self.vf_loss_coeff = 0.5
        self.entropy_coeff = 0.01
        self.num_sgd_iter = 4
        self.sgd_minibatch_size = 512
        self.train_batch_size = 4000
        self.grad_clip: Optional[float] = 0.5
        # IMPALA
        self.vtrace_clip_rho = 1.0
        self.vtrace_clip_c = 1.0
        self.broadcast_interval = 1
        # model
        self.hiddens = (64, 64)
        self.use_lstm = False
        self.lstm_cell_size = 128
        # attention memory (reference model-config keys: use_attention,
        # attention_dim, attention_num_heads,
        # attention_num_transformer_units; window replaces the reference's
        # attention_memory_inference/training pair)
        self.use_attention = False
        self.attention_dim = 64
        self.attention_num_heads = 4
        self.attention_window = 8
        self.attention_num_layers = 1
        # resources / misc
        self.seed = 0
        self.framework_str = "torch"
        # The device the Anakin step runs on: None means CUDA.
        self.device: Optional[str] = None
        # Data-parallel learner mesh (reference: num_gpus on the learner,
        # rllib/core/rl_trainer/trainer_runner.py:75-90 — one DDP bucket
        # per GPU).  TPU-first redesign: the anakin train step shard_maps
        # over a `data` mesh axis — envs sharded, grads psum'd over ICI.
        # None = legacy single-device jit; an int (1 is valid) compiles
        # the SPMD program over that many devices.
        self.num_devices: Optional[int] = None
        # ZeRO-style update sharding over the data mesh (arxiv 2004.13336;
        # ray_tpu.parallel.zero): "off" replicates the optimizer state on
        # every device, "opt" shards it 1/N (grads still all-reduced),
        # "opt+grads" also reduce-scatters the gradients.  Requires
        # num_devices (the SPMD path).
        self.zero_sharding: str = "off"
        # Gradient-reduction wire format (EQuARX, arxiv 2506.17615;
        # ray_tpu.ops.collectives): "off" = fp32 psum, "int8" =
        # block-scaled int8 (~4x fewer bytes, loss-parity gated in
        # tests/test_zero.py).  Requires num_devices.
        self.quantized_collectives: str = "off"

    # ---- fluent sections ----
    def environment(self, env=None, env_config: Optional[dict] = None):
        if env is not None:
            self.env = env
        if env_config is not None:
            self.env_config = env_config
        return self

    def rollouts(self, num_rollout_workers: Optional[int] = None,
                 num_envs_per_worker: Optional[int] = None,
                 rollout_fragment_length: Optional[int] = None,
                 mode: Optional[str] = None,
                 sample_streaming: Optional[bool] = None,
                 max_in_flight_per_worker: Optional[int] = None,
                 max_weight_staleness: Optional[int] = None,
                 env_parallelism: Optional[str] = None,
                 num_env_workers: Optional[int] = None):
        if num_rollout_workers is not None:
            self.num_rollout_workers = num_rollout_workers
            if mode is None and num_rollout_workers > 0:
                self.mode = "actor"
        if num_envs_per_worker is not None:
            self.num_envs_per_worker = num_envs_per_worker
        if rollout_fragment_length is not None:
            self.rollout_fragment_length = rollout_fragment_length
        if mode is not None:
            self.mode = mode
        if sample_streaming is not None:
            self.sample_streaming = bool(sample_streaming)
        if max_in_flight_per_worker is not None:
            self.max_in_flight_per_worker = int(max_in_flight_per_worker)
        if max_weight_staleness is not None:
            self.max_weight_staleness = max_weight_staleness
        if env_parallelism is not None:
            if env_parallelism not in ("serial", "thread", "subprocess",
                                       "auto"):
                raise ValueError(
                    f"env_parallelism must be serial|thread|subprocess|"
                    f"auto, got {env_parallelism!r}")
            self.env_parallelism = env_parallelism
        if num_env_workers is not None:
            self.num_env_workers = int(num_env_workers)
        return self

    def env_runners(self, **kw):  # new-stack alias
        return self.rollouts(**kw)

    def anakin(self, num_envs: Optional[int] = None,
               unroll_length: Optional[int] = None):
        if num_envs is not None:
            self.num_envs = num_envs
        if unroll_length is not None:
            self.unroll_length = unroll_length
        self.mode = "anakin"
        return self

    def training(self, **kw):
        for k, v in kw.items():
            if k == "model" and isinstance(v, dict):
                known = {"fcnet_hiddens", "use_lstm", "lstm_cell_size",
                         "use_attention", "attention_dim",
                         "attention_num_heads", "attention_window",
                         "attention_num_layers",
                         "attention_num_transformer_units"}
                unknown = set(v) - known
                if unknown:
                    # Same loudness as typo'd top-level params: a silent
                    # default fallback trains the wrong model.
                    raise ValueError(
                        f"unknown model config keys {sorted(unknown)}; "
                        f"known: {sorted(known)}")
                self.hiddens = tuple(v.get("fcnet_hiddens", self.hiddens))
                # Recurrent policy knobs (reference model config:
                # use_lstm / lstm_cell_size, catalog.py MODEL_DEFAULTS).
                self.use_lstm = bool(v.get("use_lstm", self.use_lstm))
                self.lstm_cell_size = int(v.get("lstm_cell_size",
                                                self.lstm_cell_size))
                # Attention-memory knobs (GTrXL path).
                self.use_attention = bool(v.get("use_attention",
                                                self.use_attention))
                self.attention_dim = int(v.get("attention_dim",
                                               self.attention_dim))
                self.attention_num_heads = int(
                    v.get("attention_num_heads", self.attention_num_heads))
                self.attention_window = int(
                    v.get("attention_window", self.attention_window))
                if ("attention_num_transformer_units" in v
                        and "attention_num_layers" in v):
                    raise ValueError(
                        "pass attention_num_transformer_units (reference "
                        "key) OR attention_num_layers, not both")
                self.attention_num_layers = int(
                    v.get("attention_num_transformer_units",
                          v.get("attention_num_layers",
                                self.attention_num_layers)))
                continue
            if not hasattr(self, k):
                raise ValueError(f"unknown training param {k!r}")
            setattr(self, k, v)
        return self

    def framework(self, framework: str = "torch"):
        if framework != "torch":
            raise ValueError("this package is the PyTorch port; the JAX "
                             "framework is the ray_tpu package")
        return self

    def resources(self, num_devices: Optional[int] = None,
                  zero_sharding: Optional[str] = None,
                  quantized_collectives: Optional[str] = None,
                  device: Optional[str] = None, **kw):
        if device is not None:
            self.device = device
        if num_devices is not None:
            self.num_devices = num_devices
        if zero_sharding is not None:
            if zero_sharding not in ("off", "opt", "opt+grads"):
                raise ValueError(f"zero_sharding must be off|opt|opt+grads, "
                                 f"got {zero_sharding!r}")
            self.zero_sharding = zero_sharding
        if quantized_collectives is not None:
            if quantized_collectives not in ("off", "int8"):
                raise ValueError(f"quantized_collectives must be off|int8, "
                                 f"got {quantized_collectives!r}")
            self.quantized_collectives = quantized_collectives
        return self

    def debugging(self, seed: Optional[int] = None, **kw):
        if seed is not None:
            self.seed = seed
        return self

    def copy(self) -> "AlgorithmConfig":
        return copy.deepcopy(self)

    def build(self, env=None):
        if env is not None:
            self.env = env
        if self.algo_class is None:
            raise ValueError("no algorithm class bound to this config")
        return self.algo_class(self)
