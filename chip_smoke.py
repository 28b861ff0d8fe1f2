"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's hand-written kernels from ``ray_tpu_torch/ops/csrc``
(the flash-attention forward, and its dq and dkv backward), holds each
against its plain PyTorch version on the card, then drives the port's
three main paths with random weights from a seed:

- serving: GPT-2 small through ``LLMServer`` (the paged-KV
  ``LLMEngine``), token-identical in fp32 to ``NaiveLM(width=1024)``,
  whose full-context forwards run the flash forward in every layer; then
  the same requests in bf16;
- the serving engine's features at GPT-2 small's width, on one fp32
  model: speculative decoding (``[spec]``, ``bench_serving_spec``'s
  protocol: 16 users, prompts 480-992, the LayerSkip draft with a 64-token
  window; the spec leg token-identical to the plain leg, greedy spec
  decoding token-identical to ``NaiveLM(width=1024)``, whose forwards are
  the only flash launches of these paths), the prefix cache
  (``[prefix]``, ``bench_serving_shared_prefix``'s: 100 users on a
  192-token prefix; cache-on token-identical to cache-off in fp32, timed
  in bf16), in-process disaggregated prefill (``[disagg]``: a
  ``PrefillWorker`` on the card; the native wire token-identical to inline
  prefill, the int8 wire >= 3x smaller) and hot weight swaps with
  rollouts (``[swap]``: every token's version stamp and logprob against a
  full-context forward of the version that stamped it);
- the task/actor/object runtime, ``ray_tpu_torch.init(num_cpus=4)`` on
  this machine with the card as its one GPU, its workers subprocesses:
  ``[runtime]`` (a task without GPUs sees ``CUDA_VISIBLE_DEVICES=""``
  and cannot resolve CUDA; a ``num_gpus=1`` actor sees the card; a second
  one waits until the first is killed; GPT-2 small's bf16 state dict goes
  from the GPU actor to the driver bit for bit, with its put and get
  rates), ``[serve]`` (``LLMServer`` as a Serve deployment, replicas at
  half a card: fp32 tokens through ``generate_many``, the handle and HTTP
  equal to ``[fp32]``'s ``NaiveLM(width=1024)`` tokens, p50/p99 latency
  and tokens/s beside the engine in this process; then bf16 autoscaled
  1 -> 2 -> 1 replicas on ``autoscale_metric`` under 8 saturating
  clients; no engine path launches a flash kernel), ``[rlhf]``
  (``RLHFLoop`` at GPT-2 small's width in bf16, a ``RemoteEngine`` at
  half a card, 16 rollouts of 960 + 64 tokens a step, overlapped and
  drain-then-train: the weight version advances one a step, 60 / 48 / 48
  flash launches a step; on an fp32 2-layer cut the engine's behavior
  log-probs equal the learner's recomputation and the learner's first
  gradients and update losses the CPU's), ``[disagg-actor]`` (``bench_serving_disagg``'s two legs at
  GPT-2 small fp32, the ``PrefillWorker`` a GPU actor beside the driver's
  engine, the object plane off and on: tokens equal to the colocated
  leg's and to ``[disagg]``'s in-process native leg, occupancy, TTFT and
  tokens/s as readings), ``[swap-ref]`` (``swap_weights`` of a ref to a
  state dict a GPU actor put: the greedy tokens of an engine built with
  those weights), ``[actor-train]`` (``[train]``'s B=16 S=1024 steps
  in a GPU actor: the kernels the driver built, 12 launches of each a
  step in the worker, the losses bit for bit ``[train]``'s) and
  ``[trainer]`` (``bench_gpt2``'s two fits, B=16 S=1024 and B=4 S=4096,
  through ``TorchTrainer`` with one GPU worker: int32 tokens from
  ``data.from_numpy`` at 1k and from .npy shards through ``read_numpy``
  and a ``BatchMapper`` at 4k, the batches through ``get_dataset_shard``
  -> ``iter_device_batches``; 12 launches of each kernel a step in the
  worker, and at 1k the losses bit for bit those of the same steps on the
  same batches in this process), ``[data]`` (``bench_streaming_data``'s
  plan, 16 lazy reads of 4 MiB and a map, streaming in a window of 3
  against eager: blocks/s, peak resident store bytes, peak in flight,
  the same blocks and checksum, the window held, streaming's peak below
  eager's; then GPT-2 small's step at B=16 S=1024 fed through
  ``read_streaming`` -> ``BatchMapper`` -> ``random_shuffle(seed=0)`` ->
  ``iter_device_batches`` under a store budget: 12 launches of each
  kernel a step, finite falling losses, the rows consumed are the rows
  written, the store's peak within the budget; tokens/s beside
  ``[train]``'s), ``[zero]`` (``bench_gpt2``'s third fit,
  ZeRO-2 with the int8 wire through ``compile_zero_step``, one worker over
  NCCL: world 1, so the update is the plain one and its losses equal
  ``[trainer]``'s bit for bit; one step profiled by kernel group); and
  actor-mode RL, which runs just after ``[runtime]``: ``[ppo-actor]``
  (``bench_ppo_real_env``'s configuration on CartPole-v1: 2 CPU rollout
  actors x 8 envs x 256 steps, the streaming sampler with 2 fragments in
  flight a worker, the learner on the card; trained to reward 100, then
  streaming and lockstep env-steps/s, the stream's readings, the SGD and
  publish times; only this process holds the card; the checkpoint round
  trip), ``[impala-actor]`` (IMPALA, then APPO, 2 x 4 x 32 for 20
  iterations: finite losses, every env step, the weight lag within the
  staleness bound) and ``[dqn-actor]`` (DQN, 2 CPU rollout actors x 4
  envs x 64 steps feeding the replay plane, the learner on the card: the
  local plane to reward 100 within 80 iterations; 10 iterations on 2
  prioritized shards, every sampled batch one ``get_many`` gather, the
  fragments inserted as refs only, the TD errors back as priorities;
  only this process holds the card); in a second cluster, ``[dp2]``: two ranks at half
  the card each over gloo (NCCL refuses two ranks on one device), ZeRO-2
  through ``TorchTrainer`` on the fp32 and int8 wires (the ranks'
  parameters bit-identical after every step, losses against one
  worker's, the int8 wire's against the fp32 wire's, the parameters'
  change against one worker's plain steps with a half-batch control
  that must fail it, the optimizer bytes a replica, the sharded state saved at
  world 2 and restored at world 1 here), ``ElasticMeshGroup`` at GPT-2
  small shrinking on a preemption notice (bit for bit
  ``reference_trajectory`` here) and ``DistributedLearnerGroup`` with
  ``[ppo-actor]``'s learner, then ``[layouts]``: two ranks at half the
  card over gloo run GPT-2 tiny with MoE (4 experts, top-2, fp32) in the
  ``data`` (DDP), ``expert`` (the expert-parallel MoE's all-to-alls) and
  ``sequence`` (``ring_attention``) layouts, each loss and gradient held
  to one rank's step here, and ring and Ulysses attention against full
  attention on the JAX tests' shapes; then the two dryrun legs that
  need the pipelines (``__graft_entry__.py``'s ``_dryrun_pipeline_mesh``
  and ``_dryrun_llama_3d``): GPT-2 tiny in 2 stages and Llama tiny in 2
  stages x 2 virtual chunks with ZeRO, each stage a 2-rank gang (the
  reference's ``spmd_devices=2``), held to the chunks composed here on
  the fp32 wire, and the int8 wire within 0.05 with >= 3x fewer bytes;
  they run in a process and a cluster of their own beside the serving
  phases (``chip_smoke.py --pipeline-legs <dir>``, joined with the RL
  phases' process before ``[train]``);
- ``[pipeline]`` (after ``[resnet]`` in the shared cluster):
  ``bench_gpt2_pipeline`` at its full configuration, GPT-2 small in fp32
  at B=16 S=1024 through ``MPMDPipeline`` with its stage actors on the
  card (one stage with one microbatch, then two with 8), AdamW: tokens/s,
  MFU, bubble fraction against ``simulate_schedule``, activation GB/s, no
  driver sync in the stream, and each leg's losses, the lockstep steps
  and the streamed ones, held to the same chunks composed here (the fp32
  flash kernels' user path);
- ``[resnet]`` (after ``[zero]`` in the shared cluster): ResNet-50 with
  the CIFAR stem through ``TorchTrainer`` (one worker,
  ``train_loop_per_worker``, one epoch of 8192 seeded images of
  CIFAR-10's shape through the Data ingest at B=256), then
  ``BatchPredictor`` with ``TorchPredictor`` over 2048 held-out images
  from the fit's checkpoint: held-out accuracy >= 0.5;
- training: GPT-2 small steps (bf16 compute over fp32 parameters,
  ``adamw(3e-4)``, ``make_train_step``) at the JAX bench's two shapes,
  B=16 x S=1024 and B=4 x S=4096, every layer running the forward with
  the LSE and both backward kernels; ``[moe-train]``, the same step at
  B=8 x S=1024 with ``MoEConfig()``'s 8 experts (top-2) in every block
  (12 launches of each kernel a step, a falling loss); then one fp32
  step of a 2-layer GPT-2 small, and of its MoE cut, on the card against
  the same step on the CPU; ``[remat]``, GPT-2 medium (24 x 1024) at
  B=8 x S=1024 with the remat layer stack and without it, from the same
  weights: the same losses, a lower peak memory, 48/24/24 launches a
  step checkpointed and 24/24/24 not;
- the Llama family at ``llama_1b``'s shape (the TinyLlama-1.1B config:
  22 layers, width 2048, 32 query heads over 4 K/V heads):
  ``[llama-serve]`` serves it in bf16 through ``LLMServer`` (8 requests,
  prompts of 88-1316 tokens, 64 greedy tokens; pages at 4 K/V heads),
  then holds the engine's fp32 tokens to ``NaiveLM(width=2048)`` (the
  fp32 flash forward in each layer) and the bf16 logits to the fp32
  ones; ``[llama-train]`` trains it at ``bench_llama_3d``'s B=8 S=1024
  (bf16 over fp32 parameters, ``adamw(3e-4)``; 22 launches of each
  kernel a step, K and V repeated from the 4 K/V heads; one profiled
  step); ``[llama-train-fp32]`` compares one fp32 step of its 2-layer cut,
  card against CPU;
- reinforcement learning (``[ppo]``): Anakin PPO on Breakout-Atari84 at
  ``bench.py::bench_ppo_atari84``'s configuration (2048 envs x 64 steps,
  the Nature CNN, fp32), after its env and module are held against the
  CPU; trained to the bench's reward floor, then timed and profiled
  (with the device time of cuDNN's layout transposes);
- the rest of the one-process RL path: the MinAtar, Pendulum and
  StatelessCartPole envs' ``step_core`` card against CPU (``[envs]``);
  PPO (``[ppo-minatar]``) and IMPALA (``[impala]``, seeds in turn) on
  Breakout-MinAtar at ``bench_ppo_breakout``'s and
  ``bench_impala_breakout``'s configurations (16384 envs x 64 steps),
  each trained to the bench's reward floor, then timed; APPO at IMPALA's
  size, timed (``[appo]``); LSTM and attention PPO on
  StatelessCartPole at the tuned example's settings, trained to reward
  150 and evaluated greedily (``[memory]``); the replay family with its
  ring on the card, each update replayed as a CUDA graph (held once
  against the same update eager): DQN on CartPole-v1 to reward 150
  within 90 iterations (``[dqn]``), SAC and TD3 on PendulumContinuous-v1
  to -300 within 200 (``[sac]``, ``[td3]``), then DDPG for 5 iterations;
  then the rest of RLlib, each at its JAX test's configuration, gate and
  iteration budget: ``[offline]`` (a PPO expert's greedy rollout written
  with ``JsonWriter`` and BC cloning it: bc_loss < 0.3, score >= 100;
  MARWIL on 60%-random scripted data: score >= 250), ``[es]`` (>= 120
  within 30 generations), ``[bandit]`` (LinUCB, LinTS: the 9th
  iteration's regret < 0.3x the first's), ``[dynaq]`` (>= 100 within 80,
  the model loss falling), ``[qmix]`` (>= 12 within 150) and ``[mappo]``
  (>= 28 within 60), each with ms an iteration and launch calls eager and
  from its CUDA graphs; ``[cli]`` runs ``python -m
  ray_tpu_torch.rllib.train -f`` on a JSON file in a process of its own
  beside them.  Every Anakin PPO step replays its minibatch updates from
  CUDA graphs.  No RL path reaches a flash kernel (checked, path by
  path).

Each C entry picks its kernel by dtype (every bf16 kernel: ``wgmma``;
every fp32 kernel: ``fma``); the script checks and prints the routes
after the build, and the main paths run in those dtypes.  Then it times
each kernel (in CUDA graphs, without the host's enqueue) beside its
bound, its achieved TFLOP/s, its plain version and PyTorch's SDPA, in
bf16 at the training shapes (GPT-2's two and llama_1b's) and in fp32 at
the fp32 step's shape and ``[pipeline]``'s microbatch shape.
The RL phases that need no cluster, ``[ppo-parity]`` to ``[cli]``, run
in a process of their own (``chip_smoke.py --rl-phases <dir>``), and
``[layouts]``' pipeline legs in another with a cluster of its own
(``--pipeline-legs``), both started before the cluster and joined before
``[train]``: beside ``[runtime]`` to ``[swap]``, whose times are
readings only, so that the training phases and the kernels' timings
have the card to themselves.  Their logs are printed where they are
joined.
Every phase raises on failure and nothing is caught, so any failure
exits non-zero; a failure in a child's process fails its join.

Just before the kernels line come one ``[record]`` line a phase (its
seconds and headline numbers as compact JSON), so that a log cut to its
last lines keeps every phase's numbers.
The line before the last is the card's name and power limit, as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
them; the line before that is a JSON object of every kernel's launches,
error and times.  The last line is exactly
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without CUDA it exits non-zero and prints no result.
"""
from __future__ import annotations

import collections
import concurrent.futures
import copy
import dataclasses
import functools
import itertools
import json
import os
import subprocess
import sys
import threading
import time
import types

import numpy as np
import torch
import torch.nn.functional as F

import ray_tpu_torch
from ray_tpu_torch.models import (
    GPT2Config,
    Llama,
    LlamaConfig,
    ResNet,
    ResNetConfig,
    gpt2_loss_fn,
    llama_loss_fn,
    resnet_loss_fn,
    split_stages,
)
from ray_tpu_torch.models import llama as llama_mod
from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops import attention as attn
from ray_tpu_torch.ops.moe import (
    MoEConfig,
    make_expert_parallel_moe,
    moe_apply,
    moe_apply_token_sharded,
)
from ray_tpu_torch.parallel import MeshSpec, make_mesh
from ray_tpu_torch.parallel import mpmd_pipeline as mpmd
from ray_tpu_torch.parallel.ring_attention import (
    ring_attention,
    ulysses_attention,
)
from ray_tpu_torch.rllib import (
    APPOConfig,
    BanditLinTSConfig,
    BanditLinUCBConfig,
    BCConfig,
    DDPGConfig,
    DQNConfig,
    DynaQConfig,
    ESConfig,
    IMPALAConfig,
    MAPPOConfig,
    MARWILConfig,
    PPOConfig,
    QMixConfig,
    RLModuleSpec,
    SACConfig,
    TD3Config,
)
from ray_tpu_torch.rllib.offline import JsonWriter
from ray_tpu_torch.rllib.policy.sample_batch import SampleBatch
from ray_tpu_torch.rllib.utils import mesh as rl_mesh
from ray_tpu_torch.rllib.env.py_envs import PyCartPole, VectorEnv
from ray_tpu_torch.rllib.env.torch_envs import Breakout84, make_torch_env
from ray_tpu_torch.rllib.evaluation.worker_set import (
    FragmentBuffers,
    collect_fragment,
    fragment_batch,
)
from ray_tpu_torch.models.convert import layerskip_draft
from ray_tpu_torch.serve import (
    LLMEngine,
    LLMServer,
    NaiveLM,
    PrefillWorker,
    PrefixCacheLocal,
    SamplingParams,
    build_model,
)
from ray_tpu_torch.serve.sampling import draw_seed
from ray_tpu_torch import data as rdata
from ray_tpu_torch.air import Checkpoint, ScalingConfig
from ray_tpu_torch.train import (
    BatchPredictor,
    TorchPredictor,
    TorchTrainer,
    adamw,
    make_train_step,
)

# Published H100 SXM peaks (NVIDIA data sheet, dense): memory bytes/s and
# operations/s by input type.  The bound of a call is the larger of its
# bytes over the memory rate and its operations over the peak for its type.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}

# Kernel against its plain version.  fp32 differs only by summation
# order: atol 1e-4 on outputs of size ~1.  In bf16 the kernel rounds P to
# bf16 before P.V, as the TPU kernel does (a relative error of at most
# 2^-8 per entry, of random sign, so about 2^-8 of the row's |O|), and
# both round O to bf16, where they can land one ulp apart (at most 2^-7
# of the row's largest |O|).  So bf16 is held, in each (b, q, h) row, to
# 2^-5 of that row's largest |O_ref|: about twice both effects at their
# extremes, and a bound that shrinks with |O| at long L, where a flat
# atol would exceed a typical |O|.  The LSE is fp32 in both cases.
TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -5}
LSE_ATOL = 1e-4
# Lengths that are odd multiples of the kernels' 64-row tile (3 and 5
# tiles), added to both grids at B = 1.
ODD_TILE_LENGTHS = (192, 320)
# The path's attention shape: NaiveLM at width 1024 on GPT-2 small.
PATH_SHAPE = (1, 1024, 12, 64)
# [pipeline]'s microbatch attention (B=16 over 8 microbatches, fp32).
PIPELINE_ATTN_SHAPE = (2, 1024, 12, 64)
# The Llama paths' attention shapes (B, L, H; D = 64), added to both
# grids: the llama_1b training step's, bf16 8x32x1024x64 with the LSE,
# and its NaiveLM oracle's, fp32 1x32x2048x64.
LLAMA_KERNEL_SHAPES = ((8, 1024, 32, torch.bfloat16),
                       (1, 2048, 32, torch.float32))
SEED = 0
PROMPT_LENS = (17, 60, 123, 200, 256, 300)
NEW_TOKENS = 32
# bf16 full-context logits against fp32 on the same weights: 12 layers of
# bf16 rounding (2^-8 relative per op) on logits of scale ~1; the bound is
# 5% of the largest fp32 logit.
BF16_LOGITS_REL = 0.05
# Backward kernels against flash_attention_backward_reference on the same
# (q, k, v, O, LSE, dO).  fp32: max |dX| <= 1e-4, as for O; the gradients
# of these random inputs are O(1-10) and differ only by summation order
# (~1e-6).  bf16: in each (b, l, h) row, |dX| <= 2^-5 of the row's
# largest |dX_ref|.  Both round dS (and P for dV) to bf16 at the same
# points, so an element of dS or P can differ by one bf16 ulp only where
# the two fp32 sums straddle a rounding boundary (a 2^-8 relative change
# of one term of dX's sum); then both round dX to bf16, where they can
# land one ulp (at most 2^-7 of the row's largest |dX|) apart.  The bound
# is four such ulps.  A row whose gradient cancels to ~0 (dq's first
# causal row: P = 1 and dP = Delta up to rounding) holds only rounding
# noise, so the denominator is floored at 2^-8 of the tensor's largest
# |dX_ref|.
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -5}
# The fp32 kernel gradients against torch.autograd through
# flash_attention_reference (softmax materialised, no LSE recompute):
# the same function in other fp32 orders, so the fp32 atol again.
AUTOGRAD_ATOL = 1e-4
# Training: the JAX bench's two GPT-2 small shapes (bench.py:210 and
# :270), warm-up step then timed steps.
TRAIN_SHAPES = ((16, 1024, 10), (4, 4096, 5))  # (B, S, timed steps)
LN_VOCAB = float(np.log(50257))
# [timing-bwd]'s shapes (B, L, H, layout of q, k, v): GPT-2's two training
# shapes (the views of a fused QKV output) and llama_1b's (contiguous:
# rope and the GQA expand make new tensors).
TIMING_BWD_SHAPES = ((16, 1024, 12, "fused"), (4, 4096, 12, "fused"),
                     (8, 1024, 32, "contiguous"))
FIRST_LOSS_SLACK = 0.5
# One fp32 step of a 2-layer GPT-2 small, card (the three kernels) against
# CPU (the plain attention path), TF32 off.  The loss is a mean over 1023
# positions of fp32 cross-entropies: rtol 1e-5.  A gradient is a sum over
# the 1024 tokens (and, for wte, over the 50257 logits of the tied head)
# taken in other orders on the two devices: fp32 rounding of such sums
# leaves a relative error of ~sqrt(n) * 2^-24 <= 1.4e-5 per element at
# worst, and a norm-wise error below that; each parameter's gradient is
# held to a relative norm error of 1e-4, ~7x that worst case.
FP32_STEP_LAYERS = 2
FP32_LOSS_RTOL = 1e-5
FP32_GRAD_REL = 1e-4
# PPO: bench.py::bench_ppo_atari84 (:1085-1096) as it is, not cut.  The
# gate is bench.py::_learn_to_floor's: one warm-up iteration, then the
# CURRENT episode_reward_mean >= ATARI84_REWARD_FLOOR (bench.py:28) at an
# iteration >= 10, within 150; then PPO_TIMED_ITERS timed iterations
# (_measure_steps_per_s).
PPO_ENVS, PPO_UNROLL = 2048, 64
PPO_TRAINING = {"num_sgd_iter": 2, "sgd_minibatch_size": 8192, "lr": 5e-4,
                "entropy_coeff": 0.01}
PPO_PARAMS = 2_061_732  # the JAX module's count on Breakout-Atari84
ATARI84_REWARD_FLOOR = 15.0
PPO_MAX_ITERS = 150
# Timed iterations after the floor (PPO, MinAtar PPO, IMPALA's gate
# seed), few to keep the script within its time limit; each iteration
# does the same work.
PPO_TIMED_ITERS = 2
# The module's logits and value on the card against the CPU, fp32 with TF32
# off: the same sums (fan-in up to 7744) in other orders, ~1e-6 relative;
# held to 1e-4 of each output's largest magnitude.
PPO_MODULE_RTOL = 1e-4
# The MinAtar-scale paths, at bench.py's configurations, not cut.
# PPO: bench_ppo_breakout (:1127-1166), gated at BREAKOUT_REWARD_FLOOR
# (bench.py:25) as _learn_to_floor gates it, then PPO_TIMED_ITERS timed.
MINATAR_ENVS, MINATAR_UNROLL = 16384, 64
MINATAR_PPO_TRAINING = {"num_sgd_iter": 2, "sgd_minibatch_size": 8192,
                        "lr": 5e-4, "entropy_coeff": 0.01}
MINATAR_REWARD_FLOOR = 3.0
# IMPALA: bench_impala_breakout (:1282-1331): seeds 0, 1, 2 in turn, each
# trained to the floor with the margin target; the first seed that reaches
# the target ends the loop; throughput is timed on the best seed that met
# the floor.  The budget is cut from the bench's 300 iterations a seed to
# 110, to keep the script's time with the serving and data-parallel
# phases: on the H100 (cuDNN deterministic, so every run repeats them)
# the rewards of seeds 0 and 1 stop rising near 1.48-1.49 by iteration
# 110, and seed 2 passes the floor at iteration 100 and reads 1.64 at
# 110 (PERF.md, section 6).
IMPALA_TRAINING = {"lr": 2e-3, "entropy_coeff": 0.01}
IMPALA_FLOOR, IMPALA_TARGET, IMPALA_MAX_ITERS = 1.5, 1.8, 110
IMPALA_SEEDS = (0, 1, 2)
APPO_TIMED_ITERS = 4
# LSTM and attention PPO on StatelessCartPole: the tuned example
# ray_tpu/rllib/tuned_examples/stateless-cartpole-attention.yaml (the LSTM
# with lstm_cell_size 64, as tests/test_ppo_rnn.py:76-80), gated on the
# best reward >= 150 within 120 iterations.
MEMORY_ENVS, MEMORY_UNROLL = 64, 64
MEMORY_TRAINING = {"lr": 3e-4, "num_sgd_iter": 4,
                   "sgd_minibatch_size": 1024, "entropy_coeff": 0.01}
MEMORY_MODELS = {"lstm": {"use_lstm": True, "lstm_cell_size": 64},
                 "attention": {"use_attention": True, "attention_dim": 64,
                               "attention_window": 8}}
MEMORY_FLOOR, MEMORY_MAX_ITERS = 150.0, 120
# The envs' step_core, card against CPU: integer state, boards, rewards
# and dones bitwise; float state (Pendulum, CartPole) within this of
# 1 + |CPU value| (sin/cos may round an ulp apart).
ENV_STATES = 2048
ENV_FLOAT_TOL = 1e-6


def log(*args):
    print(*args, flush=True)


# Each phase's seconds and headline numbers, printed again as one compact
# line a phase just before the kernels line, so that a log cut to its
# last lines still holds every phase's numbers.
RECORD: dict = {}


def note(tag, **numbers):
    RECORD.setdefault(tag, {}).update(numbers)


def record_lines() -> list:
    def short(v):
        return float(f"{v:.4g}") if isinstance(v, float) else v

    return [f"[record] {tag} " + json.dumps(
        {k: short(v) for k, v in numbers.items()}, separators=(",", ":"))
        for tag, numbers in RECORD.items()]


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters=50, warmup=5) -> float:
    """Mean device time of fn() over ``iters`` back-to-back launches."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, launches=20, replays=10) -> float:
    """Device time of one fn(): ``launches`` calls captured in one CUDA
    graph, replayed ``replays`` times between CUDA events, so that the
    host's enqueue time (which exceeds a short kernel's run at B = 1) is
    not counted."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (launches * replays)
    del graph
    torch.cuda.empty_cache()
    return ms


def flash_bound(q, causal, kernel="fwd", with_lse=False) -> tuple:
    """Least time (ms) for a flash kernel on these self-attention inputs
    (lq == lk), over the visible (q, k) pairs, each input read once and
    each output written once:

    - fwd: Q, K, V read, O (and the fp32 LSE) written; QK^T and PV, 4*D
      operations a pair;
    - dq: Q, K, V, dO, LSE and Delta read, dQ written; QK^T, dO V^T and
      dS K, 6*D a pair;
    - dkv: the same inputs, dK and dV written; QK^T, dO V^T, P^T dO and
      dS^T Q, 8*D a pair;
    - bwd: the backward function itself, whichever kernels compute it:
      Q, K, V, O, dO and LSE read, dQ, dK and dV written; QK^T, dO V^T,
      P^T dO, dS K and dS^T Q, 10*D a pair (dq + dkv recompute S and dP,
      so their two bounds add to more than this one).

    Returns (ms, "bytes" or "operations")."""
    b, lq, h, d = q.shape
    tensor_bytes = q.numel() * q.element_size()
    row_bytes = b * h * lq * 4  # one fp32 value per row (LSE, Delta)
    tensors, rows = {"fwd": (4, int(with_lse)), "dq": (5, 2), "dkv": (6, 2),
                     "bwd": (8, 1)}[kernel]
    nbytes = tensors * tensor_bytes + rows * row_bytes
    ops = flash_ops(q, causal, kernel)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[q.dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def flash_ops(q, causal, kernel="fwd") -> int:
    """Operations of a flash kernel on the visible (q, k) pairs of these
    self-attention inputs: 4*D a pair (fwd), 6*D (dq), 8*D (dkv), 10*D
    (bwd), as ``flash_bound`` counts them."""
    b, lq, h, d = q.shape
    pairs = lq * (lq + 1) // 2 if causal else lq * lq
    per_pair = {"fwd": 4, "dq": 6, "dkv": 8, "bwd": 10}[kernel]
    return per_pair * b * h * pairs * d


def rate_line(q, causal, kernel, ms, with_lse=False) -> str:
    """A kernel's achieved TFLOP/s on the visible pairs and its share of
    the bound (bound / time)."""
    bound_ms, bound_by = flash_bound(q, causal, kernel, with_lse)
    tflops = flash_ops(q, causal, kernel) / (ms * 1e-3) / 1e12
    return (f"{tflops:.1f} TFLOP/s, {bound_ms / ms:.1%} of its bound "
            f"{bound_ms:.4f} ms ({bound_by})")


def routes_by_dtype() -> dict:
    """Each kernel's route for each dtype, as its C entry names it."""
    libs = {"flash_fwd": _build.load("flash_fwd"),
            "flash_dq": _build.load("flash_bwd"),
            "flash_dkv": _build.load("flash_bwd")}
    return {name: {str(dtype)[6:]: getattr(lib, f"rtt_{name}_route")(code)
                   .decode() for dtype, code in attn._DTYPE_CODES.items()}
            for name, lib in libs.items()}


def kernel_error(o, o_ref) -> float:
    """The error that ``TOL`` bounds: max |dO| in fp32; in bf16, |dO| over
    the largest |O_ref| of its row (over D)."""
    diff = (o.float() - o_ref.float()).abs()
    if o.dtype == torch.float32:
        return diff.max().item()
    row = o_ref.float().abs().amax(-1, keepdim=True).clamp_min(1e-30)
    return (diff / row).max().item()


def bwd_error(g, ref) -> float:
    """The error that ``BWD_TOL`` bounds: max |dX| in fp32; in bf16, |dX|
    over the largest |dX_ref| of its row (over D), that denominator
    floored at 2^-8 of the tensor's largest |dX_ref|."""
    diff = (g.float() - ref.float()).abs()
    if g.dtype == torch.float32:
        return diff.max().item()
    ref = ref.float().abs()
    row = ref.amax(-1, keepdim=True).clamp_min(2.0 ** -8 * ref.max())
    return (diff / row).max().item()


def zero_launches():
    for name in attn.LAUNCHES:
        attn.LAUNCHES[name] = 0


def fused_qkv(b, length, h, d, dtype, gen):
    """q, k, v as the model gives them to attention: the split thirds of
    one [B, L, 3*H*D] QKV output, each viewed as [B, L, H, D] (L stride
    3*H*D)."""
    qkv = torch.randn(b, length, 3 * h * d, device="cuda",
                      generator=gen).to(dtype)
    return [x.reshape(b, length, h, d) for x in qkv.split(h * d, dim=-1)]


def cudart_libs() -> list:
    """The CUDA runtime libraries mapped into this process."""
    with open("/proc/self/maps") as maps:
        return sorted({line.split()[-1] for line in maps
                       if "libcudart" in line})


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[device] {card_line()} | torch {torch.__version__} "
        f"cuda {torch.version.cuda} | python {sys.version.split()[0]}")


def phase_build():
    """Build every kernel source, one nvcc each, all started together, and
    check that the libraries bind to the one CUDA runtime PyTorch
    loaded."""
    def build(name):
        t0 = time.perf_counter()
        _build.load(name)
        return f"{name} {time.perf_counter() - t0:.1f} s"

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(_build.SIGNATURES)) as pool:
        times = list(pool.map(build, _build.SIGNATURES))
    libs = cudart_libs()
    log(f"[build] {', '.join(times)} ({time.perf_counter() - t0:.1f} s in "
        f"parallel); CUDA runtime(s) in the process: {libs}")
    if len(libs) != 1:
        raise AssertionError(f"expected one libcudart, found {libs}")
    routes = routes_by_dtype()
    log(f"[build] routes by dtype: {routes}")
    want = {"flash_fwd": {"bfloat16": "wgmma", "float32": "fma"},
            "flash_dq": {"bfloat16": "wgmma", "float32": "fma"},
            "flash_dkv": {"bfloat16": "wgmma", "float32": "fma"}}
    if routes != want:
        raise AssertionError(f"routes {routes}, expected {want}")


def phase_kernel_grid():
    """The flash kernel against flash_attention_reference over the grid,
    in both layouts (contiguous, and the model's views of a fused QKV
    output), and both refusals."""
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    n = 0
    dtypes = (torch.bfloat16, torch.float32)
    # The base grid (12 heads), then lengths that are odd multiples of the
    # 64-row tile (B = 1, with the LSE), then the Llama paths' shapes.
    cases = [(b, n, 12, d, dt, (True, False)) for b, n, d, dt in
             itertools.product((1, 4), (128, 1024, 2048), (64, 128), dtypes)]
    cases += [(1, n, 12, d, dt, (True,)) for n, d, dt in
              itertools.product(ODD_TILE_LENGTHS, (64, 128), dtypes)]
    cases += [(b, n, h, 64, dt, (True, False))
              for b, n, h, dt in LLAMA_KERNEL_SHAPES]
    with torch.no_grad():
        for b, length, h, d, dtype, lse_cases in cases:
            fused = fused_qkv(b, length, h, d, dtype, gen)
            for layout, causal, with_lse in itertools.product(
                    ("contiguous", "fused_qkv"), (True, False), lse_cases):
                q, k, v = fused if layout == "fused_qkv" else \
                    [x.contiguous() for x in fused]
                got = attn.flash_attention(q, k, v, causal=causal,
                                           return_lse=with_lse)
                want = attn.flash_attention_reference(
                    q, k, v, causal=causal, return_lse=with_lse)
                torch.cuda.synchronize()
                o, o_r = (got[0], want[0]) if with_lse else (got, want)
                err = kernel_error(o, o_r)
                lse_err = (got[1] - want[1]).abs().max().item() \
                    if with_lse else 0.0
                if not (err <= TOL[dtype] and lse_err <= LSE_ATOL):
                    raise AssertionError(
                        f"flash kernel disagrees (B={b} L={length} H={h} "
                        f"D={d} "
                        f"{str(dtype)[6:]} {layout} causal={causal} "
                        f"lse={with_lse}): error {err:.3g}, |dLSE| "
                        f"{lse_err:.3g}")
                worst[dtype] = max(worst[dtype], err)
                n += 1
    note("kernel", cases=n, worst_fp32=worst[torch.float32],
         worst_bf16=worst[torch.bfloat16])
    log(f"[kernel] flash_fwd == reference on {n} cases; worst fp32 max "
        f"|dO| {worst[torch.float32]:.3g} (atol {TOL[torch.float32]}); "
        f"worst bf16 |dO| / row max |O_ref| {worst[torch.bfloat16]:.3g} "
        f"(bound {TOL[torch.bfloat16]:.3g})")
    q = torch.zeros(1, 96, 12, 64, device="cuda")
    for args, kw, what in (((q, q, q), {"causal": False}, "multiples"),
                           ((torch.zeros(1, 128, 12, 64, device="cuda"),
                             torch.zeros(1, 256, 12, 64, device="cuda"),
                             torch.zeros(1, 256, 12, 64, device="cuda")),
                            {"causal": True}, "lq == lk")):
        try:
            attn.flash_attention(*args, **kw)
        except ValueError as e:
            assert what in str(e), e
        else:
            raise AssertionError(f"flash_attention did not refuse ({what})")
    log("[kernel] both refusals raise ValueError")


def _bwd_case(q, k, v, causal, gen):
    """(dq, dk, dv) through _FlashAttention (the kernels) and from
    flash_attention_backward_reference on the same (q, k, v, O, LSE,
    dO)."""
    d_out = torch.randn(q.shape, device="cuda", generator=gen).to(q.dtype)
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    out, lse = attn.flash_attention(*leaves, causal=causal, return_lse=True)
    out.backward(d_out)
    with torch.no_grad():
        want = attn.flash_attention_backward_reference(
            q, k, v, out.detach(), lse, d_out, causal)
    torch.cuda.synchronize()
    return [x.grad for x in leaves], want, out.detach(), d_out


def phase_kernel_bwd_grid():
    """The dq and dkv kernels (through _FlashAttention's backward) against
    flash_attention_backward_reference over the grid, in both layouts,
    plus non-causal lq != lk each way; then the fp32 kernel gradients
    against torch.autograd of flash_attention_reference."""
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    n = 0

    def check(got, want, what):
        nonlocal n
        for g, ref, name in zip(got, want, ("dq", "dk", "dv")):
            err = bwd_error(g, ref)
            if not (g.dtype == ref.dtype and g.shape == ref.shape
                    and err <= BWD_TOL[g.dtype]):
                raise AssertionError(f"{name} kernel disagrees ({what}): "
                                     f"error {err:.3g}")
            worst[g.dtype] = max(worst[g.dtype], err)
        n += 1

    dtypes = (torch.bfloat16, torch.float32)
    for b, length, h, d, dtype in itertools.chain(
            ((b, n, 12, d, dt) for b, n, d, dt in itertools.product(
                (1, 4), (128, 1024, 2048), (64, 128), dtypes)),
            ((1, n, 12, d, dt) for n, d, dt in itertools.product(
                ODD_TILE_LENGTHS, (64, 128), dtypes)),
            ((b, n, h, 64, dt) for b, n, h, dt in LLAMA_KERNEL_SHAPES)):
        fused = fused_qkv(b, length, h, d, dtype, gen)
        for layout, causal in itertools.product(
                ("contiguous", "fused_qkv"), (True, False)):
            q, k, v = fused if layout == "fused_qkv" else \
                [x.contiguous() for x in fused]
            got, want, _, _ = _bwd_case(q, k, v, causal, gen)
            check(got, want, f"B={b} L={length} H={h} D={d} "
                  f"{str(dtype)[6:]} {layout} causal={causal}")
    for lq, lk in ((1024, 2048), (2048, 1024)):
        for dtype in (torch.bfloat16, torch.float32):
            q = torch.randn(1, lq, 12, 64, device="cuda",
                            generator=gen).to(dtype)
            k, v = (torch.randn(1, lk, 12, 64, device="cuda",
                                generator=gen).to(dtype) for _ in "kv")
            got, want, _, _ = _bwd_case(q, k, v, False, gen)
            check(got, want, f"lq={lq} lk={lk} {str(dtype)[6:]} "
                  f"non-causal")
    note("kernel-bwd", cases=n, worst_fp32=worst[torch.float32],
         worst_bf16=worst[torch.bfloat16])
    log(f"[kernel-bwd] flash_dq, flash_dkv == reference on {n} cases; "
        f"worst fp32 max |dX| {worst[torch.float32]:.3g} (atol "
        f"{BWD_TOL[torch.float32]}); worst bf16 |dX| / row max |dX_ref| "
        f"{worst[torch.bfloat16]:.3g} (bound "
        f"{BWD_TOL[torch.bfloat16]:.3g})")
    # Independent of the LSE-recompute design: autograd through the
    # plain forward, fp32, one shape per D.
    for d in (64, 128):
        q, k, v = fused_qkv(2, 1024, 12, d, torch.float32, gen)
        got, _, _, d_out = _bwd_case(q, k, v, True, gen)
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        attn.flash_attention_reference(*leaves, causal=True).backward(d_out)
        errs = [(g - x.grad).abs().max().item()
                for g, x in zip(got, leaves)]
        log(f"[kernel-bwd] fp32 kernel vs torch.autograd of the plain "
            f"forward, 2x1024x12x{d} causal fused: max |d(dq, dk, dv)| "
            f"{max(errs):.3g} (atol {AUTOGRAD_ATOL})")
        if not max(errs) <= AUTOGRAD_ATOL:
            raise AssertionError(f"kernel gradients != autograd: {errs}")


def _requests(vocab):
    rng = np.random.default_rng(SEED)
    return [{"tokens": [int(t) for t in rng.integers(0, vocab, size=n)],
             "max_new_tokens": NEW_TOKENS} for n in PROMPT_LENS]


def serve(server, requests):
    """All requests at once through LLMServer.__call__ (max_slots=4, so
    continuous batching admits mid-flight); returns (outputs, seconds)."""
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(requests)) as pool:
        outs = [f.result() for f in [pool.submit(server, r)
                                     for r in requests]]
    return [o["tokens"] for o in outs], time.perf_counter() - t0


def margin_at(model, context):
    """Top-1 minus top-2 logit after ``context`` (full-context forward)."""
    with torch.no_grad():
        logits = model(torch.tensor([context], device="cuda"))[0, -1]
    top = logits.topk(2).values
    return float(top[0] - top[1])


def engine_line(tag, st, seconds):
    note(tag, decode_ms=st["decode_seconds"] / max(st["steps"], 1) * 1e3,
         tokens_per_s=(st["tokens_generated"] + st["prefills"]) / seconds)
    log(f"[{tag}] engine: {st['steps']} decode steps, "
        f"{st['decode_seconds'] / max(st['steps'], 1) * 1e3:.2f} ms/step; "
        f"{st['prefills']} prefills, "
        f"{st['prefill_seconds'] / max(st['prefills'], 1) * 1e3:.2f} "
        f"ms/prefill; {st['tokens_generated'] + st['prefills']} tokens in "
        f"{seconds:.2f} s = "
        f"{(st['tokens_generated'] + st['prefills']) / seconds:.1f} tokens/s;"
        f" preemptions {st['preemptions']}, admitted mid-batch "
        f"{st['admitted_mid_batch']}")


def phase_fp32_slice() -> tuple:
    """The main path: GPT-2 small fp32 through LLMServer, token-identical
    to NaiveLM(width=1024).  Returns the flash launches of this run, the
    requests and NaiveLM's tokens."""
    kw = {"tiny": False, "dtype": torch.float32}
    server = LLMServer("gpt2", kw, seed=SEED, max_slots=4)
    model = build_model("gpt2", kw, seed=SEED)
    naive = NaiveLM(model, width=1024)
    requests = _requests(model.config.vocab_size)
    try:
        zero_launches()
        outs, seconds = serve(server, requests)
        engine_launches = attn.LAUNCHES["flash_fwd"]
        st = server.stats()
        t0 = time.perf_counter()
        want = [naive.generate(r["tokens"], NEW_TOKENS) for r in requests]
        naive_s = time.perf_counter() - t0
        launches = attn.LAUNCHES["flash_fwd"]
    finally:
        server.drain()
    engine_line("fp32", st, seconds)
    steps = sum(len(w) for w in want)
    log(f"[fp32] NaiveLM(width=1024): {steps} steps in {naive_s:.2f} s, "
        f"flash_fwd launches {launches - engine_launches} "
        f"({(launches - engine_launches) / steps:.1f} per step), fp32 route "
        f"{routes_by_dtype()['flash_fwd']['float32']}")
    # One launch per layer per step: 12 on GPT-2 small.
    if launches - engine_launches != model.config.num_layers * steps:
        raise AssertionError(f"flash_fwd launched {launches - engine_launches}"
                             f" times in {steps} NaiveLM steps")
    if st["admitted_mid_batch"] < 1:
        raise AssertionError(f"no mid-flight admission: {st}")
    for r, got, ref in zip(requests, outs, want):
        if got != ref:
            i = next(j for j, (a, b) in enumerate(zip(got, ref)) if a != b)
            m = margin_at(model, r["tokens"] + ref[:i])
            raise AssertionError(
                f"engine != NaiveLM for prompt length {len(r['tokens'])} at "
                f"token {i}: {got[i]} vs {ref[i]}; top-1 minus top-2 "
                f"logit there {m:.3g}")
    log(f"[fp32] {len(requests)} requests (prompts {PROMPT_LENS}, "
        f"{NEW_TOKENS} new tokens, greedy) token-identical to NaiveLM")
    return launches, requests, want


def phase_bf16_slice():
    kw16 = {"tiny": False, "dtype": torch.bfloat16}
    server = LLMServer("gpt2", kw16, seed=SEED, max_slots=4)
    requests = _requests(50257)
    try:
        outs, seconds = serve(server, requests)
        st = server.stats()
    finally:
        server.drain()
    engine_line("bf16", st, seconds)
    # One full-context forward at width 1024 (the flash kernel in each
    # layer), bf16 against fp32 on the same weights.
    m32 = build_model("gpt2", {"tiny": False, "dtype": torch.float32},
                      seed=SEED)
    m16 = build_model("gpt2", kw16, seed=SEED)
    ids = torch.from_numpy(np.random.default_rng(SEED + 1).integers(
        0, 50257, size=(1, 1024))).to("cuda")
    with torch.no_grad():
        l32, l16 = m32(ids), m16(ids)
    torch.cuda.synchronize()
    err = (l16 - l32).abs().max().item()
    scale = l32.abs().max().item()
    agree = (l16.argmax(-1) == l32.argmax(-1)).float().mean().item()
    note("bf16", rel_err=err / scale, argmax_agree=agree)
    log(f"[bf16] full-context logits vs fp32: max |d| {err:.4g} of max "
        f"|logit| {scale:.4g} ({err / scale:.2%}, bound "
        f"{BF16_LOGITS_REL:.0%}); argmax agreement {agree:.2%}")
    if not err <= BF16_LOGITS_REL * scale:
        raise AssertionError("bf16 logits too far from fp32")
    if not torch.isfinite(l16).all():
        raise AssertionError("bf16 logits not finite")
    return outs


# ---------------------------------------------------------------------------
# The serving engine's features: speculative decoding, the prefix cache,
# in-process disaggregated prefill, hot weight swaps with rollouts
# ---------------------------------------------------------------------------
GPT2_SMALL_FP32 = {"tiny": False, "dtype": torch.float32}
# [spec]: bench_serving_spec's protocol (bench.py:742-815) at GPT-2 small:
# 16 users, prompts of 480-992 tokens (prompt + 24 new tokens + the
# window fit the 1024 context), seeded temperature-1.0 sampling, the
# LayerSkip draft (the target's wte, wpe, h_0, ln_f) with a 64-token
# window.
SPEC_USERS, SPEC_NEW, SPEC_TOKENS, SPEC_WINDOW = 16, 24, 4, 64
SPEC_PROMPT_LENS = (480, 993)  # numpy integers(low, high): 480..992
SPEC_SAMPLING = SamplingParams(temperature=1.0, top_p=1.0, seed=1)
SPEC_PARTS = ("draft", "draft_sample", "verify", "verify_sample")
# [prefix]: bench_serving_shared_prefix (:633-739): 100 users, a
# 192-token shared prefix, tails of 8-16 tokens, 8 new tokens, greedy.
PREFIX_USERS, PREFIX_SHARED, PREFIX_NEW = 100, 192, 8
PREFIX_ENGINE = {"max_slots": 32, "page_size": 16, "max_ctx": 256}
# [disagg]: prompts of 64-900 tokens, four of them sharing a 256-token
# prefix; an in-process PrefillWorker on the card beside the engine.
DISAGG_SHARED, DISAGG_NEW, DISAGG_MIN_TOKENS = 256, 8, 32
DISAGG_ENGINE = {"max_slots": 8, "page_size": 16, "max_ctx": 1024}
# [swap]: 8 rollouts (a 64-token shared prefix, tails of 8-40 tokens, 16
# sampled tokens each) with a swap to perturbed weights mid-flight; each
# captured logprob against a full-context forward of the version that
# stamped it (the reference test's rtol, test_rlhf.py:144).
SWAP_PROMPTS, SWAP_SHARED, SWAP_NEW = 8, 64, 16
SWAP_NOISE = 0.01
LOGP_RTOL, LOGP_ATOL = 1e-4, 1e-5


def perturbed_gap(model, context, position, seed, a, b) -> float:
    """At temperature 1 the sampler takes the argmax of logits + Gumbel
    noise from ``draw_seed(seed, position)``: that sum at token ``a``
    minus at token ``b`` after ``context`` (full-context forward)."""
    with torch.no_grad():
        logits = model(torch.tensor([context], device=model.wte.device))[
            0, -1]
    gen = torch.Generator().manual_seed(draw_seed(seed, position))
    u = torch.empty(logits.shape[-1]).uniform_(generator=gen)
    perturbed = logits.float() + (-torch.log(-torch.log(u))).to(
        logits.device)
    return float(perturbed[a] - perturbed[b])


def spec_leg(model, prompts, draft=None) -> tuple:
    """bench_serving_spec's leg: a warm-up request, then all prompts at
    once; returns (outputs, tokens/s, the window's stats deltas, the
    engine)."""
    kw = {} if draft is None else {"draft_model": draft,
                                   "spec_tokens": SPEC_TOKENS,
                                   "draft_window": SPEC_WINDOW}
    eng = LLMEngine(model, max_slots=SPEC_USERS, page_size=16,
                    max_ctx=1024, **kw)
    eng.result(eng.submit(prompts[0], 8, sampling=SPEC_SAMPLING),
               timeout=600)
    st0 = eng.stats()
    t0 = time.perf_counter()
    rids = [eng.submit(p, SPEC_NEW, sampling=SPEC_SAMPLING)
            for p in prompts]
    outs = [eng.result(r, timeout=600) for r in rids]
    seconds = time.perf_counter() - t0
    st = eng.stats()
    delta = {key: st[key] - st0[key] for key in (
        "tokens_generated", "steps", "spec_steps", "decode_seconds",
        "prefill_seconds", "prefills", "spec_proposed", "spec_accepted")}
    delta["split"] = {part: st["spec_split_seconds"].get(part, 0.0)
                      - st0["spec_split_seconds"].get(part, 0.0)
                      for part in SPEC_PARTS}
    return outs, delta["tokens_generated"] / seconds, delta, eng


def phase_spec(card, model) -> dict:
    """Speculative decoding at GPT-2 small's width: the plain and the
    spec leg, token-identical; greedy spec decoding of two prompts against
    NaiveLM(width=1024), whose forwards run the flash kernel."""
    vocab = model.config.vocab_size
    rng = np.random.default_rng(0)
    lengths = rng.integers(*SPEC_PROMPT_LENS, size=SPEC_USERS)
    prompts = [[int(t) for t in rng.integers(0, vocab, size=int(n))]
               for n in lengths]
    draft = layerskip_draft(model)
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    plain_outs, plain_tps, plain, eng = spec_leg(model, prompts)
    eng.close()
    del eng
    spec_outs, spec_tps, spec, eng = spec_leg(model, prompts, draft)
    greedy = [eng.result(eng.submit(p, SPEC_NEW), timeout=600)
              for p in prompts[:2]]
    eng.close()
    launches = dict(attn.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del eng
    torch.cuda.empty_cache()
    zero_launches()
    naive = NaiveLM(model, width=1024)
    want = [naive.generate(p, SPEC_NEW) for p in prompts[:2]]
    oracle = dict(attn.LAUNCHES)
    steps = spec["spec_steps"]
    split = {part: spec["split"][part] / steps * 1e3 for part in SPEC_PARTS}
    step_ms = spec["decode_seconds"] / steps * 1e3
    sample_ms = split["draft_sample"] + split["verify_sample"]
    acceptance = spec["spec_accepted"] / spec["spec_proposed"]
    note("spec", plain_tokens_per_s=plain_tps, spec_tokens_per_s=spec_tps,
         acceptance=acceptance)
    log(f"[spec] {card} | GPT-2 small fp32, TF32 off, {SPEC_USERS} users, "
        f"prompts {int(lengths.min())}-{int(lengths.max())}, {SPEC_NEW} "
        f"new tokens at T=1.0: plain {plain_tps:.1f} tokens/s "
        f"({plain['steps']} steps, "
        f"{plain['decode_seconds'] / plain['steps'] * 1e3:.2f} ms/step; "
        f"{plain['prefills']} prefills, "
        f"{plain['prefill_seconds'] / plain['prefills'] * 1e3:.1f} ms each);"
        f" spec (k={SPEC_TOKENS}, LayerSkip draft, window {SPEC_WINDOW}) "
        f"{spec_tps:.1f} tokens/s ({spec_tps / plain_tps:.2f}x), acceptance "
        f"{acceptance:.3f}, {steps} spec steps of {step_ms:.2f} ms: draft "
        f"forwards {split['draft']:.2f}, draft sampling "
        f"{split['draft_sample']:.2f}, verify forward {split['verify']:.2f},"
        f" verify sampling {split['verify_sample']:.2f} (host sampling "
        f"{sample_ms / step_ms:.1%} of the step; the rest "
        f"{step_ms - sum(split.values()):.2f}); admissions (target and draft "
        f"prefill) {spec['prefill_seconds'] / spec['prefills'] * 1e3:.1f} ms"
        f" each; peak memory {peak:.2f} GiB")
    for i, (got, ref) in enumerate(zip(spec_outs, plain_outs)):
        if got != ref:
            j = next(j for j, (a, b) in enumerate(zip(got, ref)) if a != b)
            pos = len(prompts[i]) + j
            gap = perturbed_gap(model, prompts[i] + ref[:j], pos,
                                SPEC_SAMPLING.seed, ref[j], got[j])
            raise AssertionError(
                f"[spec] request {i} differs from the plain leg at token "
                f"{j} (position {pos}): {got[j]} vs {ref[j]}; the plain "
                f"token's perturbed logit leads by {gap:.3g} there")
    if greedy != want:
        raise AssertionError(f"[spec] greedy spec != NaiveLM: {greedy} vs "
                             f"{want}")
    if any(launches.values()):
        raise AssertionError(f"[spec] the engine launched {launches}")
    steps_naive = sum(len(w) for w in want)
    if oracle["flash_fwd"] != model.config.num_layers * steps_naive:
        raise AssertionError(f"[spec] NaiveLM launched {oracle} in "
                             f"{steps_naive} steps")
    log(f"[spec] {SPEC_USERS} spec outputs token-identical to the plain "
        f"leg's; greedy spec decoding of 2 prompts token-identical to "
        f"NaiveLM(width=1024); flash launches: engine legs {launches}, "
        f"oracle {oracle}")
    return {"spec": launches, "spec-oracle": oracle}


def time_methods(obj, names) -> collections.Counter:
    """Wrap the methods ``names`` of ``obj`` to add their host time,
    closed by a device sync, to the returned counter (seconds)."""
    spent = collections.Counter()

    def wrap(name, fn):
        def timed(*args, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            spent[name] += time.perf_counter() - t
            return out
        return timed

    for name in names:
        setattr(obj, name, wrap(name, getattr(obj, name)))
    return spent


PREFIX_PARTS = ("_lookup_prefix", "_adopt_pages", "_publish_prefix")


def prefix_leg(model, prompts, shared, cache) -> dict:
    """bench_serving_shared_prefix's leg: three warm-up requests, then
    every user on its own thread; latency from submit to result.  The
    timed window also splits the admissions: prefix lookup, adoption of
    the cached pages, and the snapshot of new pages."""
    eng = LLMEngine(model, prefix_cache=cache, **PREFIX_ENGINE)
    try:
        eng.result(eng.submit(prompts[0], PREFIX_NEW), timeout=600)
        eng.result(eng.submit(shared + [1] * 8, 2), timeout=600)
        eng.result(eng.submit(shared + [2] * 12, 2), timeout=600)
        outs, lat = [None] * len(prompts), [0.0] * len(prompts)

        def user(i):
            t = time.perf_counter()
            outs[i] = eng.result(eng.submit(prompts[i], PREFIX_NEW),
                                 timeout=600)
            lat[i] = time.perf_counter() - t

        st0 = eng.stats()
        parts = time_methods(eng, PREFIX_PARTS)
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(len(prompts)) as pool:
            for f in [pool.submit(user, i) for i in range(len(prompts))]:
                f.result()
        seconds = time.perf_counter() - t0
        st = eng.stats()
    finally:
        eng.close()
    lat.sort()
    return {"outs": outs,
            "tokens_per_s": (st["tokens_generated"]
                             - st0["tokens_generated"]) / seconds,
            "p50_ms": lat[len(lat) // 2] * 1e3,
            "p99_ms": lat[min(len(lat) - 1, int(len(lat) * 0.99))] * 1e3,
            "prefix_hit_pages": st["prefix_hit_pages"],
            "prefill_tokens": st["prefill_tokens"],
            "prefill_tokens_saved": st["prefill_tokens_saved"],
            "prefill_ms": (st["prefill_seconds"] - st0["prefill_seconds"])
            / len(prompts) * 1e3,
            "parts_ms": {name[1:]: parts[name] / len(prompts) * 1e3
                         for name in PREFIX_PARTS},
            "pages_in_use": st["pages_in_use"]}


def phase_prefix(card, model) -> dict:
    """The prefix cache at GPT-2 small's width: fp32 cache off / on,
    token-identical; bf16 (the bench's dtype) off / on, timed."""
    rng = np.random.default_rng(0)
    vocab = model.config.vocab_size
    shared = [int(t) for t in rng.integers(0, vocab, size=PREFIX_SHARED)]
    prompts = [shared + [int(t) for t in rng.integers(0, vocab, size=int(n))]
               for n in rng.integers(8, 17, size=PREFIX_USERS)]
    zero_launches()
    off = prefix_leg(model, prompts, shared, False)
    on = prefix_leg(model, prompts, shared, True)
    m16 = build_model("gpt2", dict(GPT2_SMALL_FP32, dtype=torch.bfloat16),
                      seed=SEED)
    off16 = prefix_leg(m16, prompts, shared, False)
    on16 = prefix_leg(m16, prompts, shared, True)
    launches = dict(attn.LAUNCHES)
    del m16
    torch.cuda.empty_cache()
    if on["outs"] != off["outs"]:
        i = next(i for i, (a, b) in enumerate(zip(on["outs"], off["outs"]))
                 if a != b)
        raise AssertionError(f"[prefix] fp32 cache-on != cache-off for user "
                             f"{i}: {on['outs'][i]} vs {off['outs'][i]}")
    for leg in (off, on, off16, on16):
        if leg["pages_in_use"]:
            raise AssertionError(f"[prefix] leaked pages: {leg}")
    if not on["prefix_hit_pages"] or not on16["prefix_hit_pages"]:
        raise AssertionError(f"[prefix] no cache hits: {on}, {on16}")
    if any(launches.values()):
        raise AssertionError(f"[prefix] the engine launched {launches}")
    hits = on16["prefix_hit_pages"]
    note("prefix", off_p50_ms=off16["p50_ms"], on_p50_ms=on16["p50_ms"],
         off_tokens_per_s=off16["tokens_per_s"],
         on_tokens_per_s=on16["tokens_per_s"])
    log(f"[prefix] {card} | {PREFIX_USERS} users, fp32: cache-on outputs "
        f"token-identical to cache-off ({on['prefix_hit_pages']} hit pages, "
        f"prefill {off['prefill_ms']:.1f} -> {on['prefill_ms']:.1f} ms per "
        f"admission); flash launches {launches}")
    log(f"[prefix] {card} | GPT-2 small bf16, {PREFIX_USERS} users, "
        f"{PREFIX_SHARED}-token shared prefix, tails 8-16, {PREFIX_NEW} new "
        f"tokens, max_slots {PREFIX_ENGINE['max_slots']}: cache off p50 "
        f"{off16['p50_ms']:.1f} ms, p99 {off16['p99_ms']:.1f} ms, "
        f"{off16['tokens_per_s']:.1f} tokens/s, prefill "
        f"{off16['prefill_ms']:.1f} ms per admission; cache on p50 "
        f"{on16['p50_ms']:.1f} ms, p99 {on16['p99_ms']:.1f} ms, "
        f"{on16['tokens_per_s']:.1f} tokens/s, prefill "
        f"{on16['prefill_ms']:.1f} ms per admission (of which, by part "
        f"with a sync each side: "
        f"{', '.join(f'{k} {v:.2f}' for k, v in on16['parts_ms'].items())}"
        f"); {hits} hit pages, hit "
        f"rate {hits / (hits + PREFIX_USERS):.3f} (hits over hits + users, "
        f"as the bench), prefill tokens saved "
        f"{on16['prefill_tokens_saved']} ({on16['prefill_tokens']} "
        f"prefilled against {off16['prefill_tokens']}); p50 speedup "
        f"{off16['p50_ms'] / on16['p50_ms']:.2f}x")
    return {"prefix": launches}


def disagg_leg(model, first, rest, worker=None, prefix_cache=True):
    """The first prompt alone (it publishes the shared prefix), then the
    rest at once."""
    eng = LLMEngine(model, prefix_cache=prefix_cache, prefill=worker,
                    prefill_min_tokens=DISAGG_MIN_TOKENS, **DISAGG_ENGINE)
    try:
        t0 = time.perf_counter()
        outs = [eng.result(eng.submit(first, DISAGG_NEW), timeout=600)]
        rids = [eng.submit(p, DISAGG_NEW) for p in rest]
        outs += [eng.result(r, timeout=600) for r in rids]
        seconds = time.perf_counter() - t0
        st = eng.stats()
    finally:
        eng.close()
    return outs, st, seconds


def phase_disagg(card, model) -> tuple:
    """In-process disaggregated prefill on the card, fp32: the native
    wire token-identical to inline prefill, the worker fed only uncached
    tails; the int8 wire >= 3x smaller than fp32, no page leaked.
    Returns the launches, and the prompts with the native leg's tokens
    (``[disagg-actor]`` holds its actor to them)."""
    rng = np.random.default_rng(2)
    vocab = model.config.vocab_size
    shared = [int(t) for t in rng.integers(0, vocab, size=DISAGG_SHARED)]
    sharing = [shared + [int(t) for t in rng.integers(0, vocab, size=int(n))]
               for n in rng.integers(40, 645, size=4)]
    alone = [[int(t) for t in rng.integers(0, vocab, size=int(n))]
             for n in rng.integers(64, 901, size=4)]
    first, rest = sharing[0], sharing[1:] + alone
    zero_launches()
    inline, ist, inline_s = disagg_leg(model, first, rest)
    worker = PrefillWorker("gpt2", GPT2_SMALL_FP32, SEED,
                           page_size=DISAGG_ENGINE["page_size"])
    native, nst, native_s = disagg_leg(model, first, rest, worker)
    wst = worker.stats()
    del worker
    worker8 = PrefillWorker("gpt2", GPT2_SMALL_FP32, SEED, wire_dtype="int8",
                            page_size=DISAGG_ENGINE["page_size"])
    int8, st8, int8_s = disagg_leg(model, first, rest, worker8,
                                   prefix_cache=False)
    w8 = worker8.stats()
    del worker8
    launches = dict(attn.LAUNCHES)
    torch.cuda.empty_cache()
    want_tokens = len(first) + sum(len(p) - DISAGG_SHARED
                                   for p in sharing[1:]) + sum(map(len, alone))
    lens = sorted(len(p) for p in sharing + alone)
    note("disagg", inline_s=inline_s, native_s=native_s,
         wire_bytes=nst["wire_bytes"])
    log(f"[disagg] {card} | GPT-2 small fp32, prompts {lens}, "
        f"{DISAGG_NEW} new tokens, prefill_min_tokens {DISAGG_MIN_TOKENS}: "
        f"inline {inline_s:.2f} s ({ist['prefills']} prefills, "
        f"{ist['prefill_seconds'] / ist['admitted'] * 1e3:.1f} ms per "
        f"admission); native wire {native_s:.2f} s ({nst['prefill_offloaded']}"
        f" offloaded, worker {wst['tokens']} tokens in {wst['requests']} "
        f"prefills of {wst['seconds'] / wst['requests'] * 1e3:.1f} ms, "
        f"engine {nst['prefill_seconds'] / nst['admitted'] * 1e3:.1f} ms per "
        f"admission, {nst['wire_bytes']} wire bytes, "
        f"{nst['prefix_hit_pages']} prefix hit pages); int8 wire "
        f"{int8_s:.2f} s ({st8['wire_bytes']} wire bytes against "
        f"{st8['wire_fp32_bytes']} fp32: {st8['wire_fp32_bytes'] / st8['wire_bytes']:.2f}x"
        f" smaller; worker {w8['seconds'] / w8['requests'] * 1e3:.1f} ms a "
        f"prefill); flash launches {launches}")
    if native != inline:
        raise AssertionError(f"[disagg] native wire != inline: {native} vs "
                             f"{inline}")
    if wst["tokens"] != want_tokens or nst["prefill_offloaded"] != 8:
        raise AssertionError(f"[disagg] the worker saw {wst} (want "
                             f"{want_tokens} tokens), engine {nst}")
    if st8["wire_fp32_bytes"] < 3.0 * st8["wire_bytes"]:
        raise AssertionError(f"[disagg] int8 wire not 3x smaller: {st8}")
    if any(len(o) != DISAGG_NEW for o in int8):
        raise AssertionError(f"[disagg] int8 outputs {int8}")
    for st in (ist, nst, st8):
        if st["pages_in_use"] or st["prefill_inflight"]:
            raise AssertionError(f"[disagg] leaked: {st}")
    if any(launches.values()):
        raise AssertionError(f"[disagg] the engine launched {launches}")
    log(f"[disagg] native wire token-identical to inline prefill; the "
        f"worker saw only uncached tails ({want_tokens} tokens); no page "
        f"leaked")
    return {"disagg": launches}, (first, rest, native)


class VersionedCache(PrefixCacheLocal):
    """The engine's prefix cache, recording the weight version each page
    was published under and each hit's: a hit on a page of another
    version is a pre-swap page adopted after the swap.  ``version`` is set
    to read the engine's (both run on the engine's loop thread)."""

    def __init__(self):
        super().__init__()
        self.version = None
        self.published = {}
        self.hits_by_version = collections.Counter()
        self.stale = 0

    def put(self, key, k, v):
        self.published[key] = self.version()
        super().put(key, k, v)

    def get(self, key):
        entry = super().get(key)
        if entry is not None:
            self.hits_by_version[self.version()] += 1
            self.stale += self.published[key] != self.version()
        return entry


def phase_swap(card, model) -> dict:
    """generate_rollouts of 8 prompts with swap_weights to perturbed
    weights mid-flight, fp32: every token stamped, none dropped, each
    logprob equal to a full-context forward of the version that stamped
    it; pre-swap prefix pages never adopted after the swap.  Swaps the
    weights of ``model`` (the last phase to use it)."""
    rng = np.random.default_rng(3)
    vocab = model.config.vocab_size
    shared = [int(t) for t in rng.integers(0, vocab, size=SWAP_SHARED)]
    prompts = [shared + [int(t) for t in rng.integers(0, vocab, size=int(n))]
               for n in rng.integers(8, 41, size=SWAP_PROMPTS)]
    sampling = [SamplingParams(temperature=1.0, seed=i)
                for i in range(SWAP_PROMPTS)]
    v0 = copy.deepcopy(model)
    gen = torch.Generator().manual_seed(SEED + 1)
    v1_state = {name: t.cpu() + SWAP_NOISE * torch.randn(t.shape,
                                                         generator=gen)
                for name, t in model.state_dict().items()}
    cache = VersionedCache()
    eng = LLMEngine(model, max_slots=SWAP_PROMPTS, page_size=16,
                    max_ctx=1024, prefix_cache=cache)
    cache.version = lambda: eng.weight_version
    zero_launches()
    try:
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            fut = pool.submit(eng.generate_rollouts, prompts, SWAP_NEW,
                              None, sampling)
            while eng.stats()["tokens_generated"] < SWAP_PROMPTS and \
                    not fut.done():
                time.sleep(0.001)
            eng.swap_weights(v1_state, 1, timeout=60)
            rolls = fut.result()
        st = eng.stats()
    finally:
        eng.close()
    launches = dict(attn.LAUNCHES)
    mixed = sum(0 in r["versions"] and 1 in r["versions"] for r in rolls)
    worst = 0.0
    for r in rolls:
        vs = r["versions"]
        if len(r["tokens"]) != SWAP_NEW or vs != sorted(vs) or \
                set(vs) - {0, 1}:
            raise AssertionError(f"[swap] rollout {r}")
        seq = torch.tensor([r["prompt"] + r["tokens"]],
                           device=model.wte.device)
        p = len(r["prompt"])
        with torch.no_grad():
            lp = {v: torch.log_softmax(m(seq)[0], -1)
                  for v, m in ((0, v0), (1, model))}
        ref = np.array([float(lp[v][p - 1 + i, t])
                        for i, (t, v) in enumerate(zip(r["tokens"], vs))])
        got = np.array(r["logprobs"])
        worst = max(worst, float(np.max(np.abs(got - ref) / np.abs(ref))))
        np.testing.assert_allclose(got, ref, rtol=LOGP_RTOL, atol=LOGP_ATOL)
    del v0
    torch.cuda.empty_cache()
    note("swap", swap_ms=st["swap_latency_s_avg"] * 1e3,
         worst_logprob_rel=worst)
    log(f"[swap] {card} | GPT-2 small fp32, {SWAP_PROMPTS} rollouts of "
        f"{SWAP_NEW} sampled tokens: swap to version 1 in "
        f"{st['swap_latency_s_avg'] * 1e3:.1f} ms, "
        f"{st['swap_reprefills']} reprefills, {mixed} rollouts straddle the "
        f"swap; prefix hits by version {dict(cache.hits_by_version)}, stale "
        f"{cache.stale}; logprobs vs a full-context forward of the "
        f"stamping version: worst relative error {worst:.2e} (rtol "
        f"{LOGP_RTOL}); flash launches {launches}")
    if st["swaps"] != 1 or not mixed or st["completed"] < SWAP_PROMPTS:
        raise AssertionError(f"[swap] not mid-flight: {st}")
    if cache.stale or not cache.hits_by_version[1]:
        raise AssertionError(f"[swap] prefix hits by version "
                             f"{dict(cache.hits_by_version)}, "
                             f"{cache.stale} of a page published under "
                             f"another version")
    if st["pages_in_use"]:
        raise AssertionError(f"[swap] leaked pages: {st}")
    if any(launches.values()):
        raise AssertionError(f"[swap] the engine launched {launches}")
    log("[swap] every token stamped with its version, no rollout dropped, "
        "pre-swap prefix pages never adopted after the swap")
    return {"swap": launches}


# ---------------------------------------------------------------------------
# The task/actor/object runtime with GPU workers: [runtime], [disagg-actor],
# [swap-ref], [actor-train]
# ---------------------------------------------------------------------------
RUNTIME_CPUS = 4
GET_S = 600  # seconds: the bound of every get of these phases
PLACE_WAIT_S = 5.0  # how long a second GPU actor is watched not to start
# [disagg-actor]: bench_serving_disagg (bench.py:818-966) at GPT-2 small
# fp32: 8 short users (12-token prompts, 24 new tokens) arriving 0.5 s
# behind a burst of 14 long prompts (440-488 tokens, 8 new), greedy; 16
# slots, pages of 16, max_ctx 512, prefill_min_tokens 64, chunk_tokens 1;
# occupancy sampled every 20 ms of wall time.
BENCH_SHORTS, BENCH_LONGS, BENCH_SHORT_LEN = 8, 14, 12
BENCH_LONG_LENS, BENCH_SHORT_NEW, BENCH_LONG_NEW = (440, 489), 24, 8
BENCH_ENGINE = {"max_slots": 16, "page_size": 16, "max_ctx": 512,
                "prefill_min_tokens": 64, "chunk_tokens": 1}
# [swap-ref]: 4 greedy requests of 16 tokens before and after a swap to a
# state dict of another seed, put by a GPU actor.
SWAP_REF_SEED, SWAP_REF_PROMPTS, SWAP_REF_NEW = SEED + 7, 4, 16
# [actor-train]: [train]'s first shape in a num_gpus=1 actor.  The losses
# must equal [train]'s bit for bit: same seed, ids, kernels (the bf16 dq
# is deterministic) and cuBLAS on the same card.
ACTOR_LOSS_ATOL = 0.0


def jax_modules() -> list:
    return sorted(m for m in sys.modules
                  if m in ("jax", "ray_tpu") or m.startswith("ray_tpu."))


def cpu_task_view() -> tuple:
    """Run as a task without GPUs: what it sees of the card."""
    try:
        ray_tpu_torch.resolve_device()
        err = None
    except RuntimeError as e:
        err = str(e)
    return os.environ.get("CUDA_VISIBLE_DEVICES"), err, jax_modules()


class GPUActor:
    """A ``num_gpus=1`` actor: what its worker sees, and a GPT-2 small
    state dict put from its card."""

    def seen(self) -> dict:
        return {"visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                "name": torch.cuda.get_device_name(0),
                "count": torch.cuda.device_count(), "jax": jax_modules()}

    def put_state(self, config_kw, seed, dtype=None) -> tuple:
        """The state dict of build_model(config_kw, seed) (cast to
        ``dtype`` if given), its tensors on the card, put by this worker:
        ([ref], seconds of the put)."""
        state = model_state(config_kw, seed, dtype)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = ray_tpu_torch.put(state)
        return [ref], time.perf_counter() - t0


class TrainActor:
    """A ``num_gpus=1`` actor that runs ``train_steps`` with [train]'s
    settings (TF32 off for matmuls; GPT-2 runs no convolution) on the
    kernels the driver built.  It sets the precision through
    ``set_float32_matmul_precision`` ("highest" is ``allow_tf32 =
    False``): cloudpickle ships this class by value when the script is
    ``__main__``, and cannot pickle the module objects of
    ``torch.backends`` that a method naming them would carry."""

    def __init__(self):
        torch.set_float32_matmul_precision("highest")

    def setup(self) -> dict:
        for name in _build.SIGNATURES:
            _build.load(name)
        return worker_setup()

    def train(self, b, length, iters) -> dict:
        return train_steps(b, length, iters)


def worker_setup() -> dict:
    """What a GPU worker sees: its card, the kernel libraries it loaded,
    its CUDA runtimes, and any module of the JAX package."""
    with open("/proc/self/maps") as maps:
        libs = sorted({line.split()[-1] for line in maps
                       if "/_build/lib" in line})
    return {"visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "libs": libs, "cudart": cudart_libs(), "jax": jax_modules()}


def check_worker_setup(tag, setup, shared=False) -> None:
    """The worker saw the card as device 0 (its own partition; a worker
    holding a share of the card keeps this process's view), loaded every
    kernel from the driver's build directory against one CUDA runtime,
    and no module of the JAX package."""
    build_dir = str(_build.BUILD_DIR)
    visible = os.environ.get("CUDA_VISIBLE_DEVICES") if shared else "0"
    if setup["visible"] != visible or setup["jax"] or \
            len(setup["libs"]) != \
            len(_build.SIGNATURES) or not all(
                lib.startswith(build_dir) for lib in setup["libs"]) or \
            len(setup["cudart"]) != 1:
        raise AssertionError(f"{tag} worker setup {setup}")


def model_state(config_kw, seed, dtype=None) -> dict:
    """GPT-2's state dict (fp32 parameters, as flax keeps them), on the
    card, cast to ``dtype`` if given."""
    state = build_model("gpt2", config_kw, seed=seed).state_dict()
    return {k: t if dtype is None else t.to(dtype) for k, t in state.items()}


def state_bytes(state) -> int:
    return sum(t.numel() * t.element_size() for t in state.values())


def same_bits(a, b) -> bool:
    return (a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8)))


def phase_runtime(card) -> None:
    """The runtime on this machine: the card is its one GPU; a task
    without GPUs sees none and cannot resolve CUDA; a GPU actor sees the
    card; a second waits until the first is killed; GPT-2 small's bf16
    state dict comes from the GPU actor to the driver bit for bit."""
    from ray_tpu_torch._native import available as native_built
    from ray_tpu_torch._private.config import CONFIG

    get = ray_tpu_torch.get
    res = ray_tpu_torch.cluster_resources()
    if res.get("GPU") != 1.0 or res.get("CPU") != RUNTIME_CPUS:
        raise AssertionError(f"[runtime] cluster resources {res}")
    visible, err, jax = get(ray_tpu_torch.remote(cpu_task_view).remote(),
                            timeout=GET_S)
    if visible != "" or err is None or jax:
        raise AssertionError(f"[runtime] a task without GPUs saw "
                             f"CUDA_VISIBLE_DEVICES={visible!r}, "
                             f"resolve_device() error {err!r}, {jax}")
    actor_cls = ray_tpu_torch.remote(num_gpus=1)(GPUActor)
    name = card.split(",")[0].strip()
    t0 = time.perf_counter()
    first = actor_cls.remote()
    seen = get(first.seen.remote(), timeout=GET_S)
    cold_s = time.perf_counter() - t0
    want = {"visible": "0", "name": name, "count": 1, "jax": []}
    if seen != want:
        raise AssertionError(f"[runtime] the GPU actor saw {seen}, "
                             f"expected {want}")
    second = actor_cls.remote()
    pending = second.seen.remote()
    ready, _ = ray_tpu_torch.wait([pending], timeout=PLACE_WAIT_S)
    if ready:
        raise AssertionError("[runtime] a second num_gpus=1 actor started "
                             "while the first held the card")
    t0 = time.perf_counter()
    ray_tpu_torch.kill(first)
    seen2 = get(pending, timeout=GET_S)
    handover_s = time.perf_counter() - t0
    if seen2 != want:
        raise AssertionError(f"[runtime] the second GPU actor saw {seen2}")
    (ref,), put_s = get(second.put_state.remote(
        GPT2_SMALL_FP32, SEED, torch.bfloat16), timeout=GET_S)
    t0 = time.perf_counter()
    got = get(ref, timeout=GET_S)
    get_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    on_card = {k: t.to("cuda") for k, t in got.items()}
    torch.cuda.synchronize()
    h2d_s = time.perf_counter() - t0
    ray_tpu_torch.kill(second)
    want_state = model_state(GPT2_SMALL_FP32, SEED, torch.bfloat16)
    nbytes = state_bytes(got)
    wrong = [k for k in want_state
             if got[k].device.type != "cpu"
             or not same_bits(got[k], want_state[k].cpu())]
    if set(got) != set(want_state) or wrong:
        raise AssertionError(f"[runtime] the state dict differs: {wrong}")
    store = ("the native arena" if CONFIG.native_store
             else "per-object shared-memory segments (Python)")
    note("runtime", cold_s=cold_s, put_gb_s=nbytes / put_s / 1e9,
         get_gb_s=nbytes / get_s / 1e9, to_card_gb_s=nbytes / h2d_s / 1e9)
    log(f"[runtime] {card} | init(num_cpus={RUNTIME_CPUS}): {res}; a task "
        f"without GPUs sees CUDA_VISIBLE_DEVICES='' and resolve_device() "
        f"raises; a num_gpus=1 actor sees '0' = {seen['name']}, its cold "
        f"start (spawn, imports, CUDA context) {cold_s:.2f} s; a second "
        f"waited {PLACE_WAIT_S:.0f} s unplaced and started "
        f"{handover_s:.2f} s after the first was killed; no module of the "
        f"JAX package in either worker")
    log(f"[runtime] {card} | GPT-2 small bf16 state dict, {len(got)} "
        f"tensors, {nbytes} bytes, from the GPU actor: put {put_s:.3f} s "
        f"({nbytes / put_s / 1e9:.2f} GB/s, card to host included), get "
        f"{get_s:.4f} s ({nbytes / get_s / 1e9:.2f} GB/s, zero-copy), to "
        f"the driver's card {h2d_s:.3f} s ({nbytes / h2d_s / 1e9:.2f} "
        f"GB/s); bitwise equal to the driver's build; store: {store} "
        f"(native arena built: {native_built()})")
    del got, on_card, want_state
    torch.cuda.empty_cache()


def bench_disagg_leg(model, shorts, longs, worker=None) -> tuple:
    """One leg of bench_serving_disagg (bench.py:858-956): warm both
    sides, then the long burst with the short users 0.5 s behind it.
    Returns (tokens of every request, readings, stats)."""
    eng = LLMEngine(model, prefill=worker, **BENCH_ENGINE)
    try:
        eng.result(eng.submit(shorts[0], 2), timeout=GET_S)
        eng.result(eng.submit(longs[0], 2), timeout=GET_S)
        occ, stop = [], threading.Event()

        def sampler():
            while not stop.is_set():
                occ.append(int(eng._active.sum()))
                time.sleep(0.02)

        ttft, lat, short_out, long_rids = [], [], {}, []
        lock = threading.Lock()

        def short_user(i):
            time.sleep(0.5)
            t = time.perf_counter()
            rid = eng.submit(shorts[i], BENCH_SHORT_NEW)
            first, toks = None, []
            for chunk in eng.stream(rid, timeout=GET_S):
                if first is None:
                    first = time.perf_counter() - t
                toks += chunk
            with lock:
                ttft.append(first)
                lat.append(time.perf_counter() - t)
                short_out[i] = toks

        def long_feeder():
            for prompt in longs:
                long_rids.append(eng.submit(prompt, BENCH_LONG_NEW))

        threading.Thread(target=sampler, daemon=True).start()
        threads = [threading.Thread(target=short_user, args=(i,))
                   for i in range(len(shorts))]
        threads.append(threading.Thread(target=long_feeder))
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        long_out = [eng.result(r, timeout=GET_S) for r in long_rids]
        deadline = time.time() + GET_S
        while eng.stats()["pages_in_use"] and time.time() < deadline:
            time.sleep(0.05)
        seconds = time.perf_counter() - t0
        stop.set()
        st = eng.stats()
    finally:
        eng.close()
    ttft.sort()
    lat.sort()
    readings = {
        "occupancy": sum(occ) / max(1, len(occ)) / BENCH_ENGINE["max_slots"],
        "ttft_p50_ms": ttft[len(ttft) // 2] * 1e3,
        "ttft_p99_ms": ttft[-1] * 1e3, "p50_ms": lat[len(lat) // 2] * 1e3,
        "p99_ms": lat[-1] * 1e3,
        "tokens_per_s": st["tokens_generated"] / seconds,
        "steps_per_s": st["steps"] / seconds,
        "offloaded": st["prefill_offloaded"]}
    return [short_out[i] for i in range(len(shorts))] + long_out, \
        readings, st


def phase_disagg_actor(card, model, disagg_native) -> dict:
    """bench_serving_disagg's two legs at GPT-2 small fp32, the engine in
    the driver and the PrefillWorker a num_gpus=1 actor on the same card:
    colocated (inline prefill), then the actor with the native wire, with
    the object plane off and on.  Each actor leg's tokens equal the
    colocated leg's, and on [disagg]'s prompts the in-process native
    leg's; no page leaks."""
    first, rest, native = disagg_native
    rng = np.random.default_rng(0)
    vocab = model.config.vocab_size
    shorts = [[int(t) for t in rng.integers(0, vocab, size=BENCH_SHORT_LEN)]
              for _ in range(BENCH_SHORTS)]
    longs = [[int(t) for t in rng.integers(0, vocab, size=int(n))]
             for n in rng.integers(*BENCH_LONG_LENS, size=BENCH_LONGS)]
    zero_launches()
    colocated, co, co_st = bench_disagg_leg(model, shorts, longs)
    legs = {"colocated": co}
    actor_cls = ray_tpu_torch.remote(num_gpus=1)(PrefillWorker)
    for plane in (False, True):
        tag = f"actor, object plane {'on' if plane else 'off'}"
        t0 = time.perf_counter()
        worker = actor_cls.remote("gpt2", GPT2_SMALL_FP32, SEED,
                                  page_size=BENCH_ENGINE["page_size"],
                                  use_object_plane=plane)
        warm = ray_tpu_torch.get(worker.prefill.remote(longs[0], 0),
                                 timeout=GET_S)
        cold_s = time.perf_counter() - t0
        if ("refs" in warm) != plane:
            raise AssertionError(f"[disagg-actor] {tag}: payload keys "
                                 f"{sorted(warm)}")
        toks, legs[tag], st = bench_disagg_leg(model, shorts, longs, worker)
        outs, dst, _ = disagg_leg(model, first, rest, worker)
        wst = ray_tpu_torch.get(worker.stats.remote(), timeout=GET_S)
        ray_tpu_torch.kill(worker)
        legs[tag]["cold_s"] = cold_s
        legs[tag]["worker_ms"] = wst["seconds"] / wst["requests"] * 1e3
        if toks != colocated:
            diff = [i for i, (a, b) in enumerate(zip(toks, colocated))
                    if a != b]
            raise AssertionError(f"[disagg-actor] {tag}: requests {diff} "
                                 f"differ from the colocated leg")
        if outs != native:
            raise AssertionError(f"[disagg-actor] {tag}: [disagg]'s "
                                 f"prompts give {outs}, the in-process "
                                 f"native leg {native}")
        if st["prefill_offloaded"] < BENCH_LONGS or \
                dst["prefill_offloaded"] != 1 + len(rest):
            raise AssertionError(f"[disagg-actor] {tag}: offloaded "
                                 f"{st['prefill_offloaded']}, "
                                 f"{dst['prefill_offloaded']}")
        for s in (st, dst):
            if s["pages_in_use"] or s["prefill_inflight"]:
                raise AssertionError(f"[disagg-actor] {tag}: leaked {s}")
    if co_st["pages_in_use"]:
        raise AssertionError(f"[disagg-actor] colocated leaked {co_st}")
    launches = dict(attn.LAUNCHES)
    if any(launches.values()):
        raise AssertionError(f"[disagg-actor] the engine launched "
                             f"{launches}")
    for tag, r in legs.items():
        extra = (f", actor cold start {r['cold_s']:.2f} s, "
                 f"{r['worker_ms']:.1f} ms a prefill in the actor"
                 if "cold_s" in r else "")
        log(f"[disagg-actor] {card} | {tag}: occupancy "
            f"{r['occupancy']:.3f}, short TTFT p50 {r['ttft_p50_ms']:.1f} "
            f"ms p99 {r['ttft_p99_ms']:.1f} ms, short latency p50 "
            f"{r['p50_ms']:.1f} ms p99 {r['p99_ms']:.1f} ms, "
            f"{r['tokens_per_s']:.1f} tokens/s, {r['steps_per_s']:.1f} "
            f"steps/s, {r['offloaded']} offloaded{extra}")
    note("disagg-actor", **{f"{tag.split(',')[-1].strip()} tokens_per_s":
                            r["tokens_per_s"] for tag, r in legs.items()})
    log(f"[disagg-actor] GPT-2 small fp32, {BENCH_SHORTS} short + "
        f"{BENCH_LONGS} long requests, greedy: both actor legs "
        f"token-identical to the colocated leg, and on [disagg]'s prompts "
        f"to its in-process native leg; no page leaked; flash launches "
        f"{launches}")
    return {"disagg-actor": launches}


def phase_swap_ref(card, model) -> dict:
    """swap_weights(ref): a GPU actor puts the state dict of another seed;
    the engine in the driver swaps to the ref, and its greedy tokens then
    equal those of an engine built with that seed."""
    rng = np.random.default_rng(4)
    vocab = model.config.vocab_size
    prompts = [[int(t) for t in rng.integers(0, vocab, size=int(n))]
               for n in rng.integers(64, 201, size=SWAP_REF_PROMPTS)]
    kw = {"max_slots": SWAP_REF_PROMPTS, "page_size": 16, "max_ctx": 1024}
    publisher = ray_tpu_torch.remote(num_gpus=1)(GPUActor).remote()
    (ref,), put_s = ray_tpu_torch.get(
        publisher.put_state.remote(GPT2_SMALL_FP32, SWAP_REF_SEED),
        timeout=GET_S)

    def greedy(eng):
        rids = [eng.submit(p, SWAP_REF_NEW) for p in prompts]
        return [eng.result(r, timeout=GET_S) for r in rids]

    zero_launches()
    eng = LLMEngine(copy.deepcopy(model), **kw)
    try:
        before = greedy(eng)
        eng.swap_weights(ref, 1, timeout=GET_S)
        after = greedy(eng)
        st = eng.stats()
    finally:
        eng.close()
    ray_tpu_torch.kill(publisher)
    fresh = LLMEngine(build_model("gpt2", GPT2_SMALL_FP32,
                                  seed=SWAP_REF_SEED), **kw)
    try:
        want = greedy(fresh)
    finally:
        fresh.close()
    launches = dict(attn.LAUNCHES)
    torch.cuda.empty_cache()
    note("swap-ref", put_s=put_s, swap_ms=st["swap_latency_s_avg"] * 1e3)
    log(f"[swap-ref] {card} | GPT-2 small fp32 state dict of seed "
        f"{SWAP_REF_SEED} put by a GPU actor in {put_s:.3f} s; "
        f"swap_weights(ref) applied in {st['swap_latency_s_avg'] * 1e3:.1f} "
        f"ms (the get and the copy to the card included); {len(prompts)} "
        f"greedy requests of {SWAP_REF_NEW} tokens; flash launches "
        f"{launches}")
    if after != want:
        raise AssertionError(f"[swap-ref] tokens after the swap {after} != "
                             f"an engine built with seed {SWAP_REF_SEED}: "
                             f"{want}")
    if after == before:
        raise AssertionError("[swap-ref] the swap changed no token")
    if st["swaps"] != 1 or st["weight_version"] != 1 or st["pages_in_use"]:
        raise AssertionError(f"[swap-ref] stats {st}")
    if any(launches.values()):
        raise AssertionError(f"[swap-ref] the engine launched {launches}")
    log("[swap-ref] greedy tokens after swap_weights(ref) equal an engine "
        "built with those weights")
    return {"swap-ref": launches}


def phase_actor_train(card, train) -> dict:
    """[train]'s first shape in a num_gpus=1 actor: the worker loads the
    kernels the driver built, launches each 12 times a step, and its
    losses equal the in-process ones.  Returns its launches."""
    b, length, iters = TRAIN_SHAPES[0]
    tag = f"B={b} S={length}"
    t0 = time.perf_counter()
    actor = ray_tpu_torch.remote(num_gpus=1)(TrainActor).remote()
    setup = ray_tpu_torch.get(actor.setup.remote(), timeout=GET_S)
    cold_s = time.perf_counter() - t0
    run = ray_tpu_torch.get(actor.train.remote(b, length, iters),
                            timeout=GET_S)
    ray_tpu_torch.kill(actor)
    check_worker_setup("[actor-train]", setup)
    tokens_per_s, mfu, _ = check_train(f"[actor-train] {tag}", run, b,
                                       length, iters)
    local = train[tag]
    diff = max(abs(x - y) for x, y in zip(run["losses"], local["losses"]))
    log(f"[actor-train] {card} | GPT-2 small {tag} in a num_gpus=1 actor "
        f"(cold start {cold_s:.2f} s; kernels {setup['libs']}): "
        f"{run['seconds'] / iters * 1e3:.1f} ms/step in the actor against "
        f"{local['seconds'] / iters * 1e3:.1f} in the process, "
        f"{tokens_per_s:.0f} tokens/s, MFU {mfu:.4f}; loss "
        f"{' '.join(f'{x:.4f}' for x in run['losses'])}; max |loss - "
        f"[train]'s| {diff:.3g} (bitwise {run['losses'] == local['losses']}"
        f", bound {ACTOR_LOSS_ATOL}); launches {run['launches']}; peak "
        f"memory {run['peak_gib']:.1f} GiB")
    note("actor-train", ms_per_step=run["seconds"] / iters * 1e3,
         tokens_per_s=tokens_per_s, mfu=mfu, cold_s=cold_s,
         bitwise=run["losses"] == local["losses"])
    if not diff <= ACTOR_LOSS_ATOL:
        raise AssertionError(f"[actor-train] losses {run['losses']} vs "
                             f"[train]'s {local['losses']}")
    return {f"actor-train {tag}": run["launches"]}, (tokens_per_s, mfu)


# [trainer]: bench_gpt2 (bench.py:186-215, :263-270) through TorchTrainer:
# int32 tokens from default_rng(0), B * (iters + 2) rows (warm-up, timed
# steps, one spare) in 8 blocks, one worker with one GPU: at 1k through
# from_numpy(parallelism=8), at 4k written as 8 .npy shards of the same
# rows and read back through read_numpy and a BatchMapper (the same rows
# in the same order).  At 1k the worker's losses must equal the same
# steps in this process on the same batches bit for bit, as
# [actor-train]'s equal [train]'s.
TRAINER_FITS = ((16, 1024, 20), (4, 4096, 10))  # (B, S, timed steps)
TRAINER_LOSS_ATOL = 0.0
TRAINER_BLOCKS = 8


def trainer_tokens(b, length, iters) -> np.ndarray:
    return np.random.default_rng(0).integers(
        0, 50257, size=(b * (iters + 2), length), dtype=np.int32)


def write_shards(root, rows, n) -> list:
    """``rows`` as ``n`` .npy files, split where from_numpy(parallelism=n)
    splits them; the paths in row order."""
    bounds = np.linspace(0, len(rows), n + 1, dtype=int)
    paths = []
    for i, (a, b) in enumerate(zip(bounds, bounds[1:])):
        paths.append(os.path.join(root, f"rows-{i:05d}.npy"))
        np.save(paths[-1], rows[a:b])
    return paths


def as_tokens(batch):
    """read_numpy's ``data`` column as the step's ``tokens``."""
    return {"tokens": batch["data"]}


def trainer_dataset(tokens, length, root):
    if length == 1024:
        return rdata.from_numpy({"tokens": tokens},
                                parallelism=TRAINER_BLOCKS)
    paths = write_shards(root, tokens, TRAINER_BLOCKS)
    return rdata.BatchMapper(as_tokens).transform(rdata.read_numpy(paths))


def process_start() -> float:
    """This process's start on the wall clock (Linux: now, less the
    seconds since boot, /proc/uptime, less its start in clock ticks after
    boot, /proc/self/stat field 22)."""
    with open("/proc/self/stat") as f:
        ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))


def trainer_loop(config):
    """bench.py's gpt2_train_loop (:56-176, the non-ZeRO branch) in the
    port, run by TorchTrainer's worker: the batches come from the dataset
    shard through iter_device_batches (pinned memory, a side stream), the
    steps are ``train_steps``'.  Reports the bench's keys and what the
    driver's checks read, the worker's process start among them.  With
    ``config["zero"]`` the step is bench.py's ZeRO branch
    (``compile_zero_step``) and one more step is profiled by
    ``ZERO_STEP_GROUPS``."""
    started = time.time()
    from ray_tpu_torch.air import session

    torch.set_float32_matmul_precision("highest")
    b, length, iters = config["batch"], config["seq"], config["iters"]
    stream = session.get_dataset_shard("train").iter_device_batches(b)
    zero = config.get("zero")
    run = train_steps(b, length, iters,
                      batches=(batch["tokens"] for batch in stream),
                      zero=zero, groups=ZERO_STEP_GROUPS if zero else None)
    stream.close()
    tokens_per_s, mfu, _ = train_rates(run, b, length, iters)
    ended = time.time()
    session.report({
        "tokens_per_s": round(tokens_per_s), "mfu": round(mfu, 4),
        "loss": run["losses"][-1],
        "device_kind": torch.cuda.get_device_name(0),
        "n_params": run["n_params"], "streaming_ingest": True,
        "run": run, "spawned": process_start(), "started": started,
        "ended": ended,
        "peak_occupancy": stream.peak_occupancy, "setup": worker_setup()})


def phase_trainer(card, train, actor_rates) -> dict:
    """bench_gpt2's two fits through TorchTrainer on the port's Data
    ingest: the worker launches each kernel 12 times a step from the
    driver's build, its losses pass [train]'s checks, and at 1k they equal
    this process's steps on the same batches bit for bit.  Returns the
    fits' launches and their runs."""
    import tempfile

    out, runs = {}, {}
    for b, length, iters in TRAINER_FITS:
        tag = f"B={b} S={length}"
        tokens = trainer_tokens(b, length, iters)
        t0 = time.time()
        with tempfile.TemporaryDirectory() as root:
            result = TorchTrainer(
                trainer_loop,
                train_loop_config={"batch": b, "seq": length,
                                   "iters": iters},
                datasets={"train": trainer_dataset(tokens, length, root)},
                scaling_config=ScalingConfig(num_workers=1,
                                             use_gpu=True)).fit()
        t_end = time.time()
        fit_s = t_end - t0
        if result.error is not None:
            raise AssertionError(f"[trainer] {tag}: {result.error}")
        m = result.metrics
        run = m["run"]
        check_worker_setup(f"[trainer] {tag}", m["setup"])
        tokens_per_s, mfu, _ = check_train(f"[trainer] {tag}", run, b,
                                           length, iters)
        # The worker's cold start (fit to the loop's first line), split
        # at its process's start: placement and spawn before it; imports,
        # the process group, the split and the dispatch after it.
        cold_s = m["started"] - t0
        numbers = {"tokens_per_s": tokens_per_s, "mfu": mfu,
                   "ms_per_step": run["seconds"] / iters * 1e3,
                   "cold_s": cold_s, "to_spawn_s": m["spawned"] - t0,
                   "in_worker_s": m["started"] - m["spawned"],
                   "build_s": run["build_s"], "warm_s": run["warm_s"],
                   "after_loop_s": t_end - m["ended"],
                   "fit_s": fit_s, "peak_occupancy": m["peak_occupancy"]}
        local = train[tag]
        source = ("from_numpy" if length == 1024 else
                  f"{TRAINER_BLOCKS} .npy shards -> read_numpy -> "
                  "BatchMapper")
        line = (f"[trainer] {card} | GPT-2 small {tag} through TorchTrainer "
                f"(one worker, one GPU; int32 tokens through {source} -> "
                f"iter_device_batches): {iters} steps {run['seconds']:.3f} s "
                f"= {numbers['ms_per_step']:.1f} ms/step, {tokens_per_s:.0f} "
                f"tokens/s, MFU {mfu:.4f} (reported {m['tokens_per_s']} "
                f"tokens/s, MFU {m['mfu']}, on {m['device_kind']}); [train]"
                f" {local['seconds'] / local['iters'] * 1e3:.1f} ms/step, "
                f"{train_rates(local, b, length, local['iters'])[0]:.0f} "
                f"tokens/s")
        if length == 1024:
            line += (f"; [actor-train] {actor_rates[0]:.0f} tokens/s, MFU "
                     f"{actor_rates[1]:.4f}")
            batches = (torch.from_numpy(tokens[i * b:(i + 1) * b]).to("cuda")
                       for i in range(iters + 1))
            here = train_steps(b, length, iters, batches=batches)
            diff = max(abs(x - y) for x, y in zip(run["losses"],
                                                  here["losses"]))
            numbers["bitwise"] = run["losses"] == here["losses"]
            line += (f"; max |loss - this process's on the same batches| "
                     f"{diff:.3g} (bitwise {numbers['bitwise']}, bound "
                     f"{TRAINER_LOSS_ATOL})")
            if not diff <= TRAINER_LOSS_ATOL:
                raise AssertionError(f"[trainer] {tag}: losses "
                                     f"{run['losses']} vs {here['losses']}")
        note(f"trainer {tag}", **numbers)
        log(line + f"; worker cold start (fit to loop) {cold_s:.2f} s: "
            f"{numbers['to_spawn_s']:.2f} s to the worker process's start "
            f"(placement, spawn), {numbers['in_worker_s']:.2f} s in it "
            f"before the loop (imports, the process group, the split, the "
            f"dispatch); in the loop, the model's build {run['build_s']:.2f}"
            f" s and the warm-up step {run['warm_s']:.2f} s ([train]'s "
            f"{local['build_s']:.2f} and {local['warm_s']:.2f} s); from the "
            f"report to fit's return {numbers['after_loop_s']:.2f} s; fit "
            f"{fit_s:.1f} s; prefetch peak occupancy "
            f"{m['peak_occupancy']}; loss "
            f"{' '.join(f'{x:.4f}' for x in run['losses'])}; launches "
            f"{run['launches']}; peak memory {run['peak_gib']:.1f} GiB")
        out[f"trainer {tag}"] = run["launches"]
        runs[tag] = run
    return out, runs


# ---------------------------------------------------------------------------
# [data]: the rest of Data on the card's machine (in the shared cluster)
# ---------------------------------------------------------------------------
# Streaming against eager at bench_streaming_data's configuration
# (bench.py:1334-1430): 16 lazy read sources of 256 Ki rows x 2 int64
# columns (4 MiB a block), map_batches(x * 3), a window of 3; the
# dataset is 5.3 windows.  Then streaming ingest into the GPT-2 step:
# [trainer]'s rows (trainer_tokens, default_rng(0)) for B=16 S=1024, one
# warm-up and DATA_STEPS timed steps' worth, as DATA_SHARDS .npy shards
# of 128 KiB (the store holds objects above 100 KiB; smaller ones travel
# inline), read_streaming(numpy) under a store budget of
# DATA_BUDGET_SHARDS shards' bytes (a window of 2: half the budget over
# the first block's stored size, a little above its file's) ->
# BatchMapper -> the window-scoped random_shuffle(seed=0) ->
# iter_device_batches(16) on CUDA -> the steps in this process.  The
# shuffle holds one window's blocks and their outputs in the store.
DATA_WINDOW, DATA_BLOCKS, DATA_BLOCK_ROWS = 3, 16, 256 * 1024
DATA_STEPS, DATA_SHARDS, DATA_BUDGET_SHARDS = 15, 8, 5


def data_block_reader(path, columns):
    """bench.py's _bench_block_reader: the path is the block's index; the
    block is ids counting up and ones, int64."""
    i = int(path)
    base = i * DATA_BLOCK_ROWS
    return {"id": np.arange(base, base + DATA_BLOCK_ROWS, dtype=np.int64),
            "x": np.ones(DATA_BLOCK_ROWS, np.int64)}


def times_three(batch):
    return {"id": batch["id"], "x": batch["x"] * 3}


def store_used() -> int:
    return sum(r.store.used for r in ray_tpu_torch._head.raylets.values())


def drain_ref_gc():
    from ray_tpu_torch._private.worker import global_worker

    global_worker._drain_ref_gc_queue()


def consume_blocks(refs, base) -> tuple:
    """(blocks, checksum of every id and x, peak store bytes above
    ``base``) of a stream of block refs, each dropped once read."""
    blocks = checksum = peak = 0
    for ref in refs:
        blk = ray_tpu_torch.get(ref, timeout=GET_S)
        del ref
        blocks += 1
        checksum += int(blk["id"].sum()) + int(blk["x"].sum())
        del blk
        peak = max(peak, store_used() - base)
    return blocks, checksum, peak


def streaming_against_eager(card) -> dict:
    def build():
        return rdata.Dataset([("read", data_block_reader, str(i), None)
                              for i in range(DATA_BLOCKS)]
                             ).map_batches(times_three)

    # Warm the workers (imports) so both legs measure steady state.
    warm = build()._executor(window=DATA_WINDOW).materialize_refs()
    ray_tpu_torch.wait(warm, num_returns=len(warm), timeout=GET_S)
    del warm
    drain_ref_gc()

    ds = build()
    base = store_used()
    t0 = time.perf_counter()
    ex = ds._executor(window=DATA_WINDOW, name="data_stream")
    s_blocks, s_sum, s_peak = consume_blocks(ex.iter_block_refs(), base)
    s_dt = time.perf_counter() - t0
    inflight = ex.last_stream_stats["peak_in_flight"]
    drain_ref_gc()

    ds = build()
    base = store_used()
    t0 = time.perf_counter()
    refs = ds._blocks
    ray_tpu_torch.wait(refs, num_returns=len(refs), timeout=GET_S)
    e_materialized = store_used() - base
    e_blocks, e_sum, e_peak = consume_blocks(iter(refs), base)
    e_dt = time.perf_counter() - t0
    e_peak = max(e_peak, e_materialized)
    del refs, ds
    drain_ref_gc()

    rows = DATA_BLOCKS * DATA_BLOCK_ROWS
    want = rows * (rows - 1) // 2 + 3 * rows
    if not s_blocks == e_blocks == DATA_BLOCKS or not s_sum == e_sum == want:
        raise AssertionError(f"[data] streaming {s_blocks} blocks, checksum "
                             f"{s_sum}; eager {e_blocks}, {e_sum}; want "
                             f"{DATA_BLOCKS}, {want}")
    if not inflight <= DATA_WINDOW:
        raise AssertionError(f"[data] {inflight} blocks in flight, window "
                             f"{DATA_WINDOW}")
    if not s_peak < e_peak:
        raise AssertionError(f"[data] streaming held {s_peak} B at its "
                             f"peak, eager {e_peak} B")
    out = {"stream_blocks_per_s": s_blocks / s_dt,
           "eager_blocks_per_s": e_blocks / e_dt,
           "stream_peak_bytes": s_peak, "eager_peak_bytes": e_peak,
           "stream_peak_inflight": inflight,
           "residency_ratio": s_peak / e_peak}
    log(f"[data] {card} | bench_streaming_data's plan ({DATA_BLOCKS} read "
        f"sources x {DATA_BLOCK_ROWS} rows x 2 int64 = 4 MiB a block, "
        f"map_batches(x * 3), window {DATA_WINDOW}): streaming "
        f"{out['stream_blocks_per_s']:.1f} blocks/s, peak resident "
        f"{s_peak} B, peak in flight {inflight}; eager "
        f"{out['eager_blocks_per_s']:.1f} blocks/s, peak resident {e_peak} "
        f"B; residency ratio {out['residency_ratio']:.3f}; "
        f"{s_blocks} blocks and checksum {s_sum} from both")
    return out


def row_hashes(rows, weights):
    """One int64 a row: ids (< 2^16) times weights (< 2^20) summed over
    1024 positions, exact; a torch tensor on the card or numpy."""
    if isinstance(rows, torch.Tensor):
        return (rows.long() * weights).sum(1)
    return (rows.astype(np.int64) * weights).sum(1)


class StorePeak:
    """The store's peak bytes above ``base``, sampled every millisecond on
    a thread of its own while the ``with`` block runs."""

    def __init__(self, base):
        self.base, self.peak = base, 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)

    def _sample(self):
        while not self._stop.is_set():
            self.peak = max(self.peak, store_used() - self.base)
            time.sleep(0.001)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()


def streaming_ingest(card, train) -> dict:
    import tempfile

    b, length, iters = 16, 1024, DATA_STEPS
    rows = trainer_tokens(b, length, iters)[:b * (iters + 1)]
    weights = np.random.default_rng(SEED + 7).integers(
        0, 2**20, size=length, dtype=np.int64)
    on_card = torch.from_numpy(weights).to("cuda")
    hashes = []
    with tempfile.TemporaryDirectory() as root:
        paths = write_shards(root, rows, DATA_SHARDS)
        budget = DATA_BUDGET_SHARDS * os.path.getsize(paths[0])
        sd = rdata.BatchMapper(as_tokens).transform(
            rdata.read_streaming(paths, "numpy", store_budget=budget)
        ).random_shuffle(seed=0)
        drain_ref_gc()
        with StorePeak(store_used()) as store:
            stream = sd.iter_device_batches(b)

            def batches():
                for batch in stream:
                    hashes.append(row_hashes(batch["tokens"], on_card))
                    yield batch["tokens"]

            t0 = time.perf_counter()
            run = train_steps(b, length, iters, batches=batches())
            wall = time.perf_counter() - t0
            occupancy = stream.peak_occupancy
            stream.close()
    tag = f"B={b} S={length}"
    tokens_per_s, mfu, _ = check_train(f"[data] {tag}", run, b, length,
                                       iters)
    got = np.sort(torch.cat(hashes).cpu().numpy())
    want = np.sort(row_hashes(rows, weights))
    if not np.array_equal(got, want):
        raise AssertionError(f"[data] the steps consumed {len(got)} rows "
                             f"that are not the {len(want)} written")
    if not store.peak <= budget:
        raise AssertionError(f"[data] store held {store.peak} B at its "
                             f"peak, budget {budget} B")
    local = train[tag]
    local_rate = train_rates(local, b, length, local["iters"])[0]
    numbers = {"tokens_per_s": tokens_per_s, "mfu": mfu,
               "ms_per_step": run["seconds"] / iters * 1e3,
               "train_tokens_per_s": local_rate, "wall_s": wall,
               "build_s": run["build_s"], "warm_s": run["warm_s"],
               "peak_store_bytes": store.peak, "budget_bytes": budget,
               "prefetch_peak": occupancy}
    log(f"[data] {card} | GPT-2 small {tag}, streaming ingest "
        f"(read_streaming of {DATA_SHARDS} .npy shards under a {budget} B "
        f"store budget -> BatchMapper -> random_shuffle(seed=0) -> "
        f"iter_device_batches on CUDA): {iters} steps {run['seconds']:.3f} "
        f"s = {numbers['ms_per_step']:.1f} ms/step, {tokens_per_s:.0f} "
        f"tokens/s, MFU {mfu:.4f}; [train]'s in-memory "
        f"{local_rate:.0f} tokens/s; the model's build "
        f"{run['build_s']:.2f} s, the warm-up step {run['warm_s']:.2f} s; "
        f"launches {run['launches']}; loss "
        f"{' '.join(f'{x:.4f}' for x in run['losses'])}; rows consumed = "
        f"rows written ({len(got)}, as a multiset); peak store "
        f"{store.peak} B of {budget} B; prefetch peak occupancy "
        f"{occupancy}")
    note(f"data {tag}", **numbers)
    return {f"data {tag}": run["launches"]}


def phase_data(card, train) -> dict:
    """The port's Data on the card's machine: streaming against eager at
    bench_streaming_data's configuration (same blocks and checksum, the
    in-flight window held, streaming's peak residency below eager's),
    then streaming ingest into the GPT-2 step (12 launches of each kernel
    a step, finite falling losses, the rows consumed are the rows
    written, the store within its budget).  Returns the step's
    launches."""
    note("data", **streaming_against_eager(card))
    return streaming_ingest(card, train)


# ---------------------------------------------------------------------------
# Data parallelism: [zero] (bench_gpt2's ZeRO phase, one worker over NCCL)
# and [dp2] (two ranks sharing the card over gloo)
# ---------------------------------------------------------------------------
# [zero]: bench.py:226-255, the third fit: [trainer]'s 1k fit with
# zero_sharding="opt+grads" and quantized_collectives="int8".  At world 1
# the update is the plain one (no collective), so its losses on
# [trainer]'s batches must equal [trainer]'s within TRAINER_LOSS_ATOL.
ZERO_CONFIG = {"zero_sharding": "opt+grads", "quantized": "int8"}
# Device time of one ZeRO step by kernel name (first match): the flash
# kernels, AdamW's multi-tensor kernels, copies and dtype casts (the flat
# vector's split and merge, the weights' bf16 casts, the logits' fp32
# one), cuBLAS's matmuls, the rest elementwise.
ZERO_STEP_GROUPS = (("flash", ("flash_",)),
                    ("optimizer", ("multi_tensor_apply",)),
                    ("copy/cast", ("Memcpy", "Memset", "CatArrayBatchedCopy",
                                "copy_kernel", "direct_copy")),
                    ("matmul", ("gemm", "xmma", "cutlass", "nvjet",
                                "sm90_")),
                    ("elementwise", ("elementwise", "vectorized", "reduce",
                                     "softmax", "norm", "Norm", "nll",
                                     "cross_entropy", "index", "gelu")))
# [dp2]: two TorchTrainer workers at half a card each, over gloo, on
# [trainer]'s 1k batches (the global batch 16 x 1024, 8 rows a rank):
# a warm-up step and DP2_STEPS steps with the fp32 wire, then with the
# int8 wire; after the fp32 leg the sharded optimizer state is saved at
# world 2, two more steps are taken, and the driver restores the save at
# world 1 and takes the same two steps.
DP2_GPUS = 0.5
DP2_STEPS = 5
# The fp32 wire's losses against one worker's plain steps on the same
# global batches ([trainer]'s), and the world-1 restore's two losses
# against the 2-rank run's: two B=8 halves in bf16 against one B=16
# batch (other matmul shapes, so other roundings) averaged in fp32.
# Measured 1.45e-4 and 1.14e-5 (H100 80GB HBM3, 700 W; PERF.md, section
# 6); the bound is 10x the larger.
DP2_LOSS_ATOL = 2e-3
# test_zero.py::test_gpt2_int8_collectives_loss_envelope's envelope.
INT8_ENVELOPE = 0.05
# The int8 wire's losses against the fp32 wire's at every step: 10x the
# largest gap read on the H100 80GB HBM3 at 700 W (5.34e-5, PERF.md,
# section 6).  Over the window the loss moves only ~0.011, so a wire that
# brought back zero gradients would end ~0.01 off.
INT8_WIRE_ATOL = 5e-4
# The parameters' change over a leg's DP2_STEPS + 1 updates against one
# worker's plain steps on the same global batches, |theta_leg -
# theta_plain| / |theta_plain - theta_0|: a number that moves with every
# element of the update, where the loss moves little.  The control (one
# worker's plain steps on rank 0's half of each batch: the update a rank
# makes when the wire brings back only its own gradient) must fail it.
# Read 0.0490 (fp32 wire), 0.0601 (int8 wire) and 0.958 (the control) on
# the H100 80GB HBM3 at 700 W (PERF.md, section 6); the bound is 3x the
# larger wire reading.
DP2_CHANGE_RTOL = 0.18
ZERO_OPT_RATIO = 0.51
# ElasticMeshGroup at GPT-2 small: 4 slots of 2 x 1024, two ranks at
# half a card, a preemption notice at step 3, one rank to step 6; the
# parameters bit for bit reference_trajectory's in this process.
ELASTIC_SLOTS, ELASTIC_ROWS, ELASTIC_STEPS, ELASTIC_NOTICE = 4, 2, 6, 3
# DistributedLearnerGroup(num_hosts=2) with [ppo-actor]'s learner (the
# CartPole module, PPO's loss, lr 3e-4) for 10 updates on one batch of
# 512 CartPole transitions, against one TorchLearner on the same batch:
# two halves' mean gradients averaged against one mean, in fp32
# (measured 2.2e-7 on the H100 80GB HBM3 at 700 W; PERF.md, section 6).
LEARNER_UPDATES, LEARNER_ROWS = 10, 512
LEARNER_RTOL = 1e-5
# The second cluster's object store: the elastic gang's boundary snapshot
# (GPT-2 small's fp32 parameters and Adam moments, ~1.5 GB) goes through
# it twice.
DP2_STORE_BYTES = 8 * 1024 ** 3


def zero_train_step(model, zero_sharding, quantized):
    """``make_train_step``'s counterpart through ``compile_zero_step`` over
    this process's group (``get_mesh``), adamw(3e-4): ``step(batch) ->
    loss`` with the memory and wire envelope, the parameters, the
    optimizer share and the mesh beside it."""
    from ray_tpu_torch.train.torch import compile_zero_step, get_mesh

    params = dict(model.named_parameters())
    mesh = get_mesh()

    def grad_fn(p, batch):
        loss = gpt2_loss_fn(model, batch)
        return loss, dict(zip(p, torch.autograd.grad(loss,
                                                     list(p.values()))))

    zstep, opt, info = compile_zero_step(
        grad_fn, lambda ps: adamw(ps, 3e-4), params, mesh,
        zero_sharding=zero_sharding, quantized_collectives=quantized)
    holder = [opt]

    def step(batch):
        _, holder[0], loss = zstep(params, holder[0], batch)
        return loss

    return types.SimpleNamespace(step=step, info=info, params=params,
                                 opt=holder, mesh=mesh)


def phase_zero(card, trainer_runs) -> dict:
    """bench_gpt2's ZeRO fit through TorchTrainer, one worker over NCCL:
    [trainer]'s checks, the losses against [trainer]'s 1k run, the
    memory and wire envelope, and one profiled step by kernel group.
    Returns the fit's launches."""
    b, length, iters = TRAINER_FITS[0]
    tag = f"B={b} S={length}"
    t0 = time.time()
    result = TorchTrainer(
        trainer_loop,
        train_loop_config={"batch": b, "seq": length, "iters": iters,
                           "zero": ZERO_CONFIG},
        datasets={"train": rdata.from_numpy(
            {"tokens": trainer_tokens(b, length, iters)}, parallelism=8)},
        scaling_config=ScalingConfig(num_workers=1, use_gpu=True)).fit()
    fit_s = time.time() - t0
    if result.error is not None:
        raise AssertionError(f"[zero] {tag}: {result.error}")
    m = result.metrics
    run, info, prof = m["run"], m["run"]["info"], m["run"]["profile"]
    check_worker_setup(f"[zero] {tag}", m["setup"])
    tokens_per_s, mfu, _ = check_train(f"[zero] {tag}", run, b, length,
                                       iters)
    local = trainer_runs[tag]
    diff = max(abs(x - y) for x, y in zip(run["losses"], local["losses"]))
    bitwise = run["losses"] == local["losses"]
    if not diff <= TRAINER_LOSS_ATOL:
        raise AssertionError(f"[zero] losses {run['losses']} vs [trainer]'s "
                             f"{local['losses']}")
    if not info["zero_opt_bytes_per_replica"] <= \
            info["replicated_opt_bytes"]:
        raise AssertionError(f"[zero] envelope {info}")
    step_ms = run["seconds"] / iters * 1e3
    t_rate, t_mfu, _ = train_rates(local, b, length, local["iters"])
    groups = ", ".join(f"{g} {ms:.1f}" for g, ms in sorted(
        prof["groups"].items(), key=lambda kv: -kv[1]))
    top = "; ".join(f"{name[:60]} x{n} {ms:.1f} ms"
                    for name, (n, ms) in prof["top"])
    note("zero", ms_per_step=step_ms, tokens_per_s=tokens_per_s, mfu=mfu,
         trainer_ms_per_step=local["seconds"] / local["iters"] * 1e3,
         bitwise=bitwise, device_ms=prof["device_ms"],
         **{f"{g}_ms": ms for g, ms in prof["groups"].items()},
         zero_opt_bytes_per_replica=info["zero_opt_bytes_per_replica"],
         replicated_opt_bytes=info["replicated_opt_bytes"],
         grad_comm_bytes_per_step=info["grad_comm_bytes"],
         grad_comm_reduction_vs_fp32=info["grad_comm_reduction_vs_fp32"])
    log(f"[zero] {card} | GPT-2 small {tag} through TorchTrainer, one worker"
        f" over NCCL, zero_sharding=opt+grads, quantized_collectives=int8 "
        f"(world 1: the plain update on the flat shard, no collective): "
        f"{iters} steps {run['seconds']:.3f} s = {step_ms:.1f} ms/step, "
        f"{tokens_per_s:.0f} tokens/s, MFU {mfu:.4f}; [trainer] "
        f"{local['seconds'] / local['iters'] * 1e3:.1f} ms/step, "
        f"{t_rate:.0f} tokens/s, MFU {t_mfu:.4f}; max |loss - [trainer]'s "
        f"on the same batches| {diff:.3g} (bitwise {bitwise}, bound "
        f"{TRAINER_LOSS_ATOL}); zero_opt_bytes_per_replica "
        f"{info['zero_opt_bytes_per_replica']}, replicated_opt_bytes "
        f"{info['replicated_opt_bytes']}, grad_comm_bytes_per_step "
        f"{info['grad_comm_bytes']:.0f}, grad_comm_reduction_vs_fp32 "
        f"{info['grad_comm_reduction_vs_fp32']:.2f}; launches "
        f"{run['launches']}; peak memory {run['peak_gib']:.1f} GiB; fit "
        f"{fit_s:.1f} s")
    log(f"[zero] {card} | one profiled ZeRO step: device "
        f"{prof['device_ms']:.1f} ms, {prof['device_ms'] / step_ms:.1%} of a"
        f" timed step ({prof['wall_ms']:.1f} ms of wall time under the "
        f"profiler), {prof['device_ops']} device ops, "
        f"{prof['launch_calls']} launch calls; by group (ms): {groups}; "
        f"top: {top}")
    return {"zero": run["launches"]}


def param_hash(params) -> int:
    """A hash of the parameters' bits on the card: each fp32 word as an
    integer times a fixed weight, summed in int64 (exact, so the order of
    the sum does not matter)."""
    total = 0
    for i, p in enumerate(params.values()):
        bits = p.detach().reshape(-1).view(torch.int32).to(torch.int64)
        w = torch.arange(bits.numel(), device=bits.device) % 65521 + i + 1
        total = total + (bits * w).sum()
    return int(total.item()) % 2 ** 63


def dp2_loop(config):
    """One of two ranks sharing the card over gloo: the ZeRO-2 step on
    this rank's half of [trainer]'s 1k batches, the fp32 wire then the
    int8 wire, each from the seeded weights: a warm-up step, then
    DP2_STEPS timed steps, a hash of the parameters after every step;
    rank 0 saves each leg's parameters.  After the fp32 leg the
    optimizer shard is saved and two more steps are taken."""
    import torch.distributed as dist

    from ray_tpu_torch.air import session
    from ray_tpu_torch.parallel import zero as zero_mod
    from ray_tpu_torch.train.torch import prepare_batch

    torch.set_float32_matmul_precision("highest")
    b, length = config["batch"], config["seq"]
    tokens = trainer_tokens(b, length, TRAINER_FITS[0][2])
    out = {}
    for wire in ("off", "int8"):
        model = build_model("gpt2", {"tiny": False,
                                     "max_position_embeddings":
                                     max(1024, length)}, seed=SEED)
        zs = zero_train_step(model, "opt+grads", wire)
        batches = [prepare_batch({"input_ids": torch.from_numpy(
            tokens[i * b:(i + 1) * b])}, zs.mesh)["input_ids"].to("cuda")
            for i in range(DP2_STEPS + 3)]
        losses = [zs.step({"input_ids": batches[0]})]
        hashes = [param_hash(zs.params)]
        zero_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(1, DP2_STEPS + 1):
            losses.append(zs.step({"input_ids": batches[i]}))
            hashes.append(param_hash(zs.params))
        seconds = time.perf_counter() - t0
        launches = dict(attn.LAUNCHES)
        both = [None, None]
        dist.all_gather_object(both, (hashes, launches))
        leg = {"losses": torch.stack(losses).tolist(), "hashes": hashes,
               "peer_hashes": both[1][0], "seconds": seconds,
               "launches": launches,
               "launches_both": {k: both[0][1][k] + both[1][1][k]
                                 for k in launches},
               "info": zs.info, "rows": batches[0].shape[0]}
        if zs.mesh.rank == 0:
            torch.save({k: v.detach().cpu() for k, v in zs.params.items()},
                       os.path.join(config["root"], f"params_{wire}.pt"))
        if wire == "off":
            t0 = time.perf_counter()
            zero_mod.save_opt_shard(config["root"], 1, zs.opt[0])
            leg["save_s"] = time.perf_counter() - t0
            leg["next"] = [zs.step({"input_ids": batches[i]}).item()
                           for i in (DP2_STEPS + 1, DP2_STEPS + 2)]
        out[wire] = leg
        del model, zs, batches
        torch.cuda.empty_cache()
    out["setup"] = worker_setup()
    session.report(out)


def restore_one_rank(root, tokens, b) -> list:
    """The [dp2] save restored at world 1 in this process (no process
    group: ``compile_zero_step``'s world-1 path): its parameters and its
    optimizer state re-chunked from two shards to one, then the two steps
    the 2-rank run took after the save, on the same global batches."""
    from ray_tpu_torch.parallel import zero as zero_mod

    model = build_model("gpt2", {"tiny": False,
                                 "max_position_embeddings": 1024}, seed=SEED)
    saved = torch.load(os.path.join(root, "params_off.pt"))
    with torch.no_grad():
        for k, p in model.named_parameters():
            p.copy_(saved[k])
    zs = zero_train_step(model, "opt+grads", "off")
    opt = zs.opt[0]
    opt.load_global_tree(zero_mod.restore_opt_state(
        root, opt.sharder, lambda ps: adamw(ps, 3e-4)))
    out = [zs.step({"input_ids": torch.from_numpy(
        tokens[i * b:(i + 1) * b]).to("cuda")}).item()
        for i in (DP2_STEPS + 1, DP2_STEPS + 2)]
    del model, zs
    torch.cuda.empty_cache()
    return out


def parameter_change(root, tokens, b) -> dict:
    """Each [dp2] leg's parameters against one worker's plain steps on
    the same global batches, here at world 1 (``compile_zero_step``'s
    plain update): |theta_leg - theta_plain| / |theta_plain - theta_0|
    after DP2_STEPS + 1 updates, for the fp32 and int8 wires and for the
    control, one worker's plain steps on rank 0's half of each batch."""
    kw = {"tiny": False, "max_position_embeddings": 1024}

    def plain(rows, start=None):
        model = build_model("gpt2", kw, seed=SEED)
        if start is not None:
            start.update({k: p.detach().clone()
                          for k, p in model.named_parameters()})
        zs = zero_train_step(model, "opt+grads", "off")
        for i in range(DP2_STEPS + 1):
            zs.step({"input_ids": torch.from_numpy(
                tokens[i * b:i * b + rows]).to("cuda")})
        out = {k: p.detach().clone() for k, p in zs.params.items()}
        del model, zs
        torch.cuda.empty_cache()
        return out

    def dist(x, y):
        return sum(float((x[k].double() - y[k].to(x[k].device).double())
                         .pow(2).sum()) for k in x) ** 0.5

    theta0 = {}
    full = plain(b, theta0)
    scale = dist(full, theta0)
    out = {"change_norm": scale,
           "control": dist(plain(b // 2), full) / scale}
    for wire in ("off", "int8"):
        leg = torch.load(os.path.join(root, f"params_{wire}.pt"))
        out[wire] = dist(full, leg) / scale
    del theta0, full
    torch.cuda.empty_cache()
    return out


def dp2_driver_runs(root, tokens, b, fns) -> tuple:
    """[dp2]'s runs in this process: the 2 -> 1 restore, the parameter
    change against one worker's plain steps, and reference_trajectory
    with its seconds."""
    from ray_tpu_torch.parallel.elastic import reference_trajectory

    restored = restore_one_rank(root, tokens, b)
    change = parameter_change(root, tokens, b)
    t0 = time.time()
    ref = reference_trajectory(*fns, steps=ELASTIC_STEPS,
                               slots=ELASTIC_SLOTS, world=1)
    return restored, change, ref, time.time() - t0


def elastic_problem():
    """GPT-2 small as ``ElasticMeshGroup``'s functions: each process
    builds the module once (seeded) and runs it with the given parameters
    (``torch.func.functional_call``); bf16 compute over fp32 parameters,
    adamw(3e-4); slots of ELASTIC_ROWS x 1024 seeded ids."""
    kw = {"tiny": False, "max_position_embeddings": 1024}
    cache = {}

    def loss_fn(params, mb):
        if "model" not in cache:
            cache["model"] = build_model("gpt2", kw, seed=SEED)
        model = cache["model"]
        return gpt2_loss_fn(lambda ids: torch.func.functional_call(
            model, params, (ids,)), mb)

    def params_factory():
        model = build_model("gpt2", kw, seed=SEED)
        return {k: v.detach().cpu().numpy()
                for k, v in model.named_parameters()}

    def tx_factory():
        return lambda ps: adamw(ps, 3e-4)

    def batch_fn(step_idx):
        rng = np.random.default_rng(SEED + 100 + step_idx)
        return {"input_ids": rng.integers(
            0, 50257, (ELASTIC_SLOTS, ELASTIC_ROWS, 1024))}

    return loss_fn, params_factory, tx_factory, batch_fn


def learner_factory():
    """[ppo-actor]'s learner: the CartPole module, PPO's loss, lr 3e-4,
    on the card."""
    from ray_tpu_torch.rllib.algorithms.ppo import ppo_loss
    from ray_tpu_torch.rllib.core.learner import TorchLearner

    c = PPOConfig()
    torch.manual_seed(SEED)
    module = RLModuleSpec(obs_dim=4, num_actions=2).build()
    return TorchLearner(module, functools.partial(
        ppo_loss, clip_param=c.clip_param, vf_clip_param=c.vf_clip_param,
        vf_loss_coeff=c.vf_loss_coeff,
        entropy_coeff=PPO_ACTOR_TRAINING["entropy_coeff"]),
        lr=PPO_ACTOR_TRAINING["lr"], device="cuda")


def cartpole_batch() -> dict:
    """LEARNER_ROWS CartPole transitions under a uniform random policy
    (seeded), with discounted returns as value targets and their
    standardised values as advantages."""
    rng = np.random.default_rng(SEED)
    env = PyCartPole(seed=SEED)
    obs, rows, rewards, dones = env.reset(seed=SEED), [], [], []
    for _ in range(LEARNER_ROWS):
        action = int(rng.integers(2))
        nxt, r, term, trunc, _ = env.step(action)
        rows.append((obs, action))
        rewards.append(r)
        dones.append(term or trunc)
        obs = env.reset() if (term or trunc) else nxt
    ret, returns = 0.0, []
    for r, d in zip(reversed(rewards), reversed(dones)):
        ret = r + (0.0 if d else 0.99 * ret)
        returns.append(ret)
    returns = np.asarray(returns[::-1], np.float32)
    adv = (returns - returns.mean()) / (returns.std() + 1e-8)
    return {"obs": np.stack([o for o, _ in rows]).astype(np.float32),
            "actions": np.asarray([a for _, a in rows], np.int64),
            "action_logp": np.full(LEARNER_ROWS, np.log(0.5), np.float32),
            "advantages": adv.astype(np.float32), "value_targets": returns}


def learner_weights(state):
    return state["learner"].get_weights()


def phase_dp2(card, trainer_runs) -> dict:
    """Two ranks sharing the card over gloo: ZeRO-2 through TorchTrainer
    (fp32 and int8 wires: bit-identical ranks after every step, losses
    against [trainer]'s, the optimizer bytes, the 2 -> 1 restore),
    ElasticMeshGroup's notice shrink (bitwise against
    reference_trajectory here) and DistributedLearnerGroup (bitwise
    ranks, losses against one learner).  Timings are readings only: two
    CUDA contexts time-slice the card.  Returns the ZeRO legs' launches."""
    import shutil
    import tempfile

    from ray_tpu_torch.parallel.elastic import ElasticMeshGroup
    from ray_tpu_torch.rllib.core.learner import (
        DistributedLearnerGroup, metrics_to_host)

    b, length, _ = TRAINER_FITS[0]
    tag = f"B={b} S={length}"
    plain = trainer_runs[tag]["losses"]
    tokens = trainer_tokens(b, length, TRAINER_FITS[0][2])
    fns = elastic_problem()
    root = tempfile.mkdtemp(prefix="rttp_dp2_")
    # The driver's own runs (the 2 -> 1 restore, the plain steps of the
    # parameter-change check, reference_trajectory) go on the card beside
    # the elastic gang, whose ranks are other processes: each run is
    # deterministic, so sharing the card moves only the times.
    pool = concurrent.futures.ThreadPoolExecutor(1)
    try:
        t0 = time.time()
        result = TorchTrainer(
            dp2_loop, train_loop_config={"batch": b, "seq": length,
                                         "root": root},
            scaling_config=ScalingConfig(num_workers=2, use_gpu=True,
                                         gpus_per_worker=DP2_GPUS)).fit()
        fit_s = time.time() - t0
        if result.error is not None:
            raise AssertionError(f"[dp2] {result.error}")
        m = result.metrics
        check_worker_setup("[dp2]", m["setup"], shared=True)
        fp32, int8 = m["off"], m["int8"]
        info = fp32["info"]
        # The reference gets functions of its own: each closure caches the
        # module it builds, and the gang's are pickled at every rebuild.
        driver = pool.submit(dp2_driver_runs, root, tokens, b,
                             elastic_problem())
        # ElasticMeshGroup: 2 ranks, a notice at step ELASTIC_NOTICE, 1 rank.
        t0 = time.time()
        emg = ElasticMeshGroup(*fns, num_hosts=(1, 2), slots=ELASTIC_SLOTS,
                               resources_per_host={"CPU": 1,
                                                   "GPU": DP2_GPUS},
                               snapshot_interval=ELASTIC_STEPS + 1,
                               bootstrap_timeout=GET_S)
        try:
            losses = emg.run(ELASTIC_NOTICE)
            emg.preemption_notice(1)
            losses += emg.run(ELASTIC_STEPS - ELASTIC_NOTICE)
            stats = emg.stats()
            params = emg.params_host()
        finally:
            emg.shutdown()
        gang_s = time.time() - t0
        restored, change, ref, ref_s = driver.result()
    finally:
        pool.shutdown(wait=True)
        shutil.rmtree(root, ignore_errors=True)
    for leg, name in ((fp32, "fp32"), (int8, "int8")):
        if leg["hashes"] != leg["peer_hashes"]:
            raise AssertionError(f"[dp2] {name} wire: the ranks' parameters "
                                 f"differ: {leg['hashes']} vs "
                                 f"{leg['peer_hashes']}")
    n = len(fp32["losses"])
    gap = max(abs(x - y) for x, y in zip(fp32["losses"], plain[:n]))
    if not gap <= DP2_LOSS_ATOL:
        raise AssertionError(f"[dp2] fp32 wire losses {fp32['losses']} vs "
                             f"one worker's {plain[:n]}")
    ratio = info["zero_opt_bytes_per_replica"] / info["replicated_opt_bytes"]
    if not ratio <= ZERO_OPT_RATIO:
        raise AssertionError(f"[dp2] optimizer bytes per replica {ratio:.3f}"
                             f" of replicated: {info}")
    envelope = abs(int8["losses"][-1] - fp32["losses"][-1])
    wire_gap = max(abs(x - y) for x, y in zip(int8["losses"],
                                               fp32["losses"]))
    if not envelope < INT8_ENVELOPE or not wire_gap <= INT8_WIRE_ATOL or \
            not int8["losses"][-1] < int8["losses"][0]:
        raise AssertionError(f"[dp2] int8 wire {int8['losses']} vs fp32 "
                             f"{fp32['losses']}")
    if not (change["off"] <= DP2_CHANGE_RTOL and change["int8"] <=
            DP2_CHANGE_RTOL < change["control"]):
        raise AssertionError(f"[dp2] parameter change against one worker's"
                             f" plain steps {change} (bound "
                             f"{DP2_CHANGE_RTOL}; the control must exceed "
                             f"it)")
    restore_gap = max(abs(x - y) for x, y in zip(restored, fp32["next"]))
    if not restore_gap <= DP2_LOSS_ATOL:
        raise AssertionError(f"[dp2] world-1 restore {restored} vs the "
                             f"2-rank run's {fp32['next']}")
    note("dp2", fit_s=fit_s, fp32_s=fp32["seconds"], int8_s=int8["seconds"],
         fp32_gap=gap, restore_gap=restore_gap, int8_envelope=envelope,
         int8_wire_gap=wire_gap, change_norm=change["change_norm"],
         change_rel_fp32=change["off"], change_rel_int8=change["int8"],
         change_rel_control=change["control"], opt_ratio=ratio,
         save_s=fp32["save_s"])
    log(f"[dp2] {card} | two TorchTrainer workers at {DP2_GPUS} of the card"
        f" each over gloo (two CUDA contexts time-slice the card: timings "
        f"are readings, compared with nothing), GPT-2 small bf16, ZeRO-2, "
        f"[trainer]'s 1k batches, {fp32['rows']} rows a rank: the ranks' "
        f"parameter hashes equal after each of {n} steps on both wires; "
        f"fp32 wire losses {' '.join(f'{x:.4f}' for x in fp32['losses'])}, "
        f"max |loss - one worker's plain step| {gap:.3g} (bound "
        f"{DP2_LOSS_ATOL}); int8 wire "
        f"{' '.join(f'{x:.4f}' for x in int8['losses'])}, max "
        f"{wire_gap:.3g} from the fp32 wire's (bound {INT8_WIRE_ATOL}; last "
        f"step {envelope:.3g}, envelope {INT8_ENVELOPE}); the parameters' "
        f"change over {n} updates, |theta - theta_plain| / |theta_plain - "
        f"theta_0| against one worker's plain steps (|theta_plain - "
        f"theta_0| = {change['change_norm']:.6g}): fp32 wire "
        f"{change['off']:.6g}, int8 wire {change['int8']:.6g}, control "
        f"(rank 0's half only) {change['control']:.6g} (bound "
        f"{DP2_CHANGE_RTOL}, the control above it); "
        f"zero_opt_bytes_per_replica {info['zero_opt_bytes_per_replica']} = "
        f"{ratio:.4f} of replicated {info['replicated_opt_bytes']} (bound "
        f"{ZERO_OPT_RATIO}); grad_comm_bytes {info['grad_comm_bytes']:.0f} "
        f"fp32, {int8['info']['grad_comm_bytes']:.0f} int8 "
        f"(x{int8['info']['grad_comm_reduction_vs_fp32']:.2f} vs the fp32 "
        f"all-reduce); saved at world 2 ({fp32['save_s']:.2f} s), restored "
        f"at world 1 in this process: the next two losses "
        f"{' '.join(f'{x:.4f}' for x in restored)} vs the 2-rank run's "
        f"{' '.join(f'{x:.4f}' for x in fp32['next'])} (max gap "
        f"{restore_gap:.3g}, bound {DP2_LOSS_ATOL}); {DP2_STEPS} steps "
        f"{fp32['seconds']:.2f} s fp32, {int8['seconds']:.2f} s int8 "
        f"(rank 0's clock, hashing included); launches rank 0 "
        f"{fp32['launches']}; fit {fit_s:.1f} s")

    same = np.array_equal(np.asarray(losses, np.float64), ref["losses"]) \
        and all(same_bits(params[k], ref["params"][k]) for k in params)
    if stats["hosts"] != 1 or stats["elastic_notice_shrinks_total"] != 1 \
            or stats["elastic_steps_lost_total"] != 0 or not same:
        raise AssertionError(f"[dp2] elastic {stats}, losses {losses} vs "
                             f"{ref['losses'].tolist()}, bitwise {same}")
    note("dp2", elastic_gang_s=gang_s, elastic_reference_s=ref_s,
         elastic_reshard_s=stats["elastic_reshard_seconds_total"])
    log(f"[dp2] {card} | ElasticMeshGroup, GPT-2 small, {ELASTIC_SLOTS} "
        f"slots of {ELASTIC_ROWS} x 1024, ranks at {DP2_GPUS} of the card: 2 "
        f"ranks, a preemption_notice at step {ELASTIC_NOTICE}, 1 rank to "
        f"step {ELASTIC_STEPS}; losses "
        f"{' '.join(f'{x:.4f}' for x in losses)}; parameters and losses bit "
        f"for bit reference_trajectory's in this process ({same}); "
        f"{stats['elastic_weight_puts_total']} weight puts, reshard "
        f"{stats['elastic_reshard_seconds_total']:.1f} s; gang "
        f"{gang_s:.1f} s, reference {ref_s:.1f} s")

    # DistributedLearnerGroup: 2 ranks at half the card each.
    batch = cartpole_batch()
    t0 = time.time()
    lg = DistributedLearnerGroup(learner_factory, num_hosts=2,
                                 resources_per_host={"CPU": 1,
                                                     "GPU": DP2_GPUS})
    try:
        got = [lg.update(batch)["total_loss"]
               for _ in range(LEARNER_UPDATES)]
        w0, w1 = lg.group.run_stateful(learner_weights, timeout=GET_S)
    finally:
        lg.shutdown()
    group_s = time.time() - t0
    single = learner_factory()
    want = [metrics_to_host(single.update(batch))["total_loss"]
            for _ in range(LEARNER_UPDATES)]
    rel = max(abs(x - y) / abs(y) for x, y in zip(got, want))
    bitwise = all(same_bits(w0[k], w1[k]) for k in w0)
    if not bitwise or not rel <= LEARNER_RTOL:
        raise AssertionError(f"[dp2] learner group: ranks bitwise {bitwise},"
                             f" losses {got} vs one learner's {want}")
    note("dp2", learner_rel=rel, learner_group_s=group_s)
    log(f"[dp2] {card} | DistributedLearnerGroup(num_hosts=2), [ppo-actor]'s"
        f" learner at {DP2_GPUS} of the card a rank, {LEARNER_UPDATES} "
        f"updates on {LEARNER_ROWS} CartPole transitions: ranks' weights bit"
        f" for bit ({bitwise}); losses "
        f"{' '.join(f'{x:.5f}' for x in got)}, max relative gap to one "
        f"TorchLearner {rel:.3g} (bound {LEARNER_RTOL}); {group_s:.1f} s")
    return {"dp2": fp32["launches_both"]}


# ---------------------------------------------------------------------------
# Actor-mode RL on the same cluster: [ppo-actor], [impala-actor]
# ---------------------------------------------------------------------------
# [ppo-actor]: bench.py::bench_ppo_real_env (:1169-1234) with one change:
# the env is the port's native CartPole-v1 (numpy) in place of gymnasium's
# LunarLander-v3, which the card's machine does not have.  2 CPU rollout
# actors x 8 envs x 256 steps, the streaming sampler with 2 fragments in
# flight a worker, env stepping in subprocesses where the host has >= 4
# cores; the learner on the card.  The gate is _learn_to_floor's with
# tests/test_rllib_actor_path.py's CartPole floor of 100: the CURRENT
# episode_reward_mean >= 100 at an iteration >= 10, within 60.  Then 3
# timed iterations (_measure_steps_per_s), and a lockstep leg of the same
# settings (sample_streaming=False), timed the same way.
PPO_ACTOR_ROLLOUTS = {"num_rollout_workers": 2, "num_envs_per_worker": 8,
                      "rollout_fragment_length": 256,
                      "sample_streaming": True,
                      "max_in_flight_per_worker": 2,
                      "env_parallelism": "auto"}
PPO_ACTOR_TRAINING = {"lr": 3e-4, "num_sgd_iter": 6,
                      "sgd_minibatch_size": 512, "entropy_coeff": 0.01,
                      "gamma": 0.999}
PPO_ACTOR_FLOOR, PPO_ACTOR_MAX_ITERS, PPO_ACTOR_TIMED_ITERS = 100.0, 60, 3
# [impala-actor]: tests/test_rllib_actor_path.py:62-75's configuration (2
# workers x 4 envs x 32 steps, lr 5e-4) for 20 iterations, then APPO at
# the same size; no reward floor (the JAX package sets none).
IMPALA_ACTOR_ROLLOUTS = {"num_rollout_workers": 2, "num_envs_per_worker": 4,
                         "rollout_fragment_length": 32}
IMPALA_ACTOR_ITERS = 20


def ppo_actor_algo(streaming: bool):
    return (PPOConfig().environment("CartPole-v1")
            .rollouts(**{**PPO_ACTOR_ROLLOUTS,
                         "sample_streaming": streaming})
            .training(**PPO_ACTOR_TRAINING).debugging(seed=SEED).build())


def timed_actor_iterations(algo, iters) -> dict:
    """``iters`` iterations of an actor-mode PPO by the host clock, with a
    CUDA event and a host time at each phase the step marks: env-steps/s,
    the SGD epochs' device time an iteration (CUDA events from the batch's
    concatenation to the metrics' read, which ends them) and the weights'
    publish (``get_weights`` and the put, with the lockstep sync's wait
    for the workers) by the host clock."""
    marks = []

    def mark(name):
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        marks.append((name, event, time.perf_counter()))

    algo.on_phase = mark
    steps = 0
    t0 = time.perf_counter()
    for _ in range(iters):
        metrics = algo.train()
        if not np.isfinite(metrics["total_loss"]):
            raise AssertionError(f"timed actor iteration: {metrics}")
        steps += metrics["num_env_steps_sampled_this_iter"]
    seconds = time.perf_counter() - t0
    algo.on_phase = None
    torch.cuda.synchronize()
    names = ("start", "sample", "sgd", "publish")
    if [n for n, _, _ in marks] != list(names) * iters:
        raise AssertionError(f"phase marks {[n for n, _, _ in marks]}")
    rows = [marks[i:i + 4] for i in range(0, len(marks), 4)]
    return {"seconds": seconds, "metrics": metrics,
            "steps_per_s": steps / seconds,
            "sample_ms": float(np.mean([(r[1][2] - r[0][2]) * 1e3
                                        for r in rows])),
            "sgd_ms": float(np.mean([r[1][1].elapsed_time(r[2][1])
                                     for r in rows])),
            "publish_ms": float(np.mean([(r[3][2] - r[2][2]) * 1e3
                                         for r in rows]))}


def child_pids(parents) -> set:
    """The processes whose parent is one of ``parents``."""
    out = set()
    for entry in os.listdir("/proc"):
        if entry.isdigit():
            try:
                with open(f"/proc/{entry}/stat") as f:
                    ppid = int(f.read().rsplit(")", 1)[1].split()[1])
            except (OSError, IndexError, ValueError):
                continue
            if ppid in parents:
                out.add(int(entry))
    return out


def holds_the_card(pid) -> bool:
    """Whether the process maps the card's device files, which a CUDA
    context (and nothing before it: not ``import torch``) does."""
    try:
        with open(f"/proc/{pid}/maps") as maps:
            return any("/dev/nvidia" in line for line in maps)
    except OSError:
        return False


def card_holders(algo) -> dict:
    """Which of this process, the rollout workers and their env
    subprocesses hold a CUDA context (``/proc/<pid>/maps``), and, as a
    reading only, the card's compute processes as ``nvidia-smi`` lists
    them: it lists the PIDs of its own namespace, which a container's are
    not, so they are never compared with the workers'."""
    workers = set(ray_tpu_torch.get(
        [w.pid.remote() for w in algo.workers.workers], timeout=GET_S))
    envs = child_pids(workers)
    listed = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.split()
    return {"driver": os.getpid(), "workers": sorted(workers),
            "env_processes": len(envs),
            "holders": sorted(p for p in {os.getpid()} | workers | envs
                              if holds_the_card(p)),
            "nvidia_smi": sorted(int(p) for p in listed)}


def serial_fragment_ms(reps=3) -> float:
    """One fragment's compute in this process, on one CPU thread: 256
    steps of 8 CartPoles stepped serially under a CPU policy, then GAE
    (what a rollout worker does, without its env subprocesses' round trips
    and the actor's messages)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    env = VectorEnv(lambda: PyCartPole(), 8, SEED)
    module = RLModuleSpec(obs_dim=4, num_actions=2).build()
    gen = torch.Generator().manual_seed(SEED)
    bufs = FragmentBuffers(PPO_ACTOR_ROLLOUTS["rollout_fragment_length"])

    def act(obs, g):
        a, logp, v = module.forward_exploration(torch.from_numpy(obs), g)
        return a.numpy(), logp.numpy(), v.numpy()

    obs = env.reset_all().astype(np.float32)
    ep, done = np.zeros(8), []
    times = []
    with torch.inference_mode():
        for _ in range(reps + 1):
            t0 = time.perf_counter()
            obs, cols = collect_fragment(env, act, obs, bufs.T, gen, ep,
                                         done, bufs=bufs,
                                         cast=lambda o: o.astype(np.float32))
            fragment_batch("gae", cols, module(torch.from_numpy(obs))[1]
                           .numpy(), 0.999, 0.95)
            times.append((time.perf_counter() - t0) * 1e3)
    env.close()
    torch.set_num_threads(threads)
    return float(np.mean(times[1:]))


def phase_ppo_actor(card) -> dict:
    """Actor-mode PPO at bench_ppo_real_env's settings on CartPole-v1:
    the learner's parameters on the card; trained to the gate; 3 timed
    iterations (env-steps/s, the stream's readings, SGD and publish
    times); only this process holds the card; a lockstep leg timed the
    same way; the checkpoint round trip into the lockstep algorithm."""
    zero_launches()
    algo = ppo_actor_algo(streaming=True)
    on_card = {p.device.type for p in algo.learner.module.parameters()}
    if on_card != {"cuda"}:
        raise AssertionError(f"[ppo-actor] learner parameters on {on_card}")
    gate = learn_to_floor(algo, "ppo-actor", PPO_ACTOR_FLOOR,
                          PPO_ACTOR_MAX_ITERS)
    if gate["met_at"] is None:
        raise AssertionError(f"[ppo-actor] the gate {PPO_ACTOR_FLOOR} was "
                             f"not met within {PPO_ACTOR_MAX_ITERS}: {gate}")
    stream = timed_actor_iterations(algo, PPO_ACTOR_TIMED_ITERS)
    st = algo._stream.stats()
    # A worker's busy time a fragment (every fragment that came back,
    # stale ones included), and one minibatch update profiled.
    busy_ms = algo._stream._busy_s / max(
        1, st["fragments_consumed"] + st["stale_dropped"]) * 1e3
    minibatch = {k: v[:PPO_ACTOR_TRAINING["sgd_minibatch_size"]]
                 for k, v in algo._train_buf.items()}
    update = profile_device(lambda: algo.learner.update(minibatch),
                            check=True)
    holders = card_holders(algo)
    if holders["holders"] != [os.getpid()] or \
            holders["env_processes"] < 1:
        raise AssertionError(f"[ppo-actor] card holders {holders}")
    ckpt = algo.save_checkpoint()
    saved = algo.learner.get_weights()
    algo.stop()
    del algo
    lock = ppo_actor_algo(streaming=False)
    try:
        lock.train()  # warm-up, as the streaming leg's gate had
        lockstep = timed_actor_iterations(lock, PPO_ACTOR_TIMED_ITERS)
        # Rounds of one fragment a worker, called directly: the round's
        # wall time against the slower worker's busy time.
        rounds = []
        for _ in range(3):
            t0 = time.perf_counter()
            infos = ray_tpu_torch.get([w.sample_fragment.remote("gae")
                                       for w in lock.workers.workers],
                                      timeout=GET_S)
            rounds.append(((time.perf_counter() - t0) * 1e3,
                           max(i["busy_s"] for _, _, i in infos) * 1e3))
        version = lock.workers.weights_version
        lock.load_checkpoint(ckpt)
        loaded = lock.learner.get_weights()
        bitwise = all(same_bits(saved[k], loaded[k]) for k in saved)
        infos = ray_tpu_torch.get([w.sample_fragment.remote("gae")
                                   for w in lock.workers.workers],
                                  timeout=GET_S)
        versions = [info["weights_version"] for _, _, info in infos]
    finally:
        lock.stop()
    if not bitwise or versions != [version + 1] * len(versions):
        raise AssertionError(f"[ppo-actor] checkpoint round trip: bitwise "
                             f"{bitwise}, versions {versions} after "
                             f"{version}")
    numbers = {"gate_iteration": gate["met_at"], "gate_reward":
               gate["reward"], "env_steps_per_s": stream["steps_per_s"],
               "lockstep_env_steps_per_s": lockstep["steps_per_s"],
               "sgd_ms": stream["sgd_ms"],
               "lockstep_sgd_ms": lockstep["sgd_ms"],
               "publish_ms": stream["publish_ms"],
               "lockstep_publish_ms": lockstep["publish_ms"],
               "sample_ms": stream["sample_ms"],
               "lockstep_sample_ms": lockstep["sample_ms"],
               "worker_idle_frac": st["worker_idle_frac"],
               "weight_lag_mean": st["weight_lag_mean"],
               "weight_lag_max": st["weight_lag_max"],
               "fragments_per_s": st["fragments_per_s"],
               "stale_dropped": st["stale_dropped"],
               "gate_s": gate["seconds"], "fragment_busy_ms": busy_ms,
               "round_ms": float(np.mean([r[0] for r in rounds])),
               "round_busy_ms": float(np.mean([r[1] for r in rounds])),
               "serial_fragment_ms": serial_fragment_ms(),
               "update_launch_calls": update["launch_calls"],
               "update_device_ms": update["device_ms"],
               "update_wall_ms": update["wall_ms"],
               "card_holders": len(holders["holders"]),
               "nvidia_smi_listed": len(holders["nvidia_smi"])}
    note("ppo-actor", **numbers)
    log(f"[ppo-actor] {card} | PPO in actor mode, CartPole-v1: 2 CPU "
        f"rollout actors x 8 envs x 256 steps ({holders['env_processes']} "
        f"child processes of the workers step the envs), the learner on the card "
        f"(fp32, 6 epochs x 8 minibatches of 512 an iteration): gate reward "
        f"{gate['reward']:.2f} >= {PPO_ACTOR_FLOOR} at iteration "
        f"{gate['met_at']} ({gate['seconds']:.1f} s); streaming "
        f"{stream['steps_per_s']:.0f} env-steps/s ({stream['seconds'] / PPO_ACTOR_TIMED_ITERS * 1e3:.1f} ms an iteration: "
        f"waiting for fragments {stream['sample_ms']:.1f} ms, SGD "
        f"{stream['sgd_ms']:.1f} ms by CUDA events, publish "
        f"{stream['publish_ms']:.2f} ms), lockstep "
        f"{lockstep['steps_per_s']:.0f} env-steps/s (sample "
        f"{lockstep['sample_ms']:.1f} ms, SGD {lockstep['sgd_ms']:.1f} ms, "
        f"publish + sync {lockstep['publish_ms']:.2f} ms); stream: worker "
        f"idle {st['worker_idle_frac']:.4f}, weight lag mean "
        f"{st['weight_lag_mean']:.3f} max {st['weight_lag_max']}, "
        f"{st['fragments_per_s']:.2f} fragments/s, {st['stale_dropped']} "
        f"stale dropped; a worker busy {busy_ms:.1f} ms a fragment; "
        f"lockstep rounds of one fragment a worker called directly "
        f"{numbers['round_ms']:.1f} ms (the slower worker busy "
        f"{numbers['round_busy_ms']:.1f}); the same fragment's compute in "
        f"this process with serial envs {numbers['serial_fragment_ms']:.1f}"
        f" ms; one minibatch update: {update['launch_calls']} launch "
        f"calls, {update['device_ops']} device ops, "
        f"{update['device_ms']:.2f} ms on the card of "
        f"{update['wall_ms']:.2f} ms (profiled); card held by "
        f"{holders['holders']} (this process "
        f"{holders['driver']}; workers {holders['workers']}; nvidia-smi, "
        f"in its own PID namespace, lists {holders['nvidia_smi']}); "
        f"checkpoint round trip bitwise "
        f"{bitwise}, next fragments at version {versions}; flash launches "
        f"{dict(attn.LAUNCHES)}")
    if any(attn.LAUNCHES.values()):
        raise AssertionError(f"[ppo-actor] launched {attn.LAUNCHES}")
    return {"flash": dict(attn.LAUNCHES)}


def phase_impala_actor(card) -> dict:
    """IMPALA, then APPO, in actor mode at the JAX package's test size:
    finite losses, every env step counted, the weight lag within the
    staleness bound."""
    zero_launches()
    out = {}
    for name, config_cls in (("IMPALA", IMPALAConfig),
                             ("APPO", APPOConfig)):
        algo = (config_cls().environment("CartPole-v1")
                .rollouts(**IMPALA_ACTOR_ROLLOUTS).training(lr=5e-4)
                .debugging(seed=SEED).build())
        try:
            # The first iteration waits for the workers to start.
            t0 = time.perf_counter()
            first = algo.train()
            t1 = time.perf_counter()
            for _ in range(IMPALA_ACTOR_ITERS - 1):
                m = algo.train()
            seconds = time.perf_counter() - t1
            bound = algo.config.max_weight_staleness
        finally:
            algo.stop()
        want = IMPALA_ACTOR_ITERS * 2 * 4 * 32
        if not (np.isfinite(m["total_loss"])
                and m["num_env_steps_sampled"] >= want
                and m["rollout_weight_lag_max"] <= bound):
            raise AssertionError(f"[impala-actor] {name}: {m}")
        out[name] = {"env_steps_per_s": (m["num_env_steps_sampled"] - first[
            "num_env_steps_sampled"]) / seconds, "first_s": t1 - t0,
            "reward": m["episode_reward_mean"]}
        note(f"{name.lower()}-actor", **out[name],
             weight_lag_max=m["rollout_weight_lag_max"])
        log(f"[impala-actor] {card} | {name} in actor mode, CartPole-v1: 2 "
            f"CPU rollout actors x 4 envs x 32 steps, one V-trace update a "
            f"fragment on the card: the first iteration (the workers' "
            f"start) {out[name]['first_s']:.2f} s, then "
            f"{IMPALA_ACTOR_ITERS - 1} in {seconds:.2f} s, "
            f"{out[name]['env_steps_per_s']:.0f} env-steps/s; "
            f"{m['num_env_steps_sampled']} env steps (>= {want}); reward"
            f" {m['episode_reward_mean']:.2f}; total loss "
            f"{m['total_loss']:.4f}; weight lag mean "
            f"{m['rollout_weight_lag_mean']:.3f} max "
            f"{m['rollout_weight_lag_max']} (bound {bound}); "
            f"{m['rollout_stale_dropped']} stale dropped")
    log(f"[impala-actor] flash launches {dict(attn.LAUNCHES)}")
    if any(attn.LAUNCHES.values()):
        raise AssertionError(f"[impala-actor] launched {attn.LAUNCHES}")
    return {"flash": dict(attn.LAUNCHES)}


# [dqn-actor]: tests/test_rllib_actor_path.py:78-100's configuration on the
# native CartPole-v1 (the card's machine has no gymnasium): 2 CPU rollout
# actors x 4 envs x 64 steps, lr 5e-4, the learner on the card.  The
# local plane is gated at the test's best >= 100 within 80 iterations;
# the sharded plane (2 shards, prioritized) runs DQN_SHARDED_ITERS.
DQN_ACTOR_ROLLOUTS = {"num_rollout_workers": 2, "num_envs_per_worker": 4,
                      "rollout_fragment_length": 64}
DQN_ACTOR_FLOOR, DQN_ACTOR_MAX_ITERS, DQN_SHARDED_ITERS = 100.0, 80, 10
DQN_ACTOR_PHASES = ("start", "sample", "gather", "update", "publish")


def dqn_actor_algo(**replay):
    cfg = (DQNConfig().environment("CartPole-v1")
           .rollouts(**DQN_ACTOR_ROLLOUTS).training(lr=5e-4)
           .debugging(seed=SEED))
    for k, v in replay.items():
        setattr(cfg, k, v)
    return cfg.build()


def dqn_actor_iterations(algo, tag, iters, floor=None) -> dict:
    """Up to ``iters`` iterations (until the best reward >= ``floor``
    when given), a CUDA event and a host time at each of the iteration's
    marks: the wait for transitions ("sample", host clock), the gather of
    the stacked batches onto the card (host clock), the updates (CUDA
    events, ended by their metrics' read) and the publish (host clock),
    as ms an iteration over the iterations that updated."""
    marks = []

    def mark(name):
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        marks.append((name, event, time.perf_counter()))

    algo.on_phase = mark
    best, met_at, warm, results = float("-inf"), None, [], []
    t0 = time.perf_counter()
    for i in range(iters):
        m = algo.train()
        results.append(m)
        r = m.get("episode_reward_mean", float("nan"))
        if np.isfinite(r):
            best = max(best, r)
        if "total_loss" in m:
            if not np.isfinite(m["total_loss"]):
                raise AssertionError(f"[{tag}] iteration {i}: {m}")
            warm.append(i)
        if i % 20 == 0:
            log(f"[{tag}] iteration {i}: episode_reward_mean {r:.2f} (best "
                f"{best:.2f}), replay {m['replay_size']}, "
                f"{m['time_this_iter_s'] * 1e3:.1f} ms")
        if floor is not None and best >= floor:
            met_at = i
            break
    seconds = time.perf_counter() - t0
    algo.on_phase = None
    torch.cuda.synchronize()
    k = len(DQN_ACTOR_PHASES)
    if [n for n, _, _ in marks] != list(DQN_ACTOR_PHASES) * len(results):
        raise AssertionError(f"[{tag}] phase marks {marks[:k]}")
    rows = [marks[j * k:(j + 1) * k] for j in warm]

    def host_ms(a, b):
        return float(np.mean([(r[b][2] - r[a][2]) * 1e3 for r in rows]))

    steps = sum(m["num_env_steps_sampled_this_iter"] for m in results)
    return {"met_at": met_at, "best": best, "iterations": len(results),
            "seconds": seconds, "results": results, "warm": len(warm),
            "sample_ms": host_ms(0, 1), "gather_ms": host_ms(1, 2),
            "update_ms": float(np.mean([r[2][1].elapsed_time(r[3][1])
                                        for r in rows])),
            "publish_ms": host_ms(3, 4), "env_steps_per_s": steps / seconds}


def dqn_actor_card_holders(algo) -> dict:
    """card_holders' reading over the rollout workers and, on a sharded
    plane, the replay shards: only this process may hold the card."""
    shards = []
    if algo._rb.distributed:
        shards = ray_tpu_torch.get([w.pid.remote() for w in
                                    algo._rb._shard_set.workers],
                                   timeout=GET_S)
    holders = card_holders(algo)
    holders["shards"] = sorted(shards)
    holders["holders"] = sorted(p for p in {*holders["holders"], *shards}
                                if holds_the_card(p))
    if holders["holders"] != [os.getpid()]:
        raise AssertionError(f"[dqn-actor] card holders {holders}")
    return holders


def phase_dqn_actor(card) -> dict:
    """Actor-mode DQN on CartPole-v1, the learner on the card: on the
    local plane to the gate; on a sharded prioritized plane, every sampled
    batch one get_many gather, no payload through the plane's insert path
    (the workers publish, the shards take refs), the TD errors back as
    priorities, finite losses; only this process holds the card."""
    from ray_tpu_torch.object_ref import ObjectRef

    zero_launches()
    algo = dqn_actor_algo()
    try:
        where = devices(algo.learner.module.parameters())
        if where != {"cuda"}:
            raise AssertionError(f"[dqn-actor] learner on {where}")
        local = dqn_actor_iterations(algo, "dqn-actor", DQN_ACTOR_MAX_ITERS,
                                     DQN_ACTOR_FLOOR)
        if local["met_at"] is None:
            raise AssertionError(
                f"[dqn-actor] best reward {local['best']:.2f} < "
                f"{DQN_ACTOR_FLOOR} within {DQN_ACTOR_MAX_ITERS}")
        holders = dqn_actor_card_holders(algo)
    finally:
        algo.stop()
    algo = dqn_actor_algo(replay_num_shards=2, replay_prioritized=True)
    try:
        plane = algo._rb
        counts = collections.Counter()
        insert, insert_refs, sample = (plane.insert, plane.insert_refs,
                                       plane.sample)

        def count_insert(*args, **kwargs):
            counts["payload_inserts"] += 1
            return insert(*args, **kwargs)

        def count_refs(refs, *args, **kwargs):
            if not all(isinstance(r, ObjectRef) for r in refs.values()):
                raise AssertionError(f"[dqn-actor] a payload in {refs}")
            counts["ref_inserts"] += 1
            return insert_refs(refs, *args, **kwargs)

        def count_sample(*args, **kwargs):
            counts["samples"] += 1
            return sample(*args, **kwargs)

        plane.insert, plane.insert_refs, plane.sample = (
            count_insert, count_refs, count_sample)
        sharded = dqn_actor_iterations(algo, "dqn-actor sharded",
                                       DQN_SHARDED_ITERS)
        gathers, sampled = plane.gather_calls, counts["samples"]
        updates = sum(1 for m in sharded["results"] if "total_loss" in m)
        # The priorities the learner sent land on the shards: their mass,
        # all 1.0 a row at insert, moves off the row count.
        deadline = time.monotonic() + GET_S
        while True:
            plane.sample(8)
            st = plane.stats()
            if abs(sum(st["per_shard_mass"]) - st["size"]) > 1.0:
                break
            if time.monotonic() > deadline:
                raise AssertionError(f"[dqn-actor] no priority update "
                                     f"landed: {st}")
            time.sleep(0.2)
        shard_holders = dqn_actor_card_holders(algo)
    finally:
        algo.stop()
    want_samples = updates * algo._actor_updates
    if not (counts["payload_inserts"] == 0 and counts["ref_inserts"]
            == DQN_SHARDED_ITERS * DQN_ACTOR_ROLLOUTS["num_rollout_workers"]
            and sampled == gathers == want_samples
            and updates >= DQN_SHARDED_ITERS - 1
            and st["num_healthy_shards"] == 2):
        raise AssertionError(f"[dqn-actor] sharded plane: {dict(counts)}, "
                             f"{gathers} gathers, {updates} updating "
                             f"iterations, {st}")
    last = sharded["results"][-1]
    note("dqn-actor", met_at=local["met_at"], best=local["best"],
         sample_ms=local["sample_ms"], gather_ms=local["gather_ms"],
         update_ms=local["update_ms"], publish_ms=local["publish_ms"],
         env_steps_per_s=local["env_steps_per_s"],
         sharded_sample_ms=sharded["sample_ms"],
         sharded_gather_ms=sharded["gather_ms"],
         sharded_update_ms=sharded["update_ms"],
         sharded_publish_ms=sharded["publish_ms"])
    log(f"[dqn-actor] {card} | DQN in actor mode, CartPole-v1: 2 CPU "
        f"rollout actors x 4 envs x 64 steps, {algo._actor_updates} "
        f"updates of {algo.config.dqn_batch_size} an iteration on the card "
        f"(fp32): local plane best reward {local['best']:.2f} >= "
        f"{DQN_ACTOR_FLOOR} at iteration {local['met_at']} "
        f"({local['seconds']:.1f} s, {local['env_steps_per_s']:.0f} "
        f"env-steps/s); ms an iteration over the {local['warm']} that "
        f"updated: waiting for transitions {local['sample_ms']:.1f}, the "
        f"gather onto the card {local['gather_ms']:.1f}, updates "
        f"{local['update_ms']:.1f} (CUDA events), publish "
        f"{local['publish_ms']:.1f}; sharded prioritized plane (2 shards) "
        f"{DQN_SHARDED_ITERS} iterations in {sharded['seconds']:.1f} s: "
        f"waiting {sharded['sample_ms']:.1f}, gather "
        f"{sharded['gather_ms']:.1f}, updates {sharded['update_ms']:.1f}, "
        f"publish {sharded['publish_ms']:.1f} ms; {sampled} "
        f"sampled batches in {gathers} get_many gathers, "
        f"{counts['ref_inserts']} fragments inserted as refs and "
        f"{counts['payload_inserts']} as payload, shard masses "
        f"{[round(x, 1) for x in st['per_shard_mass']]} over {st['size']} "
        f"rows (priority updates landed), last loss "
        f"{last['total_loss']:.4f}; card held by {holders['holders']} "
        f"(this process {holders['driver']}; workers {holders['workers']}; "
        f"shards {shard_holders['shards']}: "
        f"{shard_holders['holders']}); flash launches "
        f"{dict(attn.LAUNCHES)}")
    if any(attn.LAUNCHES.values()):
        raise AssertionError(f"[dqn-actor] launched {attn.LAUNCHES}")
    return {"flash": dict(attn.LAUNCHES)}


# ---------------------------------------------------------------------------
# The Serve control plane with LLMServer as a GPU deployment ([serve]), and
# the RLHF loop ([rlhf]), in the runtime's shared cluster
# ---------------------------------------------------------------------------
# [serve]: replicas of GPT-2 small at half a card each (two share it), 16
# replica threads (8 clients plus the controller's metric polls); the
# engine settings of [fp32].  Latency: [fp32]'s 6 requests sent together,
# one warm-up round then SERVE_ROUNDS timed, through the engine in this
# process, the handle and HTTP.  Autoscaling: a bf16 redeployment driven
# by SERVE_CLIENTS saturating threads, on autoscale_metric (in-flight work
# per decode slot).
SERVE_ENGINE = {"max_slots": 4}
SERVE_GPUS = 0.5
SERVE_OPTIONS = {"num_gpus": SERVE_GPUS, "max_concurrency": 16}
SERVE_ROUNDS = 1
SERVE_CLIENTS = 8
SERVE_SCALE_S = 60.0  # the bound of the scale-up and of the scale-down
SERVE_AUTOSCALING = {"min_replicas": 1, "max_replicas": 2,
                     "metric_method": "autoscale_metric",
                     "target_num_ongoing_requests_per_replica": 1.0,
                     "look_back_polls": 2}


class FlashServer(LLMServer):
    """``LLMServer`` that also reports its process's flash launches."""

    def flash_launches(self) -> dict:
        return dict(attn.LAUNCHES)


def percentile_ms(seconds, q) -> float:
    return float(np.percentile(np.asarray(seconds) * 1e3, q))


def timed_requests(call, requests, rounds) -> tuple:
    """``requests`` sent together through ``call`` (request -> tokens):
    one warm-up round, then ``rounds`` timed.  Returns (the last round's
    tokens, every timed request's seconds, the timed wall seconds)."""
    def one(r):
        t = time.perf_counter()
        out = call(r)
        return out, time.perf_counter() - t

    latencies = []
    with concurrent.futures.ThreadPoolExecutor(len(requests)) as pool:
        list(pool.map(one, requests))
        t0 = time.perf_counter()
        for _ in range(rounds):
            res = list(pool.map(one, requests))
            latencies += [s for _, s in res]
        wall = time.perf_counter() - t0
    return [o for o, _ in res], latencies, wall


def post_json(port, name, payload) -> dict:
    import urllib.request

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/{name}",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=GET_S) as resp:
        return json.loads(resp.read())


def check_tokens(tag, requests, got, want):
    for r, g, w in zip(requests, got, want):
        if g != w:
            i = next(j for j, (a, b) in enumerate(zip(g, w)) if a != b)
            raise AssertionError(
                f"[serve] {tag} != NaiveLM for prompt length "
                f"{len(r['tokens'])} at token {i}: {g[i]} vs {w[i]}")


def replica_launches(dep) -> dict:
    total = collections.Counter()
    for r in dep._replicas:
        total.update(ray_tpu_torch.get(
            r.handle_request.remote("flash_launches", (), {}),
            timeout=GET_S))
    return dict(total)


def phase_serve(card, requests, want) -> dict:
    """LLMServer as a Serve deployment at GPT-2 small's width: fp32
    replicas at half a card answer [fp32]'s requests through
    ``generate_many``, the handle and HTTP with NaiveLM(1024)'s tokens;
    then a bf16 redeployment scales 1 -> 2 -> 1 under a saturating client
    on ``autoscale_metric``.  No engine path launches a flash kernel."""
    from ray_tpu_torch import serve
    from ray_tpu_torch.serve import generate_many
    from ray_tpu_torch.util.metrics import prometheus_text

    get = ray_tpu_torch.get
    new_tokens = sum(r["max_new_tokens"] for r in requests)
    out = {}
    zero_launches()
    server = LLMServer("gpt2", GPT2_SMALL_FP32, seed=SEED, **SERVE_ENGINE)
    try:
        got, lat, wall = timed_requests(lambda r: server(r)["tokens"],
                                        requests, SERVE_ROUNDS)
    finally:
        server.drain()
    check_tokens("the engine in this process", requests, got, want)
    out["engine"] = (lat, wall)
    try:
        t0 = time.perf_counter()
        dep = serve.deployment(FlashServer, name="llm",
                               ray_actor_options=SERVE_OPTIONS)
        handle = serve.run(dep.bind("gpt2", GPT2_SMALL_FP32, SEED,
                                    **SERVE_ENGINE))
        get(handle.method("stats").remote(), timeout=GET_S)
        deploy_s = time.perf_counter() - t0
        prompts = [r["tokens"] for r in requests]
        got = generate_many(handle, prompts, NEW_TOKENS, timeout=GET_S)
        check_tokens("generate_many", requests, got, want)
        got, lat, wall = timed_requests(
            lambda r: get(handle.remote(r), timeout=GET_S)["tokens"],
            requests, SERVE_ROUNDS)
        check_tokens("the handle", requests, got, want)
        out["handle"] = (lat, wall)
        port = serve.start_http_proxy()
        got, lat, wall = timed_requests(
            lambda r: post_json(port, "llm", r)["result"]["tokens"],
            requests, SERVE_ROUNDS)
        check_tokens("HTTP", requests, got, want)
        out["http"] = (lat, wall)
        launches = collections.Counter(replica_launches(dep))
        log(f"[serve] {card} | fp32 GPT-2 small as a deployment "
            f"(num_gpus={SERVE_GPUS}, deployed and ready in {deploy_s:.2f} "
            f"s): generate_many, the handle and HTTP token-identical to "
            f"NaiveLM(width=1024) on {len(requests)} requests")
        for path, (lat, wall) in out.items():
            note(f"serve-{path}", p50_ms=percentile_ms(lat, 50),
                 p99_ms=percentile_ms(lat, 99),
                 tokens_per_s=SERVE_ROUNDS * new_tokens / wall)
            log(f"[serve] {card} | {path}: {len(lat)} requests ("
                f"{len(requests)} together x {SERVE_ROUNDS}), latency p50 "
                f"{percentile_ms(lat, 50):.1f} ms p99 "
                f"{percentile_ms(lat, 99):.1f} ms, "
                f"{SERVE_ROUNDS * new_tokens / wall:.1f} tokens/s")

        # bf16, autoscaled on autoscale_metric under a saturating client.
        kw16 = {**GPT2_SMALL_FP32, "dtype": torch.bfloat16}
        dep16 = serve.deployment(FlashServer, name="llm",
                                 ray_actor_options=SERVE_OPTIONS,
                                 autoscaling_config=SERVE_AUTOSCALING)
        handle = serve.run(dep16.bind("gpt2", kw16, SEED, **SERVE_ENGINE))
        get(handle.remote(requests[0]), timeout=GET_S)
        stop, done = threading.Event(), collections.Counter()
        done_lock = threading.Lock()

        def client(i):
            k = i
            while not stop.is_set():
                r = requests[k % len(requests)]
                get(handle.remote(r), timeout=GET_S)
                with done_lock:
                    done["requests"] += 1
                    done["tokens"] += r["max_new_tokens"]
                k += 1

        pool = concurrent.futures.ThreadPoolExecutor(SERVE_CLIENTS)
        t_load = time.perf_counter()
        clients = [pool.submit(client, i) for i in range(SERVE_CLIENTS)]
        try:
            time.sleep(1.0)
            metric = get(dep16._replicas[0].handle_request.remote(
                "autoscale_metric", (), {}), timeout=GET_S)
            while handle.num_replicas < 2:
                if time.perf_counter() - t_load > SERVE_SCALE_S:
                    raise AssertionError(
                        f"[serve] no scale-up within {SERVE_SCALE_S} s "
                        f"(autoscale_metric {metric})")
                time.sleep(0.05)
            t_up = time.perf_counter()
            second = dep16._replicas[-1]
            first_stats = get(second.handle_request.remote(
                "stats", (), {}), timeout=GET_S)
            cold_s = time.perf_counter() - t_up
            while get(second.handle_request.remote("stats", (), {}),
                      timeout=GET_S)["completed"] < 1:
                time.sleep(0.1)
            launches.update(replica_launches(dep16))
            metrics = [get(r.handle_request.remote(
                "autoscale_metric", (), {}), timeout=GET_S)
                for r in dep16._replicas]
        finally:
            stop.set()
            for c in clients:
                c.result(timeout=GET_S)
            pool.shutdown()
        load_s = time.perf_counter() - t_load
        t_stop = time.perf_counter()
        while handle.num_replicas > 1:
            if time.perf_counter() - t_stop > SERVE_SCALE_S:
                raise AssertionError(f"[serve] no scale-down within "
                                     f"{SERVE_SCALE_S} s")
            time.sleep(0.05)
        down_s = time.perf_counter() - t_stop
        names = sorted({line.split("{")[0].split(" ")[0]
                        for line in prometheus_text().splitlines()
                        if line.startswith("serve_")})
    finally:
        serve.shutdown()
    launches.update(attn.LAUNCHES)
    launches = {name: launches.get(name, 0) for name in attn.LAUNCHES}
    note("serve-autoscale", scale_up_s=t_up - t_load, cold_s=cold_s,
         scale_down_s=down_s, metric=metric,
         tokens_per_s=done["tokens"] / load_s)
    log(f"[serve] {card} | bf16 with autoscaling_config "
        f"{SERVE_AUTOSCALING}: {SERVE_CLIENTS} saturating clients; "
        f"autoscale_metric {metric:.2f} on one replica; 1 -> 2 replicas "
        f"{t_up - t_load:.2f} s after the load began; the second replica's "
        f"cold start (its first answer after it joined: spawn, imports, "
        f"CUDA context, GPT-2 small) {cold_s:.2f} s; autoscale_metric "
        f"then {[round(m, 2) for m in metrics]}; {done['requests']} "
        f"requests, {done['tokens'] / load_s:.1f} tokens/s over "
        f"{load_s:.2f} s; 2 -> 1 replica {down_s:.2f} s after the load "
        f"stopped; the second replica's first stats at weight version "
        f"{first_stats['weight_version']}")
    log(f"[serve] serve_* metrics in prometheus_text(): {names}")
    log(f"[serve] flash launches (this process and every replica) "
        f"{launches}")
    want_names = {"serve_tokens", "serve_requests", "serve_inflight_requests",
                  "serve_batch_occupancy", "serve_kv_pages_in_use",
                  "serve_kv_pages_free", "serve_tokens_per_s",
                  "serve_queue_wait_s_count"}
    if not want_names <= set(names):
        raise AssertionError(f"[serve] metrics missing: "
                             f"{sorted(want_names - set(names))}")
    if any(launches.values()):
        raise AssertionError(f"[serve] an engine path launched {launches}")
    return {"serve": launches}


# [rlhf]: bench_rlhf's loop (bench.py:968-1060) at GPT-2 small's width in
# bf16: 16 prompts of 960 tokens from the seed, 64 new tokens (so pad_to
# is 1024 and every forward and backward of the learner runs the flash
# kernels), 16 rollouts a step, 2 epochs of 2 minibatches of 8, the
# target-token reward, the engine a RemoteEngine actor at half a card.
# One warm-up step and RLHF_TIMED_STEPS timed, with overlap and without.
# lr 1e-5: the toy bench's 1e-2 is for its 2-layer width-64 model.
RLHF_PROMPTS, RLHF_PROMPT_LEN, RLHF_NEW, RLHF_TARGET = 16, 960, 64, 7
RLHF_VOCAB = 50257
RLHF_CONFIG = {"rollouts_per_step": 16, "max_new_tokens": RLHF_NEW,
               "num_sgd_iter": 2, "minibatch_size": 8, "lr": 1e-5,
               "entropy_coeff": 0.001, "seed": SEED}
RLHF_ENGINE = {"max_slots": 16, "page_size": 16, "max_ctx": 1024}
RLHF_GPUS = 0.5
RLHF_TIMED_STEPS = 2
# Flash launches of a step, E epochs of M minibatches: the advantage
# forward and each minibatch's forward run 12 layers of the forward; each
# minibatch's backward 12 of dq and of dkv.
RLHF_LAYERS = 12
# The fp32 cut: GPT-2 small's width at 2 layers, 4 rollouts of the same
# prompts; its update in 2 epochs of 2 minibatches of 2.  Behavior
# logprobs (the engine's decode, cached attention) against the learner's
# full-context forward (the flash forward) at tests/test_rlhf.py:166's
# tolerance.  The card's learner against the CPU's at [train-fp32]'s
# tolerances: the first minibatch's loss terms and the whole update's
# loss metrics within FP32_LOSS_RTOL of the largest term (the entropy,
# ~ln V: the total is a sum of terms that cancel), and the first
# minibatch's gradient of each parameter within FP32_GRAD_REL in relative
# norm.  The update itself is a reading: Adam divides each gradient by
# its running RMS, so where successive minibatches' gradients cancel the
# update's relative error exceeds the gradients' (2.5e-4 on ln_f.weight
# on an H100 80GB HBM3); the K third of the fused QKV
# biases is left out of it, since softmax is invariant to a shift of
# every key by one vector, so that part's exact gradient is 0 and Adam
# scales the rounding noise that stands in for it to as much as lr.
RLHF_CUT_LAYERS, RLHF_CUT_ROLLOUTS, RLHF_CUT_MINIBATCH = 2, 4, 2
LOGP_RTOL, LOGP_ATOL = 1e-4, 1e-5


def rlhf_prompts() -> list:
    rng = np.random.default_rng(SEED)
    return rng.integers(0, RLHF_VOCAB, size=(RLHF_PROMPTS, RLHF_PROMPT_LEN)
                        ).tolist()


def actor_critic(config_kw, device=None):
    """GPT2WithValue whose lm holds build_model(config_kw, SEED)'s
    weights (the engine's version 0), its value head from the seed."""
    from ray_tpu_torch.models import GPT2WithValue

    lm = build_model("gpt2", config_kw, seed=SEED, device="cpu")
    model = GPT2WithValue(lm.config).init_from_lm(
        lm.state_dict(), torch.Generator().manual_seed(SEED))
    return model if device is None else model.to(device)


def recomputed_logp_error(model, rollouts) -> tuple:
    """The learner's log-probs of the sampled tokens (one full-context
    forward of the padded batch) against the engine's behavior
    log-probs: (max |d|, max of |d| - rtol |want| - atol)."""
    from ray_tpu_torch.rllib.algorithms.rlhf import sequence_logprobs
    from ray_tpu_torch.rllib.evaluation.sequence_batch import SequenceBatch

    batch = SequenceBatch.from_rollouts(rollouts, 1024)
    device = next(model.parameters()).device
    tokens = torch.from_numpy(batch.tokens).long().to(device)
    with torch.no_grad():
        logits, _ = model(tokens)
        lp = sequence_logprobs(logits, tokens).cpu().numpy()
    mask = batch.response_mask[:, 1:] > 0
    got, want = lp[mask], batch.behavior_logp[:, 1:][mask]
    d = np.abs(got - want)
    return float(d.max()), float((d - LOGP_RTOL * np.abs(want)
                                  - LOGP_ATOL).max())


def rlhf_run(card, overlap, prompts) -> dict:
    from ray_tpu_torch.rllib.algorithms.rlhf import (
        RLHFConfig,
        RLHFLoop,
        RemoteEngine,
        target_token_reward,
    )
    from ray_tpu_torch.rllib.evaluation.sequence_batch import (
        SequenceRollout,
    )

    kw16 = {**GPT2_SMALL_FP32, "dtype": torch.bfloat16}
    t0 = time.perf_counter()
    model = actor_critic(kw16)
    eng = RemoteEngine("gpt2", kw16, SEED, num_gpus=RLHF_GPUS, **RLHF_ENGINE)
    out = {}
    loop = None
    try:
        if overlap:
            # The first minibatch's worth of rollouts: behavior log-probs
            # against the learner's recomputation (bf16: a reading).
            recs = eng.generate_rollouts(
                prompts[:RLHF_CONFIG["minibatch_size"]], RLHF_NEW,
                sampling=[SamplingParams(temperature=1.0, seed=SEED + i)
                          for i in range(RLHF_CONFIG["minibatch_size"])],
                timeout=GET_S)
            out["logp_max_err"], _ = recomputed_logp_error(
                model.to(ray_tpu_torch.resolve_device()),
                [SequenceRollout.from_engine(r) for r in recs])
        loop = RLHFLoop(eng, model, prompts,
                        target_token_reward(RLHF_TARGET),
                        RLHFConfig(overlap=overlap, **RLHF_CONFIG))
        out["setup_s"] = time.perf_counter() - t0
        lm_bytes = state_bytes(loop.learner.lm_state_dict())
        steps = []
        for _ in range(1 + RLHF_TIMED_STEPS):
            zero_launches()
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            m = loop.step()
            m["step_s"] = time.perf_counter() - t
            m["launches"] = dict(attn.LAUNCHES)
            m["engine_version"] = eng.weight_version
            m["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
            steps.append(m)
        out["engine_stats"] = eng.stats()
        out["stamps"] = np.asarray(eng.recent_step_stamps())
        out["stale"] = loop.stale_batches_dropped
    finally:
        if loop is not None:
            loop.close()
        eng.close()
        del model, loop
        torch.cuda.empty_cache()
    out["steps"], out["lm_mib"] = steps, lm_bytes / 2 ** 20
    return out


def rlhf_fp32_cut(card, prompts) -> dict:
    """The fp32 cut on the card: the engine's behavior log-probs against
    the learner's recomputation, and the learner against the CPU's on the
    same batch: the first minibatch's loss and gradients, then one whole
    update's loss metrics."""
    from ray_tpu_torch.rllib.algorithms.rlhf import (
        SeqPPOLearner,
        sequence_ppo_loss,
        target_token_reward,
    )
    from ray_tpu_torch.rllib.evaluation.sequence_batch import (
        SequenceBatch,
        SequenceRollout,
    )

    kw = {**GPT2_SMALL_FP32, "num_layers": RLHF_CUT_LAYERS}
    n = RLHF_CUT_ROLLOUTS
    eng = LLMEngine(build_model("gpt2", kw, seed=SEED), **RLHF_ENGINE)
    try:
        recs = eng.generate_rollouts(
            prompts[:n], RLHF_NEW,
            sampling=[SamplingParams(temperature=1.0, seed=SEED + i)
                      for i in range(n)], timeout=GET_S)
    finally:
        eng.close()
    rollouts = [SequenceRollout.from_engine(r) for r in recs]
    reward = target_token_reward(RLHF_TARGET)
    for r in rollouts:
        r.reward = reward(r.prompt, r.tokens)
    zero_launches()
    card_device = ray_tpu_torch.resolve_device()
    logp_err, logp_excess = recomputed_logp_error(
        actor_critic(kw, card_device), rollouts)
    fwd = attn.LAUNCHES["flash_fwd"]
    batch = SequenceBatch.from_rollouts(rollouts, 1024).as_dict()
    losses, grads, metrics, updates = {}, {}, {}, {}
    for key, device in (("cuda", card_device), ("cpu", "cpu")):
        model = actor_critic(kw)
        hidden = model.config.hidden_size
        start = {k: v.clone() for k, v in model.state_dict().items()}
        learner = SeqPPOLearner(
            model, batch_size=n, pad_to=1024,
            minibatch_size=RLHF_CUT_MINIBATCH,
            **{k: RLHF_CONFIG[k] for k in ("num_sgd_iter", "lr",
                                           "entropy_coeff", "seed")},
            device=device)
        flat = learner.sgd_batch(batch)
        loss, aux = sequence_ppo_loss(
            learner.model, {k: v[:RLHF_CUT_MINIBATCH] for k, v in
                            flat.items()},
            clip_param=0.2, vf_coeff=0.5,
            entropy_coeff=RLHF_CONFIG["entropy_coeff"])
        params = dict(learner.model.named_parameters())
        losses[key] = {"total": loss.item(),
                       **{k: v.item() for k, v in aux.items()}}
        grads[key] = dict(zip(params, (g.cpu() for g in torch.autograd.grad(
            loss, list(params.values())))))
        metrics[key] = learner.update(batch)
        updates[key] = {k: v.detach().cpu() - start[k]
                        for k, v in model.state_dict().items()}
        del model, learner, flat, loss
    torch.cuda.empty_cache()

    def rel_norm(a, b):
        return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()

    grad_rel = {k: rel_norm(g, grads["cpu"][k])
                for k, g in grads["cuda"].items()}
    update_rel = {}
    for name, u in updates["cuda"].items():
        ref = updates["cpu"][name]
        if name.endswith("attn_qkv.bias"):  # drop the K third (see above)
            u = torch.cat([u[:hidden], u[2 * hidden:]])
            ref = torch.cat([ref[:hidden], ref[2 * hidden:]])
        update_rel[name] = rel_norm(u, ref)
    scale = max(1.0, abs(losses["cpu"]["entropy"]))
    loss_err = max(abs(losses["cuda"][k] - losses["cpu"][k])
                   for k in losses["cpu"]) / scale
    metric_err = max(abs(metrics["cuda"][k] - metrics["cpu"][k])
                     for k in metrics["cpu"]) / scale
    worst_g = max(grad_rel, key=grad_rel.get)
    worst_u = max(update_rel, key=update_rel.get)
    out = {"logp_err": logp_err, "loss_err": loss_err,
           "grad_rel": grad_rel[worst_g], "metric_err": metric_err,
           "update_rel": update_rel[worst_u]}
    log(f"[rlhf] {card} | fp32 cut ({RLHF_CUT_LAYERS} layers at GPT-2 "
        f"small's width, {n} rollouts of {RLHF_PROMPT_LEN} + {RLHF_NEW}): "
        f"the engine's behavior log-probs against the learner's "
        f"recomputation (flash forward, {fwd} launches): max |d| "
        f"{logp_err:.3g} (bound {LOGP_ATOL} + {LOGP_RTOL} |logp|); the "
        f"first minibatch card vs CPU: loss terms {losses['cuda']} vs "
        f"{losses['cpu']} (worst |d| {loss_err:.3g} of the largest term, "
        f"bound {FP32_LOSS_RTOL}), worst gradient relative norm error "
        f"{grad_rel[worst_g]:.3g} ({worst_g}; bound {FP32_GRAD_REL}); one "
        f"update ({RLHF_CONFIG['num_sgd_iter']} epochs x "
        f"{n // RLHF_CUT_MINIBATCH} minibatches) card vs CPU: loss metrics "
        f"worst |d| {metric_err:.3g} of the largest term (bound "
        f"{FP32_LOSS_RTOL}); the update's worst relative norm error "
        f"{update_rel[worst_u]:.3g} ({worst_u}; a reading: Adam divides "
        f"each gradient by its running RMS)")
    if logp_excess > 0:
        raise AssertionError(f"[rlhf] behavior log-probs differ: max |d| "
                             f"{logp_err}")
    if fwd != RLHF_CUT_LAYERS:
        raise AssertionError(f"[rlhf] the recomputation launched {fwd}")
    if not (loss_err <= FP32_LOSS_RTOL and metric_err <= FP32_LOSS_RTOL):
        raise AssertionError(f"[rlhf] losses differ: {losses}, {metrics}")
    if not grad_rel[worst_g] <= FP32_GRAD_REL:
        raise AssertionError(f"[rlhf] gradients differ: {grad_rel}")
    return out


def phase_rlhf(card) -> dict:
    """RLHFLoop at GPT-2 small's width in bf16 with a RemoteEngine on the
    card, overlapped and drain-then-train; every step advances the weight
    version by one and launches the three flash kernels as many times as
    its epochs and minibatches say; then the fp32 cut."""
    prompts = rlhf_prompts()
    e = RLHF_CONFIG["num_sgd_iter"]
    m = RLHF_CONFIG["rollouts_per_step"] // RLHF_CONFIG["minibatch_size"]
    want = {"flash_fwd": RLHF_LAYERS * (1 + e * m),
            "flash_dq": RLHF_LAYERS * e * m,
            "flash_dkv": RLHF_LAYERS * e * m}
    runs = {tag: rlhf_run(card, overlap, prompts)
            for tag, overlap in (("overlap", True), ("drain", False))}
    launches = collections.Counter()
    for tag, run in runs.items():
        steps, timed = run["steps"], run["steps"][1:]
        versions = [s["weight_version"] for s in steps]
        if versions != list(range(1, len(steps) + 1)) or \
                [s["engine_version"] for s in steps] != versions:
            raise AssertionError(f"[rlhf] {tag}: versions {versions}, the "
                                 f"engine's "
                                 f"{[s['engine_version'] for s in steps]}")
        for s in steps:
            if s["launches"] != want:
                raise AssertionError(f"[rlhf] {tag}: a step launched "
                                     f"{s['launches']}, expected {want}")
            if not np.isfinite(s["total_loss"]):
                raise AssertionError(f"[rlhf] {tag}: loss {s['total_loss']}")
            launches.update(s["launches"])
        wall = sum(s["step_s"] for s in timed)
        tokens = sum(s["response_tokens"] for s in timed)
        run["tokens_per_s"] = tokens / wall
        per_step = {
            "step_ms": 1e3 * wall / len(timed),
            "gen_ms": 1e3 * float(np.mean([s["gen_window"][1]
                                            - s["gen_window"][0]
                                            for s in timed])),
            "sgd_ms": 1e3 * float(np.mean([s["sgd_seconds"]
                                            for s in timed])),
            "swap_s": float(np.mean([s["swap_seconds"]
                                     + s["swap_put_seconds"]
                                     for s in timed])),
            "put_s": float(np.mean([s["swap_put_seconds"]
                                    for s in timed])),
            "busy": float(np.mean([s["gen_busy_frac_during_sgd"]
                                   for s in timed])),
            # The engine's decode steps (stamped with CLOCK_MONOTONIC in
            # its process) that ended inside each SGD window.
            "decode_in_sgd": float(np.mean([
                ((run["stamps"] >= s["sgd_window"][0])
                 & (run["stamps"] <= s["sgd_window"][1])).sum()
                for s in timed])),
            # SGD windows during which this process had a generate call
            # in flight (the stage thread's call to its return), over the
            # timed steps but the last, whose next batch is never taken.
            "gen_call_in_sgd": sum(
                any(g["gen_window"][0] <= s["sgd_window"][1]
                    and g["gen_window"][1] >= s["sgd_window"][0]
                    for g in steps) for s in timed[:-1]),
            "peak_gib": max(s["peak_gib"] for s in steps)}
        run.update(per_step)
        note(f"rlhf-{tag}", tokens_per_s=run["tokens_per_s"],
             stale=run["stale"], **per_step)
        log(f"[rlhf] {card} | {tag}: setup {run['setup_s']:.1f} s; "
            f"{len(timed)} timed steps of {RLHF_CONFIG['rollouts_per_step']}"
            f" rollouts ({RLHF_PROMPT_LEN} + {RLHF_NEW} tokens, pad_to "
            f"1024): {per_step['step_ms']:.0f} ms a step; generation "
            f"{per_step['gen_ms']:.0f} ms, SGD {per_step['sgd_ms']:.0f} ms,"
            f" swap {per_step['swap_s']:.3f} s ({per_step['put_s']:.3f} s of"
            f" it the put of {run['lm_mib']:.1f} MiB) a step; "
            f"gen_busy_frac_during_sgd {per_step['busy']:.3f} "
            f"({per_step['decode_in_sgd']:.1f} engine decode steps ended "
            f"in an SGD window; a generate call in flight during "
            f"{per_step['gen_call_in_sgd']} of {len(timed) - 1} SGD "
            f"windows); "
            f"{run['tokens_per_s']:.1f} response tokens/s; stale batches "
            f"dropped {run['stale']}; learner peak "
            f"{per_step['peak_gib']:.2f} GiB; rewards "
            f"{[round(s['reward_mean'], 3) for s in steps]}; weight "
            f"versions {[s['weight_version'] for s in steps]} (the "
            f"engine's agree); flash launches a step {steps[0]['launches']}")
    log(f"[rlhf] {card} | bf16 behavior log-probs against the learner's "
        f"recomputation, one minibatch: max |d| "
        f"{runs['overlap']['logp_max_err']:.3g} (a reading); response "
        f"tokens/s with overlap {runs['overlap']['tokens_per_s']:.1f}, "
        f"without {runs['drain']['tokens_per_s']:.1f}")
    cut = rlhf_fp32_cut(card, prompts)
    note("rlhf", logp_bf16_max=runs["overlap"]["logp_max_err"],
         **{f"cut_{k}": v for k, v in cut.items()})
    return {"rlhf": dict(launches)}


def train_steps(b, length, iters, seed=SEED, batches=None, zero=None,
                groups=None, config_kw=None) -> dict:
    """GPT-2 small steps at B x S: bf16 compute over fp32 parameters,
    adamw(3e-4), on the ids ``batches`` yields (tensors on the card), or
    the same seeded ids every step (bench.py's synthetic branch).  One
    warm-up step, then ``iters`` steps ended by one device read of the
    last loss (bench.py:143-148).  The counts are zeroed just before each
    window and read just after it.  ``[train]`` runs this in the process,
    ``[actor-train]`` in a GPU actor, ``[trainer]`` in TorchTrainer's
    worker on the dataset shard's batches, ``[zero]`` there too with
    ``zero`` (``zero_train_step``'s settings: the step through
    ``compile_zero_step``) and ``groups`` (one more step, on the next
    batch, profiled by those kernel groups); ``[moe-train]`` with
    ``config_kw`` (more GPT2Config fields: the MoE)."""
    t0 = time.perf_counter()
    model = build_model("gpt2", {"tiny": False,
                                 "max_position_embeddings": max(1024, length),
                                 **(config_kw or {})},
                        seed=seed)
    cfg = model.config
    info = None
    if zero is None:
        step = make_train_step(model, adamw(model.parameters(), 3e-4),
                               gpt2_loss_fn)
    else:
        zs = zero_train_step(model, **zero)
        step, info = zs.step, zs.info
    build_s = time.perf_counter() - t0
    if batches is None:
        ids = torch.from_numpy(np.random.default_rng(seed).integers(
            0, cfg.vocab_size, size=(b, length))).to("cuda")
        batches = itertools.repeat(ids)
    zero_launches()
    t0 = time.perf_counter()
    first = step({"input_ids": next(batches)}).item()
    warm_s = time.perf_counter() - t0
    warm = dict(attn.LAUNCHES)
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    t0 = time.perf_counter()
    losses = [step({"input_ids": next(batches)}) for _ in range(iters)]
    losses[-1].item()  # the one device read: the barrier
    seconds = time.perf_counter() - t0
    timed = dict(attn.LAUNCHES)
    out = {"losses": [first] + torch.stack(losses).tolist(),
           "seconds": seconds, "warm_launches": warm, "launches": timed,
           "n_params": sum(p.numel() for p in model.parameters()),
           "iters": iters, "build_s": build_s, "warm_s": warm_s,
           "num_layers": cfg.num_layers, "hidden_size": cfg.hidden_size,
           "config": {f: getattr(cfg, f) for f in (
               "num_layers", "num_heads", "hidden_size", "vocab_size",
               "scan_layers_threshold")},
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "info": info}
    if groups is not None:
        ids = next(batches)
        out["profile"] = profile_device(lambda: step({"input_ids": ids}),
                                        groups)
    del model, step, losses
    torch.cuda.empty_cache()
    return out


def train_rates(run, b, length, iters) -> tuple:
    """(tokens/s, MFU, FLOPs a token) of one ``train_steps`` run, as
    bench.py reckons them (:151-153): (6 N + 12 layers width S) FLOPs a
    token over the bf16 peak."""
    flops_per_token = (6 * run["n_params"] + 12 * run["num_layers"]
                       * run["hidden_size"] * length)
    tokens_per_s = iters * b * length / run["seconds"]
    mfu = tokens_per_s * flops_per_token / PEAK_OPS_PER_S[torch.bfloat16]
    return tokens_per_s, mfu, flops_per_token


def check_train(tag, run, b, length, iters) -> tuple:
    """Hold one ``train_steps`` run to the path's rules: 12 launches of
    each kernel a step, finite losses, the first near ln 50257, a falling
    loss.  Returns (tokens/s, MFU, FLOPs a token)."""
    per_step = {name: run["num_layers"] for name in attn.LAUNCHES}
    if run["warm_launches"] != per_step:
        raise AssertionError(f"{tag} warm-up step launched "
                             f"{run['warm_launches']}, expected {per_step}")
    want = {name: n * iters for name, n in per_step.items()}
    if run["launches"] != want:
        raise AssertionError(f"{tag}: {iters} steps launched "
                             f"{run['launches']}, expected {want}")
    losses = run["losses"]
    first, last = losses[0], losses[-1]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{tag}: losses {losses}")
    if abs(first - LN_VOCAB) > FIRST_LOSS_SLACK:
        raise AssertionError(f"{tag}: first loss {first:.4f} not within "
                             f"{FIRST_LOSS_SLACK} of ln 50257 = "
                             f"{LN_VOCAB:.4f}")
    if not last < first:
        raise AssertionError(f"{tag}: loss did not fall ({first:.4f} -> "
                             f"{last:.4f})")
    return train_rates(run, b, length, iters)


def phase_train(card) -> dict:
    """GPT-2 small training steps at the JAX bench's two shapes
    (``train_steps``).  Returns each shape's run: its losses, time and the
    launches of each kernel in the timed window."""
    runs = {}
    routes = {name: r["bfloat16"] for name, r in routes_by_dtype().items()}
    for b, length, iters in TRAIN_SHAPES:
        tag = f"B={b} S={length}"
        run = train_steps(b, length, iters)
        tokens_per_s, mfu, flops_per_token = check_train(
            f"[train] {tag}", run, b, length, iters)
        per_step = {name: run["num_layers"] for name in attn.LAUNCHES}
        note("train", **{f"{tag} ms_per_step": run["seconds"] / iters * 1e3,
                         f"{tag} tokens_per_s": tokens_per_s,
                         f"{tag} mfu": mfu})
        log(f"[train] {card} | GPT-2 small {tag} bf16/fp32-params adamw: "
            f"{iters} steps in {run['seconds']:.3f} s = "
            f"{run['seconds'] / iters * 1e3:.1f} ms/step, "
            f"{tokens_per_s:.0f} tokens/s, MFU {mfu:.4f} "
            f"(N={run['n_params']}, {flops_per_token / 1e9:.3f} GFLOP/token, "
            f"bf16 peak); loss "
            f"{' '.join(f'{x:.4f}' for x in run['losses'])}; launches per "
            f"step {per_step}, bf16 routes {routes}; peak memory "
            f"{run['peak_gib']:.1f} GiB")
        runs[tag] = run
    return runs


def phase_train_fp32(tag="train-fp32", kind="gpt2",
                     kw=(("tiny", False),), loss_fn=gpt2_loss_fn):
    """One fp32 step of a 2-layer ``kind`` model at its full width (GPT-2
    small, or llama_1b for ``[llama-train-fp32]``), B=1, S=1024, TF32 off:
    on the card (attention through the three kernels) and on the CPU copy
    of the same weights (mha_attention takes the plain path by device).
    Loss and every parameter's gradient compared."""
    kw = {**dict(kw), "dtype": torch.float32, "num_layers": FP32_STEP_LAYERS}
    losses, grads = {}, {}
    for device in ("cuda", "cpu"):
        model = build_model(kind, kw, seed=SEED, device=device)
        ids = np.random.default_rng(SEED + 4).integers(
            0, model.config.vocab_size, size=(1, 1024))
        zero_launches()
        loss = loss_fn(model, {"input_ids": torch.from_numpy(ids).to(
            next(model.parameters()).device)})
        loss.backward()
        if device == "cuda":
            want = {name: FP32_STEP_LAYERS for name in attn.LAUNCHES}
            if attn.LAUNCHES != want:
                raise AssertionError(f"[{tag}] launches {attn.LAUNCHES}, "
                                     f"expected {want}")
        losses[device] = loss.item()
        grads[device] = {n: p.grad.detach().cpu()
                         for n, p in model.named_parameters()}
        del model, loss
    torch.cuda.empty_cache()
    rel = {n: ((g - grads["cpu"][n]).norm()
               / grads["cpu"][n].norm().clamp_min(1e-30)).item()
           for n, g in grads["cuda"].items()}
    worst = max(rel, key=rel.get)
    loss_rel = abs(losses["cuda"] - losses["cpu"]) / abs(losses["cpu"])
    note(tag, loss_rel=loss_rel, worst_grad_rel=rel[worst])
    log(f"[{tag}] 2-layer {kind} B=1 S=1024 fp32 at full width, card vs "
        f"CPU: loss {losses['cuda']:.7f} vs {losses['cpu']:.7f} (rel "
        f"{loss_rel:.3g}, bound {FP32_LOSS_RTOL}); worst gradient relative "
        f"norm error {rel[worst]:.3g} ({worst}; bound {FP32_GRAD_REL}) "
        f"over {len(rel)} parameters")
    if not loss_rel <= FP32_LOSS_RTOL:
        raise AssertionError(f"[{tag}] losses differ")
    if not rel[worst] <= FP32_GRAD_REL:
        raise AssertionError(f"[{tag}] gradients differ: {rel}")


# ---------------------------------------------------------------------------
# The Llama family at llama_1b's shape (the TinyLlama-1.1B config)
# ---------------------------------------------------------------------------
# LlamaConfig.llama_1b's fields (checked against it), as build_model takes
# them: 22 layers, width 2048, 32 query heads over 4 K/V heads, SwiGLU
# 5632, vocab 32000, context 2048.
LLAMA_1B = {"tiny": False, "vocab_size": 32000,
            "max_position_embeddings": 2048, "num_layers": 22,
            "num_heads": 32, "num_kv_heads": 4, "hidden_size": 2048,
            "intermediate_size": 5632}
# [llama-serve]: 8 requests, prompts of 64-1536 tokens from a seed (one
# past 1024 at least), 64 greedy tokens each, 8 slots, max_ctx 2048; the
# fp32 oracle leg: 2 prompts (one past 1024) x 16 tokens against
# NaiveLM(width=2048).
LLAMA_USERS, LLAMA_NEW, LLAMA_PROMPT_LENS = 8, 64, (64, 1537)
LLAMA_LONG_PROMPT = 1024
LLAMA_ENGINE = {"max_slots": 8, "page_size": 16, "max_ctx": 2048}
LLAMA_ORACLE_LENS, LLAMA_ORACLE_NEW = (480, 1200), 16
# K and V of 22 layers x 4 K/V heads x 64 in bf16: the GQA page size of a
# token (180,224 bytes at 32 heads).
LLAMA_KV_BYTES = 22 * 2 * 4 * 64 * 2
# [llama-train]: bench_llama_3d's full shape (bench.py:437-438), B=8
# S=1024, unpipelined on one card; warm-up step, then timed steps.
LLAMA_TRAIN = (8, 1024, 8)
# The first loss: the untied head (lecun-normal, variance 1/2048) over the
# final norm's unit-RMS output gives logits of variance 1, so the
# expected cross-entropy of a random label is ln 32000 + 1/2 = 10.873
# (E[log-sum-exp] of 32000 unit normals), not ln 32000.
LLAMA_FIRST_LOSS = float(np.log(32000)) + 0.5
LLAMA_FIRST_LOSS_SLACK = 0.25
# Device time of a training step by kernel name: the flash kernels, the
# fp32 matmuls (the lm_head and its gradients: TF32 is off), the other
# matmuls (bf16, cuBLAS), AdamW's multi-tensor kernels, the rest.
LLAMA_STEP_GROUPS = (("flash", ("flash_",)),
                     ("fp32 matmul", ("sgemm", "f32f32_f32f32")),
                     ("matmul", ("gemm", "xmma", "cutlass", "nvjet")),
                     ("optimizer", ("multi_tensor_apply",)))


def llama_copy(model, **changes):
    """A ``Llama`` of ``model``'s config with ``changes``, holding a copy
    of its weights, made on the card (the seeded CPU init runs once)."""
    cfg = dataclasses.replace(model.config, **changes)
    with torch.device("meta"):
        copy_ = Llama(cfg)
    copy_ = copy_.to_empty(device=model.embed.device)
    copy_.load_state_dict(model.state_dict())
    return copy_.eval()


def phase_llama_serve(card) -> tuple:
    """llama_1b in bf16 through LLMServer (8 requests, prompts 64-1536, 64
    greedy tokens, 8 slots): prefill and decode ms, tokens/s, peak memory,
    the KV bytes a token read back from the page arrays.  Then, on the
    same weights in fp32 (TF32 off), the engine's tokens for 2 prompts
    against NaiveLM(width=2048), whose forwards run the flash forward in
    each layer, and the bf16 model's full-context logits against the fp32
    model's.  Returns the launches of each path and the fp32 model."""
    t0 = time.perf_counter()
    server = LLMServer("llama", {**LLAMA_1B, "dtype": torch.bfloat16},
                       seed=SEED, **LLAMA_ENGINE)
    init_s = time.perf_counter() - t0
    m16 = server.engine._model
    cfg = m16.config
    if dataclasses.replace(cfg, dtype=torch.bfloat16) != \
            LlamaConfig.llama_1b():
        raise AssertionError(f"LLAMA_1B is not llama_1b: {cfg}")
    rng = np.random.default_rng(SEED)
    lengths = rng.integers(*LLAMA_PROMPT_LENS, size=LLAMA_USERS)
    if lengths.max() <= LLAMA_LONG_PROMPT:
        raise AssertionError(f"no prompt past {LLAMA_LONG_PROMPT}: "
                             f"{lengths}")
    requests = [{"tokens": [int(t) for t in rng.integers(
        0, cfg.vocab_size, size=int(n))], "max_new_tokens": LLAMA_NEW}
        for n in lengths]
    eng = server.engine
    kv_bytes = (eng._k_pages.numel() + eng._v_pages.numel()) * \
        eng._k_pages.element_size() // (eng._k_pages.shape[1]
                                        * eng.page_size)
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    try:
        outs, seconds = serve(server, requests)
        st = server.stats()
    finally:
        server.drain()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    engine_line("llama-serve", st, seconds)
    log(f"[llama-serve] {card} | llama_1b bf16 (fp32 parameters, "
        f"{cfg.n_params} of them; seeded init on the CPU and copy "
        f"{init_s:.1f} s), {LLAMA_USERS} requests, prompts "
        f"{int(lengths.min())}-{int(lengths.max())}, {LLAMA_NEW} greedy "
        f"tokens, {LLAMA_ENGINE['max_slots']} slots, max_ctx "
        f"{LLAMA_ENGINE['max_ctx']}: decode "
        f"{st['decode_seconds'] / max(st['steps'], 1) * 1e3:.2f} ms/step, "
        f"prefill {st['prefill_seconds'] / max(st['prefills'], 1) * 1e3:.1f}"
        f" ms each, {st['tokens_generated'] / seconds:.1f} generated "
        f"tokens/s; peak memory {peak:.2f} GiB; KV pages {kv_bytes} bytes a "
        f"token (expected {LLAMA_KV_BYTES}); flash launches "
        f"{attn.LAUNCHES}")
    if kv_bytes != LLAMA_KV_BYTES:
        raise AssertionError(f"[llama-serve] {kv_bytes} KV bytes a token")
    if any(len(o) != LLAMA_NEW for o in outs):
        raise AssertionError("[llama-serve] a request came back short")
    # fp32, TF32 off: the engine's tokens against NaiveLM(width=2048).
    m32 = llama_copy(m16, dtype=torch.float32)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, size=n)]
               for n in LLAMA_ORACLE_LENS]
    eng = LLMEngine(m32, **LLAMA_ENGINE)
    try:
        got = [eng.result(eng.submit(p, LLAMA_ORACLE_NEW), timeout=600)
               for p in prompts]
    finally:
        eng.close()
    serve_launches = dict(attn.LAUNCHES)  # both engine runs
    zero_launches()
    t0 = time.perf_counter()
    naive = NaiveLM(m32, width=cfg.max_position_embeddings)
    want = [naive.generate(p, LLAMA_ORACLE_NEW) for p in prompts]
    naive_s = time.perf_counter() - t0
    oracle = dict(attn.LAUNCHES)
    steps = sum(len(w) for w in want)
    log(f"[llama-serve] fp32 engine vs NaiveLM(width="
        f"{cfg.max_position_embeddings}) on prompts of "
        f"{LLAMA_ORACLE_LENS} tokens x {LLAMA_ORACLE_NEW}: {steps} oracle "
        f"steps in {naive_s:.2f} s, flash launches {oracle} "
        f"({oracle['flash_fwd'] / steps:.1f} a step), engine paths "
        f"{serve_launches}")
    if any(serve_launches.values()):
        raise AssertionError(f"[llama-serve] the engine launched "
                             f"{serve_launches}")
    if oracle != {"flash_fwd": cfg.num_layers * steps, "flash_dq": 0,
                  "flash_dkv": 0}:
        raise AssertionError(f"[llama-serve] NaiveLM launched {oracle} in "
                             f"{steps} steps")
    for p, g, w in zip(prompts, got, want):
        if g != w:
            i = next(j for j, (a, b) in enumerate(zip(g, w)) if a != b)
            m = margin_at(m32, p + w[:i])
            raise AssertionError(
                f"[llama-serve] engine != NaiveLM for prompt length "
                f"{len(p)} at token {i}: {g[i]} vs {w[i]}; top-1 minus "
                f"top-2 logit there {m:.3g}")
    # bf16 against fp32, one full-context forward at width 2048 (the
    # flash forward in each layer), as GPT-2's bf16 leg.
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(
        1, cfg.max_position_embeddings))).to(m32.embed.device)
    with torch.no_grad():
        l32 = m32(ids)
        l16 = m16(ids)
    err = (l16 - l32).abs().max().item()
    scale = l32.abs().max().item()
    agree = (l16.argmax(-1) == l32.argmax(-1)).float().mean().item()
    log(f"[llama-serve] {len(prompts)} fp32 requests token-identical to "
        f"NaiveLM; bf16 full-context logits (1x"
        f"{cfg.max_position_embeddings}) vs fp32: max |d| "
        f"{err:.4g} of max |logit| {scale:.4g} ({err / scale:.2%}, bound "
        f"{BF16_LOGITS_REL:.0%}); argmax agreement {agree:.2%}")
    if not (err <= BF16_LOGITS_REL * scale and torch.isfinite(l16).all()):
        raise AssertionError("[llama-serve] bf16 logits too far from fp32")
    del m16, l16, l32, naive, eng
    torch.cuda.empty_cache()
    return {"llama-serve": serve_launches, "llama-oracle": oracle}, m32


def phase_llama_train(card, model) -> dict:
    """llama_1b training steps at bench_llama_3d's full shape, B=8 S=1024,
    unpipelined: ``model`` (bf16 compute over fp32 parameters, the seeded
    weights), adamw(3e-4), seeded ids, every layer running the
    forward with the LSE and both backward kernels.  One warm-up step,
    then timed steps ended by one device read of the last loss; then one
    profiled step, its device time by ``LLAMA_STEP_GROUPS``.  Returns the
    launches of each kernel in the timed window."""
    b, length, iters = LLAMA_TRAIN
    cfg = model.config
    step = make_train_step(model, adamw(model.parameters(), 3e-4),
                           llama_loss_fn)
    ids = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, size=(b, length))).to(model.embed.device)
    batch = {"input_ids": ids}
    per_step = {name: cfg.num_layers for name in attn.LAUNCHES}
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    first = step(batch).item()
    if attn.LAUNCHES != per_step:
        raise AssertionError(f"[llama-train] warm-up step launched "
                             f"{attn.LAUNCHES}, expected {per_step}")
    zero_launches()
    t0 = time.perf_counter()
    losses = [step(batch) for _ in range(iters)]
    last = losses[-1].item()  # the one device read: the barrier
    seconds = time.perf_counter() - t0
    counted = dict(attn.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    want = {name: n * iters for name, n in per_step.items()}
    if counted != want:
        raise AssertionError(f"[llama-train] {iters} steps launched "
                             f"{counted}, expected {want}")
    losses = [first] + torch.stack(losses).tolist()
    if not all(np.isfinite(losses)):
        raise AssertionError(f"[llama-train] losses {losses}")
    if abs(first - LLAMA_FIRST_LOSS) > LLAMA_FIRST_LOSS_SLACK:
        raise AssertionError(f"[llama-train] first loss {first:.4f} not "
                             f"within {LLAMA_FIRST_LOSS_SLACK} of ln 32000 "
                             f"+ 1/2 = {LLAMA_FIRST_LOSS:.4f}")
    if not last < first:
        raise AssertionError(f"[llama-train] loss did not fall ({first:.4f}"
                             f" -> {last:.4f})")
    flops_per_token = (6 * cfg.n_params
                       + 12 * cfg.num_layers * cfg.hidden_size * length)
    tokens_per_s = iters * b * length / seconds
    mfu = tokens_per_s * flops_per_token / PEAK_OPS_PER_S[torch.bfloat16]
    routes = {name: r["bfloat16"] for name, r in routes_by_dtype().items()}
    note("llama-train", ms_per_step=seconds / iters * 1e3,
         tokens_per_s=tokens_per_s, mfu=mfu, peak_gib=peak)
    log(f"[llama-train] {card} | llama_1b B={b} S={length} bf16/fp32-params "
        f"adamw: {iters} steps in {seconds:.3f} s = "
        f"{seconds / iters * 1e3:.1f} ms/step, {tokens_per_s:.0f} tokens/s, "
        f"MFU {mfu:.4f} (N={cfg.n_params} with the embedding, "
        f"{flops_per_token / 1e9:.3f} GFLOP/token, bf16 peak); loss "
        f"{' '.join(f'{x:.4f}' for x in losses)}; launches per step "
        f"{per_step}, bf16 routes {routes}; peak memory {peak:.2f} GiB")
    prof = profile_device(lambda: step(batch), LLAMA_STEP_GROUPS)
    step_ms = seconds / iters * 1e3
    groups = ", ".join(f"{g} {ms:.1f}" for g, ms in sorted(
        prof["groups"].items(), key=lambda kv: -kv[1]))
    top = "; ".join(f"{name[:60]} x{n} {ms:.1f} ms"
                    for name, (n, ms) in prof["top"])
    log(f"[llama-train] {card} | one profiled step: device "
        f"{prof['device_ms']:.1f} ms, {prof['device_ms'] / step_ms:.1%} of "
        f"a timed step ({prof['wall_ms']:.1f} ms of wall time under the "
        f"profiler), {prof['device_ops']} device ops, "
        f"{prof['launch_calls']} launch calls; by group (ms): {groups}; "
        f"top: {top}")
    del step, losses
    return counted


def phase_timing(card) -> dict:
    """Kernel, plain version and SDPA at the path's shape and layout (bf16
    causal, q/k/v the views of a fused QKV output, inputs L2-resident as
    in the model), each timed in a CUDA graph, plus the kernel-vs-plain-
    path crossover over L (back-to-back launches from Python, as the
    model calls them)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    q, k, v = fused_qkv(*PATH_SHAPE, torch.bfloat16, gen)
    with torch.no_grad():
        got = attn.flash_attention(q, k, v, causal=True)
        want = attn.flash_attention_reference(q, k, v, causal=True)
        err = (got.float() - want.float()).abs().max().item()
        if not kernel_error(got, want) <= TOL[torch.bfloat16]:
            raise AssertionError("flash kernel disagrees at the path's "
                                 "shape")
        launch_ms = cuda_ms(lambda: attn.flash_attention(q, k, v,
                                                         causal=True))
        ms = graph_ms(lambda: attn.flash_attention(q, k, v, causal=True))
        plain_ms = graph_ms(lambda: attn.flash_attention_reference(
            q, k, v, causal=True))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        sdpa_ms = graph_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True))
        q32, k32, v32 = (x.float() for x in (q, k, v))
        ms32 = graph_ms(lambda: attn.flash_attention(q32, k32, v32,
                                                     causal=True))
        plain32_ms = graph_ms(lambda: attn.flash_attention_reference(
            q32, k32, v32, causal=True))
    bound_ms, bound_by = flash_bound(q, True)
    routes = routes_by_dtype()["flash_fwd"]
    note("timing", fwd_ms=ms, sdpa_ms=sdpa_ms, fwd_fp32_ms=ms32)
    log(f"[timing] {card} | flash_fwd 1x12x1024x64 bf16 causal: kernel "
        f"({routes['bfloat16']}) {ms:.4f} ms, "
        f"{rate_line(q, True, 'fwd', ms)}; plain {plain_ms:.4f} ms, SDPA "
        f"{sdpa_ms:.4f} ms; fp32 kernel ({routes['float32']}) {ms32:.4f} "
        f"ms, {rate_line(q32, True, 'fwd', ms32)}, plain fp32 "
        f"{plain32_ms:.4f} ms (device times in CUDA "
        f"graphs; the bf16 call launched back to back from Python "
        f"{launch_ms:.4f} ms)")
    for length in (128, 256, 512, 1024, 2048, 4096):
        x = [torch.randn(1, length, 12, 64, device="cuda", generator=gen)
             .to(torch.bfloat16) for _ in range(3)]
        with torch.no_grad():
            t_k = cuda_ms(lambda: attn.flash_attention(*x, causal=True))
            t_p = cuda_ms(lambda: attn._plain_attention(*x, True, None))
        log(f"[crossover] {card} | L={length} bf16 causal B=1 H=12 D=64: "
            f"kernel {t_k:.4f} ms, plain path {t_p:.4f} ms")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": sdpa_ms}


def phase_timing_bwd(card) -> dict:
    """At each training shape (bf16, causal, ``TIMING_BWD_SHAPES``'s
    layout): the forward with the LSE held against the plain forward
    (O and LSE), dq and dkv held against the plain backward, then timed:
    dq, dkv, the two together and ``_bwd_operands`` alone (Delta and the
    checks, the rest of the pair's time), the forward with the LSE and
    SDPA's forward in CUDA graphs; the plain forward and backward, and SDPA's
    backward (fwd+bwd minus fwd, timed as a yardstick, never called by
    the port) from back-to-back launches; each kernel beside its bound.  Returns, per kernel, its JSON fields at each
    shape."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    by_shape = {name: {} for name in ("flash_fwd", "flash_dq", "flash_dkv")}
    for b, length, h, layout in TIMING_BWD_SHAPES:
        shape = f"{b}x{h}x{length}x64"
        q, k, v = fused_qkv(b, length, h, 64, torch.bfloat16, gen)
        if layout == "contiguous":
            q, k, v = (x.contiguous() for x in (q, k, v))
        d_out = torch.randn(q.shape, device="cuda",
                            generator=gen).to(torch.bfloat16)
        scale = 64 ** -0.5
        with torch.no_grad():
            out, lse = attn._flash_fwd_cuda(q, k, v, True, scale, True)
            out_ref, lse_ref = attn.flash_attention_reference(
                q, k, v, True, scale, True)
            err_fwd = kernel_error(out, out_ref)
            err_lse = (lse - lse_ref).abs().max().item()
            if not (err_fwd <= TOL[torch.bfloat16] and err_lse <= LSE_ATOL):
                raise AssertionError(
                    f"flash_fwd with LSE disagrees with the plain forward "
                    f"at {shape}: |dO| / row max |O_ref| {err_fwd:.3g} "
                    f"(bound {TOL[torch.bfloat16]:.3g}), |dLSE| "
                    f"{err_lse:.3g} (atol {LSE_ATOL})")
            del out_ref, lse_ref
            ops = attn._bwd_operands(q, k, v, out, lse, d_out, True)
            dq = attn._flash_dq_cuda(q, k, v, *ops, True, scale)
            dk, dv = attn._flash_dkv_cuda(q, k, v, *ops, True, scale)
            want = attn.flash_attention_backward_reference(
                q, k, v, out, lse, d_out, True)
            err_dq = (dq.float() - want[0].float()).abs().max().item()
            err_dkv = max((g.float() - r.float()).abs().max().item()
                          for g, r in zip((dk, dv), want[1:]))
            equal = sum((g == r).sum().item() for g, r in
                        zip((dq, dk, dv), want)) / (3 * q.numel())
            for g, r in zip((dq, dk, dv), want):
                if not bwd_error(g, r) <= BWD_TOL[torch.bfloat16]:
                    raise AssertionError(f"backward kernel disagrees at "
                                         f"{shape}")
            del dq, dk, dv, want
            t = {
                "dq": graph_ms(lambda: attn._flash_dq_cuda(
                    q, k, v, *ops, True, scale)),
                "dkv": graph_ms(lambda: attn._flash_dkv_cuda(
                    q, k, v, *ops, True, scale)),
                "bwd": graph_ms(lambda: attn._flash_bwd_cuda(
                    q, k, v, out, lse, d_out, True, scale)),
                "operands": graph_ms(lambda: attn._bwd_operands(
                    q, k, v, out, lse, d_out, True)),
                "fwd_lse": graph_ms(lambda: attn._flash_fwd_cuda(
                    q, k, v, True, scale, True)),
                "plain_fwd": cuda_ms(
                    lambda: attn.flash_attention_reference(
                        q, k, v, True, scale, True), iters=5, warmup=2),
                "plain_bwd": cuda_ms(
                    lambda: attn.flash_attention_backward_reference(
                        q, k, v, out, lse, d_out, True), iters=5,
                    warmup=2),
            }
        leaves = [x.detach().transpose(1, 2).requires_grad_()
                  for x in (q, k, v)]
        d_out_t = d_out.transpose(1, 2)

        def sdpa_fwd_bwd():
            o = F.scaled_dot_product_attention(*leaves, is_causal=True)
            torch.autograd.grad(o, leaves, d_out_t)

        with torch.no_grad():
            sdpa_fwd = cuda_ms(lambda: F.scaled_dot_product_attention(
                *leaves, is_causal=True), iters=20)
            sdpa_fwd_graph = graph_ms(lambda: F.scaled_dot_product_attention(
                *leaves, is_causal=True))
        t["sdpa_bwd"] = cuda_ms(sdpa_fwd_bwd, iters=20) - sdpa_fwd
        bounds = {name: flash_bound(q, True, name, with_lse=True)
                  for name in ("fwd", "dq", "dkv", "bwd")}
        routes = {name: r["bfloat16"] for name, r in routes_by_dtype().items()}
        note("timing-bwd", **{f"{shape} {k}_ms": t[k]
                              for k in ("fwd_lse", "dq", "dkv", "bwd")})
        log(f"[timing-bwd] {card} | {shape} bf16 causal {layout}, rates on "
            f"the visible pairs: fwd+LSE ({routes['flash_fwd']}) "
            f"{rate_line(q, True, 'fwd', t['fwd_lse'], True)}; dq "
            f"({routes['flash_dq']}) {rate_line(q, True, 'dq', t['dq'])}; "
            f"dkv ({routes['flash_dkv']}) "
            f"{rate_line(q, True, 'dkv', t['dkv'])}; dq+dkv "
            f"{rate_line(q, True, 'bwd', t['bwd'])}")
        log(f"[timing-bwd] {card} | {shape} bf16 causal {layout}: "
            f"dq {t['dq']:.4f} ms (bound {bounds['dq'][0]:.4f}, "
            f"{bounds['dq'][1]}); dkv {t['dkv']:.4f} ms (bound "
            f"{bounds['dkv'][0]:.4f}, {bounds['dkv'][1]}); dq+dkv (with "
            f"Delta) {t['bwd']:.4f} ms (bound of the backward "
            f"{bounds['bwd'][0]:.4f}, {bounds['bwd'][1]}), of which "
            f"_bwd_operands (Delta, checks) {t['operands']:.4f} ms; fwd+LSE "
            f"{t['fwd_lse']:.4f} ms (bound {bounds['fwd'][0]:.4f}, "
            f"{bounds['fwd'][1]}); plain forward+LSE {t['plain_fwd']:.4f} "
            f"ms; plain backward {t['plain_bwd']:.4f} ms; SDPA backward "
            f"{t['sdpa_bwd']:.4f} ms (SDPA forward {sdpa_fwd_graph:.4f} ms); "
            f"fwd+LSE vs plain: |dO| / row max |O_ref| {err_fwd:.3g} "
            f"(bound {TOL[torch.bfloat16]:.3g}), max |dLSE| {err_lse:.3g} "
            f"(atol {LSE_ATOL}); max |d(dq)| {err_dq:.3g}, max "
            f"|d(dk, dv)| {err_dkv:.3g}, bitwise equal {equal:.6f} of dq, "
            f"dk, dv")
        # dq and dkv each compute part of the backward; the plain version
        # and the library call compute all of it, so each kernel's row
        # also carries the pair's time and the backward's own bound.
        whole = {"plain_ms": t["plain_bwd"], "library_ms": t["sdpa_bwd"],
                 "plain_and_library_compute": "dq, dk and dv together",
                 "pair_ms": t["bwd"], "pair_bound_ms": bounds["bwd"][0],
                 "pair_bound_by": bounds["bwd"][1]}
        by_shape["flash_fwd"][shape] = {
            "max_abs_err": err_fwd, "max_lse_err": err_lse,
            "ms": t["fwd_lse"], "plain_ms": t["plain_fwd"],
            "bound_ms": bounds["fwd"][0], "bound_by": bounds["fwd"][1],
            "library_ms": sdpa_fwd_graph}
        by_shape["flash_dq"][shape] = {
            "max_abs_err": err_dq, "ms": t["dq"],
            "bound_ms": bounds["dq"][0], "bound_by": bounds["dq"][1],
            **whole}
        by_shape["flash_dkv"][shape] = {
            "max_abs_err": err_dkv, "ms": t["dkv"],
            "bound_ms": bounds["dkv"][0], "bound_by": bounds["dkv"][1],
            **whole}
        del q, k, v, out, lse, ops, leaves
        torch.cuda.empty_cache()
    return by_shape


def phase_timing_fp32(card):
    """The fp32 kernels (the FMA routes) at the fp32 step's attention
    shape (1x12x1024x64) and at [pipeline]'s microbatch shape
    (2x12x1024x64): ``timing_fp32_at`` each."""
    timing_fp32_at(card, PATH_SHAPE, SEED + 6)
    timing_fp32_at(card, PIPELINE_ATTN_SHAPE, SEED + 7)


def timing_fp32_at(card, shape, seed):
    """The fp32 kernels at ``shape`` (B, L, H, D; causal, q/k/v the views
    of a fused QKV output): the forward with the LSE, dq and dkv, each
    held against its plain version and timed in a CUDA graph beside its
    bound (fp32 at the FMA rate), the plain versions and SDPA in fp32
    (TF32 off, as phase_device sets it; its backward as forward+backward
    minus forward, from back-to-back launches)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = fused_qkv(*shape, torch.float32, gen)
    d_out = torch.randn(q.shape, device="cuda", generator=gen)
    scale = shape[-1] ** -0.5
    with torch.no_grad():
        out, lse = attn._flash_fwd_cuda(q, k, v, True, scale, True)
        out_ref, lse_ref = attn.flash_attention_reference(q, k, v, True,
                                                          scale, True)
        ops = attn._bwd_operands(q, k, v, out, lse, d_out, True)
        got = (attn._flash_dq_cuda(q, k, v, *ops, True, scale),
               *attn._flash_dkv_cuda(q, k, v, *ops, True, scale))
        want = attn.flash_attention_backward_reference(q, k, v, out, lse,
                                                       d_out, True)
        errs = {"fwd": max(kernel_error(out, out_ref),
                           (lse - lse_ref).abs().max().item()),
                "dq": bwd_error(got[0], want[0]),
                "dkv": max(bwd_error(got[1], want[1]),
                           bwd_error(got[2], want[2]))}
        if not max(errs.values()) <= BWD_TOL[torch.float32]:
            raise AssertionError(f"fp32 kernels disagree at "
                                 f"{shape}: {errs}")
        del out_ref, lse_ref, got, want
        t = {"fwd": graph_ms(lambda: attn._flash_fwd_cuda(
                 q, k, v, True, scale, True)),
             "dq": graph_ms(lambda: attn._flash_dq_cuda(
                 q, k, v, *ops, True, scale)),
             "dkv": graph_ms(lambda: attn._flash_dkv_cuda(
                 q, k, v, *ops, True, scale)),
             "plain_fwd": cuda_ms(lambda: attn.flash_attention_reference(
                 q, k, v, True, scale, True), iters=10),
             "plain_bwd": cuda_ms(
                 lambda: attn.flash_attention_backward_reference(
                     q, k, v, out, lse, d_out, True), iters=10)}
    leaves = [x.detach().transpose(1, 2).requires_grad_() for x in (q, k, v)]
    d_out_t = d_out.transpose(1, 2)

    def sdpa_fwd_bwd():
        o = F.scaled_dot_product_attention(*leaves, is_causal=True)
        torch.autograd.grad(o, leaves, d_out_t)

    with torch.no_grad():
        sdpa_fwd = cuda_ms(lambda: F.scaled_dot_product_attention(
            *leaves, is_causal=True), iters=20)
        sdpa_fwd_graph = graph_ms(lambda: F.scaled_dot_product_attention(
            *leaves, is_causal=True))
    sdpa_bwd = cuda_ms(sdpa_fwd_bwd, iters=20) - sdpa_fwd
    routes = {name: r["float32"] for name, r in routes_by_dtype().items()}
    parts = []
    for name, kernel in (("fwd", "flash_fwd"), ("dq", "flash_dq"),
                         ("dkv", "flash_dkv")):
        bound_ms, bound_by = flash_bound(q, True, name, with_lse=True)
        parts.append(f"{name}{'+LSE' if name == 'fwd' else ''} "
                     f"({routes[kernel]}) {t[name]:.4f} ms, "
                     f"{rate_line(q, True, name, t[name], True)}, error "
                     f"{errs[name]:.3g}")
    b, length, h, d = shape
    note("timing-fp32", **{f"{b}x{h}x{length}x{d} {name}_ms": t[name]
                           for name in ("fwd", "dq", "dkv", "plain_fwd",
                                        "plain_bwd")},
         **{f"{b}x{h}x{length}x{d} sdpa_fwd_ms": sdpa_fwd_graph,
            f"{b}x{h}x{length}x{d} sdpa_bwd_ms": sdpa_bwd})
    log(f"[timing-fp32] {card} | {b}x{h}x{length}x{d} fp32 causal fused, "
        f"TF32 off: "
        f"{'; '.join(parts)} (atol {BWD_TOL[torch.float32]}); plain "
        f"forward+LSE {t['plain_fwd']:.4f} ms, plain backward "
        f"{t['plain_bwd']:.4f} ms; SDPA fp32 forward {sdpa_fwd_graph:.4f} "
        f"ms, backward {sdpa_bwd:.4f} ms")


def _breakout_states(rng, n) -> dict:
    """``n`` seeded Breakout84 states over the whole state space: walls of
    every density (an eighth of them down to one brick, so that a hit can
    clear the wall), the ball and paddle anywhere, t up to the limit."""
    density = rng.random((n, 1, 1))
    bricks = rng.random((n, 6, 12)) < density
    last = np.arange(n) % 8 == 0
    bricks[last] = False
    bricks[last, rng.integers(0, 6, last.sum()),
           rng.integers(0, 12, last.sum())] = True
    ints = {"px": rng.integers(0, 77, n), "bx": rng.integers(0, 83, n),
            "by": rng.integers(0, 83, n), "dx": rng.choice([-2, -1, 1, 2], n),
            "dy": rng.choice([-2, 2], n), "lx": rng.integers(0, 83, n),
            "ly": rng.integers(0, 83, n), "t": rng.integers(0, 2500, n)}
    return {**{k: v.astype(np.int32) for k, v in ints.items()},
            "bricks": bricks}


def phase_ppo_parity():
    """The PPO path's env and module, card against CPU: Breakout84's
    ``step_core`` and render from the same seeded states and actions
    (bitwise), then the module's logits and value on those frames (TF32
    off) within ``PPO_MODULE_RTOL`` of each output's largest
    magnitude."""
    env = Breakout84()
    rng = np.random.default_rng(SEED + 7)
    states = _breakout_states(rng, PPO_ENVS)
    actions = torch.from_numpy(rng.integers(0, 3, PPO_ENVS))
    out = {}
    for device in ("cuda", "cpu"):
        stepped, reward, done = env.step_core(
            {k: torch.from_numpy(v).to(device) for k, v in states.items()},
            actions.to(device))
        out[device] = {**stepped, "reward": reward, "done": done,
                       "obs": env._obs(stepped)}
    unequal = [k for k, v in out["cpu"].items()
               if not torch.equal(out["cuda"][k].cpu(), v)]
    if unequal:
        raise AssertionError(f"[ppo] Breakout84 card != CPU in {unequal}")
    cpu = out["cpu"]
    respawned = int((~torch.from_numpy(states["bricks"]).flatten(1).all(1)
                     & cpu["bricks"].flatten(1).all(1)).sum())
    log(f"[ppo] Breakout84.step_core and render, card vs CPU: bitwise equal "
        f"over {PPO_ENVS} seeded states ({int(cpu['done'].sum())} done, "
        f"{int(cpu['reward'].sum())} bricks hit, {respawned} walls "
        f"respawned)")
    module = RLModuleSpec.for_env(env, ()).build(
        torch.Generator().manual_seed(SEED))
    frames = cpu["obs"][:256]
    with torch.no_grad():
        want = module(frames)
        got = module.to("cuda")(frames.to("cuda"))
    errs = [((g.cpu() - w).abs().max() / w.abs().max()).item()
            for g, w in zip(got, want)]
    log(f"[ppo] DiscreteActorCritic (Nature CNN) on 256 frames, card vs CPU, "
        f"TF32 off: max |d| / max |ref| logits {errs[0]:.3g}, value "
        f"{errs[1]:.3g} (bound {PPO_MODULE_RTOL})")
    if not max(errs) <= PPO_MODULE_RTOL:
        raise AssertionError(f"[ppo] module card != CPU: {errs}")


# Device operations grouped by kernel name, first match wins: cuDNN's
# layout transposes, then the convolution (direct, implicit-GEMM or FFT)
# and GEMM kernels of cuDNN and cuBLAS; the rest (elementwise,
# reductions, copies, RNG, Adam) is "other".
DEVICE_GROUPS = (("layout", ("nhwcToNchw", "nchwToNhwc")),
                 ("conv/gemm", ("cudnn", "conv", "gemm", "wgrad", "dgrad",
                                "fprop", "xmma", "cutlass", "fft")))


def device_events(prof, from_averages=False) -> tuple:
    """(device operations by name: (count, ms), kernel-launch calls) of a
    finished ``torch.profiler`` run.  Read from the kineto events as they
    are: ``key_averages`` builds Python objects for the host's events
    first, which took 32 s for one LSTM PPO iteration's 390k events on
    the CPU; the device's events do not nest, so their counts and times
    are ``key_averages``' (``from_averages=True`` computes those, to check
    it).  A user annotation (the optimizer's "Optimizer.step#...") also
    has a span on the device's timeline, over kernels counted on their
    own."""
    cuda = torch.autograd.DeviceType.CUDA
    device, launches = {}, 0
    if from_averages:
        events = prof.key_averages()
        device = {e.key: (e.count, getattr(e, "self_device_time_total",
                                           getattr(e, "self_cuda_time_total",
                                                   0)) / 1e3)
                  for e in events if e.device_type == cuda
                  and not getattr(e, "is_user_annotation", False)}
        return device, sum(e.count for e in events
                           if "LaunchKernel" in e.key)
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if "LaunchKernel" in name:
            launches += 1
        if e.device_type() == cuda and not getattr(
                e, "is_user_annotation", lambda: False)():
            n, ms = device.get(name, (0, 0.0))
            device[name] = (n + 1, ms + e.duration_ns() / 1e6)
    return device, launches


def profile_device(fn, groups=DEVICE_GROUPS, check=False) -> dict:
    """What ``fn()`` puts on the card, from ``torch.profiler``: the device
    operations it ran (kernels, memsets, copies), the kernel-launch calls
    the host made (``cudaLaunchKernel``, ``cuLaunchKernel``), the device
    time summed over those operations (one stream: they do not overlap),
    that time by ``groups`` (first match of a name's words), and the six
    operations that took the most of it, with their counts.  ``check``
    holds ``device_events`` to ``key_averages``' counts and times."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    device, launches = device_events(prof)
    if check:
        want, want_launches = device_events(prof, from_averages=True)
        if launches != want_launches or {k: n for k, (n, _) in
                                         device.items()} != \
                {k: n for k, (n, _) in want.items()} or any(
                    abs(device[k][1] - ms) > 1e-3 * max(ms, 1e-3)
                    for k, (_, ms) in want.items()):
            raise AssertionError(f"device_events {launches} {device} != "
                                 f"key_averages {want_launches} {want}")
    top = sorted(device.items(), key=lambda kv: -kv[1][1])[:6]
    by_group = {}
    for name, (_, ms) in device.items():
        group = next((g for g, words in groups if any(
            w in name for w in words)), "other")
        by_group[group] = by_group.get(group, 0.0) + ms
    return {"device_ops": sum(n for n, _ in device.values()),
            "launch_calls": launches,
            "device_ms": sum(ms for _, ms in device.values()),
            "wall_ms": wall_ms, "top": top, "kinds": len(device),
            "groups": by_group}


def learn_to_floor(algo, tag, floor, max_iters, target=None) -> dict:
    """bench.py::_learn_to_floor: one warm-up iteration, then train until
    the CURRENT episode_reward_mean >= ``floor`` at an iteration >= 10
    (and >= ``target`` when given), within ``max_iters``; after the
    budget the verdict is the current reward against the floor.  Raises
    on a non-finite loss; logs every 10th iteration."""
    t0 = time.perf_counter()
    algo.train()
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    met_at, reward, best = None, float("nan"), float("-inf")
    for i in range(max_iters):
        metrics = algo.train()
        reward = metrics["episode_reward_mean"]
        if not np.isfinite(metrics["total_loss"]):
            raise AssertionError(f"[{tag}] iteration {i}: {metrics}")
        if np.isfinite(reward):
            best = max(best, reward)
        if i % 10 == 0:
            log(f"[{tag}] iteration {i}: episode_reward_mean {reward:.2f}, "
                f"total_loss {metrics['total_loss']:.4f}, entropy "
                f"{metrics['entropy']:.4f}, {metrics['time_this_iter_s']:.3f}"
                f" s")
        if i >= 10 and reward >= floor and (target is None
                                            or reward >= target):
            met_at = i
            break
    return {"floor_met": bool(reward >= floor), "met_at": met_at,
            "reward": reward, "best": best, "iterations": i + 1,
            "seconds": time.perf_counter() - t0, "warm_s": warm_s}


def timed_iterations(algo, iters, names) -> dict:
    """``iters`` iterations timed by the host clock (each ends in the
    iteration's one device read), with a CUDA event at each phase the
    train step marks (``names``, "start" first): env-steps/s, each
    phase's mean ms an iteration, peak memory."""
    marks = []

    def mark(name):
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        marks.append((name, event))

    algo.on_phase = mark
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(iters):
        metrics = algo.train()
        if not np.isfinite(metrics["total_loss"]):
            raise AssertionError(f"timed iteration: {metrics}")
    seconds = time.perf_counter() - t0
    algo.on_phase = None
    torch.cuda.synchronize()
    k = len(names)
    if [n for n, _ in marks] != list(names) * iters:
        raise AssertionError(f"phase marks {[n for n, _ in marks]}")
    split = {name: float(np.mean([
        marks[i + j][1].elapsed_time(marks[i + j + 1][1])
        for i in range(0, len(marks), k)])) for j, name in
        enumerate(names[1:])}
    return {"seconds": seconds, "split": split, "metrics": metrics,
            "steps_per_s": iters * algo._steps_per_iter / seconds,
            "ms": seconds / iters * 1e3,
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}


def phase_ppo(card) -> dict:
    """The PPO path: ``PPOConfig()...build().train()`` on Breakout-Atari84
    at bench.py's configuration, trained to the reward floor, then timed
    (env-steps/s; the rollout, GAE and SGD of each iteration between CUDA
    events; peak memory), then one env step and one iteration profiled
    (launches an env step; the device's busy share; the device time of
    cuDNN's layout transposes, which the NCHW trunk should leave near
    0)."""
    zero_launches()
    algo = (PPOConfig()
            .environment("Breakout-Atari84-v0")
            .anakin(num_envs=PPO_ENVS, unroll_length=PPO_UNROLL)
            .training(**PPO_TRAINING)
            .debugging(seed=SEED)
            .build())
    n_params = sum(p.numel() for p in algo.module.parameters())
    if n_params != PPO_PARAMS:
        raise AssertionError(f"[ppo] {n_params} parameters, expected "
                             f"{PPO_PARAMS}")
    gate = learn_to_floor(algo, "ppo", ATARI84_REWARD_FLOOR, PPO_MAX_ITERS)
    if gate["met_at"] is None:
        raise AssertionError(
            f"[ppo] reward {gate['reward']:.2f} < {ATARI84_REWARD_FLOOR} "
            f"after {PPO_MAX_ITERS} iterations")
    log(f"[ppo] reward floor {ATARI84_REWARD_FLOOR} met at iteration "
        f"{gate['met_at']} (episode_reward_mean {gate['reward']:.2f}) in "
        f"{gate['seconds']:.1f} s, after a warm-up iteration of "
        f"{gate['warm_s']:.2f} s")
    timed = timed_iterations(algo, PPO_TIMED_ITERS,
                             ("start", "rollout", "gae", "sgd"))
    split, metrics = timed["split"], timed["metrics"]

    st = algo._anakin_state
    env = Breakout84()
    action = algo.module.forward_exploration(st.obs, st.generator)[0]
    with torch.no_grad():
        env_prof = profile_device(
            lambda: env.step(st.env_states, action, st.generator))
        policy_prof = profile_device(
            lambda: algo.module.forward_exploration(st.obs, st.generator))
    iter_prof = profile_device(algo.train)
    iter_ms = timed["ms"]
    device_ms = iter_prof["device_ms"]
    top = "; ".join(f"{name[:60]} x{n} {ms:.1f} ms ({ms / device_ms:.1%})"
                    for name, (n, ms) in iter_prof["top"])
    groups = ", ".join(f"{g} {ms:.1f} ms ({ms / device_ms:.1%})"
                       for g, ms in sorted(iter_prof["groups"].items()))
    layout_ms = iter_prof["groups"].get("layout", 0.0)
    if any(attn.LAUNCHES.values()):
        raise AssertionError(f"[ppo] launched {attn.LAUNCHES}")
    note("ppo", env_steps_per_s=timed["steps_per_s"], iter_ms=iter_ms,
         floor_met_at=gate["met_at"])
    log(f"[ppo] {card} | PPO Breakout-Atari84 {PPO_ENVS} envs x "
        f"{PPO_UNROLL} steps, Nature CNN ({n_params} parameters), fp32, "
        f"TF32 off, eager rollout, SGD updates from CUDA graphs: "
        f"{PPO_TIMED_ITERS} iterations in "
        f"{timed['seconds']:.3f} s = {timed['steps_per_s']:.0f} "
        f"env-steps/s, {iter_ms:.1f} ms an iteration; "
        f"split by CUDA events (ms an iteration): rollout "
        f"(env step + action sampling) {split['rollout']:.1f}, GAE + "
        f"normalisation {split['gae']:.1f}, SGD {split['sgd']:.1f}; an env "
        f"step {env_prof['device_ops']} device ops "
        f"({env_prof['launch_calls']} launch calls, "
        f"{env_prof['device_ms']:.3f} ms on the device), the policy's "
        f"forward and draw {policy_prof['device_ops']} "
        f"({policy_prof['launch_calls']} launch calls, "
        f"{policy_prof['device_ms']:.3f} ms); one profiled iteration: "
        f"{iter_prof['device_ops']} device ops, device busy {device_ms:.1f}"
        f" ms of its {iter_prof['wall_ms']:.1f} ms under the profiler "
        f"({device_ms / iter_prof['wall_ms']:.1%}), {device_ms / iter_ms:.1%}"
        f" of a timed iteration; peak memory {timed['peak_gib']:.2f} GiB; "
        f"reward {metrics['episode_reward_mean']:.2f}; flash launches "
        f"{dict(attn.LAUNCHES)}")
    log(f"[ppo] {card} | the profiled iteration's device time by group: "
        f"{groups}; cuDNN layout transposes (nhwcToNchw, nchwToNhwc) "
        f"{layout_ms:.1f} ms ({layout_ms / device_ms:.1%}); the top 6 of "
        f"{iter_prof['kinds']} kinds: {top}")
    return {"env_steps_per_s": timed["steps_per_s"], "split_ms": split,
            "reward_floor_met_at": gate["met_at"],
            "flash": dict(attn.LAUNCHES)}


def _minatar_breakout_states(rng, n) -> dict:
    """Seeded Breakout-MinAtar states over the state space: walls of every
    density (an eighth down to one brick), the ball at every cell and
    heading, t up to the limit."""
    bricks = rng.random((n, 3, 10)) < rng.random((n, 1, 1))
    last = np.arange(n) % 8 == 0
    bricks[last] = False
    bricks[last, rng.integers(0, 3, last.sum()),
           rng.integers(0, 10, last.sum())] = True
    ints = {"paddle_x": rng.integers(0, 10, n),
            "ball_x": rng.integers(0, 10, n),
            "ball_y": rng.integers(0, 9, n), "dx": rng.choice([-1, 1], n),
            "dy": rng.choice([-1, 1], n), "last_x": rng.integers(0, 10, n),
            "last_y": rng.integers(0, 10, n),
            "t": rng.integers(0, 1000, n)}
    return {**{k: v.astype(np.int32) for k, v in ints.items()},
            "bricks": bricks}


def _space_invaders_states(rng, n) -> dict:
    """Seeded SpaceInvaders states: alien blocks of every density (an
    eighth down to one alien, so that a shot can clear the wave), sparse
    bullets, every cannon position, heading, march and cooldown phase."""
    aliens = rng.random((n, 10, 10)) < rng.random((n, 1, 1))
    aliens[:, 9] = False  # an alien on the bottom row has already won
    last = np.arange(n) % 8 == 0
    aliens[last] = False
    rows, cols = rng.integers(1, 8, last.sum()), rng.integers(0, 10,
                                                            last.sum())
    aliens[last, rows, cols] = True
    aliens[~aliens.reshape(n, -1).any(1), 1, 4] = True
    fbul = rng.random((n, 10, 10)) < 0.05
    fbul[last, rows + 1, cols] = True  # a bullet under the last alien
    ints = {"pos": rng.integers(0, 10, n), "dir": rng.choice([-1, 1], n),
            "move_t": rng.integers(0, 4, n), "shot_t": rng.integers(0, 5, n),
            "t": rng.integers(0, 1000, n)}
    return {**{k: v.astype(np.int32) for k, v in ints.items()},
            "aliens": aliens, "fbul": fbul,
            "ebul": rng.random((n, 10, 10)) < 0.05}


def phase_envs():
    """The MinAtar and classic envs, ``step_core`` on the card against the
    CPU from the same seeded states, actions and draws: Breakout-MinAtar
    and SpaceInvaders bitwise (state, boards, reward, done, frames), the
    two Pendulums' (discrete and continuous torque) and
    StatelessCartPole's float state within ``ENV_FLOAT_TOL``; how many
    states took each branch."""
    rng = np.random.default_rng(SEED + 11)
    n = ENV_STATES
    gen = torch.Generator().manual_seed(SEED + 11)
    pend = {"th": rng.uniform(-3 * np.pi, 3 * np.pi, n).astype(np.float32),
            "thdot": rng.uniform(-8, 8, n).astype(np.float32),
            "t": rng.integers(0, 200, n).astype(np.int32)}
    pend["t"][-64:] = 199
    core = rng.uniform(-0.25, 0.25, (n, 4)).astype(np.float32)
    core[: n // 8, 0] = rng.uniform(2.35, 2.45, n // 8)
    cart = {"core": core, "t": rng.integers(0, 500, n).astype(np.int32)}
    cart["t"][-64:] = 499
    invaders = make_torch_env("SpaceInvaders-MinAtar-v0")
    cases = (("Breakout-MinAtar-v0", _minatar_breakout_states(rng, n), (),
              ()),
             ("SpaceInvaders-MinAtar-v0", _space_invaders_states(rng, n),
              invaders.draws(n, gen, "cpu"), ()),
             ("Pendulum-v1", pend, (), ("th", "thdot", "reward", "obs")),
             ("PendulumContinuous-v1", pend, (),
              ("th", "thdot", "reward", "obs")),
             ("StatelessCartPole-v1", cart, (), ("core", "obs")))
    lines = []
    for name, states, draws, floats in cases:
        env = make_torch_env(name)
        if env.num_actions is None:  # torques inside and outside [-2, 2]
            actions = torch.from_numpy(rng.uniform(
                -3, 3, (n, env.action_dim)).astype(np.float32))
        else:
            actions = torch.from_numpy(rng.integers(0, env.num_actions, n))
        out = {}
        for device in ("cuda", "cpu"):
            stepped, reward, done = env.step_core(
                {k: torch.from_numpy(v).to(device) for k, v in
                 states.items()}, actions.to(device),
                *[d.to(device) for d in draws])
            out[device] = {**stepped, "reward": reward, "done": done,
                           "obs": env._obs(stepped)}
        worst = 0.0
        for k, want in out["cpu"].items():
            got = out["cuda"][k].cpu()
            if k in floats:
                err = ((got - want).abs() / (1 + want.abs())).max().item()
                worst = max(worst, err)
                ok = err <= ENV_FLOAT_TOL
            else:
                ok = torch.equal(got, want)
            if not ok:
                raise AssertionError(f"[envs] {name} card != CPU in {k}")
        cpu = out["cpu"]
        if name == "Breakout-MinAtar-v0":
            bounced = int((cpu["dx"] != torch.from_numpy(states["dx"]))
                          .sum())
            counts = (f"{int(cpu['reward'].sum())} bricks hit, {bounced} "
                      f"wall bounces")
        elif name == "SpaceInvaders-MinAtar-v0":
            before = torch.from_numpy(states["aliens"]).flatten(1).sum(1)
            respawned = int(((before - cpu["reward"]) == 0).sum())
            fired = int(((draws[0] < invaders.enemy_fire_prob)
                         & (before > 0)).sum())
            counts = (f"{int((cpu['reward'] > 0).sum())} states with an "
                      f"alien shot, {respawned} waves respawned, {fired} "
                      f"enemy bullets drawn")
        elif name.startswith("Pendulum"):
            wrapped = int((torch.from_numpy(states["th"]).abs() > np.pi)
                          .sum())
            counts = f"{wrapped} angles wrapped"
        else:
            counts = "velocities hidden"
        lines.append(f"{name}: {counts}, {int(cpu['done'].sum())} done"
                     + (f", max |d| / (1 + |x|) {worst:.3g}" if floats
                        else ", bitwise equal"))
    log(f"[envs] step_core card vs CPU over {n} seeded states each: "
        + "; ".join(lines))


def phase_ppo_minatar(card) -> dict:
    """PPO on Breakout-MinAtar at bench_ppo_breakout's configuration:
    trained to the floor, then PPO_TIMED_ITERS timed iterations, one env
    step profiled (device ops)."""
    zero_launches()
    algo = (PPOConfig().environment("Breakout-MinAtar-v0")
            .anakin(num_envs=MINATAR_ENVS, unroll_length=MINATAR_UNROLL)
            .training(**MINATAR_PPO_TRAINING).debugging(seed=SEED).build())
    gate = learn_to_floor(algo, "ppo-minatar", MINATAR_REWARD_FLOOR,
                          PPO_MAX_ITERS)
    if gate["met_at"] is None:
        raise AssertionError(
            f"[ppo-minatar] reward {gate['reward']:.2f} < "
            f"{MINATAR_REWARD_FLOOR} after {PPO_MAX_ITERS} iterations")
    timed = timed_iterations(algo, PPO_TIMED_ITERS,
                             ("start", "rollout", "gae", "sgd"))
    st = algo._anakin_state
    action = algo.module.forward_exploration(st.obs, st.generator)[0]
    with torch.no_grad():
        env_prof = profile_device(lambda: make_torch_env(
            "Breakout-MinAtar-v0").step(st.env_states, action,
                                        st.generator))
        policy_prof = profile_device(
            lambda: algo.module.forward_exploration(st.obs, st.generator))
    split = timed["split"]
    note("ppo-minatar", env_steps_per_s=timed["steps_per_s"],
         iter_ms=timed["ms"], floor_met_at=gate["met_at"])
    log(f"[ppo-minatar] {card} | PPO Breakout-MinAtar {MINATAR_ENVS} envs "
        f"x {MINATAR_UNROLL} steps, MinAtar CNN, fp32, TF32 off, eager "
        f"rollout, SGD updates from CUDA graphs: "
        f"reward floor {MINATAR_REWARD_FLOOR} met at iteration "
        f"{gate['met_at']} ({gate['reward']:.2f}) in {gate['seconds']:.1f} "
        f"s; {PPO_TIMED_ITERS} iterations in {timed['seconds']:.3f} s = "
        f"{timed['steps_per_s']:.0f} env-steps/s, {timed['ms']:.1f} ms an "
        f"iteration (rollout {split['rollout']:.1f}, GAE "
        f"{split['gae']:.1f}, SGD {split['sgd']:.1f} by CUDA events); an "
        f"env step {env_prof['device_ops']} device ops "
        f"({env_prof['device_ms']:.3f} ms on the device), the policy "
        f"{policy_prof['device_ops']} ({policy_prof['device_ms']:.3f} ms);"
        f" peak memory {timed['peak_gib']:.2f} GiB; flash launches "
        f"{dict(attn.LAUNCHES)}")
    if any(attn.LAUNCHES.values()):
        raise AssertionError(f"[ppo-minatar] launched {attn.LAUNCHES}")
    return {"flash": dict(attn.LAUNCHES),
            "env_steps_per_s": timed["steps_per_s"]}


IMPALA_PHASES = ("start", "rollout", "forward", "vtrace", "update")


def _impala_algo(config_cls, seed):
    return (config_cls().environment("Breakout-MinAtar-v0")
            .anakin(num_envs=MINATAR_ENVS, unroll_length=MINATAR_UNROLL)
            .training(**IMPALA_TRAINING).debugging(seed=seed).build())


def _impala_line(tag, card, timed) -> str:
    split = timed["split"]
    return (f"[{tag}] {card} | {MINATAR_ENVS} envs x {MINATAR_UNROLL} "
            f"steps, one full-batch update of "
            f"{MINATAR_ENVS * MINATAR_UNROLL} frames an iteration, fp32, "
            f"TF32 off: {timed['steps_per_s']:.0f} env-steps/s, "
            f"{timed['ms']:.1f} ms an iteration (rollout "
            f"{split['rollout']:.1f}, forward {split['forward']:.1f}, "
            f"V-trace {split['vtrace']:.1f}, loss + backward + update "
            f"{split['update']:.1f} by CUDA events); peak memory "
            f"{timed['peak_gib']:.2f} GiB; cuDNN deterministic "
            f"{torch.backends.cudnn.deterministic}")


def phase_impala(card) -> dict:
    """IMPALA on Breakout-MinAtar at bench_impala_breakout's protocol:
    seeds in turn to the floor (margin target 1.8), PPO_TIMED_ITERS timed
    iterations on the best seed past the floor."""
    zero_launches()
    gate_seed, gate_reward, timed, tried = None, float("-inf"), None, []
    for seed in IMPALA_SEEDS:
        algo = _impala_algo(IMPALAConfig, seed)
        res = learn_to_floor(algo, "impala", IMPALA_FLOOR, IMPALA_MAX_ITERS,
                             target=IMPALA_TARGET)
        tried.append(f"seed {seed}: floor met {res['floor_met']}, reward "
                     f"{res['reward']:.2f} (best {res['best']:.2f}) after "
                     f"{res['iterations']} iterations, {res['seconds']:.1f}"
                     f" s")
        log(f"[impala] {tried[-1]}")
        if res["floor_met"] and res["reward"] > gate_reward:
            gate_seed, gate_reward = seed, res["reward"]
            timed = timed_iterations(algo, PPO_TIMED_ITERS, IMPALA_PHASES)
        del algo
        torch.cuda.empty_cache()
        if res["floor_met"] and res["reward"] >= IMPALA_TARGET:
            break
    if gate_seed is None:
        raise AssertionError(f"[impala] no seed met the floor "
                             f"{IMPALA_FLOOR}: {tried}")
    note("impala", env_steps_per_s=timed["steps_per_s"], gate_seed=gate_seed,
         gate_reward=gate_reward)
    log(_impala_line("impala", card, timed) + f"; gate seed {gate_seed} "
        f"(reward {gate_reward:.2f}), timed reward "
        f"{timed['metrics']['episode_reward_mean']:.2f}; flash launches "
        f"{dict(attn.LAUNCHES)}")
    if any(attn.LAUNCHES.values()):
        raise AssertionError(f"[impala] launched {attn.LAUNCHES}")
    return {"flash": dict(attn.LAUNCHES),
            "env_steps_per_s": timed["steps_per_s"]}


def phase_appo(card) -> dict:
    """APPO at IMPALA's size: one warm-up iteration, then timed ones; every
    loss must be finite (APPO's learning is gated on the CPU)."""
    zero_launches()
    algo = _impala_algo(APPOConfig, SEED)
    algo.train()
    timed = timed_iterations(algo, APPO_TIMED_ITERS, IMPALA_PHASES)
    m = timed["metrics"]
    note("appo", env_steps_per_s=timed["steps_per_s"])
    log(_impala_line("appo", card, timed) + f"; last losses: total "
        f"{m['total_loss']:.4f}, policy {m['policy_loss']:.4f}, vf "
        f"{m['vf_loss']:.4f}, entropy {m['entropy']:.4f}; flash launches "
        f"{dict(attn.LAUNCHES)}")
    if any(attn.LAUNCHES.values()):
        raise AssertionError(f"[appo] launched {attn.LAUNCHES}")
    del algo
    torch.cuda.empty_cache()
    return {"flash": dict(attn.LAUNCHES)}


def phase_memory(card) -> dict:
    """LSTM and attention PPO on StatelessCartPole at the tuned example's
    settings: best reward >= 150 within 120 iterations, a greedy
    evaluation, and one iteration profiled (launches, device time)."""
    out = {}
    for kind, model in MEMORY_MODELS.items():
        zero_launches()
        algo = (PPOConfig().environment("StatelessCartPole-v1")
                .anakin(num_envs=MEMORY_ENVS, unroll_length=MEMORY_UNROLL)
                .training(**MEMORY_TRAINING, model=model)
                .debugging(seed=SEED).build())
        best, iter_s = float("-inf"), []
        for i in range(MEMORY_MAX_ITERS):
            m = algo.train()
            iter_s.append(m["time_this_iter_s"])
            if np.isfinite(m["episode_reward_mean"]):
                best = max(best, m["episode_reward_mean"])
            if best >= MEMORY_FLOOR:
                break
        if best < MEMORY_FLOOR:
            raise AssertionError(f"[memory] {kind} PPO best reward "
                                 f"{best:.1f} < {MEMORY_FLOOR} after "
                                 f"{MEMORY_MAX_ITERS} iterations")
        evaluation = algo.evaluate(num_steps=500)["episode_reward_mean"]
        if not np.isfinite(evaluation):
            raise AssertionError(f"[memory] {kind} evaluate: {evaluation}")
        prof = profile_device(algo.train)
        # The first iteration warms the allocator and cuDNN/cuBLAS.
        ms = np.mean(iter_s[1:] or iter_s) * 1e3
        note("memory", **{f"{kind} iter_ms": ms, f"{kind} best": best})
        log(f"[memory] {card} | {kind} PPO StatelessCartPole "
            f"{MEMORY_ENVS} envs x {MEMORY_UNROLL} steps: best reward "
            f"{best:.1f} >= {MEMORY_FLOOR} at iteration {i + 1}; "
            f"{ms:.1f} ms an iteration (mean after the first); one "
            f"profiled iteration: {prof['launch_calls']} launch calls, "
            f"{prof['device_ops']} device ops, device busy "
            f"{prof['device_ms']:.1f} ms of {prof['wall_ms']:.1f} ms "
            f"({prof['device_ms'] / prof['wall_ms']:.1%}); greedy "
            f"evaluate() over 500 steps: {evaluation:.1f}; flash launches "
            f"{dict(attn.LAUNCHES)}")
        if any(attn.LAUNCHES.values()):
            raise AssertionError(f"[memory] launched {attn.LAUNCHES}")
        out[kind] = dict(attn.LAUNCHES)
        del algo
    return out


# ---------------------------------------------------------------------------
# The replay family in Anakin mode ([dqn], [sac], [td3]): the envs, the
# replay ring and the updates on the card, fp32 with TF32 off
# ---------------------------------------------------------------------------
# [dqn]: tests/test_dqn.py:56-77's configuration and gate (the reference's
# tuned_examples/dqn/cartpole-dqn.yaml bar): the BEST episode_reward_mean
# >= 150 within 90 iterations.
DQN_ANAKIN = {"num_envs": 128, "unroll_length": 16}
DQN_KNOBS = {"num_updates_per_iter": 16, "dqn_batch_size": 256,
             "epsilon_decay_steps": 60_000, "learning_starts": 2_000}
DQN_FLOOR, DQN_MAX_ITERS = 150.0, 90
# [sac] and [td3]: tests/test_sac_offline.py:57-78's and
# tests/test_more_algos.py:91-108's configuration and gate (best >= -300
# within 200 iterations; the reference's pendulum-sac.yaml reads ~-250).
# An episode lasts 200 steps, 50 iterations of 4: the reward moves at
# iterations 50, 100, 150 and 200.
PENDULUM_ANAKIN = {"num_envs": 32, "unroll_length": 4}
PENDULUM_KNOBS = {"num_updates_per_iter": 64, "learning_starts": 1000}
PENDULUM_FLOOR, PENDULUM_MAX_ITERS = -300.0, 200
# DDPG: TD3's configuration for DDPG_ITERS iterations, collecting only
# until DDPG_LEARNING_STARTS (128 env steps an iteration: the last 4
# update).
DDPG_ITERS, DDPG_LEARNING_STARTS = 5, 256
OFFPOLICY_PHASES = ("start", "rollout", "update")


def devices(tensors) -> set:
    """The device types the tensors among ``tensors`` lie on."""
    return {t.device.type for t in tensors if isinstance(t, torch.Tensor)}


def offpolicy_algo(config_cls, env, knobs, seed=SEED, **training):
    cfg = (config_cls().environment(env)
           .anakin(**(DQN_ANAKIN if env == "CartPole-v1"
                      else PENDULUM_ANAKIN))
           .training(**training).debugging(seed=seed))
    for k, v in knobs.items():
        setattr(cfg, k, v)
    return cfg.build()


def best_within(algo, tag, floor, max_iters, loss) -> dict:
    """The JAX tests' gate: train until the BEST episode_reward_mean >=
    ``floor``, within ``max_iters``; raises on a non-finite ``loss`` once
    the updates run.  Every iteration is split by CUDA events at the
    step's marks ("start", "rollout", "update"); the means are over the
    iterations that updated, with their env-steps/s by the host clock."""
    marks = []

    def mark(name):
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        marks.append((name, event, time.perf_counter()))

    algo.on_phase = mark
    best, met_at, warm, host_s = float("-inf"), None, [], 0.0
    t0 = time.perf_counter()
    for i in range(max_iters):
        m = algo.train()
        if np.isfinite(m["episode_reward_mean"]):
            best = max(best, m["episode_reward_mean"])
        updated = m["replay_size"] >= algo.config.learning_starts
        if updated:
            if not np.isfinite(m[loss]):
                raise AssertionError(f"[{tag}] iteration {i}: {m}")
            warm.append(i)
            host_s += m["time_this_iter_s"]
        if i % 20 == 0:
            log(f"[{tag}] iteration {i}: episode_reward_mean "
                f"{m['episode_reward_mean']:.2f} (best {best:.2f}), {loss} "
                f"{m[loss]:.4f}, {m['time_this_iter_s'] * 1e3:.1f} ms")
        if best >= floor:
            met_at = i
            break
    seconds = time.perf_counter() - t0
    algo.on_phase = None
    torch.cuda.synchronize()
    k = len(OFFPOLICY_PHASES)
    if [n for n, _, _ in marks] != list(OFFPOLICY_PHASES) * (i + 1):
        raise AssertionError(f"[{tag}] phase marks {marks[:k]}")
    rows = [marks[j * k:(j + 1) * k] for j in warm]
    split = {name: float(np.mean([r[n][1].elapsed_time(r[n + 1][1])
                                  for r in rows]))
             for n, name in enumerate(OFFPOLICY_PHASES[1:])}
    return {"met_at": met_at, "best": best, "iterations": i + 1,
            "seconds": seconds, "metrics": m, "split": split,
            "warm_iterations": len(warm),
            "iter_ms": host_s / max(1, len(warm)) * 1e3,
            "env_steps_per_s": len(warm) * algo._steps_per_iter
            / max(host_s, 1e-9)}


def profile_update(algo) -> dict:
    """One update of the algorithm's learner on a uniform draw from its
    ring, profiled (launch calls, device ops and time): eager, and
    replayed from its CUDA graph (under "graph")."""
    st = algo._anakin_state
    updates = st.updates

    def eager():
        updates.use_graphs = False
        try:
            return updates.update(st.replay.size, st.generator)
        finally:
            updates.use_graphs = True

    out = profile_device(eager, check=True)
    out["graph"] = profile_device(
        lambda: updates.update(st.replay.size, st.generator))
    return out


# A replayed update's graph against the same update run eagerly from the
# same state and draws: every parameter and optimizer-state tensor within
# this of its largest magnitude (the same kernels, unless cuBLAS picks
# another algorithm under capture).
GRAPH_EAGER_RTOL = 1e-5


def learner_tensors(learner) -> list:
    """Every tensor an update changes: the modules' parameters (targets
    included), ``log_alpha``, the optimizers' states."""
    out = []
    for value in vars(learner).values():
        if isinstance(value, torch.nn.Module):
            out += list(value.parameters())
        elif isinstance(value, torch.nn.Parameter):
            out.append(value)
        elif isinstance(value, torch.optim.Optimizer):
            out += [t for st in value.state.values() for t in st.values()
                    if isinstance(t, torch.Tensor)]
    return list({id(t): t for t in out}.values())


def graph_against_eager(algo) -> dict:
    """One update through the captured graph, then, from the state and
    generator as they were, the same update eagerly: the largest
    difference over every tensor it changed, relative to that tensor's
    largest magnitude."""
    st, learner = algo._anakin_state, algo.learner
    updates = st.updates
    if not updates.graphs or learner.step_kind() not in updates.graphs:
        raise AssertionError(f"no captured graph: {updates.warm}")
    tensors = learner_tensors(learner)
    saved = [t.detach().clone() for t in tensors]
    counts = dict(vars(learner))
    gen_state = st.generator.get_state()
    with torch.no_grad():
        updates.update(st.replay.size, st.generator)
        after_graph = [t.detach().clone() for t in tensors]
        for t, v in zip(tensors, saved):
            t.copy_(v)
    for k in ("update_count", "policy_updates"):
        if k in counts:
            setattr(learner, k, counts[k])
    st.generator.set_state(gen_state)
    updates.use_graphs = False
    try:
        updates.update(st.replay.size, st.generator)
    finally:
        updates.use_graphs = True
    worst, bitwise = 0.0, True
    for t, g in zip(tensors, after_graph):
        e = t.detach()
        bitwise = bitwise and torch.equal(e, g)
        scale = max(e.abs().max().item(), 1e-12) if e.numel() else 1.0
        worst = max(worst, (e - g).abs().max().item() / scale
                    if e.numel() else 0.0)
    if worst > GRAPH_EAGER_RTOL:
        raise AssertionError(f"graph vs eager update: {worst:.3g}")
    return {"rel": worst, "bitwise": bitwise, "tensors": len(tensors),
            "replays": updates.replays, "graphs": len(updates.graphs)}


def offpolicy_line(tag, card, what, gate, prof) -> str:
    split = gate["split"]
    return (f"[{tag}] {card} | {what}: best episode_reward_mean "
            f"{gate['best']:.2f} at iteration {gate['met_at']} of "
            f"{gate['iterations']} ({gate['seconds']:.1f} s); over the "
            f"{gate['warm_iterations']} iterations that updated "
            f"{gate['iter_ms']:.1f} ms an iteration, "
            f"{gate['env_steps_per_s']:.0f} env-steps/s, by CUDA events "
            f"rollout {split['rollout']:.2f} ms and updates "
            f"{split['update']:.2f} ms; one update profiled: "
            f"{prof['launch_calls']} launch calls, {prof['device_ops']} "
            f"device ops, {prof['device_ms']:.3f} ms on the card of "
            f"{prof['wall_ms']:.3f} ms eager, "
            f"{prof['graph']['launch_calls']} launch calls, "
            f"{prof['graph']['device_ms']:.3f} ms of "
            f"{prof['graph']['wall_ms']:.3f} ms replayed from its graph; "
            f"the updates replayed "
            f"{gate['graph']['replays']} times from "
            f"{gate['graph']['graphs']} CUDA graph(s), one against the "
            f"same update eager: max relative difference "
            f"{gate['graph']['rel']:.3g} over {gate['graph']['tensors']} "
            f"tensors (bitwise {gate['graph']['bitwise']}); flash launches "
            f"{dict(attn.LAUNCHES)}")


def phase_dqn(card) -> dict:
    """Anakin DQN on CartPole-v1 at tests/test_dqn.py's configuration:
    the gate, ms an iteration split into rollout and updates, env-steps/s,
    one update profiled."""
    zero_launches()
    algo = offpolicy_algo(DQNConfig, "CartPole-v1", DQN_KNOBS, lr=1e-3)
    where = devices([*algo.module.parameters(),
                     *vars(algo._anakin_state.replay).values()])
    if where != {"cuda"}:
        raise AssertionError(f"[dqn] parameters and ring on {where}")
    gate = best_within(algo, "dqn", DQN_FLOOR, DQN_MAX_ITERS, "total_loss")
    if gate["met_at"] is None:
        raise AssertionError(f"[dqn] best reward {gate['best']:.2f} < "
                             f"{DQN_FLOOR} within {DQN_MAX_ITERS}")
    gate["graph"] = graph_against_eager(algo)
    prof = profile_update(algo)
    note("dqn", met_at=gate["met_at"], best=gate["best"],
         iter_ms=gate["iter_ms"], env_steps_per_s=gate["env_steps_per_s"],
         rollout_ms=gate["split"]["rollout"],
         update_ms=gate["split"]["update"],
         update_launch_calls=prof["launch_calls"],
         graph_update_ms=prof["graph"]["wall_ms"])
    log(offpolicy_line(
        "dqn", card, f"DQN CartPole-v1 {DQN_ANAKIN['num_envs']} envs x "
        f"{DQN_ANAKIN['unroll_length']} steps, "
        f"{DQN_KNOBS['num_updates_per_iter']} double-Q updates of "
        f"{DQN_KNOBS['dqn_batch_size']} an iteration, fp32, TF32 off",
        gate, prof))
    if any(attn.LAUNCHES.values()):
        raise AssertionError(f"[dqn] launched {attn.LAUNCHES}")
    return {"flash": dict(attn.LAUNCHES)}


def phase_sac(card) -> dict:
    """Anakin SAC on PendulumContinuous-v1 at tests/test_sac_offline.py's
    configuration: the gate, ms an iteration split into rollout and
    updates, one update profiled."""
    zero_launches()
    algo = offpolicy_algo(SACConfig, "PendulumContinuous-v1", PENDULUM_KNOBS)
    gate = best_within(algo, "sac", PENDULUM_FLOOR, PENDULUM_MAX_ITERS,
                       "critic_loss")
    if gate["met_at"] is None:
        raise AssertionError(f"[sac] best reward {gate['best']:.2f} < "
                             f"{PENDULUM_FLOOR} within {PENDULUM_MAX_ITERS}")
    gate["graph"] = graph_against_eager(algo)
    prof = profile_update(algo)
    m = gate["metrics"]
    note("sac", met_at=gate["met_at"], best=gate["best"],
         iter_ms=gate["iter_ms"], rollout_ms=gate["split"]["rollout"],
         update_ms=gate["split"]["update"],
         update_launch_calls=prof["launch_calls"],
         graph_update_ms=prof["graph"]["wall_ms"], alpha=m["alpha"])
    log(offpolicy_line(
        "sac", card, f"SAC PendulumContinuous-v1 "
        f"{PENDULUM_ANAKIN['num_envs']} envs x "
        f"{PENDULUM_ANAKIN['unroll_length']} steps, "
        f"{PENDULUM_KNOBS['num_updates_per_iter']} updates (critic, actor, "
        f"alpha) of {algo.config.sac_batch_size} an iteration, fp32, TF32 "
        f"off; alpha {m['alpha']:.4f}", gate, prof))
    if any(attn.LAUNCHES.values()):
        raise AssertionError(f"[sac] launched {attn.LAUNCHES}")
    return {"flash": dict(attn.LAUNCHES)}


def phase_td3(card) -> dict:
    """Anakin TD3 on PendulumContinuous-v1 at tests/test_more_algos.py's
    configuration, gated as SAC; then DDPG for DDPG_ITERS iterations:
    finite losses, a policy step at every update."""
    zero_launches()
    algo = offpolicy_algo(TD3Config, "PendulumContinuous-v1", PENDULUM_KNOBS)
    gate = best_within(algo, "td3", PENDULUM_FLOOR, PENDULUM_MAX_ITERS,
                       "critic_loss")
    if gate["met_at"] is None:
        raise AssertionError(f"[td3] best reward {gate['best']:.2f} < "
                             f"{PENDULUM_FLOOR} within {PENDULUM_MAX_ITERS}")
    learner = algo.learner
    if learner.policy_updates != -(-learner.update_count // 2):
        raise AssertionError(f"[td3] {learner.policy_updates} policy steps "
                             f"in {learner.update_count} updates")
    gate["graph"] = graph_against_eager(algo)
    prof = profile_update(algo)
    del algo
    ddpg = offpolicy_algo(DDPGConfig, "PendulumContinuous-v1",
                          {**PENDULUM_KNOBS,
                           "learning_starts": DDPG_LEARNING_STARTS})
    t0 = time.perf_counter()
    losses = [ddpg.train() for _ in range(DDPG_ITERS)]
    ddpg_s = time.perf_counter() - t0
    dl = ddpg.learner
    updated = [m for m in losses
               if m["replay_size"] >= DDPG_LEARNING_STARTS]
    if not (len(updated) == DDPG_ITERS - 1 and all(
            np.isfinite(m["critic_loss"]) and np.isfinite(m["actor_loss"])
            for m in updated) and dl.policy_updates == dl.update_count
            == len(updated) * PENDULUM_KNOBS["num_updates_per_iter"]):
        raise AssertionError(f"[td3] DDPG: {losses[-1]}, "
                             f"{dl.policy_updates} policy steps in "
                             f"{dl.update_count} updates")
    note("td3", met_at=gate["met_at"], best=gate["best"],
         iter_ms=gate["iter_ms"], rollout_ms=gate["split"]["rollout"],
         update_ms=gate["split"]["update"],
         update_launch_calls=prof["launch_calls"],
         graph_update_ms=prof["graph"]["wall_ms"], ddpg_s=ddpg_s)
    log(offpolicy_line(
        "td3", card, f"TD3 PendulumContinuous-v1 "
        f"{PENDULUM_ANAKIN['num_envs']} envs x "
        f"{PENDULUM_ANAKIN['unroll_length']} steps, "
        f"{PENDULUM_KNOBS['num_updates_per_iter']} updates of "
        f"{TD3Config().td3_batch_size} an iteration (a policy step every "
        f"2nd), fp32, TF32 off", gate, prof)
        + f"; DDPG {DDPG_ITERS} iterations in {ddpg_s:.2f} s: critic loss "
        f"{updated[-1]['critic_loss']:.4f}, actor loss "
        f"{updated[-1]['actor_loss']:.4f}, {dl.policy_updates} policy "
        f"steps in {dl.update_count} updates")
    if any(attn.LAUNCHES.values()):
        raise AssertionError(f"[td3] launched {attn.LAUNCHES}")
    return {"flash": dict(attn.LAUNCHES)}


# ---------------------------------------------------------------------------
# The rest of RLlib ([offline], [es], [bandit], [dynaq], [qmix], [mappo]):
# each at its JAX test's configuration, gate and iteration budget, on the
# card in fp32 with TF32 off; then the train CLI on a JSON file ([cli])
# ---------------------------------------------------------------------------
# [offline], BC: tests/test_sac_offline.py:120-168 — a PPO expert on
# CartPole-v1 (32 envs x 64 steps) trained until its best reward reaches
# 400 within 80 iterations (and must reach 150), its greedy rollout (32 x
# 64) written with JsonWriter, BC for 30 iterations: bc_loss < 0.3 and a
# greedy score >= 100 over 500 steps.
BC_EXPERT = {"num_envs": 32, "unroll_length": 64}
BC_EXPERT_TRAINING = {"lr": 3e-4, "num_sgd_iter": 4,
                      "sgd_minibatch_size": 512, "entropy_coeff": 0.01}
BC_EXPERT_STOP, BC_EXPERT_FLOOR, BC_EXPERT_MAX_ITERS = 400.0, 150.0, 80
BC_ITERS, BC_LOSS_BOUND, BC_SCORE_FLOOR = 30, 0.3, 100.0
# [offline], MARWIL: tests/test_more_algos.py:160-212 — 32 envs x 96
# steps of a balancing heuristic diluted with 60% random actions, beta 2,
# 40 iterations, a greedy score >= 250 over 500 steps.
MARWIL_FRAC_RANDOM, MARWIL_ITERS, MARWIL_SCORE_FLOOR = 0.6, 40, 250.0
OFFLINE_EVAL_STEPS = 500
# [es]: tests/test_algo_families.py — population 128, sigma 0.1, lr
# 0.03, 200-step episodes: best >= 120 within 30 generations.
ES_TRAINING = {"population_size": 128, "noise_stdev": 0.1, "lr": 0.03,
               "episode_length": 200}
ES_FLOOR, ES_MAX_ITERS = 120.0, 30
# [bandit]: the 9th iteration's regret < 0.3x the first's (LinUCB seed 0,
# LinTS seed 1), 256 rounds an iteration.
BANDIT_ITERS, BANDIT_REGRET_RATIO = 9, 0.3
BANDITS = ((BanditLinUCBConfig, "LinUCB", 0), (BanditLinTSConfig, "LinTS",
                                                 1))
# [dynaq]: 32 envs x 16 steps, lr 1e-3, learning_starts 500, 8 Q updates
# an iteration, epsilon over 15,000 steps: best >= 100 within 80
# iterations, and the model loss falls.
DYNAQ_ANAKIN = {"num_envs": 32, "unroll_length": 16}
DYNAQ_TRAINING = {"lr": 1e-3, "learning_starts": 500,
                  "num_updates_per_iter": 8, "epsilon_decay_steps": 15_000}
DYNAQ_FLOOR, DYNAQ_MAX_ITERS = 100.0, 80
# [qmix]: the default QMixConfig on CoordinationGame-v0: best >= 12 of 16
# within 150 iterations.
QMIX_FLOOR, QMIX_MAX_ITERS = 12.0, 150
# [mappo]: tests/test_multi_agent.py — 32 games x 32 steps, lr 1e-3, 4
# epochs of 512: best team return >= 28 within 60 iterations.
MAPPO_ANAKIN = {"num_envs": 32, "unroll_length": 32}
MAPPO_TRAINING = {"lr": 1e-3, "num_sgd_iter": 4, "sgd_minibatch_size": 512,
                  "entropy_coeff": 0.01}
MAPPO_FLOOR, MAPPO_MAX_ITERS = 28.0, 60
# [cli]: `python -m ray_tpu_torch.rllib.train -f <json>` on the card.
# The device of these phases' own tensors (the expert's and the scripted
# rollouts, MAPPO's profiled minibatch).
RL_DEVICE = "cuda"
CLI_EXPERIMENT = {"linucb": {"run": "BanditLinUCB",
                             "env": "LinearBandit-v0",
                             "stop": {"training_iteration": 2},
                             "config": {"seed": 0}}}


def no_flash(tag) -> dict:
    if any(attn.LAUNCHES.values()):
        raise AssertionError(f"[{tag}] launched {attn.LAUNCHES}")
    return {"flash": dict(attn.LAUNCHES)}


def on_card(tag, tensors) -> None:
    where = devices(tensors)
    if where != {"cuda"}:
        raise AssertionError(f"[{tag}] state on {where}")


def marked_iteration(algo, names) -> tuple:
    """One ``algo.train()`` with a CUDA event at each phase its step
    marks: (metrics, ms between consecutive marks by name)."""
    marks = []

    def mark(name):
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        marks.append((name, event))

    algo.on_phase = mark
    m = algo.train()
    algo.on_phase = None
    torch.cuda.synchronize()
    if [n for n, _ in marks] != list(names):
        raise AssertionError(f"phase marks {[n for n, _ in marks]}")
    return m, {names[j + 1]: marks[j][1].elapsed_time(marks[j + 1][1])
               for j in range(len(names) - 1)}


def eager_and_graphed(calls, fn) -> dict:
    """``fn()`` profiled with ``calls`` (a ``CapturedCalls``) eager, then
    replayed from its graph: launch calls and device ms of each."""
    calls.use_graphs = False
    try:
        eager = profile_device(fn)
    finally:
        calls.use_graphs = True
    graph = profile_device(fn)
    return {"eager": eager, "graph": graph}


def launch_text(prof, what) -> str:
    return (f"{what}: {prof['eager']['launch_calls']} launch calls, "
            f"{prof['eager']['device_ms']:.3f} ms on the card of "
            f"{prof['eager']['wall_ms']:.3f} ms eager; "
            f"{prof['graph']['launch_calls']} launch calls, "
            f"{prof['graph']['device_ms']:.3f} ms of "
            f"{prof['graph']['wall_ms']:.3f} ms from its CUDA graph")


def write_batch(path, columns) -> str:
    writer = JsonWriter(path)
    writer.write(SampleBatch(columns))
    writer.close()
    return path


def expert_rollout(path, module, num_envs=32, steps=64, seed=3) -> str:
    """The expert's greedy rollout on the card, written with JsonWriter."""
    env = make_torch_env("CartPole-v1")
    g = torch.Generator(device=RL_DEVICE).manual_seed(seed)
    states, obs = env.reset(num_envs, g, RL_DEVICE)
    all_obs, all_act = [], []
    with torch.no_grad():
        for _ in range(steps):
            act = module.forward_inference(obs)
            states, obs2, _r, _d, _ = env.step(states, act, g)
            all_obs.append(obs)
            all_act.append(act)
            obs = obs2
    return write_batch(path, {"obs": torch.cat(all_obs).cpu().numpy(),
                              "actions": torch.cat(all_act).cpu().numpy()})


def scripted_rollout(path, frac_random, num_envs=32, steps=96, seed=0):
    """tests/test_more_algos.py's mixture data on the card: the balancing
    heuristic, diluted with random actions, env-major, each env's last
    step marked done."""
    env = make_torch_env("CartPole-v1")
    g = torch.Generator(device=RL_DEVICE).manual_seed(seed)
    states, obs = env.reset(num_envs, g, RL_DEVICE)
    cols = {"obs": [], "actions": [], "rewards": [], "dones": []}
    for _ in range(steps):
        good = (obs[:, 2] + 0.3 * obs[:, 3] > 0).to(torch.int64)
        rand = torch.randint(0, 2, good.shape, generator=g,
                             device=RL_DEVICE)
        use_rand = torch.rand(good.shape, generator=g,
                              device=RL_DEVICE) < frac_random
        act = torch.where(use_rand, rand, good)
        states, obs2, rew, done, _ = env.step(states, act, g)
        for k, v in (("obs", obs), ("actions", act), ("rewards", rew),
                     ("dones", done.to(torch.float32))):
            cols[k].append(v)
        obs = obs2
    cols["dones"][-1] = torch.ones(num_envs, device=RL_DEVICE)
    stacked = {k: torch.stack(v, 1).reshape(-1, *v[0].shape[1:]).cpu()
               .numpy() for k, v in cols.items()}
    return write_batch(path, stacked)


def offline_run(algo, iters, tag) -> dict:
    """``iters`` iterations of BC or MARWIL (host-timed, each ending in its
    metrics' read), the greedy score, one pass profiled eager and from its
    graph."""
    loss_key = "bc_loss" if tag == "BC" else "marwil_loss"
    on_card(tag, [*algo.module.parameters(), *algo._data.values()])
    first_met, host_s = None, []
    for i in range(iters):
        m = algo.train()
        host_s.append(m["time_this_iter_s"])
        if not np.isfinite(m[loss_key]):
            raise AssertionError(f"[offline] {tag} iteration {i}: {m}")
        if tag == "BC" and first_met is None and m[loss_key] < BC_LOSS_BOUND:
            first_met = i
    t0 = time.perf_counter()
    score = algo.evaluate(num_steps=OFFLINE_EVAL_STEPS)["episode_reward_mean"]
    eval_s = time.perf_counter() - t0
    prof = eager_and_graphed(algo._calls,
                             lambda: algo._calls.run(algo._sgd_pass))
    return {"metrics": m, "score": score, "eval_s": eval_s,
            "first_met": first_met, "prof": prof,
            "iter_ms": float(np.mean(host_s[1:] or host_s)) * 1e3,
            "updates": algo.config.num_sgd_per_iter}


def phase_offline(card) -> dict:
    """BC and MARWIL at their JAX tests' configurations and gates (see
    BC_EXPERT and MARWIL_FRAC_RANDOM), from JSON-lines files written and
    read back through ``rllib/offline``."""
    import tempfile

    zero_launches()
    t0 = time.perf_counter()
    expert = (PPOConfig().environment("CartPole-v1").anakin(**BC_EXPERT)
              .training(**BC_EXPERT_TRAINING).debugging(seed=SEED).build())
    best, expert_iters = float("-inf"), 0
    for expert_iters in range(1, BC_EXPERT_MAX_ITERS + 1):
        r = expert.train()["episode_reward_mean"]
        if np.isfinite(r):
            best = max(best, r)
        if best >= BC_EXPERT_STOP:
            break
    if best < BC_EXPERT_FLOOR:
        raise AssertionError(f"[offline] the PPO expert reached {best:.2f}")
    expert_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as root:
        path = expert_rollout(os.path.join(root, "expert"), expert.module)
        bc = (BCConfig().environment("CartPole-v1").offline_data(input_=path)
              .training(lr=1e-3).debugging(seed=SEED).build())
        bc_run = offline_run(bc, BC_ITERS, "BC")
        path = scripted_rollout(os.path.join(root, "mix"), MARWIL_FRAC_RANDOM)
        cfg = (MARWILConfig().environment("CartPole-v1")
               .offline_data(input_=path).training(lr=1e-3)
               .debugging(seed=SEED))
        cfg.beta = 2.0
        marwil_run = offline_run(cfg.build(), MARWIL_ITERS, "MARWIL")
    bc_loss = bc_run["metrics"]["bc_loss"]
    if not (bc_loss < BC_LOSS_BOUND and bc_run["score"] >= BC_SCORE_FLOOR):
        raise AssertionError(f"[offline] BC: loss {bc_loss:.4f}, score "
                             f"{bc_run['score']:.2f}")
    m = marwil_run["metrics"]
    if not (marwil_run["score"] >= MARWIL_SCORE_FLOOR
            and m["ma_adv_norm"] > 0):
        raise AssertionError(f"[offline] MARWIL: score "
                             f"{marwil_run['score']:.2f}, {m}")
    note("offline", expert_iters=expert_iters, expert_best=best,
         expert_s=expert_s, bc_loss=bc_loss, bc_score=bc_run["score"],
         bc_loss_met_at=bc_run["first_met"], bc_iter_ms=bc_run["iter_ms"],
         marwil_score=marwil_run["score"],
         marwil_iter_ms=marwil_run["iter_ms"],
         pass_launch_calls=bc_run["prof"]["eager"]["launch_calls"],
         graph_launch_calls=bc_run["prof"]["graph"]["launch_calls"])
    for tag, run, gate in (
            ("BC", bc_run, f"bc_loss {bc_loss:.4f} < {BC_LOSS_BOUND} "
             f"(first below it at iteration {bc_run['first_met']}), greedy "
             f"score {bc_run['score']:.2f} >= {BC_SCORE_FLOOR} after "
             f"{BC_ITERS} iterations; expert PPO best {best:.2f} in "
             f"{expert_iters} iterations ({expert_s:.1f} s)"),
            ("MARWIL", marwil_run, f"greedy score {marwil_run['score']:.2f}"
             f" >= {MARWIL_SCORE_FLOOR} after {MARWIL_ITERS} iterations, "
             f"marwil_loss {m['marwil_loss']:.4f}, ma_adv_norm "
             f"{m['ma_adv_norm']:.3f}")):
        log(f"[offline] {card} | {tag} CartPole-v1, {run['updates']} "
            f"minibatch updates an iteration, fp32, TF32 off: {gate}; "
            f"{run['iter_ms']:.2f} ms an iteration (mean after the first), "
            f"evaluate {run['eval_s']:.2f} s; "
            + launch_text(run["prof"], f"one pass of {run['updates']} "
                          "updates"))
    return no_flash("offline")


def phase_es(card) -> dict:
    """ES on CartPole-v1 at tests/test_algo_families.py's configuration:
    the gate, ms a generation, one generation eager and from its graph."""
    zero_launches()
    algo = (ESConfig().environment("CartPole-v1").training(**ES_TRAINING)
            .debugging(seed=SEED).build())
    on_card("es", [algo.flat, algo._eps, algo._init_core])
    best, met_at, host_s = float("-inf"), None, []
    for i in range(ES_MAX_ITERS):
        m = algo.train()
        host_s.append(m["time_this_iter_s"])
        best = max(best, m["episode_reward_mean"])
        if best >= ES_FLOOR:
            met_at = i
            break
    if met_at is None:
        raise AssertionError(f"[es] best {best:.2f} < {ES_FLOOR} within "
                             f"{ES_MAX_ITERS}")
    prof = eager_and_graphed(algo._calls, algo.train)
    ms = float(np.mean(host_s[1:] or host_s)) * 1e3
    note("es", met_at=met_at, best=best, gen_ms=ms,
         env_steps_per_s=algo._steps_per_iter / ms * 1e3,
         eager_launch_calls=prof["eager"]["launch_calls"],
         graph_launch_calls=prof["graph"]["launch_calls"])
    log(f"[es] {card} | ES CartPole-v1 population "
        f"{ES_TRAINING['population_size']} x {ES_TRAINING['episode_length']}"
        f" steps, fp32, TF32 off: best episode_reward_mean {best:.2f} at "
        f"generation {met_at}; {ms:.2f} ms a generation (mean after the "
        f"first), {algo._steps_per_iter / ms * 1e3:.0f} env-steps/s; "
        + launch_text(prof, "one generation"))
    return no_flash("es")


def phase_bandit(card) -> dict:
    """LinUCB and LinTS on LinearBandit-v0: the regret gate, ms an
    iteration, one iteration's rounds eager and from its graph."""
    zero_launches()
    parts = []
    for cls, name, seed in BANDITS:
        algo = cls().debugging(seed=seed).build()
        st = algo._anakin_state
        on_card("bandit", [st.A_inv, st.b, algo._xs])
        runs = [algo.train() for _ in range(BANDIT_ITERS)]
        first, last = runs[0]["regret_this_iter"], runs[-1][
            "regret_this_iter"]
        if not last < BANDIT_REGRET_RATIO * max(first, 1e-9):
            raise AssertionError(f"[bandit] {name}: regret {last:.4f} "
                                 f"against the first {first:.4f}")
        prof = eager_and_graphed(algo._calls, algo.train)
        ms = float(np.mean([m["time_this_iter_s"] for m in runs[1:]])) * 1e3
        note("bandit", **{f"{name} regret_ratio": last / first,
                          f"{name} iter_ms": ms,
                          f"{name} eager_launch_calls":
                              prof["eager"]["launch_calls"]})
        parts.append(
            f"{name} (seed {seed}): regret {first:.3f} in the first "
            f"iteration, {last:.3f} in the {BANDIT_ITERS}th "
            f"({last / first:.3f}x < {BANDIT_REGRET_RATIO}x), mean reward "
            f"{runs[-1]['episode_reward_mean']:.3f}; {ms:.2f} ms an "
            f"iteration of {algo.config.rounds_per_iter} rounds; "
            + launch_text(prof, "one iteration"))
    log(f"[bandit] {card} | fp32, TF32 off: " + "; ".join(parts))
    return no_flash("bandit")


def replay_gate(algo, tag, floor, max_iters, extra=None) -> dict:
    """The JAX tests' gate for the replay-family step (best reward >=
    ``floor`` within ``max_iters``), each iteration split by CUDA events
    into its rollout and its updates; ``extra(metrics)`` sees every
    iteration's metrics."""
    best, met_at, rows, host_s = float("-inf"), None, [], []
    for i in range(max_iters):
        m, split = marked_iteration(algo, OFFPOLICY_PHASES)
        if np.isfinite(m["episode_reward_mean"]):
            best = max(best, m["episode_reward_mean"])
        if extra is not None:
            extra(m)
        if m["replay_size"] >= algo.config.learning_starts:
            if not np.isfinite(m["total_loss"]):
                raise AssertionError(f"[{tag}] iteration {i}: {m}")
            rows.append(split)
            host_s.append(m["time_this_iter_s"])
        if best >= floor:
            met_at = i
            break
    if met_at is None:
        raise AssertionError(f"[{tag}] best {best:.2f} < {floor} within "
                             f"{max_iters}")
    return {"met_at": met_at, "best": best, "metrics": m,
            "iter_ms": float(np.mean(host_s)) * 1e3,
            "rollout_ms": float(np.mean([r["rollout"] for r in rows])),
            "update_ms": float(np.mean([r["update"] for r in rows]))}


def replay_update_profile(updates, size, generator) -> dict:
    return eager_and_graphed(updates, lambda: updates.update(size,
                                                             generator))


def phase_dynaq(card) -> dict:
    """Dyna-Q on CartPole-v1 at tests/test_algo_families.py's
    configuration: the gate and the model's falling loss, ms an iteration
    by part, one Q update and one model update eager and graphed."""
    zero_launches()
    algo = (DynaQConfig().environment("CartPole-v1").anakin(**DYNAQ_ANAKIN)
            .training(**DYNAQ_TRAINING).debugging(seed=SEED).build())
    st = algo._anakin_state
    on_card("dynaq", [*algo.module.parameters(), st.replay.obs])
    model_losses = []
    gate = replay_gate(algo, "dynaq", DYNAQ_FLOOR, DYNAQ_MAX_ITERS,
                       lambda m: model_losses.append(m["model_loss"]))
    if not model_losses[-1] < model_losses[0]:
        raise AssertionError(f"[dynaq] model loss {model_losses[0]:.4f} -> "
                             f"{model_losses[-1]:.4f}")
    st = algo._anakin_state
    q = replay_update_profile(st.updates, st.replay.size, st.generator)
    model = replay_update_profile(algo.learner.model_updates,
                                  st.replay.size, st.generator)
    note("dynaq", met_at=gate["met_at"], best=gate["best"],
         iter_ms=gate["iter_ms"], rollout_ms=gate["rollout_ms"],
         update_ms=gate["update_ms"], model_loss_first=model_losses[0],
         model_loss_last=model_losses[-1],
         q_eager_launch_calls=q["eager"]["launch_calls"],
         model_eager_launch_calls=model["eager"]["launch_calls"])
    log(f"[dynaq] {card} | Dyna-Q CartPole-v1 {DYNAQ_ANAKIN['num_envs']} "
        f"envs x {DYNAQ_ANAKIN['unroll_length']} steps, "
        f"{algo.config.model_updates_per_iter} model fits and "
        f"{DYNAQ_TRAINING['num_updates_per_iter']} Q updates (128 real + "
        f"128 imagined rows) an iteration, fp32, TF32 off: best "
        f"episode_reward_mean {gate['best']:.2f} at iteration "
        f"{gate['met_at']}, model loss {model_losses[0]:.4f} -> "
        f"{model_losses[-1]:.4f}; {gate['iter_ms']:.2f} ms an iteration "
        f"once updating (rollout {gate['rollout_ms']:.2f} ms, model fits "
        f"and Q updates {gate['update_ms']:.2f} ms by CUDA events); "
        + launch_text(q, "one Q update") + "; "
        + launch_text(model, "one model fit"))
    return no_flash("dynaq")


def phase_qmix(card) -> dict:
    """QMIX on CoordinationGame-v0 at tests/test_algo_families.py's
    configuration: the gate, ms an iteration by part, one update eager
    and graphed."""
    zero_launches()
    algo = QMixConfig().environment("CoordinationGame-v0").debugging(
        seed=SEED).build()
    st = algo._anakin_state
    on_card("qmix", [*algo.module.parameters(), st.replay.obs])
    gate = replay_gate(algo, "qmix", QMIX_FLOOR, QMIX_MAX_ITERS)
    st = algo._anakin_state
    prof = replay_update_profile(st.updates, st.replay.size, st.generator)
    note("qmix", met_at=gate["met_at"], best=gate["best"],
         iter_ms=gate["iter_ms"], rollout_ms=gate["rollout_ms"],
         update_ms=gate["update_ms"],
         eager_launch_calls=prof["eager"]["launch_calls"])
    c = algo.config
    log(f"[qmix] {card} | QMIX CoordinationGame-v0 {c.num_envs} games x "
        f"{c.unroll_length} steps, {c.num_updates_per_iter} mixed TD "
        f"updates of {c.qmix_batch_size} an iteration, fp32, TF32 off: "
        f"best episode_reward_mean {gate['best']:.2f} at iteration "
        f"{gate['met_at']}; {gate['iter_ms']:.2f} ms an iteration once "
        f"updating (rollout {gate['rollout_ms']:.2f} ms, updates "
        f"{gate['update_ms']:.2f} ms by CUDA events); "
        + launch_text(prof, "one update"))
    return no_flash("qmix")


def phase_mappo(card) -> dict:
    """MAPPO on CoordinationGame-v0 at tests/test_multi_agent.py's
    configuration: the gate, ms an iteration by part, one minibatch
    update profiled eager, one iteration eager and with its updates from
    their CUDA graphs."""
    zero_launches()
    algo = (MAPPOConfig().environment("CoordinationGame-v0")
            .anakin(**MAPPO_ANAKIN).training(**MAPPO_TRAINING)
            .debugging(seed=SEED).build())
    on_card("mappo", list(algo.module.parameters()))
    best, met_at, rows = float("-inf"), None, []
    for i in range(MAPPO_MAX_ITERS):
        m, split = marked_iteration(algo, ("start", "rollout", "gae", "sgd"))
        rows.append((m["time_this_iter_s"], split))
        if not np.isfinite(m["total_loss"]):
            raise AssertionError(f"[mappo] iteration {i}: {m}")
        if np.isfinite(m["episode_reward_mean"]):
            best = max(best, m["episode_reward_mean"])
        if best >= MAPPO_FLOOR:
            met_at = i
            break
    if met_at is None:
        raise AssertionError(f"[mappo] best {best:.2f} < {MAPPO_FLOOR} "
                             f"within {MAPPO_MAX_ITERS}")
    st = algo._anakin_state
    module, params = st.module, list(st.module.parameters())
    G, T = MAPPO_ANAKIN["num_envs"], MAPPO_ANAKIN["unroll_length"]
    mb = MAPPO_TRAINING["sgd_minibatch_size"]
    obs = st.obs.reshape(G * 2, -1).repeat(mb // (G * 2), 1)
    with torch.no_grad():
        actions, logp, value = module.forward_exploration(obs, st.generator)
    batch = {"obs": obs, "actions": actions, "action_logp": logp,
             "advantages": torch.randn(mb, device=RL_DEVICE),
             "value_targets": value}
    from ray_tpu_torch.rllib.algorithms.ppo import ppo_loss

    def one_update():
        loss, _ = ppo_loss(module, batch, clip_param=0.2, vf_clip_param=10.0,
                           vf_loss_coeff=0.5, entropy_coeff=0.01)
        grads = rl_mesh.clip_by_global_norm(
            torch.autograd.grad(loss, params), algo.config.grad_clip)
        for p, g in zip(params, grads):
            p.grad = g
        st.optimizer.step()

    prof = profile_device(one_update)
    iteration = eager_and_graphed(algo._train_step.graphs, algo.train)
    ms = float(np.mean([r[0] for r in rows[1:] or rows])) * 1e3
    split = {k: float(np.mean([r[1][k] for r in rows[1:] or rows]))
             for k in ("rollout", "gae", "sgd")}
    updates = algo.config.num_sgd_iter * (G * T * 2 // mb)
    note("mappo", met_at=met_at, best=best, iter_ms=ms,
         rollout_ms=split["rollout"], sgd_ms=split["sgd"],
         update_launch_calls=prof["launch_calls"],
         iteration_launch_calls_eager=iteration["eager"]["launch_calls"],
         iteration_launch_calls_graphed=iteration["graph"]["launch_calls"])
    log(f"[mappo] {card} | MAPPO CoordinationGame-v0 {G} games x {T} steps"
        f" x 2 agents folded, {updates} minibatch updates an iteration, "
        f"fp32, TF32 off: best team return {best:.2f} at iteration "
        f"{met_at}; {ms:.2f} ms an iteration (rollout "
        f"{split['rollout']:.2f}, GAE {split['gae']:.2f}, SGD "
        f"{split['sgd']:.2f} by CUDA events, mean after the first); one "
        f"minibatch update: {prof['launch_calls']} launch calls, "
        f"{prof['device_ms']:.3f} ms on the card of {prof['wall_ms']:.3f} "
        f"ms eager; " + launch_text(iteration, f"one iteration ({updates} "
                                    "updates)"))
    return no_flash("mappo")


def start_cli() -> dict:
    """Starts ``python -m ray_tpu_torch.rllib.train -f <json>`` in a
    process of its own on the card (no device in the file: CUDA by
    default), with a checkpoint directory; it runs beside the phases that
    follow until ``phase_cli`` collects it."""
    import tempfile

    tmp = tempfile.mkdtemp()
    path = os.path.join(tmp, "experiments.json")
    with open(path, "w") as f:
        json.dump(CLI_EXPERIMENT, f)
    proc = subprocess.Popen(
        [sys.executable, "-m", "ray_tpu_torch.rllib.train", "-f", path,
         "--checkpoint-dir", os.path.join(tmp, "ckpt")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    return {"proc": proc, "tmp": tmp, "t0": time.perf_counter()}


def phase_cli(card, cli) -> dict:
    """The started CLI's exit code, its JSON result and its checkpoint."""
    import shutil

    proc = cli["proc"]
    try:
        stdout, stderr = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    seconds = time.perf_counter() - cli["t0"]
    try:
        if proc.returncode != 0:
            raise AssertionError(f"[cli] exit {proc.returncode}: "
                                 f"{stderr[-2000:]}")
        out = json.loads(stdout.strip().splitlines()[-1])["linucb"]
        ckpt = os.path.join(cli["tmp"], "ckpt", "linucb", "checkpoint.pkl")
        if not (out["training_iteration"] == 2 and out["rounds"] == 512
                and os.path.exists(ckpt)):
            raise AssertionError(f"[cli] {out}")
    finally:
        shutil.rmtree(cli["tmp"], ignore_errors=True)
    note("cli", since_start_s=seconds, regret=out["regret_this_iter"])
    log(f"[cli] {card} | python -m ray_tpu_torch.rllib.train -f <json> "
        f"(BanditLinUCB, 2 iterations, CUDA by default), run beside "
        f"[offline] onwards: exit 0, {seconds:.1f} s after its start, "
        f"regret {out['regret_this_iter']:.3f}, checkpoint written")
    return {}


# ---------------------------------------------------------------------------
# Queue 1 item 8's models: the MoE GPT-2 ([moe-train]), ResNet-50 on
# CIFAR-10's shape through TorchTrainer and BatchPredictor ([resnet]), and
# the data / expert / sequence layouts over two ranks ([layouts])
# ---------------------------------------------------------------------------
# [moe-train]: GPT-2 small's width with MoEConfig()'s experts (8, top-2,
# capacity factor 1.25) in every block, [train]'s step (bf16 over fp32
# parameters, adamw(3e-4)) at B=8 S=1024, a warm-up step and 10 timed;
# the router, the dispatch and the expert FFN run in fp32 (ln_2's output).
# Then [train-fp32]'s card-against-CPU step on its 2-layer fp32 cut.
MOE_TRAIN = (8, 1024, 10)  # (B, S, timed steps)
MOE_CONFIG = MoEConfig()
# Device time of one more MoE step by kernel name (first match): the
# fp32 matmuls (the expert FFN and the router) apart from the bf16 ones.
MOE_STEP_GROUPS = (("flash", ("flash_",)),
                   ("fp32 matmul", ("sgemm", "f32f32_f32f32", "gemm_f32",
                                    "nvjet_sss")),
                   ("bf16 matmul", ("gemm", "xmma", "cutlass", "nvjet",
                                    "sm90_")),
                   ("index/sort", ("index", "gather", "scatter", "sort",
                                   "cumsum", "Scan", "radix")),
                   ("optimizer", ("multi_tensor_apply",)),
                   ("copy/cast", ("Memcpy", "Memset", "CatArrayBatchedCopy",
                                  "copy_kernel", "direct_copy")),
                   ("elementwise", ("elementwise", "vectorized", "reduce",
                                    "softmax", "norm", "Norm", "nll",
                                    "cross_entropy", "gelu")))


def moe_flops_per_token(run, length) -> float:
    """Training FLOPs a token on the parameters a token uses: every
    parameter but the experts, top_k of each layer's E experts, and the
    attention scores (bench.py's 6 N + 12 layers width S)."""
    e, k = MOE_CONFIG.num_experts, MOE_CONFIG.top_k
    d, layers = run["hidden_size"], run["num_layers"]
    experts = layers * e * 2 * d * 4 * d
    active = run["n_params"] - experts + experts * k // e
    return 6 * active + 12 * layers * d * length


def phase_moe_train(card) -> dict:
    """The MoE GPT-2 small step (``train_steps`` with ``MOE_CONFIG``):
    [train]'s checks (12 launches of each kernel a step, the first loss
    near ln 50257, a falling loss), then its 2-layer fp32 cut on the card
    against the CPU at [train-fp32]'s bounds.  Returns the launches."""
    b, length, iters = MOE_TRAIN
    run = train_steps(b, length, iters, config_kw={"moe": MOE_CONFIG},
                      groups=MOE_STEP_GROUPS)
    check_train("[moe-train]", run, b, length, iters)
    tokens_per_s = iters * b * length / run["seconds"]
    flops = moe_flops_per_token(run, length)
    mfu = tokens_per_s * flops / PEAK_OPS_PER_S[torch.bfloat16]
    per_step = {name: run["num_layers"] for name in attn.LAUNCHES}
    note("moe-train", ms_per_step=run["seconds"] / iters * 1e3,
         tokens_per_s=tokens_per_s, active_mfu=mfu,
         peak_gib=run["peak_gib"], build_s=run["build_s"],
         warm_s=run["warm_s"])
    log(f"[moe-train] {card} | GPT-2 small width, MoE in every block "
        f"({MOE_CONFIG.num_experts} experts, top-{MOE_CONFIG.top_k}, "
        f"capacity factor {MOE_CONFIG.capacity_factor}; fp32 router, "
        f"dispatch and expert FFN), B={b} S={length} bf16/fp32-params "
        f"adamw: {iters} steps in {run['seconds']:.3f} s = "
        f"{run['seconds'] / iters * 1e3:.1f} ms/step, {tokens_per_s:.0f} "
        f"tokens/s, MFU on the active parameters {mfu:.4f} "
        f"(N={run['n_params']}, {flops / 1e9:.3f} active GFLOP/token, bf16 "
        f"peak); loss {' '.join(f'{x:.4f}' for x in run['losses'])}; "
        f"launches per step {per_step}; build {run['build_s']:.1f} s, "
        f"warm-up step {run['warm_s']:.2f} s; peak memory "
        f"{run['peak_gib']:.1f} GiB")
    prof = run["profile"]
    step_ms = run["seconds"] / iters * 1e3
    note("moe-train", device_ms=prof["device_ms"],
         **{f"{g}_ms": ms for g, ms in prof["groups"].items()})
    log(f"[moe-train] {card} | one profiled step: device "
        f"{prof['device_ms']:.1f} ms, {prof['device_ms'] / step_ms:.1%} of a"
        f" timed step, {prof['device_ops']} device ops, "
        f"{prof['launch_calls']} launch calls; by group (ms): "
        + ", ".join(f"{g} {ms:.1f}" for g, ms in sorted(
            prof["groups"].items(), key=lambda kv: -kv[1]))
        + "; top: " + "; ".join(f"{name[:60]} x{n} {ms:.1f} ms"
                                for name, (n, ms) in prof["top"]))
    phase_train_fp32("moe-train-fp32", "gpt2",
                     (("tiny", False), ("moe", MOE_CONFIG)))
    return {"moe-train": run["launches"]}


# [remat]: GPT-2 medium (GPT2Config.gpt2_medium(): 24 layers x 1024, 16
# heads, vocab 50257), bf16 over fp32 parameters, adamw(3e-4), B=8 S=1024,
# through make_train_step in this process (train_steps): one warm-up step
# and REMAT_TRAIN[2] timed steps at the default scan_layers_threshold (24:
# every block recomputed in the backward), then the same from the same
# seeded weights at REMAT_KEEP_ALL (25: every activation kept).  Gates: the
# two runs' losses within REMAT_LOSS_RTOL (relative) step for step, a lower
# peak memory checkpointed, and the flash launches a step (forward, dq,
# dkv) 48/24/24 checkpointed (the recompute runs each forward again) and
# 24/24/24 kept.
GPT2_MEDIUM = {"num_layers": 24, "num_heads": 16, "hidden_size": 1024}
REMAT_TRAIN = (8, 1024, 5)  # (B, S, timed steps)
REMAT_KEEP_ALL = 25
REMAT_LOSS_RTOL = 1e-6


def phase_remat(card) -> dict:
    """GPT-2 medium's step with the remat layer stack against the same
    step keeping every activation (see REMAT_TRAIN).  Returns each run's
    launches."""
    b, length, iters = REMAT_TRAIN
    medium = GPT2Config.gpt2_medium()
    runs, lines = {}, []
    for label, kw in (("checkpointed", {}),
                      ("kept", {"scan_layers_threshold": REMAT_KEEP_ALL})):
        run = train_steps(b, length, iters, config_kw={**GPT2_MEDIUM, **kw})
        cfg_fields = {f: run["config"][f] for f in
                      ("num_layers", "num_heads", "hidden_size",
                       "vocab_size")}
        if cfg_fields != {f: getattr(medium, f) for f in cfg_fields}:
            raise AssertionError(f"[remat] not GPT-2 medium: {cfg_fields}")
        layers = run["num_layers"]
        remat = layers >= run["config"]["scan_layers_threshold"]
        per_step = {"flash_fwd": layers * (2 if remat else 1),
                    "flash_dq": layers, "flash_dkv": layers}
        if run["warm_launches"] != per_step or run["launches"] != {
                k: n * iters for k, n in per_step.items()}:
            raise AssertionError(
                f"[remat] {label}: warm-up launched {run['warm_launches']}"
                f", {iters} steps {run['launches']}; a step should launch "
                f"{per_step}")
        if not all(np.isfinite(run["losses"])):
            raise AssertionError(f"[remat] {label}: losses {run['losses']}")
        tokens_per_s, mfu, flops = train_rates(run, b, length, iters)
        ms = run["seconds"] / iters * 1e3
        note("remat", **{f"{label} ms_per_step": ms,
                         f"{label} tokens_per_s": tokens_per_s,
                         f"{label} mfu": mfu,
                         f"{label} peak_gib": run["peak_gib"]})
        lines.append(
            f"{label} (threshold {run['config']['scan_layers_threshold']}): "
            f"{ms:.1f} ms/step, {tokens_per_s:.0f} tokens/s, MFU {mfu:.4f}, "
            f"peak memory {run['peak_gib']:.2f} GiB, launches a step "
            f"{per_step}")
        runs[label] = run
    a, k = runs["checkpointed"]["losses"], runs["kept"]["losses"]
    rel = max(abs(x - y) / abs(y) for x, y in zip(a, k))
    bits = a == k
    note("remat", loss_rel=rel, bitwise=bits)
    routes = {name: r["bfloat16"] for name, r in routes_by_dtype().items()}
    log(f"[remat] {card} | GPT-2 medium (N={runs['kept']['n_params']}) "
        f"B={b} S={length} bf16/fp32-params adamw, warm-up + {iters} steps "
        f"each, bf16 routes {routes}: " + "; ".join(lines)
        + f"; losses {' '.join(f'{x:.6f}' for x in a)} vs "
        f"{' '.join(f'{x:.6f}' for x in k)}: worst relative difference "
        f"{rel:.3g} (bound {REMAT_LOSS_RTOL}), bit for bit {bits}")
    if not rel <= REMAT_LOSS_RTOL:
        raise AssertionError(f"[remat] losses differ: {a} vs {k}")
    if not runs["checkpointed"]["peak_gib"] < runs["kept"]["peak_gib"]:
        raise AssertionError("[remat] checkpointing did not lower the peak "
                             "memory")
    return {f"remat {label}": run["launches"]
            for label, run in runs.items()}


# [pipeline]: bench.py's bench_gpt2_pipeline at its full configuration
# (bench.py:326-327): GPT-2 small in fp32 split by split_stages, B=16
# S=1024, AdamW at 3e-4 with optax.adamw's defaults (train.adamw), the
# MPMDPipeline's stage actors on the card (half of it each at two
# stages).  Two legs: one stage with one microbatch, then two stages with
# PIPELINE_TRAIN[2] microbatches and step_window 2; each runs two
# lockstep train_steps (the first the warm-up), then PIPELINE_TRAIN[3]
# submit_steps and a flush, timed.  Gates: no driver sync in the stream,
# finite losses, the launches of each kernel a step (12 a microbatch), and
# each leg's losses, the two train_steps and the streamed steps, equal to
# the same stage functions composed in this process on the card, from the
# same weights with the same optimizer (full-batch gradients), step for
# step, within PIPELINE_RTOL and PIPELINE_ATOL (the tolerance of
# __graft_entry__.py's _dryrun_pipeline_mesh): a stale parameter or a
# reordered step inside the window shows there.
PIPELINE_TRAIN = (16, 1024, 8, 8)  # (B, S, microbatches, streamed steps)
PIPELINE_LR = 3e-4
PIPELINE_RTOL, PIPELINE_ATOL = 1e-5, 1e-6
PIPELINE_WARM_STEPS = 2


def stage_launches(core, zero=False) -> dict:
    """In a stage's process: its flash launches (set to 0 after reading
    with ``zero``)."""
    counts = dict(attn.LAUNCHES)
    if zero:
        zero_launches()
    return counts


def composed_reference(fns, inits, ids, steps, lr, device="cuda") -> list:
    """The chunk functions composed in this process on ``device`` from
    the same weights (the init functions drawn here), with one
    ``train.adamw`` a chunk: the full-batch losses of ``steps`` steps."""
    params = [{k: v.to(device).requires_grad_(True) for k, v in f().items()}
              for f in inits]
    opts = [adamw(list(p.values()), lr) for p in params]
    tokens = torch.from_numpy(np.asarray(ids)).long().to(device)
    losses = []
    for _ in range(steps):
        h = tokens
        for c in range(len(fns) - 1):
            h = fns[c](params[c], h)
        loss = fns[-1](params[-1], h, tokens)
        for o in opts:
            o.zero_grad(set_to_none=True)
        loss.backward()
        for o in opts:
            o.step()
        losses.append(loss.item())
    del params, opts
    torch.cuda.empty_cache()
    return losses


def pipeline_leg(cfg, num_stages, microbatches, ids) -> dict:
    """One leg of bench_gpt2_pipeline on the card: the warm-up and
    lockstep train_steps, then the timed stream, the launches of each
    stage counted over the stream alone."""
    b, length, _, steps = PIPELINE_TRAIN
    fns, inits = split_stages(cfg, num_stages)
    t0 = time.perf_counter()
    pipe = mpmd.MPMDPipeline(
        fns, inits, optimizer=functools.partial(adamw,
                                                learning_rate=PIPELINE_LR),
        num_microbatches=microbatches, step_window=2, drain_timeout=GET_S,
        bootstrap_timeout=GET_S)
    try:
        lockstep = [pipe.train_step(ids, ids)
                    for _ in range(PIPELINE_WARM_STEPS)]
        warm_s = time.perf_counter() - t0
        ray_tpu_torch.get([s.run.remote(stage_launches, True)
                           for s in pipe.stages], timeout=GET_S)
        syncs0 = mpmd.mpmd_driver_sync_count()
        t0 = time.perf_counter()
        for _ in range(steps):
            pipe.submit_step(ids, ids)
        stream = pipe.flush()
        seconds = time.perf_counter() - t0
        syncs = mpmd.mpmd_driver_sync_count() - syncs0
        per_stage = ray_tpu_torch.get(
            [s.run.remote(stage_launches) for s in pipe.stages],
            timeout=GET_S)
        stats = pipe.stats()
    finally:
        pipe.stop()
    launches = {name: sum(c[name] for c in per_stage)
                for name in attn.LAUNCHES}
    return {"fns": fns, "inits": inits, "lockstep": lockstep,
            "stream": [loss for _, loss in sorted(stream)],
            "seconds": seconds,
            "warm_s": warm_s, "syncs": syncs, "stats": stats,
            "launches": launches, "stage_launches": per_stage,
            "blocks": [f.blocks for f in fns],
            "tokens_per_s": steps * b * length / seconds}


def phase_pipeline(card) -> dict:
    """bench_gpt2_pipeline's two legs on the card (see PIPELINE_TRAIN).
    Returns each leg's launches."""
    b, length, microbatches, steps = PIPELINE_TRAIN
    cfg = GPT2Config.gpt2_small(dtype=torch.float32)
    ids = np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, size=(b, length)).astype(np.int32)
    n_params = cfg.num_layers * 12 * cfg.hidden_size ** 2 \
        + 2 * cfg.vocab_size * cfg.hidden_size \
        + cfg.max_position_embeddings * cfg.hidden_size
    fpt = 6 * n_params + 12 * cfg.num_layers * cfg.hidden_size * length
    peak = PEAK_OPS_PER_S[torch.float32]
    routes = {name: r["float32"] for name, r in routes_by_dtype().items()}
    legs = {}
    for stages, m in ((1, 1), (2, microbatches)):
        leg = pipeline_leg(cfg, stages, m, ids)
        per_step = {name: cfg.num_layers * m for name in attn.LAUNCHES}
        losses = leg["lockstep"] + leg["stream"]
        if leg["syncs"] != 0:
            raise AssertionError(f"[pipeline] {stages} stage(s): "
                                 f"{leg['syncs']} driver syncs in the stream")
        if not all(np.isfinite(losses)):
            raise AssertionError(f"[pipeline] losses {losses}")
        if leg["launches"] != {k: n * steps for k, n in per_step.items()}:
            raise AssertionError(
                f"[pipeline] {stages} stage(s): the stream launched "
                f"{leg['launches']}, expected {per_step} a step")
        st = leg["stats"]
        predicted = mpmd.simulate_schedule("1f1b", stages, m)[
            "bubble_fraction"]
        mfu = leg["tokens_per_s"] * fpt / (stages * peak)
        note("pipeline", **{f"{stages}-stage tokens_per_s":
                            leg["tokens_per_s"],
                            f"{stages}-stage mfu_per_card": mfu,
                            f"{stages}-stage bubble": st["bubble_fraction"],
                            f"{stages}-stage bubble_predicted": predicted,
                            f"{stages}-stage act_gb_per_s":
                            st["act_gb_per_s"],
                            f"{stages}-stage ms_per_step":
                            leg["seconds"] / steps * 1e3})
        log(f"[pipeline] {card} | GPT-2 small fp32 B={b} S={length}, "
            f"{stages} stage(s) (blocks {leg['blocks']}), {m} "
            f"microbatch(es), step_window 2, adamw({PIPELINE_LR}): "
            f"{steps} streamed steps in {leg['seconds']:.3f} s = "
            f"{leg['seconds'] / steps * 1e3:.1f} ms/step, "
            f"{leg['tokens_per_s']:.0f} tokens/s, MFU per card "
            f"{mfu:.4f} (bench.py:365-371: tokens/s x {fpt / 1e9:.3f} "
            f"GFLOP/token over {stages} x the fp32 peak "
            f"{peak / 1e12:.0f} TFLOP/s; the stages share one card); "
            f"bubble fraction {st['bubble_fraction']:.4f} measured, "
            f"{predicted:.4f} predicted by simulate_schedule; activation "
            f"{st['act_gb_per_s']:.3f} GB/s; driver syncs in the stream "
            f"{leg['syncs']}; stats {json.dumps(st, default=str)}; flash "
            f"launches a step {per_step} by stage "
            f"{leg['stage_launches']} over the stream, fp32 routes "
            f"{routes}; losses {' '.join(f'{x:.4f}' for x in losses)}; "
            f"start and warm-up {leg['warm_s']:.1f} s")
        legs[stages] = leg
    for stages, leg in legs.items():
        got = leg["lockstep"] + leg["stream"]
        ref = composed_reference(leg["fns"], leg["inits"], ids, len(got),
                                 PIPELINE_LR)
        excess = allclose_excess(torch.tensor(got, dtype=torch.float64),
                                 torch.tensor(ref, dtype=torch.float64),
                                 PIPELINE_RTOL) - PIPELINE_ATOL
        note("pipeline", **{f"{stages}-stage ref_excess": excess})
        log(f"[pipeline] {card} | {stages} stage(s): the {len(got)} losses "
            f"({PIPELINE_WARM_STEPS} train_steps, then the stream) "
            f"{' '.join(f'{x:.7f}' for x in got)} vs the chunks composed "
            f"in this process {' '.join(f'{x:.7f}' for x in ref)} (rtol "
            f"{PIPELINE_RTOL}, atol {PIPELINE_ATOL}; excess {excess:.3g})")
        if not excess <= 0:
            raise AssertionError(f"[pipeline] {stages} stage(s): losses "
                                 f"{got} vs composed {ref}")
    ratio = legs[2]["tokens_per_s"] / legs[1]["tokens_per_s"]
    note("pipeline", ratio_tokens=ratio)
    log(f"[pipeline] {card} | two stages over one: tokens/s ratio "
        f"{ratio:.3f} (bench.py's >= 0.8 quantity; a reading here, the two "
        f"stages sharing one card)")
    return {f"pipeline {k}-stage": leg["launches"]
            for k, leg in legs.items()}


# [resnet]: ResNetConfig.resnet50_cifar() (bf16 convolutions, fp32 BN and
# head) through TorchTrainer, one worker, train_loop_per_worker: one epoch
# of RESNET_TRAIN images of CIFAR-10's shape at B=256 through the Data
# ingest (from_numpy -> the worker's shard -> iter_device_batches), then
# BatchPredictor with TorchPredictor over RESNET_HELD_OUT held-out images
# from the fit's checkpoint.  No copy of CIFAR-10 is on either machine: an
# image is its class's fixed template (N(0, 1) pixels from the seed) plus
# N(0, 1) noise.  Gates: the first loss within RESNET_FIRST_SLACK of
# ln 10, a falling loss, held-out accuracy >= RESNET_ACCURACY (chance is
# 0.1), no flash launch.
RESNET_TRAIN, RESNET_HELD_OUT, RESNET_BATCH = 8192, 2048, 256
RESNET_LR = 1e-3
RESNET_FIRST_SLACK = 0.5
RESNET_ACCURACY = 0.5


def resnet_images(n, seed) -> dict:
    """``n`` images [n, 32, 32, 3] fp32 with their labels [n]."""
    templates = np.random.default_rng(SEED).standard_normal(
        (10, 32, 32, 3), dtype=np.float32)
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, n)
    noise = rng.standard_normal((n, 32, 32, 3), dtype=np.float32)
    return {"image": templates[labels] + noise, "label": labels}


def resnet_model():
    """ResNet-50 with the CIFAR stem, drawn from the seed on the CPU."""
    return ResNet(ResNetConfig.resnet50_cifar(),
                  torch.Generator().manual_seed(SEED))


def resnet_loop(config):
    """TorchTrainer's worker: one epoch of the dataset shard through
    iter_device_batches, ``make_train_step`` over ``resnet_loss_fn``
    (AdamW), the first step timed apart; reports the rates and the
    model's state dict as the checkpoint."""
    started = time.time()
    from ray_tpu_torch.air import session

    t0 = time.perf_counter()
    model = resnet_model().to("cuda", memory_format=torch.channels_last)
    step = make_train_step(model, adamw(model.parameters(), RESNET_LR),
                           lambda m, batch: resnet_loss_fn(m, batch)[0])
    build_s = time.perf_counter() - t0
    stream = session.get_dataset_shard("train").iter_device_batches(
        config["batch"])
    zero_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses = [step(next(stream))]
    first = losses[0].item()
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    losses += [step(batch) for batch in stream]
    losses[-1].item()
    seconds = time.perf_counter() - t0
    stream.close()
    session.report({
        "losses": [first] + torch.stack(losses[1:]).tolist(),
        "seconds": seconds, "warm_s": warm_s, "build_s": build_s,
        "steps": len(losses), "launches": dict(attn.LAUNCHES),
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
        "started": started, "spawned": process_start(),
        "jax": jax_modules()},
        checkpoint=Checkpoint.from_state_dict(model.state_dict()))


def phase_resnet(card) -> dict:
    """ResNet-50 (CIFAR stem) fit through TorchTrainer, then batch
    prediction over held-out images from its checkpoint.  Returns the
    fit's flash launches (none)."""
    b = RESNET_BATCH
    train = resnet_images(RESNET_TRAIN, SEED + 7)
    t_fit = time.time()
    result = TorchTrainer(
        resnet_loop, train_loop_config={"batch": b},
        datasets={"train": rdata.from_numpy(train, parallelism=8)},
        scaling_config=ScalingConfig(num_workers=1, use_gpu=True)).fit()
    fit_s = time.time() - t_fit
    if result.error is not None:
        raise AssertionError(f"[resnet] {result.error}")
    m = result.metrics
    losses, steps = m["losses"], m["steps"]
    images_per_s = (steps - 1) * b / m["seconds"]
    held = resnet_images(RESNET_HELD_OUT, SEED + 8)
    t0 = time.time()
    predictor = BatchPredictor.from_checkpoint(
        result.checkpoint, TorchPredictor, model=resnet_model,
        input_column="image")
    out = predictor.predict(rdata.from_numpy(held, parallelism=4))
    batches = list(out.iter_batches(batch_size=RESNET_HELD_OUT))
    predict_s = time.time() - t0
    logits = np.concatenate([x["predictions"] for x in batches])
    labels = np.concatenate([x["label"] for x in batches])
    accuracy = float((logits.argmax(-1) == labels).mean())
    ln10 = float(np.log(10))
    note("resnet", images_per_s=images_per_s,
         ms_per_step=m["seconds"] / (steps - 1) * 1e3, accuracy=accuracy,
         cold_s=m["started"] - t_fit, to_spawn_s=m["spawned"] - t_fit,
         fit_s=fit_s, predict_s=predict_s, peak_gib=m["peak_gib"])
    log(f"[resnet] {card} | ResNet-50 (CIFAR stem; bf16 convolutions, fp32 "
        f"BN and head) through TorchTrainer, one worker: {steps} steps of "
        f"B={b} on {RESNET_TRAIN} 32x32x3 images of 10 classes (template + "
        f"N(0,1) noise) through from_numpy -> iter_device_batches, AdamW "
        f"{RESNET_LR}: {steps - 1} steps after the first in "
        f"{m['seconds']:.3f} s = {m['seconds'] / (steps - 1) * 1e3:.1f} "
        f"ms/step, {images_per_s:.0f} images/s; first step "
        f"{m['warm_s']:.2f} s, model build {m['build_s']:.2f} s; loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f} (ln 10 = {ln10:.4f}); peak "
        f"memory {m['peak_gib']:.1f} GiB; flash launches {m['launches']}; "
        f"worker cold start (fit to loop) {m['started'] - t_fit:.2f} s, "
        f"{m['spawned'] - t_fit:.2f} s of it to the worker process's "
        f"start; fit {fit_s:.1f} s. BatchPredictor(TorchPredictor) over "
        f"{RESNET_HELD_OUT} held-out images from the fit's checkpoint: "
        f"accuracy {accuracy:.4f} (bound {RESNET_ACCURACY}, chance 0.1) in "
        f"{predict_s:.1f} s")
    if m["jax"] or any(m["launches"].values()):
        raise AssertionError(f"[resnet] worker {m['jax']}, flash "
                             f"{m['launches']}")
    if not (np.all(np.isfinite(losses))
            and abs(losses[0] - ln10) <= RESNET_FIRST_SLACK
            and losses[-1] < losses[0]):
        raise AssertionError(f"[resnet] losses {losses}")
    if not accuracy >= RESNET_ACCURACY:
        raise AssertionError(f"[resnet] held-out accuracy {accuracy}")
    return {"resnet": m["launches"]}


# [layouts]: the counterpart of __graft_entry__.py's _dryrun_one_mesh over
# each layout of two ranks: GPT-2 tiny with MoE (4 experts, top-2, fp32,
# 4 heads) at batch max(4, world) x 128, the same weights and ids through
# `data` = 2 (DDP; the MoE over the global tokens, as GSPMD runs it),
# `expert` = 2 (DDP; make_expert_parallel_moe) and `sequence` = 2 (DDP;
# ring_attention as attn_fn, positions from the rank's offset, the MoE
# over the global tokens).  Gates: the losses within LAYOUT_SPREAD of each
# other (the JAX dryrun's spread); data and sequence equal to one rank's
# plain step, expert to one rank's moe_apply on each token shard, within
# LAYOUT_LOSS_ATOL, and every parameter's gradient within LAYOUT_GRAD_REL
# (relative norm) of the same one-rank step's.  Then ring and Ulysses
# attention on the JAX tests' shapes, forward and gradient against full
# attention at their tolerances (|a - b| <= atol + rtol |b|).
LAYOUTS = ("data", "expert", "sequence")
LAYOUT_WORLD = 2
LAYOUT_SEQ = 128
LAYOUT_CONFIG = {"dtype": torch.float32, "num_heads": 4,
                 "moe": MoEConfig(num_experts=4, top_k=2,
                                  dtype=torch.float32)}
LAYOUT_SPREAD = 5e-2
LAYOUT_LOSS_ATOL = 1e-5
LAYOUT_GRAD_REL = 1e-4
SEQ_ATTN_TOL = {"forward": 2e-5, "gradient": 5e-4}


def layout_ids(world) -> np.ndarray:
    return np.random.default_rng(SEED + 5).integers(
        0, 512, (max(4, world), LAYOUT_SEQ))


def layout_model(state, device, attn_fn=None, moe_fn=None):
    """GPT-2 tiny with LAYOUT_CONFIG's MoE, ``state``'s weights."""
    from ray_tpu_torch.models import GPT2, GPT2Config

    model = GPT2(GPT2Config.tiny(**LAYOUT_CONFIG), attn_fn, moe_fn)
    model.load_state_dict(state, strict=True)
    return model.to(device)


def shard_moe(n):
    """One rank's ``moe_apply`` on each of ``n`` token shards, at a
    shard's capacity: what the expert-parallel MoE computes."""
    def fn(x, w_router, w_in, w_out, cfg):
        cap = cfg.capacity(x.shape[0] // n)
        return torch.cat([moe_apply(s, w_router, w_in, w_out, cfg,
                                    capacity=cap) for s in x.chunk(n)])
    return fn


def layout_reference(state, ids, device, world=LAYOUT_WORLD) -> dict:
    """One rank's loss and gradients on the whole batch: the plain model,
    and the model with ``shard_moe(world)``."""
    out = {}
    for name, moe_fn in (("plain", None), ("expert", shard_moe(world))):
        model = layout_model(state, device, moe_fn=moe_fn)
        loss = gpt2_loss_fn(model, {"input_ids": torch.from_numpy(ids).to(
            device)})
        loss.backward()
        out[name] = {"loss": loss.item(),
                     "grads": {k: p.grad.cpu()
                               for k, p in model.named_parameters()}}
    return out


def layout_rank(layout, state, ids, device) -> dict:
    """One rank of ``layout`` over the default process group: this
    rank's rows (data, expert) or positions (sequence) of ``ids``, one
    DDP forward and backward, the loss summed over the ranks.  Returns
    the loss and the gradients (equal on every rank after DDP)."""
    from torch.nn.parallel import DistributedDataParallel

    from ray_tpu_torch.ops.collectives import all_reduce_sum

    mesh = make_mesh(MeshSpec({layout: -1}))
    n, r = mesh.world, mesh.rank
    b, length = ids.shape
    group = mesh.axis_group(layout)
    attn_fn = positions = None
    if layout == "sequence":
        ls = length // n
        local = ids[:, r * ls:(r + 1) * ls]
        labels = torch.from_numpy(ids[:, r * ls + 1:(r + 1) * ls + 1])
        positions = torch.arange(r * ls, (r + 1) * ls).expand(b, ls)
        attn_fn = functools.partial(ring_attention, mesh=mesh)
        moe_fn = functools.partial(moe_apply_token_sharded, group=group,
                                   rows=b)
    else:
        local = ids[r * b // n:(r + 1) * b // n]
        if layout == "data":
            moe_fn = functools.partial(moe_apply_token_sharded, group=group)
        else:
            ep = make_expert_parallel_moe(mesh, LAYOUT_CONFIG["moe"],
                                          local.size)
            moe_fn = lambda x, w_r, w_in, w_out, cfg: ep(  # noqa: E731
                x, w_r, w_in, w_out)
    model = layout_model(state, device, attn_fn, moe_fn)
    ddp = DistributedDataParallel(
        model, device_ids=None if device == "cpu" else [0])
    ids_t = torch.from_numpy(local).to(device)
    if layout == "sequence":
        logits = ddp(ids_t, positions=positions.to(device))
        part = F.cross_entropy(
            logits[:, :labels.shape[1]].flatten(0, 1),
            labels.to(device).flatten().long(),
            reduction="sum") / (b * (length - 1))
        scaled = part * n  # DDP averages the gradients: n * part sums them
    else:
        scaled = gpt2_loss_fn(ddp, {"input_ids": ids_t})
        part = scaled / n
    scaled.backward()
    loss = all_reduce_sum(part.detach()).item()
    return {"loss": loss, "grads": {k: p.grad.cpu()
                                    for k, p in model.named_parameters()}}


def grad_rel(got, want) -> tuple:
    """(worst relative norm error over the parameters, its name)."""
    rel = {k: ((got[k] - w).norm() / w.norm().clamp_min(1e-30)).item()
           for k, w in want.items()}
    worst = max(rel, key=rel.get)
    return rel[worst], worst


def check_layouts(runs, ref) -> dict:
    """Hold the layouts' runs to one rank's (``layout_reference``): the
    gaps, raising when a bound is passed."""
    numbers = {"spread": max(x["loss"] for x in runs.values())
               - min(x["loss"] for x in runs.values())}
    for layout, run in runs.items():
        want = ref["expert" if layout == "expert" else "plain"]
        numbers[f"{layout}_loss_gap"] = abs(run["loss"] - want["loss"])
        numbers[f"{layout}_grad_rel"], worst = grad_rel(run["grads"],
                                                        want["grads"])
        if not (numbers[f"{layout}_loss_gap"] <= LAYOUT_LOSS_ATOL
                and numbers[f"{layout}_grad_rel"] <= LAYOUT_GRAD_REL):
            raise AssertionError(
                f"[layouts] {layout}: loss {run['loss']} vs one rank's "
                f"{want['loss']}, worst gradient {worst} "
                f"{numbers[f'{layout}_grad_rel']}")
    if not numbers["spread"] <= LAYOUT_SPREAD:
        raise AssertionError(f"[layouts] losses {runs} spread "
                             f"{numbers['spread']}")
    return numbers


def allclose_excess(got, want, rtol) -> float:
    """max(|got - want| - rtol |want|): within ``assert_allclose(atol,
    rtol)`` when at most atol."""
    return ((got - want).abs() - rtol * want.abs()).max().item()


def sequence_attention_checks(device) -> dict:
    """Ring and Ulysses attention over the default group's ranks on the
    JAX tests' shapes (B=2, L=256, D=16; 4 heads, Ulysses 8), causal and
    not: this rank's shard of the output and of the gradients of sum(o^2)
    against full attention's, as allclose excesses over the rtol."""
    mesh = make_mesh(MeshSpec({"sequence": -1}))
    n, r = mesh.world, mesh.rank
    out = {}
    for name, fn, h in (("ring", ring_attention, 4),
                        ("ulysses", ulysses_attention, 8)):
        rng = np.random.default_rng(SEED + 6)
        q, k, v = (torch.from_numpy(rng.standard_normal(
            (2, 256, h, 16), dtype=np.float32)).to(device) for _ in range(3))
        ls = q.shape[1] // n
        rows = slice(r * ls, (r + 1) * ls)
        for causal in (False, True):
            shards = [t[:, rows].clone().requires_grad_(True)
                      for t in (q, k, v)]
            o = fn(*shards, mesh, causal=causal)
            (o ** 2).sum().backward()
            full = [t.clone().requires_grad_(True) for t in (q, k, v)]
            o_ref = attn.mha_attention(*full, causal=causal,
                                       use_flash=False)
            (o_ref ** 2).sum().backward()
            tag = f"{name} causal={causal}"
            tol = SEQ_ATTN_TOL
            out[f"{tag} forward"] = allclose_excess(
                o, o_ref[:, rows].detach(), tol["forward"])
            out[f"{tag} gradient"] = max(
                allclose_excess(s.grad, f.grad[:, rows], tol["gradient"])
                for s, f in zip(shards, full))
    return out


def layouts_loop(config):
    """TorchTrainer's worker (one of two): each layout's step, then the
    sequence-parallel attention checks; the worst check over the ranks."""
    import torch.distributed as dist

    from ray_tpu_torch.air import session

    torch.set_float32_matmul_precision("highest")
    zero_launches()
    out = {layout: layout_rank(layout, config["state"], config["ids"],
                               "cuda") for layout in LAYOUTS}
    checks = sequence_attention_checks("cuda")
    both = [None] * dist.get_world_size()
    dist.all_gather_object(both, checks)
    out["attention"] = {k: max(c[k] for c in both) for k in checks}
    out["launches"] = dict(attn.LAUNCHES)
    out["jax"] = jax_modules()
    session.report(out)


def phase_layouts(card) -> dict:
    """The three layouts and the sequence-parallel attention checks in two
    TorchTrainer workers at half the card each over gloo, held to one
    rank's steps in this process.  Returns the workers' flash launches
    (none: L=128 takes the plain path)."""
    state = build_model("gpt2", LAYOUT_CONFIG, seed=SEED,
                        device="cpu").state_dict()
    ids = layout_ids(LAYOUT_WORLD)
    t0 = time.time()
    result = TorchTrainer(
        layouts_loop, train_loop_config={"state": state, "ids": ids},
        scaling_config=ScalingConfig(num_workers=LAYOUT_WORLD, use_gpu=True,
                                     gpus_per_worker=DP2_GPUS)).fit()
    fit_s = time.time() - t0
    if result.error is not None:
        raise AssertionError(f"[layouts] {result.error}")
    m = result.metrics
    ref = layout_reference(state, ids, "cuda")
    numbers = check_layouts({k: m[k] for k in LAYOUTS}, ref)
    bad = {k: e for k, e in m["attention"].items()
           if not e <= SEQ_ATTN_TOL[k.rsplit(" ", 1)[1]]}
    note("layouts", fit_s=fit_s, **numbers,
         **{k.replace(" ", "_"): e for k, e in m["attention"].items()})
    log(f"[layouts] {card} | GPT-2 tiny MoE (4 experts, top-2, fp32, 4 "
        f"heads) at {ids.shape[0]}x{ids.shape[1]}, two TorchTrainer workers "
        f"at {DP2_GPUS} of the card over gloo: losses "
        + ", ".join(f"{k} {m[k]['loss']:.6f} (one rank's "
                    f"{ref['expert' if k == 'expert' else 'plain']['loss']:.6f}"
                    f", gradient rel {numbers[f'{k}_grad_rel']:.3g})"
                    for k in LAYOUTS)
        + f"; spread {numbers['spread']:.3g} (bound {LAYOUT_SPREAD}; loss "
        f"bound {LAYOUT_LOSS_ATOL}, gradient bound {LAYOUT_GRAD_REL}); ring "
        f"and Ulysses against full attention, allclose excess over the "
        f"rtol (bounds forward {SEQ_ATTN_TOL['forward']}, gradient "
        f"{SEQ_ATTN_TOL['gradient']}): "
        + ", ".join(f"{k} {e:.3g}" for k, e in m["attention"].items())
        + f"; flash launches {m['launches']}; fit {fit_s:.1f} s")
    if bad or m["jax"] or any(m["launches"].values()):
        raise AssertionError(f"[layouts] attention {bad}, worker "
                             f"{m['jax']}, launches {m['launches']}")
    return {"layouts": m["launches"]}


# [layouts]' pipeline legs: __graft_entry__.py's _dryrun_pipeline_mesh
# (:119) and _dryrun_llama_3d (:173) on the card, each at its reference's
# size and tolerance.  Their stage 0 with spmd_devices=2 is a 2-rank gang
# here, and so is every other stage (a pipeline's gangs are one width):
# each rank a quarter of the card over gloo.  Gates: the fp32 wire's
# losses against the chunks composed in this process (the same weights and
# adamw) within DRYRUN_RTOL and DRYRUN_ATOL, the int8 wire's within
# DRYRUN_INT8_ENVELOPE of the composed losses, and the int8 wire at least
# DRYRUN_WIRE_X times smaller than the fp32 bytes.
DRYRUN_RTOL, DRYRUN_ATOL = 1e-5, 1e-6
DRYRUN_INT8_ENVELOPE = 0.05
DRYRUN_WIRE_X = 3.0
DRYRUN_LR = 1e-3
DRYRUN_GANG = 2


def gang_launches(pipe) -> list:
    """Every gang rank's flash launches."""
    return [n for g in pipe._gangs
            for n in g.run(lambda: dict(attn.LAUNCHES), timeout=GET_S)]


def dryrun_leg(fns, inits, ids, steps, **kw) -> dict:
    t0 = time.perf_counter()
    pipe = mpmd.MPMDPipeline(
        fns, inits, optimizer=functools.partial(adamw,
                                                learning_rate=DRYRUN_LR),
        gang_hosts=DRYRUN_GANG, drain_timeout=GET_S,
        bootstrap_timeout=GET_S, **kw)
    try:
        losses = [pipe.train_step(ids, ids) for _ in range(steps)]
        stats = pipe.stats()
        launches = gang_launches(pipe)
    finally:
        pipe.stop()
    return {"losses": losses, "stats": stats, "launches": launches,
            "s": time.perf_counter() - t0}


def layouts_pipelines(card) -> dict:
    """The two dryrun legs that wait for the pipelines (see DRYRUN_RTOL).
    Returns the gang workers' flash launches (none: the tiny models'
    lengths take the plain path)."""
    excess = lambda got, want: allclose_excess(  # noqa: E731
        torch.tensor(got, dtype=torch.float64),
        torch.tensor(want, dtype=torch.float64), DRYRUN_RTOL) - DRYRUN_ATOL
    rng = np.random.default_rng(0)
    cfg = GPT2Config.tiny(dtype=torch.float32)
    fns, inits = split_stages(cfg, 2)
    ids = rng.integers(0, cfg.vocab_size, size=(8, 64)).astype(np.int32)
    gpt = dryrun_leg(fns, inits, ids, 2, num_microbatches=4)
    gpt["ref"] = composed_reference(fns, inits, ids, 2, DRYRUN_LR)
    gpt["excess"] = excess(gpt["losses"], gpt["ref"])

    lcfg = LlamaConfig.tiny(dtype=torch.float32, num_layers=4)
    S, v = 2, 2
    lfns, linits = llama_mod.split_stages(lcfg, S, virtual_per_rank=v)
    rng = np.random.default_rng(0)
    lids = rng.integers(0, lcfg.vocab_size, size=(8, 32)).astype(np.int32)
    zero = {"zero_sharding": "opt+grads"}
    llama = {wire: dryrun_leg(lfns, linits, lids, 2, num_microbatches=2,
                              virtual_per_rank=v, wire_dtype=wire,
                              stage_options=[dict(zero), dict(zero)])
             for wire in ("fp32", "int8")}
    lref = composed_reference(lfns, linits, lids, 2, DRYRUN_LR)
    l_excess = excess(llama["fp32"]["losses"], lref)
    int8_gap = max(abs(a - b) for a, b in zip(llama["int8"]["losses"],
                                              lref))
    wire_x = llama["int8"]["stats"]["wire_reduction_vs_fp32"]
    launches = gpt["launches"] + [n for leg in llama.values()
                                  for n in leg["launches"]]
    note("layouts", pipeline_excess=gpt["excess"], llama_excess=l_excess,
         llama_int8_gap=int8_gap, llama_wire_x=wire_x,
         pipeline_s=gpt["s"], llama_s=sum(x["s"] for x in llama.values()))
    log(f"[layouts] {card} | _dryrun_pipeline_mesh: GPT-2 tiny fp32 in 2 "
        f"stages, each a {DRYRUN_GANG}-rank gang over gloo at a quarter of "
        f"the card, 4 microbatches, adamw({DRYRUN_LR}): losses "
        f"{' '.join(f'{x:.7f}' for x in gpt['losses'])} vs composed "
        f"{' '.join(f'{x:.7f}' for x in gpt['ref'])} (rtol {DRYRUN_RTOL}, "
        f"atol {DRYRUN_ATOL}; excess {gpt['excess']:.3g}), {gpt['s']:.1f} s")
    log(f"[layouts] {card} | _dryrun_llama_3d: Llama tiny (4 layers, GQA, "
        f"SwiGLU) fp32, 2 stages x virtual_per_rank {v}, "
        f"{DRYRUN_GANG}-rank gangs with ZeRO opt+grads, 2 microbatches: "
        f"fp32 wire {' '.join(f'{x:.7f}' for x in llama['fp32']['losses'])}"
        f" vs composed {' '.join(f'{x:.7f}' for x in lref)} (excess "
        f"{l_excess:.3g}); int8 wire "
        f"{' '.join(f'{x:.7f}' for x in llama['int8']['losses'])} (worst "
        f"gap {int8_gap:.3g}, bound {DRYRUN_INT8_ENVELOPE}), "
        f"{wire_x:.2f}x fewer wire bytes (bound {DRYRUN_WIRE_X}); "
        f"{sum(x['s'] for x in llama.values()):.1f} s; gang flash "
        f"launches {launches}")
    if not (gpt["excess"] <= 0 and l_excess <= 0
            and int8_gap < DRYRUN_INT8_ENVELOPE and wire_x >= DRYRUN_WIRE_X):
        raise AssertionError("[layouts] a pipeline dryrun leg failed")
    if any(any(n.values()) for n in launches):
        raise AssertionError(f"[layouts] pipeline gangs launched {launches}")
    return {"layouts pipelines": {name: sum(n[name] for n in launches)
                                  for name in attn.LAUNCHES}}


def timed(tag, phase, *args):
    """Run one phase, log its seconds and keep them for its record line."""
    RECORD.setdefault(tag, {})
    t_phase = time.perf_counter()
    out = phase(*args)
    seconds = time.perf_counter() - t_phase
    note(tag, s=seconds)
    log(f"[{tag}] {seconds:.1f} s")
    return out


RL_PHASES_FLAG = "--rl-phases"


def rl_phases(card) -> dict:
    """The RL phases that need no cluster, in order: ``[ppo-parity]`` to
    ``[cli]``.  Returns each path's flash launches."""
    timed("ppo-parity", phase_ppo_parity)
    rl = {"ppo": timed("ppo", phase_ppo, card)["flash"]}
    timed("envs", phase_envs)
    rl["ppo-minatar"] = timed("ppo-minatar", phase_ppo_minatar,
                              card)["flash"]
    # IMPALA's gate is close: on an H100 seeds 0 and 1 end at 1.49 against
    # the floor of 1.5.  cuDNN documents its weight-gradient algorithms 0
    # and 3 as non-deterministic (atomic adds), with which a rerun need not
    # repeat a seed's plateau; IMPALA's and APPO's phases run cuDNN's
    # deterministic algorithms, so that the same card and stack repeat
    # each seed's outcome.
    torch.backends.cudnn.deterministic = True
    rl["impala"] = timed("impala", phase_impala, card)["flash"]
    rl["appo"] = timed("appo", phase_appo, card)["flash"]
    torch.backends.cudnn.deterministic = False
    rl.update({f"ppo-{kind}": n
               for kind, n in timed("memory", phase_memory, card).items()})
    for tag, phase in (("dqn", phase_dqn), ("sac", phase_sac),
                       ("td3", phase_td3)):
        rl[tag] = timed(tag, phase, card)["flash"]
    # The train CLI's process runs beside the rest of RLlib's phases.
    cli = start_cli()
    try:
        for tag, phase in (("offline", phase_offline), ("es", phase_es),
                           ("bandit", phase_bandit), ("dynaq", phase_dynaq),
                           ("qmix", phase_qmix), ("mappo", phase_mappo)):
            rl[tag] = timed(tag, phase, card)["flash"]
        timed("cli", phase_cli, card, cli)
    finally:
        if cli["proc"].poll() is None:
            cli["proc"].kill()
            cli["proc"].wait()
    return rl


def rl_phases_main(out_dir) -> None:
    """``chip_smoke.py --rl-phases <dir>``: ``rl_phases`` in a process of
    its own, with ``phase_device``'s settings; its launches and record go
    to ``<dir>/result.json``."""
    phase_device()
    rl = rl_phases(card_line())
    with open(os.path.join(out_dir, "result.json"), "w") as f:
        json.dump({"launches": rl, "record": RECORD}, f)


PIPELINE_LEGS_FLAG = "--pipeline-legs"


def pipeline_legs_main(out_dir) -> None:
    """``chip_smoke.py --pipeline-legs <dir>``: ``layouts_pipelines`` in a
    process of its own with a cluster of its own (the gangs' workers
    start while the main cluster's serving phases run), with
    ``phase_device``'s settings; its launches and record go to
    ``<dir>/result.json``."""
    phase_device()
    card = card_line()
    ray_tpu_torch.init(num_cpus=RUNTIME_CPUS)
    try:
        legs = timed("layouts-pipelines", layouts_pipelines, card)
    finally:
        ray_tpu_torch.shutdown()
    with open(os.path.join(out_dir, "result.json"), "w") as f:
        json.dump({"launches": legs, "record": RECORD}, f)


def start_child(flag, prefix) -> dict:
    """Starts ``chip_smoke.py <flag> <dir>`` in a child process on the
    card, in a session of its own (so that ``stop_child`` ends what it
    starts too), its standard output in a file until ``join_child``
    prints it.  Its phases seed every draw; run beside this process's
    phases they share the card and the host, which moves only the times
    of both."""
    import tempfile

    tmp = tempfile.mkdtemp(prefix=prefix)
    out = open(os.path.join(tmp, "log"), "w")
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), flag, tmp],
        stdout=out, cwd=os.path.dirname(os.path.abspath(__file__)),
        start_new_session=True)
    return {"proc": proc, "tmp": tmp, "out": out, "t0": time.perf_counter()}


def join_child(child, tag, what) -> dict:
    """Waits for a child's process, prints its log, takes its record
    lines and returns its launches; raises if it failed."""
    t0 = time.perf_counter()
    rc = child["proc"].wait()
    waited = time.perf_counter() - t0
    child["out"].close()
    with open(os.path.join(child["tmp"], "log")) as f:
        sys.stdout.write(f.read())
    sys.stdout.flush()
    if rc != 0:
        raise AssertionError(f"[{tag}] {what}' process exited {rc}")
    with open(os.path.join(child["tmp"], "result.json")) as f:
        result = json.load(f)
    for name, numbers in result["record"].items():
        note(name, **numbers)
    seconds = time.perf_counter() - child["t0"]
    note(tag, s=seconds, waited_s=waited)
    log(f"[{tag}] {what} ran in a process of their own beside this "
        f"process's phases: {seconds:.1f} s, of which this process waited "
        f"{waited:.1f} s")
    return result["launches"]


def stop_child(child) -> None:
    """Ends a child's process and what it started, if still running, and
    removes its files."""
    import shutil
    import signal

    if child["proc"].poll() is None:
        os.killpg(child["proc"].pid, signal.SIGKILL)
        child["proc"].wait()
    child["out"].close()
    shutil.rmtree(child["tmp"], ignore_errors=True)


def main():
    t0 = time.perf_counter()
    timed("device", phase_device)
    card = card_line()
    timed("build", phase_build)
    timed("kernel", phase_kernel_grid)
    timed("kernel-bwd", phase_kernel_bwd_grid)
    fp32_launches, fp32_requests, fp32_want = timed("fp32",
                                                     phase_fp32_slice)
    timed("bf16", phase_bf16_slice)
    serve_model = build_model("gpt2", GPT2_SMALL_FP32, seed=SEED)
    serving = {}
    serving.update(timed("spec", phase_spec, card, serve_model))
    serving.update(timed("prefix", phase_prefix, card, serve_model))
    launches, disagg_native = timed("disagg", phase_disagg, card,
                                    serve_model)
    serving.update(launches)
    # The RL phases that need no cluster run in a process of their own,
    # and [layouts]' two pipeline legs (correctness only; their gangs'
    # workers take most of their time to start) in a process and a
    # cluster of their own, both beside the cluster's phases up to
    # [swap], whose times are readings only; they are joined before
    # [train], so that the training phases, [dp2], the Llama phases and
    # the kernels' timings have the card to themselves.
    child = start_child(RL_PHASES_FLAG, "rttp_rl_")
    legs = start_child(PIPELINE_LEGS_FLAG, "rttp_legs_")
    try:
        # The runtime's phases share one cluster on this machine (its
        # workers are subprocesses), up from [runtime] to [resnet]:
        # [actor-train] needs [train]'s losses, [trainer] [train]'s and
        # [actor-train]'s rates; [swap] runs after [swap-ref] because it
        # perturbs the serving model's weights.
        ray_tpu_torch.init(num_cpus=RUNTIME_CPUS)
        try:
            timed("runtime", phase_runtime, card)
            actor_rl = {
                "ppo-actor": timed("ppo-actor", phase_ppo_actor,
                                   card)["flash"],
                "impala-actor": timed("impala-actor", phase_impala_actor,
                                      card)["flash"],
                "dqn-actor": timed("dqn-actor", phase_dqn_actor,
                                   card)["flash"]}
            serving.update(timed("serve", phase_serve, card, fp32_requests,
                                 fp32_want))
            rlhf = timed("rlhf", phase_rlhf, card)
            serving.update(timed("disagg-actor", phase_disagg_actor, card,
                                 serve_model, disagg_native))
            serving.update(timed("swap-ref", phase_swap_ref, card,
                                 serve_model))
            serving.update(timed("swap", phase_swap, card, serve_model))
            del serve_model
            torch.cuda.empty_cache()
            rl = join_child(child, "rl-phases", "the RL phases")
            layout_legs = join_child(legs, "layouts-pipelines",
                                     "[layouts]' pipeline legs")
            train = timed("train", phase_train, card)
            moe = timed("moe-train", phase_moe_train, card)
            remat = timed("remat", phase_remat, card)
            actor_train, actor_rates = timed("actor-train",
                                             phase_actor_train, card, train)
            trainer, trainer_runs = timed("trainer", phase_trainer, card,
                                          train, actor_rates)
            data = timed("data", phase_data, card, train)
            trainer.update(timed("zero", phase_zero, card, trainer_runs))
            resnet = timed("resnet", phase_resnet, card)
            pipeline = timed("pipeline", phase_pipeline, card)
        finally:
            ray_tpu_torch.shutdown()
    finally:
        stop_child(child)
        stop_child(legs)
    # [dp2] in a cluster of its own: its elastic leg's boundary snapshot
    # (GPT-2 small's parameters and Adam moments) needs a larger store.
    ray_tpu_torch.init(num_cpus=RUNTIME_CPUS,
                       object_store_memory=DP2_STORE_BYTES)
    try:
        trainer.update(timed("dp2", phase_dp2, card, trainer_runs))
        layouts = timed("layouts", phase_layouts, card)
    finally:
        ray_tpu_torch.shutdown()
    layouts.update(layout_legs)
    timed("train-fp32", phase_train_fp32)
    llama, model = timed("llama-serve", phase_llama_serve, card)
    model = llama_copy(model, dtype=torch.bfloat16)
    llama["llama-train"] = timed("llama-train", phase_llama_train, card,
                                 model)
    del model
    torch.cuda.empty_cache()
    timed("llama-train-fp32", phase_train_fp32, "llama-train-fp32", "llama",
          LLAMA_1B.items(), llama_loss_fn)
    timing = timed("timing", phase_timing, card)
    timing_bwd = timed("timing-bwd", phase_timing_bwd, card)
    timed("timing-fp32", phase_timing_fp32, card)
    note("done", s=time.perf_counter() - t0)
    log(f"[done] {time.perf_counter() - t0:.1f} s")
    by_path = {"fp32": {"flash_fwd": fp32_launches}, **serving, **rlhf,
               **{f"train {tag}": run["launches"]
                  for tag, run in train.items()},
               **moe, **remat, **actor_train, **trainer, **data, **resnet,
               **pipeline, **layouts,
               **actor_rl,
               **llama, **rl}
    # dq's and dkv's top-level fields are those of the first training
    # shape; the forward's are the serving shape's.
    first = next(iter(timing_bwd["flash_dq"]))
    kernels = [
        ("flash_fwd", "ray_tpu_torch/ops/csrc/flash_fwd.cu",
         "ray_tpu/ops/attention.py:171", timing, timing_bwd["flash_fwd"]),
        ("flash_dq", "ray_tpu_torch/ops/csrc/flash_bwd.cu",
         "ray_tpu/ops/attention.py:240", timing_bwd["flash_dq"][first],
         timing_bwd["flash_dq"]),
        ("flash_dkv", "ray_tpu_torch/ops/csrc/flash_bwd.cu",
         "ray_tpu/ops/attention.py:284", timing_bwd["flash_dkv"][first],
         timing_bwd["flash_dkv"]),
    ]
    routes = routes_by_dtype()
    for line in record_lines():
        log(line)
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "routes_by_dtype": routes[name],
        "launches": sum(n.get(name, 0) for n in by_path.values()),
        "launches_by_path": {path: n[name] for path, n in by_path.items()
                             if name in n},
        **fields, "training_shapes": train}
        for name, source, replaces, fields, train in kernels]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == [RL_PHASES_FLAG]:
        rl_phases_main(sys.argv[2])
    elif sys.argv[1:2] == [PIPELINE_LEGS_FLAG]:
        pipeline_legs_main(sys.argv[2])
    else:
        main()
