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
- training: GPT-2 small steps (bf16 compute over fp32 parameters,
  ``adamw(3e-4)``, ``make_train_step``) at the JAX bench's two shapes,
  B=16 x S=1024 and B=4 x S=4096, every layer running the forward with
  the LSE and both backward kernels; then one fp32 step of a 2-layer
  GPT-2 small on the card against the same step on the CPU;
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
- the rest of the one-process RL path, last: the MinAtar, Pendulum and
  StatelessCartPole envs' ``step_core`` card against CPU (``[envs]``);
  PPO (``[ppo-minatar]``) and IMPALA (``[impala]``, seeds in turn) on
  Breakout-MinAtar at ``bench_ppo_breakout``'s and
  ``bench_impala_breakout``'s configurations (16384 envs x 64 steps),
  each trained to the bench's reward floor, then timed; APPO at IMPALA's
  size, timed (``[appo]``); LSTM and attention PPO on
  StatelessCartPole at the tuned example's settings, trained to reward
  150 and evaluated greedily (``[memory]``).  No RL path reaches a flash
  kernel (checked, path by path).

Each C entry picks its kernel by dtype (every bf16 kernel: ``wgmma``;
every fp32 kernel: ``fma``); the script checks and prints the routes
after the build, and the main paths run in those dtypes.  Then it times
each kernel (in CUDA graphs, without the host's enqueue) beside its
bound, its achieved TFLOP/s, its plain version and PyTorch's SDPA, in
bf16 at the training shapes (GPT-2's two and llama_1b's) and in fp32 at
the fp32 step's shape.
Every phase raises on failure and nothing is caught, so any failure
exits non-zero.

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
import itertools
import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch.models import (
    Llama,
    LlamaConfig,
    gpt2_loss_fn,
    llama_loss_fn,
)
from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops import attention as attn
from ray_tpu_torch.rllib import (
    APPOConfig,
    IMPALAConfig,
    PPOConfig,
    RLModuleSpec,
)
from ray_tpu_torch.rllib.env.torch_envs import Breakout84, make_torch_env
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
from ray_tpu_torch.train import adamw, make_train_step

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
# iteration >= 10, within 150; then 8 timed iterations
# (_measure_steps_per_s).
PPO_ENVS, PPO_UNROLL = 2048, 64
PPO_TRAINING = {"num_sgd_iter": 2, "sgd_minibatch_size": 8192, "lr": 5e-4,
                "entropy_coeff": 0.01}
PPO_PARAMS = 2_061_732  # the JAX module's count on Breakout-Atari84
ATARI84_REWARD_FLOOR = 15.0
PPO_MAX_ITERS = 150
PPO_TIMED_ITERS = 8
# The module's logits and value on the card against the CPU, fp32 with TF32
# off: the same sums (fan-in up to 7744) in other orders, ~1e-6 relative;
# held to 1e-4 of each output's largest magnitude.
PPO_MODULE_RTOL = 1e-4
# The MinAtar-scale paths, at bench.py's configurations, not cut.
# PPO: bench_ppo_breakout (:1127-1166), gated at BREAKOUT_REWARD_FLOOR
# (bench.py:25) as _learn_to_floor gates it, then 8 timed iterations.
MINATAR_ENVS, MINATAR_UNROLL = 16384, 64
MINATAR_PPO_TRAINING = {"num_sgd_iter": 2, "sgd_minibatch_size": 8192,
                        "lr": 5e-4, "entropy_coeff": 0.01}
MINATAR_REWARD_FLOOR = 3.0
# IMPALA: bench_impala_breakout (:1282-1331): seeds 0, 1, 2 in turn, each
# trained to the floor with the margin target; the first seed that reaches
# the target ends the loop; throughput is timed on the best seed that met
# the floor.  The budget is cut from the bench's 300 iterations a seed to
# 150, to keep the script's time with the serving phases: on the H100 the
# rewards of seeds 0 and 1 stop rising near 1.49 by iteration 110, and
# seed 2 passes the floor at iteration 100 (PERF.md, section 6).
IMPALA_TRAINING = {"lr": 2e-3, "entropy_coeff": 0.01}
IMPALA_FLOOR, IMPALA_TARGET, IMPALA_MAX_ITERS = 1.5, 1.8, 150
IMPALA_SEEDS = (0, 1, 2)
APPO_TIMED_ITERS = 10
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
    log(f"[{tag}] engine: {st['steps']} decode steps, "
        f"{st['decode_seconds'] / max(st['steps'], 1) * 1e3:.2f} ms/step; "
        f"{st['prefills']} prefills, "
        f"{st['prefill_seconds'] / max(st['prefills'], 1) * 1e3:.2f} "
        f"ms/prefill; {st['tokens_generated'] + st['prefills']} tokens in "
        f"{seconds:.2f} s = "
        f"{(st['tokens_generated'] + st['prefills']) / seconds:.1f} tokens/s;"
        f" preemptions {st['preemptions']}, admitted mid-batch "
        f"{st['admitted_mid_batch']}")


def phase_fp32_slice() -> int:
    """The main path: GPT-2 small fp32 through LLMServer, token-identical
    to NaiveLM(width=1024).  Returns the flash launches of this run."""
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
    return launches


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


def phase_disagg(card, model) -> dict:
    """In-process disaggregated prefill on the card, fp32: the native
    wire token-identical to inline prefill, the worker fed only uncached
    tails; the int8 wire >= 3x smaller than fp32, no page leaked."""
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
    return {"disagg": launches}


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


def phase_train(card) -> dict:
    """GPT-2 small training steps at the JAX bench's two shapes: bf16
    compute over fp32 parameters, adamw(3e-4), the same seeded ids every
    step (bench.py's synthetic branch).  One warm-up step, then timed
    steps ended by one device read of the last loss (bench.py:143-148).
    Returns the launches of each kernel in the timed windows."""
    launches = {}
    routes = {name: r["bfloat16"] for name, r in routes_by_dtype().items()}
    for b, length, iters in TRAIN_SHAPES:
        tag = f"B={b} S={length}"
        model = build_model("gpt2", {"tiny": False,
                                     "max_position_embeddings":
                                         max(1024, length)}, seed=SEED)
        cfg = model.config
        step = make_train_step(model, adamw(model.parameters(), 3e-4),
                               gpt2_loss_fn)
        ids = torch.from_numpy(np.random.default_rng(SEED).integers(
            0, cfg.vocab_size, size=(b, length))).to("cuda")
        batch = {"input_ids": ids}
        per_step = {name: cfg.num_layers for name in attn.LAUNCHES}
        zero_launches()
        first = step(batch).item()
        if attn.LAUNCHES != per_step:
            raise AssertionError(f"[train] {tag} warm-up step launched "
                                 f"{attn.LAUNCHES}, expected {per_step}")
        torch.cuda.reset_peak_memory_stats()
        zero_launches()
        t0 = time.perf_counter()
        losses = [step(batch) for _ in range(iters)]
        last = losses[-1].item()  # the one device read: the barrier
        seconds = time.perf_counter() - t0
        counted = dict(attn.LAUNCHES)
        launches[tag] = counted
        want = {name: n * iters for name, n in per_step.items()}
        if counted != want:
            raise AssertionError(f"[train] {tag}: {iters} steps launched "
                                 f"{counted}, expected {want}")
        losses = [first] + torch.stack(losses).tolist()
        if not all(np.isfinite(losses)):
            raise AssertionError(f"[train] {tag}: losses {losses}")
        if abs(first - LN_VOCAB) > FIRST_LOSS_SLACK:
            raise AssertionError(f"[train] {tag}: first loss {first:.4f} "
                                 f"not within {FIRST_LOSS_SLACK} of ln "
                                 f"50257 = {LN_VOCAB:.4f}")
        if not last < first:
            raise AssertionError(f"[train] {tag}: loss did not fall "
                                 f"({first:.4f} -> {last:.4f})")
        n_params = sum(p.numel() for p in model.parameters())
        flops_per_token = (6 * n_params + 12 * cfg.num_layers
                           * cfg.hidden_size * length)
        tokens_per_s = iters * b * length / seconds
        mfu = tokens_per_s * flops_per_token / PEAK_OPS_PER_S[torch.bfloat16]
        log(f"[train] {card} | GPT-2 small {tag} bf16/fp32-params adamw: "
            f"{iters} steps in {seconds:.3f} s = "
            f"{seconds / iters * 1e3:.1f} ms/step, {tokens_per_s:.0f} "
            f"tokens/s, MFU {mfu:.4f} (N={n_params}, "
            f"{flops_per_token / 1e9:.3f} GFLOP/token, bf16 peak); loss "
            f"{' '.join(f'{x:.4f}' for x in losses)}; launches per step "
            f"{per_step}, bf16 routes {routes}; peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
        del model, step, losses
        torch.cuda.empty_cache()
    return launches


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
    shape (1x12x1024x64, causal, q/k/v the views of a fused QKV output):
    the forward with the LSE, dq and dkv, each held against its plain
    version and timed in a CUDA graph beside its bound (fp32 at the FMA
    rate), the plain versions and SDPA in fp32 (TF32 off, as
    phase_device sets it; its backward as forward+backward minus
    forward, from back-to-back launches)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    q, k, v = fused_qkv(*PATH_SHAPE, torch.float32, gen)
    d_out = torch.randn(q.shape, device="cuda", generator=gen)
    scale = PATH_SHAPE[-1] ** -0.5
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
                                 f"{PATH_SHAPE}: {errs}")
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
    log(f"[timing-fp32] {card} | 1x12x1024x64 fp32 causal fused, TF32 off: "
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


def profile_device(fn, groups=DEVICE_GROUPS) -> dict:
    """What ``fn()`` puts on the card, from ``torch.profiler``: the device
    operations it ran (kernels, memsets, copies), the kernel-launch calls
    the host made (``cudaLaunchKernel``, ``cuLaunchKernel``), the device
    time summed over those operations (one stream: they do not overlap),
    that time by ``groups`` (first match of a name's words), and the six
    operations that took the most of it, with their counts."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    # A user annotation (the optimizer's "Optimizer.step#...") also has a
    # span on the device's timeline, over kernels counted on their own.
    device = {e.key: (e.count, getattr(e, "self_device_time_total", getattr(
        e, "self_cuda_time_total", 0)) / 1e3)
              for e in events
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)}
    top = sorted(device.items(), key=lambda kv: -kv[1][1])[:6]
    by_group = {}
    for name, (_, ms) in device.items():
        group = next((g for g, words in groups if any(
            w in name for w in words)), "other")
        by_group[group] = by_group.get(group, 0.0) + ms
    return {"device_ops": sum(n for n, _ in device.values()),
            "launch_calls": sum(e.count for e in events
                                if "LaunchKernel" in e.key),
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
    log(f"[ppo] {card} | PPO Breakout-Atari84 {PPO_ENVS} envs x "
        f"{PPO_UNROLL} steps, Nature CNN ({n_params} parameters), fp32, "
        f"TF32 off, eager: {PPO_TIMED_ITERS} iterations in "
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
    """This slice's envs, ``step_core`` on the card against the CPU from
    the same seeded states, actions and draws: Breakout-MinAtar and
    SpaceInvaders bitwise (state, boards, reward, done, frames),
    Pendulum's and StatelessCartPole's float state within
    ``ENV_FLOAT_TOL``; how many states took each branch."""
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
             ("StatelessCartPole-v1", cart, (), ("core", "obs")))
    lines = []
    for name, states, draws, floats in cases:
        env = make_torch_env(name)
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
        elif name == "Pendulum-v1":
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
    trained to the floor, then 8 timed iterations, one env step profiled
    (device ops)."""
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
    log(f"[ppo-minatar] {card} | PPO Breakout-MinAtar {MINATAR_ENVS} envs "
        f"x {MINATAR_UNROLL} steps, MinAtar CNN, fp32, TF32 off, eager: "
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
    seeds in turn to the floor (margin target 1.8), 8 timed iterations on
    the best seed past the floor."""
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


def main():
    t0 = time.perf_counter()
    phase_device()
    card = card_line()
    phase_build()
    phase_kernel_grid()
    phase_kernel_bwd_grid()
    serve_launches = phase_fp32_slice()
    phase_bf16_slice()
    serve_model = build_model("gpt2", GPT2_SMALL_FP32, seed=SEED)
    serving = {}
    for phase in (phase_spec, phase_prefix, phase_disagg, phase_swap):
        t_phase = time.perf_counter()
        serving.update(phase(card, serve_model))
        log(f"[{phase.__name__[6:]}] {time.perf_counter() - t_phase:.1f} s")
    del serve_model
    torch.cuda.empty_cache()
    train_launches = phase_train(card)
    phase_train_fp32()
    t_phase = time.perf_counter()
    llama, model = phase_llama_serve(card)
    model = llama_copy(model, dtype=torch.bfloat16)
    llama["llama-train"] = phase_llama_train(card, model)
    del model
    torch.cuda.empty_cache()
    phase_train_fp32("llama-train-fp32", "llama", LLAMA_1B.items(),
                     llama_loss_fn)
    log(f"[llama] {time.perf_counter() - t_phase:.1f} s")
    timing = phase_timing(card)
    timing_bwd = phase_timing_bwd(card)
    phase_timing_fp32(card)
    phase_ppo_parity()
    ppo = phase_ppo(card)
    phase_envs()
    rl = {"ppo-minatar": phase_ppo_minatar(card)["flash"]}
    # IMPALA's gate is close: on an H100 seeds 0 and 1 end at 1.49 against
    # the floor of 1.5.  cuDNN documents its weight-gradient algorithms 0
    # and 3 as non-deterministic (atomic adds), with which a rerun need not
    # repeat a seed's plateau; IMPALA's and APPO's phases run cuDNN's
    # deterministic algorithms, so that the same card and stack repeat
    # each seed's outcome.
    torch.backends.cudnn.deterministic = True
    rl["impala"] = phase_impala(card)["flash"]
    rl["appo"] = phase_appo(card)["flash"]
    torch.backends.cudnn.deterministic = False
    rl.update({f"ppo-{kind}": n for kind, n in phase_memory(card).items()})
    log(f"[done] {time.perf_counter() - t0:.1f} s")
    by_path = {"serve": {"flash_fwd": serve_launches}, **serving,
               **{f"train {tag}": n for tag, n in train_launches.items()},
               **llama, "ppo": ppo["flash"], **rl}
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
    main()
