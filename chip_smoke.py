"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's hand-written kernels from ``ray_tpu_torch/ops/csrc``,
holds each against its plain PyTorch version on the card, then drives the
port's main path: GPT-2 small (random weights from a seed) served through
``LLMServer`` (the paged-KV ``LLMEngine``), token-identical in fp32 to
``NaiveLM(width=1024)``, whose full-context forwards run the flash
kernel in every layer; then the same requests in bf16.  Every phase
raises on failure and nothing is caught, so any failure exits non-zero.

The line before the last is the card's name and power limit, as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
them; the line before that is a JSON object of every kernel's launches,
error and times.  The last line is exactly
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without CUDA it exits non-zero and prints no result.
"""
from __future__ import annotations

import concurrent.futures
import itertools
import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops import attention as attn
from ray_tpu_torch.serve import LLMServer, NaiveLM, build_model

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
# The path's attention shape: NaiveLM at width 1024 on GPT-2 small.
PATH_SHAPE = (1, 1024, 12, 64)
SEED = 0
PROMPT_LENS = (17, 60, 123, 200, 256, 300)
NEW_TOKENS = 32
# bf16 full-context logits against fp32 on the same weights: 12 layers of
# bf16 rounding (2^-8 relative per op) on logits of scale ~1; the bound is
# 5% of the largest fp32 logit.
BF16_LOGITS_REL = 0.05


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


def flash_bound(q, causal) -> tuple:
    """Least time (ms) for the flash forward on these inputs: Q, K, V read
    once and O written once, against QK^T and PV over the visible pairs."""
    b, lq, h, d = q.shape
    nbytes = 4 * q.numel() * q.element_size()
    pairs = lq * (lq + 1) // 2 if causal else lq * lq
    ops = 2 * 2 * b * h * pairs * d
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[q.dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def kernel_error(o, o_ref) -> float:
    """The error that ``TOL`` bounds: max |dO| in fp32; in bf16, |dO| over
    the largest |O_ref| of its row (over D)."""
    diff = (o.float() - o_ref.float()).abs()
    if o.dtype == torch.float32:
        return diff.max().item()
    row = o_ref.float().abs().amax(-1, keepdim=True).clamp_min(1e-30)
    return (diff / row).max().item()


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
    t0 = time.perf_counter()
    _build.load("flash_fwd")
    log(f"[build] flash_fwd: {time.perf_counter() - t0:.1f} s; CUDA "
        f"runtime(s) in the process: {cudart_libs()}")


def phase_kernel_grid():
    """The flash kernel against flash_attention_reference over the grid,
    in both layouts (contiguous, and the model's views of a fused QKV
    output), and both refusals."""
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    n = 0
    with torch.no_grad():
        for b, length, d, dtype in itertools.product(
                (1, 4), (128, 1024, 2048), (64, 128),
                (torch.bfloat16, torch.float32)):
            fused = fused_qkv(b, length, 12, d, dtype, gen)
            for layout, causal, with_lse in itertools.product(
                    ("contiguous", "fused_qkv"), (True, False),
                    (True, False)):
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
                        f"flash kernel disagrees (B={b} L={length} D={d} "
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
        attn.LAUNCHES["flash_fwd"] = 0
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
        f"({(launches - engine_launches) / steps:.1f} per step)")
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


def phase_timing(card) -> dict:
    """Kernel, plain version and SDPA at the path's shape and layout (bf16
    causal, q/k/v the views of a fused QKV output, back-to-back launches,
    inputs L2-resident as in the model), plus the kernel-vs-plain-path
    crossover over L."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    q, k, v = fused_qkv(*PATH_SHAPE, torch.bfloat16, gen)
    with torch.no_grad():
        got = attn.flash_attention(q, k, v, causal=True)
        want = attn.flash_attention_reference(q, k, v, causal=True)
        err = (got.float() - want.float()).abs().max().item()
        if not kernel_error(got, want) <= TOL[torch.bfloat16]:
            raise AssertionError("flash kernel disagrees at the path's "
                                 "shape")
        ms = cuda_ms(lambda: attn.flash_attention(q, k, v, causal=True))
        plain_ms = cuda_ms(lambda: attn.flash_attention_reference(
            q, k, v, causal=True))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        sdpa_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True))
        q32, k32, v32 = (x.float() for x in (q, k, v))
        ms32 = cuda_ms(lambda: attn.flash_attention(q32, k32, v32,
                                                    causal=True))
    bound_ms, bound_by = flash_bound(q, True)
    log(f"[timing] {card} | flash_fwd 1x12x1024x64 bf16 causal: kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA {sdpa_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by}); fp32 kernel {ms32:.4f} ms (bound "
        f"{flash_bound(q32, True)[0]:.4f} ms)")
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


def main():
    t0 = time.perf_counter()
    phase_device()
    card = card_line()
    phase_build()
    phase_kernel_grid()
    launches = phase_fp32_slice()
    phase_bf16_slice()
    timing = phase_timing(card)
    log(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": [{
        "name": "flash_fwd", "route": "cuda",
        "source": "ray_tpu_torch/ops/csrc/flash_fwd.cu",
        "replaces": "ray_tpu/ops/attention.py:171",
        "launches": launches, **timing}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
