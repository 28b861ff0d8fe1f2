"""Time the port's bf16 flash forward, dq and dkv kernels of several
source trees on one NVIDIA card, in alternating turns.

    python3 chip_kernel_ab.py TREE [TREE ...]

Each TREE is a directory that holds a ``ray_tpu_torch`` package: this
checkout (``.``), or another commit unpacked with ``git archive`` into a
directory that ``.gitignore`` lists.  The trees run in order and then in
reverse (parent, change, change, parent for two trees; name a tree again
for more turns), each run in a fresh process that builds that tree's
kernels from its own sources, holds the forward (O and LSE), dq and dkv
against their plain versions at chip_smoke.py's bounds, and times them
in CUDA graphs
(chip_smoke.py's ``graph_ms``) at the two training shapes and the serving
shape (bf16, causal, q/k/v the views of a fused QKV output).  It prints
one JSON line a run, ``{"tree": ..., "turn": ..., "ms": {...}}``, then the
card's name and power limit.  Only times from one call are comparable.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
SHAPES = ((16, 1024), (4, 4096), (1, 1024))  # (B, L); H = 12, D = 64
SEED = 5


def child(tree: str) -> dict:
    """Check and time the kernels of ``tree`` (imported first on the
    path); the helpers are this checkout's chip_smoke.py."""
    sys.path.insert(0, str(Path(tree).resolve()))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import torch
    from ray_tpu_torch.ops import attention as attn

    if not torch.cuda.is_available():
        raise SystemExit("chip_kernel_ab: needs an NVIDIA card")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    bf16 = torch.bfloat16
    times = {}
    for b, length in SHAPES:
        q, k, v = smoke.fused_qkv(b, length, 12, 64, bf16, gen)
        d_out = torch.randn(q.shape, device="cuda", generator=gen).to(bf16)
        scale = 64 ** -0.5
        with torch.no_grad():
            out, lse = attn._flash_fwd_cuda(q, k, v, True, scale, True)
            want, want_lse = attn.flash_attention_reference(
                q, k, v, True, scale, True)
            ops = attn._bwd_operands(q, k, v, out, lse, d_out, True)
            dq = attn._flash_dq_cuda(q, k, v, *ops, True, scale)
            dk, dv = attn._flash_dkv_cuda(q, k, v, *ops, True, scale)
            grads = attn.flash_attention_backward_reference(
                q, k, v, out, lse, d_out, True)
            errs = (smoke.kernel_error(out, want),
                    (lse - want_lse).abs().max().item(),
                    *(smoke.bwd_error(g, r) for g, r in zip((dq, dk, dv),
                                                             grads)))
            if not (errs[0] <= smoke.TOL[bf16] and errs[1] <= smoke.LSE_ATOL
                    and max(errs[2:]) <= smoke.BWD_TOL[bf16]):
                raise AssertionError(f"{tree} {b}x{length}: errors {errs}")
            del want, want_lse, grads, dq, dk, dv
            times[f"{b}x12x{length}x64"] = {
                "fwd_lse": smoke.graph_ms(lambda: attn._flash_fwd_cuda(
                    q, k, v, True, scale, True)),
                "fwd": smoke.graph_ms(lambda: attn._flash_fwd_cuda(
                    q, k, v, True, scale, False)),
                "dq": smoke.graph_ms(lambda: attn._flash_dq_cuda(
                    q, k, v, *ops, True, scale)),
                "dkv": smoke.graph_ms(lambda: attn._flash_dkv_cuda(
                    q, k, v, *ops, True, scale)),
            }
        del q, k, v, d_out, out, lse, ops
        torch.cuda.empty_cache()
    return times


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("trees", nargs="+")
    parser.add_argument("--child", action="store_true",
                        help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.child:
        print(json.dumps(child(args.trees[0])), flush=True)
        return
    order = list(args.trees) + list(reversed(args.trees))
    for turn, tree in enumerate(order):
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--child", tree],
            capture_output=True, text=True, env=env, cwd=str(HERE))
        if proc.returncode != 0:
            raise SystemExit(f"chip_kernel_ab: {tree} failed "
                             f"({proc.returncode}):\n{proc.stderr[-4000:]}")
        ms = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps({"tree": tree, "turn": turn, "ms": ms}), flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card.splitlines()[0])


if __name__ == "__main__":
    main()
