#!/usr/bin/env python3
"""Time the grouped GEMM of several builds of `csrc/gemm.cu` against each
other on one NVIDIA GPU, at the deepseek-moe-16b expert shapes (28 layers
x {up, down}, 64 experts) with 16 rows an expert (the 4-slot decode tick)
and 128 (a prefill slab), and the ungrouped popcount bodies at a
llama3.2-3b 256-row prefill.

    python3 chip_ab.py TREE [TREE ...]

A TREE is a directory holding a checkout of this repository (`.` for this
one, or a parent commit unpacked with `git archive` into `build/parent`).
Each tree's `src/repro_torch/kernels/csrc/gemm.cu` is built with
`build.NVCC_FLAGS` (one nvcc each, in parallel) into `build/ab/`; its
ptxas lines for the tensor-core kernels are printed. Every tree runs
through this checkout's harness, the body's launcher bound to that tree's
`repro_gemm_grouped` or `repro_gemm` (one C signature each in every tree),
on the same operands, and each result must be bit-equal to the body's
plain version (int32 accumulator and bf16 output). The grouped bodies are
K3 and K4 (binary and ternary popcount), K7 (binary and ternary mxu), K8
and K11's s4 body; the ungrouped ones K3 and K4 (28 x {qkv, out, up, down}
+ lm_head at M = 256, their 64-row b1 tile). Per body the trees are timed
in turns, t1 .. tn then tn .. t1, each launch as `chip_smoke.time_ms` times
it (operands cold, 10 launches); a tree's tick is the mean of its two
turns. Prints the card's name and power limit, a line per body and rows,
then one JSON line. Exits non-zero without a CUDA device or when a tree
disagrees.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
#: the bodies timed grouped: K3, K4, K7 (binary, ternary), K8, and K11's s4
#: body
TIMED = ("bgemm_popcount", "tgemm_popcount", "bgemm_mxu", "tgemm_mxu",
         "tgemm_wt_i8a", "i4gemm_w4a8")
#: rows an expert: the 4-slot decode tick's, and a prefill slab
ROWS = (16, 128)
#: the bodies also timed ungrouped, at PREFILL rows
UNGROUPED = ("bgemm_popcount", "tgemm_popcount")
PREFILL = 256


def build_tree(tree: str):
    """Start nvcc for one tree; returns (tree, library path, Popen or None
    when the library exists)."""
    from repro_torch.kernels import build
    src = (ROOT / tree).resolve() / "src/repro_torch/kernels/csrc/gemm.cu"
    if not src.exists():
        raise SystemExit(f"chip_ab: no {src}")
    h = hashlib.sha256(src.read_bytes() + (src.parent / "ptx.cuh").read_bytes())
    out = ROOT / "build" / "ab" / f"libgemm-{h.hexdigest()[:12]}.so"
    if out.exists():
        return tree, out, None
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", str(out), str(src)]
    return tree, out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)


def ptxas_lines(tree: str, text: str,
                keep=("pop_mma", "mxu_mma", "wt_mma", "s4_mma")) -> None:
    """Print the registers and spills of the tensor-core kernels timed."""
    fn = None
    for line in text.splitlines():
        hit = re.search(r"Compiling entry function '(\S+)'", line)
        if hit:
            fn = hit.group(1)
        elif fn and any(k in fn for k in keep) and ("registers" in line or "spill" in line):
            print(f"[ab] {tree} {fn}: {line.strip()}", flush=True)


def bind(path: Path) -> dict:
    """The tree's `repro_gemm_grouped` and `repro_gemm`, typed as the
    harness calls them."""
    from repro_torch.kernels import harness
    lib, fns = ctypes.CDLL(str(path)), {}
    for kernel in (harness.GEMM_GROUPED, harness.gemm_kernel()):
        fn = getattr(lib, kernel.symbol)
        fn.argtypes = list(kernel.argtypes) + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[kernel.symbol] = fn
    return fns


def same(tree: str, label: str, got, want) -> None:
    """Exit unless got == want bit for bit (int32, or bf16 as int16)."""
    if got.dtype == torch.bfloat16:
        got, want = got.view(torch.int16), want.view(torch.int16)
    if not torch.equal(got, want):
        print(f"chip_ab: {tree} {label}: kernel != plain", file=sys.stderr)
        raise SystemExit(1)


def in_turns(libs, kernel, fn, flush, tick: dict, scale: float) -> None:
    """Time fn() with `kernel` bound to each tree's library in turns, t1 ..
    tn then tn .. t1, adding scale x half of each turn's ms to tick[tree]."""
    import chip_smoke as cs
    for tree, fns in libs + libs[::-1]:
        kernel._fn = fns[kernel.symbol]
        tick[tree] += scale * cs.time_ms(fn, 10, flush) / 2


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="+")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_ab: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import BODIES, harness

    cs.phase_device()
    jobs = [build_tree(t) for t in args.trees]
    libs = []
    for tree, out, proc in jobs:
        if proc is not None:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                print(f"chip_ab: nvcc failed for {tree}:\n{log}", file=sys.stderr)
                return 1
            ptxas_lines(tree, log)
        libs.append((tree, bind(out)))

    by_name = {b.name: b for b in BODIES}
    cfg = get_config("deepseek-moe-16b")
    gen = torch.Generator(device="cuda").manual_seed(7)
    flush = torch.ones(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    result = {}
    for m in ROWS:
        for bname in TIMED:
            body = by_name[bname]
            tick = {tree: 0.0 for tree, _ in libs}
            for name, g, n, k in cs.moe_gemm_shapes(cfg):
                x_ops, w_ops, ws, as_, bias = cs.grouped_stack(body, g, m, n, k, gen)
                dot = cs.grouped_plain(body, x_ops, w_ops, None, None, None, k, "acc")
                want = cs.grouped_plain(body, x_ops, w_ops, ws, as_, bias, k)
                for tree, fns in libs:
                    body.grouped._fn = fns[body.grouped.symbol]
                    label = f"{bname} {name} M={m}"
                    same(tree, label, harness.gemm_grouped(body, x_ops, w_ops, None, None,
                                                           k=k, out="acc"), dot)
                    same(tree, label, harness.gemm_grouped(body, x_ops, w_ops, ws, as_, bias,
                                                           k=k), want)
                in_turns(libs, body.grouped, lambda: harness.gemm_grouped(
                    body, x_ops, w_ops, ws, as_, k=k), flush, tick, cfg.n_layers)
                del x_ops, w_ops, ws, as_, bias, dot, want
                torch.cuda.empty_cache()
            result[f"{bname} grouped M={m}"] = tick
            print(f"[ab] {bname} grouped, deepseek-moe-16b {m} rows an expert, a tick of "
                  f"28 x {{up, down}} (bit-equal to plain in every tree): "
                  + "; ".join(f"{tree} {t:.3f} ms" for tree, t in tick.items()), flush=True)
    dense = get_config("llama3.2-3b")
    for bname in UNGROUPED:
        body = by_name[bname]
        tick = {tree: 0.0 for tree, _ in libs}
        for name, n, k, per_tick in cs.gemm_shapes(dense):
            x_ops, w_ops, ws, as_, bias = cs.gemm_operands(body, PREFILL, n, k, gen)
            dot = body.plain(x_ops, w_ops, k)
            want = harness.requant(dot, ws, as_, bias).to(torch.bfloat16)
            for tree, fns in libs:
                body.kernel._fn = fns[body.kernel.symbol]
                label = f"{bname} {name} M={PREFILL}"
                same(tree, label, harness.gemm(body, x_ops, w_ops, None, None, k=k,
                                               out="acc"), dot)
                same(tree, label, harness.gemm(body, x_ops, w_ops, ws, as_, bias, k=k), want)
            in_turns(libs, body.kernel, lambda: harness.gemm(body, x_ops, w_ops, ws, as_, k=k),
                     flush, tick, per_tick)
            del x_ops, w_ops, ws, as_, bias, dot, want
        result[f"{bname} ungrouped M={PREFILL}"] = tick
        print(f"[ab] {bname} ungrouped, llama3.2-3b {PREFILL}-row prefill (28 x {{qkv, out, "
              f"up, down}} + lm_head, bit-equal to plain in every tree): "
              + "; ".join(f"{tree} {t:.3f} ms" for tree, t in tick.items()), flush=True)
    print(json.dumps({"tick_ms": result}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
