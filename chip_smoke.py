#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU and check
it end to end.

    python3 chip_smoke.py

Phases:
  1. device  — the card's name and power limit (nvidia-smi)
  2. build   — nvcc builds every kernel under src/repro_torch/kernels/csrc
               (one nvcc per source, in parallel) for sm_90a; prints each
               kernel's registers and spills, and fails unless the SASS
               (cuobjdump) of K6's bf16 kernel holds HMMA/HGMMA, that of
               every instantiation (16- and 128-row tiles) of the
               tensor-core kernels of K1, K7 (binary and ternary), K8, K9
               and K10 IMMA/IGMMA and that of every instantiation of K3's
               and K4's b1 tile (16- and 64-row, ungrouped and grouped)
               BMMA/BGMMA instructions, or if K5's llama3.2-3b or
               deepseek-moe-16b instantiation, any of K3's and K4's kernels
               or the 16-row K7 / K8 tiles spill
  3. kernels — each CUDA kernel against its plain PyTorch version on the
               card, at the serve path's full llama3.2-3b shapes: the packed
               GEMM under each of its seven MAC bodies at M = 4, 32 and 256,
               the mxu bodies (K7), their popcount twins (K3, K4) and
               wt-i8a (K8) also at M = 8 and 9, each side of their switch
               from the streaming kernel to the tensor-core kernel (int32
               accumulator and bf16 requant output bit-equal, bias on and
               off; the mxu bodies' accumulators equal the popcount
               bodies'; K9 at qkv, out, up
               and down, the shapes w4a8 runs it at; K1's and K9's decode
               ticks also timed back to back),
               one torch.mm in bf16 on the unpacked codes beside each
               body at M = 4; the plane-composed bodies (K10, int4 and int8
               stacks) at P = 1, 2 and bits live planes and M = 4, 7, 9,
               13, 16, 32, 40 and 256 (both regimes; bit-equal, and at P =
               bits equal to the direct int8 / int4 bodies' accumulators on
               the composed codes), paged decode (bf16 and int8 pools, within
               2e-2; the 4-slot tick, 4 slots over a 2048-token cache and
               16 verify rows, each beside SDPA), flash attention (T = 256
               and 2048, bf16, within 3e-2),
               and the grouped GEMM (K11) at the full-width expert shapes of
               deepseek-moe-16b (G = 64) and phi3.5-moe-42b-a6.6b (G = 16),
               M = 4, 16 and 128 rows per expert (1- and 4-slot decode, a
               prefill slab), K9 and K1 bodies (bit-equal to the plain
               version and to G ungrouped launches); K10 over expert stacks
               (the plane bodies grouped) at the same shapes and rows, P = 1
               and bits live planes (bit-equal to the plain version and to
               G ungrouped K10 launches, and at P = bits to K11's int4 /
               int8 body on the composed codes); grouped K7 (binary and
               ternary mxu) and K8 (wt-i8a) on the tensor-core tile at the
               same shapes and rows (bit-equal to the plain version and to
               G ungrouped launches; K7's accumulators equal grouped K3's /
               K4's); grouped K3 and K4 on the b1 tile at deepseek-moe-16b's
               expert shapes, M = 4, 16 and 128 (bit-equal to the plain
               version, to G ungrouped launches and to grouped K7 on the
               same operands, timed beside it; at 16 rows beside torch.bmm,
               at 128 beside torch._int_mm once per expert); with
               kernel, plain and library times and the bound of each
  4. serve   — full-width, 28-layer llama3.2-3b from the port's seeded init,
               8 requests through the paged continuous-batching server:
               binary, ternary and int8 on the serve CLI's 4..16-token
               prompts; het, w-ternary (the arch's default) and binary and
               ternary in both formulations (popcount, mxu) on a mix of
               4..16- and 129..224-token prompts, whose prefill runs flash
               attention; the other policies at 3 layers, full width, on the
               mix (3 layers: one body layer between the first and the
               last). Every run reads each kernel's launch count (set to 0
               just before it) and fails if a kernel its layers resolve to
               was not launched; a 4-slot server's tokens must equal a
               1-slot server's, and mxu tokens the popcount tokens; int8 and
               w4a8 at 28 layers on the mix with `--impl planes` (tokens ==
               the direct cells' tokens, 4-slot == 1-slot) and with
               self-speculative decoding at a sign-plane draft (planes:1)
               and a full-depth draft (planes:8), and binary with a
               planes:1 draft (the per-layer popcount fallback): spec
               tokens == sequential tokens, with the drafted and accepted
               counts; then one profiled 4-slot decode tick for binary,
               ternary, int8, het, w-ternary and int8 under planes (wall
               time, device busy time, top kernels), and one profiled
               256-token het prefill (time to first token: wall, device
               busy, flash attention's share)
  5. moe     — MoE serving, 8 requests on the serve CLI's prompts, from the
               port's seeded init packed block by block: deepseek-moe-16b at
               full width and depth under het and int8, phi3.5-moe at full
               width and 4 layers under het (84 GB of bf16 layers at full
               depth), deepseek under w-ternary (weight-only experts, no
               K11) at 4 layers; 4-slot tokens == 1-slot tokens, the routing
               counters (moe_routed == sum(moe_expert_tokens) +
               moe_dropped), and the GEMM launches exactly one per layer per
               forward call, one grouped launch per expert projection,
               counted by its form;
               deepseek het also with `--impl planes` and with
               `--spec-draft planes:1 --spec-k 4`, phi3.5-moe het with
               `--impl planes` (K10 over expert stacks; tokens == the
               direct run's, 4-slot == 1-slot, launches counted exactly);
               deepseek at full depth under wt-a8 (grouped K8) and ternary,
               popcount and `--impl mxu` (grouped K4, grouped K7: mxu
               tokens == popcount tokens), and at 4 layers under binary
               (grouped K3); then
               one profiled 4-slot decode tick of deepseek het, direct and
               under `--impl planes`, and of deepseek wt-a8
  6. archs   — qwen1.5-32b (4 of 64 layers) and nemotron-4-340b (2 of 96)
               at full width under ternary: 4-slot == 1-slot tokens
  7. launches — every kernel was launched on the serve path
  8. summary — one line per kernel, then one JSON line of kernel records:
               ms, plain_ms, bound_ms and library_ms are per decode tick of
               the serve path for a GEMM body (4 slots, the layers that run
               it: 28 x {qkv, out, up, down} + lm_head for a whole-model body,
               het's layers for the mixed bodies, w4a8's 26 body layers for
               the int4 plane body), 28 launches for paged
               decode, per 256-token prefill (28 layers) for flash
               attention, and per 4-slot deepseek-moe-16b het decode tick
               (28 x {up, down} expert stacks) for K11 (K9 body) and for K10
               over expert stacks (int4 stacks, P = 4), per 4-slot deepseek
               decode tick of its policy (28 x {up, down}, 16 rows an
               expert) for grouped K7 (ternary mxu), K8 and K4 (ternary
               popcount, whose record holds K3's grouped launches too)
The last line is {"ok": true, "device": {...}} only when every phase passed;
any failure exits non-zero. Without a CUDA device, or outside a checkout
of the repository, it exits non-zero and prints no result.
"""
from __future__ import annotations

import dataclasses
import json
import re
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# NVIDIA H100 SXM data sheet (dense): the bounds below are against these
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
BF16_FLOPS_PER_S = 989e12
SPIN_CYCLES = 200_000        # ~0.1 ms of device clock before each timed span
TICK_SPIN_CYCLES = 40_000_000   # ~20 ms: the host issues a tick's launches meanwhile
LIST_SPIN_CYCLES = 4_000_000    # ~2 ms: ... or a library call once per expert

ARCH = "llama3.2-3b"
POLICIES = ("binary", "ternary", "int8")     # the first slice's runs
#: full-depth runs on the mixed prompts: (policy, impl)
MIXED_RUNS = (("het", "popcount"), ("w-ternary", "popcount"),
              ("binary", "popcount"), ("binary", "mxu"),
              ("ternary", "popcount"), ("ternary", "mxu"))
#: the remaining policies, at SHALLOW layers and full width: 3, so that
#: one layer is neither first nor last and runs the policy's body cell
SHALLOW_POLICIES = ("mixed", "wt-a8", "w4a8", "w-binary", "w-int4", "w-int8",
                    "none")
SHALLOW = 3
PROFILED = (("binary", "popcount"), ("ternary", "popcount"), ("int8", "popcount"),
            ("het", "popcount"), ("w-ternary", "popcount"), ("int8", "planes"))
#: full-depth --impl planes and speculative runs on the mixed prompts
PLANE_POLICIES = ("int8", "w4a8")
SPEC_DRAFTS = ("planes:1", "planes:8")     # sign plane; full depth
SPEC_K = 4
PLANE_DEPTHS = (1, 2)                      # truncations checked besides bits
SLOTS, CACHE_LEN, PAGE_SIZE, REQUESTS, MAX_NEW = 4, 256, 32, 8, 16
PREFILL_BUCKET = 32          # the serve CLI's 4..16-token prompts land here
LONG_BUCKET = 256            # the 129..224-token prompts land here
LONG_PROMPT = 2048           # K6 is also checked at a 2048-token prompt
#: K10's checked rows: decode (4 slots), each side of the switch from the
#: streaming kernel to the tensor-core kernel above 8 rows (7 | 9), verify
#: rows (4 slots x 4 drafts = 16) and a ragged 13, both prefill buckets and
#: a ragged 40
PLANE_ROWS = (SLOTS, 7, 9, 13, 16, PREFILL_BUCKET, 40, LONG_BUCKET)
PAGED_POS = (1, 77, 160, 255)  # 4 slots, positions spread over 1..255
#: K5's other checked shapes: 4 slots over a 2048-token cache, and 16
#: verify rows (4 slots x 4 consecutive positions, each row reading its
#: slot's pages)
LONG_POS = (2047, 1000, 511, 1536)
VERIFY_POS = tuple(max(p - 3, 0) + i for p in PAGED_POS for i in range(4))
VERIFY_SLOTS = tuple(r // 4 for r in range(16))

_GEMM = "src/repro/kernels/harness.py:240 (gemm, {} body {})"
MOE_ARCHS = ("deepseek-moe-16b", "phi3.5-moe-42b-a6.6b")
#: rows per expert of the grouped GEMM: a 1-slot and a 4-slot decode tick
#: (slots x capacity 4) and a prefill-sized slab
GROUPED_ROWS = (4, 16, 128)
TICK_ROWS = 16               # the 4-slot decode tick's, timed per tick
LIB_ROWS = 128               # rows an expert where torch._int_mm is timed beside
#: the grouped forms on the tensor-core tile, checked at the MoE expert
#: shapes: kernel record -> its bodies, the first the one whose deepseek
#: decode tick the record holds (het's experts for K11, the served ternary
#: --impl mxu for K7, wt-a8's for K8)
GROUPED_FORMS = {"gemm_grouped": ("i4gemm_w4a8", "i8gemm"),
                 "gemm_grouped_mxu": ("tgemm_mxu", "bgemm_mxu"),
                 "gemm_grouped_wt_i8a": ("tgemm_wt_i8a",)}
#: GEMM rows checked: decode (4 slots), both prefill buckets, and for the
#: mxu bodies (K7) and their popcount twins each side of K7's switch from
#: its streaming kernel (up to 8 rows) to its tensor-core kernel
GEMM_ROWS = (SLOTS, PREFILL_BUCKET, LONG_BUCKET)
MXU_ROWS = (SLOTS, 8, 9, PREFILL_BUCKET, LONG_BUCKET)
REPLACES = {
    "i8gemm": _GEMM.format("I8_DOT", "i8gemm.py:18"),
    "bgemm_popcount": _GEMM.format("BINARY_POPCOUNT", "bgemm.py:29"),
    "tgemm_popcount": _GEMM.format("TERNARY_POPCOUNT", "tgemm.py:29"),
    "bgemm_mxu": _GEMM.format("BINARY_MXU", "bgemm.py:50"),
    "tgemm_mxu": _GEMM.format("TERNARY_MXU", "tgemm.py:56"),
    "tgemm_wt_i8a": _GEMM.format("TERNARY_W_I8A", "tgemm.py:70"),
    "i4gemm_w4a8": _GEMM.format("INT4_W_I8A", "i4gemm.py:25"),
    "pgemm_w4a8_planes": _GEMM.format("PLANES_W4_I8A", "pgemm.py:39 _planes_step, :61"),
    "pgemm_w8a8_planes": _GEMM.format("PLANES_W8_I8A", "pgemm.py:39 _planes_step, :62"),
    "paged_flash_decode": "src/repro/kernels/paged_attn.py:205 (paged_flash_decode)",
    "flash_attention": "src/repro/kernels/flash_attn.py:86 (flash_attention, "
                       "_flash_kernel :31)",
    "gemm_grouped": "src/repro/kernels/harness.py:257 (gemm_grouped; on one "
                    "device the expert vmap of dispatch.py:927-931)",
    "gemm_grouped_pop": "src/repro/kernels/harness.py:257 (gemm_grouped with "
                        "BINARY_POPCOUNT / TERNARY_POPCOUNT, bgemm.py:29 / tgemm.py:29; "
                        "on one device the expert vmap of dispatch.py:927-931)",
    "gemm_grouped_planes": "src/repro/kernels/harness.py:257 (gemm_grouped with "
                           "PLANES_W4_I8A / PLANES_W8_I8A, pgemm.py:39 _planes_step, "
                           ":61, :62; on one device the expert vmap of "
                           "dispatch.py:927-931)",
    "gemm_grouped_mxu": "src/repro/kernels/harness.py:257 (gemm_grouped with "
                        "BINARY_MXU / TERNARY_MXU, bgemm.py:50 / tgemm.py:56 _mxu_step; "
                        "on one device the expert vmap of dispatch.py:927-931)",
    "gemm_grouped_wt_i8a": "src/repro/kernels/harness.py:257 (gemm_grouped with "
                           "TERNARY_W_I8A, tgemm.py:70 _wt_i8a_step; on one device "
                           "the expert vmap of dispatch.py:927-931)",
}
SOURCE = {name: "src/repro_torch/kernels/csrc/gemm.cu" for name in REPLACES}
SOURCE["paged_flash_decode"] = "src/repro_torch/kernels/csrc/paged_attn.cu"
SOURCE["flash_attention"] = "src/repro_torch/kernels/csrc/flash_attn.cu"
ATTENTION_KERNELS = ("paged_flash_decode", "flash_attention")
#: mxu body -> the popcount body whose accumulator it must equal
MXU_TWIN = {"bgemm_mxu": "bgemm_popcount", "tgemm_mxu": "tgemm_popcount"}
TWINNED = set(MXU_TWIN) | set(MXU_TWIN.values())
#: bodies checked and timed at MXU_ROWS: K7, its popcount twins, and K8 on
#: each side of its switch from the streaming to the tensor-core kernel
SWITCH_CHECKED = TWINNED | {"tgemm_wt_i8a"}
#: layers of one decode tick that run each mixed body (het's assignment)
TICK_LAYERS = {"tgemm_wt_i8a": ("out", "down"), "i4gemm_w4a8": ("up",)}
#: shapes checked for a body beyond its tick's: w4a8 runs K9 on every body
#: projection
CHECK_LAYERS = {"i4gemm_w4a8": ("qkv", "out", "up", "down")}


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int, flush: torch.Tensor | None = None,
            spin: int = SPIN_CYCLES) -> float:
    """Mean device time of fn() over `iters` launches (CUDA events), after
    one warm-up. With `flush`, a buffer larger than the 50 MB L2 is read
    before every launch, outside the timed span, so each launch finds its
    operands cold, as in a decode tick, where the other 27 layers' weights
    pass through L2 between two uses of a layer's. (Reading, not writing:
    a written buffer leaves dirty lines whose write-back would be charged
    to the timed launch.) A spin of `spin` device cycles (~0.1 ms by
    default) before the start event keeps the device behind the host, so
    the span holds fn()'s device time and not the host's time to issue
    it; fn() that issues many launches needs a longer one."""
    fn()
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for s, e in zip(starts, ends):
        if flush is not None:
            flush.sum()
        torch.cuda._sleep(spin)
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / iters


# -- phase 1 -----------------------------------------------------------------

def phase_device() -> str:
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    line = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{name}; {torch.cuda.device_count()} device(s)")
    log(line if line else f"nvidia-smi failed: {smi.stderr.strip()}")
    return name


# -- phase 2 -----------------------------------------------------------------

#: (library, kernel whose SASS must hold tensor-core instructions, opcodes)
TENSOR_CORE_KERNELS = [("flash_attn", "flash_mma_kernel", ("HMMA", "HGMMA")),   # K6
                       ("gemm", "i8_mma_kernel", ("IMMA", "IGMMA")),            # K1, K11
                       ("gemm", "s4_mma_kernel", ("IMMA", "IGMMA")),            # K9, K11
                       ("gemm", "planes_mma_kernel", ("IMMA", "IGMMA")),        # K10
                       ("gemm", "bmxu_mma_kernel", ("IMMA", "IGMMA")),          # K7, grouped
                       ("gemm", "tmxu_mma_kernel", ("IMMA", "IGMMA")),          # K7, grouped
                       ("gemm", "wt_mma_kernel", ("IMMA", "IGMMA")),            # K8, grouped
                       # K3, K4, ungrouped and grouped (every row tile): b1
                       # products on the tensor cores (BMMA), not emulated by
                       # a run of LOP3 / POPC
                       ("gemm", "pop_mma_kernel", ("BMMA", "BGMMA"))]
#: instantiations that must not spill: K5's (G, dh) of llama3.2-3b and
#: deepseek-moe-16b, as in `paged_decode_kernel<QT, KVT, G, dh>`, every
#: instantiation of K3's and K4's kernels, which llama3.2-3b's binary and
#: ternary ticks run (MS = 4 and 8 rows; NP = 1 and 2 planes) and the MoE
#: binary and ternary ticks the 16-row b1 tiles of (`pop_mma_kernel<NP,
#: BM>`), and K7's and K8's 16-row tiles, which the MoE decode ticks run
#: (BM = 16)
NO_SPILL = {"paged_decode_kernel": ("Li3ELi128E", "Li1ELi128E"),
            "bpop_stream_kernel": ("Li4E", "Li8E"), "tpop_stream_kernel": ("Li4E", "Li8E"),
            "pop_mma_kernel": ("Li1ELi16E", "Li2ELi16E", "Li1ELi64E", "Li2ELi64E"),
            "bmxu_mma_kernel": ("Li16E",),
            "tmxu_mma_kernel": ("Li16E",), "wt_mma_kernel": ("Li16E",)}


def ptxas_report(name: str, text: str) -> dict:
    """One line per compiled kernel: its registers, shared memory and
    spills, from the -Xptxas -v log; returns kernel -> its spill line."""
    fn, parts, spills = None, {}, {}
    for line in text.splitlines():
        hit = re.search(r"Compiling entry function '(\S+)'", line)
        if hit:
            fn, parts = hit.group(1), {}
        elif fn and "Used" in line and "registers" in line:
            parts["used"] = line.split(":", 1)[1].strip()
        elif fn and "spill" in line:
            parts["spill"] = line.strip()
        if fn and len(parts) == 2:
            log(f"[build] {name} {fn[:90]}: {parts['used']}; {parts['spill']}")
            spills[fn] = parts["spill"]
            fn = None
    return spills


def check_spills(spills: dict) -> None:
    """Fails if a NO_SPILL instantiation spills (or was not compiled)."""
    for kernel, shapes in NO_SPILL.items():
        for shape in shapes:
            hits = {f: s for f, s in spills.items() if kernel in f and shape in f}
            if not hits:
                raise RuntimeError(f"no {kernel} instantiation {shape} in the build log")
            for f, line in hits.items():
                if re.search(r"[1-9]\d* bytes spill", line):
                    raise RuntimeError(f"{f}: spills ({line})")
            log(f"[build] {kernel} {shape}: {len(hits)} instantiations, no spill")


def sass_tensor_cores() -> None:
    """cuobjdump -sass (the toolkit's, beside nvcc) of the built libraries:
    K6's bf16 kernel must hold HMMA (or HGMMA), the tensor-core kernels of
    K1, K7, K8, K9 and K10 IMMA (or IGMMA) and K3's and K4's b1 tile
    (`pop_mma_kernel`, ungrouped and grouped) BMMA (or BGMMA) instructions
    (each instantiation: the row tiles of K1, K7, K8, K9 and K10, K10's bit
    widths, K3's and K4's planes and row tiles)."""
    from repro_torch.kernels import build
    tool = Path(build._nvcc()).parent / "cuobjdump"
    if not tool.exists():
        raise RuntimeError(f"{tool} not found")
    sass_of = {}
    for lib, kernel, ops in TENSOR_CORE_KERNELS:
        if lib not in sass_of:
            sass_of[lib] = subprocess.run(
                [str(tool), "-sass", str(build.lib_path(lib))], capture_output=True,
                text=True, timeout=300, check=True).stdout
        sass = sass_of[lib]
        funcs = [f for f in re.split(r"\n\s*Function : ", sass)[1:]
                 if kernel in f.split("\n", 1)[0]]
        if not funcs:
            raise RuntimeError(f"no {kernel} in the SASS of lib{lib}")
        for f in funcs:
            n = sum(1 for line in f.splitlines()
                    if any(re.search(rf"\b{op}\b", line) for op in ops))
            name = f.split("\n", 1)[0].strip()
            if n == 0:
                raise RuntimeError(f"{name}: no {'/'.join(ops)} instruction in its SASS")
            log(f"[build] SASS {name[:90]}: {n} {'/'.join(ops)} instructions")


def phase_build() -> None:
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    logs = build.build_all()
    log(f"[build] nvcc {' '.join(build.NVCC_FLAGS)}: "
        f"{len(logs)} libraries in {time.perf_counter() - t0:.1f}s")
    spills = {}
    for name, text in logs.items():
        spills.update(ptxas_report(name, text))
    check_spills(spills)
    sass_tensor_cores()


# -- phase 3 -----------------------------------------------------------------

def gemm_shapes(cfg):
    """(name, N, K, count per decode tick) of the serve path's GEMMs."""
    h, hk, dh, d, f = (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model,
                       cfg.d_ff)
    n = cfg.n_layers
    return [("qkv", (h + 2 * hk) * dh, d, n), ("out", d, h * dh, n),
            ("up", 2 * f, d, n), ("down", d, f, n), ("lm_head", cfg.vocab, d, 1)]


def gemm_operands(body, m, n, k, gen):
    """Random operands of `body` on the card: int8 codes, or int32 words with
    every bit pattern (sign bit included), each side at its own density."""
    dev = "cuda"

    def side(shape, per_unit, n_ops):
        if per_unit == 1:
            return tuple(torch.randint(-127, 128, shape, dtype=torch.int8,
                                       device=dev, generator=gen)
                         for _ in range(n_ops))
        return tuple(torch.randint(-2 ** 31, 2 ** 31 - 1, shape, dtype=torch.int32,
                                   device=dev, generator=gen) for _ in range(n_ops))

    x_ops = side((m, k // body.xk), body.xk, body.n_x)
    w_ops = side((k // body.wk, n) if body.w_kmajor else (n, k // body.wk),
                 body.wk, body.n_w)
    w_scale = torch.rand(n, device=dev, generator=gen) * 0.1 + 1e-3
    a_scale = torch.rand(m, device=dev, generator=gen) + 0.1
    bias = torch.randn(n, device=dev, generator=gen)
    return x_ops, w_ops, w_scale, a_scale, bias


def unpacked_i8(body, x_ops, w_ops, k):
    """The int8 operands a library int8 GEMM would take for the same dot:
    (M, K) activation codes and K-major (K, N) weight codes."""
    from repro_torch.core import pack
    x, w = x_ops, w_ops
    if body.xk == 1:
        xi = x[0]
    elif body.n_x == 2:
        xi = pack.unpack_ternary_i8(x[0], x[1], k)
    else:
        xi = pack.unpack_pm1_i8(x[0], k)
    if body.w_kmajor:
        wi = w[0]
    elif body.wk == pack.NIBBLES:
        wi = pack.unpack_int4_i8(w[0], k).T.contiguous()
    elif body.n_w == 2:
        wi = pack.unpack_ternary_i8(w[0], w[1], k).T.contiguous()
    else:
        wi = pack.unpack_pm1_i8(w[0], k).T.contiguous()
    return xi.contiguous(), wi


def member_codes(body, x_ops, w_ops, k) -> list:
    """unpacked_i8 of each member of grouped operands."""
    return [unpacked_i8(body, [t[i] for t in x_ops], [t[i] for t in w_ops], k)
            for i in range(x_ops[0].shape[0])]


def bf16_mm_ms(x, w, flush, iters=20) -> float:
    """Device ms of one `torch.mm` (or, on a leading group axis,
    `torch.bmm`) in bf16 on int8 codes x (.., M, K) and w (.., K, N): exact
    products and f32 sums, so the same dot as long as |dot| < 2^24, reading
    the codes at 2 bytes each."""
    xb, wb = x.to(torch.bfloat16), w.to(torch.bfloat16)
    fn = torch.bmm if x.ndim == 3 else torch.mm
    return time_ms(lambda: fn(xb, wb), iters, flush)


def int_mm_per_expert(codes, flush) -> float:
    """Device ms of `torch._int_mm` once per member (M > 16) on `codes`."""
    return time_ms(lambda: [torch._int_mm(a, w) for a, w in codes], 10, flush,
                   spin=LIST_SPIN_CYCLES)


def check_gemm(body, cfg, flush, gen, accs) -> dict:
    """Kernel vs plain at every serve GEMM shape the body runs (its tick's,
    TICK_LAYERS, and CHECK_LAYERS), at M = SLOTS (decode) and at both
    prefill buckets (MXU_ROWS for K7, its twins and K8); returns the
    per-decode-tick record over its tick's layers, its library time one
    `torch.mm` in bf16 on the unpacked codes at M = SLOTS (`torch._int_mm`
    needs M > 16; it is timed above 16 rows). `accs` collects each shape's
    int32 accumulator, so that an mxu body can be held against its popcount
    twin on the same operands (same seed). K1's and K9's decode ticks are
    also timed back to back."""
    from repro_torch.kernels import harness, i4gemm, i8gemm
    tick = {"ms": 0.0, "plain_ms": 0.0, "bytes": 0.0, "ops": 0.0, "lib": 0.0}
    layers = TICK_LAYERS.get(body.name)
    checked = CHECK_LAYERS.get(body.name, layers)
    for m in MXU_ROWS if body.name in SWITCH_CHECKED else GEMM_ROWS:
        for si, (name, n, k, per_tick) in enumerate(gemm_shapes(cfg)):
            if checked is not None and name not in checked:
                continue
            gen.manual_seed(1000 * m + si)   # an mxu body meets its twin's operands
            x_ops, w_ops, ws, as_, bias = gemm_operands(body, m, n, k, gen)
            for out, b in (("acc", None), ("requant", None), ("requant", bias)):
                sc = (None, None) if out == "acc" else (ws, as_)
                got = harness.gemm(body, x_ops, w_ops, *sc, b, k=k, out=out)
                want = body.plain(x_ops, w_ops, k)
                if out == "requant":
                    want = harness.requant(want, *sc, b).to(torch.bfloat16)
                    same = torch.equal(got.view(torch.int16), want.view(torch.int16))
                else:
                    same = torch.equal(got, want)
                    twin = accs.get((MXU_TWIN.get(body.name), m, name))
                    if twin is not None and not torch.equal(got, twin):
                        raise AssertionError(f"{body.name} {name} M={m}: mxu "
                                             f"accumulator != popcount accumulator")
                    accs[(body.name, m, name)] = got
                if not same:
                    err = (got.float() - want.float()).abs().max().item()
                    raise AssertionError(f"{body.name} {name} M={m} out={out} "
                                         f"bias={b is not None}: kernel != plain "
                                         f"(max abs diff {err})")

            def kern():
                harness.gemm(body, x_ops, w_ops, ws, as_, k=k)

            def plain():
                harness.requant(body.plain(x_ops, w_ops, k), ws, as_, None
                                ).to(torch.bfloat16)

            ms = time_ms(kern, 20, flush)
            pms = time_ms(plain, 2)
            nbytes = (sum(t.numel() * t.element_size() for t in x_ops + w_ops)
                      + 4 * (m + n) + 2 * m * n)
            ops = 2.0 * m * n * k
            bound = max(nbytes / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S) * 1e3
            lib = None
            if m > 16 or m == SLOTS:
                xi, wi = unpacked_i8(body, x_ops, w_ops, k)
                lib = (time_ms(lambda: torch._int_mm(xi, wi), 20, flush) if m > 16
                       else bf16_mm_ms(xi, wi, flush))
                del xi, wi
            log(f"[kernels] {body.name:15s} {name:8s} M={m:3d} N={n:6d} K={k:5d} "
                f"bit-equal ok  kernel {ms:.4f} ms  plain {pms:.3f} ms  "
                f"bound {bound:.4f} ms ({'bytes' if nbytes / HBM_BYTES_PER_S >= ops / INT8_OPS_PER_S else 'operations'})"
                + (f"  torch._int_mm {lib:.4f} ms" if m > 16 else
                   f"  torch.mm bf16 on the unpacked codes {lib:.4f} ms" if lib else ""))
            if m == SLOTS and (layers is None or name in layers):
                tick["ms"] += per_tick * ms
                tick["plain_ms"] += per_tick * pms
                tick["bytes"] += per_tick * nbytes
                tick["ops"] += per_tick * ops
                tick["lib"] += per_tick * lib
    t_bytes = tick["bytes"] / HBM_BYTES_PER_S
    t_ops = tick["ops"] / INT8_OPS_PER_S
    log(f"[kernels] {body.name} {SLOTS}-slot decode tick ({'+'.join(layers or ('all',))}"
        f" layers), sum of launches timed one by one: {tick['ms']:.3f} ms (bound "
        f"{max(t_bytes, t_ops) * 1e3:.4f}; torch.mm bf16 {tick['lib']:.3f})")
    if body in (i8gemm.I8_DOT, i4gemm.INT4_W_I8A):
        seq = tick_in_sequence(body, cfg, flush, gen)[None]
        log(f"[kernels] {body.name} {SLOTS}-slot decode tick "
            f"({'every layer and lm_head' if body is i8gemm.I8_DOT else 'w4a8: 26 body layers'}"
            f"), its launches back to back over distinct per-layer weights: {seq:.3f} ms")
    return {"name": body.name, "max_abs_err": 0.0, "ms": tick["ms"],
            "plain_ms": tick["plain_ms"], "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": tick["lib"]}


def moe_gemm_shapes(cfg):
    """(name, G, N, K) of an MoE arch's two expert projections."""
    up = 2 * cfg.d_ff if cfg.gated_ffn else cfg.d_ff
    return [("up", cfg.n_experts, up, cfg.d_model),
            ("down", cfg.n_experts, cfg.d_model, cfg.d_ff)]


def grouped_plain(body, x_ops, w_ops, ws, as_, bias, k, out="requant"):
    """The plain version of the grouped GEMM, member by member, on the
    card: the body's plain dot, then `harness.requant`."""
    from repro_torch.kernels import harness
    ys = []
    for i in range(x_ops[0].shape[0]):
        dot = body.plain([t[i] for t in x_ops], [t[i] for t in w_ops], k)
        ys.append(dot if out == "acc" else harness.requant(
            dot, ws[i], as_[i], None if bias is None else bias[i]).to(torch.bfloat16))
    return torch.stack(ys)


def grouped_stack(body, g, m, n, k, gen):
    """Operands of `body` with a leading group axis of g on the card: the
    members of `gemm_operands`, stacked."""
    parts = [gemm_operands(body, m, n, k, gen) for _ in range(g)]
    x_ops = tuple(torch.stack([p[0][j] for p in parts]) for j in range(body.n_x))
    w_ops = tuple(torch.stack([p[1][j] for p in parts]) for j in range(body.n_w))
    ws, as_, bias = (torch.stack([p[j] for p in parts]) for j in (2, 3, 4))
    return x_ops, w_ops, ws, as_, bias


def grouped_bit_equal(label, body, x_ops, w_ops, ws, as_, bias, k):
    """One grouped launch == its plain version == G ungrouped launches of
    `body`: int32 accumulator, and bf16 output with bias off and on.
    Returns the accumulator."""
    from repro_torch.kernels import harness
    g = x_ops[0].shape[0]
    acc = harness.gemm_grouped(body, x_ops, w_ops, None, None, k=k, out="acc")
    dot = grouped_plain(body, x_ops, w_ops, None, None, None, k, "acc")
    if not torch.equal(acc, dot):
        raise AssertionError(f"{label}: accumulator != plain")
    members = [([t[i] for t in x_ops], [t[i] for t in w_ops]) for i in range(g)]
    for i, (xi, wi) in enumerate(members):
        if not torch.equal(acc[i], harness.gemm(body, xi, wi, None, None, k=k,
                                                out="acc")):
            raise AssertionError(f"{label}: group {i} != ungrouped")
    for b in (None, bias):
        got = harness.gemm_grouped(body, x_ops, w_ops, ws, as_, b, k=k)
        want = torch.stack([harness.requant(dot[i], ws[i], as_[i],
                                            None if b is None else b[i]
                                            ).to(torch.bfloat16) for i in range(g)])
        loop = torch.stack([harness.gemm(body, xi, wi, ws[i], as_[i],
                                         None if b is None else b[i], k=k)
                            for i, (xi, wi) in enumerate(members)])
        if not (torch.equal(got.view(torch.int16), want.view(torch.int16))
                and torch.equal(got.view(torch.int16), loop.view(torch.int16))):
            raise AssertionError(f"{label} bias={b is not None}: kernel != plain / "
                                 f"ungrouped")
    return acc


def check_grouped(flush, gen) -> list:
    """The grouped forms on the tensor-core tile (GROUPED_FORMS) vs their
    plain version and vs G ungrouped launches of the same body, at the
    full-width expert shapes of deepseek-moe-16b and phi3.5-moe-42b-a6.6b,
    at M = 4, 16 and 128 rows per expert: K11's K9 (het's experts) and K1
    (int8's) bodies, grouped K7 (ternary and binary mxu, whose accumulators
    must also equal grouped K4's / K3's on the same operands) and grouped
    K8 (wt-a8's experts): int32 accumulator and bf16 output (bias on and
    off) bit-equal. Every shape is timed, at M = 128 beside
    `torch._int_mm` once per expert on the unpacked codes. Returns one
    record per form for a 4-slot deepseek-moe-16b decode tick of its first
    body: 28 layers x {up, down} at M = 16, one launch each; its library
    time is one `torch.bmm` over the experts in bf16 on the unpacked codes
    (exact products and f32 sums: the same dot, rounded to bf16)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import BODIES, harness
    by_name = {b.name: b for b in BODIES}
    ticks = {form: dict.fromkeys(("ms", "plain_ms", "bytes", "ops", "lib"), 0.0)
             for form in GROUPED_FORMS}
    for arch in MOE_ARCHS:
        cfg = get_config(arch)
        for name, g, n, k in moe_gemm_shapes(cfg):
            for form, bodies in GROUPED_FORMS.items():
                for body in (by_name[b] for b in bodies):
                    for m in GROUPED_ROWS:
                        gen.manual_seed(3000 * m + g + n + body.body_id)
                        x_ops, w_ops, ws, as_, bias = grouped_stack(body, g, m, n, k, gen)
                        label = f"{form} {body.name} {arch} {name} M={m}"
                        acc = grouped_bit_equal(label, body, x_ops, w_ops, ws, as_, bias, k)
                        twin = MXU_TWIN.get(body.name)
                        if twin is not None and not torch.equal(acc, harness.gemm_grouped(
                                by_name[twin], x_ops, w_ops, None, None, k=k, out="acc")):
                            raise AssertionError(f"{label}: accumulator != grouped {twin}")
                        ms = time_ms(lambda: harness.gemm_grouped(body, x_ops, w_ops, ws,
                                                                  as_, k=k), 10, flush)
                        nbytes = (sum(t.numel() * t.element_size() for t in x_ops + w_ops)
                                  + 4 * g * (m + n) + 2 * g * m * n)
                        ops = 2.0 * g * m * n * k
                        t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S
                        msg = (f"[kernels] {form} {body.name:12s} {arch} {name:4s} G={g} "
                               f"M={m:3d} N={n:5d} K={k}: bit-equal to plain and to {g} "
                               f"ungrouped launches" + (f", == grouped {twin}" if twin else "")
                               + f"  kernel {ms:.4f} ms  bound {max(t_b, t_o) * 1e3:.4f} ms "
                               f"({'bytes' if t_b >= t_o else 'operations'})")
                        if m == TICK_ROWS:
                            pms = time_ms(lambda: grouped_plain(body, x_ops, w_ops, ws,
                                                                as_, None, k), 1)
                            msg += f"  plain {pms:.2f} ms"
                            if arch == MOE_ARCHS[0] and body.name == bodies[0]:
                                cs = member_codes(body, x_ops, w_ops, k)
                                lib = bf16_mm_ms(torch.stack([c[0] for c in cs]),
                                                 torch.stack([c[1] for c in cs]), flush, 10)
                                msg += f"  torch.bmm bf16 on the unpacked codes {lib:.4f} ms"
                                del cs
                                t = ticks[form]
                                for key, v in (("ms", ms), ("plain_ms", pms),
                                               ("bytes", nbytes), ("ops", ops), ("lib", lib)):
                                    t[key] += cfg.n_layers * v
                        if m == LIB_ROWS:
                            lib = int_mm_per_expert(member_codes(body, x_ops, w_ops, k), flush)
                            msg += f"  torch._int_mm x {g} experts {lib:.4f} ms"
                        log(msg)
                        del x_ops, w_ops, ws, as_, bias, acc
                        torch.cuda.empty_cache()
    recs = []
    for form, t in ticks.items():
        t_b, t_o = t["bytes"] / HBM_BYTES_PER_S, t["ops"] / INT8_OPS_PER_S
        log(f"[kernels] {form} {GROUPED_FORMS[form][0]} deepseek-moe-16b {SLOTS}-slot "
            f"decode tick (28 x {{up, down}}, M={TICK_ROWS}): {t['ms']:.3f} ms (plain "
            f"{t['plain_ms']:.1f} ms, bound {max(t_b, t_o) * 1e3:.4f} ms, "
            f"{'bytes' if t_b >= t_o else 'operations'}; torch.bmm bf16 {t['lib']:.3f} ms)")
        recs.append({"name": form, "max_abs_err": 0.0, "ms": t["ms"],
                     "plain_ms": t["plain_ms"], "bound_ms": max(t_b, t_o) * 1e3,
                     "bound_by": "bytes" if t_b >= t_o else "operations",
                     "library_ms": t["lib"]})
    return recs


def check_grouped_planes(flush, gen) -> dict:
    """K10 over expert stacks (the plane bodies grouped) vs its plain
    version and vs G ungrouped K10 launches, at the full-width expert shapes
    of deepseek-moe-16b and phi3.5-moe-42b-a6.6b, M = 4, 16 and 128 rows an
    expert, P = 1 and bits live planes (the leading-P view of the full
    stack, read in place): int32 accumulator and bf16 output (bias on and
    off) bit-equal; at P = bits the accumulator equals K11's int4 / int8
    body on the composed codes. Each shape timed at both depths; at M = 128
    `torch._int_mm` once per expert on the composed codes beside it.
    Returns the record of a 4-slot deepseek-moe-16b het decode tick under
    `--impl planes` at P = 4: 28 layers x {up, down} at M = 16 on the int4
    stacks, one launch each (the P = 1 draft's tick logged beside it); its
    library time one `torch.bmm` over the experts in bf16 on the composed
    codes (`torch._int_mm` needs M > 16)."""
    from repro_torch.configs import get_config
    from repro_torch.core import pack
    from repro_torch.kernels import harness, i4gemm, i8gemm, pgemm
    tick = {"ms": {1: 0.0, 4: 0.0}, "bytes": {1: 0.0, 4: 0.0}, "plain_ms": 0.0,
            "ops": 0.0, "lib": 0.0}
    for arch in MOE_ARCHS:
        cfg = get_config(arch)
        for name, g, n, k in moe_gemm_shapes(cfg):
            for body, direct in ((pgemm.PLANES_W4_I8A, i4gemm.INT4_W_I8A),
                                 (pgemm.PLANES_W8_I8A, i8gemm.I8_DOT)):
                bits = body.w_stack
                for m in GROUPED_ROWS:
                    gen.manual_seed(4000 * m + g + n + bits)
                    x = torch.randint(-127, 128, (g, m, k), dtype=torch.int8,
                                      device="cuda", generator=gen)
                    stack = torch.randint(-2 ** 31, 2 ** 31 - 1, (g, bits, n, k // 32),
                                          dtype=torch.int32, device="cuda",
                                          generator=gen)
                    ws = torch.rand(g, n, device="cuda", generator=gen) * 0.1 + 1e-3
                    as_ = torch.rand(g, m, device="cuda", generator=gen) + 0.1
                    bias = torch.randn(g, n, device="cuda", generator=gen)
                    label = f"K10 grouped {body.name} {arch} {name} M={m}"
                    ms, nbytes = {}, {}
                    for p in (1, bits):
                        w = (stack[:, :p],)
                        acc = grouped_bit_equal(f"{label} P={p}", body, (x,), w, ws,
                                                as_, bias, k)
                        ms[p] = time_ms(lambda: harness.gemm_grouped(
                            body, (x,), w, ws, as_, k=k), 10, flush)
                        nbytes[p] = (g * m * k + g * p * n * (k // 32) * 4
                                     + 4 * g * (m + n) + 2 * g * m * n)
                    codes = torch.stack([composed_codes(stack[i], k, bits)
                                         for i in range(g)])          # (g, n, k)
                    wd = (codes.transpose(-1, -2).contiguous() if bits == 8
                          else pack.pack_int4(codes))
                    if not torch.equal(acc, harness.gemm_grouped(
                            direct, (x,), (wd,), None, None, k=k, out="acc")):
                        raise AssertionError(f"{label}: P = {bits} accumulator != "
                                             f"{direct.name} grouped accumulator")
                    del wd
                    ops = 2.0 * g * m * n * k
                    bound = {p: max(b / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S) * 1e3
                             for p, b in nbytes.items()}
                    msg = (f"[kernels] gemm_grouped_planes {body.name} {arch} {name:4s} "
                           f"G={g} M={m:3d} N={n:5d} K={k}: bit-equal to plain and to "
                           f"{g} ungrouped launches at P in (1, {bits}), P={bits} == "
                           f"{direct.name}  kernel "
                           + " / ".join(f"P={p} {t:.4f}" for p, t in ms.items())
                           + " ms  bound " + " / ".join(f"P={p} {t:.4f}"
                                                        for p, t in bound.items())
                           + " ms")
                    if m == TICK_ROWS:
                        full = (stack,)
                        pms = time_ms(lambda: grouped_plain(body, (x,), full, ws, as_,
                                                            None, k), 1)
                        msg += f"  plain {pms:.2f} ms"
                        if arch == MOE_ARCHS[0] and bits == 4:
                            lib = bf16_mm_ms(x, codes.transpose(-1, -2), flush, 10)
                            msg += f"  torch.bmm bf16 on the composed codes {lib:.4f} ms"
                            n_l = cfg.n_layers
                            for p in (1, 4):
                                tick["ms"][p] += n_l * ms[p]
                                tick["bytes"][p] += n_l * nbytes[p]
                            tick["plain_ms"] += n_l * pms
                            tick["ops"] += n_l * ops
                            tick["lib"] += n_l * lib
                    if m == LIB_ROWS:
                        lib = int_mm_per_expert([(a, c.T.contiguous())
                                                 for a, c in zip(x, codes)], flush)
                        msg += f"  torch._int_mm x {g} experts {lib:.4f} ms"
                    log(msg)
                    del x, stack, codes, acc
                    torch.cuda.empty_cache()
    t_o = tick["ops"] / INT8_OPS_PER_S
    bounds = {p: max(tick["bytes"][p] / HBM_BYTES_PER_S, t_o) * 1e3 for p in (1, 4)}
    log(f"[kernels] gemm_grouped_planes deepseek-moe-16b het {SLOTS}-slot decode tick "
        f"(28 x {{up, down}}, M={TICK_ROWS}): P=4 {tick['ms'][4]:.3f} ms (bound "
        f"{bounds[4]:.4f}), P=1 {tick['ms'][1]:.3f} ms (bound {bounds[1]:.4f}); "
        f"P=1 / P=4 = {tick['ms'][1] / tick['ms'][4]:.3f}; torch.bmm bf16 "
        f"{tick['lib']:.3f} ms")
    t_b = tick["bytes"][4] / HBM_BYTES_PER_S
    return {"name": "gemm_grouped_planes", "max_abs_err": 0.0, "ms": tick["ms"][4],
            "plain_ms": tick["plain_ms"], "bound_ms": bounds[4],
            "bound_by": "bytes" if t_b >= t_o else "operations",
            "library_ms": tick["lib"]}


def check_grouped_popcount(flush, gen) -> dict:
    """Grouped K3 and K4 on the b1 tile (`pop_mma_kernel`, 16 rows up to
    G_SMALL_M, 64 above), which MoE runs under binary, ternary or mixed
    reach: at the deepseek-moe-16b expert shapes (G = 64) and M = 4, 16
    (the 4-slot decode tick) and 128 rows an expert, bit-equal to the plain
    version and to G ungrouped launches, each timed beside the grouped K7
    tile on the same operands (its accumulators equal theirs); at M = 16
    beside one `torch.bmm` in bf16 on the unpacked codes, at M = 128 beside
    `torch._int_mm` once per expert on them. Logs the 4-slot tick (28 x
    {up, down}) of each beside its bound and K7's. Returns the record of
    K4's tick (the served ternary policy's experts), its library time the
    `torch.bmm`'s."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import BODIES, harness
    by_name = {b.name: b for b in BODIES}
    cfg = get_config(MOE_ARCHS[0])
    rec = None
    for twin, pop in MXU_TWIN.items():
        body, mxu = by_name[pop], by_name[twin]
        tick_ms, tick_mxu, tick_pms, tick_b, tick_o, tick_lib = (0.0,) * 6
        for name, g, n, k in moe_gemm_shapes(cfg):
            for m in GROUPED_ROWS:
                gen.manual_seed(5000 + m + g + n + body.body_id)
                x_ops, w_ops, ws, as_, bias = grouped_stack(body, g, m, n, k, gen)
                label = f"pop_mma_kernel grouped {body.name} {name} M={m}"
                acc = grouped_bit_equal(label, body, x_ops, w_ops, ws, as_, bias, k)
                if not torch.equal(acc, harness.gemm_grouped(mxu, x_ops, w_ops, None, None,
                                                             k=k, out="acc")):
                    raise AssertionError(f"{label}: accumulator != grouped {mxu.name}")
                ms = time_ms(lambda: harness.gemm_grouped(body, x_ops, w_ops, ws, as_, k=k),
                             10, flush)
                mms = time_ms(lambda: harness.gemm_grouped(mxu, x_ops, w_ops, ws, as_, k=k),
                              10, flush)
                nbytes = (sum(t.numel() * t.element_size() for t in x_ops + w_ops)
                          + 4 * g * (m + n) + 2 * g * m * n)
                ops = 2.0 * g * m * n * k
                msg = (f"[kernels] gemm_grouped_pop {body.name:15s} {name:4s} G={g} "
                       f"M={m:3d} N={n} K={k}: bit-equal to plain and to {g} ungrouped "
                       f"launches, == grouped {mxu.name}  kernel {ms:.4f} ms  grouped "
                       f"{mxu.name} (int8 tile) {mms:.4f} ms  bound "
                       f"{max(nbytes / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S) * 1e3:.4f} ms")
                if m == TICK_ROWS:
                    pms = time_ms(lambda: grouped_plain(body, x_ops, w_ops, ws, as_, None, k),
                                  1)
                    cs = member_codes(body, x_ops, w_ops, k)
                    lib = bf16_mm_ms(torch.stack([c[0] for c in cs]),
                                     torch.stack([c[1] for c in cs]), flush, 10)
                    msg += f"  plain {pms:.2f} ms  torch.bmm bf16 on the unpacked codes {lib:.4f} ms"
                    del cs
                    tick_lib += cfg.n_layers * lib
                    tick_ms += cfg.n_layers * ms
                    tick_mxu += cfg.n_layers * mms
                    tick_pms += cfg.n_layers * pms
                    tick_b += cfg.n_layers * nbytes
                    tick_o += cfg.n_layers * ops
                elif m == LIB_ROWS:
                    lib = int_mm_per_expert(member_codes(body, x_ops, w_ops, k), flush)
                    msg += f"  torch._int_mm x {g} experts {lib:.4f} ms"
                log(msg)
                del x_ops, w_ops, ws, as_, bias, acc
                torch.cuda.empty_cache()
        t_b, t_o = tick_b / HBM_BYTES_PER_S, tick_o / INT8_OPS_PER_S
        log(f"[kernels] gemm_grouped_pop {body.name} deepseek-moe-16b "
            f"{SLOTS}-slot decode tick (28 x {{up, down}}): {tick_ms:.3f} ms (plain "
            f"{tick_pms:.1f} ms, bound {max(t_b, t_o) * 1e3:.4f} ms, "
            f"{'bytes' if t_b >= t_o else 'operations'}; torch.bmm bf16 {tick_lib:.3f} "
            f"ms); grouped {mxu.name} on the same operands {tick_mxu:.3f} ms")
        if pop != "tgemm_popcount":
            continue
        rec = {"name": "gemm_grouped_pop", "max_abs_err": 0.0, "ms": tick_ms,
               "plain_ms": tick_pms, "bound_ms": max(t_b, t_o) * 1e3,
               "bound_by": "bytes" if t_b >= t_o else "operations",
               "library_ms": tick_lib}
    return rec


def composed_codes(stack, k, bits, chunk=8192):
    """(N, K) int8 codes of a full plane stack, N rows at a time."""
    from repro_torch.core import pack
    n = stack.shape[1]
    return torch.cat([pack.unpack_planes_i8(stack[:, a:a + chunk], k, bits)
                      for a in range(0, n, chunk)])


def check_planes(body, cfg, flush, gen) -> dict:
    """K10 vs its plain version at every serve GEMM shape, at PLANE_ROWS (the
    streaming kernel up to 8 rows, the tensor-core kernel above), at P = 1,
    2 and bits live planes (int32 accumulator and bf16 output bit-equal,
    bias on and off); at P = bits the accumulator must also equal the direct
    body's (int8: K1, int4: K9) on the composed codes. Every (shape, M, P) is
    timed, and above 16 rows `torch._int_mm` (which needs M > 16) on the
    composed codes beside it, at M = SLOTS one `torch.mm` in bf16 on them.
    Logs the decode tick at each P and returns the per-decode-tick record
    at P = bits (its library time the bf16 `torch.mm`'s): the int8 body runs
    every layer of an int8 `--impl planes` tick, the int4 body w4a8's 26
    body layers."""
    from repro_torch.core import pack
    from repro_torch.kernels import harness, i4gemm, i8gemm
    bits = body.w_stack
    direct = i8gemm.I8_DOT if bits == 8 else i4gemm.INT4_W_I8A
    depths = PLANE_DEPTHS + (bits,)
    tick = {"ms": dict.fromkeys(depths, 0.0), "bytes": dict.fromkeys(depths, 0.0),
            "plain_ms": 0.0, "ops": 0.0, "lib": 0.0}
    for m in PLANE_ROWS:
        for si, (name, n, k, per_tick) in enumerate(gemm_shapes(cfg)):
            if bits == 4:
                per_tick = 0 if name == "lm_head" else per_tick - 2
            gen.manual_seed(2000 * m + si)
            x = torch.randint(-127, 128, (m, k), dtype=torch.int8, device="cuda",
                              generator=gen)
            stack = torch.randint(-2 ** 31, 2 ** 31 - 1, (bits, n, k // 32),
                                  dtype=torch.int32, device="cuda", generator=gen)
            ws = torch.rand(n, device="cuda", generator=gen) * 0.1 + 1e-3
            as_ = torch.rand(m, device="cuda", generator=gen) + 0.1
            bias = torch.randn(n, device="cuda", generator=gen)
            ms = {}
            for p in depths:
                w = (stack[:p],)
                dot = body.plain((x,), w, k)
                acc = harness.gemm(body, (x,), w, None, None, k=k, out="acc")
                if not torch.equal(acc, dot):
                    raise AssertionError(f"{body.name} {name} M={m} P={p}: kernel "
                                         f"accumulator != plain")
                for b in (None, bias):
                    got = harness.gemm(body, (x,), w, ws, as_, b, k=k)
                    want = harness.requant(dot, ws, as_, b).to(torch.bfloat16)
                    if not torch.equal(got.view(torch.int16), want.view(torch.int16)):
                        raise AssertionError(f"{body.name} {name} M={m} P={p} bias="
                                             f"{b is not None}: kernel != plain")
                ms[p] = time_ms(lambda: harness.gemm(body, (x,), w, ws, as_, k=k),
                                20, flush)
            codes = composed_codes(stack, k, bits)
            wd = codes.T.contiguous() if bits == 8 else pack.pack_int4(codes)
            if not torch.equal(acc, harness.gemm(direct, (x,), (wd,), None, None,
                                                 k=k, out="acc")):
                raise AssertionError(f"{body.name} {name} M={m}: P = {bits} "
                                     f"accumulator != {direct.name} accumulator")
            del wd

            def nbytes(p):
                return m * k + p * n * (k // 32) * 4 + 4 * (m + n) + 2 * m * n

            ops = 2.0 * m * n * k
            bound = max(nbytes(bits) / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S) * 1e3
            msg = (f"[kernels] {body.name} {name:8s} M={m:3d} N={n:6d} K={k:5d} "
                   f"P in {depths}: bit-equal ok, P={bits} == {direct.name}  kernel "
                   + " / ".join(f"P={p} {t:.4f}" for p, t in ms.items()) + " ms")
            if m == SLOTS:
                pms = time_ms(lambda: harness.requant(body.plain((x,), (stack,), k),
                                                      ws, as_, None).to(torch.bfloat16), 2)
                lib = bf16_mm_ms(x, codes.T, flush)
                msg += f"  plain {pms:.3f} ms  torch.mm bf16 on the composed codes {lib:.4f} ms"
                for p in depths:
                    tick["ms"][p] += per_tick * ms[p]
                    tick["bytes"][p] += per_tick * nbytes(p)
                tick["plain_ms"] += per_tick * pms
                tick["ops"] += per_tick * ops
                tick["lib"] += per_tick * lib
            elif m > 16:
                wi = codes.T.contiguous()
                lib = time_ms(lambda: torch._int_mm(x, wi), 20, flush)
                msg += f"  torch._int_mm {lib:.4f} ms"
                del wi
            log(msg + f"  bound {bound:.4f} ms")
            del codes, stack
    t_ops = tick["ops"] / INT8_OPS_PER_S
    bounds = {p: max(tick["bytes"][p] / HBM_BYTES_PER_S, t_ops) * 1e3 for p in depths}
    log(f"[kernels] {body.name} {SLOTS}-slot decode tick, sum of launches timed one "
        f"by one: " + "; ".join(f"P={p} {tick['ms'][p]:.3f} ms (bound {bounds[p]:.4f})"
                                for p in depths)
        + f"; P=1 / P={bits} = {tick['ms'][1] / tick['ms'][bits]:.3f}; torch.mm bf16 "
        f"{tick['lib']:.3f} ms")
    seq = tick_in_sequence(body, cfg, flush, gen, depths)
    log(f"[kernels] {body.name} {SLOTS}-slot decode tick, its launches back to back "
        f"over distinct per-layer weights: "
        + "; ".join(f"P={p} {t:.3f} ms" for p, t in seq.items())
        + f"; P=1 / P={bits} = {seq[1] / seq[bits]:.3f}")
    t_bytes = tick["bytes"][bits] / HBM_BYTES_PER_S
    return {"name": body.name, "max_abs_err": 0.0, "ms": tick["ms"][bits],
            "plain_ms": tick["plain_ms"], "bound_ms": bounds[bits],
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": tick["lib"]}


def tick_in_sequence(body, cfg, flush, gen, depths=(None,)) -> dict:
    """depth -> device ms of one 4-slot decode tick's GEMMs of `body`
    launched back to back, as a tick issues them: per layer qkv, out, up,
    down on that layer's own random weights (so each launch finds its
    weights cold, the whole model's 3.2 GB at 8 bits passing through L2),
    then lm_head; the w4a8 tick's 26 body layers and no lm_head for the
    4-bit bodies (K9, the int4 plane stack). A plane body is timed at each
    live-plane depth P, K1 and K9 once (depth None). One span of CUDA
    events per tick, so the per-launch event cost of a sum of launches
    timed one by one is not in it."""
    from repro_torch.core import pack
    from repro_torch.kernels import harness
    bits = body.w_stack
    four = bits == 4 or body.wk == pack.NIBBLES
    layers = []
    for name, n, k, per_tick in gemm_shapes(cfg):
        if four:
            per_tick = 0 if name == "lm_head" else per_tick - 2
        x = torch.randint(-127, 128, (SLOTS, k), dtype=torch.int8, device="cuda",
                          generator=gen)
        ws = torch.rand(n, device="cuda", generator=gen) * 0.1 + 1e-3
        as_ = torch.rand(SLOTS, device="cuda", generator=gen) + 0.1
        for _ in range(per_tick):
            if bits:
                w = torch.randint(-2 ** 31, 2 ** 31 - 1, (bits, n, k // 32),
                                  dtype=torch.int32, device="cuda", generator=gen)
            else:
                w = gemm_operands(body, 1, n, k, gen)[1][0]
            layers.append((x, w, ws, as_, k))
    # the tick's order: layer by layer, lm_head last
    n_l = len(layers) // 4 if four else (len(layers) - 1) // 4
    order = [layers[j * n_l + i] for i in range(n_l) for j in range(4)] + layers[4 * n_l:]
    out = {}
    for p in depths:
        def tick():
            for x, w, ws, as_, k in order:
                harness.gemm(body, (x,), (w if p is None else w[:p],), ws, as_, k=k)
        out[p] = time_ms(tick, 3, flush, spin=TICK_SPIN_CYCLES)
    del layers, order
    torch.cuda.empty_cache()
    return out


def check_paged(cfg, flush, gen, positions=PAGED_POS, max_pages=CACHE_LEN // PAGE_SIZE,
                slots=None) -> dict:
    """Kernel vs plain for one layer's decode attention of len(positions)
    rows at `positions`, row r reading table row slots[r] (default: its
    own), bf16 and int8 pools, each slot's pages as many as its longest row
    needs; kernel, plain and SDPA timed. Returns the record of the bf16 pool
    (the serve path's) for the cfg's layers: at PAGED_POS the 4-slot decode
    tick's 28 launches."""
    import torch.nn.functional as F
    from repro_torch.kernels import paged_attn
    slots = tuple(range(len(positions))) if slots is None else slots
    b, hq, hk, dh = len(positions), cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    n_slots = max(slots) + 1
    num_pages = 1 + n_slots * max_pages
    pos = torch.tensor(positions, dtype=torch.int32, device="cuda")
    table = torch.zeros((n_slots, max_pages), dtype=torch.int32, device="cuda")
    for r in range(n_slots):
        live = max(p for p, sl in zip(positions, slots) if sl == r) // PAGE_SIZE + 1
        table[r, :live] = 1 + r * max_pages + torch.arange(live, device="cuda")
    pages = table[list(slots)].contiguous()
    q = torch.randn((b, hq, dh), device="cuda", generator=gen).to(torch.bfloat16)
    rec = None
    tol = 2e-2
    for kv in ("bf16", "int8"):
        shape = (num_pages, PAGE_SIZE, hk, dh)
        # K/V ~ N(0, 1), stored as the serve path stores them: bf16, or
        # int8 codes at the static KV scale (models.attention._kv_quant)
        k_pool, v_pool = (torch.randn(shape, device="cuda", generator=gen)
                          for _ in range(2))
        if kv == "int8":
            k_pool, v_pool = (torch.clamp(torch.round(t / 0.05), -127, 127).to(torch.int8)
                              for t in (k_pool, v_pool))
        else:
            k_pool, v_pool = k_pool.to(torch.bfloat16), v_pool.to(torch.bfloat16)
        got = paged_attn.paged_flash_decode(q, k_pool, v_pool, pages, pos)
        want = paged_attn.paged_decode_plain(q, k_pool, v_pool, pages, pos)
        err = (got.float() - want.float()).abs().max().item()
        # the plain version rounds scores, probabilities and the output to
        # bf16; the kernel keeps f32 to the end: 1 bf16 step at |o| < 4 is
        # 0.0156, so allow 2e-2 + 2e-2 * |want|
        if not torch.allclose(got.float(), want.float(), rtol=tol, atol=tol):
            raise AssertionError(f"paged decode ({kv} pool, pos {list(positions)}): "
                                 f"max abs err {err} outside rtol=atol={tol}")
        ms = time_ms(lambda: paged_attn.paged_flash_decode(q, k_pool, v_pool,
                                                            pages, pos), 50, flush)
        pms = time_ms(lambda: paged_attn.paged_decode_plain(q, k_pool, v_pool,
                                                             pages, pos), 5)
        # each slot's K/V read once (verify rows of a slot share theirs)
        tokens = sum(max(p for p, sl in zip(positions, slots) if sl == r) + 1
                     for r in range(n_slots))
        nbytes = (2 * tokens * hk * dh * k_pool.element_size()
                  + 2 * 2 * b * hq * dh + 4 * (b * max_pages + b))
        ops = 4.0 * sum(p + 1 for p in positions) * hq * dh
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / BF16_FLOPS_PER_S
        # yardstick: SDPA on the already-gathered KV (gather not timed)
        s = max_pages * PAGE_SIZE
        kd = paged_attn.kv_dequant(k_pool[pages.long()].reshape(b, s, hk, dh),
                                   torch.bfloat16, 0.05)
        vd = paged_attn.kv_dequant(v_pool[pages.long()].reshape(b, s, hk, dh),
                                   torch.bfloat16, 0.05)
        g = hq // hk
        kd = kd.permute(0, 2, 1, 3).repeat_interleave(g, dim=1).contiguous()
        vd = vd.permute(0, 2, 1, 3).repeat_interleave(g, dim=1).contiguous()
        mask = (torch.arange(s, device="cuda")[None, :] <= pos[:, None].long()
                )[:, None, None, :]
        qs = q[:, :, None, :]
        lib = time_ms(lambda: F.scaled_dot_product_attention(qs, kd, vd,
                                                             attn_mask=mask),
                      50, flush)
        del kd, vd
        where = (f"pos={list(positions)}" if b <= 4 else
                 f"{b} verify rows of {n_slots} slots, pos {min(positions)}..{max(positions)}")
        log(f"[kernels] paged_flash_decode {kv} pool B={b} Hq={hq} Hk={hk} dh={dh} "
            f"max_pages={max_pages} {where}: max abs err {err:.3e} (rtol=atol={tol})  "
            f"kernel {ms:.4f} ms  plain {pms:.3f} ms  bound {max(t_bytes, t_ops) * 1e3:.5f} "
            f"ms ({'bytes' if t_bytes >= t_ops else 'operations'})  sdpa on gathered KV "
            f"{lib:.4f} ms  kernel / sdpa {ms / lib:.2f}")
        if kv == "bf16":
            n = cfg.n_layers
            rec = {"name": "paged_flash_decode", "max_abs_err": err, "ms": n * ms,
                   "plain_ms": n * pms, "bound_ms": n * max(t_bytes, t_ops) * 1e3,
                   "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                   "library_ms": n * lib}
    return rec


def check_flash(cfg, flush, gen, t=256) -> dict:
    """Kernel vs plain for one layer's T-token prefill attention (B = 1,
    24/8 heads, dh = 128, bf16, causal), with q/k/v the (B, T, H, dh) views
    the model passes, beside SDPA; returns the per-prefill record (28
    layers)."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attn
    b, h, hk, dh = 1, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = (torch.randn((b, t, n, dh), device="cuda", generator=gen
                           ).to(torch.bfloat16).transpose(1, 2) for n in (h, hk, hk))
    got = flash_attn.flash_attention(q, k, v)
    want = flash_attn.flash_attention_plain(q, k, v)
    err = (got.float() - want.float()).abs().max().item()
    tol = 3e-2                       # tests/test_flash_attn.py's bf16 bar
    if not torch.allclose(got.float(), want.float(), rtol=tol, atol=tol):
        raise AssertionError(f"flash attention T={t}: max abs err {err} outside "
                             f"rtol=atol={tol}")
    ms = time_ms(lambda: flash_attn.flash_attention(q, k, v), 50, flush)
    pms = time_ms(lambda: flash_attn.flash_attention_plain(q, k, v), 5)
    # the causal half of the two products is what this run's data needs
    pairs = t * (t + 1) / 2
    ops = 4.0 * h * pairs * dh
    nbytes = 2 * (2 * b * t * h * dh + 2 * b * t * hk * dh)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / BF16_FLOPS_PER_S
    g = h // hk
    kr, vr = (a.repeat_interleave(g, dim=1).contiguous() for a in (k, v))
    qc = q.contiguous()
    lib = time_ms(lambda: F.scaled_dot_product_attention(qc, kr, vr, is_causal=True),
                  50, flush)
    log(f"[kernels] flash_attention bf16 B={b} T={t} Hq={h} Hk={hk} dh={dh} causal: "
        f"max abs err {err:.3e} (rtol=atol={tol})  kernel {ms:.4f} ms  plain "
        f"{pms:.3f} ms  bound {max(t_bytes, t_ops) * 1e3:.5f} ms "
        f"({'bytes' if t_bytes >= t_ops else 'operations'})  sdpa (is_causal, "
        f"K/V repeated to {h} heads) {lib:.4f} ms  kernel / sdpa {ms / lib:.2f}")
    n = cfg.n_layers
    return {"name": "flash_attention", "max_abs_err": err, "ms": n * ms,
            "plain_ms": n * pms, "bound_ms": n * max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": n * lib}


def launch_floor(flush) -> None:
    """A one-element add_ timed as the kernels are: the floor under every
    per-launch time of this phase."""
    tiny = torch.zeros(1, device="cuda")
    log(f"[kernels] launch floor (one-element add_, timed as the kernels are): "
        f"{time_ms(lambda: tiny.add_(1), 50, flush):.4f} ms with L2 flushed, "
        f"{time_ms(lambda: tiny.add_(1), 50):.4f} ms warm")


def phase_kernels(cfg, recs: list) -> None:
    """Appends each kernel's record to `recs` as its check passes."""
    from repro_torch.kernels import BODIES
    gen = torch.Generator(device="cuda").manual_seed(1)
    flush = torch.ones(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    launch_floor(flush)
    accs = {}
    for body in BODIES:              # popcount bodies before their mxu twins
        recs.append(check_planes(body, cfg, flush, gen) if body.w_stack
                    else check_gemm(body, cfg, flush, gen, accs))
    recs.append(check_paged(cfg, flush, gen))
    check_paged(cfg, flush, gen, LONG_POS, LONG_PROMPT // PAGE_SIZE)
    check_paged(cfg, flush, gen, VERIFY_POS, slots=VERIFY_SLOTS)
    recs.append(check_flash(cfg, flush, gen, LONG_BUCKET))
    check_flash(cfg, flush, gen, LONG_PROMPT)
    recs.extend(check_grouped(flush, gen))
    recs.append(check_grouped_planes(flush, gen))
    recs.append(check_grouped_popcount(flush, gen))
    log("[kernels] mxu accumulators == popcount accumulators at every shape")


# -- phase 4 -----------------------------------------------------------------

def prompts(cfg):
    """The serve CLI's prompts: 4..16 random tokens each, from seed 0."""
    rng = np.random.default_rng(0)
    return [rng.integers(0, cfg.vocab, size=(rng.integers(4, 17),)).astype(np.int32)
            for _ in range(REQUESTS)]


def mixed_prompts(cfg):
    """Alternately a 4..16-token prompt (bucket 32) and a 129..224-token
    prompt (bucket 256, whose prefill runs flash attention), from seed 1."""
    rng = np.random.default_rng(1)
    return [rng.integers(0, cfg.vocab, size=(rng.integers(*((4, 17) if i % 2 == 0
                                                           else (129, 225))),)
                         ).astype(np.int32) for i in range(REQUESTS)]


def serve(cfg, sparams, slots, reqs, impl="popcount", spec_draft=None):
    from repro_torch.launch.serve import Request, Server
    from repro_torch.models.common import ModelCtx
    srv = Server(cfg, sparams, slots=slots, cache_len=CACHE_LEN,
                 page_size=PAGE_SIZE, ctx=ModelCtx(impl=impl), device="cuda",
                 spec_draft=spec_draft, spec_k=SPEC_K)
    for i, p in enumerate(reqs):
        srv.submit(Request(i, p, MAX_NEW, seed=i))
    t0 = time.perf_counter()
    ticks = srv.run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return srv, ticks, dt


def linear_specs(cfg) -> list:
    """Every quantized linear of one forward call: lm_head and, per block,
    qkv, out and the FFN's, or an MoE block's router, expert stacks and
    shared expert."""
    from repro_torch.models import transformer
    sp = transformer.build_specs(cfg)
    specs = [sp.lm_head]
    for b in sp.blocks:
        specs += [b.mixer.qkv, b.mixer.out]
        f = b.ffn
        if b.is_moe:
            specs += [f.router, f.up, f.down]
            if f.shared is not None:
                specs += [f.shared.up, f.shared.down]
        else:
            specs += [f.up, f.down]
    return specs


def draft_ctx(spec_draft):
    """The speculative draft's context for `--spec-draft planes[:DEPTH]`."""
    from repro_torch.models.common import ModelCtx
    depth = spec_draft.partition(":")[2]
    return ModelCtx(impl="planes", draft_planes=int(depth or 1))


def gemm_launches_per_call(cfg, impl="popcount", ctx=None) -> dict:
    """GEMM kernel -> its launches in one forward call (a prefill or a
    decode tick) under `ctx` (default: the `impl` formulation): one per
    layer that resolves to its body, and one grouped launch per expert
    stack with a body, counted by the body's grouped launcher (K11, K10 over
    expert stacks for a plane body, grouped K3 / K4, K7 or K8)."""
    from repro_torch.kernels import KERNELS, dispatch
    from repro_torch.models.common import ModelCtx, operating_point
    ctx = ctx or ModelCtx(impl=impl)
    grouped_name = {k: n for n, k in KERNELS.items()}
    out = {}
    for spec in linear_specs(cfg):
        body = dispatch.lookup(operating_point(spec, ctx)).body
        if body is not None:
            name = grouped_name[body.grouped] if spec.experts else body.name
            out[name] = out.get(name, 0) + 1
    return out


def expected_kernels(cfg, impl, reqs, spec_draft=None) -> set:
    """The kernels a serve run must launch: the GEMM body of every layer
    that has one (under the draft's context too, for a speculative run),
    the grouped GEMM for an expert stack with a body, paged decode, and
    flash attention when a prompt lands in a bucket that is a multiple of
    256."""
    want = {"paged_flash_decode"} | set(gemm_launches_per_call(cfg, impl))
    if spec_draft:
        want |= set(gemm_launches_per_call(cfg, ctx=draft_ctx(spec_draft)))
    if any(len(p) > CACHE_LEN // 2 for p in reqs):
        want.add("flash_attention")
    return want


def served(label, cfg, sparams, impl, reqs, device_name, total,
           spec_draft=None, on_done=None) -> dict:
    """One 4-slot serve run with the launch counts set to 0 just before it
    and read just after, added to `total`; returns the tokens by request.
    `on_done(srv, launches)` checks more of the run."""
    import repro_torch.kernels as K
    from repro_torch.launch.serve import tree_nbytes
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    srv, ticks, dt = serve(cfg, sparams, SLOTS, reqs, impl, spec_draft)
    runs = K.launch_counts()
    for name, n in runs.items():
        total[name] = total.get(name, 0) + n
    toks = sum(len(r.out) for r in srv.completed)
    out = {r.rid: r.out for r in srv.completed}
    log(f"[serve] {label}: packed {tree_nbytes(sparams) / 2 ** 20:.1f} MiB; "
        f"{len(srv.completed)} requests, {toks} tokens, {ticks} ticks, {dt:.3f} s, "
        f"{toks / dt:.1f} tok/s on {device_name}; max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; launches "
        f"{ {k: v for k, v in runs.items() if v} }")
    if spec_draft:
        st = srv.stats
        if not srv.spec or st["spec_ticks"] == 0:
            raise AssertionError(f"{label}: the server did not speculate")
        log(f"[serve] {label}: spec_ticks {st['spec_ticks']}, spec_proposed "
            f"{st['spec_proposed']}, spec_accepted {st['spec_accepted']}, "
            f"spec_emitted {st['spec_emitted']}, {toks / dt:.1f} tok/s")
    if len(srv.completed) != len(reqs) or toks != len(reqs) * MAX_NEW:
        raise AssertionError(f"{label}: served {len(srv.completed)} requests, "
                             f"{toks} tokens")
    if not all(0 <= t < cfg.vocab for o in out.values() for t in o):
        raise AssertionError(f"{label}: token ids out of range")
    missing = sorted(n for n in expected_kernels(cfg, impl, reqs, spec_draft)
                     if runs[n] == 0)
    if missing:
        raise AssertionError(f"{label}: kernels {missing} never launched")
    if on_done is not None:
        on_done(srv, runs)
    return out


def same_as_one_slot(label, cfg, sparams, impl, reqs, want, spec_draft=None) -> None:
    srv, ticks, dt = serve(cfg, sparams, 1, reqs, impl, spec_draft)
    seq = {r.rid: r.out for r in srv.completed}
    if seq != want:
        bad = [i for i in seq if seq[i] != want.get(i)]
        raise AssertionError(f"{label}: {SLOTS}-slot tokens != 1-slot tokens "
                             f"for requests {bad}")
    log(f"[serve] {label}: {SLOTS}-slot tokens == 1-slot tokens "
        f"({ticks} sequential ticks, {dt:.3f} s)")


def phase_serve(cfg0, device_name) -> dict:
    import repro_torch.kernels as K
    from repro_torch.models import transformer
    from repro_torch.models.common import ModelCtx
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    train = transformer.init(cfg0, gen, "cuda")
    torch.cuda.synchronize()
    log(f"[serve] {ARCH}: {cfg0.n_layers} layers, d_model {cfg0.d_model}, "
        f"{cfg0.n_heads}/{cfg0.n_kv_heads} heads, d_ff {cfg0.d_ff}, vocab "
        f"{cfg0.vocab}; seeded init in {time.perf_counter() - t0:.1f}s")
    cfgs = {pol: dataclasses.replace(cfg0, policy=pol)
            for pol in POLICIES + tuple(p for p, _ in MIXED_RUNS) + PLANE_POLICIES}
    packed = {pol: transformer.pack_for_serve(train, cfgs[pol])
              for pol in POLICIES + tuple(p for p, _ in MIXED_RUNS)}
    # with the stacked bit-plane twin, for --impl planes and the spec draft
    twins = {pol: transformer.pack_for_serve(train, cfgs[pol], plane_twins=True)
             for pol in PLANE_POLICIES}
    del train
    torch.cuda.empty_cache()

    total = {}          # launches summed over the 4-slot runs of the path
    short, mixed = prompts(cfg0), mixed_prompts(cfg0)
    for policy in POLICIES:
        label = f"policy={policy}"
        out = served(label, cfgs[policy], packed[policy], "popcount", short,
                     device_name, total)
        same_as_one_slot(label, cfgs[policy], packed[policy], "popcount", short, out)
    outs = {}
    for policy, impl in MIXED_RUNS:
        label = f"policy={policy} impl={impl} (mixed prompts)"
        outs[policy, impl] = out = served(label, cfgs[policy], packed[policy], impl,
                                          mixed, device_name, total)
        if impl == "mxu":
            if out != outs[policy, "popcount"]:
                raise AssertionError(f"{label}: mxu tokens != popcount tokens")
            log(f"[serve] {label}: mxu tokens == popcount tokens")
        same_as_one_slot(label, cfgs[policy], packed[policy], impl, mixed, out)
    planes_and_spec(cfgs, packed, twins, outs, mixed, device_name, total)

    shallow = dataclasses.replace(cfg0, n_layers=SHALLOW)
    gen = torch.Generator(device="cuda").manual_seed(2)
    train = transformer.init(shallow, gen, "cuda")
    for policy in SHALLOW_POLICIES:
        cfg = dataclasses.replace(shallow, policy=policy)
        sp = transformer.pack_for_serve(train, cfg)
        label = f"policy={policy} ({SHALLOW} layers, mixed prompts)"
        out = served(label, cfg, sp, "popcount", mixed, device_name, total)
        same_as_one_slot(label, cfg, sp, "popcount", mixed, out)
    del train

    for policy in POLICIES:
        cfg = cfgs[policy]
        sp = transformer.build_specs(cfg)
        toks = torch.from_numpy(prompts(cfg)[0]).to("cuda")[None]
        logits, _ = transformer.prefill(packed[policy], toks, sp, ModelCtx())
        if logits.shape != (1, 1, cfg.vocab) or not torch.isfinite(logits).all():
            raise AssertionError(f"{policy}: prefill logits {tuple(logits.shape)}, "
                                 f"finite={bool(torch.isfinite(logits).all())}")
    log(f"[serve] prefill logits finite, shape (1, 1, {cfg0.vocab}), every policy")
    for policy, impl in PROFILED:
        profile_tick(cfgs[policy], (twins if impl == "planes" else packed)[policy],
                     device_name, impl)
    profile_prefill(cfgs["het"], packed["het"], device_name)
    return total


def planes_and_spec(cfgs, packed, twins, outs, mixed, device_name, total) -> None:
    """This slice's paths at 28 layers on the mixed prompts: `--impl planes`
    and self-speculative decoding, each held to the direct cells' tokens."""
    for policy in PLANE_POLICIES:
        cfg, sp = cfgs[policy], twins[policy]
        direct = served(f"policy={policy} impl=popcount (mixed prompts)", cfg, sp,
                        "popcount", mixed, device_name, total)
        label = f"policy={policy} impl=planes (mixed prompts)"
        out = served(label, cfg, sp, "planes", mixed, device_name, total)
        if out != direct:
            raise AssertionError(f"{label}: planes tokens != direct-cell tokens")
        log(f"[serve] {label}: planes tokens == direct-cell tokens")
        same_as_one_slot(label, cfg, sp, "planes", mixed, out)
        for draft in SPEC_DRAFTS:
            label = (f"policy={policy} spec-draft={draft} spec-k={SPEC_K} "
                     f"(mixed prompts)")
            got = served(label, cfg, sp, "popcount", mixed, device_name, total,
                         spec_draft=draft)
            if got != direct:
                raise AssertionError(f"{label}: spec tokens != sequential tokens")
            log(f"[serve] {label}: spec tokens == sequential tokens")
    # binary has no plane cell: the draft falls back to popcount per layer
    label = f"policy=binary spec-draft=planes:1 spec-k={SPEC_K} (mixed prompts)"
    got = served(label, cfgs["binary"], packed["binary"], "popcount", mixed,
                 device_name, total, spec_draft="planes:1")
    if got != outs["binary", "popcount"]:
        raise AssertionError(f"{label}: spec tokens != sequential tokens")
    log(f"[serve] {label}: spec tokens == sequential tokens")


#: MoE serve runs: (arch, policy, layers; None = the arch's full depth)
#: the 4-layer deepseek binary run: the one served path of grouped K3 (the
#: full-depth ternary run serves grouped K4)
GROUPED_K3_RUN = ("deepseek-moe-16b", "binary", 4)
MOE_RUNS = (("deepseek-moe-16b", "het", None), ("deepseek-moe-16b", "int8", None),
            ("deepseek-moe-16b", "wt-a8", None), ("deepseek-moe-16b", "ternary", None),
            ("phi3.5-moe-42b-a6.6b", "het", 4), ("deepseek-moe-16b", "w-ternary", 4),
            GROUPED_K3_RUN)
#: runs beside a MoE run's direct (popcount) one, on the same weights (packed
#: with the plane twin for planes or a draft): (impl, spec_draft); each
#: must emit the direct run's tokens
MOE_BESIDE_RUNS = {MOE_RUNS[0]: (("planes", None), ("popcount", "planes:1")),
                   MOE_RUNS[3]: (("mxu", None),),
                   MOE_RUNS[4]: (("planes", None),)}
#: MoE runs whose 4-slot decode tick is profiled, each under its impls
MOE_PROFILED = {MOE_RUNS[0]: ("popcount", "planes"), MOE_RUNS[2]: ("popcount",)}
#: dense archs at full width and cut depth: (arch, policy, layers)
DENSE_RUNS = (("qwen1.5-32b", "ternary", 4), ("nemotron-4-340b", "ternary", 2))


def moe_checks(label, cfg, impl="popcount", spec_draft=None):
    """The MoE run's own checks: the routing counters add up, and the
    GEMM launches are exactly one per layer per forward call, one grouped
    launch per expert projection on its form's count, none of the
    ungrouped bodies per expert. A speculative run's forward calls are
    its prefills and verify steps under the run's context and its draft
    steps under the draft's; the draft steps are counted by the grouped
    plane launches, which only they make."""
    def check(srv, runs):
        st = srv.stats
        et = st["moe_expert_tokens"]
        if not (st["moe_routed"] == sum(et) + st["moe_dropped"] and st["moe_routed"] > 0):
            raise AssertionError(f"{label}: moe_routed {st['moe_routed']} != "
                                 f"sum(moe_expert_tokens) {sum(et)} + moe_dropped "
                                 f"{st['moe_dropped']}")
        calls = st["prefills"] + st["decode_ticks"] + st["spec_ticks"]
        want = {n: c * calls for n, c in gemm_launches_per_call(cfg, impl).items()}
        drafts = 0
        if spec_draft:
            per = gemm_launches_per_call(cfg, ctx=draft_ctx(spec_draft))
            drafts, rest = divmod(runs["gemm_grouped_planes"], per["gemm_grouped_planes"])
            if rest or not 0 < drafts <= st["spec_ticks"] * (SPEC_K - 1):
                raise AssertionError(f"{label}: {runs['gemm_grouped_planes']} grouped "
                                     f"plane launches are no whole number of draft "
                                     f"steps ({st['spec_ticks']} spec ticks)")
            for n, c in per.items():
                want[n] = want.get(n, 0) + c * drafts
        got = {n: c for n, c in runs.items() if c and n not in ATTENTION_KERNELS}
        if got != want:
            raise AssertionError(f"{label}: GEMM launches {got} != {want} "
                                 f"({calls} forward calls, {drafts} draft steps)")
        log(f"[moe] {label}: moe_routed {st['moe_routed']} == sum(moe_expert_tokens) "
            f"{sum(et)} + moe_dropped {st['moe_dropped']}; expert tokens min "
            f"{min(et)} max {max(et)}; GEMM launches {got} == per call x {calls} calls"
            + (f" + per draft step x {drafts} draft steps" if spec_draft else ""))
    return check


def phase_moe(device_name, launches) -> None:
    """MoE serving: deepseek-moe-16b at full width and depth under het
    (K11 with the K9 body, and K1/K8/K9/K5), int8 (K11 with K1), wt-a8
    (grouped K8) and ternary (grouped K4), phi3.5-moe-42b-a6.6b at full
    width and 4 layers under het (its 32 bf16 layers are ~84 GB before
    packing: cut), and deepseek at 4 layers under w-ternary (weight-only
    experts, no K11) and binary (GROUPED_K3_RUN: grouped K3, whose one
    served path it is). Each from the port's seeded init, packed block by
    block, on the serve CLI's prompts: 4-slot tokens == 1-slot tokens,
    routing counters printed and checked, GEMM launches counted exactly.
    Beside a direct run, on its weights (MOE_BESIDE_RUNS): deepseek het
    with `--impl planes` and with `--spec-draft planes:1 --spec-k 4`,
    deepseek ternary with `--impl mxu` (grouped K7), phi3.5-moe het with
    `--impl planes` (K10 over expert stacks): tokens == the direct run's,
    4-slot == 1-slot, launches counted exactly. Then one profiled 4-slot
    decode tick of deepseek het, direct and under `--impl planes`, and of
    deepseek wt-a8."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    from repro_torch.models.common import ModelCtx
    for arch, policy, layers in MOE_RUNS:
        cfg = dataclasses.replace(get_config(arch), policy=policy)
        if layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        gen = torch.Generator(device="cuda").manual_seed(3)
        t0 = time.perf_counter()
        run = (arch, policy, layers)
        beside = MOE_BESIDE_RUNS.get(run, ())
        twins = any(b_impl == "planes" or draft for b_impl, draft in beside)
        sparams, train_b = transformer.init_for_serve(cfg, gen, "cuda", plane_twins=twins)
        torch.cuda.synchronize()
        label = f"{arch} policy={policy} ({cfg.n_layers} layers)"
        log(f"[moe] {label}: d_model {cfg.d_model}, {cfg.n_experts} experts top-"
            f"{cfg.top_k}, {cfg.n_shared_experts} shared, d_ff {cfg.d_ff}; train "
            f"layout {train_b / 2 ** 30:.2f} GiB, seeded init + pack block by block "
            f"in {time.perf_counter() - t0:.1f}s")
        reqs = prompts(cfg)
        out = served(label, cfg, sparams, "popcount", reqs, device_name, launches,
                     on_done=moe_checks(label, cfg))
        same_as_one_slot(label, cfg, sparams, "popcount", reqs, out)
        for b_impl, draft in beside:
            blabel = (f"{arch} policy={policy} " + (f"spec-draft={draft} spec-k={SPEC_K}"
                                                     if draft else f"impl={b_impl}")
                      + f" ({cfg.n_layers} layers)")
            got = served(blabel, cfg, sparams, b_impl, reqs, device_name, launches,
                         spec_draft=draft, on_done=moe_checks(blabel, cfg, b_impl, draft))
            if got != out:
                raise AssertionError(f"{blabel}: tokens != the direct run's tokens")
            log(f"[moe] {blabel}: " + ("spec tokens == sequential tokens" if draft
                                       else f"{b_impl} tokens == popcount tokens"))
            same_as_one_slot(blabel, cfg, sparams, b_impl, reqs, got, draft)
        toks = torch.from_numpy(reqs[0]).to("cuda")[None]
        logits, _ = transformer.prefill(sparams, toks, transformer.build_specs(cfg),
                                        ModelCtx())
        if logits.shape != (1, 1, cfg.vocab) or not torch.isfinite(logits).all():
            raise AssertionError(f"{label}: prefill logits {tuple(logits.shape)}")
        for p_impl in MOE_PROFILED.get(run, ()):
            profile_tick(cfg, sparams, device_name, p_impl)
        del sparams
        torch.cuda.empty_cache()


def phase_archs(device_name, launches) -> None:
    """The other dense archs at full width, cut in depth: qwen1.5-32b (QKV
    bias) at 4 of 64 layers and nemotron-4-340b (squared ReLU, non-gated
    FFN, 12 query heads a kv head) at 2 of 96 layers, under ternary, from
    the port's seeded init packed block by block (a nemotron layer is ~7 GB
    of bf16, its embedding and head ~9.4 GB each), on the serve CLI's
    prompts: 4-slot tokens == 1-slot tokens, prefill logits finite."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    from repro_torch.models.common import ModelCtx
    for arch, policy, layers in DENSE_RUNS:
        cfg = dataclasses.replace(get_config(arch), policy=policy, n_layers=layers)
        gen = torch.Generator(device="cuda").manual_seed(4)
        t0 = time.perf_counter()
        sparams, train_b = transformer.init_for_serve(cfg, gen, "cuda")
        torch.cuda.synchronize()
        label = f"{arch} policy={policy} ({layers} of {get_config(arch).n_layers} layers)"
        log(f"[archs] {label}: d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} "
            f"heads of {cfg.head_dim}, d_ff {cfg.d_ff} ({cfg.act_fn}, gated "
            f"{cfg.gated_ffn}), qkv bias {cfg.qkv_bias}, vocab {cfg.vocab}; train "
            f"layout {train_b / 2 ** 30:.2f} GiB, seeded init + pack block by block in "
            f"{time.perf_counter() - t0:.1f}s")
        reqs = prompts(cfg)
        out = served(label, cfg, sparams, "popcount", reqs, device_name, launches)
        same_as_one_slot(label, cfg, sparams, "popcount", reqs, out)
        toks = torch.from_numpy(reqs[0]).to("cuda")[None]
        logits, _ = transformer.prefill(sparams, toks, transformer.build_specs(cfg),
                                        ModelCtx())
        if logits.shape != (1, 1, cfg.vocab) or not torch.isfinite(logits).all():
            raise AssertionError(f"{label}: prefill logits {tuple(logits.shape)}")
        del sparams, logits
        torch.cuda.empty_cache()


def profile_tick(cfg, sparams, device_name, impl="popcount") -> None:
    """Where one 4-slot decode tick's time goes: host wall time, device busy
    time and kernel count from torch.profiler, and the top kernels."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import transformer
    from repro_torch.models.common import ModelCtx
    max_pages = CACHE_LEN // PAGE_SIZE
    num_pages = 1 + SLOTS * max_pages
    cache = transformer.init_cache(cfg, num_pages, PAGE_SIZE, kv_dtype=torch.bfloat16,
                                   device="cuda")
    pages = (1 + torch.arange(SLOTS * max_pages, dtype=torch.int32, device="cuda")
             ).reshape(SLOTS, max_pages)
    pos = torch.tensor(PAGED_POS, dtype=torch.int32, device="cuda")
    toks = torch.zeros((SLOTS, 1), dtype=torch.int32, device="cuda")
    sp = transformer.build_specs(cfg)

    def tick():
        transformer.decode_step(sparams, cache, toks, pos, sp, ModelCtx(impl=impl),
                                pages=pages)

    tick()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        tick()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / 5 * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        tick()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    if not kernels:
        log(f"[profile] {cfg.name} policy={cfg.policy} impl={impl}: decode tick {wall:.2f} ms wall; device "
            f"time not measured (the profiler recorded no device events)")
        return
    log(f"[profile] {cfg.name} policy={cfg.policy} impl={impl}: decode tick {wall:.2f} ms wall, device busy "
        f"{busy:.2f} ms ({100 * busy / wall:.1f} %), {len(kernels)} kernels on "
        f"{device_name}; top: " + ", ".join(f"{n[:40]} {t:.3f} ms" for n, t in top))


def profile_prefill(cfg, sparams, device_name) -> None:
    """Time to first token of a 256-token prompt (one prefill of the whole
    model, bucket 256, so every layer runs flash attention): host wall
    time, device busy time from torch.profiler, and flash attention's
    share of it."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import transformer
    from repro_torch.models.common import ModelCtx
    rng = np.random.default_rng(5)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (1, LONG_BUCKET)).astype(np.int32)
                            ).to("cuda")
    sp = transformer.build_specs(cfg)

    def run():
        transformer.prefill(sparams, toks, sp, ModelCtx())

    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        run()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / 3 * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        log(f"[profile] {cfg.name} policy={cfg.policy}: {LONG_BUCKET}-token prefill "
            f"{wall:.2f} ms wall; device time not measured (no device events)")
        return
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    flash = [e for e in kernels if "flash" in e.name]
    fms = sum(e.time_range.elapsed_us() for e in flash) / 1e3
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    log(f"[profile] {cfg.name} policy={cfg.policy}: {LONG_BUCKET}-token prefill "
        f"{wall:.2f} ms wall, device busy {busy:.2f} ms ({100 * busy / wall:.1f} %), "
        f"{len(kernels)} kernels; flash attention {len(flash)} launches {fms:.3f} ms "
        f"({100 * fms / busy:.1f} % of busy) on {device_name}; top: "
        + ", ".join(f"{n[:40]} {t:.3f} ms" for n, t in top))


# -- driver ------------------------------------------------------------------

def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.configs import get_config
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})", file=sys.stderr)
        return 1
    cfg = get_config(ARCH)
    failures = []
    recs, launches = [], {}
    device_name = phase_device()
    def phase_launches():
        for name in REPLACES:
            if launches.get(name, 0) == 0:
                raise AssertionError(f"kernel {name} never launched on the serve path")

    phases = (("build", phase_build),
              ("kernels", lambda: phase_kernels(cfg, recs)),
              ("serve", lambda: launches.update(phase_serve(cfg, device_name))),
              ("moe", lambda: phase_moe(device_name, launches)),
              ("archs", lambda: phase_archs(device_name, launches)),
              ("launches", phase_launches))
    for phase, fn in phases:
        t0 = time.perf_counter()
        try:
            fn()
            log(f"[{phase}] ok in {time.perf_counter() - t0:.1f}s")
        except Exception:                 # report every phase, then fail
            failures.append(phase)
            log(f"[{phase}] FAILED:\n{traceback.format_exc()}")
            if phase == "build":
                break
    checked = {r["name"] for r in recs}
    names = list(REPLACES)
    log("[summary] " + "; ".join(
        f"{n}: launches {launches.get(n, 0)}, check "
        f"{'ok' if n in checked else 'FAILED'}" for n in names))
    if failures:
        log(f"chip_smoke: FAILED phases {failures}")
        return 1
    kernels = []
    for r in recs:
        kernels.append({"name": r["name"], "route": "cuda", "source": SOURCE[r["name"]],
                        "replaces": REPLACES[r["name"]],
                        "launches": launches[r["name"]],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": device_name,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
