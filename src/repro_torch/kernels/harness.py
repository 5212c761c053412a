"""The output-stationary packed GEMM with its fused requant epilogue —
counterpart of `repro.kernels.harness`.

One CUDA template (`csrc/gemm.cu`) serves every precision; a `MacBody`
names the compile-time MAC body it instantiates, the operand layout it
takes, and its plain PyTorch version (`plain`), which states the same
algebra with torch ops. `gemm` launches the kernel for CUDA tensors and runs
the plain version for CPU tensors; it never falls back from one to the
other. `gemm_grouped` (K11) runs G GEMMs of one shape, every operand
carrying a leading group axis, as ONE launch (`repro_gemm_grouped`),
counted by the body's grouped launcher (`MacBody.grouped`): the int8,
s4, plane (K10 over expert stacks), mxu (K7) and wt-i8a (K8) bodies on the
int8 tensor-core tile, the popcount bodies (K3, K4) on the b1 tensor-core
tile (`pop_mma_kernel`), each with a grid z over the members.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Callable, Sequence

import torch

from .build import Kernel

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def gemm_kernel() -> Kernel:
    """A launcher of `repro_gemm` (csrc/gemm.cu) with its own launch count;
    each MacBody holds one, so launches are counted per body."""
    return Kernel("gemm", "repro_gemm",
                  [_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _L,
                   _P, _L])


#: ints of the zeroed scratch an ungrouped launch may use for a sum across
#: blocks (K1 splits K across blocks at decode; it needs at most 257 ints a
#: 32-column tile, and splits only when the tiles are fewer than the
#: resident blocks, at most 16 a multiprocessor)
WORKSPACE_INTS = 1 << 20
_workspaces: dict[tuple[int, int], torch.Tensor] = {}


def _workspace(dev: torch.device, stream: int) -> torch.Tensor:
    """The zeroed int32 scratch of `stream` on `dev`, allocated at its first
    use; every kernel leaves it zeroed, so launches on one stream share it
    and launches on two streams never do."""
    key = (dev.index, stream)
    ws = _workspaces.get(key)
    if ws is None:
        ws = _workspaces[key] = torch.zeros(WORKSPACE_INTS, dtype=torch.int32,
                                            device=dev)
    return ws


_GROUPED_ARGS = [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _L, _L,
                 _I, _L]
#: the grouped launcher (K11, `repro_gemm_grouped`), one count per form, so
#: that a run tells grouped launches from ungrouped ones and each grouped
#: form from the others: the int8 and s4 bodies (K11's tensor-core tile) ...
GEMM_GROUPED = Kernel("gemm", "repro_gemm_grouped", _GROUPED_ARGS)
#: ... the popcount bodies (K3, K4: `pop_mma_kernel`, the b1 tile, 16 rows
#: up to 16 rows a member and 64 above) ...
GEMM_GROUPED_POP = Kernel("gemm", "repro_gemm_grouped", _GROUPED_ARGS)
#: ... the plane bodies (K10 over expert stacks) ...
GEMM_GROUPED_PLANES = Kernel("gemm", "repro_gemm_grouped", _GROUPED_ARGS)
#: ... the mxu bodies (K7: `bmxu_mma_kernel` / `tmxu_mma_kernel`) ...
GEMM_GROUPED_MXU = Kernel("gemm", "repro_gemm_grouped", _GROUPED_ARGS)
#: ... and the wt-i8a body (K8: `wt_mma_kernel`)
GEMM_GROUPED_WT_I8A = Kernel("gemm", "repro_gemm_grouped", _GROUPED_ARGS)


@dataclasses.dataclass(frozen=True)
class MacBody:
    """One MAC body of the GEMM template.

    body_id: the BODY_* constant of csrc/gemm.cu. n_x / n_w: activation and
    weight operand planes. k_per_q: the K quantum, the lcm of the two
    sides' storage densities. xk_per_q / wk_per_q: K elements per storage
    unit of the activation / weight operand (None => k_per_q): 32 for
    bit-plane words, 8 for s4 nibble words, 1 for int8 codes, so a mixed
    body (int8 codes x trit planes) blocks each side by its own density.
    w_kmajor: weights are (K, N) instead of (N, K/wk_per_q).
    w_stack: the planes of a full plane-stacked weight (0: not stacked); its
    operand is (P, N, K/wk_per_q) with 1 <= P <= w_stack live planes.
    plain(x_ops, w_ops, k) -> (M, N) int32 dot is the body's plain PyTorch
    version; kernel launches the CUDA instantiation and counts its
    launches. grouped: the launcher of this body's grouped calls, one of
    the GEMM_GROUPED* above, whose count holds them."""
    name: str
    body_id: int
    n_x: int
    n_w: int
    k_per_q: int
    plain: Callable
    kernel: Kernel
    grouped: Kernel
    w_kmajor: bool = False
    w_stack: int = 0
    xk_per_q: int | None = None
    wk_per_q: int | None = None

    @property
    def xk(self) -> int:
        return self.xk_per_q or self.k_per_q

    @property
    def wk(self) -> int:
        return self.wk_per_q or self.k_per_q


def requant(dot, w_scale, a_scale, bias):
    """The fused requant epilogue, defined once: dot * w_scale[n] *
    a_scale[m] + bias[n] in f32, in that order. Any scale/bias may be None
    (identity). Callers cast the result themselves."""
    y = dot.to(torch.float32)
    if w_scale is not None:
        y = y * w_scale[None, :]
    if a_scale is not None:
        y = y * a_scale[:, None]
    if bias is not None:
        y = y + bias[None, :]
    return y


def _dtype(k_per_unit: int) -> torch.dtype:
    """Storage dtype of an operand side: int8 codes, or int32 words."""
    return torch.int8 if k_per_unit == 1 else torch.int32


def _check(body: MacBody, x_ops, w_ops, k: int):
    if len(x_ops) != body.n_x or len(w_ops) != body.n_w:
        raise ValueError(f"{body.name}: want {body.n_x} activation and "
                         f"{body.n_w} weight operands")
    if k % body.k_per_q or k % 4:
        raise ValueError(f"{body.name}: K={k} not a multiple of the storage unit")
    m = x_ops[0].shape[0]
    n = w_ops[0].shape[1] if body.w_kmajor or body.w_stack else w_ops[0].shape[0]
    for xo in x_ops:
        if tuple(xo.shape) != (m, k // body.xk):
            raise ValueError(f"{body.name}: activation operand {tuple(xo.shape)} "
                             f"!= {(m, k // body.xk)}")
    want_w = (k // body.wk, n) if body.w_kmajor else (n, k // body.wk)
    if body.w_stack:
        p = w_ops[0].shape[0] if w_ops[0].ndim == 3 else 0
        if not 1 <= p <= body.w_stack:
            raise ValueError(f"{body.name}: weight stack {tuple(w_ops[0].shape)} "
                             f"needs 1..{body.w_stack} leading planes")
        want_w = (p,) + want_w
    for wo in w_ops:
        if tuple(wo.shape) != want_w:
            raise ValueError(f"{body.name}: weight operand {tuple(wo.shape)} "
                             f"!= {want_w}")
    return m, n


def gemm(body: MacBody, x_ops: Sequence[torch.Tensor],
         w_ops: Sequence[torch.Tensor], w_scale: torch.Tensor | None,
         a_scale: torch.Tensor | None, bias: torch.Tensor | None = None, *,
         k: int, out: str = "requant") -> torch.Tensor:
    """Run `body` through the shared output-stationary GEMM.

    x_ops: n_x tensors (M, K/xk_per_q); w_ops: n_w tensors (N, K/wk_per_q),
    or (K, N) when body.w_kmajor, or a (P, N, K/32) plane stack when
    body.w_stack (a leading slice of a contiguous stack is contiguous; any
    other stack is refused, never copied); packed words are int32, int8
    codes int8.
    w_scale (N,) f32, a_scale (M,) f32, bias (N,) f32 or None
    -> (M, N) bf16. out="acc" returns the raw (M, N) int32 dot instead; the
    scales are then unused and may be None. Ragged M and N need no padding.
    """
    if out not in ("requant", "acc"):
        raise ValueError(f"out={out!r}")
    m, n = _check(body, x_ops, w_ops, k)
    if out == "requant" and (w_scale is None or a_scale is None):
        raise ValueError("requant needs w_scale and a_scale")
    dev = x_ops[0].device
    if dev.type == "cpu":
        dot = body.plain(x_ops, w_ops, k)
        if out == "acc":
            return dot
        return requant(dot, w_scale, a_scale, bias).to(torch.bfloat16)
    rq = out == "requant"
    _check_cuda(body, x_ops, w_ops, (w_scale, a_scale, bias) if rq else (), n)
    y = torch.empty((m, n), dtype=torch.bfloat16 if rq else torch.int32,
                    device=dev)
    if m == 0:
        return y
    # a plane stack: its live planes and the words from one plane to the next
    planes, stride = ((w_ops[0].shape[0], w_ops[0].stride(0)) if body.w_stack
                      else (1, 0))
    stream = torch.cuda.current_stream().cuda_stream
    ws = _workspace(dev, stream)
    body.kernel(body.body_id, *_ptrs(body, x_ops, w_ops),
                *(_ptr(t) if rq else None for t in (w_scale, a_scale, bias)),
                y.data_ptr(), int(not rq), m, n, k, planes, stride,
                ws.data_ptr(), ws.numel(), stream=stream)
    return y


def gemm_grouped(body: MacBody, x_ops: Sequence[torch.Tensor],
                 w_ops: Sequence[torch.Tensor], w_scale: torch.Tensor | None,
                 a_scale: torch.Tensor | None, bias: torch.Tensor | None = None,
                 *, k: int, out: str = "requant") -> torch.Tensor:
    """K11: `gemm` over a leading group axis G, in one launch on the card.

    Every operand carries the same leading G: x_ops (G, M, K/xk_per_q);
    w_ops (G, N, K/wk_per_q), or (G, K, N) when body.w_kmajor, or for a
    plane body (K10 over expert stacks) (G, P, N, K/32): a contiguous
    stack, or its leading-P slice `stack[:, :P]` (the draft's truncation),
    read in place; w_scale (G, N), a_scale (G, M), bias (G, N) f32 or None
    -> (G, M, N) bf16, or the raw (G, M, N) int32 dot with out="acc".
    Member g is exactly `gemm(body, x_ops[:, g], ...)`: the reference's
    `gemm_grouped` is that call under `jax.vmap`. On CPU tensors the body's
    plain version runs once per member, then `requant`; on CUDA tensors one
    `repro_gemm_grouped` launch of the body's tensor-core tile (int8, or b1
    for the popcount bodies) runs every member (its grid's third dimension),
    never a loop of `gemm` launches, and adds one to `body.grouped`'s
    count."""
    if out not in ("requant", "acc"):
        raise ValueError(f"out={out!r}")
    if out == "requant" and (w_scale is None or a_scale is None):
        raise ValueError("requant needs w_scale and a_scale")
    g = x_ops[0].shape[0] if x_ops[0].ndim == 3 else 0
    w_ndim = 4 if body.w_stack else 3
    if g < 1 or any(t.ndim != nd or t.shape[0] != g
                    for nd, ts in ((3, x_ops), (w_ndim, w_ops)) for t in ts):
        raise ValueError(f"{body.name}: grouped operands need one leading group "
                         f"axis G >= 1, got {[tuple(t.shape) for t in x_ops]} x "
                         f"{[tuple(t.shape) for t in w_ops]}")
    m, n = _check(body, [t[0] for t in x_ops], [t[0] for t in w_ops], k)
    for name, t, want in (("w_scale", w_scale, (g, n)), ("a_scale", a_scale, (g, m)),
                          ("bias", bias, (g, n))):
        if t is not None and tuple(t.shape) != want:
            raise ValueError(f"{body.name}: {name} {tuple(t.shape)} != {want}")
    dev = x_ops[0].device
    if dev.type == "cpu":
        ys = []
        for i in range(g):
            dot = body.plain([t[i] for t in x_ops], [t[i] for t in w_ops], k)
            ys.append(dot if out == "acc" else requant(
                dot, w_scale[i], a_scale[i], None if bias is None else bias[i]
            ).to(torch.bfloat16))
        return torch.stack(ys)
    rq = out == "requant"
    _check_cuda(body, x_ops, w_ops, (w_scale, a_scale, bias) if rq else (), n)
    y = torch.empty((g, m, n), dtype=torch.bfloat16 if rq else torch.int32,
                    device=dev)
    if m == 0:
        return y

    def words(t):        # 32-bit words from one group member to the next
        return t.stride(0) * t.element_size() // 4

    # a plane stack: its live planes and the words from one plane to the next
    w0 = w_ops[0]
    planes, stride = (w0.shape[1], w0.stride(1)) if body.w_stack else (1, 0)
    body.grouped(body.body_id, g, *_ptrs(body, x_ops, w_ops),
                 *(_ptr(t) if rq else None for t in (w_scale, a_scale, bias)),
                 y.data_ptr(), int(not rq), m, n, k, words(x_ops[0]), words(w0),
                 planes, stride)
    return y


def _ptr(t):
    return None if t is None else t.data_ptr()


def _ptrs(body: MacBody, x_ops, w_ops):
    """x0, x1, w0, w1 of a launch: the second planes of trit operands, or
    None."""
    return (x_ops[0].data_ptr(), _ptr(x_ops[1]) if body.n_x > 1 else None,
            w_ops[0].data_ptr(), _ptr(w_ops[1]) if body.n_w > 1 else None)


def _plane_slice(body: MacBody, t: torch.Tensor) -> bool:
    """t is the leading-P slice `stack[:, :P]` of a contiguous (G,
    w_stack, N, K/32) plane stack: the one non-contiguous layout the grouped
    plane launch reads in place (member stride w_stack planes, plane stride
    N * K/32 words)."""
    if not body.w_stack or t.ndim != 4:
        return False
    _, _, n, kw = t.shape
    member = body.w_stack * n * kw
    return (t.stride() == (member, n * kw, kw, 1)
            and t.storage_offset() % member == 0)     # from plane 0 of a member


def _check_cuda(body: MacBody, x_ops, w_ops, scales, n: int) -> None:
    """What the CUDA kernel takes: contiguous operands on the card (a
    grouped plane stack may also be a leading-P slice of a full one,
    `_plane_slice`), int8 codes or int32 words as the body's sides store
    them, f32 scales and bias (None entries are skipped), N % 4 == 0 for
    K-major weights, and int8 activations against bit-plane weight words
    (K8, K10) starting 16-byte aligned, every group member's rows too:
    their kernels load the rows 16 bytes at a time."""
    dev = x_ops[0].device
    if dev.type != "cuda":
        raise ValueError(f"gemm: unsupported device {dev}")
    scales = [t for t in scales if t is not None]
    for t in list(x_ops) + list(w_ops) + scales:
        if t.device != dev or not (t.is_contiguous() or _plane_slice(body, t)):
            raise ValueError(f"{body.name}: every operand must be a contiguous "
                             f"tensor on {dev}")
    for t in scales:
        if t.dtype != torch.float32:
            raise ValueError(f"{body.name}: scales and bias must be float32")
    if (any(t.dtype != _dtype(body.xk) for t in x_ops)
            or any(t.dtype != _dtype(body.wk) for t in w_ops)):
        raise ValueError(f"{body.name}: activation operands must be "
                         f"{_dtype(body.xk)}, weight operands {_dtype(body.wk)}")
    if body.w_kmajor and n % 4:
        raise ValueError(f"{body.name}: K-major int8 weights need N % 4 == 0")
    x = x_ops[0]
    if body.xk == 1 and body.wk == 32 and (x.data_ptr() % 16
                                           or x.ndim == 3 and x.stride(0) % 16):
        raise ValueError(f"{body.name}: int8 activation rows must start 16-byte "
                         f"aligned (an aligned storage offset, and whole 16-byte "
                         f"runs from one group member to the next)")
