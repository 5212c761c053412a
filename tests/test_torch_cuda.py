"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked `cuda` and skips without a CUDA device; the file
imports no JAX, so it runs on a machine that has only torch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Bars: the GEMM kernel's int32 accumulator and bf16 requant output are
bit-equal to the plain version for every MAC body (ragged M and N, with and
without bias; K1, K7, K8 and K9 in both of their kernels, K1 with K split
across blocks), and the mxu bodies' accumulators equal the popcount bodies';
the plane bodies (K10) are bit-equal to their plain version at every
truncation depth P in 1..bits, in both regimes (up to 8 rows and above),
and at P = bits to the direct int8 and int4 bodies on the composed codes;
paged decode is within rtol=atol=2e-5 of the plain version for f32 queries
(the bar of tests/test_paged_attn.py: the same algebra summed in another
order) and 2e-2 for bf16 (the plain version rounds scores, probabilities
and output to bf16, the kernel keeps f32 to the end; one bf16 step at
|o| < 4 is 0.0156), at every G x dh instantiation, a 2048-token cache and
16 verify rows, and each row of a multi-row launch is bit-equal to its own
1-row launch (the kernel's chunks depend on positions alone); flash attention is within the bars of
tests/test_flash_attn.py (f32 2e-4, bf16 3e-2: the same algebra summed in
another order, so bf16 outputs may differ by a rounding step); a reduced
model served through the kernels gives a 4-slot server the tokens of a
1-slot server under every policy, with a bf16 or an int8 KV pool, and the
mxu formulation gives the popcount formulation's tokens; `--impl planes`
gives the direct cells' tokens, speculative decoding gives sequential
decoding's tokens, and a verify row's logits are bit-equal to the
sequential decode step's at the same position. The grouped GEMM (K11) is
bit-equal to its plain version and to G separate ungrouped launches for
every body it serves, in one launch counted once by the body's grouped
launcher (every body on both of its row tiles, at G up to 64, the mxu,
wt-i8a and popcount bodies at K whole and ragged against the tile's stage
and its 16-byte loads; the grouped mxu accumulators equal the grouped
popcount bodies'), and so is K10 over expert stacks (the
plane bodies grouped, at P = 1 and bits live planes, M = 4, 16 and 128,
and at P = bits equal to K11's int4 / int8 body on the composed codes),
which reads a truncated stack `stack[:, :P]` in place, allocating no copy;
a reduced MoE arch served through it gives a 4-slot server the tokens of a
1-slot server, and launches it once per expert projection per forward
call (under wt-a8 the grouped wt-i8a form, under `--impl mxu` the grouped
mxu form, whose tokens equal the popcount formulation's); under `--impl
planes` (K10 over the expert stacks) its tokens equal the direct cells',
and self-speculative decoding gives sequential decoding's tokens.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.precision import POLICIES
from repro_torch.core import pack
from repro_torch.kernels import (BODIES, bgemm, flash_attn, harness, i4gemm, i8gemm,
                                 paged_attn, pgemm, tgemm)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _side(shape_units, per_unit, n_ops, gen):
    """n_ops random operands: int8 codes, or int32 words with every bit
    pattern (sign bit included)."""
    if per_unit == 1:
        return tuple(torch.randint(-127, 128, shape_units, dtype=torch.int8,
                                   generator=gen) for _ in range(n_ops))
    return tuple(torch.randint(-2 ** 31, 2 ** 31 - 1, shape_units,
                               dtype=torch.int32, generator=gen)
                 for _ in range(n_ops))


def _operands(body, m, n, k, gen):
    x = _side((m, k // body.xk), body.xk, body.n_x, gen)
    w_shape = (k // body.wk, n) if body.w_kmajor else (n, k // body.wk)
    if body.w_stack:
        w_shape = (body.w_stack,) + w_shape
    w = _side(w_shape, body.wk, body.n_w, gen)
    scales = (torch.rand(n, generator=gen) * 0.1 + 1e-3,
              torch.rand(m, generator=gen) + 0.1, torch.randn(n, generator=gen))
    return x, w, scales


_GEMM_SHAPES = [(1, 128, 96), (5, 256, 100), (33, 3072, 200), (4, 8192, 3072)]
#: K1, K7 and K9 on each side of their switch from the streaming kernel (up
#: to 8 rows) to the tensor-core kernel: K ragged against the 128-k stage and the
#: 16-byte loads (int8 K = 132, 3076; s4 K = 136), N ragged (a multiple of 4
#: for K1's K-major weights) or 16-byte aligned (3072). K1 at K = 3076, N =
#: 228 splits K across blocks unevenly at 4 and 8 rows (769 k-quads: the
#: last split holds one).
_TWO_KERNEL_SHAPES = {
    i8gemm.I8_DOT: [(132, 100), (3076, 228), (1024, 3072)],
    i4gemm.INT4_W_I8A: [(136, 100), (1024, 3072)],
    # K7 likewise: K = 160 and 4128 are not multiples of the 128-k stage
    # (4-byte loads on both sides), 1024 is; N ragged or 3072
    bgemm.BINARY_MXU: [(160, 100), (4128, 200), (1024, 3072)],
    tgemm.TERNARY_MXU: [(160, 100), (4128, 200), (1024, 3072)],
    # K8 likewise (trit weight words against int8 activation rows)
    tgemm.TERNARY_W_I8A: [(160, 100), (4128, 200), (1024, 3072)],
    # K3 and K4 (the packed weight stream up to 8 rows, the b1 tile above)
    # at K7's shapes: K = 160 and 4128 take 4-byte loads and are ragged
    # against the tile's 1024- / 512-k stage, 1024 is not
    bgemm.BINARY_POPCOUNT: [(160, 100), (4128, 200), (1024, 3072)],
    tgemm.TERNARY_POPCOUNT: [(160, 100), (4128, 200), (1024, 3072)],
}
_GEMM_CASES = ([(b, *s) for b in BODIES for s in _GEMM_SHAPES]
               + [(b, m, k, n) for b, kn in _TWO_KERNEL_SHAPES.items()
                  for m in (1, 4, 8, 9, 16, 33, 256) for k, n in kn])


@pytest.mark.cuda
@pytest.mark.parametrize("body,m,k,n", _GEMM_CASES,
                         ids=[f"{b.name}-{m}-{k}-{n}" for b, m, k, n in _GEMM_CASES])
def test_gemm_kernel_bit_equal_to_plain(cuda, body, m, k, n):
    gen = torch.Generator().manual_seed(m * 1000 + n)
    x, w, (ws, as_, b) = _operands(body, m, n, k, gen)
    dev = lambda ts: tuple(t.to(cuda) for t in ts)
    acc = harness.gemm(body, dev(x), dev(w), None, None, k=k, out="acc")
    assert torch.equal(acc.cpu(), harness.gemm(body, x, w, None, None, k=k, out="acc"))
    for bias in (None, b):
        got = harness.gemm(body, dev(x), dev(w), ws.to(cuda), as_.to(cuda),
                           None if bias is None else bias.to(cuda), k=k)
        want = harness.gemm(body, x, w, ws, as_, bias, k=k)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu().view(torch.int16), want.view(torch.int16))


#: K is a multiple of 32 (one packed word) on both formulations; 1056 (33
#: words) and 1152 (36) are not multiples of 32 words, so neither fills the
#: popcount tile's last stage, at 8 and 9 rows (each side of the switch from
#: the streaming kernels to the tiles) and at 33
@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(4, 3072, 200), (32, 8192, 96), (8, 160, 100),
                                   (9, 4128, 200), (256, 1024, 300), (8, 1056, 130),
                                   (9, 1056, 130), (8, 1152, 72), (9, 1152, 72),
                                   (33, 1152, 200)])
@pytest.mark.parametrize("mxu,popcount", [
    (bgemm.BINARY_MXU, bgemm.BINARY_POPCOUNT),
    (tgemm.TERNARY_MXU, tgemm.TERNARY_POPCOUNT)], ids=["binary", "ternary"])
def test_mxu_kernel_equals_popcount_kernel(cuda, mxu, popcount, m, k, n):
    gen = torch.Generator().manual_seed(k + n)
    x, w, _ = _operands(mxu, m, n, k, gen)
    dev = lambda ts: tuple(t.to(cuda) for t in ts)
    a = harness.gemm(mxu, dev(x), dev(w), None, None, k=k, out="acc")
    b = harness.gemm(popcount, dev(x), dev(w), None, None, k=k, out="acc")
    assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [4, 9, 256])
def test_ternary_kernel_ignores_sign_under_zero_mask(cuda, m):
    """Every sign bit set on both sides, a sparse mask: the gated XNOR
    reads a sign only where its mask is 1, so the kernel (the packed stream
    at 4 rows, the b1 tile at 9 and 256) equals the plain version and the
    same operands with the sign planes cut to their masks."""
    k, n = 1056, 200
    gen = torch.Generator().manual_seed(m)
    body = tgemm.TERNARY_POPCOUNT

    def sparse(rows):           # about one bit in eight
        a, b, c = (torch.randint(-2 ** 31, 2 ** 31 - 1, (rows, k // 32),
                                 dtype=torch.int32, generator=gen) for _ in range(3))
        return a & b & c

    xm, wm = sparse(m), sparse(n)
    xs, ws = (torch.full_like(t, -1) for t in (xm, wm))
    acc = harness.gemm(body, (xm.to(cuda), xs.to(cuda)), (wm.to(cuda), ws.to(cuda)),
                       None, None, k=k, out="acc")
    cut = harness.gemm(body, (xm.to(cuda), (xs & xm).to(cuda)),
                       (wm.to(cuda), (ws & wm).to(cuda)), None, None, k=k, out="acc")
    want = harness.gemm(body, (xm, xs), (wm, ws), None, None, k=k, out="acc")
    torch.cuda.synchronize()
    assert torch.equal(acc.cpu(), want) and torch.equal(cut.cpu(), want)


#: both K10 regimes (the streaming kernel up to 8 rows, the tensor-core
#: kernel above) at decode, verify and prefill rows, on each side of the
#: switch, with K a multiple of 128 (16-byte plane rows) or not (K = 160)
_PLANE_SHAPES = ([(1, 128, 96), (5, 256, 100), (33, 3072, 200)]
                 + [(m, k, 200) for m in (1, 4, 8, 9, 13, 16, 17, 40, 256)
                    for k in (128, 3072, 8192)]
                 + [(4, 160, 100), (40, 160, 100)])


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", _PLANE_SHAPES)
@pytest.mark.parametrize("body,direct", [(pgemm.PLANES_W4_I8A, i4gemm.INT4_W_I8A),
                                         (pgemm.PLANES_W8_I8A, i8gemm.I8_DOT)],
                         ids=["w4", "w8"])
def test_plane_kernel_truncations_and_direct(cuda, body, direct, m, k, n):
    gen = torch.Generator().manual_seed(m + k + n)
    x, w, (ws, as_, b) = _operands(body, m, n, k, gen)
    bits = body.w_stack
    dev = lambda ts: tuple(t.to(cuda) for t in ts)
    for p in range(1, bits + 1):                 # every truncation depth
        wp = (w[0][:p],)
        acc = harness.gemm(body, dev(x), dev(wp), None, None, k=k, out="acc")
        assert torch.equal(acc.cpu(), harness.gemm(body, x, wp, None, None, k=k,
                                                   out="acc")), p
        for bias in (None, b):
            got = harness.gemm(body, dev(x), dev(wp), ws.to(cuda), as_.to(cuda),
                               None if bias is None else bias.to(cuda), k=k)
            want = harness.gemm(body, x, wp, ws, as_, bias, k=k)
            assert torch.equal(got.cpu().view(torch.int16), want.view(torch.int16)), p
    codes = pack.unpack_planes_i8(w[0], k, bits)               # (N, K)
    wd = codes.T.contiguous() if direct.w_kmajor else pack.pack_int4(codes)
    want = harness.gemm(direct, dev(x), (wd.to(cuda),), None, None, k=k, out="acc")
    torch.cuda.synchronize()
    assert torch.equal(acc, want)
    # a strided stack is refused, not copied
    strided = torch.zeros((2 * bits, n, k // 32), dtype=torch.int32, device=cuda)[::2]
    with pytest.raises(ValueError, match="contiguous"):
        harness.gemm(body, dev(x), (strided,), None, None, k=k, out="acc")


#: the serve path's shapes and MHA / MQA, then T (a multiple of the 64-row
#: tile or not, up to a 2048-token prompt) x dh x GQA group g in {1, 3} x
#: causal or not
_FLASH_SHAPES = ([
    (1, 24, 8, 256, 128, True),      # the serve path's prefill (GQA g=3)
    (2, 4, 4, 128, 64, True),        # MHA
    (1, 4, 1, 512, 32, True),        # MQA, two 256-row plain blocks
    (2, 6, 2, 100, 64, False),       # ragged T, no mask
] + [(1, 2 * g, 2, t, dh, causal) for t in (64, 192, 200, 256, 2048)
     for dh in (64, 128) for g in (1, 3) for causal in (True, False)])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("b,h,hk,t,dh,causal", _FLASH_SHAPES)
def test_flash_kernel_matches_plain(cuda, dtype, tol, b, h, hk, t, dh, causal):
    rng = np.random.default_rng(t + dh)
    # (B, T, H, dh) activations, passed as (B, H, T, dh) views like the model
    q, k, v = (torch.from_numpy(rng.standard_normal((b, t, n, dh)).astype(np.float32)
                                ).to(dtype).transpose(1, 2) for n in (h, hk, hk))
    want = flash_attn.flash_attention(q, k, v, causal=causal)
    got = flash_attn.flash_attention(*(a.to(cuda) for a in (q, k, v)), causal=causal)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == dtype
    assert got.transpose(1, 2).is_contiguous()
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().numpy(),
                               rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,int8,tol", [(torch.float32, False, 2e-5),
                                            (torch.float32, True, 2e-5),
                                            (torch.bfloat16, False, 2e-2),
                                            (torch.bfloat16, True, 2e-2)])
@pytest.mark.parametrize("hq,hk,dh", [(24, 8, 128), (4, 2, 32), (4, 4, 64)])
def test_paged_kernel_matches_plain(cuda, dtype, int8, tol, hq, hk, dh):
    rng = np.random.default_rng(hq + dh)
    b, max_pages, page = 4, 8, 32
    num_pages = 1 + b * max_pages
    pos = np.asarray([0, 77, 160, 255], np.int32)
    pages = np.zeros((b, max_pages), np.int32)
    for r in range(b):
        live = pos[r] // page + 1
        pages[r, :live] = 1 + r * max_pages + np.arange(live)
    pages[:, :1] = 1                                   # an aliased first page
    q = torch.from_numpy(rng.standard_normal((b, hq, dh)).astype(np.float32)).to(dtype)
    shape = (num_pages, page, hk, dh)
    # K/V ~ N(0, 1), stored as the serve path stores them: in the compute
    # dtype, or int8 codes at the static KV scale
    pools = [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
             for _ in range(2)]
    if int8:
        pools = [torch.clamp(torch.round(t / 0.05), -127, 127).to(torch.int8)
                 for t in pools]
    else:
        pools = [t.to(dtype) for t in pools]
    args = (q, *pools, torch.from_numpy(pages), torch.from_numpy(pos))
    want = paged_attn.paged_flash_decode(*args)
    got = paged_attn.paged_flash_decode(*(a.to(cuda) for a in args))
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().numpy(),
                               rtol=tol, atol=tol)


def _paged_args(rng, dtype, int8, hq, hk, dh, pos, max_pages, page=32, rows=None):
    """q, pools, page table and positions of a paged decode: row r of the
    table owns pages 1 + r * max_pages, ..., as many as its position needs
    (`rows`: the table row each query reads, so that queries may share a
    slot's pages), the rest point at the scratch page 0; K/V ~ N(0, 1) in
    the compute dtype or as int8 codes at the static KV scale."""
    rows = list(range(len(pos))) if rows is None else rows
    slots = max(rows) + 1
    table = np.zeros((slots, max_pages), np.int32)
    for r in range(slots):
        live = max(p for p, rr in zip(pos, rows) if rr == r) // page + 1
        table[r, :live] = 1 + r * max_pages + np.arange(live)
    shape = (1 + slots * max_pages, page, hk, dh)
    pools = [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
             for _ in range(2)]
    if int8:
        pools = [torch.clamp(torch.round(t / 0.05), -127, 127).to(torch.int8)
                 for t in pools]
    else:
        pools = [t.to(dtype) for t in pools]
    q = torch.from_numpy(rng.standard_normal((len(pos), hq, dh)).astype(np.float32))
    return (q.to(dtype), *pools, torch.from_numpy(table[rows]),
            torch.from_numpy(np.asarray(pos, np.int32)))


def _paged_vs_plain(cuda, args, tol):
    want = paged_attn.paged_flash_decode(*args)
    got = paged_attn.paged_flash_decode(*(a.to(cuda) for a in args))
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().numpy(),
                               rtol=tol, atol=tol)
    return got


_PAGED_DTYPES = [(torch.float32, False, 2e-5), (torch.float32, True, 2e-5),
                 (torch.bfloat16, False, 2e-2), (torch.bfloat16, True, 2e-2)]
_PAGED_IDS = ["f32", "f32-int8kv", "bf16", "bf16-int8kv"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,int8,tol", _PAGED_DTYPES, ids=_PAGED_IDS)
@pytest.mark.parametrize("g", [1, 3, 4, 8])
@pytest.mark.parametrize("dh", [64, 128, 256])
def test_paged_kernel_heads_and_dims(cuda, dtype, int8, tol, g, dh):
    """Every G x dh instantiation, specialised or generic, with a row at
    position 0 and rows of one to three 64-token chunks."""
    rng = np.random.default_rng(g * 1000 + dh)
    args = _paged_args(rng, dtype, int8, 2 * g, 2, dh, [0, 63, 64, 190], 8)
    _paged_vs_plain(cuda, args, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,int8,tol", _PAGED_DTYPES, ids=_PAGED_IDS)
@pytest.mark.parametrize("dh", [128, 192])
def test_paged_kernel_wide_group(cuda, dtype, int8, tol, dh):
    """G = 12 query heads a kv head (nemotron-4-340b: 96 over 8, dh 192),
    its own instantiation."""
    rng = np.random.default_rng(dh)
    args = _paged_args(rng, dtype, int8, 24, 2, dh, [0, 77, 160, 255], 8)
    _paged_vs_plain(cuda, args, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,int8,tol", _PAGED_DTYPES, ids=_PAGED_IDS)
def test_paged_kernel_long_context(cuda, dtype, int8, tol):
    """A 2048-token cache (64 pages of 32): up to 32 chunks merged a row."""
    rng = np.random.default_rng(7)
    args = _paged_args(rng, dtype, int8, 24, 8, 128, [2047, 1000, 511, 1536], 64)
    _paged_vs_plain(cuda, args, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,int8,tol", _PAGED_DTYPES, ids=_PAGED_IDS)
def test_paged_kernel_verify_rows(cuda, dtype, int8, tol):
    """16 speculative verify rows that share one slot's pages at consecutive
    positions across a chunk boundary (120 .. 135): each within the bar of
    the plain version and bit-equal to a 1-row launch at its position (the
    decode step there)."""
    rng = np.random.default_rng(8)
    pos = list(range(120, 136))
    args = _paged_args(rng, dtype, int8, 24, 8, 128, pos, 8, rows=[0] * 16)
    got = _paged_vs_plain(cuda, args, tol)
    dev = [a.to(cuda) for a in args]
    for r in range(16):
        one = paged_attn.paged_flash_decode(dev[0][r:r + 1], dev[1], dev[2],
                                            dev[3][r:r + 1], dev[4][r:r + 1])
        assert torch.equal(one, got[r:r + 1]), r


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,int8", [(torch.float32, False), (torch.bfloat16, False),
                                        (torch.bfloat16, True)])
@pytest.mark.parametrize("hq,hk,dh", [(24, 8, 128), (16, 16, 128), (4, 2, 32), (10, 2, 96)])
def test_paged_kernel_batch_invariant(cuda, dtype, int8, hq, hk, dh):
    """Each row of a 4-row launch is bit-equal to its own 1-row launch, with
    the full table and with the table cut to the pages the row needs: the
    chunks and the merge order depend on the row's position alone."""
    rng = np.random.default_rng(hq + dh)
    pos = [0, 77, 160, 1500]
    q, kp, vp, pages, p = (a.to(cuda) for a in
                           _paged_args(rng, dtype, int8, hq, hk, dh, pos, 64))
    got = paged_attn.paged_flash_decode(q, kp, vp, pages, p)
    for r, pr in enumerate(pos):
        for width in (pages.shape[1], pr // 32 + 1):
            one = paged_attn.paged_flash_decode(
                q[r:r + 1], kp, vp, pages[r:r + 1, :width].contiguous(), p[r:r + 1])
            assert torch.equal(one, got[r:r + 1]), (r, width)


@pytest.mark.cuda
@pytest.mark.parametrize("g,m,k,n", [(3, 5, 256, 100), (8, 16, 2048, 352),
                                     (2, 33, 1024, 96)])
@pytest.mark.parametrize("body", [b for b in BODIES if not b.w_stack],
                         ids=lambda b: b.name)
def test_grouped_kernel_bit_equal_to_plain_and_ungrouped(cuda, body, g, m, k, n):
    _check_grouped(cuda, body, g, m, k, n)


def _check_grouped(cuda, body, g, m, k, n):
    """One grouped launch == its plain version == g ungrouped launches
    (int32 accumulator, and bf16 output with bias on and off)."""
    gen = torch.Generator().manual_seed(g * 1000 + m + n)
    parts = [_operands(body, m, n, k, gen) for _ in range(g)]
    x = tuple(torch.stack([p[0][j] for p in parts]) for j in range(body.n_x))
    w = tuple(torch.stack([p[1][j] for p in parts]) for j in range(body.n_w))
    ws, as_, b = (torch.stack([p[2][j] for p in parts]) for j in range(3))
    dev = lambda ts: tuple(t.to(cuda) for t in ts)
    before = body.grouped.launches
    acc = harness.gemm_grouped(body, dev(x), dev(w), None, None, k=k, out="acc")
    assert body.grouped.launches == before + 1
    assert torch.equal(acc.cpu(), harness.gemm_grouped(body, x, w, None, None, k=k,
                                                       out="acc"))
    for i in range(g):
        one = harness.gemm(body, dev(t[i] for t in x), dev(t[i] for t in w),
                           None, None, k=k, out="acc")
        assert torch.equal(acc[i], one), i
    for bias in (None, b):
        got = harness.gemm_grouped(body, dev(x), dev(w), ws.to(cuda), as_.to(cuda),
                                   None if bias is None else bias.to(cuda), k=k)
        want = harness.gemm_grouped(body, x, w, ws, as_, bias, k=k)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu().view(torch.int16), want.view(torch.int16))
        for i in range(g):
            one = harness.gemm(body, dev(t[i] for t in x), dev(t[i] for t in w),
                               ws[i].to(cuda), as_[i].to(cuda),
                               None if bias is None else bias[i].to(cuda), k=k)
            assert torch.equal(got[i].view(torch.int16), one.view(torch.int16)), i


#: K11's int8 and s4 bodies on both of their row tiles (16 rows up to 16,
#: 128 above): G = 1, 3 and 64 (deepseek-moe-16b's experts), ragged M on
#: each side of the switch, K ragged against the 16-byte loads (136, 264)
#: or not, N ragged (a multiple of 4 for the K-major int8 weights)
_GROUPED_TC = [(1, 4, 256, 100), (1, 130, 1024, 352), (3, 1, 136, 100),
               (3, 17, 264, 228), (3, 33, 512, 96), (64, 16, 512, 100),
               (64, 4, 256, 96), (64, 32, 136, 260)]


@pytest.mark.cuda
@pytest.mark.parametrize("g,m,k,n", _GROUPED_TC)
@pytest.mark.parametrize("body", [i8gemm.I8_DOT, i4gemm.INT4_W_I8A],
                         ids=lambda b: b.name)
def test_grouped_tc_bodies_bit_equal_to_plain_and_ungrouped(cuda, body, g, m, k, n):
    _check_grouped(cuda, body, g, m, k, n)


#: K7's and K8's grouped bodies on both row tiles: G = 1, 3 and 64, M on
#: each side of the 16-row switch (1, 4, 16 | 17, 33, 130), K a multiple of
#: the 32-k word, whole (2048) or ragged (32, 96, 160, 1408) against the
#: 128-k stage (4-byte loads), N ragged (100, 228)
_GROUPED_BITS = [(1, 1, 32, 100), (1, 130, 2048, 228), (1, 17, 96, 100),
                 (1, 33, 1408, 100), (3, 4, 160, 228), (3, 16, 1408, 100),
                 (3, 33, 96, 228), (3, 130, 160, 100), (3, 1, 2048, 228),
                 (64, 16, 2048, 100), (64, 4, 32, 228), (64, 17, 1408, 228)]


@pytest.mark.cuda
@pytest.mark.parametrize("g,m,k,n", _GROUPED_BITS)
@pytest.mark.parametrize("body", [bgemm.BINARY_MXU, tgemm.TERNARY_MXU,
                                  tgemm.TERNARY_W_I8A], ids=lambda b: b.name)
def test_grouped_bit_bodies_bit_equal_to_plain_and_ungrouped(cuda, body, g, m, k, n):
    _check_grouped(cuda, body, g, m, k, n)


#: K3's and K4's grouped bodies on both b1 row tiles (16 rows up to 16, 64
#: above): G = 1, 3 and 64, M on each side of both switches (1, 4, 16 | 17,
#: 33, 64 | 65, 130), K a multiple of the 32-k word, whole against the
#: 16-byte loads (1408: a partial last stage, 2048) or not (32, 96, 160: the
#: 4-byte loads), N ragged (100, 228)
_GROUPED_POP = [(1, 1, 32, 100), (1, 130, 2048, 228), (1, 17, 96, 100),
                (1, 65, 1408, 228), (3, 4, 160, 228), (3, 16, 1408, 100),
                (3, 33, 96, 228), (3, 64, 2048, 100), (3, 130, 160, 100),
                (3, 1, 1408, 228), (64, 16, 2048, 100), (64, 4, 32, 228),
                (64, 17, 1408, 228), (64, 65, 96, 100)]


@pytest.mark.cuda
@pytest.mark.parametrize("g,m,k,n", _GROUPED_POP)
@pytest.mark.parametrize("body", [bgemm.BINARY_POPCOUNT, tgemm.TERNARY_POPCOUNT],
                         ids=lambda b: b.name)
def test_grouped_pop_bodies_bit_equal_to_plain_and_ungrouped(cuda, body, g, m, k, n):
    _check_grouped(cuda, body, g, m, k, n)


@pytest.mark.cuda
@pytest.mark.parametrize("g,m,k,n", [(3, 4, 160, 228), (64, 16, 1408, 100),
                                     (3, 17, 2048, 100), (2, 130, 96, 228),
                                     (64, 16, 2048, 2816)])
@pytest.mark.parametrize("mxu,popcount", [
    (bgemm.BINARY_MXU, bgemm.BINARY_POPCOUNT),
    (tgemm.TERNARY_MXU, tgemm.TERNARY_POPCOUNT)], ids=["binary", "ternary"])
def test_grouped_mxu_kernel_equals_grouped_popcount_kernel(cuda, mxu, popcount, g, m,
                                                           k, n):
    """A grouped mxu launch (K7's int8 tile) and a grouped popcount launch
    (K3 / K4, the b1 tile) on the same operands give the same int32
    accumulators; the last case is deepseek-moe-16b's up projection at the
    4-slot decode tick."""
    gen = torch.Generator().manual_seed(g + m + k + n)
    parts = [_operands(mxu, m, n, k, gen) for _ in range(g)]
    x = tuple(torch.stack([p[0][j] for p in parts]).to(cuda) for j in range(mxu.n_x))
    w = tuple(torch.stack([p[1][j] for p in parts]).to(cuda) for j in range(mxu.n_w))
    a = harness.gemm_grouped(mxu, x, w, None, None, k=k, out="acc")
    b = harness.gemm_grouped(popcount, x, w, None, None, k=k, out="acc")
    assert torch.equal(a, b)


def _grouped_planes(g, m, k, n, bits, gen):
    """Operands of a grouped plane GEMM: int8 activations (g, m, k), a full
    (g, bits, n, k/32) plane stack with every bit pattern, scales and bias."""
    x = torch.randint(-127, 128, (g, m, k), dtype=torch.int8, generator=gen)
    stack = torch.randint(-2 ** 31, 2 ** 31 - 1, (g, bits, n, k // 32),
                          dtype=torch.int32, generator=gen)
    return (x, stack, torch.rand(g, n, generator=gen) * 0.1 + 1e-3,
            torch.rand(g, m, generator=gen) + 0.1, torch.randn(g, n, generator=gen))


#: K10 over expert stacks on both row tiles: a 1-slot and a 4-slot decode
#: slab and a prefill slab, G = 3 and 64, N ragged, K a multiple of the
#: 128-k stage (16-byte weight loads) or not (4-byte loads)
_GROUPED_PLANES = [(3, 4, 256, 100), (3, 16, 1056, 96), (64, 16, 512, 72),
                   (3, 128, 512, 200), (2, 33, 1024, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("g,m,k,n", _GROUPED_PLANES)
@pytest.mark.parametrize("body,direct", [(pgemm.PLANES_W4_I8A, i4gemm.INT4_W_I8A),
                                         (pgemm.PLANES_W8_I8A, i8gemm.I8_DOT)],
                         ids=lambda b: b.name)
def test_grouped_plane_kernel_bit_equal_to_plain_ungrouped_and_direct(
        cuda, body, direct, g, m, k, n):
    """One grouped plane launch == its plain version == g ungrouped K10
    launches, at P = 1 and bits (a view of the full stack), int32
    accumulator and bf16 output with bias on and off; at P = bits == K11's
    direct body on the composed codes."""
    bits = body.w_stack
    gen = torch.Generator().manual_seed(g * 1000 + m + n + bits)
    x, stack, ws, as_, b = _grouped_planes(g, m, k, n, bits, gen)
    xd, sd = x.to(cuda), stack.to(cuda)
    for p in (1, bits):
        w, wd = stack[:, :p], sd[:, :p]
        before = harness.GEMM_GROUPED_PLANES.launches
        acc = harness.gemm_grouped(body, (xd,), (wd,), None, None, k=k, out="acc")
        assert harness.GEMM_GROUPED_PLANES.launches == before + 1
        assert torch.equal(acc.cpu(), harness.gemm_grouped(body, (x,), (w,), None,
                                                           None, k=k, out="acc"))
        for i in range(g):
            one = harness.gemm(body, (xd[i],), (wd[i].contiguous(),), None, None,
                               k=k, out="acc")
            assert torch.equal(acc[i], one), (p, i)
        for bias in (None, b):
            bd = None if bias is None else bias.to(cuda)
            got = harness.gemm_grouped(body, (xd,), (wd,), ws.to(cuda), as_.to(cuda),
                                       bd, k=k)
            want = harness.gemm_grouped(body, (x,), (w,), ws, as_, bias, k=k)
            torch.cuda.synchronize()
            assert torch.equal(got.cpu().view(torch.int16), want.view(torch.int16))
            for i in range(g):
                one = harness.gemm(body, (xd[i],), (wd[i].contiguous(),),
                                   ws[i].to(cuda), as_[i].to(cuda),
                                   None if bd is None else bd[i], k=k)
                assert torch.equal(got[i].view(torch.int16), one.view(torch.int16))
    codes = pack.unpack_planes_i8(sd, k, bits)                  # (g, n, k)
    wdir = (codes.transpose(-1, -2).contiguous() if bits == 8
            else pack.pack_int4(codes))
    before = harness.GEMM_GROUPED.launches
    dacc = harness.gemm_grouped(direct, (xd,), (wdir,), None, None, k=k, out="acc")
    assert harness.GEMM_GROUPED.launches == before + 1
    assert torch.equal(acc, dacc)


@pytest.mark.cuda
def test_grouped_plane_kernel_reads_truncated_view_in_place(cuda):
    """A draft's `stack[:, :P]` (expert stride bits planes, not P) goes to
    the launch as it is: the only allocation is the output, and the result
    equals the launch on a contiguous copy; any other strided stack is
    refused."""
    body, (g, m, k, n) = pgemm.PLANES_W8_I8A, (16, 16, 2048, 2816)
    gen = torch.Generator().manual_seed(5)
    x, stack, ws, as_, _ = _grouped_planes(g, m, k, n, 8, gen)
    xd, sd, wsd, asd = x.to(cuda), stack.to(cuda), ws.to(cuda), as_.to(cuda)
    for p in (1, 3):
        view = sd[:, :p]
        assert not view.is_contiguous() and view.stride(0) == 8 * n * (k // 32)
        harness.gemm_grouped(body, (xd,), (view,), wsd, asd, k=k)   # warm
        torch.cuda.synchronize()
        before = torch.cuda.memory_stats()
        got = harness.gemm_grouped(body, (xd,), (view,), wsd, asd, k=k)
        torch.cuda.synchronize()
        after = torch.cuda.memory_stats()
        # one allocation, the output's bytes (the allocator may hand out a
        # larger cached block, so bytes are read as requested)
        assert (after["allocation.all.allocated"]
                - before["allocation.all.allocated"]) == 1
        key = "requested_bytes.all.allocated"
        if key in after:
            assert after[key] - before[key] == got.numel() * got.element_size()
        want = harness.gemm_grouped(body, (xd,), (view.contiguous(),), wsd, asd, k=k)
        assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    for bad in (sd[:, 1:3], sd[::2, :2], sd[:, :2, ::2]):
        xs = xd[:bad.shape[0]]                      # contiguous activations
        with pytest.raises(ValueError, match="contiguous"):
            harness.gemm_grouped(body, (xs,), (bad,), None, None, k=k, out="acc")


#: every grouped launcher's count, by the name `kernels.KERNELS` gives it
_GROUPED = {"gemm_grouped": harness.GEMM_GROUPED,
            "gemm_grouped_pop": harness.GEMM_GROUPED_POP,
            "gemm_grouped_planes": harness.GEMM_GROUPED_PLANES,
            "gemm_grouped_mxu": harness.GEMM_GROUPED_MXU,
            "gemm_grouped_wt_i8a": harness.GEMM_GROUPED_WT_I8A}


def _reduced_moe_serve(cuda, arch, policy, slots, lens=(3, 9, 14, 5, 30, 1), *,
                       impl="popcount", spec_draft=None):
    """Reduced `arch` (3 layers) served from the port's seeded init; returns
    (tokens by request, stats, the grouped launches by launcher name, those
    that launched)."""
    from repro_torch.launch.serve import Request, Server
    from repro_torch.models import transformer
    from repro_torch.models.common import ModelCtx
    cfg = dataclasses.replace(get_config(arch).reduced(), policy=policy, n_layers=3)
    gen = torch.Generator(device=cuda).manual_seed(0)
    sp = transformer.pack_for_serve(transformer.init(cfg, gen, cuda), cfg,
                                    plane_twins=True)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab, size=(n,)).astype(np.int32) for n in lens]
    srv = Server(cfg, sp, slots=slots, cache_len=64, page_size=8,
                 ctx=ModelCtx(impl=impl), device=cuda, spec_draft=spec_draft)
    for i, p in enumerate(prompts):
        srv.submit(Request(i, p, 8, seed=i))
    before = {name: k.launches for name, k in _GROUPED.items()}
    srv.run()
    grouped = {name: k.launches - before[name] for name, k in _GROUPED.items()}
    return ({r.rid: r.out for r in srv.completed}, srv.stats,
            {name: c for name, c in grouped.items() if c})


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["het", "int8", "ternary", "w-ternary", "wt-a8"])
@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "phi3.5-moe-42b-a6.6b"])
def test_reduced_moe_serve_batched_equals_sequential_on_card(cuda, arch, policy):
    toks, st, grouped = _reduced_moe_serve(cuda, arch, policy, 4)
    assert toks == _reduced_moe_serve(cuda, arch, policy, 1)[0]
    assert st["moe_routed"] == sum(st["moe_expert_tokens"]) + st["moe_dropped"] > 0
    calls = st["prefills"] + st["decode_ticks"]
    # every W&A expert projection is one grouped launch on its form's count
    # (het, int8: all 2 x 3 on K11's; ternary: on K3 / K4's; wt-a8: its first
    # and last layers' int8 experts on K11's, the body layer's 2 on K8's);
    # weight-only none
    per_call = {"het": {"gemm_grouped": 6}, "int8": {"gemm_grouped": 6},
                "ternary": {"gemm_grouped_pop": 6}, "w-ternary": {},
                "wt-a8": {"gemm_grouped": 4, "gemm_grouped_wt_i8a": 2}}[policy]
    assert grouped == {n: c * calls for n, c in per_call.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["binary", "ternary"])
@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "phi3.5-moe-42b-a6.6b"])
def test_reduced_moe_serve_mxu_equals_popcount_on_card(cuda, arch, policy):
    """--impl mxu: every expert projection one grouped mxu launch (K7's
    tile), tokens == the popcount formulation's (one grouped popcount
    launch, K3 / K4, per expert projection), 4-slot == 1-slot."""
    toks, st, grouped = _reduced_moe_serve(cuda, arch, policy, 4, impl="mxu")
    pop, pst, pgrouped = _reduced_moe_serve(cuda, arch, policy, 4)
    assert toks == pop
    assert toks == _reduced_moe_serve(cuda, arch, policy, 1, impl="mxu")[0]
    assert grouped == {"gemm_grouped_mxu": 2 * 3 * (st["prefills"] + st["decode_ticks"])}
    assert pgrouped == {"gemm_grouped_pop": 2 * 3 * (pst["prefills"] + pst["decode_ticks"])}


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["het", "int8"])
@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "phi3.5-moe-42b-a6.6b"])
def test_reduced_moe_serve_planes_and_spec_on_card(cuda, arch, policy):
    """--impl planes: every expert projection one grouped plane launch,
    tokens == the direct cells', 4-slot == 1-slot; a planes:1 draft: spec
    tokens == sequential tokens, the draft's expert projections on the
    grouped plane launch, the verify step's on K11."""
    direct = _reduced_moe_serve(cuda, arch, policy, 4)[0]
    toks, st, grouped = _reduced_moe_serve(cuda, arch, policy, 4, impl="planes")
    assert toks == direct
    assert toks == _reduced_moe_serve(cuda, arch, policy, 1, impl="planes")[0]
    assert grouped == {"gemm_grouped_planes": 2 * 3 * (st["prefills"] + st["decode_ticks"])}
    toks, st, grouped = _reduced_moe_serve(cuda, arch, policy, 4, spec_draft="planes:1")
    assert toks == direct and st["spec_ticks"] > 0
    assert set(grouped) == {"gemm_grouped", "gemm_grouped_planes"}
    assert st["moe_routed"] == sum(st["moe_expert_tokens"]) + st["moe_dropped"] > 0


def _reduced_serve(cuda, policy, slots, *, impl="popcount", kv="bfloat16",
                   lens=(3, 9, 14, 5, 30, 1), n_layers=4, cache_len=64,
                   spec_draft=None, spec_k=4):
    from repro_torch.launch.serve import Request, Server
    from repro_torch.models import transformer
    from repro_torch.models.common import ModelCtx
    cfg = dataclasses.replace(get_config("llama3.2-3b").reduced(), policy=policy,
                              n_layers=n_layers, kv_cache_dtype=kv)
    gen = torch.Generator(device=cuda).manual_seed(0)
    sp = transformer.pack_for_serve(transformer.init(cfg, gen, cuda), cfg,
                                    plane_twins=impl == "planes" or bool(spec_draft))
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab, size=(n,)).astype(np.int32) for n in lens]
    srv = Server(cfg, sp, slots=slots, cache_len=cache_len, page_size=8,
                 ctx=ModelCtx(impl=impl), device=cuda, spec_draft=spec_draft,
                 spec_k=spec_k)
    for i, p in enumerate(prompts):
        srv.submit(Request(i, p, 8, seed=i))
    srv.run()
    assert srv.spec == bool(spec_draft)
    return {r.rid: r.out for r in srv.completed}


@pytest.mark.cuda
@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_reduced_serve_batched_equals_sequential_on_card(cuda, policy):
    assert _reduced_serve(cuda, policy, 4) == _reduced_serve(cuda, policy, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["binary", "ternary", "mixed"])
def test_reduced_serve_mxu_equals_popcount_on_card(cuda, policy):
    assert (_reduced_serve(cuda, policy, 4, impl="mxu")
            == _reduced_serve(cuda, policy, 4, impl="popcount"))


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["int8", "w-ternary"])
def test_reduced_serve_int8_kv_and_long_prompt_on_card(cuda, policy):
    """An int8 KV pool, and prompts of 129-256 tokens, whose prefill runs
    the flash-attention kernel (bucket 256), batched == sequential."""
    kw = dict(kv="int8", lens=(3, 200, 9, 150, 140), n_layers=2, cache_len=256)
    assert _reduced_serve(cuda, policy, 4, **kw) == _reduced_serve(cuda, policy, 1, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["int8", "w4a8", "het"])
def test_reduced_serve_planes_equals_direct_on_card(cuda, policy):
    planes = _reduced_serve(cuda, policy, 4, impl="planes")
    assert planes == _reduced_serve(cuda, policy, 4)
    assert planes == _reduced_serve(cuda, policy, 1, impl="planes")


@pytest.mark.cuda
@pytest.mark.parametrize("draft", ["planes:1", "planes:8"])
@pytest.mark.parametrize("policy", ["int8", "w4a8", "binary"])
def test_reduced_serve_spec_equals_sequential_on_card(cuda, policy, draft):
    assert (_reduced_serve(cuda, policy, 4, spec_draft=draft, spec_k=4)
            == _reduced_serve(cuda, policy, 4))


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["int8", "ternary"])
def test_verify_rows_equal_decode_steps_on_card(cuda, policy):
    """Each verify row reads attention through the paged-decode kernel, as
    a sequential decode step does, so on the card its logits are bit-equal
    to the decode step's at the same position (bf16 compute)."""
    from repro_torch.models import transformer
    from repro_torch.models.common import ModelCtx
    cfg = dataclasses.replace(get_config("llama3.2-3b").reduced(), policy=policy,
                              n_layers=4)
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = transformer.pack_for_serve(transformer.init(cfg, gen, cuda), cfg)
    sp = transformer.build_specs(cfg)
    ctx = ModelCtx()
    b, page, max_pages, kwin = 3, 8, 8, 4
    pages = (1 + torch.arange(b * max_pages, dtype=torch.int32, device=cuda)
             ).reshape(b, max_pages)
    pool = transformer.init_cache(cfg, 1 + b * max_pages, page, kv_dtype=torch.bfloat16,
                                  device=cuda)
    rng = np.random.default_rng(4)
    pos0 = torch.tensor([5, 17, 30], dtype=torch.int32, device=cuda)
    # fill the pool below pos0 with K/V written by sequential decode steps
    for t in range(int(pos0.max())):
        tok = torch.from_numpy(rng.integers(0, cfg.vocab, (b, 1)).astype(np.int32))
        transformer.decode_step(params, pool, tok.to(cuda),
                                torch.minimum(torch.full_like(pos0, t), pos0 - 1),
                                sp, ctx, pages=pages)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (b, kwin)).astype(np.int32)).to(cuda)
    nreal = torch.tensor([4, 2, 3], dtype=torch.int32, device=cuda)
    vpool = [{k: v.clone() for k, v in c.items()} for c in pool]
    vl, _ = transformer.decode_verify(params, vpool, toks, pos0, sp, ctx,
                                      read_pages=pages, write_pages=pages, nreal=nreal)
    for t in range(kwin):
        dl, pool = transformer.decode_step(params, pool, toks[:, t:t + 1], pos0 + t,
                                           sp, ctx, pages=pages)
        for r in range(b):
            if t < int(nreal[r]):
                assert torch.equal(vl[r, t], dl[r, 0]), (r, t)
