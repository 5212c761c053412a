"""The port's bit-plane cells (K10), `--impl planes` and self-speculative
decoding against the JAX package, in f32 on the CPU.

Bars:
  * plane packing: `pack_planes` / `unpack_planes_i8` bit-identical to the
    JAX codec for int4 and int8 (sign-bit words, an expert axis, every
    truncation depth P), the truncation equal to the arithmetic-shift
    floor, the coefficients, and the K-quantum rejections (twins of
    tests/test_core.py's plane tests);
  * plane cells: at P in {1, 2, bits}, bias on and off, M in {1, 4, 9}, the
    plain version's int32 accumulator and bf16 output are bit-equal to the
    JAX Pallas PLANES_* body (interpret; its bf16 wherever the Pallas
    epilogue is not FMA-contracted, ROADMAP queue 3) and to the jnp
    `_acc_planes`, and at P = bits to the direct int4/int8 cells (a
    fixed-seed twin of
    tests/test_dispatch.py::test_plane_truncation_matches_snapped_code_oracle);
  * `decode_verify` logits allclose to the JAX `decode_verify` (4 layers),
    and verify row t allclose to the port's sequential decode at pos0 + t;
  * serving: speculative tokens == the JAX server's sequential tokens ==
    the port's sequential tokens under binary, ternary, int8 and w4a8 (and
    == sequential at temperature 0.8), an EOS inside the window, the int8-KV fallback, and `--impl planes`
    tokens == popcount tokens == the JAX server's under int8, w4a8, het.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import CACHE_LEN, PAGE_SIZE, built, np_tree, prompts
from _torch_port import one_torch_thread  # noqa: F401
from repro.core import pack as jpack
from repro.core import qlinear as jqlinear
from repro.core.precision import LayerQuant as JLayerQuant
from repro.core.quantize import QuantSpec as JQuantSpec
from repro.kernels import dispatch as jdispatch
from repro.kernels import harness as jharness
from repro.launch.serve import Request as JRequest
from repro.launch.serve import Server as JServer
from repro.models import transformer as jtransformer
from repro.models.common import ModelCtx as JCtx
from repro_torch import bridge
from repro_torch.bridge import to_torch
from repro_torch.core import pack as tpack
from repro_torch.core import qlinear as tqlinear
from repro_torch.core.precision import LayerQuant
from repro_torch.core.quantize import QuantSpec
from repro_torch.kernels import dispatch as tdispatch
from repro_torch.kernels import harness as tharness
from repro_torch.launch import serve as tserve
from repro_torch.models import transformer
from repro_torch.models.common import ModelCtx, operating_point

CTX = ModelCtx(dtype=torch.float32)
JCTX = JCtx(mode="serve", backend="jnp", dtype=jnp.float32)
PROMPT_LENS = (3, 9, 14, 5)
MAX_NEW = 6


def _rand_codes(rng, bits, shape):
    lo, hi = -(1 << (bits - 1)), (1 << (bits - 1)) - 1
    return rng.integers(lo, hi + 1, size=shape).astype(np.int8)


def _bits16(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(a).view(np.uint16)


# -- packing ------------------------------------------------------------------

@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("lead", [(), (2,)], ids=["matrix", "experts"])
def test_pack_planes_bit_identical_to_jax(bits, lead):
    rng = np.random.default_rng(bits * 10 + len(lead))
    codes = _rand_codes(rng, bits, lead + (6, 96))
    codes[..., 0, 0] = -(1 << (bits - 1))         # the sign plane's extreme
    codes[..., 0, 1] = (1 << (bits - 1)) - 1
    codes[..., 1, 31] = -1                        # bit 31 set on every plane
    j = np.asarray(jpack.pack_planes(jnp.asarray(codes), bits))
    t = tpack.pack_planes(torch.from_numpy(codes), bits)
    assert t.dtype == torch.int32 and tuple(t.shape) == lead + (bits, 6, 3)
    np.testing.assert_array_equal(t.numpy(), j.view(np.int32))
    assert (t.numpy() < 0).any()                  # words with the sign bit
    for keep in range(1, bits + 1):
        jt = np.asarray(jpack.unpack_planes_i8(jnp.asarray(j)[..., :keep, :, :],
                                               96, bits))
        tt = tpack.unpack_planes_i8(t[..., :keep, :, :], 96, bits).numpy()
        np.testing.assert_array_equal(tt, jt, err_msg=f"keep={keep}")
        floor = (codes.astype(np.int32) >> (bits - keep)) << (bits - keep)
        np.testing.assert_array_equal(tt.astype(np.int32), floor)
    np.testing.assert_array_equal(tpack.unpack_planes_i8(t, 96, bits).numpy(), codes)


def test_plane_coeffs_and_k_quantum():
    for bits in (2, 4, 8):
        assert tpack.plane_coeffs(bits) == jpack.plane_coeffs(bits)
    assert tpack.plane_coeffs(4) == (-8, 4, 2, 1)
    for bad in (1, 9):
        with pytest.raises(ValueError):
            tpack.plane_coeffs(bad)
    assert tpack.PLANE_BITS == jpack.PLANE_BITS
    assert tpack.K_QUANTUM == jpack.K_QUANTUM
    assert tpack.K_QUANTUM["w_planes"] == tpack.WORD
    with pytest.raises(ValueError):
        tpack.pack_planes(torch.zeros((4, 33), dtype=torch.int8), 4)
    with pytest.raises(ValueError):
        tpack.pack_planes(torch.zeros((64,), dtype=torch.int8), 4)


@pytest.mark.parametrize("policy", ["int8", "w4a8", "het"])
def test_pack_for_serve_plane_twins_match(policy):
    """pack_for_serve(plane_twins=True) keeps the twin, bit for bit the
    JAX one, on every int4/int8 x int8 layer; the default strips it."""
    jcfg, tcfg, params, _ = built(policy)
    want = bridge.from_jax_params(
        np_tree(jtransformer.pack_for_serve(params, jcfg, plane_twins=True)), tcfg)
    tparams = bridge.from_jax_params(np_tree(params), tcfg)
    got = transformer.pack_for_serve(tparams, tcfg, plane_twins=True)
    want_planes, got_planes = _planes_of(want), _planes_of(got)
    assert sorted(got_planes) == sorted(want_planes) and want_planes
    for path, w in want_planes.items():
        assert torch.equal(got_planes[path], w), path
    assert not _planes_of(transformer.pack_for_serve(tparams, tcfg))


def _planes_of(tree, path=()):
    """path -> w_planes tensor, over a nested dict/list param tree."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return {}
    out = {}
    for k, v in items:
        if k == "w_planes":
            out[path] = v
        else:
            out.update(_planes_of(v, path + (k,)))
    return out


# -- plane cells ---------------------------------------------------------------

def _cell_setup(wprec, m, k, n, bias, seed):
    rng = np.random.default_rng(seed)
    jspec = jqlinear.QLinearSpec(k, n, JLayerQuant(JQuantSpec(wprec), JQuantSpec("int8")),
                                 use_bias=bias)
    tspec = tqlinear.QLinearSpec(k, n, LayerQuant(QuantSpec(wprec), QuantSpec("int8")),
                                 use_bias=bias)
    p = {"w": jnp.asarray((rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32))}
    if bias:
        p["b"] = jnp.asarray(rng.standard_normal(n).astype(np.float32))
    packed = jqlinear.pack_params(p, jspec)
    x = jnp.asarray(rng.standard_normal((m, k)).astype(np.float32))
    return jspec, tspec, packed, x


@pytest.mark.parametrize("m", [1, 4, 9])
@pytest.mark.parametrize("keep", [1, 2, "bits"])
@pytest.mark.parametrize("wprec", ["int4", "int8"])
def test_plane_cells_bit_equal_to_pallas_and_jnp(wprec, keep, m):
    bits = jpack.PLANE_BITS[wprec]
    keep = bits if keep == "bits" else keep
    k, n = 128, 96
    for bias in (False, True):
        jspec, tspec, packed, x = _cell_setup(wprec, m, k, n, bias, seed=m + keep + bias)
        jcell = jdispatch.lookup(jdispatch.OperatingPoint(wprec, "int8", "planes"))
        x_ops, a_scale = jcell.prep(x, packed, jspec)
        w_ops = (packed["w_planes"][:keep],)
        jb = packed.get("b")
        acc_pallas = jharness.gemm(jcell.body, x_ops, w_ops, None, None, k=k,
                                   interpret=True, out="acc")
        out_pallas = jharness.gemm(jcell.body, x_ops, w_ops, packed["w_scale"],
                                   a_scale, jb, k=k, interpret=True)
        acc_jnp = jcell.acc(x_ops, w_ops, k)
        out_jnp = jharness.requant(acc_jnp, packed["w_scale"], a_scale,
                                   jb).astype(jnp.bfloat16)
        tcell = tdispatch.lookup(tdispatch.OperatingPoint(wprec, "int8", "planes"))
        tx = tuple(to_torch(np.asarray(o)) for o in x_ops)
        tw = (to_torch(np.asarray(packed["w_planes"]))[:keep],)
        ws, asc = to_torch(np.asarray(packed["w_scale"])), to_torch(np.asarray(a_scale))
        tbias = to_torch(np.asarray(jb)) if bias else None
        acc = tharness.gemm(tcell.body, tx, tw, None, None, k=k, out="acc")
        out = tharness.gemm(tcell.body, tx, tw, ws, asc, tbias, k=k)
        np.testing.assert_array_equal(acc.numpy(), np.asarray(acc_pallas))
        np.testing.assert_array_equal(acc.numpy(), np.asarray(acc_jnp))
        np.testing.assert_array_equal(_bits16(out), _bits16(out_jnp))
        # the Pallas epilogue may FMA-contract `* a_scale + bias` (ROADMAP
        # queue 3): where it differs from its own jnp formulation, it is the
        # once-rounded FMA value; everywhere else the port equals it
        agree = _bits16(out_pallas) == _bits16(out_jnp)
        np.testing.assert_array_equal(_bits16(out)[agree], _bits16(out_pallas)[agree])
        if not agree.all():
            y = np.asarray(acc_jnp).astype(np.float32) * np.asarray(packed["w_scale"])[None, :]
            fma = (y.astype(np.float64) * np.asarray(a_scale)[:, None]
                   + np.asarray(jb)[None, :]).astype(np.float32)
            np.testing.assert_array_equal(
                _bits16(out_pallas)[~agree],
                _bits16(torch.from_numpy(fma).to(torch.bfloat16))[~agree])
        # through qgemm with the truncation as an OperatingPoint, each side
        # from its own activation prep and packed weights
        tp = {nm: to_torch(np.asarray(v)) for nm, v in packed.items()}
        op = tdispatch.OperatingPoint(wprec, "int8", "planes", planes=keep)
        got = tdispatch.qgemm(tp, to_torch(np.asarray(x)), tspec, op)
        want = jdispatch.qgemm(packed, x, jspec, dataclasses.replace(
            jdispatch.OperatingPoint.for_spec(jspec, impl="planes"), planes=keep))
        np.testing.assert_array_equal(_bits16(got), _bits16(want))
        if keep == bits:
            direct = tdispatch.qgemm(tp, to_torch(np.asarray(x)), tspec,
                                     tdispatch.OperatingPoint(wprec, "int8"))
            np.testing.assert_array_equal(_bits16(got), _bits16(direct))


def test_plane_truncation_errors_and_op_resolution():
    _, tspec, packed, _ = _cell_setup("int4", 2, 64, 32, False, seed=0)
    tp = {nm: to_torch(np.asarray(v)) for nm, v in packed.items()}
    x = torch.zeros((2, 64))
    with pytest.raises(ValueError, match="outside the stored stack"):
        tdispatch.qgemm(tp, x, tspec, tdispatch.OperatingPoint("int4", "int8", "planes",
                                                               planes=5))
    with pytest.raises(ValueError, match="plane-composed"):
        tdispatch.qgemm(tp, x, tspec, tdispatch.OperatingPoint("int4", "int8", planes=1))
    with pytest.raises(ValueError):
        tdispatch.OperatingPoint("int4", "int8", "planes", planes=0)
    tp.pop("w_planes")
    with pytest.raises(KeyError, match="plane_twins=True"):
        tdispatch.qgemm(tp, x, tspec, tdispatch.OperatingPoint("int4", "int8", "planes"))
    assert (tdispatch.OperatingPoint("int8", "int8", "planes", planes=2).tag
            == "wint8/aint8/planes:p2")
    # per-layer resolution: a pair without a plane cell runs its default
    # cell, and the draft depth is clamped to the layer's bits
    bin_spec = tqlinear.QLinearSpec(64, 32, LayerQuant(QuantSpec("binary"),
                                                       QuantSpec("binary")))
    draft = ModelCtx(impl="planes", draft_planes=8)
    assert operating_point(bin_spec, draft) == tdispatch.OperatingPoint(
        "binary", "binary", "popcount")
    assert operating_point(tspec, draft).planes == 4
    assert operating_point(tspec, ModelCtx(impl="planes")).planes is None


# -- the verify step ---------------------------------------------------------------

def _tables(b):
    max_pages = CACHE_LEN // PAGE_SIZE
    pages = np.zeros((b, max_pages), np.int32)
    for r in range(b):
        pages[r] = 1 + r * max_pages + np.arange(max_pages)
    return pages


@pytest.mark.parametrize("policy", ["int8", "w4a8"])
def test_decode_verify_matches_jax_and_sequential_decode(policy):
    """Prefill two prompts into identical paged pools, then one 3-token
    verify step (slot 1 verifies only 2) on both sides: logits allclose to
    JAX's; then the port's sequential decode over the same tokens gives
    each verify row's logits at pos0 + t."""
    jcfg, tcfg, _, sparams = built(policy, n_layers=4)
    jsp, tsp = jtransformer.build_specs(jcfg), transformer.build_specs(tcfg)
    tp = bridge.from_jax_params(np_tree(sparams), tcfg)
    lens = np.asarray([9, 14], np.int32)
    b, bucket, kwin = 2, 16, 3
    toks = np.zeros((b, bucket), np.int32)
    for r, p in enumerate(prompts(jcfg, lens)):
        toks[r, :len(p)] = p
    _, tc = transformer.prefill(tp, torch.from_numpy(toks), tsp, CTX,
                                cache_len=CACHE_LEN, last_pos=lens - 1)
    pages = _tables(b)
    num_pages = 1 + int(pages.max())
    pool = transformer.init_cache(tcfg, num_pages, PAGE_SIZE, kv_dtype=torch.float32)
    for li, c in enumerate(tc):
        for name in ("k", "v"):
            body = c[name].reshape(b, -1, PAGE_SIZE, *c[name].shape[2:])
            for r in range(b):
                pool[li][name][torch.from_numpy(pages[r]).long()] = body[r]

    def jpool(tpool):
        flat = [{nm: jnp.asarray(c[nm].numpy()) for nm in ("k", "v")} for c in tpool]
        return {"first": flat[0], "last": flat[-1],
                "mid": {"b0": {nm: jnp.stack([flat[1][nm], flat[2][nm]])
                               for nm in ("k", "v")}}}

    def clone(tpool):
        return [{nm: c[nm].clone() for nm in ("k", "v")} for c in tpool]

    rng = np.random.default_rng(5)
    vt = rng.integers(0, jcfg.vocab, size=(b, kwin)).astype(np.int32)
    pos0, nreal = lens.copy(), np.asarray([3, 2], np.int32)
    jverify = jax.jit(lambda p, c, t, p0, pg, nr: jtransformer.decode_verify(
        p, c, t, p0, jsp, JCTX, read_pages=pg, write_pages=pg, nreal=nr))
    jl, _ = jverify(sparams, jpool(pool), jnp.asarray(vt), jnp.asarray(pos0),
                    jnp.asarray(pages), jnp.asarray(nreal))
    tpages = torch.from_numpy(pages)
    tl, _ = transformer.decode_verify(tp, clone(pool), torch.from_numpy(vt),
                                      torch.from_numpy(pos0), tsp, CTX,
                                      read_pages=tpages, write_pages=tpages,
                                      nreal=torch.from_numpy(nreal))
    assert tuple(tl.shape) == (b, kwin, tcfg.vocab)
    valid = np.arange(kwin)[None, :] < nreal[:, None]
    np.testing.assert_allclose(tl.numpy()[valid], np.asarray(jl)[valid],
                               rtol=1e-4, atol=1e-4)
    seq = clone(pool)
    for t in range(kwin):
        dl, seq = transformer.decode_step(tp, seq, torch.from_numpy(vt[:, t:t + 1]),
                                          torch.from_numpy(pos0 + t), tsp, CTX,
                                          pages=tpages)
        for r in range(b):
            if t < nreal[r]:
                np.testing.assert_allclose(tl[r, t].numpy(), dl[r, 0].numpy(),
                                           rtol=1e-5, atol=1e-5)


# -- serving -------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_tokens(policy, lens=PROMPT_LENS, kv="bfloat16"):
    jcfg, _, _, sparams = built(policy)
    srv = JServer(dataclasses.replace(jcfg, kv_cache_dtype=kv), sparams, slots=2,
                  cache_len=CACHE_LEN, page_size=PAGE_SIZE, ctx=JCTX)
    for i, p in enumerate(prompts(jcfg, lens)):
        srv.submit(JRequest(i, p, MAX_NEW))
    srv.run()
    return {r.rid: r.out for r in srv.completed}


@functools.lru_cache(maxsize=None)
def _port_params(policy):
    jcfg, tcfg, params, _ = built(policy)
    sparams = jtransformer.pack_for_serve(params, jcfg, plane_twins=True)
    return bridge.from_jax_params(np_tree(sparams), tcfg)


def _port_serve(policy, lens=PROMPT_LENS, *, slots=2, impl="popcount", kv="bfloat16",
                spec_draft=None, spec_k=4, **req_kw):
    _, tcfg, _, _ = built(policy)
    tcfg = dataclasses.replace(tcfg, kv_cache_dtype=kv)
    srv = tserve.Server(tcfg, _port_params(policy), slots=slots, cache_len=CACHE_LEN,
                        page_size=PAGE_SIZE, ctx=dataclasses.replace(CTX, impl=impl),
                        device="cpu", spec_draft=spec_draft, spec_k=spec_k)
    for i, p in enumerate(prompts(tcfg, lens)):
        srv.submit(tserve.Request(i, p, MAX_NEW, **req_kw))
    srv.run()
    assert len(srv.completed) == len(lens)
    assert srv.pt.free_pages == srv.pt.usable_pages
    return {r.rid: r.out for r in srv.completed}, srv


@functools.lru_cache(maxsize=None)
def _port_sequential(policy):
    """The port's sequential greedy tokens (popcount formulation)."""
    return _port_serve(policy)[0]


@pytest.mark.parametrize("policy", ["binary", "ternary", "int8", "w4a8"])
def test_spec_tokens_equal_sequential_and_jax(policy):
    want = _jax_tokens(policy)
    assert _port_sequential(policy) == want
    for draft, k in (("planes:1", 3), ("planes:8", 4)):
        got, srv = _port_serve(policy, spec_draft=draft, spec_k=k)
        assert got == want, (policy, draft, got, want)
        st = srv.stats
        assert srv.spec and st["spec_ticks"] > 0 and st["decode_ticks"] == 0
        assert st["spec_emitted"] == sum(len(o) - 1 for o in got.values())
        assert st["spec_accepted"] <= st["spec_proposed"]
        if draft == "planes:8":
            # a full-depth draft is the full model: every draft is accepted
            assert st["spec_accepted"] == st["spec_proposed"] > 0


def test_spec_sampled_tokens_equal_sequential():
    """Temperature draws are keyed by (seed, token index), so a sampled
    stream is speculation-invariant too: every accepted token is the draw
    sequential decode makes at the same index from the same logits."""
    seq, _ = _port_serve("w4a8", temperature=0.8, seed=3)
    assert seq != _jax_tokens("w4a8")
    got, srv = _port_serve("w4a8", spec_draft="planes:8", temperature=0.8, seed=3)
    assert got == seq
    assert srv.stats["spec_accepted"] > 0


def test_spec_eos_stops_inside_window():
    """An EOS sampled inside the speculative window retires the request
    with its output cut exactly where sequential decode stops."""
    full, _ = _port_serve("ternary", (5,))
    eos = full[0][2]
    cut = full[0][:full[0].index(eos) + 1]
    got, srv = _port_serve("ternary", (5,), spec_draft="planes:1", spec_k=4, eos=eos)
    assert got[0] == cut
    got, _ = _port_serve("ternary", (5,), spec_draft="planes:8", spec_k=6, eos=eos)
    assert got[0] == cut


def test_spec_falls_back_with_int8_kv():
    want = _jax_tokens("w4a8", kv="int8")
    got, srv = _port_serve("w4a8", kv="int8", spec_draft="planes:1")
    assert not srv.spec and srv.stats["spec_ticks"] == 0
    assert got == want
    _, tcfg, _, _ = built("int8")
    with pytest.raises(ValueError, match="plane_twins=True"):
        tserve.Server(tcfg, bridge.from_jax_params(np_tree(built("int8")[3]), tcfg),
                      cache_len=CACHE_LEN, page_size=PAGE_SIZE, ctx=CTX,
                      device="cpu", spec_draft="planes:1")


@pytest.mark.parametrize("policy", ["int8", "w4a8", "het"])
def test_impl_planes_tokens_equal_popcount_and_jax(policy):
    planes, _ = _port_serve(policy, impl="planes")
    assert planes == _port_sequential(policy) == _jax_tokens(policy)
