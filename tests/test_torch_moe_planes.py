"""MoE under `--impl planes` and self-speculative decoding in the port (K10
over expert stacks), against the JAX package, in f32 on the CPU.

Bars:
  * expert-stacked plane cells: the port's `qgemm` on an (E, bits, N, K/32)
    plane stack, int4 and int8, at P = 1 and P = bits live planes, bias on
    and off, equals JAX `qgemm` (the expert vmap) bit for bit under the jnp
    backend, and under the Pallas backend (interpret) wherever the Pallas
    epilogue is not FMA-contracted (ROADMAP queue 3; where it is, the
    Pallas value is the once-rounded FMA of the same accumulator); the
    grouped int32 accumulator equals JAX `gemm_grouped(interpret=True,
    out="acc")` on the truncated stack; at P = bits the output equals the
    port's direct int4 / int8 expert cell (the composition is an identity);
    the draft's truncation is the view `w_planes[:, :P]`, the one
    non-contiguous layout the grouped launch reads in place
    (`harness._plane_slice`);
  * `init_for_serve(plane_twins=True)` on reduced deepseek-moe-16b equals
    `pack_for_serve(init(...), plane_twins=True)`, and the port packs the
    JAX train weights into the bridged JAX `pack_for_serve(...,
    plane_twins=True)`, the expert stacks' plane twins included;
  * serving, reduced deepseek-moe-16b and phi3.5-moe-42b-a6.6b (3 layers,
    het, the serve-test prompts): under `--impl planes` the port's server
    emits the JAX server's tokens and the port's direct-cell tokens, with
    the JAX server's routing counters; under `--spec-draft planes:1`
    (spec_k 4) and `planes:4` (spec_k 3) it emits the port's sequential
    tokens and the JAX speculative server's, and `moe_routed`,
    `moe_dropped` and `moe_expert_tokens` equal the JAX speculative
    server's (the verify step's window rows are counted, the draft's are
    not); a 4-slot server emits a 1-slot server's tokens.
"""
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (CACHE_LEN, PAGE_SIZE, built_twins,  # noqa: F401
                         np_tree, one_torch_thread, prompts)
from repro.core import precision as jprecision
from repro.core import qlinear as jqlinear
from repro.kernels import dispatch as jdispatch
from repro.kernels import harness as jharness
from repro.launch.serve import Request as JRequest
from repro.launch.serve import Server as JServer
from repro.models import transformer as jtransformer
from repro.models.common import ModelCtx as JCtx
from repro_torch import bridge
from repro_torch.bridge import to_torch
from repro_torch.core import precision as tprecision
from repro_torch.core import qlinear as tqlinear
from repro_torch.kernels import dispatch as tdispatch
from repro_torch.kernels import harness as tharness
from repro_torch.launch import serve as tserve
from repro_torch.models import transformer
from repro_torch.models.common import ModelCtx

ARCHS = ("deepseek-moe-16b", "phi3.5-moe-42b-a6.6b")
N_LAYERS = 3
PROMPT_LENS = (3, 9, 14, 5)
MAX_NEW = 6
COUNTERS = ("moe_routed", "moe_dropped", "moe_expert_tokens")
BITS = {"int4": 4, "int8": 8}



def _bits16(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(a).view(np.uint16)


# -- expert-stacked plane cells ---------------------------------------------------

@functools.lru_cache(maxsize=None)
def _expert_case(wprec, bias, e=3, m=16, k=256, n=96):
    """JAX and port specs of the (wprec, int8, planes) cell with an expert
    stack of e, the JAX packed stack (plane twin included) and
    activations (e, m, k); m = 16 is a 4-slot decode tick's slab."""
    rng = np.random.default_rng(BITS[wprec] + 2 * bias)
    lq = jprecision.LayerQuant(jprecision.QuantSpec(wprec),
                               jprecision.QuantSpec("int8"))
    tlq = tprecision.LayerQuant(tprecision.QuantSpec(wprec),
                                tprecision.QuantSpec("int8"))
    jspec = jqlinear.QLinearSpec(k, n, lq, use_bias=bias, experts=e)
    tspec = tqlinear.QLinearSpec(k, n, tlq, use_bias=bias, experts=e)
    train = {"w": jnp.asarray((rng.standard_normal((e, k, n)) / np.sqrt(k)
                               ).astype(np.float32))}
    if bias:
        train["b"] = jnp.asarray((0.1 * rng.standard_normal((e, n))).astype(np.float32))
    packed = jqlinear.pack_params(train, jspec)
    x = (0.2 * rng.standard_normal((e, m, k))).astype(np.float32)
    return jspec, tspec, packed, x


def plane_body(wprec):
    return tdispatch.lookup(tdispatch.OperatingPoint(wprec, "int8", "planes")).body


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
@pytest.mark.parametrize("keep", [1, "bits"])
@pytest.mark.parametrize("wprec", ["int4", "int8"])
def test_expert_plane_cells_bit_equal_to_jax(wprec, keep, backend):
    bits = BITS[wprec]
    keep = bits if keep == "bits" else keep
    for bias in (False, True):
        jspec, tspec, packed, x = _expert_case(wprec, bias)
        e, m, k = x.shape
        tp = {nm: to_torch(np.asarray(v)) for nm, v in packed.items()}
        op = tdispatch.OperatingPoint(wprec, "int8", "planes", planes=keep)
        got = tdispatch.qgemm(tp, torch.from_numpy(x), tspec, op)
        assert got.dtype == torch.bfloat16 and got.shape == (e, m, tspec.out_dim)
        want = jdispatch.qgemm(packed, jnp.asarray(x), jspec, jdispatch.OperatingPoint(
            wprec, "int8", "planes", backend=backend, planes=keep))
        assert (got[0] != got[1]).any()         # each expert's own weights
        # the grouped accumulator, on JAX's own prepared operands
        jcell = jdispatch.lookup(jdispatch.OperatingPoint(wprec, "int8", "planes"))
        x_ops, a_scale = jcell.prep(jnp.asarray(x.reshape(e * m, k)), packed, jspec)
        jw = packed["w_planes"][:, :keep]
        acc_j = np.asarray(jharness.gemm_grouped(
            jcell.body, [x_ops[0].reshape(e, m, k)], [jw], k=k, interpret=True,
            out="acc"))
        tw = tp["w_planes"][:, :keep]
        assert not tw.is_contiguous() or keep == bits
        assert tharness._plane_slice(plane_body(wprec), tw)
        acc = tharness.gemm_grouped(plane_body(wprec),
                                    [to_torch(np.asarray(x_ops[0])).reshape(e, m, k)],
                                    [tw], None, None, k=k, out="acc")
        np.testing.assert_array_equal(acc.numpy(), acc_j)
        if backend == "jnp" or not bias:
            np.testing.assert_array_equal(_bits16(got), _bits16(want))
        else:
            # the Pallas epilogue may FMA-contract `* a_scale + bias`: where
            # it differs from the jnp formulation it is the once-rounded FMA
            ref = jdispatch.qgemm(packed, jnp.asarray(x), jspec, jdispatch.OperatingPoint(
                wprec, "int8", "planes", backend="jnp", planes=keep))
            np.testing.assert_array_equal(_bits16(got), _bits16(ref))
            agree = _bits16(want) == _bits16(ref)
            np.testing.assert_array_equal(_bits16(got)[agree], _bits16(want)[agree])
            if not agree.all():
                y = acc_j.astype(np.float32) * np.asarray(packed["w_scale"])[:, None, :]
                fma = (y.astype(np.float64) * float(np.asarray(a_scale)[0])
                       + np.asarray(packed["b"])[:, None, :]).astype(np.float32)
                np.testing.assert_array_equal(
                    _bits16(want)[~agree],
                    _bits16(torch.from_numpy(fma).to(torch.bfloat16))[~agree])
        if keep == bits:
            direct = tdispatch.qgemm(tp, torch.from_numpy(x), tspec,
                                     tdispatch.OperatingPoint(wprec, "int8"))
            np.testing.assert_array_equal(_bits16(got), _bits16(direct))


def test_plane_slice_is_the_only_strided_stack_read_in_place():
    body = plane_body("int4")
    stack = torch.zeros((3, 4, 8, 2), dtype=torch.int32)
    for p in (1, 2, 4):
        assert tharness._plane_slice(body, stack[:, :p])
    for t in (stack[:, 1:3],                    # not a leading slice
              stack[::2],                       # every other expert
              stack[:, :2, ::2],                # every other row
              stack.transpose(2, 3),
              torch.zeros((3, 8, 8, 2), dtype=torch.int32)[:, :4],   # 8-plane stack
              stack[0]):                        # no group axis
        assert not tharness._plane_slice(body, t)
    assert not tharness._plane_slice(
        tdispatch.lookup(tdispatch.OperatingPoint("int4", "int8")).body, stack)


# -- packing -------------------------------------------------------------------

def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def test_moe_plane_twins_match_jax_and_init_for_serve():
    jcfg, tcfg, params, sparams = built_twins("het", N_LAYERS, "deepseek-moe-16b")
    want = dict(_leaves(bridge.from_jax_params(np_tree(sparams), tcfg)))
    got = dict(_leaves(transformer.pack_for_serve(
        bridge.from_jax_params(np_tree(params), tcfg), tcfg, plane_twins=True)))
    assert sorted(map(str, got)) == sorted(map(str, want))
    twin = ("blocks", 1, "ffn", "up", "w_planes")
    assert got[twin].shape == (4, 4, 512, 4)          # E, bits, N, K/32
    assert ("blocks", 1, "ffn", "down", "w_planes") in got
    for path, w in want.items():
        g = got[path]
        assert g.dtype == w.dtype and g.shape == w.shape, path
        if path[-1] == "w_scale" and path[:-1] + ("w_mask",) in want:
            torch.testing.assert_close(g, w, rtol=1e-6, atol=0)   # float means
        else:
            assert torch.equal(g, w), path
    cfg = dataclasses.replace(tcfg, n_layers=2)
    ref = dict(_leaves(transformer.pack_for_serve(
        transformer.init(cfg, torch.Generator().manual_seed(4), "cpu"), cfg,
        plane_twins=True)))
    mine = dict(_leaves(transformer.init_for_serve(
        cfg, torch.Generator().manual_seed(4), "cpu", plane_twins=True)[0]))
    assert sorted(map(str, mine)) == sorted(map(str, ref))
    assert any(p[-1] == "w_planes" and p[2] == "ffn" for p in mine)
    assert all(torch.equal(mine[p], w) for p, w in ref.items())


# -- serving -----------------------------------------------------------------------

#: (impl, spec_draft, spec_k) of each served mode
MODES = {"planes": ("planes", None, 4), "spec1": ("popcount", "planes:1", 4),
         "spec4": ("popcount", "planes:4", 3)}


def _prompts(arch):
    return prompts(built_twins("het", N_LAYERS, arch)[0], PROMPT_LENS)


@functools.lru_cache(maxsize=None)
def _jax_serve(arch, mode):
    impl, draft, spec_k = MODES[mode]
    jcfg, _, _, sparams = built_twins("het", N_LAYERS, arch)
    srv = JServer(jcfg, sparams, slots=2, cache_len=CACHE_LEN, page_size=PAGE_SIZE,
                  ctx=JCtx(mode="serve", backend="jnp", dtype=jnp.float32, impl=impl),
                  spec_draft=draft, spec_k=spec_k)
    for i, p in enumerate(_prompts(arch)):
        srv.submit(JRequest(i, p, MAX_NEW))
    srv.run()
    return ({r.rid: r.out for r in srv.completed},
            {k: srv.stats[k] for k in COUNTERS})


@functools.lru_cache(maxsize=None)
def _port_params(arch):
    _, tcfg, _, sparams = built_twins("het", N_LAYERS, arch)
    return tcfg, bridge.from_jax_params(np_tree(sparams), tcfg)


@functools.lru_cache(maxsize=None)
def _port_serve(arch, mode=None, slots=2):
    """Tokens by request and routing counters of the port's server; mode
    None: sequential decode through the direct cells."""
    impl, draft, spec_k = MODES[mode] if mode else ("popcount", None, 4)
    tcfg, tp = _port_params(arch)
    srv = tserve.Server(tcfg, tp, slots=slots, cache_len=CACHE_LEN,
                        page_size=PAGE_SIZE,
                        ctx=ModelCtx(dtype=torch.float32, impl=impl), device="cpu",
                        spec_draft=draft, spec_k=spec_k)
    ps = _prompts(arch)
    for i, p in enumerate(ps):
        srv.submit(tserve.Request(i, p, MAX_NEW))
    srv.run()
    assert len(srv.completed) == len(ps)
    assert srv.pt.free_pages == srv.pt.usable_pages
    assert srv.spec == (draft is not None)
    if draft:
        assert srv.stats["spec_ticks"] > 0
    st = {k: srv.stats[k] for k in COUNTERS}
    assert st["moe_routed"] == sum(st["moe_expert_tokens"]) + st["moe_dropped"] > 0
    return {r.rid: r.out for r in srv.completed}, st


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_planes_and_spec_serve_equal_jax(arch, mode):
    want_toks, want_st = _jax_serve(arch, mode)
    got_toks, got_st = _port_serve(arch, mode)
    assert got_toks == want_toks
    assert got_st == want_st
    # planes == direct cells, spec == sequential: both the direct tokens
    assert got_toks == _port_serve(arch)[0]


@pytest.mark.parametrize("mode", ["planes", "spec1"])
def test_moe_planes_and_spec_batched_equals_sequential(mode):
    arch = ARCHS[0]
    assert (_port_serve(arch, mode, slots=4)[0]
            == _port_serve(arch, mode, slots=1)[0] == _port_serve(arch)[0])
