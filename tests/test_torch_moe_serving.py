"""MoE serving through the port against the JAX package's server, in f32 on
the CPU.

Weights are the JAX package's own (`transformer.init` + `pack_for_serve`)
for reduced deepseek-moe-16b (a shared expert) and phi3.5-moe-42b-a6.6b
(none), at 3 layers so that the middle layer comes from the reference's
stacked `mid` periods, carried over by `repro_torch.bridge`. Bars:
  * the port's paged continuous-batching server emits exactly the JAX
    single-device server's greedy tokens under `het` (weight-and-activation
    experts, the grouped GEMM) and `w-ternary` (weight-only experts), and
    its routing counters `moe_routed`, `moe_dropped` and
    `moe_expert_tokens` are equal to the JAX server's, idle decode rows
    included; with capacity_factor 1.0 prefill drops assignments, and the
    drops are equal too;
  * the port packs the JAX train-layout weights of the MoE model (its
    middle layer a scanned `mid` period, whose expert stacks the bridge
    unstacks along the period axis) into the JAX packed leaves, its
    per-layer specs
    resolve to the reference's, and `init_for_serve` (block by block)
    equals `pack_for_serve(init(...))`;
  * the port's 4-slot server emits its 1-slot server's tokens;
  * the CLI serves an MoE arch, also with `--spec-draft` and `--impl
    planes` (once refused), and so does the `Server`, with routing counters
    that add up (tests/test_torch_moe_planes.py holds those runs against
    the JAX server).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (CACHE_LEN, PAGE_SIZE, built, np_tree,  # noqa: F401
                         one_torch_thread, prompts)
from repro.launch.serve import Request as JRequest
from repro.launch.serve import Server as JServer
from repro.models import transformer as jtransformer
from repro.models.common import ModelCtx as JCtx
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.launch import serve as tserve
from repro_torch.models import transformer
from repro_torch.models.common import ModelCtx

ARCHS = ("deepseek-moe-16b", "phi3.5-moe-42b-a6.6b")
N_LAYERS = 3
PROMPT_LENS = (3, 9, 14, 5)
MAX_NEW = 6
COUNTERS = ("moe_routed", "moe_dropped", "moe_expert_tokens")


@functools.lru_cache(maxsize=None)
def _built(arch, policy, capacity_factor=None):
    """`built(policy, 3, arch)` with the configs' capacity factor set (None:
    the reduced configs' 8.0, which drops nothing)."""
    jcfg, tcfg, params, sparams = built(policy, N_LAYERS, arch)
    if capacity_factor is not None:
        jcfg = dataclasses.replace(jcfg, capacity_factor=capacity_factor)
        tcfg = dataclasses.replace(tcfg, capacity_factor=capacity_factor)
    return jcfg, tcfg, params, sparams


def _prompts(arch):
    return prompts(built("het", N_LAYERS, arch)[0], PROMPT_LENS)


@functools.lru_cache(maxsize=None)
def _jax_serve(arch, policy, capacity_factor=None, slots=2):
    jcfg, _, _, sparams = _built(arch, policy, capacity_factor)
    srv = JServer(jcfg, sparams, slots=slots, cache_len=CACHE_LEN,
                  page_size=PAGE_SIZE,
                  ctx=JCtx(mode="serve", backend="jnp", dtype=jnp.float32))
    for i, p in enumerate(_prompts(arch)):
        srv.submit(JRequest(i, p, MAX_NEW))
    srv.run()
    return ({r.rid: r.out for r in srv.completed},
            {k: srv.stats[k] for k in COUNTERS})


def _port_serve(arch, policy, capacity_factor=None, slots=2):
    _, tcfg, _, sparams = _built(arch, policy, capacity_factor)
    tp = bridge.from_jax_params(np_tree(sparams), tcfg)
    srv = tserve.Server(tcfg, tp, slots=slots, cache_len=CACHE_LEN,
                        page_size=PAGE_SIZE, ctx=ModelCtx(dtype=torch.float32),
                        device="cpu")
    ps = _prompts(arch)
    for i, p in enumerate(ps):
        srv.submit(tserve.Request(i, p, MAX_NEW))
    srv.run()
    assert len(srv.completed) == len(ps)
    assert srv.pt.free_pages == srv.pt.usable_pages
    return ({r.rid: r.out for r in srv.completed},
            {k: srv.stats[k] for k in COUNTERS})


@pytest.mark.parametrize("arch,policy,capacity_factor", [
    ("deepseek-moe-16b", "het", None), ("deepseek-moe-16b", "w-ternary", None),
    ("phi3.5-moe-42b-a6.6b", "het", None),
    ("phi3.5-moe-42b-a6.6b", "w-ternary", None),
    ("deepseek-moe-16b", "het", 1.0)])
def test_moe_server_tokens_and_counters_equal_jax(arch, policy, capacity_factor):
    want_toks, want_st = _jax_serve(arch, policy, capacity_factor)
    got_toks, got_st = _port_serve(arch, policy, capacity_factor)
    assert got_toks == want_toks
    assert got_st == want_st
    routed = got_st["moe_routed"]
    assert routed == sum(got_st["moe_expert_tokens"]) + got_st["moe_dropped"]
    assert (got_st["moe_dropped"] > 0) == (capacity_factor is not None)


@pytest.mark.parametrize("arch,policy", [("deepseek-moe-16b", "het"),
                                         ("phi3.5-moe-42b-a6.6b", "w-ternary")])
def test_moe_prefill_routing_equals_jax_op_by_op(arch, policy):
    """2 layers, so the JAX prefill runs op by op (no scanned `mid` stack
    for XLA to compile and fuse): the port's routing counters equal it and
    the logits agree, on prompts for which XLA's compiled prefill
    routes differently from this op-by-op run (deepseek het, the 12-token
    prompt: expert_tokens [22 24 24 26] compiled, [23 25 24 24] op by op).
    The logits are held to 2^-5: under w-ternary every linear ends in a
    bf16 epilogue, and where the two sides' f32 sums straddle a bf16
    rounding boundary one value moves by a bf16 step, which the next
    layers carry to the logits (measured: at most 0.0156)."""
    from repro_torch.models import transformer as tt
    jcfg, tcfg, _, sparams = built(policy, 2, arch)
    tp = bridge.from_jax_params(np_tree(sparams), tcfg)
    jctx = JCtx(mode="serve", backend="jnp", dtype=jnp.float32, moe_stats=True)
    jsp, tsp = jtransformer.build_specs(jcfg), tt.build_specs(tcfg)
    for p in prompts(jcfg, (5, 14, 9, 12)):
        toks = np.zeros((1, 16), np.int32)
        toks[0, :len(p)] = p
        jl, _, jst = jtransformer.prefill(sparams, jnp.asarray(toks), jsp, jctx,
                                          cache_len=CACHE_LEN, last_pos=[len(p) - 1])
        tl, _, tst = tt.prefill(tp, torch.from_numpy(toks), tsp,
                                ModelCtx(dtype=torch.float32, moe_stats=True),
                                cache_len=CACHE_LEN, last_pos=[len(p) - 1])
        np.testing.assert_array_equal(tst["expert_tokens"].numpy(),
                                      np.asarray(jst["expert_tokens"]))
        assert int(tst["dropped"]) == int(jst["dropped"])
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2 ** -7,
                                   atol=2 ** -5)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def test_moe_bridge_pack_and_specs_match():
    jcfg, tcfg, params, sparams = built("het", N_LAYERS, "deepseek-moe-16b")
    assert jax.tree.leaves(params["mid"])[0].shape[0] == 1       # n_periods
    want = dict(_leaves(bridge.from_jax_params(np_tree(sparams), tcfg)))
    got = dict(_leaves(transformer.pack_for_serve(
        bridge.from_jax_params(np_tree(params), tcfg), tcfg)))
    assert sorted(map(str, got)) == sorted(map(str, want))
    assert got[("blocks", 1, "ffn", "up", "w_q4")].shape == (4, 512, 16)  # E, N, K/8
    for path, w in want.items():
        g = got[path]
        assert g.dtype == w.dtype and g.shape == w.shape, path
        if path[-1] == "w_scale" and path[:-1] + ("w_mask",) in want:
            # ternary scales are means, summed in another order
            torch.testing.assert_close(g, w, rtol=1e-6, atol=0)
        else:
            assert torch.equal(g, w), path
    sp, jsp = transformer.build_specs(tcfg), jtransformer.build_specs(jcfg)
    for bs, jbs in zip(sp.blocks, [jsp.first] + [jsp.mid[0]] * 2 + [jsp.last]):
        assert bs.is_moe and jbs.is_moe
        for nm in ("router", "up", "down"):
            t, j = getattr(bs.ffn, nm), getattr(jbs.ffn, nm)
            assert (t.in_dim, t.out_dim, t.experts) == (j.in_dim, j.out_dim, j.experts)
            assert dataclasses.asdict(t.lq) == dataclasses.asdict(j.lq), nm


@pytest.mark.parametrize("arch,policy,twins", [
    ("deepseek-moe-16b", "het", False), ("phi3.5-moe-42b-a6.6b", "int8", True),
    ("llama3.2-3b", "w4a8", False)])
def test_init_for_serve_equals_pack_of_init(arch, policy, twins):
    cfg = dataclasses.replace(get_config(arch).reduced(), policy=policy, n_layers=3)
    want = transformer.pack_for_serve(
        transformer.init(cfg, torch.Generator().manual_seed(1), "cpu"), cfg,
        plane_twins=twins)
    got, train_b = transformer.init_for_serve(cfg, torch.Generator().manual_seed(1),
                                              "cpu", plane_twins=twins)
    want_l, got_l = dict(_leaves(want)), dict(_leaves(got))
    assert sorted(map(str, got_l)) == sorted(map(str, want_l))
    assert all(torch.equal(got_l[p], w) for p, w in want_l.items())
    assert train_b == tserve.tree_nbytes(
        transformer.init(cfg, torch.Generator().manual_seed(1), "cpu"))


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_port_batched_equals_sequential(arch):
    assert (_port_serve(arch, "het", slots=4)[0]
            == _port_serve(arch, "het", slots=1)[0])


def test_moe_cli_serves_and_refuses_unported():
    srv = tserve.main(["--arch", "deepseek-moe-16b", "--reduced", "--device", "cpu",
                       "--requests", "2", "--max-new", "3", "--policy", "het"])
    assert sorted(len(r.out) for r in srv.completed) == [3, 3]
    assert srv.ctx.moe_stats
    st = srv.stats
    assert st["moe_routed"] == sum(st["moe_expert_tokens"]) + st["moe_dropped"] > 0
    # --spec-draft and --impl planes on an MoE arch, once refused, serve
    for flags in (["--spec-draft", "planes:1"], ["--impl", "planes"]):
        srv = tserve.main(["--arch", "deepseek-moe-16b", "--reduced", "--device",
                           "cpu", "--requests", "1", "--max-new", "3", "--policy",
                           "w4a8", *flags])
        assert [len(r.out) for r in srv.completed] == [3]
        assert srv.spec == ("--spec-draft" in flags)
        st = srv.stats
        assert st["moe_routed"] == sum(st["moe_expert_tokens"]) + st["moe_dropped"] > 0
    _, tcfg, params, _ = _built("deepseek-moe-16b", "het")
    tp = transformer.pack_for_serve(bridge.from_jax_params(np_tree(params), tcfg),
                                    tcfg, plane_twins=True)
    for kw in ({"spec_draft": "planes:1"}, {"ctx": ModelCtx(dtype=torch.float32,
                                                            impl="planes")}):
        srv = tserve.Server(tcfg, tp, cache_len=CACHE_LEN, page_size=PAGE_SIZE,
                            device="cpu", **kw)
        srv.submit(tserve.Request(0, _prompts("deepseek-moe-16b")[0], 3))
        srv.run()
        assert len(srv.completed[0].out) == 3
        st = srv.stats
        assert st["moe_routed"] == sum(st["moe_expert_tokens"]) + st["moe_dropped"] > 0
