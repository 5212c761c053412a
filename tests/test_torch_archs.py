"""The port's server on the other dense archs, and three `Server` core
behaviours, against the JAX package, in f32 on the CPU.

Weights are the JAX package's own (`transformer.init` + `pack_for_serve`),
carried over by `repro_torch.bridge`. Bars:
  * reduced qwen1.5-32b (QKV bias) and nemotron-4-340b (squared ReLU,
    non-gated FFN), 2 layers: the port's paged continuous-batching server
    emits exactly the JAX server's greedy tokens under ternary, w-ternary
    and int8;
  * twins of tests/test_serving.py's core behaviours on reduced
    llama3.2-3b under ternary: a pool that backs one request's lifetime
    serves two requests one at a time (concurrency 1 in `pos_trace`) and
    gets every page back; a request whose lifetime needs more pages than
    the pool has is rejected at submit, and one that fits is served; a
    decode across 6 pages equals the JAX greedy reference (one request,
    prefill then jitted decode steps on a contiguous cache).
"""
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
from repro_torch.launch import serve as tserve
from repro_torch.models.common import ModelCtx

PROMPT_LENS = (3, 9, 14, 5)
MAX_NEW = 6
JCTX = JCtx(mode="serve", backend="jnp", dtype=jnp.float32)
CTX = ModelCtx(dtype=torch.float32)



@functools.lru_cache(maxsize=None)
def _port_params(policy, arch):
    _, tcfg, _, sparams = built(policy, 2, arch)
    return tcfg, bridge.from_jax_params(np_tree(sparams), tcfg)


@pytest.mark.parametrize("policy", ["ternary", "w-ternary", "int8"])
@pytest.mark.parametrize("arch", ["qwen1.5-32b", "nemotron-4-340b"])
def test_dense_arch_server_tokens_equal_jax(arch, policy):
    jcfg, _, _, sparams = built(policy, 2, arch)
    ps = prompts(jcfg, PROMPT_LENS)
    jsrv = JServer(jcfg, sparams, slots=2, cache_len=CACHE_LEN, page_size=PAGE_SIZE,
                   ctx=JCTX)
    tcfg, tp = _port_params(policy, arch)
    assert (tcfg.qkv_bias, tcfg.act_fn, tcfg.gated_ffn) == (
        jcfg.qkv_bias, jcfg.act_fn, jcfg.gated_ffn)
    srv = tserve.Server(tcfg, tp, slots=2, cache_len=CACHE_LEN, page_size=PAGE_SIZE,
                        ctx=CTX, device="cpu")
    for i, p in enumerate(ps):
        jsrv.submit(JRequest(i, p, MAX_NEW))
        srv.submit(tserve.Request(i, p, MAX_NEW))
    jsrv.run()
    srv.run()
    want = {r.rid: r.out for r in jsrv.completed}
    assert {r.rid: r.out for r in srv.completed} == want
    assert len(want) == len(ps) and srv.pt.free_pages == srv.pt.usable_pages


def _llama_server(**kw):
    tcfg, tp = _port_params("ternary", "llama3.2-3b")
    return tserve.Server(tcfg, tp, slots=2, cache_len=CACHE_LEN, page_size=PAGE_SIZE,
                         ctx=CTX, device="cpu", **kw)


def test_admission_is_metered_by_page_budget():
    cfg = built("ternary")[1]
    rng = np.random.default_rng(5)
    ps = [rng.integers(0, cfg.vocab, size=(8,)).astype(np.int32) for _ in range(2)]
    # each request needs pages_for(min(8 + 8 - 1, 32), 4) = 4 pages; 5 usable
    srv = _llama_server(num_pages=6)
    for i, p in enumerate(ps):
        srv.submit(tserve.Request(i, p, 8))
    srv.run()
    assert len(srv.completed) == 2
    assert srv.pos_trace and all(len(t) == 1 for t in srv.pos_trace), \
        "the page budget should have kept concurrency at 1"
    assert srv.pt.free_pages == srv.pt.usable_pages


def test_submit_rejects_unservable_page_demand():
    srv = _llama_server(num_pages=3)              # 2 usable pages
    prompt = np.arange(8, dtype=np.int32)
    with pytest.raises(ValueError, match="pages"):
        srv.submit(tserve.Request(0, prompt, 8))  # needs 4 pages, the pool has 2
    srv.submit(tserve.Request(1, prompt[:4], 3))  # 6 tokens -> 2 pages: fits
    srv.run()
    assert [r.rid for r in srv.completed] == [1]
    assert len(srv.completed[0].out) == 3


def test_paged_long_decode_extends_pages():
    jcfg, _, _, sparams = built("ternary")
    prompt = prompts(jcfg, (5,), seed=9)[0]
    max_new = 18     # 5 + 18 - 1 = 22 tokens -> 6 pages of 4
    # the JAX greedy reference: prefill, then decode steps on a contiguous cache
    # (jitted: op by op, the prefill alone takes ~15 s)
    sp = jtransformer.build_specs(jcfg)
    logits, cache = jax.jit(lambda t: jtransformer.prefill(
        sparams, t, sp, JCTX, cache_len=CACHE_LEN))(jnp.asarray(prompt)[None])
    step = jax.jit(lambda c, t, p: jtransformer.decode_step(sparams, c, t, p, sp, JCTX))
    want = [int(jnp.argmax(logits[0, -1]))]
    pos = len(prompt)
    while len(want) < max_new:
        lg, cache = step(cache, jnp.asarray([[want[-1]]], jnp.int32), jnp.int32(pos))
        want.append(int(jnp.argmax(lg[0, 0])))
        pos += 1
    srv = _llama_server()
    srv.submit(tserve.Request(0, prompt, max_new))
    srv.run()
    assert srv.completed[0].out == want
    assert srv.stats["peak_pages"] == 6


@pytest.mark.parametrize("lead", [(), (3,)], ids=["matrix", "experts"])
def test_ternary_pack_in_row_blocks_equals_whole(monkeypatch, lead):
    """A ternary weight past `qlinear.TERNARY_ROW_BLOCK_ELEMS` (nemotron's
    head on the card) is packed a block of rows at a time after one
    whole-tensor cut: the same planes and scales as the whole-tensor pass,
    and the same planes as the JAX packing (the reference has no blocks)."""
    from repro.core import precision as jprecision
    from repro.core import qlinear as jqlinear
    from repro_torch.core import precision as tprecision
    from repro_torch.core import qlinear as tqlinear
    rng = np.random.default_rng(11)
    k, n = 96, 70
    w = (rng.standard_normal(lead + (k, n)) / np.sqrt(k)).astype(np.float32)
    lq = ("ternary", "ternary")
    tspec = tqlinear.QLinearSpec(k, n, tprecision.LayerQuant(
        *(tprecision.QuantSpec(q) for q in lq)), experts=lead[0] if lead else 0)
    jspec = jqlinear.QLinearSpec(k, n, jprecision.LayerQuant(
        *(jprecision.QuantSpec(q) for q in lq)), experts=lead[0] if lead else 0)
    whole = tqlinear.pack_params({"w": torch.from_numpy(w)}, tspec)
    monkeypatch.setattr(tqlinear, "TERNARY_ROW_BLOCK_ELEMS", 8 * 3 * k)  # 3-row blocks
    blocks = tqlinear.pack_params({"w": torch.from_numpy(w)}, tspec)
    assert sorted(blocks) == sorted(whole) == ["w_mask", "w_scale", "w_sign"]
    for nm in whole:
        assert blocks[nm].shape == whole[nm].shape
        assert torch.equal(blocks[nm], whole[nm]), nm
    want = jqlinear.pack_params({"w": jnp.asarray(w)}, jspec)
    for nm in ("w_mask", "w_sign"):
        np.testing.assert_array_equal(blocks[nm].numpy(),
                                      np.asarray(want[nm]).view(np.int32))
    torch.testing.assert_close(blocks["w_scale"], torch.from_numpy(
        np.asarray(want["w_scale"])), rtol=1e-6, atol=0)
