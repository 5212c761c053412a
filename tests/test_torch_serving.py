"""The port's server against the JAX package's, in f32 on the CPU.

Weights are the JAX package's own (`transformer.init` + `pack_for_serve`),
carried over through numpy by `repro_torch.bridge`. Bars:
  * the port's paged continuous-batching server emits exactly the JAX
    server's greedy tokens (jnp backend) under every precision policy,
    with an int8 KV pool, and with prompts of 129-256 tokens, whose prefill
    takes the flash-attention route (bucket 256);
  * the mxu formulation's tokens equal the popcount formulation's;
  * the port's batched server equals its one-slot (sequential) server;
  * EOS retirement, the CLI's refusal of unported features, and that it
    serves `--impl planes` and `--spec-draft`.
"""
import dataclasses
import functools

import jax.numpy as jnp
import pytest
import torch

from _torch_port import CACHE_LEN, PAGE_SIZE, built, np_tree, prompts
from _torch_port import one_torch_thread  # noqa: F401
from repro.core.precision import POLICIES
from repro.launch.serve import Request as JRequest
from repro.launch.serve import Server as JServer
from repro.models.common import ModelCtx as JCtx
from repro_torch import bridge
from repro_torch.launch import serve as tserve
from repro_torch.launch.kv_cache import NULL_PAGE
from repro_torch.models.common import ModelCtx

PROMPT_LENS = (3, 9, 14, 5)
MAX_NEW = 6
CTX = ModelCtx(dtype=torch.float32)


@functools.lru_cache(maxsize=None)
def _built(policy, kv="bfloat16"):
    """`built(policy)` with the configs' KV-cache dtype set to `kv`."""
    jcfg, tcfg, params, sparams = built(policy)
    return (dataclasses.replace(jcfg, kv_cache_dtype=kv),
            dataclasses.replace(tcfg, kv_cache_dtype=kv), params, sparams)


def _jax_serve(policy, ps, slots=2, *, kv="bfloat16", cache_len=CACHE_LEN):
    jcfg, _, _, sparams = _built(policy, kv)
    srv = JServer(jcfg, sparams, slots=slots, cache_len=cache_len,
                  page_size=PAGE_SIZE,
                  ctx=JCtx(mode="serve", backend="jnp", dtype=jnp.float32))
    for i, p in enumerate(ps):
        srv.submit(JRequest(i, p, MAX_NEW))
    srv.run()
    return {r.rid: r.out for r in srv.completed}


def _port_serve(policy, ps, slots=2, *, impl="popcount", kv="bfloat16",
                cache_len=CACHE_LEN, **req_kw):
    _, tcfg, _, sparams = _built(policy, kv)
    tp = bridge.from_jax_params(np_tree(sparams), tcfg)
    srv = tserve.Server(tcfg, tp, slots=slots, cache_len=cache_len,
                        page_size=PAGE_SIZE,
                        ctx=dataclasses.replace(CTX, impl=impl), device="cpu")
    for i, p in enumerate(ps):
        srv.submit(tserve.Request(i, p, MAX_NEW, seed=i, **req_kw))
    srv.run()
    assert len(srv.completed) == len(ps)
    assert srv.pt.free_pages == srv.pt.usable_pages     # every page came back
    return {r.rid: r.out for r in srv.completed}


@pytest.mark.parametrize("policy", ["binary", "ternary", "int8"] + sorted(
    set(POLICIES) - {"binary", "ternary", "int8"}))
def test_port_server_tokens_equal_jax_server(policy):
    ps = prompts(built(policy)[0], PROMPT_LENS)
    want = _jax_serve(policy, ps)
    got = _port_serve(policy, ps)
    assert got == want, (policy, got, want)


@pytest.mark.parametrize("policy", ["binary", "ternary", "mixed"])
def test_mxu_tokens_equal_popcount_tokens(policy):
    ps = prompts(built(policy)[0], PROMPT_LENS)
    assert _port_serve(policy, ps, impl="mxu") == _port_serve(policy, ps)


def test_int8_kv_pool_tokens_equal_jax_server():
    """kv_cache_dtype="int8": both servers store K/V as int8 codes at the
    static scale; the port's paged decode reads them through the kernel's
    plain version."""
    ps = prompts(built("ternary")[0], PROMPT_LENS)
    assert _port_serve("ternary", ps, kv="int8") == _jax_serve("ternary", ps, kv="int8")
    _, tcfg, _, sparams = _built("ternary", "int8")
    srv = tserve.Server(tcfg, bridge.from_jax_params(np_tree(sparams), tcfg),
                        cache_len=CACHE_LEN, page_size=PAGE_SIZE, ctx=CTX,
                        device="cpu")
    assert all(c[nm].dtype == torch.int8 for c in srv.cache for nm in ("k", "v"))


@pytest.mark.parametrize("policy", ["w-ternary", "int8"])
def test_long_prompt_flash_route(policy):
    """Prompts of 129-256 tokens land in bucket 256, where prefill takes the
    flash-attention route; port tokens == JAX tokens, and the port's batched
    server == its one-slot server."""
    ps = prompts(built(policy)[0], (200, 7, 150))
    want = _jax_serve(policy, ps, cache_len=256)
    got = _port_serve(policy, ps, slots=3, cache_len=256)
    assert got == want
    assert _port_serve(policy, ps, slots=1, cache_len=256) == got


@pytest.mark.parametrize("policy", ["binary", "int8"])
def test_port_batched_equals_sequential(policy):
    ps = prompts(built(policy)[0], (3, 9, 14, 5, 30, 1))
    batched = _port_serve(policy, ps, slots=4)
    assert batched == _port_serve(policy, ps, slots=1)
    # temperature draws are keyed by (seed, token index): batching-invariant
    hot = _port_serve(policy, ps, slots=4, temperature=0.8)
    assert hot == _port_serve(policy, ps, slots=1, temperature=0.8)
    assert hot != batched


def test_eos_retires_and_frees_pages():
    ps = prompts(built("int8")[0], (5, 7))
    full = _port_serve("int8", ps)
    eos = full[0][2]
    cut = _port_serve("int8", ps, eos=eos)
    assert cut[0] == full[0][:full[0].index(eos) + 1]


def test_cli_refuses_unported_features_and_missing_card():
    for flag in (["--prefix-share"], ["--preempt"], ["--chunk-tokens", "8"],
                 ["--mesh", "1,2"], ["--contiguous"], ["--dispatch-ahead"]):
        with pytest.raises(SystemExit, match="not yet ported"):
            tserve.main(["--reduced", "--device", "cpu", *flag])
    # the plane cells and self-speculative decoding serve
    for flags in (["--policy", "w4a8", "--impl", "planes"],
                  ["--policy", "int8", "--spec-draft", "planes:1"]):
        srv = tserve.main(["--reduced", "--device", "cpu", "--requests", "2",
                           "--max-new", "3", *flags])
        assert sorted(len(r.out) for r in srv.completed) == [3, 3]
        assert srv.spec == ("--spec-draft" in flags)
        assert srv.ctx.impl == ("planes" if "--impl" in flags else "popcount")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tserve.main(["--reduced"])
    srv = tserve.main(["--reduced", "--device", "cpu", "--requests", "2",
                       "--max-new", "3", "--policy", "ternary"])
    assert sorted(len(r.out) for r in srv.completed) == [3, 3]
    assert (srv.pt.table == NULL_PAGE).all()
    # the arch's own policy (llama3.2-3b: w-ternary) and the mxu formulation
    for flags in ([], ["--policy", "binary", "--impl", "mxu"]):
        srv = tserve.main(["--reduced", "--device", "cpu", "--requests", "2",
                           "--max-new", "3", *flags])
        assert srv.cfg.policy == (flags[1] if flags else "w-ternary")
        assert srv.ctx.impl == (flags[3] if flags else "popcount")
        assert sorted(len(r.out) for r in srv.completed) == [3, 3]
