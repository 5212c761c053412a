"""The port's model against the JAX package, in f32 on the CPU.

Weights are the JAX package's own, carried over by `repro_torch.bridge`.
Bars: the port packs the JAX train-layout weights into the same packed
words and codes under every precision policy (a 4-layer config, so the
reference's scanned `mid` stack is unstacked by the bridge), its per-layer
specs resolve to the reference's operating points, and its bucket-padded
prefill and paged decode logits are allclose to the JAX model's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import CACHE_LEN, PAGE_SIZE, built, np_tree, prompts
from _torch_port import one_torch_thread  # noqa: F401
from repro.core.precision import POLICIES
from repro.models import transformer as jtransformer
from repro.models.common import ModelCtx as JCtx
from repro_torch import bridge
from repro_torch.models import transformer
from repro_torch.models.common import ModelCtx

CTX = ModelCtx(dtype=torch.float32)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


#: every policy, the first slice's three first (their test ids stay)
ALL_POLICIES = ["binary", "ternary", "int8"] + sorted(
    set(POLICIES) - {"binary", "ternary", "int8"})


@pytest.mark.parametrize("policy", ALL_POLICIES)
def test_bridge_and_pack_for_serve_match(policy):
    """4 layers: first, two scanned mid periods, last. The port packs the
    JAX train-layout weights to the JAX packed words/codes; float scales
    agree to a few ulp (torch sums the per-channel means in another
    order than XLA)."""
    jcfg, tcfg, params, sparams = built(policy, n_layers=4)
    assert jax.tree.leaves(params["mid"])[0].shape[0] == 2
    want = bridge.from_jax_params(np_tree(sparams), tcfg)
    got = transformer.pack_for_serve(bridge.from_jax_params(np_tree(params), tcfg), tcfg)
    assert len(got["blocks"]) == 4
    want_leaves = dict(_leaves(want))
    got_leaves = dict(_leaves(got))
    assert sorted(map(str, got_leaves)) == sorted(map(str, want_leaves))
    for path, w in want_leaves.items():
        g = got_leaves[path]
        assert g.dtype == w.dtype and g.shape == w.shape, path
        if g.is_floating_point() and path[-1] == "w_scale" and g.dtype == torch.float32 \
                and ("w_packed" in _parent(got, path) or "w_mask" in _parent(got, path)):
            # binary/ternary scales are means, summed in another order
            torch.testing.assert_close(g, w, rtol=1e-6, atol=0)
        else:
            assert torch.equal(g, w), path


def _parent(tree, path):
    for k in path[:-1]:
        tree = tree[k]
    return tree


def test_het_specs_resolve_per_layer():
    """`het` assigns each layer class its own operating point, first and
    last blocks included (per_class wins over first_last); lm_head falls to
    first_last. The port's specs equal the reference's, layer by layer."""
    from repro_torch.core.precision import get_policy
    from repro_torch.kernels import dispatch
    from repro_torch.models.common import operating_point
    jcfg, tcfg, _, _ = built("het", n_layers=4)
    sp = transformer.build_specs(tcfg)
    jsp = jtransformer.build_specs(jcfg)
    jblocks = [jsp.first] + [jsp.mid[0]] * 2 + [jsp.last]
    for bs, jbs in zip(sp.blocks, jblocks):
        for t, j in ((bs.mixer.qkv, jbs.mixer.qkv), (bs.mixer.out, jbs.mixer.out),
                     (bs.ffn.up, jbs.ffn.up), (bs.ffn.down, jbs.ffn.down)):
            assert dataclasses.asdict(t.lq) == dataclasses.asdict(j.lq), t.name
        assert (bs.mixer.qkv.lq.tag, bs.mixer.out.lq.tag, bs.ffn.up.lq.tag,
                bs.ffn.down.lq.tag) == tuple(get_policy("het").per_class[c].tag for c in
                                             ("attn_qkv", "attn_out", "ffn_up",
                                              "ffn_down"))
    assert sp.lm_head.lq == get_policy("het").first_last
    assert dataclasses.asdict(sp.lm_head.lq) == dataclasses.asdict(jsp.lm_head.lq)
    keys = {dispatch.lookup(operating_point(s, CTX)).key
            for s in (sp.blocks[1].mixer.qkv, sp.blocks[1].mixer.out,
                      sp.blocks[1].ffn.up, sp.lm_head)}
    assert keys == {("int8", "int8", "*"), ("ternary", "int8", "*"),
                    ("int4", "int8", "*")}


def _tables(b):
    """Disjoint contiguous page lists covering each row's whole cache."""
    max_pages = CACHE_LEN // PAGE_SIZE
    pages = np.zeros((b, max_pages), np.int32)
    for r in range(b):
        pages[r] = 1 + r * max_pages + np.arange(max_pages)
    return pages


@pytest.mark.parametrize("policy", ["binary", "ternary", "int8", "w-ternary",
                                    "mixed", "wt-a8", "w4a8", "het"])
def test_prefill_and_decode_logits_match(policy):
    """Bucket-padded prefill with last_pos, then two paged decode steps at
    per-row positions, against the JAX model (its gather path) in f32."""
    jcfg, tcfg, _, sparams = built(policy, n_layers=4)
    jctx = JCtx(mode="serve", backend="jnp", dtype=jnp.float32)
    jsp = jtransformer.build_specs(jcfg)
    tp = bridge.from_jax_params(np_tree(sparams), tcfg)
    tsp = transformer.build_specs(tcfg)
    b, bucket = 2, 16
    lens = np.asarray([9, 14], np.int32)
    toks = np.zeros((b, bucket), np.int32)
    for r, p in enumerate(prompts(jcfg, lens)):
        toks[r, :len(p)] = p
    jl, jc = jtransformer.prefill(sparams, jnp.asarray(toks), jsp, jctx,
                                  cache_len=CACHE_LEN, last_pos=lens - 1)
    tl, tc = transformer.prefill(tp, torch.from_numpy(toks), tsp, CTX,
                                 cache_len=CACHE_LEN, last_pos=lens - 1)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
    assert len(tc) == tcfg.n_layers
    # both sides' prefill KV, scattered into identical paged pools
    pages = _tables(b)
    num_pages = 1 + pages.max()
    jpaged = jtransformer.init_cache(jcfg, b, CACHE_LEN,
                                     paged=(num_pages, PAGE_SIZE),
                                     kv_dtype=jnp.float32)
    tpaged = transformer.init_cache(tcfg, num_pages, PAGE_SIZE,
                                    kv_dtype=torch.float32)
    flat = [jc["first"]] + [jax.tree.map(lambda a, i=i: a[i], jc["mid"]["b0"])
                            for i in range(2)] + [jc["last"]]
    for li, (jl_c, tl_c) in enumerate(zip(flat, tc)):
        for name in ("k", "v"):
            np.testing.assert_allclose(tl_c[name].numpy(), np.asarray(jl_c[name]),
                                       rtol=1e-4, atol=1e-4)
            body = tl_c[name].reshape(b, -1, PAGE_SIZE, *tl_c[name].shape[2:])
            for r in range(b):
                tpaged[li][name][torch.from_numpy(pages[r]).long()] = body[r]
    jpool = jax.tree.map(np.asarray, jpaged)
    for key, layer in (("first", 0), ("last", 3)):
        for name in ("k", "v"):
            jpool[key][name] = tpaged[layer][name].numpy().copy()
    for name in ("k", "v"):
        jpool["mid"]["b0"][name] = np.stack([tpaged[1][name].numpy(),
                                             tpaged[2][name].numpy()])
    jpool = jax.tree.map(jnp.asarray, jpool)
    pos = lens.copy()
    nxt = np.argmax(np.asarray(jl)[:, 0], axis=-1).astype(np.int32)[:, None]
    # jitted, as the JAX server runs it (eagerly, the scanned mid stack trips
    # the reference's concrete-pos page-table cut; ROADMAP queue 3)
    jdecode = jax.jit(lambda p, c, t, ps, pg: jtransformer.decode_step(
        p, c, t, ps, jsp, jctx, pages=pg))
    for _ in range(2):
        jl, jpool = jdecode(sparams, jpool, jnp.asarray(nxt), jnp.asarray(pos),
                            jnp.asarray(pages))
        tl, tpaged = transformer.decode_step(tp, tpaged, torch.from_numpy(nxt),
                                             torch.from_numpy(pos), tsp, CTX,
                                             pages=torch.from_numpy(pages))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
        nxt = np.argmax(np.asarray(jl)[:, 0], axis=-1).astype(np.int32)[:, None]
        pos = pos + 1
