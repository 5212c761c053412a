"""The port's MoE modules and its grouped expert GEMM (K11) against the JAX
package, on the CPU.

Bars:
  * grouped GEMM: for each body K11 serves (K1 int8, K3/K4 popcount, K7
    mxu, K8 trits x int8, K9 s4 x int8), the port's `harness.gemm_grouped`
    int32 accumulator equals JAX `harness.gemm_grouped(interpret=True,
    out="acc")` bit for bit, and its bf16 requant output equals the jnp
    formulation (`harness.requant` per member) bit for bit (the Pallas
    requant contracts to an FMA, ROADMAP queue 3, so it is not the
    yardstick); the grouped call equals a loop of `harness.gemm` per group
    member, bit for bit; the plane bodies (K10 over expert stacks) equal
    JAX's grouped accumulator too, on a full and on a truncated stack, and
    malformed operands are refused;
  * expert-stacked `qgemm` (twin of tests/test_dispatch.py
    `test_qgemm_expert_axis`): for every registered cell, E = 3, bias on,
    the port packs the JAX train weights into the JAX packed stack, and its
    output equals JAX `qgemm` (jnp backend): bit for bit for the int8-
    activation cells; within one bf16 rounding step for the binary and
    ternary activation cells (their per-row means are summed in another
    order, ROADMAP queue 3 "Float means"), whose int32 accumulators are
    held exact on JAX's own prepared operands, and for the weight-only and
    dense cells (an f32 sum in another order); the plane cells
    (impl="planes") are held bit for bit like the other int8-activation
    cells;
  * twins of tests/test_archs.py's MoE arms: router geometry, kept +
    dropped == B·S·top_k, the shared expert really contributes;
  * `moe_apply` against JAX `moe_apply` on the same packed params, in f32:
    y within 1e-4 (the bar of the port's logits), the routing counters
    equal, in a case with drops (capacity_factor 1.0) and a tie case (a
    zero router: every gate equal, the lowest indices win).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import one_torch_thread  # noqa: F401
from repro.configs import get_config as jget_config
from repro.core import precision as jprecision
from repro.core import qlinear as jqlinear
from repro.kernels import dispatch as jdispatch
from repro.kernels import harness as jharness
from repro.kernels import pgemm as pgemm_j
from repro.models import moe as jmoe
from repro.models.common import ModelCtx as JCtx
from repro_torch.bridge import to_torch
from repro_torch.configs import get_config
from repro_torch.core import precision as tprecision
from repro_torch.core import qlinear as tqlinear
from repro_torch.kernels import dispatch as tdispatch
from repro_torch.kernels import harness as tharness
from repro_torch.kernels import pgemm
from repro_torch.models import moe
from repro_torch.models.common import ModelCtx

#: weight-and-activation cells: the bodies K11 serves
GROUPED_CELLS = [("int8", "int8", "*"), ("binary", "binary", "popcount"),
                 ("ternary", "ternary", "popcount"), ("binary", "binary", "mxu"),
                 ("ternary", "ternary", "mxu"), ("ternary", "int8", "*"),
                 ("int4", "int8", "*")]
ALL_CELLS = sorted(jdispatch.cells())
CTX = ModelCtx(dtype=torch.float32)
JCTX = JCtx(mode="serve", backend="jnp", dtype=jnp.float32)


def _bits(a) -> np.ndarray:
    """bf16 (JAX or torch) as raw uint16 bits."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(a).view(np.uint16)


def _tree(t, fn):
    if isinstance(t, dict):
        return {k: _tree(v, fn) for k, v in t.items()}
    return fn(t)


def _to_port(tree):
    return _tree(tree, lambda a: to_torch(np.asarray(a)))


# -- the grouped GEMM (K11) ------------------------------------------------------

def _grouped_operands(body, g, m, n, k, rng):
    """Random numpy operands of `body` with a leading group axis: int8
    codes, or int32 words with every bit pattern; scales and bias f32."""
    def side(shape, per_unit, n_ops):
        if per_unit == 1:
            return [rng.integers(-127, 128, shape).astype(np.int8)
                    for _ in range(n_ops)]
        return [rng.integers(-2 ** 31, 2 ** 31, shape, dtype=np.int64).astype(np.int32)
                for _ in range(n_ops)]
    x = side((g, m, k // body.xk), body.xk, body.n_x)
    w = side((g, k // body.wk, n) if body.w_kmajor else (g, n, k // body.wk),
             body.wk, body.n_w)
    ws = rng.uniform(1e-3, 0.1, (g, n)).astype(np.float32)
    as_ = rng.uniform(0.1, 1.1, (g, m)).astype(np.float32)
    b = rng.standard_normal((g, n)).astype(np.float32)
    return x, w, ws, as_, b


def _jx(a):
    """A numpy operand as the reference stores it: int32 words as uint32."""
    return jnp.asarray(a.view(np.uint32) if a.dtype == np.int32 else a)


@pytest.mark.parametrize("m", [8, 16])
@pytest.mark.parametrize("key", GROUPED_CELLS, ids=lambda c: "/".join(c))
def test_grouped_gemm_bit_equal_to_jax_and_looped(key, m):
    g, k, n = 3, 256, 96
    jbody = jdispatch.lookup(jdispatch.OperatingPoint(*key)).body
    body = tdispatch.lookup(tdispatch.OperatingPoint(*key)).body
    x, w, ws, as_, b = _grouped_operands(body, g, m, n, k,
                                         np.random.default_rng(m + len(key[0])))
    want_acc = np.asarray(jharness.gemm_grouped(
        jbody, [_jx(a) for a in x], [_jx(a) for a in w], k=k, interpret=True,
        out="acc"))
    tx, tw = [torch.from_numpy(a) for a in x], [torch.from_numpy(a) for a in w]
    acc = tharness.gemm_grouped(body, tx, tw, None, None, k=k, out="acc")
    assert acc.dtype == torch.int32 and acc.shape == (g, m, n)
    np.testing.assert_array_equal(acc.numpy(), want_acc)
    for bias in (None, b):
        tb = None if bias is None else torch.from_numpy(bias)
        out = tharness.gemm_grouped(body, tx, tw, torch.from_numpy(ws),
                                    torch.from_numpy(as_), tb, k=k)
        assert out.dtype == torch.bfloat16 and out.shape == (g, m, n)
        want = np.stack([_bits(jharness.requant(
            jnp.asarray(want_acc[i]), jnp.asarray(ws[i]), jnp.asarray(as_[i]),
            None if bias is None else jnp.asarray(bias[i])).astype(jnp.bfloat16))
            for i in range(g)])
        np.testing.assert_array_equal(_bits(out), want)
        looped = torch.stack([tharness.gemm(
            body, [t[i] for t in tx], [t[i] for t in tw], torch.from_numpy(ws[i]),
            torch.from_numpy(as_[i]), None if tb is None else tb[i], k=k)
            for i in range(g)])
        np.testing.assert_array_equal(_bits(out), _bits(looped))
    looped_acc = torch.stack([tharness.gemm(body, [t[i] for t in tx],
                                            [t[i] for t in tw], None, None, k=k,
                                            out="acc") for i in range(g)])
    assert torch.equal(acc, looped_acc)


def test_grouped_gemm_refuses_planes_and_bad_shapes():
    """The plane bodies, once refused, run grouped: their accumulator
    equals JAX `gemm_grouped` on a (G, bits, N, K/32) stack and on its
    leading-P slice (read as a view); malformed operands are refused."""
    body = tdispatch.lookup(tdispatch.OperatingPoint("int4", "int8")).body
    x, w, ws, as_, _ = _grouped_operands(body, 2, 4, 32, 64,
                                         np.random.default_rng(0))
    tx, tw = [torch.from_numpy(a) for a in x], [torch.from_numpy(a) for a in w]
    rng = np.random.default_rng(1)
    stack = rng.integers(-2 ** 31, 2 ** 31, (2, 4, 32, 2), dtype=np.int64
                         ).astype(np.int32)
    for p in (4, 2):
        want = np.asarray(jharness.gemm_grouped(
            pgemm_j.PLANES_W4_I8A, [_jx(x[0])], [_jx(stack[:, :p])], k=64,
            interpret=True, out="acc"))
        got = tharness.gemm_grouped(pgemm.PLANES_W4_I8A, tx,
                                    [torch.from_numpy(stack)[:, :p]], None, None,
                                    k=64, out="acc")
        np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="leading group axis"):
        tharness.gemm_grouped(pgemm.PLANES_W4_I8A, tx, [torch.from_numpy(stack)[0]],
                              None, None, k=64, out="acc")
    with pytest.raises(ValueError, match="leading group axis"):
        tharness.gemm_grouped(body, [tx[0][0]], [tw[0][0]], None, None, k=64,
                              out="acc")
    with pytest.raises(ValueError, match="a_scale"):
        tharness.gemm_grouped(body, tx, tw, torch.from_numpy(ws),
                              torch.from_numpy(as_[:, :2]), k=64)
    meta = [t.to("meta") for t in tx]
    with pytest.raises(ValueError, match="unsupported device"):
        tharness.gemm_grouped(body, meta, tw, None, None, k=64, out="acc")


# -- expert-stacked qgemm ----------------------------------------------------------

def _expert_case(key, e=3, m=4, k=256, n=160, seed=3):
    """JAX and port specs of one cell with an expert stack, its train
    weights (numpy), the JAX packed stack and activations (e, m, k)."""
    rng = np.random.default_rng(seed)
    lq = jprecision.LayerQuant(jprecision.QuantSpec(key[0]),
                               jprecision.QuantSpec(key[1]))
    tlq = tprecision.LayerQuant(tprecision.QuantSpec(key[0]),
                                tprecision.QuantSpec(key[1]))
    jspec = jqlinear.QLinearSpec(k, n, lq, use_bias=True, experts=e)
    tspec = tqlinear.QLinearSpec(k, n, tlq, use_bias=True, experts=e)
    train = {"w": (rng.standard_normal((e, k, n)) / np.sqrt(k)).astype(np.float32),
             "b": (0.1 * rng.standard_normal((e, n))).astype(np.float32)}
    packed = jqlinear.pack_params({nm: jnp.asarray(v) for nm, v in train.items()},
                                  jspec)
    x = (0.2 * rng.standard_normal((e, m, k))).astype(np.float32)
    return jspec, tspec, train, packed, x


@pytest.mark.parametrize("key", ALL_CELLS, ids=lambda c: "/".join(c))
def test_qgemm_expert_axis_matches_jax(key):
    jspec, tspec, train, packed, x = _expert_case(key)
    e, m, k = x.shape
    # the port packs the same expert stack into the same leaves
    got = tqlinear.pack_params({nm: torch.from_numpy(v) for nm, v in train.items()},
                               tspec)
    assert sorted(got) == sorted(packed)
    for nm, j in packed.items():
        j = np.asarray(j)
        t = got[nm].view(torch.int16).numpy() if nm == "w" else got[nm].numpy()
        j = (j.view(np.int16) if nm == "w" else
             j.view(np.int32) if j.dtype == np.uint32 else j)
        assert t.shape == j.shape and t.dtype == j.dtype, nm
        if nm == "w_scale" and key[0] in ("binary", "ternary"):
            np.testing.assert_allclose(t, j, rtol=1e-6, atol=0)
        else:
            np.testing.assert_array_equal(t, j, err_msg=nm)
    op = jdispatch.OperatingPoint(*key)
    tp = _to_port(packed)
    top = tdispatch.OperatingPoint(*key)
    want = jdispatch.qgemm(packed, jnp.asarray(x), jspec, op)
    y = tdispatch.qgemm(tp, torch.from_numpy(x), tspec, top)
    assert y.dtype == torch.bfloat16 and y.shape == (e, m, tspec.out_dim)
    if key[1] == "int8":
        np.testing.assert_array_equal(_bits(y), _bits(want))
    else:
        np.testing.assert_allclose(y.float().numpy(),
                                   np.asarray(want.astype(jnp.float32)),
                                   rtol=2 ** -7, atol=1e-6)
    # expert slices differ: each expert's weights really were used
    assert (y[0] != y[1]).any()
    jcell = jdispatch.lookup(op)
    if key[1] in ("binary", "ternary"):
        # the accumulators, exact on JAX's own prepared operands
        preps = [jcell.prep(jnp.asarray(x[i]), packed, jspec) for i in range(e)]
        x_ops = [torch.stack([to_torch(np.asarray(pr[0][j])) for pr in preps])
                 for j in range(len(preps[0][0]))]
        w_ops = [tp[nm] for nm in jcell.weight_names]
        acc = tharness.gemm_grouped(tdispatch.lookup(top).body, x_ops, w_ops,
                                    None, None, k=k, out="acc")
        for i in range(e):
            want_acc = jcell.acc(preps[i][0], [packed[nm][i] for nm in
                                               jcell.weight_names], k)
            np.testing.assert_array_equal(acc[i].numpy(), np.asarray(want_acc))


# -- the MoE block -------------------------------------------------------------

def _reduced(arch, policy, **kw):
    jcfg = dataclasses.replace(jget_config(arch).reduced(), policy=policy, **kw)
    tcfg = dataclasses.replace(get_config(arch).reduced(), policy=policy, **kw)
    return jcfg, tcfg


def _port_block(arch, policy="het", seed=5):
    """Port MoE specs and packed params from the port's own seeded init."""
    _, tcfg = _reduced(arch, policy)
    specs = moe.moe_specs(tcfg, tprecision.get_policy(policy))
    gen = torch.Generator().manual_seed(seed)
    p = moe.moe_pack(moe.moe_init(gen, specs), specs)
    return tcfg, specs, p


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "phi3.5-moe-42b-a6.6b"])
def test_moe_router_topk_shapes(arch):
    cfg, specs, p = _port_block(arch)
    assert specs.router.in_dim == cfg.d_model
    assert specs.router.out_dim == cfg.n_experts
    assert specs.router.lq.weights.precision == "none"      # ALWAYS_WIDE
    assert specs.up.experts == specs.down.experts == cfg.n_experts
    assert 0 < specs.top_k <= specs.n_experts
    b, s = 2, 8
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32))
    y, aux = moe.moe_apply(p, x, specs, CTX)
    assert y.shape == x.shape and torch.isfinite(y).all()
    et = aux["expert_tokens"]
    assert et.shape == (cfg.n_experts,) and et.dtype == torch.int32
    assert int(et.sum()) + int(aux["dropped"]) == b * s * specs.top_k


def test_moe_shared_expert_path():
    cfg, specs, p = _port_block("deepseek-moe-16b")
    assert cfg.n_shared_experts == 1 and specs.shared is not None
    assert "shared" in p
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (1, 8, cfg.d_model)).astype(np.float32))
    y, _ = moe.moe_apply(p, x, specs, CTX)
    p0 = dict(p, shared={nm: {k: torch.zeros_like(v) for k, v in leaf.items()}
                         for nm, leaf in p["shared"].items()})
    y0, _ = moe.moe_apply(p0, x, specs, CTX)
    assert (y != y0).any()
    cfg_phi, specs_phi, p_phi = _port_block("phi3.5-moe-42b-a6.6b")
    assert specs_phi.shared is None and "shared" not in p_phi
    assert sorted(p_phi) == sorted(k for k in p if k != "shared")


def _jax_packed_block(jcfg, seed, zero_router=False):
    specs = jmoe.moe_specs(jcfg, jprecision.get_policy(jcfg.policy))
    p = jmoe.moe_init(jax.random.PRNGKey(seed), specs)
    if zero_router:
        p["router"] = {"w": jnp.zeros_like(p["router"]["w"])}
    packed = {nm: jqlinear.pack_params(p[nm], getattr(specs, nm))
              for nm in ("router", "up", "down")}
    if specs.shared is not None:
        packed["shared"] = {nm: jqlinear.pack_params(p["shared"][nm],
                                                     getattr(specs.shared, nm))
                            for nm in ("up", "down")}
    return packed


@pytest.mark.parametrize("arch,policy,b,s,kw", [
    ("deepseek-moe-16b", "het", 2, 8, {}),
    ("phi3.5-moe-42b-a6.6b", "w-ternary", 2, 8, {}),
    ("deepseek-moe-16b", "het", 2, 32, {"capacity_factor": 1.0}),     # drops
    ("phi3.5-moe-42b-a6.6b", "het", 1, 16, {"capacity_factor": 1.0}),
    ("deepseek-moe-16b", "w-ternary", 2, 8, {"zero_router": True}),   # ties
], ids=["deepseek-het", "phi-wternary", "deepseek-drops", "phi-drops",
        "deepseek-ties"])
def test_moe_apply_matches_jax(arch, policy, b, s, kw):
    kw = dict(kw)
    zero_router = kw.pop("zero_router", False)
    jcfg, tcfg = _reduced(arch, policy, **kw)
    packed = _jax_packed_block(jcfg, seed=s + b, zero_router=zero_router)
    jspecs = jmoe.moe_specs(jcfg, jprecision.get_policy(policy))
    tspecs = moe.moe_specs(tcfg, tprecision.get_policy(policy))
    x = np.random.default_rng(s).standard_normal((b, s, jcfg.d_model)).astype(
        np.float32)
    jy, jaux = jmoe.moe_apply(packed, jnp.asarray(x), jspecs, JCTX)
    y, aux = moe.moe_apply(_to_port(packed), torch.from_numpy(x), tspecs, CTX)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(aux["expert_tokens"].numpy(),
                                  np.asarray(jaux["expert_tokens"]))
    assert int(aux["dropped"]) == int(jaux["dropped"])
    et = aux["expert_tokens"].numpy()
    assert et.sum() + int(aux["dropped"]) == b * s * tspecs.top_k
    if "capacity_factor" in kw:
        assert int(aux["dropped"]) > 0
    if zero_router:
        # equal gates: every token takes experts 0 .. top_k-1, capacity
        # per batch row, the rest dropped
        c = moe._capacity(s, tspecs)
        want = np.zeros(tspecs.n_experts, np.int64)
        want[:tspecs.top_k] = b * min(s, c)
        np.testing.assert_array_equal(et, want)


def test_top_k_ties_go_to_the_lowest_index():
    g = torch.tensor([[0.1, 0.3, 0.3, 0.2, 0.3], [0.2] * 5])
    v, i = moe.top_k(g, 3)
    assert i.tolist() == [[1, 2, 4], [0, 1, 2]]
    jv, ji = jax.lax.top_k(jnp.asarray(g.numpy()), 3)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
