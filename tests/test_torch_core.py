"""The PyTorch port's core against the JAX package: configs, precision
tables, quantizers, bit-plane packing and `qlinear.pack_params`, on the same
inputs (made with numpy from a seed), plus the static rule that the port
imports neither JAX nor the JAX package.

Bars: packed words, int8 codes and every integer result are bit-identical.
Float means (the binary/ternary per-channel `w_scale`) are summed in another
order by torch than by XLA, so they agree to a few ulp (rtol 1e-6), not bit
for bit — the kernel tests feed both sides identical scales for that reason.
"""
import ast
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import pack as jpack
from repro.core import precision as jprecision
from repro.core import qlinear as jqlinear
from repro.core import quantize as jquantize
from repro_torch import configs as tconfigs
from repro_torch.core import pack as tpack
from repro_torch.core import precision as tprecision
from repro_torch.core import qlinear as tqlinear
from repro_torch.core import quantize as tquantize

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _i32(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.uint32 else a


def _words(rng, shape):
    """Random 32-bit words, about half with the sign bit set."""
    return rng.integers(0, 2 ** 32, size=shape, dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_configs_match(arch):
    j, t = jconfigs.get_config(arch), tconfigs.get_config(arch)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert dataclasses.asdict(j.reduced()) == dataclasses.asdict(t.reduced())


def test_precision_tables_match():
    assert tprecision.LAYER_CLASSES == jprecision.LAYER_CLASSES
    assert tprecision.ALWAYS_WIDE == jprecision.ALWAYS_WIDE
    assert sorted(tprecision.POLICIES) == sorted(jprecision.POLICIES)
    for name, jp in jprecision.POLICIES.items():
        tp = tprecision.POLICIES[name]
        for lc in jprecision.LAYER_CLASSES:
            for first, last in ((False, False), (True, False), (False, True)):
                a = jp.lookup(lc, is_first=first, is_last=last)
                b = tp.lookup(lc, is_first=first, is_last=last)
                assert dataclasses.asdict(a) == dataclasses.asdict(b), (name, lc)
    assert tquantize.BITS == jquantize.BITS


@pytest.mark.parametrize("shape", [(3, 32), (4, 128), (2, 5, 96)])
def test_pack_bits_bit_identical(shape):
    rng = np.random.default_rng(sum(shape))
    codes = rng.integers(0, 2, size=shape).astype(np.uint8)
    codes[..., 31] = 1                      # bit 31 set: the sign bit of int32
    j = _i32(jpack.pack_bits(jnp.asarray(codes)))
    t = tpack.pack_bits(torch.from_numpy(codes))
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(t.numpy(), j)
    assert (t.numpy() < 0).any()
    k = shape[-1]
    np.testing.assert_array_equal(tpack.unpack_bits(t, k).numpy(), codes)
    np.testing.assert_array_equal(
        tpack.unpack_pm1_i8(t, k).numpy(), np.asarray(jpack.unpack_pm1_i8(
            jnp.asarray(j.view(np.uint32)), k)))


def test_pack_binary_and_ternary_bit_identical():
    rng = np.random.default_rng(1)
    v = rng.standard_normal((6, 64)).astype(np.float32)
    v[0, :8] = 0.0
    np.testing.assert_array_equal(
        tpack.pack_binary(torch.from_numpy(v)).numpy(),
        _i32(jpack.pack_binary(jnp.asarray(v))))
    trits = rng.integers(-1, 2, size=(6, 64)).astype(np.float32)
    jm, js = jpack.pack_ternary(jnp.asarray(trits))
    tm, ts = tpack.pack_ternary(torch.from_numpy(trits))
    np.testing.assert_array_equal(tm.numpy(), _i32(jm))
    np.testing.assert_array_equal(ts.numpy(), _i32(js))
    np.testing.assert_array_equal(tpack.unpack_ternary_i8(tm, ts, 64).numpy(),
                                  trits.astype(np.int8))


def test_popcount_and_dot_words_bit_identical():
    rng = np.random.default_rng(2)
    x, w = _words(rng, (5, 1, 4)), _words(rng, (7, 4))
    xs, ws = _words(rng, (5, 1, 4)), _words(rng, (7, 4))
    t = lambda a: torch.from_numpy(a.view(np.int32))
    allones = torch.tensor([-1, 0, 2 ** 31 - 1, -(2 ** 31)], dtype=torch.int32)
    np.testing.assert_array_equal(tpack.popcount32(allones).numpy(), [32, 0, 31, 1])
    np.testing.assert_array_equal(
        tpack.binary_dot_words(t(x), t(w), 128).numpy(),
        np.asarray(jpack.binary_dot_words(jnp.asarray(x), jnp.asarray(w), 128)))
    np.testing.assert_array_equal(
        tpack.ternary_dot_words(t(x), t(xs), t(w), t(ws)).numpy(),
        np.asarray(jpack.ternary_dot_words(jnp.asarray(x), jnp.asarray(xs),
                                           jnp.asarray(w), jnp.asarray(ws))))


def test_quantizers_bit_identical():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 96)).astype(np.float32)
    x[0, :4] = [0.5, -0.5, 1.5, 2.5]        # exact halves: half-to-even
    s = np.float32(0.05)
    np.testing.assert_array_equal(
        tquantize.int8_codes(torch.from_numpy(x), torch.tensor(s)).numpy(),
        np.asarray(jquantize.int8_codes(jnp.asarray(x), s)))
    np.testing.assert_array_equal(
        tquantize.int8_codes(torch.from_numpy(x), torch.tensor(1.0)).numpy()[0, :4],
        [0, 0, 2, 2])
    np.testing.assert_array_equal(
        tquantize.int8_scale(torch.from_numpy(x), axis=(0,)).numpy(),
        np.asarray(jquantize.int8_scale(jnp.asarray(x), axis=(0,))))
    for axis in (None, -1):
        np.testing.assert_array_equal(
            tquantize.ternarize(torch.from_numpy(x), 0.05, axis=axis).numpy(),
            np.asarray(jquantize.ternarize(jnp.asarray(x), 0.05, axis=axis)))


def test_int4_quantizers_and_packing_bit_identical():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((6, 64)).astype(np.float32)
    x[0, :4] = [3.5, -3.5, 2.5, -0.5]       # exact halves at scale 1
    for axis in (None, -1):
        js = jquantize.int4_scale(jnp.asarray(x), axis=axis)
        ts = tquantize.int4_scale(torch.from_numpy(x), axis=axis)
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        jc = jquantize.int4_codes(jnp.asarray(x), js)
        tc = tquantize.int4_codes(torch.from_numpy(x), ts)
        assert tc.dtype == torch.int8
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(
        tquantize.int4_codes(torch.from_numpy(x), torch.tensor(1.0)).numpy()[0, :4],
        [4, -4, 2, 0])
    # every s4 code, so that words with the top nibble >= 8 (sign bit) occur
    codes = rng.integers(-8, 8, size=(5, 96)).astype(np.int8)
    codes[:, 7] = -8                         # the top nibble of word 0: 0x8
    j = _i32(jpack.pack_int4(jnp.asarray(codes)))
    t = tpack.pack_int4(torch.from_numpy(codes))
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(t.numpy(), j)
    assert (t.numpy()[:, 0] < 0).all()
    np.testing.assert_array_equal(tpack.unpack_int4_i8(t, 96).numpy(), codes)
    np.testing.assert_array_equal(
        tpack.unpack_int4_i8(t, 96).numpy(),
        np.asarray(jpack.unpack_int4_i8(jnp.asarray(j.view(np.uint32)), 96)))


#: policies whose body covers every weight precision, with int8 and bf16
#: activations beside it
PACK_POLICIES = ["binary", "ternary", "int8", "w4a8", "w-int4", "wt-a8",
                 "w-ternary", "none"]


@pytest.mark.parametrize("prec", PACK_POLICIES)
@pytest.mark.parametrize("in_dim,out_dim,bias", [(128, 256, False),
                                                 (256, 96, True)])
def test_pack_params_match(prec, in_dim, out_dim, bias):
    rng = np.random.default_rng(in_dim + out_dim)
    p = {"w": (rng.standard_normal((in_dim, out_dim)) / np.sqrt(in_dim)
               ).astype(np.float32)}
    if bias:
        p["b"] = rng.standard_normal(out_dim).astype(np.float32)
    jspec = jqlinear.QLinearSpec(in_dim, out_dim, jprecision.POLICIES[prec].body,
                                 use_bias=bias)
    tspec = tqlinear.QLinearSpec(in_dim, out_dim, tprecision.POLICIES[prec].body,
                                 use_bias=bias)
    want = jqlinear.pack_params({k: jnp.asarray(v) for k, v in p.items()}, jspec)
    got = tqlinear.pack_params({k: torch.from_numpy(v) for k, v in p.items()}, tspec)
    # int4/int8 weights with int8 activations carry the stacked plane twin
    # (w_planes, int32 words with the reference's uint32 bits)
    assert ("w_planes" in want) == (prec in ("int8", "w4a8"))
    assert sorted(got) == sorted(want)
    wprec = jprecision.POLICIES[prec].body.weights.precision
    for name, j in want.items():
        if name == "w":                      # dense bf16 weights: compare bits
            assert got[name].dtype == torch.bfloat16
            np.testing.assert_array_equal(got[name].view(torch.int16).numpy(),
                                          np.asarray(j).view(np.int16))
            continue
        j, t = _i32(j), got[name].numpy()
        assert t.dtype == j.dtype and t.shape == j.shape, name
        if name == "w_scale" and wprec in ("binary", "ternary"):
            np.testing.assert_allclose(t, j, rtol=1e-6, atol=0)
        else:
            np.testing.assert_array_equal(t, j, err_msg=name)


def _imports(path):
    tree = ast.parse(open(path, encoding="utf-8").read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") in (
                "import_module",) and node.args and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value)


def test_port_imports_no_jax_and_no_reference():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "src", "repro_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 15
    bad = [(os.path.relpath(f, REPO), m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, bad
