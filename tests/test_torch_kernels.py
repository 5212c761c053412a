"""The port's kernels' plain versions against the JAX package.

GEMM bar, per weight-and-activation cell (binary and ternary popcount and
mxu, int8, ternary x int8, int4 x int8): fed the same packed operands and
scales, the port's int32 accumulator and bf16 output are bit-equal to the
JAX Pallas body in interpret mode and to the jnp formulation `qgemm` runs,
with and without bias, at ragged M; the mxu accumulators equal the popcount
ones. Weight-only and dense cells (no kernel body on either side) agree
with the jnp `qgemm` to within one bf16 rounding step. Paged decode bar:
the port's plain version matches JAX `paged_flash_decode(interpret=True)`
to 2e-5 in f32, the bar of tests/test_paged_attn.py. Flash-attention bar:
the plain version matches JAX `flash_attention(interpret=True)` to 2e-4 in
f32 and 3e-2 in bf16, the bars of tests/test_flash_attn.py. The CUDA
kernels are held against these plain versions on the card by
tests/test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import precision as jprecision
from repro.core import qlinear as jqlinear
from repro.kernels import dispatch as jdispatch
from repro.kernels import harness as jharness
from repro.kernels import ref as jref
from repro.kernels.flash_attn import flash_attention as jflash
from repro.kernels.paged_attn import paged_flash_decode as jpaged
from repro_torch.bridge import to_torch
from repro_torch.core import precision as tprecision
from repro_torch.core import qlinear as tqlinear
from repro_torch.kernels import dispatch as tdispatch
from repro_torch.kernels import flash_attn as tflash
from repro_torch.kernels import harness as tharness
from repro_torch.kernels import paged_attn as tpaged

#: weight-and-activation cells: a CUDA kernel body in the port
CELLS = [("binary", "binary", "popcount"), ("ternary", "ternary", "popcount"),
         ("int8", "int8", "*"), ("binary", "binary", "mxu"),
         ("ternary", "ternary", "mxu"), ("ternary", "int8", "*"),
         ("int4", "int8", "*")]
#: weight-only and dense cells: torch ops on both sides
WONLY_CELLS = [("binary", "none", "*"), ("ternary", "none", "*"),
               ("int4", "none", "*"), ("int8", "none", "*"), ("none", "none", "*")]
#: a policy whose body layers run each (wprec, aprec) pair
POLICY_OF = {("binary", "binary"): "binary", ("ternary", "ternary"): "ternary",
             ("int8", "int8"): "int8", ("ternary", "int8"): "wt-a8",
             ("int4", "int8"): "w4a8", ("binary", "none"): "w-binary",
             ("ternary", "none"): "w-ternary", ("int4", "none"): "w-int4",
             ("int8", "none"): "w-int8", ("none", "none"): "none"}


def _bits(a) -> np.ndarray:
    """bf16 (JAX or torch) as raw uint16 bits."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(a).view(np.uint16)


def _setup_cell(key, m, k, n, bias, seed):
    """Packed weights (JAX pack_params) and JAX-prepared activation operands
    for one cell; returns (jax dict, torch dict) of identical operands."""
    rng = np.random.default_rng(seed)
    pol_name = POLICY_OF[key[:2]]
    jspec = jqlinear.QLinearSpec(k, n, jprecision.POLICIES[pol_name].body,
                                 use_bias=bias)
    p = {"w": jnp.asarray((rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32))}
    if bias:
        p["b"] = jnp.asarray(rng.standard_normal(n).astype(np.float32))
    packed = jqlinear.pack_params(p, jspec)
    jcell = jdispatch.lookup(jdispatch.OperatingPoint(*key))
    x = jnp.asarray(rng.standard_normal((m, k)).astype(np.float32))
    x_ops, a_scale = jcell.prep(x, packed, jspec)
    j = {"cell": jcell, "x_ops": x_ops, "a_scale": a_scale, "packed": packed,
         "w_ops": tuple(packed[nm] for nm in jcell.weight_names), "x": x}
    t = {"cell": tdispatch.lookup(tdispatch.OperatingPoint(*key)),
         "x_ops": tuple(to_torch(np.asarray(o)) for o in x_ops),
         "a_scale": None if a_scale is None else to_torch(np.asarray(a_scale)),
         "w_ops": tuple(to_torch(np.asarray(o)) for o in j["w_ops"]),
         "w_scale": (to_torch(np.asarray(packed["w_scale"]))
                     if "w_scale" in packed else None),
         "bias": to_torch(np.asarray(packed["b"])) if bias else None,
         "packed": {nm: to_torch(np.asarray(v)) for nm, v in packed.items()},
         "spec": tqlinear.QLinearSpec(k, n, tprecision.POLICIES[pol_name].body,
                                      use_bias=bias),
         "x": to_torch(np.asarray(x))}
    return j, t


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("m", [1, 5, 12])
@pytest.mark.parametrize("key", CELLS, ids=lambda c: "/".join(c))
def test_gemm_bit_equal_to_pallas_and_jnp(key, m, bias):
    k, n = 128, 96
    j, t = _setup_cell(key, m, k, n, bias, seed=m * 7 + bias)
    jb = j["packed"].get("b")
    acc_pallas = jharness.gemm(j["cell"].body, j["x_ops"], j["w_ops"], None, None,
                               k=k, interpret=True, out="acc")
    out_pallas = jharness.gemm(j["cell"].body, j["x_ops"], j["w_ops"],
                               j["packed"]["w_scale"], j["a_scale"], jb, k=k,
                               interpret=True)
    acc_jnp = j["cell"].acc(j["x_ops"], j["w_ops"], k)
    out_jnp = jharness.requant(acc_jnp, j["packed"]["w_scale"], j["a_scale"],
                               jb).astype(jnp.bfloat16)
    body = t["cell"].body
    acc = tharness.gemm(body, t["x_ops"], t["w_ops"], None, None, k=k, out="acc")
    out = tharness.gemm(body, t["x_ops"], t["w_ops"], t["w_scale"], t["a_scale"],
                        t["bias"], k=k)
    assert acc.dtype == torch.int32 and out.dtype == torch.bfloat16
    np.testing.assert_array_equal(acc.numpy(), np.asarray(acc_pallas))
    np.testing.assert_array_equal(acc.numpy(), np.asarray(acc_jnp))
    np.testing.assert_array_equal(_bits(out), _bits(out_jnp))
    # Reference fault (ROADMAP queue 3): in interpret mode on the CPU, XLA
    # may contract the Pallas epilogue's `* a_scale + bias` into one fused
    # multiply-add, so the Pallas body can differ from its own jnp
    # formulation by one bf16 step. The port never contracts: it equals the
    # Pallas body wherever the reference agrees with itself, and elsewhere
    # the Pallas value is exactly the FMA rounding.
    agree = _bits(out_pallas) == _bits(out_jnp)
    np.testing.assert_array_equal(_bits(out)[agree], _bits(out_pallas)[agree])
    if not agree.all():
        ws = np.asarray(j["packed"]["w_scale"])
        y = np.asarray(acc_jnp).astype(np.float32) * ws[None, :]
        fma = (y.astype(np.float64) * np.asarray(j["a_scale"])[:, None]
               + (0.0 if jb is None else np.asarray(jb)[None, :]))
        fma_bits = _bits(torch.from_numpy(fma.astype(np.float32)).to(torch.bfloat16))
        np.testing.assert_array_equal(_bits(out_pallas)[~agree], fma_bits[~agree])


@pytest.mark.parametrize("key", CELLS + WONLY_CELLS, ids=lambda c: "/".join(c))
def test_qgemm_matches_jnp_qgemm(key):
    """End to end through each side's own activation prep. The packed
    activation words are bit-identical; the binary/ternary per-row
    a_scale = mean|x| is summed in another order than XLA's, and the
    weight-only cells' f32 sum of bf16 products is too, before each side
    rounds it to bf16: those outputs agree to within one bf16 rounding
    step. The int8-activation cells are bit-equal."""
    m, k, n = 6, 256, 160
    j, t = _setup_cell(key, m, k, n, True, seed=11)
    jspec = jqlinear.QLinearSpec(k, n, jprecision.POLICIES[POLICY_OF[key[:2]]].body,
                                 use_bias=True)
    want = jdispatch.qgemm(j["packed"], j["x"][None], jspec,
                           jdispatch.OperatingPoint(*key))[0]
    x_ops, a_scale = t["cell"].prep(t["x"], t["packed"], t["spec"])
    for got_op, want_op in zip(x_ops, t["x_ops"]):
        assert torch.equal(got_op, want_op)
    if a_scale is not None:
        np.testing.assert_allclose(a_scale.numpy(), t["a_scale"].numpy(), rtol=1e-6)
    got = tdispatch.qgemm(t["packed"], t["x"][None], t["spec"],
                          tdispatch.OperatingPoint(*key))[0]
    assert got.dtype == torch.bfloat16
    if key[1] == "int8":
        np.testing.assert_array_equal(_bits(got), _bits(want))
    else:
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want.astype(jnp.float32)),
                                   rtol=2 ** -7, atol=1e-6)


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("m,k,n", [(3, 256, 40), (16, 512, 200), (2, 1024, 8)])
@pytest.mark.parametrize("key", CELLS[3:], ids=lambda c: "/".join(c))
def test_new_bodies_over_shapes(key, m, k, n, bias):
    """The mxu, w-ternary x a-int8 and w-int4 x a-int8 bodies over more
    M/K/N: the plain version's int32 accumulator equals the JAX jnp
    formulation's, and its bf16 output equals `harness.requant` on the same
    scales, bit for bit."""
    j, t = _setup_cell(key, m, k, n, bias, seed=m * k + n)
    acc = tharness.gemm(t["cell"].body, t["x_ops"], t["w_ops"], None, None, k=k,
                        out="acc")
    want_acc = j["cell"].acc(j["x_ops"], j["w_ops"], k)
    np.testing.assert_array_equal(acc.numpy(), np.asarray(want_acc))
    out = tharness.gemm(t["cell"].body, t["x_ops"], t["w_ops"], t["w_scale"],
                        t["a_scale"], t["bias"], k=k)
    want = jharness.requant(want_acc, j["packed"]["w_scale"], j["a_scale"],
                            j["packed"].get("b")).astype(jnp.bfloat16)
    np.testing.assert_array_equal(_bits(out), _bits(want))


@pytest.mark.parametrize("m,k,n", [(1, 128, 96), (5, 256, 40), (12, 512, 64)])
@pytest.mark.parametrize("wprec", ["binary", "ternary"])
def test_mxu_accumulator_equals_popcount(wprec, m, k, n):
    """The mxu body's integer dot is the popcount body's, bit for bit, on
    every side: port mxu == port popcount == JAX jnp mxu."""
    j, t = _setup_cell((wprec, wprec, "mxu"), m, k, n, False, seed=m + k)
    pop = tdispatch.lookup(tdispatch.OperatingPoint(wprec, wprec, "popcount"))
    a = tharness.gemm(t["cell"].body, t["x_ops"], t["w_ops"], None, None, k=k,
                      out="acc")
    b = tharness.gemm(pop.body, t["x_ops"], t["w_ops"], None, None, k=k, out="acc")
    assert torch.equal(a, b)
    np.testing.assert_array_equal(a.numpy(), np.asarray(
        j["cell"].acc(j["x_ops"], j["w_ops"], k)))


@pytest.mark.parametrize("m,k,n", [(8, 128, 64), (16, 256, 128), (32, 512, 256),
                                   (128, 1024, 128)])
def test_w4a8_oracle(m, k, n):
    """The K9 oracle (ROADMAP queue 3). With bias, the reference's Pallas
    INT4_W_I8A fails its own test against `ref.i4_gemm_ref`
    (tests/test_kernels.py::test_i4gemm_matches_ref[True-*]). The port
    follows the jnp formulation (`_acc_wint4_aint8` + `harness.requant`),
    which equals `ref.i4_gemm_ref` bit for bit; the Pallas body differs from
    it only where XLA fused `* a_scale + bias` into one FMA."""
    rng = np.random.default_rng(m + k + n)
    codes = rng.integers(-7, 8, (n, k)).astype(np.int8)
    xq = rng.integers(-127, 128, (m, k)).astype(np.int8)
    wsc = rng.uniform(0.01, 0.1, n).astype(np.float32)
    asc = rng.uniform(0.01, 0.1, m).astype(np.float32)
    bias = rng.standard_normal(n).astype(np.float32)
    from repro.core import pack as jpack
    wq4 = jpack.pack_int4(jnp.asarray(codes))
    want = _bits(jref.i4_gemm_ref(jnp.asarray(xq), wq4, k, jnp.asarray(wsc),
                                  jnp.asarray(asc), jnp.asarray(bias)))
    body = tdispatch.lookup(tdispatch.OperatingPoint("int4", "int8")).body
    got = tharness.gemm(body, (torch.from_numpy(xq),), (to_torch(np.asarray(wq4)),),
                        torch.from_numpy(wsc), torch.from_numpy(asc),
                        torch.from_numpy(bias), k=k)
    np.testing.assert_array_equal(_bits(got), want)
    jcell = jdispatch.lookup(jdispatch.OperatingPoint("int4", "int8", "*"))
    pallas = _bits(jharness.gemm(jcell.body, (jnp.asarray(xq),), (wq4,),
                                 jnp.asarray(wsc), jnp.asarray(asc),
                                 jnp.asarray(bias), k=k, interpret=True))
    off = pallas != want
    acc = tharness.gemm(body, (torch.from_numpy(xq),), (to_torch(np.asarray(wq4)),),
                        None, None, k=k, out="acc").numpy()
    fma = ((acc.astype(np.float32) * wsc[None, :]).astype(np.float64)
           * asc[:, None] + bias[None, :]).astype(np.float32)
    np.testing.assert_array_equal(pallas[off], _bits(torch.from_numpy(fma).to(
        torch.bfloat16))[off])


def test_unported_cell_and_device_raise():
    """A key neither package registers raises KeyError on both sides (the
    plane cells are registered now); a tensor on an unsupported device
    raises in the wrapper."""
    for key in (("binary", "int8", "popcount"), ("int4", "ternary", "planes")):
        with pytest.raises(KeyError):
            jdispatch.lookup(jdispatch.OperatingPoint(*key))
        with pytest.raises(KeyError, match="no GEMM registered"):
            tdispatch.lookup(tdispatch.OperatingPoint(*key))
    assert (tdispatch.lookup(tdispatch.OperatingPoint("int8", "int8", "planes")).key
            == ("int8", "int8", "planes"))
    _, t = _setup_cell(CELLS[0], 4, 64, 32, False, seed=0)
    meta = tuple(o.to("meta") for o in t["x_ops"])
    with pytest.raises(ValueError, match="unsupported device"):
        tharness.gemm(t["cell"].body, meta, t["w_ops"], None, None, k=64, out="acc")


# -- paged decode --------------------------------------------------------------

def _paged_setup(seed, b, max_pages, page_size, hk, hq, dh, int8, shared=False):
    """Random pool, per-row page lists and positions (numpy). With `shared`,
    every row maps the same first two physical pages (an aliased prefix)."""
    rng = np.random.default_rng(seed)
    num_pages = 1 + b * max_pages
    q = rng.standard_normal((b, hq, dh)).astype(np.float32)
    if int8:
        kp = rng.integers(-127, 128, size=(num_pages, page_size, hk, dh)).astype(np.int8)
        vp = rng.integers(-127, 128, size=(num_pages, page_size, hk, dh)).astype(np.int8)
    else:
        kp = rng.standard_normal((num_pages, page_size, hk, dh)).astype(np.float32)
        vp = rng.standard_normal((num_pages, page_size, hk, dh)).astype(np.float32)
    pos = rng.integers(0, max_pages * page_size, size=(b,)).astype(np.int32)
    if shared:
        pos = np.maximum(pos, 2 * page_size)
    pages = np.zeros((b, max_pages), np.int32)
    for r in range(b):
        n_active = int(pos[r]) // page_size + 1
        pages[r, :n_active] = 1 + r * max_pages + np.arange(n_active)
        if shared:
            pages[r, :2] = [1, 2]
    return q, kp, vp, pages, pos


@pytest.mark.parametrize("b,max_pages,page_size,hk,hq,dh", [
    (2, 8, 4, 4, 4, 32),      # MHA
    (3, 8, 4, 2, 4, 32),      # GQA g=2 (the reduced-llama serve geometry)
    (2, 16, 8, 1, 4, 64),     # MQA, bigger pages
])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("shared", [False, True])
def test_paged_plain_matches_jax_kernel(b, max_pages, page_size, hk, hq, dh,
                                        int8, shared):
    q, kp, vp, pages, pos = _paged_setup(b * max_pages + dh + shared, b, max_pages,
                                         page_size, hk, hq, dh, int8, shared)
    want = jpaged(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                  jnp.asarray(pages), jnp.asarray(pos), pages_per_block=4,
                  kv_scale=0.05, interpret=True)
    got = tpaged.paged_flash_decode(*(torch.from_numpy(a) for a in
                                      (q, kp, vp, pages, pos)), kv_scale=0.05)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


# -- flash attention (prefill) ---------------------------------------------------

@pytest.mark.parametrize("bh,bhk,tq,tk,dh,causal", [
    (4, 4, 256, 256, 64, True), (4, 4, 256, 256, 64, False),    # MHA
    (6, 2, 256, 256, 64, True), (6, 2, 256, 256, 64, False),    # GQA g=3
    (4, 1, 256, 256, 32, True), (4, 1, 256, 256, 32, False),    # MQA
    (2, 2, 256, 512, 128, False),                               # tq != tk
])
def test_flash_plain_matches_jax_kernel(bh, bhk, tq, tk, dh, causal):
    """The shapes and f32 bar of tests/test_flash_attn.py, at the block size
    the models use (256). The reference's (BH, T, dh) layout is the port's
    (B, H, T, dh) with B = 1."""
    rng = np.random.default_rng(bh * tq + dh)
    q = rng.standard_normal((bh, tq, dh)).astype(np.float32)
    k = rng.standard_normal((bhk, tk, dh)).astype(np.float32)
    v = rng.standard_normal((bhk, tk, dh)).astype(np.float32)
    want = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                  interpret=True)
    got = tflash.flash_attention(*(torch.from_numpy(a)[None] for a in (q, k, v)),
                                 causal=causal)[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)


def test_flash_plain_matches_jax_kernel_bf16():
    rng = np.random.default_rng(9)
    q, k, v = (rng.standard_normal((2, 256, 64)).astype(np.float32) for _ in range(3))
    jb = [jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)]
    want = jflash(*jb, causal=True, interpret=True)
    got = tflash.flash_attention(*(to_torch(np.asarray(a))[None] for a in jb))[0]
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=3e-2, atol=3e-2)
