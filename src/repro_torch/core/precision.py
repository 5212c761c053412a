"""Per-layer mixed-precision policy — the paper's central flexibility claim.

BrainTTA's motivation (§II-A): "some layers are more resilient to quantization
than others", so the architecture supports *mixed* precision — different
weight/activation bit-widths per layer, typically keeping the first and last
layers wide. A `PrecisionPolicy` assigns a `QuantSpec` pair (weights,
activations) to every *layer class* in a model, with first/last-layer
overrides, mirroring how a compiler would annotate the network graph for the
SoC.

Layer classes used by the model zoo:
  embed, attn_qkv, attn_out, ffn_up, ffn_down, moe_expert, moe_router,
  ssm_proj, lm_head
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

from .quantize import Precision, QuantSpec

LAYER_CLASSES = (
    "embed", "attn_qkv", "attn_out", "ffn_up", "ffn_down",
    "moe_expert", "moe_router", "ssm_proj", "lm_head",
)

#: layer classes that stay high-precision no matter the policy (router logits
#: and embeddings are tiny but accuracy-critical — the paper's "sensitive
#: layers stay wide" rule).
ALWAYS_WIDE = ("moe_router", "embed")


@dataclasses.dataclass(frozen=True)
class LayerQuant:
    """Quantization of one layer: weights and activations may differ."""
    weights: QuantSpec = QuantSpec("none")
    acts: QuantSpec = QuantSpec("none")

    @property
    def tag(self) -> str:
        return f"w{self.weights.precision[:3]}/a{self.acts.precision[:3]}"


def _lq(w: Precision, a: Precision) -> LayerQuant:
    return LayerQuant(QuantSpec(w), QuantSpec(a))


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """Maps layer classes to LayerQuant, with first/last layer overrides.

    `body` applies to every matmul layer class unless overridden in `per_class`.
    `first_last` overrides layers inside the first/last transformer block and
    the lm_head/embed (the classic mixed-precision recipe from the paper's
    conclusion: "mitigate accuracy loss in layers that are most adversely
    affected ... typically the first and last layer").
    """
    name: str
    body: LayerQuant
    first_last: LayerQuant = _lq("int8", "int8")
    per_class: Mapping[str, LayerQuant] = dataclasses.field(default_factory=dict)

    def lookup(self, layer_class: str, *, is_first: bool = False, is_last: bool = False) -> LayerQuant:
        if layer_class in ALWAYS_WIDE:
            return LayerQuant()
        if layer_class in self.per_class:
            return self.per_class[layer_class]
        if is_first or is_last:
            return self.first_last
        return self.body


# -- canonical policies (selectable via --precision) --------------------------

POLICIES: dict[str, PrecisionPolicy] = {
    # paper's three headline operating points, applied uniformly — the PURE
    # policies quantize first/last too (Table I single-precision columns);
    # "mixed" is the paper's accuracy recipe (first/last stay int8)
    "binary": PrecisionPolicy("binary", body=_lq("binary", "binary"),
                              first_last=_lq("binary", "binary")),
    "ternary": PrecisionPolicy("ternary", body=_lq("ternary", "ternary"),
                               first_last=_lq("ternary", "ternary")),
    "int8": PrecisionPolicy("int8", body=_lq("int8", "int8"),
                            first_last=_lq("int8", "int8")),
    # mixed: the recipe the paper advocates — int8 first/last, ternary body
    "mixed": PrecisionPolicy("mixed", body=_lq("ternary", "ternary")),
    # mixed w/a recipes (beyond the paper's matched pairs): weights in the
    # cheap packed format, activations int8 — the regime the mixed-precision
    # accelerator line targets (Bruschi'20, Zhao'19). Per-row requant
    # composes the two scales; the first/last layers stay full int8.
    "wt-a8": PrecisionPolicy("wt-a8", body=_lq("ternary", "int8")),
    "w4a8": PrecisionPolicy("w4a8", body=_lq("int4", "int8")),
    # heterogeneous per-layer-class demo: each layer class picks its own
    # operating point (the serve path resolves them per layer, not from a
    # global flag pair) — ffn_up tolerates s4 weights, attn_out keeps trits,
    # qkv stays int8; all activations int8 so the residual stream requants
    # uniformly.
    "het": PrecisionPolicy("het", body=_lq("ternary", "int8"), per_class={
        "ffn_up": _lq("int4", "int8"),
        "ffn_down": _lq("ternary", "int8"),
        "attn_qkv": _lq("int8", "int8"),
        "attn_out": _lq("ternary", "int8"),
        "moe_expert": _lq("int4", "int8"),
    }),
    # weight-only variants (useful for LLMs: activations stay bf16)
    "w-binary": PrecisionPolicy("w-binary", body=_lq("binary", "none"),
                                first_last=_lq("int8", "none")),
    "w-ternary": PrecisionPolicy("w-ternary", body=_lq("ternary", "none"),
                                 first_last=_lq("int8", "none")),
    "w-int4": PrecisionPolicy("w-int4", body=_lq("int4", "none"),
                              first_last=_lq("int8", "none")),
    "w-int8": PrecisionPolicy("w-int8", body=_lq("int8", "none")),
    # no quantization — the fp/bf16 baseline every comparison needs
    "none": PrecisionPolicy("none", body=LayerQuant(), first_last=LayerQuant()),
}


def policy_operating_points() -> set[tuple[str, str]]:
    """Every (wprec, aprec) pair the POLICIES table can assign to some layer
    — the registry-completeness tests regenerate their sweep from this, so
    a new policy entry automatically extends the coverage obligation on the
    dispatch registry."""
    pts = set()
    for pol in POLICIES.values():
        for lc in LAYER_CLASSES:
            for first, last in ((False, False), (True, False), (False, True)):
                lq = pol.lookup(lc, is_first=first, is_last=last)
                pts.add((lq.weights.precision, lq.acts.precision))
    return pts


def get_policy(name: str) -> PrecisionPolicy:
    try:
        return POLICIES[name]
    except KeyError:
        raise KeyError(f"unknown precision policy {name!r}; have {sorted(POLICIES)}") from None
