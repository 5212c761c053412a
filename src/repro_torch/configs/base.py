"""ArchConfig — the selectable architecture/config system (`--arch <id>`).

A pure-Python copy of the JAX package's `repro.configs.base` (the port
imports nothing of the JAX package). Every assigned architecture is one
`ArchConfig` in its own module under `repro_torch.configs`;
`repro_torch.configs.get_config(name)` resolves it, and
`.reduced()` produces the small same-family variant used by the CPU smoke
tests. Input shapes (train_4k / prefill_32k / decode_32k / long_500k) are
defined here once and attached per-arch via `supported_shapes`.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

BlockKind = Literal["attn", "local", "slstm", "mlstm", "rglru"]


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: Literal["dense", "moe", "ssm", "hybrid", "vlm", "audio"]
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                 # 0 => d_model // n_heads

    # block structure: repeating pattern of mixer kinds; () => all "attn"
    block_pattern: tuple[BlockKind, ...] = ()
    window: int = 0                   # sliding-window size for "local" mixers
    d_rnn: int = 0                    # RG-LRU width (0 => d_model)

    # transformer details
    qkv_bias: bool = False
    act_fn: str = "silu"              # silu | gelu | squared_relu
    gated_ffn: bool = True
    norm: str = "rmsnorm"             # rmsnorm | layernorm
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.0

    # modality frontend (stub per assignment: input_specs provides embeddings)
    frontend: Literal["none", "audio", "vision"] = "none"
    encoder_layers: int = 0           # >0 => encoder-decoder (whisper)
    frontend_len: int = 0             # frames/patches provided by the stub

    # quantization (the paper's technique; policy name from core.precision)
    policy: str = "w-ternary"
    kernel_backend: str = "jnp"       # "pallas" on real TPU

    # distribution / memory knobs
    seq_prefill: bool = False         # force sequential recurrent prefill
                                      # (the pre-optimization §Perf baseline)
    mlstm_impl: str = "scan"          # "scan" | "chunkwise" (§Perf B/xlstm)
    kv_cache_dtype: str = "bfloat16"  # "int8" = requantized cache (§Perf C)
    fsdp_wire: str = "dense"          # "packed" = bit-plane FSDP gathers (§Perf B)
    param_dtype: str = "float32"      # master/param dtype for training
    remat: bool = True
    scan_layers: bool = True
    microbatches: int = 1             # gradient-accumulation chunks per step
    opt_state_int8: bool = False      # int8-quantized Adam moments

    # which input shapes this arch supports (skips recorded in DESIGN.md)
    supported_shapes: tuple[str, ...] = ("train_4k", "prefill_32k", "decode_32k")

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // max(self.n_heads, 1))
        if self.d_rnn == 0:
            object.__setattr__(self, "d_rnn", self.d_model)
        if not self.block_pattern:
            object.__setattr__(self, "block_pattern", ("attn",))

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    def pattern_at(self, layer_idx: int) -> BlockKind:
        return self.block_pattern[layer_idx % len(self.block_pattern)]

    def n_params(self) -> int:
        """Analytic parameter count (embeddings + blocks + head), for 6·N·D."""
        d, f, v = self.d_model, self.d_ff, self.vocab
        dh, h, hk = self.head_dim, self.n_heads, self.n_kv_heads
        attn = d * (h + 2 * hk) * dh + h * dh * d
        ffn_mult = 3 if self.gated_ffn else 2
        dense_ffn = ffn_mult * d * f
        total = 0
        for i in range(self.n_layers):
            kind = self.pattern_at(i)
            if kind in ("attn", "local"):
                total += attn
            elif kind == "rglru":
                total += 2 * d * self.d_rnn + self.d_rnn * d + 4 * self.d_rnn + 2 * self.d_rnn
            elif kind == "mlstm":
                total += d * (h + 2 * hk) * dh + h * dh * d + 2 * h * dh * 2  # qkv+o+gates
            elif kind == "slstm":
                total += 4 * d * d + d * d  # 4 gates + out
            if self.n_experts and kind in ("attn", "local"):
                total += self.n_experts * ffn_mult * d * f + d * self.n_experts
                if self.n_shared_experts:
                    total += ffn_mult * d * (f * self.n_shared_experts)
            elif f > 0 and kind in ("attn", "local", "rglru"):
                total += dense_ffn
        total += v * d * (1 if self.tie_embeddings else 2)
        if self.is_encdec:
            total += self.encoder_layers * (attn + dense_ffn)
            total += self.n_layers * attn  # cross-attention
        return total

    def n_active_params(self) -> int:
        """Active params per token (MoE: only top_k + shared experts count)."""
        if not self.n_experts:
            return self.n_params()
        d, f = self.d_model, self.d_ff
        ffn_mult = 3 if self.gated_ffn else 2
        inactive = (self.n_experts - self.top_k) * ffn_mult * d * f * self.n_layers
        return self.n_params() - inactive

    def reduced(self) -> "ArchConfig":
        """Small same-family variant for CPU smoke tests (one fwd/train step)."""
        return dataclasses.replace(
            self,
            n_layers=max(2 * len(self.block_pattern), 2),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4,
            head_dim=32,
            d_ff=256 if self.d_ff else 0,
            vocab=512,
            d_rnn=128,
            window=min(self.window, 64) if self.window else 0,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            n_shared_experts=min(self.n_shared_experts, 1),
            top_k=min(self.top_k, 2) if self.top_k else 0,
            capacity_factor=8.0 if self.n_experts else 1.0,  # no drops in smoke
            encoder_layers=2 if self.encoder_layers else 0,
            frontend_len=16 if self.frontend != "none" else 0,
            microbatches=1,
            param_dtype="float32",
        )
