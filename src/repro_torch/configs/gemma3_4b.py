"""gemma3-4b [dense] — 5:1 local:global sliding-window attention, 128k ctx.
[hf:google/gemma-3-1b-pt; unverified]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-4b", family="dense",
    n_layers=34, d_model=2560, n_heads=8, n_kv_heads=4,
    d_ff=10240, vocab=262_144,
    block_pattern=("local", "local", "local", "local", "local", "attn"),
    window=1024,
    act_fn="gelu", gated_ffn=True, rope_theta=1_000_000.0,
    policy="w-ternary", microbatches=2, param_dtype="bfloat16",
)
