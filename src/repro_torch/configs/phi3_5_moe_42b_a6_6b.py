"""phi3.5-moe-42b-a6.6b [moe] — 16 experts, top-2, GQA kv=8.
[hf:microsoft/Phi-3.5-MoE-instruct; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="phi3.5-moe-42b-a6.6b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=6400, vocab=32_064,
    n_experts=16, top_k=2, capacity_factor=1.25,
    act_fn="silu", gated_ffn=True,
    policy="w-ternary", param_dtype="bfloat16", microbatches=8,
)
