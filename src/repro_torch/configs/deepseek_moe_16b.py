"""deepseek-moe-16b [moe] — fine-grained: 2 shared + 64 routed experts,
top-6, expert d_ff=1408. [arXiv:2401.06066; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-moe-16b", family="moe",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab=102_400,
    n_experts=64, n_shared_experts=2, top_k=6, capacity_factor=1.25,
    act_fn="silu", gated_ffn=True,
    policy="w-ternary", microbatches=8, param_dtype="bfloat16",
)
