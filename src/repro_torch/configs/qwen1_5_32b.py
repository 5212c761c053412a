"""qwen1.5-32b [dense] — MHA (kv=40) with QKV bias. [hf:Qwen/Qwen1.5-0.5B; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=40, n_kv_heads=40,
    d_ff=27392, vocab=152_064,
    qkv_bias=True, act_fn="silu", gated_ffn=True,
    policy="w-ternary",
    param_dtype="bfloat16", microbatches=4,
)
