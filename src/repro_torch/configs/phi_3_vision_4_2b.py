"""phi-3-vision-4.2b [vlm] — phi3-mini backbone + CLIP frontend (stub:
input_specs provides precomputed patch embeddings).
[hf:microsoft/Phi-3-vision-128k-instruct; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="phi-3-vision-4.2b", family="vlm",
    n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab=32_064,
    act_fn="silu", gated_ffn=True,
    frontend="vision", frontend_len=256,
    policy="w-ternary", microbatches=2, param_dtype="bfloat16",
)
