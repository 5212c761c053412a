"""recurrentgemma-9b [hybrid] — RG-LRU + local attention, 2:1 (pattern
rglru,rglru,attn), GQA kv=1, window 2048. [arXiv:2402.19427; unverified]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b", family="hybrid",
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1,
    d_ff=12288, vocab=256_000,
    block_pattern=("rglru", "rglru", "local"),
    window=2048, d_rnn=4096,
    act_fn="gelu", gated_ffn=True,
    policy="w-ternary", param_dtype="bfloat16", microbatches=4,
    supported_shapes=("train_4k", "prefill_32k", "decode_32k", "long_500k"),
)
