"""nemotron-4-340b [dense] — GQA kv=8, squared-ReLU (non-gated) FFN.
[arXiv:2402.16819; unverified]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="nemotron-4-340b", family="dense",
    n_layers=96, d_model=18432, n_heads=96, n_kv_heads=8,
    d_ff=73728, vocab=256_000,
    act_fn="squared_relu", gated_ffn=False,
    policy="w-ternary",
    param_dtype="bfloat16", microbatches=16, opt_state_int8=True,
)
