"""whisper-tiny [audio] — encoder-decoder; conv frontend is a STUB
(input_specs provides precomputed 1500-frame embeddings). [arXiv:2212.04356]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-tiny", family="audio",
    n_layers=4, d_model=384, n_heads=6, n_kv_heads=6,
    d_ff=1536, vocab=51_865,
    act_fn="gelu", gated_ffn=False, norm="layernorm",
    frontend="audio", encoder_layers=4, frontend_len=1500,
    policy="w-ternary",
)
