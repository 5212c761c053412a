"""xlstm-125m [ssm] — alternating sLSTM + mLSTM blocks, d_ff=0 (the mLSTM
up-projection plays the FFN role). [arXiv:2405.04517; unverified]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-125m", family="ssm",
    n_layers=12, d_model=768, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab=50_304,
    block_pattern=("slstm", "mlstm"),
    policy="w-ternary",
    mlstm_impl="chunkwise",   # §Perf D: validated == sequential oracle; 93x
                              # lower memory term on train_4k (scan baseline
                              # via --set mlstm_impl=scan)
    supported_shapes=("train_4k", "prefill_32k", "decode_32k", "long_500k"),
)
