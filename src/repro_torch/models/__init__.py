"""Model components of the dense decoder's serve path — counterpart of
`repro.models` (attention, ffn, common, transformer)."""
from . import attention, common, ffn, transformer  # noqa: F401
