"""repro_torch.core — quantizers, bit-plane packing, the precision policy and
the serve half of QuantizedLinear (counterpart of `repro.core`)."""
from . import pack, precision, qlinear, quantize  # noqa: F401
from .precision import LayerQuant, POLICIES, PrecisionPolicy, get_policy  # noqa: F401
from .quantize import BITS, PACK_FACTOR, QuantSpec  # noqa: F401
