"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions —
counterpart of `repro.kernels`.

harness    — the output-stationary packed GEMM template (csrc/gemm.cu), its
             fused requant epilogue, and the grouped launch (K11, K10 over
             expert stacks, grouped K3, K4, K7 and K8)
i8gemm     — int8 x int8 body (__dp4a)
bgemm      — binary bodies: XNOR+popcount, and ±1 unpack + int8 dot (mxu)
tgemm      — ternary bodies: gated XNOR, trit unpack + int8 dot (mxu), and
             trit weights x int8 activations
i4gemm     — s4 nibble weights x int8 activations
pgemm      — int4/int8 weights as stacked binary planes x int8 activations
paged_attn — paged flash-decode (csrc/paged_attn.cu)
flash_attn — causal GQA prefill attention (csrc/flash_attn.cu)
dispatch   — OperatingPoint-keyed registry + `qgemm`, the serve entry point
build      — nvcc build at first use, ctypes binding, launch counts

Importing builds nothing: a kernel is compiled at its first launch (or by
`build.build_all()`).
"""
from . import (bgemm, dispatch, flash_attn, harness, i4gemm, i8gemm,  # noqa: F401
               paged_attn, pgemm, tgemm)

#: every GEMM body on the serve path
BODIES = (i8gemm.I8_DOT, bgemm.BINARY_POPCOUNT, tgemm.TERNARY_POPCOUNT,
          bgemm.BINARY_MXU, tgemm.TERNARY_MXU, tgemm.TERNARY_W_I8A,
          i4gemm.INT4_W_I8A, pgemm.PLANES_W4_I8A, pgemm.PLANES_W8_I8A)

#: every kernel launcher on the serve path, by name
KERNELS = {
    **{body.name: body.kernel for body in BODIES},
    "gemm_grouped": harness.GEMM_GROUPED,
    "gemm_grouped_pop": harness.GEMM_GROUPED_POP,
    "gemm_grouped_planes": harness.GEMM_GROUPED_PLANES,
    "gemm_grouped_mxu": harness.GEMM_GROUPED_MXU,
    "gemm_grouped_wt_i8a": harness.GEMM_GROUPED_WT_I8A,
    "paged_flash_decode": paged_attn.PAGED_DECODE,
    "flash_attention": flash_attn.FLASH_ATTN,
}


def launch_counts() -> dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}


def reset_launches() -> None:
    for k in KERNELS.values():
        k.launches = 0
