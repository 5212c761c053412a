"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions —
counterpart of `repro.kernels`.

harness    — the output-stationary packed GEMM template (csrc/gemm.cu) and
             its fused requant epilogue
i8gemm     — int8 x int8 body (__dp4a)
bgemm      — binary XNOR+popcount body
tgemm      — ternary gated-XNOR body
paged_attn — paged flash-decode (csrc/paged_attn.cu)
dispatch   — OperatingPoint-keyed registry + `qgemm`, the serve entry point
build      — nvcc build at first use, ctypes binding, launch counts

Importing builds nothing: a kernel is compiled at its first launch (or by
`build.build_all()`).
"""
from . import bgemm, dispatch, harness, i8gemm, paged_attn, tgemm  # noqa: F401

#: every kernel launcher on the serve path, by name
KERNELS = {
    i8gemm.I8_DOT.name: i8gemm.I8_DOT.kernel,
    bgemm.BINARY_POPCOUNT.name: bgemm.BINARY_POPCOUNT.kernel,
    tgemm.TERNARY_POPCOUNT.name: tgemm.TERNARY_POPCOUNT.kernel,
    "paged_flash_decode": paged_attn.PAGED_DECODE,
}


def launch_counts() -> dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}


def reset_launches() -> None:
    for k in KERNELS.values():
        k.launches = 0
