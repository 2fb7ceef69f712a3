"""The work of the port's kernels, counted from their shapes, and the card's
peak rates: what chip_smoke.py's bounds and tools/get_params.py read.

An MSDA sample reads 4 bilinear corners of D channels and adds each,
weighted, into the output: 4 x D multiply-adds, 8·D operations. A DCN
output pixel contracts 9 taps of C channels with O filters: 2·9·C·O
operations. Both count the operations the kernel must do for the queries
or pixels it computes; where a tile mask skips queries, the caller counts
the active ones.

On ``meta`` tensors the front ends (``ops.msda``, ``ops.dcn``) return an
empty output of the right shape and add their kernel's operations to the
tally opened by ``tally_kernel_operations``, so that a forward on the meta
device counts the work that a FLOP counter cannot see in a ctypes call.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional, Tuple

# H100 SXM published peaks (NVIDIA data sheet): HBM bandwidth, f32 rate
# outside the tensor cores, dense bf16 tensor-core rate. MSDA's arithmetic
# is f32 FMAs on CUDA cores; the DCN product runs on CUDA cores in f32 and
# on the tensor cores in bf16.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
BF16_TENSOR_FLOP_PER_S = 989e12

_tally: Optional[Dict[str, int]] = None


def msda_operations(queries: int, heads: int, levels: int, points: int,
                    dims: int) -> int:
    """Operations of an MSDA call over ``queries`` (batch x queries that
    the kernel computes): 4 corners x D multiply-adds a sample."""
    return queries * heads * levels * points * 4 * 2 * dims


def dcn_operations(batch: int, h_out: int, w_out: int, channels: int,
                   filters: int) -> int:
    """Operations of a DCN call: 9 taps of C channels into O filters a pixel."""
    return 2 * batch * h_out * w_out * 9 * channels * filters


def bound_ms(nbytes: float, seconds_of_operations: float) -> Tuple[float, str]:
    """(least ms, "bytes" or "operations"): the larger of ``nbytes`` over
    the HBM rate and the operations' time at their rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = seconds_of_operations * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


@contextlib.contextmanager
def tally_kernel_operations():
    """Inside, each front end called on meta tensors adds its kernel's
    operations to the yielded dict, by entry name."""
    global _tally
    prev, _tally = _tally, {}
    try:
        yield _tally
    finally:
        _tally = prev


def record(entry: str, operations: int) -> None:
    if _tally is not None:
        _tally[entry] = _tally.get(entry, 0) + operations
