"""The yardstick of the rooflines: the H100's published peaks and, one
module a kernel, the operations and bytes its algorithm needs for one
launch on a cell's inputs.

A count is made from the algorithm (the mathematics the kernel computes,
as the plain reference states it) and from the cell's own sizes and data,
never from how a kernel is written: a redesigned kernel does the same work
and is held to the same count. Every input byte is counted once and every
output byte once. An operation is one float add, multiply, compare or
select; a transcendental (exp, log, sin, cos, atan2, sqrt) counts as one.
Where the work depends on the data, the count is what these inputs need.
"""

PEAK_FLOPS = 67e12  # float32 outside the tensor cores, H100 SXM (NVIDIA data sheet)
PEAK_BYTES = 3.35e12  # HBM3, H100 SXM


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the operations
    over the float32 peak and the bytes over the memory rate."""
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)
