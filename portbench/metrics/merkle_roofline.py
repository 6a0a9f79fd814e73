"""K2's share of its roofline: the least time of hashing the request's four
trees and its FRI layers' trees (work.merkle, from the statement) over
the device time of the kernels named below, in the profiled window."""

LAYER = "hand kernels"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "proved_cells_per_s"
KERNELS = ("merkle_pass_kernel",)


def read(r):
    t = r.profile.kernel_s(KERNELS) if r.profile else 0.0
    return 100.0 * r.work["merkle"].seconds / t if t > 0 else None
