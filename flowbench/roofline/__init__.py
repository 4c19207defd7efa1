"""Operations and bytes of the four operations whose roofline shares the benchmark reports.

Each module's ``work(call)`` takes one recorded call's shapes (and, for
PCG, the iterations these inputs needed) and returns (operations, bytes):
the least work any implementation of the operation does, with each input
byte read once and each output byte written once.  ``least_seconds``
turns them into the least time on a card of the peak table.
"""


def least_seconds(ops: float, nbytes: float, peak: dict) -> float:
    """The larger of the compute bound and the memory bound."""
    return max(ops / peak["fp32_flops"], nbytes / peak["hbm_bytes_per_s"])
