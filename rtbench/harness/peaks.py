"""Peaks of the cards the benchmark knows, from their makers' data sheets.

NVIDIA H100 SXM5 80GB (data sheet, dense, at the 700 W limit): 67 TFLOP/s
fp32 outside the tensor cores (an FMA counted as two operations) and
3.35 TB/s of HBM3. A card that matches no entry gets no roofline or mfu:
their readers return nothing.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Peak:
    fp32_flops: float
    hbm_bytes_s: float

    def bound_s(self, ops: float, nbytes: float) -> tuple[float, str]:
        """The least time for `ops` fp32 operations and `nbytes` bytes,
        and which of the two sets it."""
        t_ops, t_bytes = ops / self.fp32_flops, nbytes / self.hbm_bytes_s
        return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


TABLE = {"H100 80GB HBM3": Peak(67e12, 3.35e12)}


def for_device(name: str) -> Peak | None:
    for key, peak in TABLE.items():
        if key in name:
            return peak
    return None
