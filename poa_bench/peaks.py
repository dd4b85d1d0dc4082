"""The card's peaks, read in the run.

Bytes: 3.35 TB/s, NVIDIA's published HBM3 rate of the H100 SXM. Integer
operations: the SM count (from the device) x 64 INT32 lanes a clock x
the card's maximum SM clock (from nvidia-smi). A 32 x 32 -> 64-bit
multiply is two int32 operations, so a Montgomery product of 8 x 32-bit
limbs, 64 limb products for the product and 64 for the reduction, is
MONT_OPS = 256; additions are not counted, so a bound from these counts
is a lower bound of the time. The power limit is read beside them: a card
set below 700 W runs slower than these peaks assume.
"""

from __future__ import annotations

import subprocess

HBM_BYTES_S = 3.35e12
INT32_LANES_PER_SM = 64
MONT_OPS = 256


def read(device_index: int = 0) -> dict:
    import torch

    props = torch.cuda.get_device_properties(device_index)
    out = subprocess.run(
        ["nvidia-smi", "-i", str(device_index), "--query-gpu=clocks.max.sm,power.limit",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=30, check=True).stdout
    clock_mhz, power_w = (float(v) for v in out.strip().split(","))
    return {"name": props.name, "sm_count": props.multi_processor_count,
            "max_sm_clock_mhz": clock_mhz, "power_limit_w": power_w,
            "bytes_s": HBM_BYTES_S,
            "int32_ops_s": props.multi_processor_count * INT32_LANES_PER_SM * clock_mhz * 1e6}


def bound_s(ops: float, n_bytes: float, peaks: dict) -> float:
    """The least time the card could take for `ops` int32 operations and
    `n_bytes` moved: the larger of the two."""
    return max(ops / peaks["int32_ops_s"], n_bytes / peaks["bytes_s"])
