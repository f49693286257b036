"""ks_mac_roofline.<cell kind>: limb_cuda.ks_mac's share of its roofline
in the profiled passes (``trace.kernel_roofline``), in %."""

from fhe_bench.trace import kernel_roofline


def read(rec: dict) -> float | None:
    return kernel_roofline(rec, "ks_mac")
