"""base_conv_roofline.<cell kind>: limb_cuda.base_conv's share of its
roofline in the profiled passes (``trace.kernel_roofline``), in %."""

from fhe_bench.trace import kernel_roofline


def read(rec: dict) -> float | None:
    return kernel_roofline(rec, "base_conv")
