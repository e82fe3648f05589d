"""The scatter-tail kernel's share of its roofline, in %: the least time
to move the layer's compulsory bytes for the cell's lanes once (its bytes
over the card's memory rate) over the kernel's device time a round.

The bytes are counted from the cell's lanes, not from the program, so
that the least time stays the same whatever implements the layer: per
lane the 23 words every lane moves whatever its branch. It reads 18: the
primary wavelength, throughput (4), probability (4), the sample (3), the
hit's time, the ray's direction (3) and the 64-bit random state (2). It
writes 5: the sample (3) and the stepped random state (2). The new
throughput, probability, origin, direction and alive mask, the hit frame
and integrand a surface lane reads, the volumetric branch and the sky's
texels are left out, so the count is a lower bound in every layout and
the share cannot pass 100%.
"""

from benchmark.harness import roofline

KERNEL = 'scatter_tail_kernel'
LANE_BYTES = 23 * 4


def read(data):
    ms = data.kernel_ms(KERNEL)
    if data.generator != 'offline' or not ms or not data.rounds:
        return None
    peak = roofline.PEAKS.get(data.device_kind)
    if peak is None or not data.lanes:
        return None
    least = data.lanes * LANE_BYTES / peak['hbm_bytes_per_s']
    return 100.0 * least / (ms / data.rounds / 1e3)
