"""The medium-event kernel's share of its roofline, in %: the least time
to move the layer's compulsory bytes for the cell's lanes once (its bytes
over the card's memory rate) over the kernel's device time a round.

The bytes are counted from the cell's lanes, not from the program, so
that the least time stays the same whatever implements the layer: per
lane 36 words. It reads 26: the four active-shape slots, the primary
wavelength, throughput (4), probability (4), the hit's time, shape and
normal (3), the ray's origin (3) and direction (3), and the 64-bit random
state (2). It writes 10 that no implementation can avoid: the absorbed
throughput (4), the exterior IOR (4) and the stepped random state (2).
The event masks, the priority and the volumetric branch's origin,
direction, throughput and probability, which the layer writes too, are
left out, as are the material tables it gathers from, so the count is a
lower bound and the share cannot pass 100%.
"""

from benchmark.harness import roofline

KERNEL = 'medium_event_kernel'
LANE_BYTES = 36 * 4


def read(data):
    ms = data.kernel_ms(KERNEL)
    if data.generator != 'offline' or not ms or not data.rounds:
        return None
    peak = roofline.PEAKS.get(data.device_kind)
    if peak is None or not data.lanes:
        return None
    least = data.lanes * LANE_BYTES / peak['hbm_bytes_per_s']
    return 100.0 * least / (ms / data.rounds / 1e3)
