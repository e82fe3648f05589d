"""The hit-attribute kernel's share of its roofline, in %: the least
time to move the resolved hit record of the cell's lanes once (its bytes
over the card's memory rate) over the kernel's device time a round.

The bytes are counted from the cell's lanes and the record's fields, not
from the program, so that the least time stays the same whatever
implements the layer: per lane the 20 words that scatter reads (time,
shape, shape type, primitive, material, position, normal, tangent,
bitangent, uv, complexity). They are a lower bound on the layer's
compulsory bytes, not what the kernel writes: it passes complexity
through, and time, shape, shape type and primitive too where it merges
no winners. What the layer reads (the rays, the hit record, the mesh
kernel's winners and attribute rows) is left out as well, so the share
cannot pass 100%.
"""

from benchmark.harness import roofline

KERNEL = 'hit_attributes_kernel'
RECORD_BYTES = 20 * 4


def read(data):
    ms = data.kernel_ms(KERNEL)
    if data.generator != 'offline' or not ms or not data.rounds:
        return None
    peak = roofline.PEAKS.get(data.device_kind)
    if peak is None or not data.lanes:
        return None
    least = data.lanes * RECORD_BYTES / peak['hbm_bytes_per_s']
    return 100.0 * least / (ms / data.rounds / 1e3)
