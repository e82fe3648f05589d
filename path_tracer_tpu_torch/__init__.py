"""path_tracer_tpu_torch: the spectral wavefront path tracer on PyTorch + CUDA.

A port of the JAX package path_tracer_tpu to PyTorch, with the
traversal of the two-level instanced BVH8 as a hand-written CUDA kernel
for Hopper (csrc/trace_inst.cu). The module tree mirrors the JAX
package's (core, scene, ops, models, integrator, utils). Entry points
run on the card (device='cuda') unless the caller asks for the CPU.
"""

from .core import constants
from .integrator.resolve import resolve
from .integrator.wavefront import RenderConfig, render, reset
from .ops.intersect import SceneLayout
from .scene.compile import PackedScene, compile_scene
from .scene.model import Scene, Transform
from .scene.procedural import make_viking_hall_scene

__version__ = '0.1.0'


def render_scene(scene, width=512, height=256, spp_rounds=32, seed=0,
                 tonemap_mode=constants.TONE_MAPPING_MODE_CLAMP,
                 brightness=1.0, camera_index=0,
                 termination_probability=0.05, device='cuda'):
    """One-call scene -> image: compile, render, resolve.

    Returns an (H, W, 3) float32 tone-mapped sRGB image tensor on `device`.
    """
    packed = compile_scene(scene, aspect_ratio=width / height, device=device)
    layout = SceneLayout.from_packed(packed)
    camera_model = packed.host_camera_models[camera_index]
    config = RenderConfig(width=width, height=height,
                          camera_index=camera_index,
                          camera_model=camera_model)
    state = render(packed, config, spp_rounds, seed=seed,
                   termination_probability=termination_probability,
                   layout=layout)
    return resolve(state['accum'], width, height, brightness=brightness,
                   mode=tonemap_mode, lane=state['lane'])
