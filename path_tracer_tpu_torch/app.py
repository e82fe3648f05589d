"""Interactive application session: the reference's editor loop as a library.

Port of path_tracer_tpu/app.py (the reference's Update(),
application.cpp:86-124): apply camera fly-controls, incrementally
recompile the scene, restart accumulation when anything changed, then
advance the path tracer by one or two rounds and resolve for display.

`Session` exposes that loop to scripts and a viewer front end: mutate
the scene (or move the camera), call frame(), get a resolved image;
accumulation restarts on changes and refines progressively otherwise.
Everything runs on `device` (the card unless the caller asks for the
CPU).
"""

from __future__ import annotations

import numpy as np
import torch

from .core.constants import TONE_MAPPING_MODE_CLAMP
from .integrator.resolve import resolve
from .integrator.wavefront import RenderConfig, render, reset
from .ops.intersect import SceneLayout
from .scene.compile import compile_scene
from .scene.model import (
    ENTITY_TYPE_CAMERA,
    SCENE_DIRTY_CAMERAS,
    make_transform_matrix,
)
from .utils import log
from .viewer import preview as preview_mod


class Session:
    """Progressive interactive render session over an editable scene."""

    def __init__(self, scene, width=960, height=540, camera_index=0,
                 termination_probability=0.05, generic_programs=False,
                 device='cuda'):
        self.scene = scene
        self.width = width
        self.height = height
        self.camera_index = camera_index
        self.termination_probability = termination_probability
        self.device = torch.device(device)
        # The JAX package's editor compiles GENERIC programs (every
        # analytic shape type and material model in from the start,
        # conservative scatter flags) so that no edit changes the
        # program structure and stalls on an XLA recompile. The port has
        # no program to recompile, and there the generic layout only
        # runs every model's branch: a steady frame of the viking hall
        # at 960x540 took 116-157 ms and 8,400-8,500 kernels with it
        # against 16-24 ms and 1,110 kernels without (chip_smoke.py
        # phases `session` and `viewer` time both; NVIDIA H100 80GB
        # HBM3, 700 W). So the port specializes by default.
        # generic_programs=True packs as the JAX editor does. The two
        # layouts give two samples of one estimator, not the same bits:
        # with every model in the type set the OpenPBR walk draws on
        # every lane (tests/test_torch_app.py).
        self.generic_programs = generic_programs
        scene.compile_generic = generic_programs
        self.packed = None
        self.layout = None
        self.state = None
        self.frame_index = 0
        self._seed = 0
        self._recompile(full=True)

    # -- scene/camera mutation ------------------------------------------

    def set_scene(self, scene):
        """Replace the scene document (the editor's New/Open): full
        recompile and restart."""
        self.scene = scene
        scene.compile_generic = self.generic_programs
        self.packed = None
        self._recompile(full=True)

    def camera(self):
        cams = [e for e in self.scene.walk_entities()
                if e.type == ENTITY_TYPE_CAMERA]
        return cams[self.camera_index]

    def camera_world(self):
        cam = self.camera()
        return make_transform_matrix(cam.transform.position,
                                     cam.transform.rotation)

    def move_camera(self, delta=(0, 0, 0), rotate=(0, 0, 0)):
        """Fly-control analog (application.cpp:19-69): translate in the
        camera frame, rotate by euler deltas; restarts accumulation."""
        cam = self.camera()
        world = make_transform_matrix(cam.transform.position,
                                      cam.transform.rotation)
        local = np.asarray(delta, np.float32)
        cam.transform.position = (cam.transform.position
                                  + world[:3, :3] @ local)
        cam.transform.rotation = cam.transform.rotation + np.asarray(
            rotate, np.float32)
        self.scene.mark_dirty(SCENE_DIRTY_CAMERAS)

    # -- the frame loop --------------------------------------------------

    def _recompile(self, full=False):
        if full:
            self.scene.dirty_flags = 0xFFFFFFFF
        self.packed = compile_scene(self.scene, prev=self.packed,
                                    aspect_ratio=self.width / self.height,
                                    device=self.device)
        self.layout = SceneLayout.from_packed(self.packed)
        self.config = RenderConfig(
            width=self.width, height=self.height,
            camera_index=self.camera_index,
            camera_model=self.packed.host_camera_models[self.camera_index])
        self._restart()

    def _restart(self):
        self._seed += 1
        log.event('session.restart', seed=self._seed,
                  frame=self.frame_index)
        self.state = reset(self.packed, self.config, self._seed)

    def frame(self, rounds=None, tonemap_mode=TONE_MAPPING_MODE_CLAMP,
              brightness=1.0):
        """One Update(): recompile if dirty (restarting accumulation),
        advance the renderer, return the resolved (H, W, 3) image.

        Like the reference, a restart frame runs 2 rounds and a steady
        frame 1 round (application.cpp:110-114), unless `rounds`
        overrides.
        """
        restarted = False
        if self.scene.dirty_flags:
            self._recompile()
            restarted = True
        n_rounds = rounds if rounds is not None else (2 if restarted else 1)
        self.state = render(
            self.packed, self.config, n_rounds, layout=self.layout,
            state=self.state,
            termination_probability=self.termination_probability)
        self.frame_index += 1
        return resolve(self.state['accum'], self.width, self.height,
                       brightness=brightness, mode=tonemap_mode,
                       lane=self.state['lane'])

    # -- editor services --------------------------------------------------

    def preview(self, mode=preview_mod.PREVIEW_RENDER_MODE_BASE_COLOR_SHADED,
                selected_shape=-1, brightness=1.0):
        """Real-time false-color preview through the session camera."""
        if self.scene.dirty_flags:
            self._recompile()
        return preview_mod.render_preview(
            self.packed, self.layout, self.width, self.height,
            self.camera_world(), mode=mode, selected_shape=selected_shape,
            brightness=brightness, device=self.device)

    def pick(self, x, y):
        """Shape index under pixel (x, y), or -1 (mouse picking)."""
        if self.scene.dirty_flags:
            self._recompile()
        return preview_mod.pick(self.packed, self.layout, self.width,
                                self.height, self.camera_world(), x, y,
                                device=self.device)

    def samples_per_pixel(self):
        """Mean accumulated samples per slot (reads back; call sparingly)."""
        return float(self.state['accum']['count'].mean())
