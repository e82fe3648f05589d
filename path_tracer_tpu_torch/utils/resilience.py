"""Failure detection and recovery for long renders.

Port of path_tracer_tpu/utils/resilience.py. The host scene document
plus a periodic render-state checkpoint (integrator/checkpoint.py, one
npz) are the durable truth; everything on the device (the PackedScene,
the render state) is rebuilt from them after a failure, on the device
the render was given (never on another). Progress advances in
checkpoint units, so a failure costs at most `checkpoint_every` rounds.

`render_resilient` drives chunked rendering with retry-and-resume. A
retry happens in the same process first. A CUDA error, though, can
leave the process's CUDA context unusable (errors such as an illegal
address are sticky: every later call fails), and then every retry fails
too; the checkpoint file is the way out, because a NEW process resumes
from it (`resume=True`, the CLI's `--resume`).

`wavefront.render` updates the state dict it is given in place, unlike
the JAX package's pure `render`: a chunk that fails part way may leave
half-updated tensors behind. Such a state is never rendered on: after a
failure the state is always reloaded from the checkpoint file, or reset
when there is none.
"""

from __future__ import annotations

import os
import time

from . import log


class RenderFailure(RuntimeError):
    """Raised when a render chunk keeps failing after recovery retries."""


def _atomic_save(path, state):
    from ..integrator.checkpoint import save_render_state

    # np.savez appends '.npz' unless the name already ends with it.
    tmp = f'{path}.tmp.npz'
    save_render_state(tmp, state)
    os.replace(tmp, path)


def render_resilient(scene, width, height, total_rounds, *, seed=0,
                     camera_index=0, termination_probability=0.05,
                     checkpoint_path=None, checkpoint_every=64,
                     resume=False, max_retries=2, device='cuda',
                     _inject_failure=None):
    """Render `total_rounds` wavefront rounds with checkpoint/recovery on
    `device`.

    Returns the final render state. `checkpoint_path` enables
    durability: progress is saved every `checkpoint_every` rounds and on
    completion, and the rounds it holds go to `<path>.rounds`;
    `resume=True` restarts from an existing checkpoint.

    `_inject_failure` (tests only): (round_index -> None) callback run
    before each chunk; raising from it exercises the recovery path.
    """
    from ..integrator.checkpoint import load_render_state
    from ..integrator.wavefront import RenderConfig, render, reset
    from ..ops.intersect import SceneLayout
    from ..scene.compile import compile_scene

    def build():
        packed = compile_scene(scene, aspect_ratio=width / height,
                               device=device)
        layout = SceneLayout.from_packed(packed)
        config = RenderConfig(width=width, height=height,
                              camera_index=camera_index,
                              camera_model=packed.host_camera_models[camera_index])
        return packed, layout, config

    def restore(packed, config):
        """(state, rounds done) from the checkpoint, or a fresh state."""
        if checkpoint_path and os.path.exists(checkpoint_path):
            state = load_render_state(checkpoint_path,
                                      reset(packed, config, seed),
                                      device=device)
            done = 0
            if os.path.exists(rounds_file):
                with open(rounds_file) as f:
                    done = int(f.read().strip() or 0)
            return state, done
        return reset(packed, config, seed), 0

    packed, layout, config = build()
    rounds_file = f'{checkpoint_path}.rounds' if checkpoint_path else None
    if resume and checkpoint_path and os.path.exists(checkpoint_path):
        state, done = restore(packed, config)
        log.event('resilience.resume', path=checkpoint_path, rounds=done)
    else:
        state, done = reset(packed, config, seed), 0

    retries = 0
    while done < total_rounds:
        chunk = min(checkpoint_every, total_rounds - done)
        try:
            if _inject_failure is not None:
                _inject_failure(done)
            state = render(packed, config, chunk, layout=layout,
                           state=state,
                           termination_probability=termination_probability)
            if checkpoint_path:
                _atomic_save(checkpoint_path, state)
                with open(rounds_file, 'w') as f:
                    f.write(str(done + chunk))
        except Exception as e:  # device error, lost worker, injected
            retries += 1
            log.event('resilience.failure', at_round=done, retry=retries,
                      error=f'{type(e).__name__}: {e}')
            if retries > max_retries:
                raise RenderFailure(
                    f'render failed {retries} times at round {done}; '
                    f'last checkpoint: {checkpoint_path or "none"}') from e
            # Rebuild everything on the device from the host truth, and
            # never render on the state the failed chunk may have left
            # half-updated.
            time.sleep(min(2.0 ** retries, 10.0))
            del state
            packed, layout, config = build()
            state, done = restore(packed, config)
            continue
        retries = 0
        done += chunk
        log.event('resilience.progress', rounds=done, total=total_rounds)
    return state
