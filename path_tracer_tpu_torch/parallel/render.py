"""Multi-device progressive rendering over torch.distributed.

Port of path_tracer_tpu/parallel/render.py, one process (rank) per
device. The JAX package's ('batch', 'pixels') device mesh becomes a grid
of ranks, rank = b * pixels + p:

  * `pixels`: the slot space of the frame (config.waves * W * H slots)
    is split into `pixels` contiguous slices, one a rank -- the analogue
    of tiling the wavefront buffers. No collective runs in the round
    loop; the accumulator is assembled from the slices at merge.
  * `batch`: every batch row renders the whole slot space with its own
    sample stream (seed + b, in uint32 arithmetic); the rows'
    accumulators are added by an all-reduce over the batch group (the
    ranks that share p).

A rank's render state is the ordinary state of `wavefront.reset` for its
slice, so a sharded render is progressive and resumable as the
single-device one is: pass the returned state back via `state=`, or save
and load it with integrator/checkpoint.py, one file per rank.

The backend is NCCL on the card and gloo on the CPU. `make_mesh` sets up
a world of one process when no process group exists; a multi-process
world is the caller's (torch.distributed.init_process_group with a
tcp://127.0.0.1:<port> address, its world size and each rank), as in
`dryrun_multichip`. Nothing here falls back from the card to the CPU.
"""

from __future__ import annotations

import socket
import time
from dataclasses import dataclass
from typing import Any

import torch
import torch.distributed as dist

from ..integrator.wavefront import RenderConfig, render_rounds, reset
from ..ops.intersect import SceneLayout

BACKENDS = {'cuda': 'nccl', 'cpu': 'gloo'}


@dataclass(frozen=True)
class Mesh:
    """This rank's place in the ('batch', 'pixels') grid of ranks.

    `shape` reads as the JAX Mesh's (`mesh.shape['batch']`,
    `mesh.shape['pixels']`); `coords` is this rank's (b, p); the batch
    group holds the ranks that share p, the pixel group those that share
    b (each ordered by the other coordinate)."""

    shape: dict
    coords: tuple
    device: torch.device
    batch_group: Any = None
    pixel_group: Any = None


def free_port():
    """A TCP port on 127.0.0.1 that nothing listens on now."""
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def make_mesh(batch=1, pixels=None, device='cuda'):
    """Build the ('batch', 'pixels') mesh over the ranks of the process
    group, one rank per device: NCCL and the rank's card for
    device='cuda', gloo for 'cpu'. Without a process group, a world of
    one is set up here."""
    device = torch.device(device)
    if device.type not in BACKENDS:
        raise ValueError(f'make_mesh: unsupported device {device}')
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('make_mesh: no CUDA device; pass device="cpu" '
                           'to shard over CPU processes with gloo')
    backend = BACKENDS[device.type]
    if not dist.is_initialized():
        dist.init_process_group(
            backend, init_method=f'tcp://127.0.0.1:{free_port()}',
            world_size=1, rank=0)
    if dist.get_backend() != backend:
        raise ValueError(f'make_mesh: the process group runs '
                         f'{dist.get_backend()}, device {device.type} '
                         f'needs {backend}')
    n, rank = dist.get_world_size(), dist.get_rank()
    if pixels is None:
        pixels = n // batch
    if batch * pixels != n or pixels < 1:
        raise ValueError(
            f'mesh wants batch*pixels = {batch}*{pixels} devices but the '
            f'process group has {n} ranks; start batch*pixels processes, '
            f'one a device, each calling torch.distributed.'
            f'init_process_group with world_size={batch * pixels}')
    if device.type == 'cuda':
        device = torch.device('cuda', rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    # Every rank creates every group, in the same order.
    batch_groups = [dist.new_group([b * pixels + p for b in range(batch)])
                    for p in range(pixels)]
    pixel_groups = [dist.new_group([b * pixels + p for p in range(pixels)])
                    for b in range(batch)]
    b, p = divmod(rank, pixels)
    return Mesh(shape={'batch': batch, 'pixels': pixels}, coords=(b, p),
                device=device, batch_group=batch_groups[p],
                pixel_group=pixel_groups[b])


def _check_device(packed, mesh):
    if packed.camera_model.device.type != mesh.device.type:
        raise ValueError(f'the scene lives on {packed.camera_model.device}, '
                         f'the mesh on {mesh.device}')


def reset_sharded(packed, config: RenderConfig, mesh: Mesh, seed=0):
    """This rank's fresh render state: slice p of the config.waves * W * H
    slot space, in batch row b's sample stream (seed + b)."""
    _check_device(packed, mesh)
    n = config.waves * config.width * config.height
    n_pixels = mesh.shape['pixels']
    if n % n_pixels:
        raise ValueError(f'{n} slots do not split into {n_pixels} '
                         'equal slices')
    b, p = mesh.coords
    per = n // n_pixels
    slot = torch.arange(p * per, (p + 1) * per, dtype=torch.int32,
                        device=packed.camera_model.device)
    return reset(packed, config, (int(seed) + b) & 0xFFFFFFFF, slot)


def render_sharded_state(packed, config: RenderConfig, rounds, mesh: Mesh,
                         state, termination_probability=0.05, layout=None):
    """Advance this rank's state by `rounds` wavefront rounds, in place;
    no collective."""
    _check_device(packed, mesh)
    layout = layout or SceneLayout.from_packed(packed)
    return render_rounds(packed, layout, config, state,
                         termination_probability, rounds)


def merge_accumulator(mesh: Mesh, state):
    """The global accumulator on every rank: this rank's slots in lane
    order (stable; the render loop never permutes the state, so this is
    a safety net), summed over the batch group and gathered over the
    pixel group in p order. Returns dict(xyz (3, N), count (N,),
    lane (N,)), resolvable by integrator.resolve."""
    order = torch.argsort(state['lane'], stable=True)
    xyz = state['accum']['xyz'][:, order].contiguous()
    count = state['accum']['count'][order].contiguous()
    lane = state['lane'][order].contiguous()
    dist.all_reduce(xyz, dist.ReduceOp.SUM, group=mesh.batch_group)
    dist.all_reduce(count, dist.ReduceOp.SUM, group=mesh.batch_group)
    out = {}
    for key, value in (('xyz', xyz), ('count', count), ('lane', lane)):
        parts = [torch.empty_like(value) for _ in range(mesh.shape['pixels'])]
        dist.all_gather(parts, value, group=mesh.pixel_group)
        out[key] = torch.cat(parts, dim=-1)
    return out


def render_sharded(packed, config: RenderConfig, rounds, mesh: Mesh,
                   seed=0, termination_probability=0.05, layout=None,
                   state=None, return_state=False):
    """Render `rounds` wavefront rounds sharded over `mesh`.

    Returns the merged global accumulator dict (xyz (3, N), count (N,),
    lane (N,)), summed over the batch rows and resolvable by
    integrator.resolve. With return_state=True, returns (accumulator,
    state): this rank's state, to pass back via `state=` and continue,
    or to checkpoint with integrator.checkpoint (one file per rank)."""
    layout = layout or SceneLayout.from_packed(packed)
    if state is None:
        state = reset_sharded(packed, config, mesh, seed)
    state = render_sharded_state(packed, config, rounds, mesh, state,
                                 termination_probability, layout)
    accum = merge_accumulator(mesh, state)
    if return_state:
        return accum, state
    return accum


DRYRUN_WIDTH, DRYRUN_HEIGHT = 32, 16     # __graft_entry__'s dry-run size
DRYRUN_TIMEOUT = 600                     # seconds for all ranks to finish


def _dryrun_rank(rank, n_devices, port, device, results):
    """One rank of `dryrun_multichip`: the flagship mesh scene through a
    sharded render, resumed once from its state; rank 0 reports."""
    from .. import resolve
    from ..scene.compile import compile_scene
    from ..scene.procedural import make_viking_hall_scene

    dist.init_process_group(BACKENDS[device], rank=rank,
                            world_size=n_devices,
                            init_method=f'tcp://127.0.0.1:{port}')
    width, height = DRYRUN_WIDTH, DRYRUN_HEIGHT
    try:
        batch = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
        mesh = make_mesh(batch=batch, pixels=n_devices // batch,
                         device=device)
        packed = compile_scene(make_viking_hall_scene(detail=1),
                               aspect_ratio=width / height,
                               device=mesh.device)
        layout = SceneLayout.from_packed(packed)
        config = RenderConfig(width=width, height=height)
        t0 = time.perf_counter()
        accum, state = render_sharded(packed, config, 2, mesh, seed=0,
                                      layout=layout, return_state=True)
        img = resolve(accum, width, height, lane=accum['lane'])
        if device == 'cuda':
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        resumed = render_sharded(packed, config, 1, mesh, layout=layout,
                                 state=state)
        ok = (tuple(img.shape) == (height, width, 3)
              and bool(torch.isfinite(img).all())
              and float(resumed['count'].sum()) > float(accum['count'].sum()))
        merge_bytes = sum(v.numel() * v.element_size()
                          for v in accum.values())
        if rank == 0:
            results.put(dict(
                n_devices=n_devices, device=str(mesh.device),
                backend=dist.get_backend(), mesh=dict(mesh.shape),
                lanes_per_rank=int(state['lane'].numel()),
                image_mean=float(img.mean()), seconds_2_rounds=seconds,
                samples=float(resumed['count'].sum()),
                merged_accumulator_bytes=merge_bytes, ok=ok))
        if not ok:
            raise RuntimeError(f'dryrun_multichip rank {rank}: bad image or '
                               'the resumed render added no sample')
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices, device='cuda'):
    """Spawn `n_devices` ranks, one a device, each running one sharded
    render step (2 rounds, then 1 more resumed from its state) of the
    viking hall over a (batch, pixels) mesh with batch = 2 when
    n_devices is even: the port's counterpart of __graft_entry__'s
    dryrun_multichip. device='cuda' needs n_devices cards and NCCL and
    raises when there are fewer; 'cpu' runs the ranks on gloo. Returns
    rank 0's report."""
    if device not in BACKENDS:
        raise ValueError(f'dryrun_multichip: unsupported device {device!r}')
    if device == 'cuda' and torch.cuda.device_count() < n_devices:
        raise RuntimeError(f'dryrun_multichip needs {n_devices} CUDA '
                           f'devices, found {torch.cuda.device_count()}')
    ctx = torch.multiprocessing.get_context('spawn')
    results = ctx.SimpleQueue()
    port = free_port()
    procs = [ctx.Process(target=_dryrun_rank, args=(
        rank, n_devices, port, device, results))
        for rank in range(n_devices)]
    for proc in procs:
        proc.start()
    deadline = time.monotonic() + DRYRUN_TIMEOUT
    try:
        for proc in procs:
            proc.join(max(deadline - time.monotonic(), 0.0))
    finally:
        for proc in procs:
            if proc.is_alive():
                proc.kill()
                proc.join()
    codes = [proc.exitcode for proc in procs]
    if any(code != 0 for code in codes) or results.empty():
        raise RuntimeError(f'dryrun_multichip({n_devices}, {device!r}): '
                           f'rank exit codes {codes}')
    report = results.get()
    print(f'dryrun_multichip({n_devices}): {report}', flush=True)
    return report
