"""Multi-device scaling: shard the sample wavefront over a device mesh.

This is the distributed backend the reference never had (SURVEY par.2.5 P7:
no MPI/NCCL anywhere — single-node nanothread + one CUDA device).  The
design per BASELINE.json's north star:

  * mesh axis "dp": the pixelxspp wavefront is sharded by *sample index* —
    each device renders spp/n_dev samples of every pixel with its own
    counter-based RNG streams (deterministic, device-count-invariant:
    sample i is identical no matter which device draws it),
  * scene/BVH/parameter tensors are replicated (broadcast once),
  * each device splats into a local film accumulator; one psum over "dp"
    merges films (the only collective in the forward pass),
  * under jax.grad, the transpose of that psum delivers the adjoint image to
    every device and parameter gradients are psum-reduced automatically —
    the "psum grads overlapped with the adjoint sweep" of the plan.

Works identically on a virtual CPU mesh (tests) and on GPUs, whose psums
XLA hands to NCCL; multi-host needs only jax.distributed.initialize
upstream.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from .. import film as film_mod
from ..integrators.common import render_pass
from ..scene.ir import Scene
from ..util import apply_params

AXIS = "dp"


def make_mesh(n_devices: int | None = None) -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.asarray(devs[:n]), (AXIS,))


def _local_pass(scene: Scene, seed, spp_local: int, mode: str,
                extra: int = 0):
    """Per-device body: render this device's sample-index slab.  extra=r
    handles spp % n_dev != 0: the first r devices render ONE additional
    sample (global index n_dev*spp_local + dev); the rest compute the
    same masked pass so the SPMD program stays uniform."""
    dev = jax.lax.axis_index(AXIS)
    acc = None
    if spp_local > 0:
        acc = render_pass(scene, seed, spp_local, dev * spp_local, mode)
    if extra > 0:
        n = jax.lax.axis_size(AXIS)
        e = render_pass(scene, seed, 1, n * spp_local + dev, mode)
        e = jnp.where(dev < extra, e, 0.0)
        acc = e if acc is None else acc + e
    return jax.lax.psum(acc, AXIS)


def render_sharded(scene: Scene, mesh: Mesh, spp: int | None = None,
                   seed: int = 0, mode: str = "primal"):
    """Distributed render: image identical (up to summation order) to the
    single-device render with the same total spp.  Any spp — a remainder
    r = spp % n_dev runs as one masked extra sample on the first r
    devices instead of aborting."""
    spp = spp or scene.spp
    n_dev = mesh.devices.size
    spp_local, r = divmod(spp, n_dev)

    fn = jax.shard_map(
        partial(_local_pass, spp_local=spp_local, mode=mode, extra=r),
        mesh=mesh,
        in_specs=(P(), P()),     # scene + seed replicated
        out_specs=P(),           # film fully replicated after psum
        check_vma=False,         # scan carries flip varying-ness mid-loop
    )

    @partial(jax.jit)
    def run(sc, sd):
        return film_mod.develop(fn(sc, sd))

    return run(scene, jnp.asarray(seed, jnp.uint32))


# ---------------------------------------------------------------------------
# sharded FAST paths: the regen wavefront + the PRB replay adjoint
# (round 4 — VERDICT #1: the flagship perf paths under shard_map)
# ---------------------------------------------------------------------------

# jitted shard_map programs memoized across calls: a fresh
# jax.jit(jax.shard_map(...)) object per call would miss jit's cache and
# re-trace + re-lower the whole wavefront graph every render (~1.8 s for
# the bench scene)
_SHARDED_CACHE: dict = {}


def _mesh_key(mesh: Mesh):
    return (tuple(d.id for d in mesh.devices.flat), mesh.axis_names)


def _cached_sharded(key, build):
    fn = _SHARDED_CACHE.get(key)
    if fn is None:
        fn = _SHARDED_CACHE[key] = build()
    return fn

def _sharded_regen_tile(scene: Scene, seed, pix0, samp0_base, n_valid,
                        spp: int, tile_pix: int, spp_local: int):
    """Per-device body: one regen wavefront over this device's sample-index
    chunk of a pixel tile, psum-merged.  Device d renders samples
    [samp0_base + d*spp_local, ... + spp_local) of every tile pixel; the
    counter RNG keys on the GLOBAL (pixel, sample) pair so the psum'd tile
    is bit-identical (up to summation order) to the single-device tile.
    Devices with index >= n_valid render a dummy chunk whose film is
    masked out — the ragged-remainder path for spp % n_dev != 0."""
    from ..integrators.regen import _render_regen_tile
    dev = jax.lax.axis_index(AXIS)
    samp0 = samp0_base + dev.astype(jnp.uint32) * jnp.uint32(spp_local)
    film = _render_regen_tile(scene, seed, spp, pix0, tile_pix,
                              samp0=samp0, spp_chunk=spp_local)
    film = jnp.where(dev < n_valid, film, 0.0)
    return jax.lax.psum(film, AXIS)


def render_regen_sharded(scene: Scene, mesh: Mesh, spp: int | None = None,
                         seed: int = 0):
    """Distributed regen render -> (h, w, 4) accumulator: the fast
    (regenerating-wavefront) primal under shard_map, sample-sharded over
    the mesh, host-partitioned into bounded (tile, spp-chunk)
    executions exactly like regen.render_regen_host.  Any spp: a
    non-divisible remainder runs one extra 1-sample chunk on the first
    r devices (masked on the rest).  On a 1-device mesh the compiled
    program is the single-chip fast path plus a trivial psum."""
    from ..integrators import regen as regen_mod
    spp = spp or scene.spp
    n_dev = mesh.devices.size
    w, h = scene.film_w, scene.film_h
    n_pix = w * h
    tile_pix = min(regen_mod.TILE_PIX, n_pix)
    n_tiles = (n_pix + tile_pix - 1) // tile_pix

    # main chunks: divisible slabs, each device's share under the
    # execution budget; remainder spp handled by masked 1-sample chunks
    spp_main = (spp // n_dev) * n_dev
    r = spp - spp_main
    local_cap = max(1, regen_mod.EXEC_PATH_BUDGET // tile_pix)
    spp_local = max(1, min(spp_main // n_dev, local_cap)) if spp_main else 1
    while spp_main % (spp_local * n_dev) != 0 and spp_local > 1:
        spp_local -= 1
    n_chunks = spp_main // (spp_local * n_dev) if spp_main else 0

    def _build(sl):
        return lambda: jax.jit(jax.shard_map(
            partial(_sharded_regen_tile, spp=spp, tile_pix=tile_pix,
                    spp_local=sl),
            mesh=mesh, in_specs=(P(), P(), P(), P(), P()), out_specs=P(),
            check_vma=False))

    mk = _mesh_key(mesh)
    fn = _cached_sharded(("regen", mk, spp, tile_pix, spp_local),
                         _build(spp_local))
    fn_rem = _cached_sharded(("regen", mk, spp, tile_pix, 1),
                             _build(1)) if r else None

    seed = jnp.asarray(seed, jnp.uint32)
    tiles = []
    for t in range(n_tiles):
        acc = None
        for c in range(n_chunks):
            tile = fn(scene, seed, jnp.uint32(t * tile_pix),
                      jnp.uint32(c * spp_local * n_dev), jnp.int32(n_dev))
            acc = tile if acc is None else acc + tile
        if r:
            tile = fn_rem(scene, seed, jnp.uint32(t * tile_pix),
                          jnp.uint32(spp_main), jnp.int32(r))
            acc = tile if acc is None else acc + tile
        tiles.append(acc)
    if n_tiles == 1:
        # tile_pix == n_pix: the accumulator IS the film — return the
        # device array directly (a host round-trip per call measurably
        # inflated the sharded fast path's overhead proxy)
        return tiles[0].reshape(h, w, 4)
    film = np.zeros((n_tiles * tile_pix, 4), np.float32)
    for t, acc in enumerate(tiles):
        film[t * tile_pix:(t + 1) * tile_pix] = np.asarray(acc)
    return jnp.asarray(film[:n_pix].reshape(h, w, 4))


def _local_replay_grad(scene: Scene, params, g_rgb, seed,
                       pix0, samp0_base, n_valid, spp: int, tile_pix: int,
                       spp_local: int):
    """Per-device body of the sharded replay adjoint: stored forward +
    backward walk over this device's sample chunk, grads psum-merged.
    g_rgb (d loss / d accumulated-rgb per FILM pixel) is replicated.
    Devices with index >= n_valid walk a dummy chunk whose gradients are
    masked out — the ragged-remainder path for spp % n_dev != 0."""
    from ..integrators.prb_replay import (_aux_pool, _detach, _replay_walk)
    from ..integrators.regen import _render_regen_tile
    dev = jax.lax.axis_index(AXIS)
    samp0 = samp0_base + dev.astype(jnp.uint32) * jnp.uint32(spp_local)
    sc_det = _detach(apply_params(scene, _detach(params)))
    _, pool_L = _render_regen_tile(sc_det, seed, spp, pix0, tile_pix,
                                   store_paths=True, samp0=samp0,
                                   spp_chunk=spp_local)
    aux = _aux_pool(scene, g_rgb, pool_L, seed, spp, pix0, tile_pix,
                    samp0, tile_pix * spp_local)
    g = _replay_walk(scene, params, seed, spp, aux, pix0, tile_pix,
                     samp0, spp_local)
    g = jax.tree_util.tree_map(
        lambda x: jnp.where(dev < n_valid, x, jnp.zeros_like(x)), g)
    return jax.lax.psum(g, AXIS)


def render_grad_replay_sharded(scene: Scene, mesh: Mesh, params,
                               loss_fn, spp: int, seed: int = 0):
    """(loss, grads, image) through the SHARDED replay adjoint — the fast
    gradient path (integrators/prb_replay.py) distributed over the mesh.

    Schedule: one sharded-regen primal for the loss image (sample-sharded,
    psum film), then per (pixel-tile, spp-chunk) partition a single
    shard-mapped program re-renders each device's sample chunk with path
    storage and replays it backward, psum-ing parameter grads — the
    replay walk is embarrassingly parallel over the path pool, so the
    only collectives per step are the film psum and the grad psum.
    Any spp: a remainder r = spp % n_dev runs one masked 1-sample round
    on the first r devices (the rest walk a dummy chunk whose grads are
    zeroed), so every sample is walked exactly once."""
    from ..integrators import regen as regen_mod
    from ..integrators import prb_replay as pr
    # configurations outside the replay adjoint's domain (sensor params,
    # spectral, surface-SSS, non-regen-able scenes) would silently return
    # zero grads here; the single-device render_grad falls back to the
    # scan adjoint for them — demand the same routing from the caller
    assert pr.replay_applicable(scene, params, spp), \
        "render_grad_replay_sharded: configuration outside the replay " \
        "adjoint's domain (see prb_replay.replay_applicable) — use the " \
        "scan adjoint (render_grad) for it"
    n_dev = mesh.devices.size
    w, h = scene.film_w, scene.film_h
    n_pix = w * h
    tile_pix = min(regen_mod.TILE_PIX, n_pix)
    n_tiles = (n_pix + tile_pix - 1) // tile_pix

    # primal (sharded fast path) -> loss image + per-pixel cotangent
    sc_det = apply_params(scene, jax.tree_util.tree_map(
        jax.lax.stop_gradient, params))
    acc = render_regen_sharded(sc_det, mesh, spp=spp, seed=seed)
    loss, image, g_rgb = pr._loss_from_acc_jit(acc, loss_fn)

    # per-device chunk: pools + walk working set must fit alongside the
    # wavefront; mirror the single-chip pool cap per device
    spp_main = (spp // n_dev) * n_dev
    r = spp - spp_main
    cap = pr._pool_spp_cap(scene, tile_pix)
    spp_local = max(1, min(max(spp_main // n_dev, 1), cap))
    while spp_main and (spp_main // n_dev) % spp_local != 0:
        spp_local -= 1
    n_chunks = spp_main // (spp_local * n_dev) if spp_main else 0

    def _build(sl):
        return lambda: jax.jit(jax.shard_map(
            partial(_local_replay_grad, spp=spp, tile_pix=tile_pix,
                    spp_local=sl),
            mesh=mesh, in_specs=(P(), P(), P(), P(), P(), P(), P()),
            out_specs=P(), check_vma=False))

    mk = _mesh_key(mesh)
    fn = _cached_sharded(("replay", mk, spp, tile_pix, spp_local),
                         _build(spp_local))
    fn_rem = _cached_sharded(("replay", mk, spp, tile_pix, 1),
                             _build(1)) if r else None

    seed = jnp.asarray(seed, jnp.uint32)
    grads = jax.tree_util.tree_map(jnp.zeros_like, params)
    for t in range(n_tiles):
        for c in range(n_chunks):
            g = fn(scene, params, g_rgb, seed, jnp.uint32(t * tile_pix),
                   jnp.uint32(c * spp_local * n_dev), jnp.int32(n_dev))
            grads = jax.tree_util.tree_map(jnp.add, grads, g)
        if r:
            g = fn_rem(scene, params, g_rgb, seed,
                       jnp.uint32(t * tile_pix), jnp.uint32(spp_main),
                       jnp.int32(r))
            grads = jax.tree_util.tree_map(jnp.add, grads, g)
    return loss, grads, image


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> None:
    """Multi-host bring-up (the jax.distributed runtime).

    On a single host this is a no-op; on several hosts call it once per
    process before building meshes (SURVEY §2.5 P7: the replacement for
    the reference's absent MPI/NCCL backend)."""
    if num_processes and num_processes > 1:
        jax.distributed.initialize(coordinator_address=coordinator,
                                   num_processes=num_processes,
                                   process_id=process_id)


def render_tiled(scene: Scene, mesh: Mesh, spp: int | None = None,
                 seed: int = 0, mode: str = "primal",
                 interleave: bool | None = None):
    """Pixel-sharded distributed render: each device renders a horizontal
    film slab at FULL spp and keeps its shard — no collective in the
    forward pass at all; the gather happens implicitly when the sharded
    film is assembled (film shard-gather at develop, SURVEY §2.5).
    Complements `render_sharded` (sample-sharded, psum-merged): tile
    sharding scales film memory, sample sharding scales spp.

    Load balance: with ``interleave`` (default whenever the filter
    footprint is one pixel), device d owns rows d, d+N, d+2N, ... instead
    of one contiguous slab — an expensive image region (e.g. the liver
    filling the lower half of the frame) is spread across all devices
    instead of stalling the slab that contains it.  Wider filters need
    contiguous slabs (their splat crosses row boundaries) and fall back
    to the static split."""
    spp = spp or scene.spp
    n_dev = mesh.devices.size
    h, w = scene.film_h, scene.film_w
    # pad the row count up to the mesh: each device renders `rows` rows;
    # rows past the film (global row >= h) are masked out of the shard
    # and sliced off after the gather — no divisibility requirement
    rows = (h + n_dev - 1) // n_dev
    h_pad = rows * n_dev
    if interleave is None:
        interleave = film_mod.filter_radius(scene.rfilter) == 0
    assert not (interleave and film_mod.filter_radius(scene.rfilter) > 0), \
        "interleaved tiling needs a 1px filter footprint (box)"

    def local(scene, seed):
        dev = jax.lax.axis_index(AXIS)
        # render the full frame's rays whose pixel row lands in our slab:
        # crop by rebasing the sensor row window [dev*rows, (dev+1)*rows)
        n_pix = w * rows
        n = n_pix * spp
        import jax.numpy as jnp
        from ..core.rng import make_sampler
        from ..sensor.perspective import sample_ray
        from ..integrators.common import _integrator_sample
        lane = jnp.arange(n, dtype=jnp.uint32)
        pix_local = lane // spp
        row_local = (pix_local // w).astype(jnp.uint32)
        if interleave:
            py = row_local * jnp.uint32(n_dev) + dev.astype(jnp.uint32)
        else:
            py = row_local + dev.astype(jnp.uint32) * rows
        px = (pix_local % w).astype(jnp.uint32)
        pix_global = py * w + px
        samp = lane % spp
        sampler = make_sampler(pix_global, samp, seed,
                               kind=scene.sampler_kind, spp=spp)
        uf, sampler = sampler.next_2d()
        pos = jnp.stack([px.astype(jnp.float32),
                         py.astype(jnp.float32)], -1) + uf
        ray = sample_ray(scene, pos)
        L, valid, _ = _integrator_sample(scene, sampler, ray, mode=mode)
        L = jnp.where(jnp.isfinite(L), L, 0.0)
        # local splat into the slab: pos rebased to this device's rows
        pos_local = jnp.stack(
            [pos[:, 0], row_local.astype(jnp.float32) + (pos[:, 1] % 1.0)],
            -1)
        acc = film_mod.splat(w, rows, scene.rfilter, pos_local, L)
        # zero padded rows (global row >= h): values AND weights, so the
        # develop of the assembled film sees no phantom samples
        lr = jnp.arange(rows)
        grow = lr * n_dev + dev if interleave else dev * rows + lr
        acc = acc * (grow < h)[:, None, None]
        return acc

    fn = jax.shard_map(local, mesh=mesh, in_specs=(P(), P()),
                       out_specs=P(AXIS), check_vma=False)

    @jax.jit
    def run(sc, sd):
        acc = fn(sc, sd)
        c = acc.shape[-1]
        if interleave:
            # gathered order is dev-major (dev, local); image row
            # local * n_dev + dev -> transpose back to scanline order
            acc = acc.reshape(n_dev, rows, w, c).transpose(1, 0, 2, 3)
        return film_mod.develop(acc.reshape(h_pad, w, c)[:h])

    return run(scene, jnp.asarray(seed, jnp.uint32))


def measure_scaling(scene: Scene, n_devices: int | None = None,
                    spp: int = 16, seed: int = 0, reps: int = 3,
                    renderer: str = "pass") -> dict:
    """Wall-clock scaling proxy on whatever devices exist (virtual CPU
    mesh or a real slice): render a FIXED total workload on a 1-device
    mesh and on the full mesh; efficiency = t1 / (tN * N) on real chips.

    renderer="regen" times the sharded FAST path (render_regen_sharded);
    "pass" times the fixed-wavefront render_sharded.

    On the virtual CPU mesh all "devices" share one host, so the ideal
    is equal wall-clock (the same total flops) and the reported
    ``efficiency_proxy`` = t1 / tN measures pure sharding/collective
    overhead (1.0 = the mesh partitioning costs nothing).  BASELINE.md
    target: >= 0.8 at >= 2 hosts."""
    import time

    n = n_devices or len(jax.devices())
    mesh1 = make_mesh(1)
    meshN = make_mesh(n)

    def run(mesh, s):
        if renderer == "regen":
            return render_regen_sharded(scene, mesh, spp=spp, seed=s)
        return render_sharded(scene, mesh, spp=spp, seed=s)

    def timed(mesh):
        run(mesh, seed).block_until_ready()
        t0 = time.perf_counter()
        for i in range(reps):
            run(mesh, seed + 1 + i).block_until_ready()
        return (time.perf_counter() - t0) / reps

    t1, tn = timed(mesh1), timed(meshN)
    same_host = len({d.process_index for d in jax.devices()[:n]}) == 1 and \
        jax.devices()[0].platform == "cpu"
    eff = t1 / tn if same_host else t1 / (tn * n)
    return {"n_devices": n, "t_1dev_s": round(t1, 4),
            "t_ndev_s": round(tn, 4),
            "efficiency_proxy" if same_host else "efficiency":
                round(eff, 4)}


_DTYPE_BYTES = {"f32": 4, "f64": 8, "f16": 2, "bf16": 2, "s32": 4,
                "u32": 4, "s64": 8, "u64": 8, "pred": 1, "s8": 1, "u8": 1}


def collective_stats(jitted_fn, *args) -> dict:
    """Per-step collective accounting from the COMPILED program: lower
    the jitted function, parse its optimized HLO, and total the bytes
    moved by each collective kind (all-reduce / all-gather /
    reduce-scatter / collective-permute / all-to-all).

    This is the evidence BASELINE.md's >=80%-at->=2-hosts target rests
    on: the forward film psum + the adjoint's gradient psum should be the
    ONLY collectives, and their volume per step is what must ride
    ICI/DCN."""
    import re

    txt = jitted_fn.lower(*args).compile().as_text()
    out: dict = {}
    kinds = ("all-reduce", "all-gather", "reduce-scatter",
             "collective-permute", "all-to-all")
    shape_pat = re.compile(r"(\w+)\[([\d,]*)\](?:\{[\d,]*\})?")
    for line in txt.splitlines():
        if "=" not in line:
            continue
        rhs = line.split("=", 1)[1]
        kind = next((k for k in kinds
                     if re.search(rf"\b{k}(?:-start)?\(", rhs)), None)
        if kind is None:
            continue
        # result shapes sit between '=' and the op name
        head = rhs.split(kind)[0]
        nbytes = 0
        for dt, dims in shape_pat.findall(head):
            n = 1
            for d in dims.split(","):
                if d:
                    n *= int(d)
            nbytes += n * _DTYPE_BYTES.get(dt, 4)
        e = out.setdefault(kind, {"ops": 0, "bytes": 0})
        e["ops"] += 1
        e["bytes"] += nbytes
    return out


def make_train_step(scene: Scene, mesh: Mesh, loss_fn, optimizer,
                    spp: int, mode: str = "ad"):
    """Build a jitted distributed inverse-rendering step:
    (params, opt_state, target, seed) -> (params, opt_state, loss).

    The full PRB-style step — forward render, adjoint sweep, parameter
    psum, Adam update — compiles to ONE XLA program on the mesh.
    """
    n_dev = mesh.devices.size
    spp_local, r = divmod(spp, n_dev)

    local = jax.shard_map(
        partial(_local_pass, spp_local=spp_local, mode=mode, extra=r),
        mesh=mesh, in_specs=(P(), P()), out_specs=P(), check_vma=False)

    def loss_of(params, target, seed):
        sc = apply_params(scene, params)
        img = film_mod.develop(local(sc, seed))
        return loss_fn(img, target)

    @jax.jit
    def step(params, opt_state, target, seed):
        loss, grads = jax.value_and_grad(loss_of)(params, target, seed)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        import optax
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    return step
