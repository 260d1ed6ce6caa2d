"""Wavefront path regeneration: keep the lanes full.

The fixed-wavefront loop (common.render_pass) pays full width on every
iteration while lanes die off — by the RR tail most of the wavefront is
masked off (the megakernel-vs-wavefront trade the reference tunes with the
-W flag, integrator.cpp:275-293 / path.cpp:320-336).  This variant keeps a
wavefront of W lanes saturated: when a lane's path terminates, its radiance
is splatted into the film *inside the loop* and the lane is re-seeded with
the next (pixel, sample) from the global pool, so utilization stays ~100%
until the pool drains.

Applies to the volpath family AND the surface `path` family (incl. SSS
scenes, which hook `path` — path.cpp:262-265) in primal mode with a
box/tent filter; other configurations fall back to the fixed wavefront.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..core.rng import make_sampler
from ..emitter.dispatch import eval_environment
from ..scene.ir import Scene
from ..sensor.perspective import sample_ray
from . import volpath as vp

import os as _os

# lanes kept in flight; smaller wavefronts shrink the drain tail at the
# end of the sample budget (it costs W * straggler iterations), larger
# ones amortize per-iteration overhead and fill more of the device.  64k
# was the best width on the previous accelerator; not yet swept on a GPU,
# where 64k lanes fill only part of the resident threads
REGEN_WAVEFRONT = int(_os.environ.get("LR_WAVEFRONT", 1 << 16))

# integrator names handled by the surface-path wavefront (path.py); the
# rest of the regen-able set runs the volpath wavefront (volpath.py)
_SURFACE = ("path", "direct")


def _family(scene: Scene):
    """Integrator module providing init_state/bounce for this scene —
    scene.integrator is a static field, so this resolves at trace time."""
    if scene.integrator in _SURFACE:
        from . import path as path_mod
        return path_mod
    return vp


def _lane_cap(scene: Scene) -> int:
    """Per-lane iteration budget, matching each family's fixed-wavefront
    loop cap so both renderers compute the identical per-sample estimate:
    volpath.sample caps at max_depth*4 (null collisions don't advance
    depth); path.sample lanes die by the depth gate itself."""
    return scene.max_depth * (1 if scene.integrator in _SURFACE else 4)


def pool_channels(scene: Scene) -> int:
    """Channel count of the stored-path pool: the spectral variant pools
    the WAVELENGTH-PACKET radiance (the replay adjoint computes suffix
    weights in packet space), RGB otherwise."""
    if scene.spectral:
        from ..core import spectrum as spec
        return spec.N_SPEC
    return 3


def _finalize_L2(scene: Scene, st):
    """(film_rgb, pool_vec) at lane death.  The volpath family defers the
    environment contribution into env_weight (one env eval per death
    instead of per bounce); the surface family folds it into L in-loop.
    Spectral lanes convert their wavelength packet to RGB for the FILM
    but keep the packet for the POOL (the replay adjoint's suffix
    identity lives in packet space)."""
    if hasattr(st, "env_weight"):
        env = eval_environment(scene, st.ray_d)
        if scene.spectral:
            from ..core import spectrum as spec
            env = spec.smits_upsample_illum(env, st.lam)
            Lp = st.L + st.env_weight * env
            return spec.spec_to_rgb_estimate(Lp, st.lam), Lp
        L = st.L + st.env_weight * env
        return L, L
    if scene.spectral:
        from ..core import spectrum as spec
        return spec.spec_to_rgb_estimate(st.L, st.lam), st.L
    return st.L, st.L


def _finalize_L(scene: Scene, st):
    return _finalize_L2(scene, st)[0]


def _make_lanes(scene: Scene, sample_ids, seed, spp: int, pix0: int = 0,
                tile_pix: int | None = None, samp0=0):
    """Seed path states for sample indices (pixel-minor ordering so early
    iterations cover the whole film).  pix0/tile_pix restrict the sample
    pool to a pixel tile (large-film mode); samp0 offsets the per-pixel
    sample index (spp-chunked replay, prb_replay.py) — the counter RNG
    keys on the GLOBAL (pixel, sample) pair so any partitioning of the
    sample budget walks bit-identical paths."""
    w, h = scene.film_w, scene.film_h
    n_pix = tile_pix if tile_pix is not None else w * h
    pix = (sample_ids % n_pix).astype(jnp.uint32) \
        + jnp.asarray(pix0, jnp.uint32)
    samp = (sample_ids // n_pix).astype(jnp.uint32) \
        + jnp.asarray(samp0, jnp.uint32)
    sampler = make_sampler(pix, samp, seed, kind=scene.sampler_kind, spp=spp)
    px = (pix % w).astype(jnp.float32)
    py = (pix // w).astype(jnp.float32)
    uf, sampler = sampler.next_2d()
    pos = jnp.stack([px, py], -1) + uf
    ray = sample_ray(scene, pos)
    st = _family(scene).init_state(ray, sampler, scene)
    return st, pos


def lane_pos(scene: Scene, sample_ids, seed, spp: int, pix0=0,
             tile_pix: int | None = None, samp0=0):
    """Film position of each sample id WITHOUT building the path state —
    same RNG draw as _make_lanes (the camera jitter is the sampler's
    first 2D), so the PRB replay adjoint can precompute per-sample filter
    cotangents before its backward walk."""
    w, h = scene.film_w, scene.film_h
    n_pix = tile_pix if tile_pix is not None else w * h
    pix = (sample_ids % n_pix).astype(jnp.uint32) \
        + jnp.asarray(pix0, jnp.uint32)
    samp = (sample_ids // n_pix).astype(jnp.uint32) \
        + jnp.asarray(samp0, jnp.uint32)
    sampler = make_sampler(pix, samp, seed, kind=scene.sampler_kind, spp=spp)
    px = (pix % w).astype(jnp.float32)
    py = (pix // w).astype(jnp.float32)
    uf, _ = sampler.next_2d()
    return jnp.stack([px, py], -1) + uf


def _select_state(mask, new, old):
    return jax.tree_util.tree_map(
        lambda a, b: jnp.where(
            mask.reshape(mask.shape + (1,) * (a.ndim - 1)), a, b), new, old)


# pixels per regen tile: films above this are rendered tile-by-tile so the
# while-loop film carry stays small (on the previous accelerator a 1080p
# carry doubled the per-iteration cost; not yet re-measured on a GPU)
TILE_PIX = 1 << 18

# paths per DEVICE EXECUTION for the host-driven schedule: bounded
# executions keep progress, cancellation and timeouts (RenderControl)
# responsive and each program's memory bounded.  Per-path cost varies
# ~10x across scenes, so render_regen_host additionally ADAPTS the chunk
# size from a timed probe execution (PROBE_PATHS, TARGET_EXEC_S below);
# this constant is the absolute cap.
EXEC_PATH_BUDGET = 1 << 26

# probe-adaptive scheduling: first execution renders PROBE_PATHS paths
# and is timed (execution only — the program is compiled separately so
# compile time does not pollute the estimate); remaining chunks
# target TARGET_EXEC_S seconds each, as power-of-two spp chunks so the
# compile variety stays logarithmic (each size caches persistently).
PROBE_PATHS = 1 << 22
TARGET_EXEC_S = 18.0

# jobs at or under this path budget run as ONE device execution (no
# probe, no chunking): every chunk boundary costs a wavefront drain tail
# plus a host round-trip, which on the previous accelerator cost 16% of a
# 6.6M-path bench job.  Not yet re-measured on a GPU.
SINGLE_EXEC_PATHS = 1 << 23

# path-pool packing factor (see _render_regen_tile store_paths)
_POOL_PACK = 8

# per-scene measured path rate (render_regen_host probe results), so
# repeat renders of one scene skip the probe's fragmented chunk schedule
_RATE_CACHE: dict = {}


def _render_regen_tile(scene: Scene, seed, spp: int, pix0, tile_pix: int,
                       store_paths: bool = False, samp0=0,
                       spp_chunk: int | None = None):
    """One regenerating wavefront over a pixel tile -> (tile_pix, 4).

    store_paths: additionally record every finished path's radiance into a
    (tile_pix*spp_chunk, 3) pool indexed by sample id — the residual the
    PRB replay adjoint (integrators/prb_replay.py) needs to reconstruct
    suffix radiance during its backward walk.

    samp0/spp_chunk: render only samples [samp0, samp0+spp_chunk) of each
    pixel (spp stays the TOTAL so pattern samplers keep their layout) —
    the replay adjoint's spp-chunked schedule for budgets past its pool."""
    from ..scene.ir import FILTER_TENT
    w, h = scene.film_w, scene.film_h
    budget = tile_pix * (spp if spp_chunk is None else spp_chunk)
    W = min(REGEN_WAVEFRONT, budget)
    # Measured dead end (round 3, previous accelerator): replacing the
    # in-loop film scatter-add with a post-loop per-pixel reduction of the
    # path pool (box pixel == sid % tile_pix) ran SLOWER than keeping the
    # splat — dropping the film from the loop carry appears to break the
    # pool buffer's in-place aliasing.  Keep the in-loop splat.

    st, pos = _make_lanes(scene, jnp.arange(W, dtype=jnp.uint32), seed, spp,
                          pix0, tile_pix, samp0)
    sid = jnp.arange(W, dtype=jnp.uint32)
    # path pool, PACKED several samples per row: XLA's scatter was
    # measured cheaper into <= 2^18-row tables, nearly independent of
    # width, so wide-few-rows is the layout for the per-iteration store;
    # the walk reads the reshaped flat view.
    #
    # Box filter + small spp chunk additionally FUSE the film splat into
    # the same scatter (one table: row = pixel = sid % tile_pix, columns
    # [film RGBA | stratum-s L-block]) — one scatter-add per iteration
    # instead of two.
    spc = spp if spp_chunk is None else spp_chunk
    C = pool_channels(scene)         # pool width: RGB or spectral packet
    fused = store_paths and scene.rfilter != FILTER_TENT and spc <= 16
    if fused:
        film_pool = jnp.zeros((tile_pix, 4 + C * spc))
        pool_L = jnp.zeros((1, 1))
        film = jnp.zeros((tile_pix, 4))
    else:
        n_rows = ((budget + _POOL_PACK - 1) // _POOL_PACK) \
            if store_paths else 1
        pool_L = jnp.zeros((n_rows, C * _POOL_PACK))
        film_pool = jnp.zeros((1, 1))
        film = jnp.zeros((tile_pix, 4))
    refills = (budget + W - 1) // W
    # per-lane iteration budget matches the fixed wavefront's loop cap
    # (_lane_cap) so both renderers compute the identical per-sample
    # estimate; the global cap is just a runaway backstop
    fam = _family(scene)
    lane_cap = _lane_cap(scene)
    max_iters = lane_cap * (refills + 2)

    def cond(c):
        st, pos, sid, film, pool_L, film_pool, age, next_s, it = c
        return jnp.any(st.active) & (it < max_iters)

    def body(c):
        st, pos, sid, film, pool_L, film_pool, age, next_s, it = c
        was_active = st.active
        st = fam.bounce(scene, st, False)
        age = age + 1
        st = st.replace(active=st.active & (age < lane_cap))
        died = was_active & ~st.active

        # finalize + splat the finished lanes.  box: one tap; tent: the
        # 2x2 filter-weighted neighborhood (the GlissonCapsule/Parenchyma
        # scenes' rfilter).  Lanes of the padded last tile carry pixel ids
        # >= n_pix (pos_y >= h before clipping): their splats are masked
        # out, not clamped into real pixels; taps landing outside the tile
        # are dropped by the scatter's OOB semantics (filter-importance
        # normalization in develop keeps the estimator consistent).
        L, Lpool = _finalize_L2(scene, st)
        L = jnp.where(jnp.isfinite(L), L, 0.0)
        Lpool = jnp.where(jnp.isfinite(Lpool), Lpool, 0.0)
        in_range = pos[:, 1] < h
        p0i = jnp.asarray(pix0, jnp.int32)
        if fused:
            # one fused scatter-add: film RGBA into cols [0,4) of the
            # lane's pixel row, radiance into the sample-stratum block
            row = jnp.where(died, (sid % jnp.uint32(tile_pix))
                            .astype(jnp.int32), tile_pix)
            blk = (sid // jnp.uint32(tile_pix)).astype(jnp.int32)
            onehot = blk[:, None] == jnp.arange(spc)[None, :]
            pool_cols = (onehot[:, :, None] * Lpool[:, None, :]).reshape(
                W, C * spc)
            film_cols = jnp.concatenate([L, jnp.ones((W, 1))], -1) \
                * in_range[:, None]
            film_pool = film_pool.at[row].add(
                jnp.concatenate([film_cols, pool_cols], -1), mode="drop")
        elif store_paths:
            row = jnp.where(died, sid // _POOL_PACK, jnp.uint32(n_rows))
            blk = (sid % _POOL_PACK).astype(jnp.int32)
            onehot = blk[:, None] == jnp.arange(_POOL_PACK)[None, :]
            vals = (onehot[:, :, None] * Lpool[:, None, :]).reshape(
                W, C * _POOL_PACK)
            # each sample dies exactly once -> add == set on zeros
            pool_L = pool_L.at[row].add(vals, mode="drop")
        if fused:
            pass                         # film handled by the fused write
        elif scene.rfilter == FILTER_TENT:
            ix0 = jnp.floor(pos[:, 0] - 0.5).astype(jnp.int32)
            iy0 = jnp.floor(pos[:, 1] - 0.5).astype(jnp.int32)
            idxs, datas = [], []
            for dy in (0, 1):
                for dx in (0, 1):
                    ix = ix0 + dx
                    iy = iy0 + dy
                    fw = jnp.maximum(1.0 - jnp.abs(pos[:, 0]
                                                   - (ix + 0.5)), 0.0) \
                        * jnp.maximum(1.0 - jnp.abs(pos[:, 1]
                                                    - (iy + 0.5)), 0.0)
                    ok = died & in_range & (ix >= 0) & (ix < w) \
                        & (iy >= 0) & (iy < h)
                    tap_idx = iy * w + ix - p0i
                    # out-of-tile taps -> send out of bounds (dropped)
                    tap_idx = jnp.where(ok, tap_idx, -1)
                    idxs.append(tap_idx)
                    datas.append(jnp.concatenate(
                        [L * fw[:, None], fw[:, None]], -1)
                        * ok[:, None])
            film = film.at[jnp.concatenate(idxs)].add(
                jnp.concatenate(datas),
                mode="drop")
        else:
            px = jnp.clip(pos[:, 0].astype(jnp.int32), 0, w - 1)
            py = jnp.clip(pos[:, 1].astype(jnp.int32), 0, h - 1)
            idx = py * w + px - p0i
            data = jnp.concatenate([L, jnp.ones((W, 1))], -1)
            film = film.at[idx].add(
                jnp.where((died & in_range)[:, None], data, 0.0))

        # regenerate from the pool
        ranks = jnp.cumsum(died.astype(jnp.uint32)) - 1
        new_ids = next_s + ranks
        take = died & (new_ids < budget)
        new_st, new_pos = _make_lanes(scene, jnp.where(take, new_ids, 0),
                                      seed, spp, pix0, tile_pix, samp0)
        st = _select_state(take, new_st, st)
        pos = jnp.where(take[:, None], new_pos, pos)
        sid = jnp.where(take, new_ids, sid)
        age = jnp.where(take, 0, age)
        next_s = jnp.minimum(next_s + jnp.sum(died.astype(jnp.uint32)),
                             jnp.uint32(budget))
        return st, pos, sid, film, pool_L, film_pool, age, next_s, it + 1

    init = (st, pos, sid, film, pool_L, film_pool,
            jnp.zeros((W,), jnp.int32), jnp.uint32(W), jnp.int32(0))
    st, pos, sid, film, pool_L, film_pool, age, next_s, it = \
        jax.lax.while_loop(cond, body, init)
    if fused:
        # flat (budget, C) view: sample sid = s*tile_pix + p lives at
        # film_pool[p, 4+Cs : 4+Cs+C]
        pool_flat = film_pool[:, 4:].reshape(tile_pix, spc, C) \
            .transpose(1, 0, 2).reshape(-1, C)[:budget]
        return film_pool[:, :4], pool_flat
    if store_paths:
        # flat (budget, C) view: row r cols [Cc,Cc+C) == sample r*PACK+c
        return film, pool_L.reshape(-1, C)[:budget]
    return film


@partial(jax.jit, static_argnames=("spp",))
def render_regen(scene: Scene, seed, spp: int):
    """Full-frame render with lane regeneration -> (h, w, 4) accumulator."""
    w, h = scene.film_w, scene.film_h
    n_pix = w * h
    if n_pix <= TILE_PIX:
        film = _render_regen_tile(scene, seed, spp, 0, n_pix)
        return film.reshape(h, w, 4)

    # tile-by-tile: every tile's loop carries only its own small film.
    # Pixels past n_pix in the padded last tile render but their splats
    # land beyond the slice and the lanes are pure (bounded) waste.
    n_tiles = (n_pix + TILE_PIX - 1) // TILE_PIX

    def tile_body(t, film):
        tile = _render_regen_tile(scene, seed, spp, t * TILE_PIX,
                                  TILE_PIX)
        return jax.lax.dynamic_update_slice(film, tile, (t * TILE_PIX, 0))

    film = jax.lax.fori_loop(
        0, n_tiles, tile_body, jnp.zeros((n_tiles * TILE_PIX, 4)))
    return film[:n_pix].reshape(h, w, 4)


@partial(jax.jit, static_argnames=("spp", "tile_pix", "spp_chunk"))
def _host_tile_jit(scene: Scene, seed, pix0, samp0, spp: int,
                   tile_pix: int, spp_chunk: int):
    """One (pixel-tile, spp-chunk) device execution for the host driver.
    pix0/samp0 are traced so every partition reuses one compiled program."""
    return _render_regen_tile(scene, seed, spp, pix0, tile_pix,
                              samp0=samp0, spp_chunk=spp_chunk)


class RenderControl:
    """Cooperative cancellation + wall-clock timeout + progress for host-
    scheduled renders (reference Integrator::cancel/should_stop/m_timeout,
    integrator.h:290-302 + integrator.cpp:26): checked BETWEEN the
    (tile, spp-chunk) device executions, so one execution (< ~17 s under
    EXEC_PATH_BUDGET) is the response granularity.  On stop the partial
    accumulator develops normally — filter weights stay consistent, pixels
    of unrendered tiles are zero-weight (black), matching the reference's
    SIGHUP partial develop (mitsuba.cpp:93-96).

    timeout: seconds of wall clock (0 = none), measured from construction.
    on_progress: optional callable(frac_done in [0, 1]).
    frame(): the developed partial image at any moment (e.g. from the
    checkpoint.install_partial_develop signal handler)."""

    def __init__(self, timeout: float = 0.0, on_progress=None):
        import time
        self.timeout = timeout
        self.on_progress = on_progress
        self.stopped = False          # set when a render aborted early
        self._cancel = False
        self._t0 = time.monotonic()
        self._partial = None          # (h, w, 4) np accumulator view
        self._shape = None

    def cancel(self) -> None:
        self._cancel = True

    def _arm(self) -> None:
        """Called by render_regen_host at render start: restart the
        timeout clock and clear a previous render's stop flag so one
        control object can drive several sequential renders.  An explicit
        cancel() sticks until the user re-creates or re-arms deliberately
        (cancelling between renders must cancel the next one too)."""
        import time
        self._t0 = time.monotonic()
        self.stopped = False

    def should_stop(self) -> bool:
        import time
        return self._cancel or (
            self.timeout > 0
            and time.monotonic() - self._t0 > self.timeout)

    def frame(self):
        """Developed partial image (h, w, 3), or None before any tile."""
        if self._partial is None:
            return None
        from .. import film as film_mod
        import numpy as np
        h, w = self._shape
        return np.asarray(
            film_mod.develop(jnp.asarray(self._partial[:h * w]
                                         .reshape(h, w, 4))))

    def _update(self, film, shape, frac) -> None:
        self._partial, self._shape = film, shape
        if self.on_progress is not None:
            self.on_progress(frac)


def render_regen_host(scene: Scene, seed, spp: int,
                      control: RenderControl | None = None):
    """Host-driven regen render: identical accumulator to `render_regen`
    (same counter RNG per sample id) but partitioned into (tile, spp-chunk)
    device executions of bounded length, so progress, cancellation and
    timeouts (RenderControl) take effect between them.

    The chunk size is PROBE-ADAPTIVE: per-path cost varies ~10x across
    scenes, so the second execution (first is a warm-up that may include
    compile) is timed and the remaining chunks target TARGET_EXEC_S
    seconds each, as power-of-two spp chunks (bounded compile variety)
    capped by EXEC_PATH_BUDGET.  Small jobs = one execution (unless a
    RenderControl is supplied — cancellation needs partition boundaries)."""
    import time as _time

    import numpy as np

    if control is not None:
        control._arm()
    w, h = scene.film_w, scene.film_h
    n_pix = w * h
    tile_pix = min(TILE_PIX, n_pix)
    n_tiles = (n_pix + tile_pix - 1) // tile_pix
    budget_cap = EXEC_PATH_BUDGET if control is None \
        else min(EXEC_PATH_BUDGET, max(tile_pix, n_pix * spp // 4))
    cap_spp = max(1, budget_cap // tile_pix)
    if n_pix * spp <= SINGLE_EXEC_PATHS and control is None:
        return render_regen(scene, seed, spp)

    seed_u = jnp.asarray(seed, jnp.uint32)
    c0 = min(spp, max(1, PROBE_PATHS // tile_pix), cap_spp)
    c0 = 1 << (c0.bit_length() - 1)
    # per-scene measured path rate, cached across calls (keyed by the
    # geometry buffer identity — stable for a loaded Scene object): the
    # SECOND render of a scene skips the probe entirely, so its first
    # tile runs full-size chunks instead of the probe's fragmented
    # 2xc0 + powers-of-two split (the fragmentation costs a drain tail
    # per extra execution)
    rate_key = (id(scene.vertices), scene.n_tris, scene.integrator,
                scene.max_depth, tile_pix)
    rate = _RATE_CACHE.get(rate_key)
    if rate is not None:
        cm = max(c0, min(int(TARGET_EXEC_S * rate // tile_pix), cap_spp))
        c_eff = 1 << (cm.bit_length() - 1)
        timed = True
    else:
        c_eff = c0
        timed = False
    n_exec = 0
    film = np.zeros((n_tiles * tile_pix, 4), np.float32)
    for t in range(n_tiles):
        acc = None
        s0 = 0
        while s0 < spp:
            if control is not None and control.should_stop():
                control.stopped = True
                if acc is not None:
                    film[t * tile_pix:(t + 1) * tile_pix] = acc
                return jnp.asarray(film[:n_pix].reshape(h, w, 4))
            c = min(c_eff, 1 << ((spp - s0).bit_length() - 1))
            t0 = _time.perf_counter()
            tile = np.asarray(_host_tile_jit(
                scene, seed_u, jnp.uint32(t * tile_pix), jnp.uint32(s0),
                spp, tile_pix, c))
            dt = _time.perf_counter() - t0
            n_exec += 1
            if not timed and n_exec == 2 and c == c0:
                # execution-only estimate (exec 1 may have compiled)
                rate = tile_pix * c / max(dt, 1e-3)
                _RATE_CACHE[rate_key] = rate
                cm = max(c0, min(int(TARGET_EXEC_S * rate // tile_pix),
                                 cap_spp))
                c_eff = 1 << (cm.bit_length() - 1)
                timed = True
            acc = tile if acc is None else acc + tile
            s0 += c
            if control is not None:
                film[t * tile_pix:(t + 1) * tile_pix] = acc
                control._update(film, (h, w),
                                (t * spp + s0) / (n_tiles * spp))
        film[t * tile_pix:(t + 1) * tile_pix] = acc
    return jnp.asarray(film[:n_pix].reshape(h, w, 4))


def regen_applicable(scene: Scene, mode: str) -> bool:
    from ..scene.ir import FILTER_BOX, SENSOR_IRRADIANCEMETER, SENSOR_THINLENS
    # thinlens/irradiancemeter need an extra 2d sample per camera ray that
    # the regen seeding does not draw
    from ..scene.ir import FILTER_TENT
    from .volpath import _has_bio
    # non-bio volpathmis runs the true spectral-MIS scheme
    # (integrators/volpathmis.py) which the regen bounce does not carry —
    # EXCEPT under the spectral variant, where wavelength-packet tracking
    # subsumes the RGB-channel MIS and volpathmis runs the (regen-able)
    # spectral volpath machinery
    ok_names = ("volpath", "biovolpath", "biovolpath06") + _SURFACE \
        + (("volpathmis",) if (_has_bio(scene) or scene.spectral) else ())
    return (mode == "primal"
            and scene.integrator in ok_names
            and scene.rfilter in (FILTER_BOX, FILTER_TENT)
            and scene.sensor.stype not in (SENSOR_THINLENS,
                                           SENSOR_IRRADIANCEMETER))
