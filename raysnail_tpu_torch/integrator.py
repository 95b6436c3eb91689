"""The wavefront path-tracing integrator.

The reference's recursive `ray_color` (src/camera.rs:156-255) as a bounce
body over a dense ray batch with masked lanes, driven by one of three loops:
  * the shuffled path-regeneration loop (`radiance_regen_shuffle`, the
    frame step) and its per-pixel form (`radiance_regen`, the sample step):
    when a lane's path dies it starts its next cell in place, so the loop
    runs for about spp x the mean path length iterations instead of
    spp x max_depth. On the card the shuffled loop replays its trips as
    CUDA graphs (`graphs.py`);
  * the per-sample scan (`radiance`, `radiance_and_alive`): max_depth
    bounces of one sample per lane, dead lanes masked. It takes any keys
    (fast streams or threefry keys); it is the gradient path
    (`diff.train`), as in the JAX package.

Estimator (compat path, the default — camera.rs:194-247):
  * emitted term added every bounce (before scattering);
  * skip_pdf materials (metal, dielectric): follow the specular ray,
    throughput *= albedo;
  * otherwise a 50/50 branch:
      - light branch: direction toward a random light, denominator pdf
        HARDCODED to 1/pi (camera.rs:199), shadow origin backed off along the
        incoming ray by shadow_eps (camera.rs:208-212), optional phong
        highlight multiplier (camera.rs:199-206);
      - BSDF branch: sample the material's pdf; numerator == denominator so
        the weight is exactly 1 (camera.rs:216-218, 240-242);
    weight = pdf.value(dir) / pdf_val with the reference's <=0/NaN clamp of
    the denominator to 1e-5 (camera.rs:236-238).
  * miss -> background gradient, ray dies (camera.rs:254).

cfg.proper_mis selects the physically-correct one-sample MIS estimator
(0.5*(p_light + p_bsdf) in the denominator with the true solid-angle light
pdf).
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from raysnail_tpu_torch import graphs as trip_graphs
from raysnail_tpu_torch import lights as lightslib
from raysnail_tpu_torch import materials as matlib
from raysnail_tpu_torch import scene as scenelib
from raysnail_tpu_torch import textures as texlib
from raysnail_tpu_torch.camera import Ray, generate_rays
from raysnail_tpu_torch.config import RenderConfig
from raysnail_tpu_torch.prelude import rng as prng
from raysnail_tpu_torch.prelude.sampling import PI
from raysnail_tpu_torch.prelude.vec import Vec3
from raysnail_tpu_torch.utils.profiling import span


def _slot_layout(kinds: frozenset, has_lights: bool, mix_depth: int = 1):
    """Per-bounce uniform slots, allocated only for the material/light kinds
    the scene contains (a pure Lambertian scene draws 6 uniforms per bounce
    instead of 17). Nested Mixed materials draw one uniform per level
    (mixed_material.rs:41-50)."""
    idx = {}
    n = 0
    if matlib.MIXED in kinds:
        idx["mix"] = n
        n += mix_depth
    if has_lights:
        idx["branch"], idx["pick"], idx["l1"], idx["l2"] = n, n + 1, n + 2, n + 3
        n += 4
    if matlib.DIELECTRIC in kinds:
        idx["refl"] = n
        n += 1
    idx["bsdf"] = n
    n += 2  # base cosine / sphere sample
    if (matlib.DIFFUSE_METAL in kinds) or (matlib.BLINN_PHONG in kinds):
        n += 2 * matlib.REJECT_TRIES
    if matlib.BLINN_PHONG in kinds:
        n += 1
    return idx, n


# static sphere groups at least this large take the BVH traversal kernel
# under sphere_bvh "auto" (the JAX package's crossover, measured on a TPU;
# ROADMAP M12 asks for the H100's)
SPHERE_BVH_AUTO_MIN = 4096


def kernel_routes(scene: scenelib.Scene, arrays: scenelib.SceneArrays,
                  cfg: RenderConfig) -> scenelib.Routes:
    """Which groups take the BVH traversal kernel: the JAX package's
    `_pallas_policy` with "cpu" meaning the scene's tensors lie on the CPU.
    On CUDA, "auto" routes every mesh through the kernel with "entry"
    binning, large box groups through kind "box" and sphere groups of
    SPHERE_BVH_AUTO_MIN or more through kind "sphere"; on the CPU it keeps
    the dense and brute routes, and "force" takes the kernel route (whose
    plain version runs on CPU tensors).

    Which traversal kernel a route takes is `ops.bvh_traverse`'s choice at
    call time, from what the scene and the environment say: a mesh compiled
    with RAYSNAIL_MESH_SOLVER=mxu carries "tri_mxu" blocks, leaf blocks
    above RAYSNAIL_BVH_STREAM_BYTES are streamed, RAYSNAIL_BVH_TWO_LEVEL=1
    turns the two-level walk on, and each of these takes the packet kernel.
    cfg.bvh_packet "force" sends the other calls through it too."""
    on_cpu = scene.device.type == "cpu"
    mesh_kernel = cfg.mesh_pallas == "force" or (cfg.mesh_pallas == "auto" and not on_cpu)
    n_spheres = arrays.spheres.radius.shape[0] if arrays.spheres is not None else 0
    sphere_bvh = cfg.sphere_bvh == "force" or (
        cfg.sphere_bvh == "auto" and not on_cpu and n_spheres >= SPHERE_BVH_AUTO_MIN)
    has_box_pk = arrays.boxes is not None and arrays.boxes.pk_bb is not None
    box_bvh = has_box_pk and (cfg.box_bvh == "force" or (cfg.box_bvh == "auto" and not on_cpu))
    if cfg.mesh_bin == "auto":
        mesh_bin = "entry" if mesh_kernel and not on_cpu else "never"
    else:
        mesh_bin = cfg.mesh_bin
    return scenelib.Routes(mesh_kernel=mesh_kernel, mesh_bin=mesh_bin,
                           sphere_bvh=sphere_bvh, box_bvh=box_bvh,
                           packet={"force": True, "never": False}.get(cfg.bvh_packet))


def _make_shade(scene: scenelib.Scene, cfg: RenderConfig, routes: scenelib.Routes):
    """One bounce of the estimator: (arrays, o, d, T, L, alive, kb, time) ->
    (new_o, new_d, T, L, alive). Dead lanes keep their incoming ray state.
    `time` is the path's departure time, which its bounce rays keep: only a
    scene with moving spheres reads it (None otherwise)."""
    static = scene.static
    kinds = static.mat_kinds
    slot, n_uniforms = _slot_layout(kinds, static.has_lights, static.mix_depth)

    def shade(arrays: scenelib.SceneArrays, o: Vec3, d: Vec3, T: Vec3, L: Vec3,
              alive, kb, time=None):
        zeros = Vec3.zeros(d.x.shape, T.x.dtype, T.x.device)
        hit = scenelib.intersect(scene, arrays, Ray(o, d, time), cfg.t_min, cfg.t_max, kb,
                                 routes, active=alive)

        # miss -> background, die (camera.rs:254)
        bg = arrays.background.color(d)
        missed = alive & (~hit.valid)
        L = L + Vec3.where(missed, T * bg, zeros)

        u = prng.ray_uniforms(prng.fold_all(kb, prng.SCATTER), n_uniforms, T.x.dtype)

        if matlib.MIXED in kinds:
            mat_id = matlib.resolve(arrays.materials, hit.mat_id,
                                    u[slot["mix"]:slot["mix"] + static.mix_depth],
                                    depth=static.mix_depth)
        else:
            mat_id = torch.clamp_min(hit.mat_id, 0)
        rows = matlib.gather(arrays.materials, mat_id)
        p = o + d * hit.t
        tex_color = texlib.evaluate(arrays.textures, rows.tex_id, hit.u, hit.v, p,
                                    static.tex_modes)

        active = alive & hit.valid
        emit = matlib.emitted(rows, tex_color)
        L = L + Vec3.where(active, T * emit, zeros)

        if static.has_absorb:
            # EXTENSION (off unless a Dielectric sets `absorption`): the
            # segment that just ended INSIDE a dielectric (back-face hit)
            # attenuates by Beer-Lambert exp(-sigma * t)
            sigma = matlib.gather_absorb(arrays.materials, mat_id)
            interior = active & (~hit.outside) & (rows.mtype == matlib.DIELECTRIC)
            T = Vec3.where(interior, T * (sigma * (-hit.t)).map(torch.exp), T)

        # -- specular (skip_pdf) path ------------------------------------
        skip = matlib.is_skip_pdf(rows)
        u_refl = u[slot["refl"]] if "refl" in slot else hit.t  # unused if absent
        spec_dir, absorbed = matlib.specular_dir(rows, d, hit.normal, hit.outside,
                                                 u_refl, kinds)

        # -- pdf path ------------------------------------------------------
        bsdf_dir = matlib.bsdf_sample(rows, d, hit.normal, u[slot["bsdf"]:], kinds)
        if static.has_lights:
            sampler = lightslib.sample_proper if cfg.proper_mis else lightslib.sample
            light_raw = sampler(arrays.lights, p, u[slot["pick"]], u[slot["l1"]],
                                u[slot["l2"]], static.light_kinds)
            light_dir = light_raw.unit()
            use_light = u[slot["branch"]] < cfg.light_sample_prob
            light_multi = matlib.phong_highlight(light_dir, d, hit.normal, rows)
        else:
            light_dir = bsdf_dir
            use_light = torch.zeros_like(alive)
            light_multi = torch.ones_like(hit.t)

        pdf_dir = Vec3.where(use_light, light_dir, bsdf_dir)
        val = matlib.bsdf_pdf_value(rows, d, hit.normal, pdf_dir, kinds,
                                    proper=cfg.proper_mis)

        if cfg.proper_mis and static.has_lights:
            # one-sample MIS: denominator = the true mixture density of the
            # combined sampler, with the real solid-angle light pdf
            p_light = lightslib.pdf_value(arrays.lights, p, pdf_dir, static.light_kinds)
            denom = (cfg.light_sample_prob * p_light
                     + (1.0 - cfg.light_sample_prob) * val)
        else:
            # compat: light branch denominator hardcoded to 1/pi
            denom = torch.where(use_light, torch.full_like(val, 1.0 / PI), val)
        denom = torch.where((denom <= 0.0) | torch.isnan(denom),
                            torch.full_like(denom, 1e-5), denom)
        weight = val / denom
        multi = torch.where(use_light, light_multi, torch.ones_like(light_multi))

        # shadow back-off start for the light branch (camera.rs:208-212)
        pdf_origin = Vec3.where(use_light, o + d * (hit.t - cfg.shadow_eps), p)

        new_d = Vec3.where(skip, spec_dir, pdf_dir)
        new_o = Vec3.where(skip, p, pdf_origin)
        t_mult = torch.where(skip, torch.ones_like(weight), weight * multi)
        T = Vec3.where(active, T * tex_color * t_mult, T)

        scatters = rows.mtype != matlib.DIFFUSE_LIGHT
        alive = active & scatters & ~(skip & absorbed)

        o = Vec3.where(alive, new_o, o)
        d = Vec3.where(alive, new_d, d)
        return o, d, T, L, alive

    return shade


def _requires_grad(tree) -> bool:
    """Whether a tensor in a nest of tuples, NamedTuples and Vec3s requires
    grad."""
    if isinstance(tree, torch.Tensor):
        return tree.requires_grad
    if isinstance(tree, Vec3):
        return any(_requires_grad(a) for a in tree)
    if isinstance(tree, tuple):
        return any(_requires_grad(a) for a in tree)
    return False


def radiance(scene: scenelib.Scene, arrays: scenelib.SceneArrays, cfg: RenderConfig,
             ray: Ray, keys) -> Vec3:
    """Per-ray radiance estimate after up to cfg.max_depth bounces.
    `keys` is the per-ray key batch ((N,) fast streams or (N, 2) threefry
    keys): every draw folds in the bounce index and a purpose tag, so the
    estimate for a given (pixel, sample) is independent of batch tiling."""
    return radiance_and_alive(scene, arrays, cfg, ray, keys)[0]


def radiance_and_alive(scene: scenelib.Scene, arrays: scenelib.SceneArrays,
                       cfg: RenderConfig, ray: Ray, keys):
    """`radiance` plus the per-bounce live-lane counts: the JAX package's
    scan over max_depth bounces as a Python loop, bounce b drawing from
    fold_all(keys, b). A path still alive after the budget contributes
    nothing more (camera.rs:161-163).

    With cfg.remat_bounces, grad mode on and a scene tensor or the rays
    requiring grad, each bounce runs under `torch.utils.checkpoint` (the
    JAX package's `jax.checkpoint` of the bounce): the backward pass keeps
    only the bounce carries and recomputes the bounce body. Every draw is
    counter-based, so the recompute draws the same numbers and no value
    changes.

    -> (L (N,) Vec3, live lanes after each bounce as a (max_depth,) int32
    tensor on the rays' device; nothing is read back to the host)."""
    shape = ray.direction.x.shape
    dtype, device = ray.direction.x.dtype, ray.direction.x.device
    shade = _make_shade(scene, cfg, kernel_routes(scene, arrays, cfg))
    o, d = ray.origin, ray.direction
    time = ray.time if scene.static.moving else None
    T, L = Vec3.ones(shape, dtype, device), Vec3.zeros(shape, dtype, device)
    alive = torch.ones(shape, dtype=torch.bool, device=device)
    counts = torch.zeros(max(cfg.max_depth, 0), dtype=torch.int32, device=device)
    remat = (cfg.remat_bounces and torch.is_grad_enabled()
             and _requires_grad((arrays, ray.origin, ray.direction)))
    for b in range(cfg.max_depth):
        kb = prng.fold_all(keys, b)
        if remat:
            o, d, T, L, alive = checkpoint(shade, arrays, o, d, T, L, alive, kb, time,
                                           use_reentrant=False, preserve_rng_state=False)
        else:
            o, d, T, L, alive = shade(arrays, o, d, T, L, alive, kb, time)
        counts[b] = alive.sum(dtype=torch.int32)
    return L, counts


def radiance_regen(scene: scenelib.Scene, arrays: scenelib.SceneArrays,
                   cfg: RenderConfig, camera, px, py, keys0, s0: int, n_samples: int):
    """Path-regeneration integrator over a pixel list: radiance SUMS over
    stratification cells [s0, s0 + n_samples) for each pixel lane.

    Each lane owns ONE pixel (px, py, with its stream keys0 =
    fast_streams(seed, pixel)) and, the moment its path dies, starts the
    pixel's next sample in place, so the loop's trip count is the worst
    lane's total path length over its samples. Lanes keep the caller's
    order: in 16x8 image-tile order, 128 consecutive lanes are one compact
    packet for the traversal kernels. Draws are keyed by (seed, pixel,
    sample, bounce), fold_all(fold_all(keys0, sid), b), as in the shuffled
    integrator, so both compute the same estimate up to summation order.

    The loop's condition is read on the host once per iteration, at its
    end. Under a running profiler each trip is an `integrator.iteration`
    span and its bounce body an `integrator.shade` span.

    Returns (L_sums (P,) Vec3, n_iterations)."""
    shape = px.shape
    dtype, device = cfg.dtype, px.device
    sqrt_spp = cfg.sqrt_spp
    if cfg.max_depth <= 0 or n_samples <= 0:  # depth 0 renders black (camera.rs:161-163)
        return Vec3.zeros(shape, dtype, device), 0
    shade = _make_shade(scene, cfg, kernel_routes(scene, arrays, cfg))
    s_end = s0 + n_samples

    def new_ray(sid):
        keys_s = prng.fold_all(keys0, sid)
        s_i = (sid % sqrt_spp).to(dtype)
        s_j = (sid // sqrt_spp).to(dtype)
        return generate_rays(camera, px, py, s_i, s_j, sqrt_spp, cfg.width, cfg.height,
                             keys_s)

    sid = torch.full(shape, s0, dtype=torch.int64, device=device)
    b = torch.zeros(shape, dtype=torch.int64, device=device)
    r0 = new_ray(sid)
    o, d = r0.origin, r0.direction
    time = r0.time if scene.static.moving else None
    ones = Vec3.ones(shape, dtype, device)
    T, L = ones, Vec3.zeros(shape, dtype, device)
    alive = torch.ones(shape, dtype=torch.bool, device=device)
    iterations = 0
    more = px.numel() > 0  # every lane starts below s_end
    while more:
        with span("integrator.iteration"):
            kb = prng.fold_all(prng.fold_all(keys0, sid), b)
            with span("integrator.shade"):
                o, d, T, L, alive2 = shade(arrays, o, d, T, L, alive, kb, time)
            # a path at its final bounce contributes nothing more
            # (camera.rs:161-163): it is done the moment it is shaded
            alive2 = alive2 & (b + 1 < cfg.max_depth)
            done = alive & (~alive2)
            sid = sid + done.to(torch.int64)
            regen = done & (sid < s_end)
            rn = new_ray(sid)
            o = Vec3.where(regen, rn.origin, o)
            d = Vec3.where(regen, rn.direction, d)
            if time is not None:
                time = torch.where(regen, rn.time, time)
            T = Vec3.where(regen, ones, T)
            b = torch.where(done, torch.zeros_like(b), b + 1)
            alive = alive2 | regen
            iterations += 1
            more = bool((sid < s_end).any())
    return L, iterations


def replays_trips(scene: scenelib.Scene, arrays: scenelib.SceneArrays, camera,
                  routes: scenelib.Routes) -> bool:
    """Whether `radiance_regen_shuffle` runs its trips from CUDA graphs
    (`graphs.TripGraphs`), as read from the call alone: where the scene
    lies on a CUDA device, no tensor the call reads wants a gradient (the
    autograd Functions would take the places of K1 and K7, the graphs'
    holes), and a trip launches no kernel by hand but K1 and K7: no BVH
    traversal (`scene.walks_bvh`) and no Mandelbulb march. Elsewhere the
    loop runs eagerly, as it does on the CPU."""
    return (scene.device.type == "cuda"
            and not (torch.is_grad_enabled() and _requires_grad((arrays, camera)))
            and not scenelib.walks_bvh(scene, arrays, routes)
            and not scene.mandelbulbs)


# lanes per image tile on the kernel routes, and the tile shapes tried in order
PKT = 128
TILES = ((16, 8), (8, 16), (32, 4), (4, 32), (64, 2), (128, 1))


def chunk_width(spp: int, cap: int) -> int:
    """The largest divisor of spp that is <= cap."""
    return max(c for c in range(1, min(spp, cap) + 1) if spp % c == 0)


def radiance_regen_shuffle(scene: scenelib.Scene, arrays: scenelib.SceneArrays,
                           cfg: RenderConfig, camera, seed: int, spp: int, s0: int = 0):
    """Full-frame path regeneration with cross-pixel cell SHUFFLING:
    row-major radiance sums over stratification cells [s0, s0 + spp).

    Lane i's k-th cell of a chunk is pixel (i + k*S) mod N for a
    golden-ratio stride S, so a lane's total path length is a sum over C
    cells of different pixels, which concentrates and keeps the loop's trip
    count near C x the mean path length. Per-cell radiance lands in an
    (N, C) column table by an indexed add; the pixel sums come back with C
    rolls, added in the same order as the JAX package adds them. Draws are
    keyed by (seed, pixel, sample, bounce), so the estimate equals the JAX
    package's.

    When a BVH kernel route is on, lanes decode to 128-pixel image tiles
    and the shuffle rotates whole tiles, so neighbouring lanes trace
    neighbouring pixels (coherent walks) for every k; the per-pixel sums
    are the same either way.

    Where `replays_trips` holds (on the card, no gradient wanted, no BVH
    traversal), the call's first trip is captured as CUDA graphs with K1
    and K7 launched eagerly between them, and every later trip replays them
    (`graphs.TripGraphs`): the same kernels on the same values, so the same
    bits, from a few dozen host calls a trip instead of about a thousand.
    The graphs and their memory pool are released when the call returns.

    The loop's condition is read on the host once per iteration, at its
    end. Under a running profiler each trip is an `integrator.iteration`
    span and its bounce body an `integrator.shade` span; a trip run from the
    graphs holds an `integrator.graphed` span, and each stretch of the
    capture an `integrator.capture` span.

    Returns (L_sums row-major (N,) Vec3, n_iterations)."""
    n_pix = cfg.width * cfg.height
    dtype = cfg.dtype
    device = scene.device
    sqrt_spp = cfg.sqrt_spp
    if cfg.max_depth <= 0 or spp <= 0:
        return Vec3.zeros((n_pix,), dtype, device), 0
    routes = kernel_routes(scene, arrays, cfg)
    shade = _make_shade(scene, cfg, routes)

    C = chunk_width(spp, cfg.chunk_cap)
    n_chunks = spp // C
    tile = None
    if (routes.mesh_kernel or routes.box_bvh or routes.sphere_bvh) and n_pix % PKT == 0:
        # rotate by whole 128-lane packets (image tiles when a shape fits)
        tile = next(((tw, th) for tw, th in TILES
                     if cfg.width % tw == 0 and cfg.height % th == 0), None)
        n_pkt = n_pix // PKT
        S = ((int(n_pkt * 0.6180339887) | 1) % n_pkt) * PKT
    else:
        # golden-ratio stride: a lane's consecutive cells land on far-apart
        # pixels, decorrelating their path lengths
        S = (int(n_pix * 0.6180339887) | 1) % n_pix
    lanes = torch.arange(n_pix, dtype=torch.int64, device=device)

    def slot_pixel(m):
        """Lane slot -> pixel id (the identity unless tiled)."""
        if tile is None:
            return m
        tw, th = tile
        tid, within = m // PKT, m % PKT
        px = (tid % (cfg.width // tw)) * tw + within % tw
        py = (tid // (cfg.width // tw)) * th + within // tw
        return py * cfg.width + px

    def lane_pixel(k):
        """Rotated lane slot -> (pixel id, px, py)."""
        p = slot_pixel((lanes + k * S) % n_pix)
        return p, (p % cfg.width).to(dtype), (p // cfg.width).to(dtype)

    def lane_keys(k, cs0):
        p, px, py = lane_pixel(k)
        return prng.fold_all(prng.fast_streams(seed, p), cs0 + k), px, py

    def new_ray(k, cs0):
        keys_s, px, py = lane_keys(k, cs0)
        sid = cs0 + k
        s_i = (sid % sqrt_spp).to(dtype)
        s_j = (sid // sqrt_spp).to(dtype)
        return generate_rays(camera, px, py, s_i, s_j, sqrt_spp, cfg.width,
                             cfg.height, keys_s)

    def trip_keys(k, b, cs0):
        keys_s, _, _ = lane_keys(k, cs0)
        return prng.fold_all(keys_s, b)

    def regenerate(table, o, d, T, time, L_add, alive, alive2, k, b, cs0):
        """The trip's bookkeeping after the shade -> the next trip's
        (o, d, T, time, alive, k, b) and whether a lane has cells left."""
        # cell (lane, k) of the (N, C) table; a finished lane (k == C)
        # adds zero radiance, so its column is clamped
        cell = lanes * C + torch.clamp_max(k, C - 1)
        table.index_add_(1, cell, torch.stack([L_add.x, L_add.y, L_add.z]))
        # a path at its final bounce contributes nothing more
        # (camera.rs:161-163): it is done the moment it is shaded
        alive2 = alive2 & (b + 1 < cfg.max_depth)
        done = alive & (~alive2)
        k = k + done.to(torch.int64)
        regen = done & (k < C)
        rn = new_ray(k, cs0)
        o = Vec3.where(regen, rn.origin, o)
        d = Vec3.where(regen, rn.direction, d)
        if time is not None:
            time = torch.where(regen, rn.time, time)
        T = Vec3.where(regen, Vec3.ones((n_pix,), dtype, device), T)
        b = torch.where(alive2, b + 1, torch.zeros_like(b))
        return o, d, T, time, alive2 | regen, k, b, (k < C).any()

    def chunk_sums(table):
        """Regroup: column c's row i is lane slot (i + c*S) mod N -> roll
        forward to slot order (pixel order unless tiled), a column at a
        time."""
        table = table.view(3, n_pix, C)
        for c in range(C):
            shift = (c * S) % n_pix
            yield Vec3(*(torch.roll(table[a, :, c], shift) for a in range(3)))

    def chunks_eager():
        L_pix = Vec3.zeros((n_pix,), dtype, device)
        iterations = 0
        for chunk in range(n_chunks):
            cs0 = s0 + chunk * C
            k = torch.zeros(n_pix, dtype=torch.int64, device=device)
            b = torch.zeros(n_pix, dtype=torch.int64, device=device)
            r0 = new_ray(k, cs0)
            o, d = r0.origin, r0.direction
            time = r0.time if scene.static.moving else None
            T = Vec3.ones((n_pix,), dtype, device)
            table = torch.zeros((3, n_pix * C), dtype=dtype, device=device)
            alive = torch.ones(n_pix, dtype=torch.bool, device=device)
            zeros = Vec3.zeros((n_pix,), dtype, device)

            more = n_pix > 0  # every lane starts at k = 0 < C
            while more:
                with span("integrator.iteration"):
                    kb = trip_keys(k, b, cs0)
                    with span("integrator.shade"):
                        o, d, T, L_add, alive2 = shade(arrays, o, d, T, zeros, alive, kb, time)
                    o, d, T, time, alive, k, b, left = regenerate(
                        table, o, d, T, time, L_add, alive, alive2, k, b, cs0)
                    iterations += 1
                    more = bool(left)
            for add in chunk_sums(table):
                L_pix = L_pix + add
        return L_pix, iterations

    def chunks_graphed(graphs):
        """chunks_eager's loop with every trip's body run from `graphs`:
        the call's first trip captures it, every later trip replays it.
        The loop's state lives in buffers that the last piece writes in
        place; the chunk's first cell is a device value, so that the graphs
        serve every chunk."""
        L_pix = Vec3.zeros((n_pix,), dtype, device)
        iterations = 0
        empty = lambda dt=dtype: torch.empty(n_pix, dtype=dt, device=device)  # noqa: E731
        cs0 = torch.empty(1, dtype=torch.int64, device=device)
        k, b = empty(torch.int64), empty(torch.int64)
        o, d, T = (Vec3(empty(), empty(), empty()) for _ in range(3))
        time = empty() if scene.static.moving else None
        alive = empty(torch.bool)
        table = torch.empty((3, n_pix * C), dtype=dtype, device=device)
        zeros = Vec3.zeros((n_pix,), dtype, device)
        state = (*o, *d, *T, alive, k, b) + ((time,) if time is not None else ())

        def regenerate_in_place(o2, d2, T2, L_add, alive2):
            o3, d3, T3, time3, alive3, k3, b3, left = regenerate(
                table, o2, d2, T2, time, L_add, alive, alive2, k, b, cs0)
            for buf, value in zip(state, (*o3, *d3, *T3, alive3, k3, b3, time3)):
                buf.copy_(value)
            return left

        for chunk in range(n_chunks):
            cs0.fill_(s0 + chunk * C)
            k.zero_()
            b.zero_()
            r0 = new_ray(k, cs0)
            for buf, value in zip((*o, *d, time), (*r0.origin, *r0.direction, r0.time)):
                if buf is not None:
                    buf.copy_(value)
            for t in T:
                t.fill_(1.0)
            table.zero_()
            alive.fill_(True)
            del r0

            more = n_pix > 0  # every lane starts at k = 0 < C
            while more:
                with span("integrator.iteration"), span("integrator.graphed"):
                    kb = graphs.piece(trip_keys, k, b, cs0)
                    with span("integrator.shade"):
                        o2, d2, T2, L_add, alive2 = graphs.piece(
                            shade, arrays, o, d, T, zeros, alive, kb, time)
                    left = graphs.piece(regenerate_in_place, o2, d2, T2, L_add, alive2)
                    graphs.end_trip()
                    iterations += 1
                    more = bool(left)
            for add in chunk_sums(table):
                L_pix = L_pix + add
        return L_pix, iterations

    if replays_trips(scene, arrays, camera, routes):
        with torch.cuda.device(device):
            graphs = trip_graphs.TripGraphs(device)
            L_pix, iterations = chunks_graphed(graphs)
            graphs.release()
    else:
        L_pix, iterations = chunks_eager()
    if tile is not None:
        owner = torch.empty_like(lanes)
        owner[slot_pixel(lanes)] = lanes  # the slot holding pixel p
        L_pix = L_pix[owner]
    return L_pix, iterations
