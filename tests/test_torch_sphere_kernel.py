"""The port's ray x sphere min-t (ops/sphere_min_t.py) against the JAX
package's TPU kernel, run in interpret mode, and its dense reference.

Tolerances. Against the JAX dense reference (`spheres.pair_t` + argmin),
which computes the same float32 operations in the same order: t within
rtol 1e-6 on at least 97% of rays and within rtol 1e-3 on all, idx equal on
all but 1% (a near-tie an ulp can flip); exact ties always go to the first
index. The share is there because torch's CPU results are not always the
IEEE float32 ones: its vectorised sqrt can be an ulp off, and under the
parallel test runner a block of rays was once computed a few ulps off in
every operation. t = -half_b - sqrt(delta) cancels, which turns a few ulps
into up to 7e-4 relative (measured). The torch side runs on one thread. Against the Pallas kernel in
interpret mode rtol 5e-4 with a share of winners allowed to differ, as
tests/test_pallas.py allows (the interpreter's fused arithmetic may round
differently at grazing hits).

The kernel itself runs only on a CUDA card: tests/test_torch_cuda.py
compares it with the plain version there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raysnail_tpu.camera import Ray as JRay
from raysnail_tpu.geometry import spheres as jsph
from raysnail_tpu.ops import sphere_pallas as sp
from raysnail_tpu.prelude.vec import Vec3 as JVec3
from raysnail_tpu_torch.camera import Ray as TRay
from raysnail_tpu_torch.geometry import spheres as tsph
from raysnail_tpu_torch.ops import sphere_min_t as smt
from raysnail_tpu_torch.prelude.vec import Vec3 as TVec3

TMIN, TMAX = 1e-3, 1e30


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_close_t(t, ref, share=0.97):
    """t within rtol 1e-6 on `share` of the rays and within rtol 1e-3 on all."""
    rel = np.abs(t - ref) / np.maximum(np.abs(ref), 1e-30)
    assert (rel <= 1e-6).mean() >= share, (rel <= 1e-6).mean()
    assert rel.max() <= 1e-3, rel.max()


def make_case(seed, n_rays, n_spheres, duplicate=False):
    """Numpy rays and spheres: rays in a 30^3 box, unit directions, spheres
    in a 20^3 box; every 5th sphere inactive. duplicate=True repeats every
    sphere right after itself, so that t ties exactly."""
    rng = np.random.default_rng(seed)
    m = n_spheres // 2 if duplicate else n_spheres
    c = rng.uniform(-10, 10, (m, 3)).astype(np.float32)
    r = rng.uniform(0.3, 1.5, m).astype(np.float32)
    act = np.ones(m, bool)
    act[::5] = False
    if duplicate:
        c, r, act = (np.repeat(a, 2, axis=0) for a in (c, r, act))
    o = rng.uniform(-15, 15, (n_rays, 3)).astype(np.float32)
    d = rng.standard_normal((n_rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d, c, r, act


def torch_args(o, d, c, r, act):
    cols = lambda a: tuple(torch.from_numpy(np.ascontiguousarray(a[:, i])) for i in range(3))
    rt = torch.from_numpy(r)
    return cols(o), cols(d), cols(c), rt * rt, torch.from_numpy(act)


def jax_dense(o, d, c, r, act):
    """JAX's dense sweep: spheres.pair_t, min and argmin."""
    g = jsph.SphereGroup(center=JVec3.from_array(jnp.asarray(c)), radius=jnp.asarray(r),
                         speed=JVec3.zeros((len(r),)),
                         mat_id=jnp.arange(len(r), dtype=jnp.int32),
                         active=jnp.asarray(act))
    col = lambda a: JVec3(*(jnp.asarray(a[:, i])[:, None] for i in range(3)))
    t = jsph.pair_t(g, col(o), col(d), 0.0, jnp.float32(TMIN), jnp.float32(TMAX), False)
    return np.asarray(jnp.min(t, axis=1)), np.asarray(jnp.argmin(t, axis=1))


def jax_pallas(o, d, c, r, act):
    """JAX's Pallas kernel in interpret mode, padded as spheres.intersect pads."""
    n, s = len(o), len(r)
    pad_n, pad_s = (-n) % sp.TILE_R, (-s) % sp.LANES
    pn = lambda a: jnp.pad(jnp.asarray(a), (0, pad_n))
    ps = lambda a, v=0.0: jnp.pad(jnp.asarray(a), (0, pad_s), constant_values=v)
    t, idx = sp.sphere_min_t(
        tuple(pn(o[:, i]) for i in range(3)), tuple(pn(d[:, i]) for i in range(3)),
        tuple(ps(c[:, i]) for i in range(3)), ps(r * r), ps(act, False),
        jnp.float32(TMIN), jnp.float32(TMAX), interpret=True)
    return np.asarray(t)[:n], np.asarray(idx)[:n]


SHAPES = [
    pytest.param(700, 130, False, id="700x130"),             # tests/test_pallas.py
    pytest.param(sp.TILE_R + 3, 69, False, id="tile+3x69"),  # its padding edges
    pytest.param(4096, 4, False, id="example-S4"),
    pytest.param(1500, 64, True, id="ties"),
]


@pytest.mark.parametrize("n,s,dup", SHAPES)
def test_plain_matches_jax_dense(n, s, dup):
    case = make_case(n + s, n, s, dup)
    t, idx = smt.sphere_min_t_plain(*torch_args(*case), TMIN, TMAX)
    jt, jidx = jax_dense(*case)
    assert t.dtype == torch.float32 and idx.dtype == torch.int32
    assert_close_t(t.numpy(), jt)
    assert (idx.numpy() != jidx).mean() <= 0.01
    assert (t.numpy() < 1e30).sum() >= 20  # the cases do hit spheres


@pytest.mark.parametrize("n,s,dup", SHAPES)
def test_plain_matches_jax_pallas_interpret(n, s, dup):
    case = make_case(n + s, n, s, dup)
    t, idx = smt.sphere_min_t_plain(*torch_args(*case), TMIN, TMAX)
    pt, pidx = jax_pallas(*case)
    hit = pt < 1e30
    assert ((t.numpy() < 1e30) == hit).mean() > 0.995
    both = hit & (t.numpy() < 1e30)
    np.testing.assert_allclose(t.numpy()[both], pt[both], rtol=5e-4)
    assert (idx.numpy()[both] == pidx[both]).mean() > 0.99


def test_ties_go_to_the_first_index():
    case = make_case(3, 4000, 100, duplicate=True)
    t, idx = smt.sphere_min_t(*torch_args(*case), TMIN, TMAX)
    hit = t.numpy() < 1e30
    assert hit.sum() > 50
    assert (idx.numpy()[hit] % 2 == 0).all()  # never the second copy


def test_wrapper_checks_inputs_and_counts_only_kernel_launches():
    o, d, c, r2, act = torch_args(*make_case(0, 64, 8))
    before = smt.sphere_min_t.launches
    smt.sphere_min_t(o, d, c, r2, act, TMIN, TMAX)
    assert smt.sphere_min_t.launches == before  # CPU tensors run the plain version
    strided = torch.zeros(128)[::2]
    with pytest.raises(ValueError, match="contiguous"):
        smt.sphere_min_t((strided, o[1], o[2]), d, c, r2, act, TMIN, TMAX)
    with pytest.raises(ValueError):
        smt.sphere_min_t(o, d, c, r2.double(), act, TMIN, TMAX)
    with pytest.raises(ValueError):
        smt.sphere_min_t(o, d, c, r2, act.float(), TMIN, TMAX)


def test_no_spheres():
    o, d, _, _, _ = torch_args(*make_case(0, 16, 4))
    empty = torch.zeros(0)
    t, idx = smt.sphere_min_t(o, d, (empty, empty, empty), empty,
                              torch.zeros(0, dtype=torch.bool), TMIN, TMAX)
    assert (t.numpy() == np.float32(1e30)).all() and (idx.numpy() == 0).all()


def test_spheres_intersect_hit_fields():
    """spheres.intersect of the port against the JAX package's."""
    o, d, c, r, _ = make_case(9, 2000, 40)
    mats = np.arange(40, dtype=np.int32)[::-1].copy()
    jg = jsph.SphereGroup(center=JVec3.from_array(jnp.asarray(c)), radius=jnp.asarray(r),
                          speed=JVec3.zeros((40,)), mat_id=jnp.asarray(mats),
                          active=jnp.ones(40, bool))
    jray = JRay(JVec3.from_array(jnp.asarray(o)), JVec3.from_array(jnp.asarray(d)),
                jnp.zeros(len(o), jnp.float32))
    jh = jsph.intersect(jg, jray, jnp.float32(TMIN), jnp.float32(TMAX))
    cols = lambda a: TVec3(*(torch.from_numpy(np.ascontiguousarray(a[:, i])) for i in range(3)))
    tg = tsph.SphereGroup(center=cols(c), radius=torch.from_numpy(r),
                          mat_id=torch.from_numpy(mats), active=torch.ones(40, dtype=torch.bool))
    th = tsph.intersect(tg, TRay(cols(o), cols(d), None), TMIN, TMAX)
    np.testing.assert_array_equal(th.valid.numpy(), np.asarray(jh.valid))
    assert_close_t(th.t.numpy(), np.asarray(jh.t))
    np.testing.assert_array_equal(th.mat_id.numpy(), np.asarray(jh.mat_id))
    np.testing.assert_array_equal(th.outside.numpy(), np.asarray(jh.outside))
    for a, b in zip((th.normal.x, th.normal.y, th.normal.z),
                    (jh.normal.x, jh.normal.y, jh.normal.z)):
        err = np.abs(a.numpy() - np.asarray(b))
        assert (err <= 1e-6).mean() >= 0.97 and err.max() <= 1e-3, err.max()
    # sphere uv (read by image textures): atan2/asin may differ by an ulp
    np.testing.assert_allclose(th.u.numpy(), np.asarray(jh.u), atol=1e-5)
    np.testing.assert_allclose(th.v.numpy(), np.asarray(jh.v), atol=1e-5)



def test_other_devices_do_not_fall_back_to_the_plain_version():
    """Only CPU tensors take the plain version: any other device launches the
    kernel (CUDA) or raises."""
    meta = tuple(tuple(a.to("meta") for a in x) if isinstance(x, tuple) else x.to("meta")
                 for x in torch_args(*make_case(0, 64, 8)))
    with pytest.raises(ValueError, match="unsupported device"):
        smt.sphere_min_t(*meta, TMIN, TMAX)
