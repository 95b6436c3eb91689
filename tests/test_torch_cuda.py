"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked `cuda` and skips where no CUDA card is present.
The file imports torch, numpy and the port only, so it runs on a machine
without JAX; tests/conftest.py imports JAX, so run it there with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Tolerance: none. The sphere kernel is built with -fmad=false, so it rounds
every product and sum as the plain version's separate elementwise kernels
do: t bit-equal, idx equal.
"""

import numpy as np
import pytest
import torch

from raysnail_tpu_torch.ops import sphere_min_t as smt

TMIN, TMAX = 1e-3, 1e30


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernel has no CPU mode")
    return torch.device("cuda")


def sphere_case(seed, n_rays, n_spheres, device, duplicate=False):
    """Rays in a 30^3 box with unit directions, spheres in a 20^3 box, every
    5th sphere inactive; duplicate=True lists each sphere twice in a row, so
    that t ties exactly."""
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

    def cols(a):
        return tuple(torch.from_numpy(np.ascontiguousarray(a[:, i])).to(device)
                     for i in range(3))

    r2 = torch.from_numpy(r * r).to(device)
    return cols(o), cols(d), cols(c), r2, torch.from_numpy(act).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("n,s,dup", [(400_000, 4, False), (100_003, 478, False),
                                     (65_537, 256, True)],
                         ids=["example-S4", "book1-S478-ragged", "ties"])
def test_sphere_kernel_matches_plain(cuda_device, n, s, dup):
    args = sphere_case(1, n, s, cuda_device, dup)
    before = smt.sphere_min_t.launches
    t, idx = smt.sphere_min_t(*args, TMIN, TMAX)
    assert smt.sphere_min_t.launches == before + 1
    pt, pidx = smt.sphere_min_t_plain(*args, TMIN, TMAX)
    torch.cuda.synchronize()
    assert torch.equal(t, pt) and torch.equal(idx, pidx)
    hit = t < 1e30
    assert int(hit.sum()) > 0
    if dup:
        assert not bool((idx[hit] % 2 == 1).any())  # ties go to the first copy


@pytest.mark.cuda
def test_sphere_kernel_checks_its_inputs(cuda_device):
    o, d, c, r2, act = sphere_case(2, 1000, 8, cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        smt.sphere_min_t((o[0][::2], o[1][::2], o[2][::2]), d, c, r2, act, TMIN, TMAX)
    with pytest.raises(ValueError):
        smt.sphere_min_t(o, d, c, r2.cpu(), act, TMIN, TMAX)  # mixed devices
    with pytest.raises(ValueError):
        smt.sphere_min_t(o, d, c, r2, act.float(), TMIN, TMAX)
