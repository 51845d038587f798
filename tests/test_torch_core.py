"""tpurt_torch core against tpurt and the scalar oracle: the u32 RNG is
exact (states and u32-derived floats), transcendental outputs are within
4 ulp (torch's and XLA's CPU log/cos/rsqrt round differently), camera
rays within 2 ulp at unit scale, the tonemap exact on the same input."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import oracle
from tpurt.core import camera as tcam
from tpurt.core import rng as trng
from tpurt.render.tonemap import tonemap as t_tonemap
from tpurt_torch.core import camera, rng
from tpurt_torch.render.tonemap import tonemap

_SEEDS = np.concatenate([
    np.array([0, 1, 7, 42, 0xDEADBEEF, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF],
             np.uint32),
    np.random.default_rng(0).integers(0, 2 ** 32, 2040, dtype=np.uint64)
    .astype(np.uint32),
])


def ulps(a, b):
    """Per-element distance in units of f32 spacing."""
    def key(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)

    return np.abs(key(a) - key(b))


def u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().astype(np.uint32)


def port_state(seeds=_SEEDS):
    return torch.from_numpy(seeds.astype(np.int64))


@pytest.mark.parametrize("frame,ray", [(0, 0), (1, 99), (123456, 7)])
def test_make_seed_exact(frame, ray):
    got = u32(rng.make_seed(port_state(), frame, ray))
    want = np.asarray(trng.make_seed(jnp.asarray(_SEEDS), frame, ray))
    np.testing.assert_array_equal(got, want)
    ref = [oracle.make_seed(int(p), frame, ray) for p in _SEEDS[:64]]
    np.testing.assert_array_equal(got[:64], np.array(ref, np.uint32))


@pytest.mark.parametrize("name", ["random_value", "rand01"])
def test_u32_streams_exact(name):
    mine, theirs = port_state(), jnp.asarray(_SEEDS)
    py = [int(s) for s in _SEEDS[:16]]
    for _ in range(50):
        mine, a = getattr(rng, name)(mine)
        theirs, b = getattr(trng, name)(theirs)
        np.testing.assert_array_equal(u32(mine), np.asarray(theirs))
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        out = [getattr(oracle, name)(s) for s in py]
        py = [o[0] for o in out]
        np.testing.assert_array_equal(a.numpy()[:16],
                                      np.array([o[1] for o in out], np.float32))


def test_random_normal_within_4ulp():
    mine, theirs = port_state(), jnp.asarray(_SEEDS)
    for _ in range(10):
        mine, a = rng.random_normal(mine)
        theirs, b = trng.random_normal(theirs)
        np.testing.assert_array_equal(u32(mine), np.asarray(theirs))
        assert ulps(a.numpy(), np.asarray(b)).max() <= 4
    py = [int(s) for s in _SEEDS[:32]]
    mine = port_state(_SEEDS[:32])
    for _ in range(5):
        mine, a = rng.random_normal(mine)
        out = [oracle.random_normal(s) for s in py]
        py = [o[0] for o in out]
        assert ulps(a.numpy(), np.array([o[1] for o in out], np.float32)).max() <= 4


def test_random_direction_within_4ulp():
    mine, theirs = port_state(), jnp.asarray(_SEEDS)
    for _ in range(5):
        mine, a = rng.random_direction(mine)
        theirs, b = trng.random_direction(theirs)
        np.testing.assert_array_equal(u32(mine), np.asarray(theirs))
        assert ulps(a.numpy(), np.asarray(b)).max() <= 4
        assert np.allclose(np.linalg.norm(a.numpy(), axis=-1), 1.0, atol=1e-6)
    py = [int(s) for s in _SEEDS[:64]]
    mine = port_state(_SEEDS[:64])
    for _ in range(3):
        mine, a = rng.random_direction(mine)
        out = [oracle.random_direction(s) for s in py]
        py = [o[0] for o in out]
        np.testing.assert_array_equal(u32(mine), np.array(py, np.uint32))
        assert ulps(a.numpy(), np.stack([o[1] for o in out])).max() <= 4


def test_masked_draws_freeze_other_lanes():
    state = port_state()
    mask = torch.from_numpy(np.arange(len(_SEEDS)) % 3 == 0)
    for fn in (rng.random_value_masked, rng.rand01_masked):
        new, _ = fn(state, mask)
        np.testing.assert_array_equal(u32(new)[~mask.numpy()],
                                      _SEEDS[~mask.numpy()])
        assert (u32(new)[mask.numpy()] != _SEEDS[mask.numpy()]).all()


@pytest.mark.parametrize("pose", [
    dict(position=(0.0, 150.0, 250.0), yaw=3.14, aspect_ratio=16 / 9),
    dict(position=(10.0, -5.0, 3.0), pitch=0.1, yaw=2.0, roll=-0.2,
         fov_degrees=70.0, aspect_ratio=1.5),
])
def test_make_camera_rays_within_2ulp(pose):
    w, h = 48, 27
    xs, ys = np.meshgrid(np.arange(w), np.arange(h))
    xs, ys = xs.ravel().astype(np.int32), ys.ravel().astype(np.int32)
    ro, rd, seeds = camera.make_camera_rays(
        camera.Camera.create(**pose, device="cpu"), torch.from_numpy(xs),
        torch.from_numpy(ys), w, h, frame_index=3)
    tro, trd, tseeds = tcam.make_camera_rays(
        tcam.Camera.create(**pose), jnp.asarray(xs), jnp.asarray(ys), w, h,
        frame_index=3)
    np.testing.assert_array_equal(ro.numpy(), np.asarray(tro))
    # Directions are unit vectors: 2 ulp at their length's scale (2^-23).
    # A component near zero has no meaningful ulp of its own.
    assert np.abs(rd.numpy() - np.asarray(trd)).max() <= 2 * 2.0 ** -23
    np.testing.assert_array_equal(u32(seeds), np.asarray(tseeds))
    uv = camera.pixel_uv(torch.from_numpy(xs), torch.from_numpy(ys), w, h)
    np.testing.assert_array_equal(
        uv.numpy(), np.asarray(tcam.pixel_uv(jnp.asarray(xs), jnp.asarray(ys), w, h)))


def test_tonemap_exact():
    r = np.random.default_rng(1)
    rad = np.concatenate([
        r.uniform(-0.5, 1.5, (100000, 3)), r.uniform(0, 1e-3, (1000, 3)),
        np.array([[0.0, 1.0, np.inf]]),
    ]).astype(np.float32)
    got = tonemap(torch.from_numpy(rad)).numpy()
    np.testing.assert_array_equal(got, np.asarray(t_tonemap(jnp.asarray(rad))))
    assert got.dtype == np.uint8
