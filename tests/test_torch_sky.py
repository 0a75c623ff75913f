"""K3 (the sky textures) and the nearest samplers: the port's plain torch
versions held to the JAX package's.

Tolerance for the textures, against the JAX function run op by op
(jax.disable_jit): rtol=1e-4, atol=1e-5 on at least 99.9% of the values,
and rtol=1e-3 on all. exp and pow of XLA and of torch differ in the last
ulps, and the planet and optical-depth terms subtract nearly equal numbers
near the horizon, which scales an ulp up: one texel in 18,432 of a 32^2
cubemap lands at 1.2e-4 relative, two in 4,096 cloud values at 2e-4. The
jitted JAX textures move further from the op-by-op ones (up to 3e-4
relative on 8% of horizon-band texels): XLA's CPU code contracts
multiply-adds there. The frame tests therefore hand the JAX package's own
textures to the port (convert.py).

The samplers pick a texel by nearest lookup with truncating casts, so on
the same (random) texture they are exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vvr_tpu.ops import sky as jsky
from vvr_tpu_torch import convert
from vvr_tpu_torch.ops import sky

# one intra-op thread: the suite runs six pytest workers on eight cores
torch.set_num_threads(1)

SUNS = {
    "day": (-0.28, 0.65, -0.71),
    "low": (0.6, 0.05, 0.8),
    "night": (0.0, -0.2, 0.98),
}


def _sun(name):
    s = np.asarray(SUNS[name], np.float32)
    return (s / np.linalg.norm(s)).astype(np.float32)


def _assert_sky_close(out, ref):
    ok = np.isclose(out, ref, rtol=1e-4, atol=1e-5)
    assert ok.mean() >= 0.999, f"{(~ok).sum()} of {ok.size} values off"
    np.testing.assert_allclose(out, ref, rtol=1e-3, atol=1e-5)


def _dirs(n, seed):
    d = np.random.default_rng(seed).normal(size=(n, 3))
    return (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("sun", list(SUNS))
def test_write_skybox_equals_jax(sun):
    s = _sun(sun)
    with jax.disable_jit():
        ref = np.asarray(jsky.write_skybox(jnp.asarray(s), 0.0,
                                           resolution=32))
    out = sky.write_skybox(s, 0.0, 32, "cpu").numpy()
    assert out.shape == (6, 32, 32, 3)
    _assert_sky_close(out, ref)


@pytest.mark.parametrize("sun,time", [("day", 0.0), ("day", 1.75),
                                      ("low", 0.25)])
def test_write_clouds_equals_jax(sun, time):
    s = _sun(sun)
    with jax.disable_jit():
        ref = np.asarray(jsky.write_clouds(jnp.asarray(s),
                                           jnp.float32(time), resolution=32))
    out = sky.write_clouds(s, time, 32, "cpu").numpy()
    assert out.shape == (32, 32, 4)
    _assert_sky_close(out, ref)


def test_sky_and_sun_colour_equal_jax():
    s = _sun("day")
    d = _dirs(2000, 1)
    ref = np.asarray(jsky.sky(jnp.broadcast_to(jnp.asarray(s), d.shape),
                              jnp.asarray(d)))
    out = sky.sky(torch.from_numpy(s).expand(2000, 3), torch.from_numpy(d))
    _assert_sky_close(out.numpy(), ref)
    np.testing.assert_allclose(sky.sun_colour(torch.from_numpy(s)).numpy(),
                               np.asarray(jsky.sun_colour(jnp.asarray(s))),
                               rtol=1e-6)


def test_samplers_equal_jax():
    """Nearest lookups on the same textures: exact."""
    rng = np.random.default_rng(7)
    jbox = rng.uniform(0, 1, (6, 32, 32, 3)).astype(np.float32)
    jcl = rng.uniform(0, 1, (64, 64, 4)).astype(np.float32)
    box, cl = convert.sky_from_numpy(jbox, jcl, "cpu")
    d = _dirs(3000, 2)
    d[:100] = np.array([0.0, 1.0, 0.0], np.float32)   # straight up
    d[100:200, 1] = 0.0                               # grazing the plane
    pos = rng.uniform(-500, 500, (3000, 3)).astype(np.float32)
    # the JAX samplers run jitted, as the JAX frame runs them
    ref_c = np.asarray(jax.jit(jsky.sample_clouds)(
        jnp.asarray(jcl), jnp.asarray(d), jnp.asarray(pos)))
    td, tp = torch.from_numpy(d), torch.from_numpy(pos)
    out_c = sky.sample_clouds(cl, *td.unbind(1), *tp.unbind(1))
    np.testing.assert_array_equal(out_c.numpy(), ref_c)
    assert (ref_c[:, 3] > 0).any()
    ref_s = np.asarray(jax.jit(jsky.sample_skybox)(jnp.asarray(jbox),
                                                   jnp.asarray(d)))
    np.testing.assert_array_equal(sky.sample_skybox(box, *td.unbind(1))
                                  .numpy(), ref_s)


@pytest.mark.parametrize("sun,time", [("day", 0.25), ("low", 1.75)])
def test_write_sky_equals_the_plain_textures(sun, time):
    """write_sky on the CPU is write_skybox_plain and write_clouds_plain at
    the same (sun, time), bit for bit, at odd sizes."""
    s = _sun(sun)
    skybox, clouds = sky.write_sky(s, time, 7, 13, "cpu")
    st = torch.from_numpy(s)
    assert torch.equal(skybox, sky.write_skybox_plain(st, 7))
    assert torch.equal(clouds, sky.write_clouds_plain(st, time, 13))
    assert skybox.shape == (6, 7, 7, 3) and clouds.shape == (13, 13, 4)


def test_renderer_builds_the_sky_through_write_sky(tmp_path, monkeypatch):
    """The Renderer's sky cache calls write_sky once per 0.25 s bucket (64^3
    world, 32x24 frames) and never the one-texture entry points."""
    from vvr_tpu_torch.config import RenderConfig, WorldConfig
    from vvr_tpu_torch.render import renderer as rmod
    from vvr_tpu_torch.utils.camera import Camera
    calls = []
    real = sky.write_sky

    def counted(*args, **kwargs):
        calls.append(args[1])
        return real(*args, **kwargs)

    def refused(*args, **kwargs):
        raise AssertionError("a one-texture entry point was called")

    monkeypatch.setattr(rmod.sky_ops, "write_sky", counted)
    monkeypatch.setattr(rmod.sky_ops, "write_skybox", refused)
    monkeypatch.setattr(rmod.sky_ops, "write_clouds", refused)
    cfg = RenderConfig(width=32, height=24, shadow_samples=1,
                       max_ray_iterations=2, skybox_resolution=8,
                       clouds_resolution=8, primary_raster="off",
                       sun_mask="off")
    r = rmod.Renderer(WorldConfig(depth=3), cfg, device="cpu",
                      cache_path=tmp_path / "map_64.npz")
    cam = Camera.look_at([32, 28, 6], [32, 2, 45], fov=85)
    for t in (0.0, 0.1, 0.3, 0.45, 0.6):
        assert r.render(cam, time=t, fetch=True).shape == (24, 32, 3)
    assert calls == [0.0, 0.25, 0.5]


@pytest.mark.parametrize("sun,time", [("day", 0.25), ("low", 1.75)])
def test_rounding_bound_covers_exp_and_pow_ulps(sun, time, monkeypatch):
    """chip_smoke.py holds K3 to the plain sky on the CPU within rtol 1e-4,
    atol 1e-5 plus sky_rounding_bound: the first-order effect of every exp
    and pow result moving by its allowed ulps. The plain sky with each exp
    and pow result moved by a random -2..2 ulps (the card's expf is within
    2) stays inside that allowance at every texel channel, though not
    inside rtol 1e-4, atol 1e-5 alone for the day sun."""
    import chip_smoke
    st = torch.from_numpy(_sun(sun))
    bounds = chip_smoke.sky_rounding_bound(sky, st, time, 16, 32)
    ref = (sky.write_skybox_plain(st, 16), sky.write_clouds_plain(st, time,
                                                                  32))
    gen = torch.Generator().manual_seed(5)
    exp, pow_ = torch.exp, torch.pow

    def moved(y):
        steps = torch.randint(-2, 3, y.shape, generator=gen,
                              dtype=torch.int32)
        return torch.where(y > 0, (y.view(torch.int32) + steps)
                           .view(torch.float32), y)

    monkeypatch.setattr(torch, "exp", lambda x: moved(exp(x)))
    monkeypatch.setattr(torch, "pow", lambda x, e: moved(pow_(x, e)))
    got = (sky.write_skybox_plain(st, 16), sky.write_clouds_plain(st, time,
                                                                  32))
    monkeypatch.undo()
    beyond = 0
    for g, r, b in zip(got, ref, bounds):
        diff = (g.double() - r.double()).abs()
        tol = 1e-5 + 1e-4 * r.double().abs()
        assert bool((diff <= tol + b).all())
        beyond += int((diff > tol).sum())
    if sun == "day":
        assert beyond > 0
