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
    ref_c = np.asarray(jsky.sample_clouds(jnp.asarray(jcl), jnp.asarray(d),
                                          jnp.asarray(pos)))
    td, tp = torch.from_numpy(d), torch.from_numpy(pos)
    out_c = sky.sample_clouds(cl, *td.unbind(1), *tp.unbind(1))
    np.testing.assert_array_equal(out_c.numpy(), ref_c)
    assert (ref_c[:, 3] > 0).any()
    ref_s = np.asarray(jsky.sample_skybox(jnp.asarray(jbox), jnp.asarray(d)))
    np.testing.assert_array_equal(sky.sample_skybox(box, *td.unbind(1))
                                  .numpy(), ref_s)
