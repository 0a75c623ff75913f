"""K4 (bloom pyramid and compositor): the port's plain torch versions held
to the JAX package's `bloom_downsample`, `bloom_upsample`, `bloom_pyramid_p`
and `composite_p`.

Tolerances: bloom atol=rtol=1e-5 (the 3x3 window sum may add in another
order than XLA's reduce_window); composite u8 within 1 (pow's last ulp can
move a value across a quantization step)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vvr_tpu.ops import post as jpost
from vvr_tpu_torch.ops import post

# one intra-op thread: the suite runs six pytest workers on eight cores
torch.set_num_threads(1)


def _hdr(h, w, seed):
    """Planar rgba with bright spots and sky (alpha 10) regions."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(0.0, 0.5, (4, h, w)).astype(np.float32)
    img[3] = 0.0
    img[3, : h // 3] = 10.0
    img[:3, rng.integers(0, h, 20), rng.integers(0, w, 20)] = 40.0
    return img


# (5, 700): mip 2 is 1 x 175, a side of 1
@pytest.mark.parametrize("shape", [(64, 96), (30, 40), (67, 33), (5, 700)])
def test_bloom_passes_and_pyramid_equal_jax(shape):
    h, w = shape
    img = _hdr(h, w, 1)
    nh, nw = max(h >> 1, 1), max(w >> 1, 1)
    down = post.bloom_downsample_plain(torch.from_numpy(img), nh, nw)
    np.testing.assert_allclose(
        down.numpy(), np.asarray(jpost.bloom_downsample(jnp.asarray(img),
                                                        nh, nw)),
        rtol=1e-5, atol=1e-5)
    up = post.bloom_upsample_plain(down, h, w)
    np.testing.assert_allclose(
        up.numpy(), np.asarray(jpost.bloom_upsample(jnp.asarray(
            down.numpy()), h, w)), rtol=1e-5, atol=1e-5)
    b2 = post.bloom_pyramid_p(torch.from_numpy(img))
    ref = np.asarray(jpost.bloom_pyramid_p(jnp.asarray(img)))
    assert b2.shape == ref.shape
    if shape == (5, 700):
        assert b2.shape == (4, 1, 175)
    np.testing.assert_allclose(b2.numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("out_scale,bloom", [(1, True), (2, True),
                                             (1, False)])
def test_composite_equals_jax(out_scale, bloom):
    h, w = 64, 96
    img = _hdr(h, w, 2)
    b2 = np.array(jpost.bloom_pyramid_p(jnp.asarray(img)))
    oh, ow = h * out_scale, w * out_scale
    ref = np.asarray(jpost.composite_p(jnp.asarray(img), jnp.asarray(b2),
                                       oh, ow, 0.05, bloom))
    out = post.composite_p(torch.from_numpy(img), torch.from_numpy(b2), oh,
                           ow, 0.05, bloom)
    assert out.dtype == torch.uint8 and tuple(out.shape) == (oh, ow, 3)
    assert np.abs(out.numpy().astype(int) - ref.astype(int)).max() <= 1


def test_mip_count():
    assert post.bloom_mip_count(1920, 1080) == jpost.bloom_mip_count(1920,
                                                                     1080)
    assert post.bloom_mip_count(96, 64) == jpost.bloom_mip_count(96, 64)


def test_bloom_dispatch_no_fallback():
    """A device with neither a kernel nor a plain path raises."""
    with pytest.raises(ValueError):
        post.bloom_pyramid_p(torch.zeros((4, 64, 96)).to("meta"))
