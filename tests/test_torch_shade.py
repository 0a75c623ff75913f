"""K2's arithmetic (the block-colour hash, the face normal, Cook-Torrance
lighting, ACES): the port's plain torch versions held to the JAX
package's.

Tolerances:
- albedo: exact on an integer block corpus. The hash is IEEE `*`, `+` and
  `floor` only. It is held to `material_at_soa` jitted, as the JAX frame
  runs it: XLA contracts the hash's dot product and norm into FMAs there,
  which changes the colour of about a quarter of all blocks against the
  op-by-op evaluation, and the port rounds the same way (utils/hash.py).
- the hash family as written (hash12, hash33, hash33_soa): exact against
  JAX op by op.
- lighting_soa: rtol=atol=1e-5 (pow differs in the last ulps).
- aces: rtol=1e-6 (division order is the same; ulp-level only)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vvr_tpu.ops import shade as jshade
from vvr_tpu.utils import hash as jhash
from vvr_tpu_torch.ops import shade
from vvr_tpu_torch.utils import hash as thash

# one intra-op thread: the suite runs six pytest workers on eight cores
torch.set_num_threads(1)


def _blocks():
    rng = np.random.default_rng(3)
    b = rng.integers(0, 256, (20000, 3))
    edges = np.array([[0, 0, 0], [255, 255, 255], [33, 0, 64], [129, 7, 250],
                      [128, 1, 1], [127, 1, 1]])
    return np.concatenate([b, edges]).astype(np.int32)


def test_albedo_exact_against_jitted_jax():
    b = _blocks()
    ref = jax.jit(lambda x, y, z: jshade.material_at_soa(x, y, z, 256))(
        *(jnp.asarray(b[:, i]) for i in range(3)))
    out = shade.material_at_soa(*(torch.from_numpy(b[:, i]).long()
                                  for i in range(3)), 256)
    for c in range(3):
        np.testing.assert_array_equal(out[c].numpy(), np.asarray(ref[c]))


@pytest.mark.parametrize("fn", ["hash12", "hash33", "hash33_soa"])
def test_hash_family_exact_against_jax(fn):
    p = np.random.default_rng(4).uniform(-1000, 1000, (5000, 3)) \
        .astype(np.float32)
    if fn == "hash12":
        ref = [jhash.hash12(jnp.asarray(p[:, :2]))]
        out = [thash.hash12(torch.from_numpy(p[:, :2]))]
    elif fn == "hash33":
        ref = [jhash.hash33(jnp.asarray(p))]
        out = [thash.hash33(torch.from_numpy(p))]
    else:
        ref = jhash.hash33_soa(*(jnp.asarray(p[:, i]) for i in range(3)))
        out = thash.hash33_soa(*(torch.from_numpy(p[:, i]) for i in range(3)))
    for r, o in zip(ref, out):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))


def test_face_normal_and_lighting_against_jax():
    rng = np.random.default_rng(5)
    n = 4000
    face = rng.integers(0, 3, n).astype(np.int32)
    sg = rng.choice([-1.0, 1.0], (n, 3)).astype(np.float32)
    jn = jshade.get_face_normal_soa(jnp.asarray(face),
                                    *(jnp.asarray(sg[:, i]) for i in range(3)))
    tn = shade.get_face_normal_soa(torch.from_numpy(face),
                                   *(torch.from_numpy(sg[:, i])
                                     for i in range(3)))
    for a, b in zip(tn, jn):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    view = rng.normal(size=(n, 3))
    view = (view / np.linalg.norm(view, axis=1, keepdims=True)) \
        .astype(np.float32)
    alb = rng.uniform(0.5, 1.0, (n, 3)).astype(np.float32)
    shadow = rng.uniform(0.0, 1.0, n).astype(np.float32)
    shadow[::7] = 0.0
    sun = np.asarray([-0.28, 0.65, -0.71], np.float32)
    sun /= np.linalg.norm(sun)
    col = np.asarray([2.9, 2.6, 2.3], np.float32)
    ref = jax.jit(lambda a, nn, v, s: jshade.lighting_soa(
        a, nn, jnp.float32(0.8), jnp.ones_like(s), s, v, jnp.asarray(sun),
        jnp.asarray(col)))(
        tuple(jnp.asarray(alb[:, i]) for i in range(3)), jn,
        tuple(jnp.asarray(view[:, i]) for i in range(3)),
        jnp.asarray(shadow))
    out = shade.lighting_soa(
        tuple(torch.from_numpy(alb[:, i]) for i in range(3)), tn, 0.8, 1.0,
        torch.from_numpy(shadow),
        tuple(torch.from_numpy(view[:, i]) for i in range(3)),
        torch.from_numpy(sun), torch.from_numpy(col))
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)


def test_aces_against_jax():
    x = np.linspace(-1.0, 50.0, 5001, dtype=np.float32)
    np.testing.assert_allclose(shade.aces(torch.from_numpy(x)).numpy(),
                               np.asarray(jshade.aces(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-7)
