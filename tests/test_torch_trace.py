"""K1 (the jump-grid trace): the port's plain torch tracer held bit for bit
to the JAX package's `trace_jump` and to the port's copy of the numpy
oracle, on the corpus of tests/test_jump.py.

Tolerance: none. (hit, face, axis_coord, t) are integer or exact float
outputs of the same IEEE formulas, and the counters (iterations, fetches,
missed_pops) count the same work. The JAX tracer runs with compaction off
(and every batch is under 4096 rays, where it would not engage): a lane
its cascade repacks re-fetches its row, which the counters would see."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vvr_tpu.ops.jump import trace_jump as jax_trace_jump
from vvr_tpu.render.oracle import trace_dense as jax_trace_dense
from vvr_tpu.world.jumpgrid import build_jump_grid as jax_build_jump_grid
from vvr_tpu_torch import convert
from vvr_tpu_torch.ops.jump import trace_jump, trace_jump_plain
from vvr_tpu_torch.render.oracle import trace_dense

N = 3000          # one batch shape for every case: one JAX compile
FIELDS = ("hit", "face", "axis_coord", "t", "iterations", "fetches",
          "missed_pops")


def _rays(rng, n, size, inside=True):
    lo, hi = (0.5, size - 0.5) if inside else (-size, 2 * size)
    o = rng.uniform(lo, hi, size=(n, 3))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _pad(o, d):
    reps = -(-N // len(o))
    return (np.tile(o, (reps, 1))[:N].astype(np.float32),
            np.tile(d, (reps, 1))[:N].astype(np.float32))


def _case(name, small_world):
    """(occ, o, d, active, max_steps) of one corpus case."""
    rng = np.random.default_rng(100 + CASES.index(name))
    act = np.ones(N, bool)
    steps = 4096
    if name == "sparse_inside":
        occ = np.random.default_rng(4).random((64, 64, 64)) < 0.01
        o, d = _rays(rng, N, 64)
    elif name == "dense_inside":
        occ = np.random.default_rng(5).random((64, 64, 64)) < 0.4
        o, d = _rays(rng, N, 64)
    elif name == "outside_origins":
        occ = np.random.default_rng(6).random((64, 64, 64)) < 0.05
        o, d = _rays(rng, N, 64, inside=False)
    elif name == "axis_aligned":
        occ = np.random.default_rng(3).random((64, 64, 64)) < 0.02
        o = rng.uniform(0.25, 63.75, size=(N, 3)).astype(np.float32)
        d = np.zeros((N, 3), np.float32)
        d[np.arange(N), rng.integers(0, 3, N)] = rng.choice([-1.0, 1.0], N)
    elif name == "start_in_solid":
        occ = np.ones((64, 64, 64), bool)
        o, d = _pad(np.array([[5.5, 5.5, 5.5], [-1.0, 5.0, 5.0],
                              [64.0, 5.0, 5.0]], np.float32),
                    np.array([[1, 0, 0], [1, 0, 0], [-1, 0, 0]], np.float32))
    elif name == "empty_world":
        occ = np.zeros((64, 64, 64), bool)
        o, d = _rays(rng, N, 64)
    elif name == "active_mask":
        occ = np.random.default_rng(7).random((64, 64, 64)) < 0.03
        o, d = _rays(rng, N, 64)
        act = rng.random(N) < 0.5
    elif name == "far_corner":
        occ = np.zeros((64, 64, 64), bool)
        occ[0:8, 0:8, 0:8] = True
        o = rng.uniform(40, 63, size=(N, 3)).astype(np.float32)
        d = (rng.uniform(0, 8, size=(N, 3)) - o)
        d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    elif name == "half_empty_bricks":
        mask = np.random.default_rng(9).random((64, 64, 64)) < 0.3
        xs = np.arange(64)
        occ = (mask & ((xs[None, None, :] & 7) >= 4)
               & ((xs[None, :, None] & 7) >= 4))
        o, d = _rays(rng, N, 64)
    elif name == "terrain":
        occ = small_world[2]
        o, d = _rays(rng, N, 64)
    elif name == "capped":
        occ = small_world[2]
        o, d = _rays(rng, N, 64)
        steps = 9
    else:
        raise ValueError(name)
    return occ, o, d, act, steps


CASES = ["sparse_inside", "dense_inside", "outside_origins", "axis_aligned",
         "start_in_solid", "empty_world", "active_mask", "far_corner",
         "half_empty_bricks", "terrain", "capped"]


@pytest.mark.parametrize("name", CASES)
def test_trace_equals_jax_and_oracle(name, small_world):
    occ, o, d, act, steps = _case(name, small_world)
    jgrid = jax_build_jump_grid(occ)
    ref = jax_trace_jump(jgrid, jnp.asarray(o), jnp.asarray(d),
                         max_steps=steps, active=jnp.asarray(act),
                         compact=False)
    grid = convert.jumpgrid_from_numpy(np.asarray(jgrid.rows), 64, "cpu")
    res = trace_jump(grid, torch.from_numpy(o), torch.from_numpy(d),
                     max_steps=steps, active=torch.from_numpy(act))
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(res, f).numpy(),
                                      np.asarray(getattr(ref, f)),
                                      err_msg=f"{name}: {f}")
    if name == "capped":
        assert (res.iterations.numpy() == steps).any()
        return
    # the oracle traces every ray; the mask only deactivates
    dense = trace_dense(occ, o, d)
    hit = res.hit.numpy()
    np.testing.assert_array_equal(hit, dense["hit"] & act)
    m = hit & act
    for f in ("face", "axis_coord", "t"):
        np.testing.assert_array_equal(getattr(res, f).numpy()[m],
                                      dense[f][m], err_msg=f"{name}: {f}")


def test_oracle_copy_equals_jax_oracle(small_world):
    """The port's numpy oracle is the JAX package's numpy body."""
    occ = small_world[2]
    o, d = _rays(np.random.default_rng(11), 2000, 64, inside=False)
    ref = jax_trace_dense(occ, o, d, prefer_native=False)
    out = trace_dense(occ, o, d)
    for f in ("hit", "face", "axis_coord", "t"):
        np.testing.assert_array_equal(out[f], ref[f])


def test_trace_dispatch_cpu_plain_and_no_fallback(small_world):
    """A CPU tensor runs the plain version; a device with neither a
    kernel nor a plain path raises instead of falling back."""
    grid = convert.jumpgrid_from_numpy(
        np.asarray(jax_build_jump_grid(small_world[2]).rows), 64, "cpu")
    o, d = _rays(np.random.default_rng(12), 500, 64)
    a = trace_jump(grid, torch.from_numpy(o), torch.from_numpy(d))
    b = trace_jump_plain(grid, torch.from_numpy(o), torch.from_numpy(d))
    for f in FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f))
    with pytest.raises(ValueError):
        trace_jump(grid, torch.from_numpy(o).to("meta"),
                   torch.from_numpy(d).to("meta"))
