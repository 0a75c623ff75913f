"""K1 (the jump-grid trace): the port's plain torch tracer held bit for bit
to the JAX package's `trace_jump` and to the port's copy of the numpy
oracle, on the corpus of tests/test_jump.py, and at every cap from 1 to 40
on the terrain case (a cap can fall between a row load and the in-brick
step it leads to). The call without counters and the call with one
direction for every ray are held to the full call, and the 8x4 tile map of
the kernel's threads (its Python twin) to a permutation of the rays.

Tolerance: none. (hit, face, axis_coord, t) are integer or exact float
outputs of the same IEEE formulas, and the counters (iterations, fetches,
missed_pops) count the same work. The JAX tracer runs with compaction off
(and every batch is under 4096 rays, where it would not engage): a lane
its cascade repacks re-fetches its row, which the counters would see."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vvr_tpu.ops import jump as jax_jump
from vvr_tpu.ops.jump import trace_jump as jax_trace_jump
from vvr_tpu.ops.traverse import _run_groups as jax_run_groups
from vvr_tpu.render.oracle import trace_dense as jax_trace_dense
from vvr_tpu.world.jumpgrid import build_jump_grid as jax_build_jump_grid
from vvr_tpu_torch import convert
from vvr_tpu_torch.ops.jump import (tile_ray_index, trace_jump,
                                    trace_jump_plain)
from vvr_tpu_torch.render.oracle import trace_dense
from vvr_tpu_torch.world.jumpgrid import build_jump_grid

# one intra-op thread: the suite runs six pytest workers on eight cores
torch.set_num_threads(1)

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


CAPS = list(range(1, 41))


def _jax_trace_per_ray_cap(jgrid, o, d, caps):
    """JAX `trace_jump` with compaction off (vvr_tpu/ops/jump.py:345-358)
    given one cap per ray: its stepper compares each ray's count with
    `max_steps`, so an array of caps runs every cap in one compile."""
    @jax.jit
    def run(o, d, caps):
        ray = jax_jump._make_ray(o, d)
        ox, oy, oz = ray[:3]
        size = jgrid.size
        inside = ((ox >= 0) & (ox < size) & (oy >= 0) & (oy < size)
                  & (oz >= 0) & (oz < size))
        state = jax_jump._init_state(jgrid, o.shape[0], inside, (ox, oy, oz))
        fetch, alu = jax_jump._make_stepper(jgrid, ray, caps, True)
        state = jax_run_groups(fetch, alu, state, None, jax_jump.FETCH_EVERY)
        return jax_jump._outputs(state, ray, size)

    return run(jnp.asarray(o), jnp.asarray(d), jnp.asarray(caps))


@pytest.fixture(scope="module")
def cap_sweep(small_world):
    """The terrain case traced by JAX once per cap in CAPS, in one call."""
    occ, o, d, _, _ = _case("terrain", small_world)
    jgrid = jax_build_jump_grid(occ)
    caps = np.repeat(np.array(CAPS, np.int32), N)
    ref = _jax_trace_per_ray_cap(jgrid, np.tile(o, (len(CAPS), 1)),
                                 np.tile(d, (len(CAPS), 1)), caps)
    grid = convert.jumpgrid_from_numpy(np.asarray(jgrid.rows), 64, "cpu")
    longest = int(trace_jump_plain(grid, torch.from_numpy(o),
                                   torch.from_numpy(d)).iterations.max())
    return grid, o, d, longest, {
        f: np.asarray(getattr(ref, f)).reshape(len(CAPS), N) for f in FIELDS}


@pytest.mark.parametrize("cap", CAPS)
def test_trace_cap_sweep_equals_jax(cap, cap_sweep):
    grid, o, d, longest, ref = cap_sweep
    res = trace_jump_plain(grid, torch.from_numpy(o), torch.from_numpy(d),
                           max_steps=cap)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(res, f).numpy(),
                                      ref[f][cap - 1],
                                      err_msg=f"cap {cap}: {f}")
    assert (res.iterations.numpy() == cap).any() == (cap <= longest)


def _port_grid(occ):
    return build_jump_grid(torch.from_numpy(occ), "cpu")


@pytest.mark.parametrize("name", ["terrain", "active_mask",
                                  "outside_origins", "axis_aligned"])
def test_trace_without_counters(name, small_world):
    """stats=False: the same (hit, face, axis_coord, t), no counters; the
    image width (the kernel's tiling) changes no output."""
    occ, o, d, act, steps = _case(name, small_world)
    grid = _port_grid(occ)
    args = (grid, torch.from_numpy(o), torch.from_numpy(d), steps,
            torch.from_numpy(act))
    full = trace_jump(*args)
    lean = trace_jump(*args, width=60, stats=False)
    for f in ("hit", "face", "axis_coord", "t"):
        assert torch.equal(getattr(lean, f), getattr(full, f)), f
    assert lean.iterations is None and lean.fetches is None
    assert lean.missed_pops is None
    with pytest.raises(ValueError):
        trace_jump(*args, width=7)


@pytest.mark.parametrize("direction", [(-0.28, 0.65, -0.71), (0.0, 0.0, -1.0),
                                       (1.0, 1.0, 1.0)],
                         ids=["sun", "axis", "diagonal"])
def test_trace_one_direction_equals_materialized(direction, small_world):
    """A (3,) direction for every ray, as the frame's shadow trace passes
    the sun, equals the same direction materialized per ray."""
    _, o, _, act, steps = _case("active_mask", small_world)
    occ = small_world[2]
    sun = np.asarray(direction, np.float32)
    sun = torch.from_numpy(sun / np.linalg.norm(sun))
    grid = _port_grid(occ)
    o, act = torch.from_numpy(o), torch.from_numpy(act)
    one = trace_jump(grid, o, sun, steps, act)
    many = trace_jump(grid, o, sun.expand(N, 3).contiguous(), steps, act)
    for f in FIELDS:
        assert torch.equal(getattr(one, f), getattr(many, f)), f
    assert one.hit.any() and not one.hit.all()


@pytest.mark.parametrize("w,h", [(33, 67), (1, 1), (7, 5), (8, 4), (96, 64),
                                 (1921, 3)])
def test_tile_ray_index_is_a_permutation(w, h):
    """Each ray is traced by exactly one thread, and the rays of a warp lie
    in one 8x4 pixel tile."""
    idx = tile_ray_index(w, h)
    assert idx.numel() == -(-w // 8) * -(-h // 4) * 32
    valid = idx[idx >= 0]
    assert torch.equal(torch.sort(valid).values, torch.arange(w * h))
    for warp in idx.reshape(-1, 32):
        rays = warp[warp >= 0]
        if rays.numel():
            x, y = rays % w, rays // w
            assert x.max() - x.min() < 8 and y.max() - y.min() < 4
            assert x.min() % 8 == 0 and y.min() % 4 == 0
