"""The port's gather microbenchmark (vvr_tpu_torch/ops/gather.py, K5-K8)
against the six Pallas kernels of tools/microbench_gather.py and
tools/microbench_gather2.py, run in interpret mode on the CPU.

Each case loads a reference tool by path, swaps `pl.pallas_call` (looked
up at call time) for one with interpret=True that records the kernel's
inputs and output as numpy through jax.debug.callback, and runs the
reference function once under jit with a small N. The recorded inputs go
through convert.py into the port's wrapper (on the CPU: its plain version),
and the output must equal the Pallas kernel's bit for bit (integers: no
tolerance). The card holds each kernel against these plain versions at
N = 2^21 (chip_smoke.py).
"""

import importlib.util
import inspect
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from vvr_tpu_torch import convert, kernels
from vvr_tpu_torch.ops import gather, raygen, sky
from vvr_tpu_torch.render import renderer, scene
from vvr_tpu_torch.tools import microbench_gather as bench
from vvr_tpu_torch.utils.camera import Camera
from vvr_tpu_torch.world import faces, generator, jumpgrid

# one intra-op thread: the suite runs six pytest workers on eight cores
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
G1, G2 = "tools/microbench_gather.py", "tools/microbench_gather2.py"
WRAPPER = {"pallas_take": "gather_chain", "pallas_tala": "gather_chain",
           "pallas_vreg": "gather_chain_shared",
           "pallas_onehot": "gather_onehot", "pallas_scalar": "gather_rows"}

# (tool, function, its arguments, lanes N). N is cut from 2^21 to keep the
# interpreter quick: 2^13 for the 4096-row one-hot product, 2^14 (one grid
# step of 256 after the tool's N / 64) for the scalar loop.
CASES = [
    (G1, "pallas_vreg", (), 1 << 15),
    (G1, "pallas_take", (4096, 2), 1 << 15),
    (G1, "pallas_take", (266305, 2), 1 << 15),
    (G1, "pallas_take", (32768, 16), 1 << 15),
    (G1, "pallas_onehot", (4096, 2), 1 << 13),
    (G1, "pallas_onehot", (64, 2), 1 << 15),
    (G1, "pallas_scalar", (266305, 2), 1 << 14),
    (G1, "pallas_scalar", (32768, 16), 1 << 14),
    (G2, "pallas_tala", (32768, 16), 1 << 15),
    (G2, "pallas_tala", (1024, 8), 1 << 15),
    (G2, "pallas_onehot", (4096, 2), 1 << 13),
    (G2, "pallas_onehot", (512, 16), 1 << 15),
]


def _name(fn, args):
    if not args:
        return f"{fn}:R1024"
    return f"{fn}:R{args[0]}xC{args[1]}"


@pytest.fixture
def pallas_calls(monkeypatch):
    """pl.pallas_call in interpret mode; each call's inputs and output are
    appended to the returned list as numpy arrays."""
    calls = []
    real = pl.pallas_call

    def interpreted(kernel, **kw):
        call = real(kernel, interpret=True, **kw)

        def run(*args):
            out = call(*args)
            jax.debug.callback(
                lambda *a: calls.append([np.asarray(x) for x in a]),
                *args, out)
            return out
        return run

    monkeypatch.setattr(pl, "pallas_call", interpreted)
    return calls


def _reference(tool: str, n: int):
    """A fresh copy of a reference tool: N lanes, one timed call, no
    report, failures raised."""
    spec = importlib.util.spec_from_file_location(
        "ref_" + pathlib.Path(tool).stem, ROOT / tool)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.N = n
    mod.REPS = 1
    mod.timed = lambda fn, *args: (np.asarray(fn(*args)), 0.0)[1]
    mod.report = lambda *a, **k: None

    def fail(name, err):
        raise err
    mod.fail = fail
    return mod


def _port(fn: str, recorded):
    """The port's wrapper on the recorded inputs, as numpy."""
    wrapper = getattr(gather, WRAPPER[fn])
    if fn == "pallas_scalar":
        idx, table, _ = recorded
    else:
        table, idx, _ = recorded
    idx = torch.from_numpy(np.array(idx))
    if fn == "pallas_onehot":
        out_dtype = torch.int32 if recorded[2].dtype == np.int32 \
            else torch.uint32
        planes = convert.gather_planes_from_numpy(table, "cpu")
        return wrapper(planes, idx, out_dtype).numpy()
    return wrapper(convert.gather_table_from_numpy(table, "cpu"), idx).numpy()


def _run_case(tool, fn, args, n, calls):
    before = dict(kernels.LAUNCHES)
    getattr(_reference(tool, n), fn)(*args)
    assert calls, "the Pallas kernel was not called"
    recorded = calls[-1]
    ref = recorded[-1]
    port = _port(fn, recorded)
    assert port.dtype == ref.dtype and port.shape == ref.shape
    np.testing.assert_array_equal(port, ref)
    assert kernels.LAUNCHES == before      # the CPU never reaches a kernel
    return recorded


@pytest.mark.parametrize("tool, fn, args, n", CASES,
                         ids=[f"{t.split('/')[-1][:-3]}:{_name(f, a)}"
                              for t, f, a, _ in CASES])
def test_plain_matches_pallas_interpret(tool, fn, args, n, pallas_calls):
    _run_case(tool, fn, args, n, pallas_calls)


# One case per chain family with a full-range u32 table: words of 2^31 and
# more are negative as int32, and the next index is their floor mod.
FULL_RANGE = [
    (G1, "pallas_take", (4096, 2)),
    (G2, "pallas_tala", (1024, 8)),
    (G1, "pallas_onehot", (64, 2)),
    (G2, "pallas_onehot", (512, 16)),
]


@pytest.mark.parametrize("tool, fn, args", FULL_RANGE,
                         ids=[f"{t.split('/')[-1][:-3]}:{_name(f, a)}"
                              for t, f, a in FULL_RANGE])
def test_full_range_table_matches_pallas(tool, fn, args, pallas_calls,
                                         monkeypatch):
    tables = []

    def make_table(rows, cols, key):
        t = np.random.default_rng(7).integers(0, 1 << 32, (rows, cols),
                                              dtype=np.uint32)
        tables.append(t)
        return jnp.asarray(t)

    mod = _reference(tool, 1 << 15)
    monkeypatch.setattr(mod, "make_table", make_table)
    getattr(mod, fn)(*args)
    recorded = pallas_calls[-1]
    np.testing.assert_array_equal(_port(fn, recorded), recorded[-1])
    table = torch.from_numpy(tables[0])
    assert int((table.view(torch.int32) < 0).sum()) > table.numel() // 4
    if fn == "pallas_onehot":   # the port's planes are the reference's
        np.testing.assert_array_equal(
            gather.u8_planes(table).view(torch.int16).numpy(),
            recorded[0].view(np.int16))


def _reference_names(tool: str) -> set[str]:
    """The experiment names a reference tool's main() runs."""
    main = (ROOT / tool).read_text().split("def main")[1]
    names = set()
    loop = re.search(r"for rows, cols in \[(.*?)\]:", main, re.S)
    if loop:
        names |= {f"xla:R{r}xC{c}"
                  for r, c in re.findall(r"\((\d+), (\d+)\)", loop.group(1))}
    for r, c, sort in re.findall(r"xla_chain\((\d+), (\d+)(, sort=True)?\)",
                                 main):
        names.add(f"xla{'_sorted' if sort else ''}:R{r}xC{c}")
    for fn, r, c in re.findall(r"(pallas_\w+)\((?:(\d+), (\d+))?\)", main):
        names.add(_name(fn, (r, c) if r else ()))
    return names


def test_tool_runs_every_reference_experiment():
    """The port's tool runs every experiment of the two reference main()s,
    and this file covers each of their Pallas experiments."""
    for tool in (G1, G2):
        port = {e.name for e in bench.EXPERIMENTS
                if e.reference.startswith(tool + ":")}
        assert port == _reference_names(tool)
    assert len(bench.EXPERIMENTS) == 27
    assert {_name(f, a) for _, f, a, _ in CASES} == {
        e.name for e in bench.EXPERIMENTS if e.name.startswith("pallas")}


def test_tool_needs_cuda(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench.main([]) == 1
    assert "no CUDA device" in capsys.readouterr().err


def test_bounds():
    """K7 at (4096, 2) over 2^21 lanes does 2 * 2^21 * 4096 * 8 * 8 = 2^40
    operations (about 1.11 ms at 989 TFLOP/s); K5's bound is its bytes."""
    n = 1 << 21
    idx = torch.empty(n, dtype=torch.int32, device="meta")
    out = torch.empty(n, dtype=torch.uint32, device="meta")
    planes = torch.empty((4096, 8), dtype=torch.bfloat16, device="meta")
    ms, by = bench.gather_bound("gather_onehot", planes, idx, out)
    assert by == "operations"
    assert ms == pytest.approx(2.0 ** 40 / 989e12 * 1e3)
    assert 1.11 < ms < 1.12
    table = torch.empty((32768, 32), dtype=torch.uint32, device="meta")
    ms, by = bench.gather_bound("gather_chain", table, idx, out)
    assert by == "bytes"
    assert ms == pytest.approx((8 * n + 32768 * 128) / 3.35e12 * 1e3)


ENTRY_POINTS = {
    "Renderer": renderer.Renderer.__init__,
    "build_scene": scene.build_scene,
    "generate_world": generator.generate_world,
    "build_jump_grid": jumpgrid.build_jump_grid,
    "camera_rays": raygen.camera_rays,
    "write_skybox": sky.write_skybox,
    "write_clouds": sky.write_clouds,
    "write_sky": sky.write_sky,
    "jumpgrid_from_numpy": convert.jumpgrid_from_numpy,
    "sky_from_numpy": convert.sky_from_numpy,
    "occupancy_from_numpy": convert.occupancy_from_numpy,
    "gather_table_from_numpy": convert.gather_table_from_numpy,
    "gather_planes_from_numpy": convert.gather_planes_from_numpy,
    "faces_from_numpy": convert.faces_from_numpy,
    "sun_grids_from_numpy": convert.sun_grids_from_numpy,
    "FaceSet.device_tuple": faces.FaceSet.device_tuple,
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_defaults_to_cuda(name):
    param = inspect.signature(ENTRY_POINTS[name]).parameters["device"]
    assert param.default == "cuda"


def test_cuda_default_does_not_fall_back():
    """On a host without a card the default raises as torch does; nothing
    falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("needs a host without a CUDA device")
    cam = Camera.look_at([8, 8, 8], [0, 0, 0], fov=60)
    with pytest.raises((AssertionError, RuntimeError)):
        raygen.camera_rays(cam, 4, 4)
    with pytest.raises((AssertionError, RuntimeError)):
        sky.write_skybox(np.array([0.0, 1.0, 0.0], np.float32), 0.0, 4)
