"""The port's measurement script: its interval arithmetic, and that it
refuses to run without a CUDA device (the CPU is never measured as the
card)."""

import hashlib
import sys

import numpy as np
import pytest
import torch

from vvr_tpu_torch.config import WorldConfig
from vvr_tpu_torch.ops import sunshadow
from vvr_tpu_torch.ops.gather import gather_chain_plain
from vvr_tpu_torch.ops.jump import trace_jump_plain
from vvr_tpu_torch.ops.raygen import camera_rays
from vvr_tpu_torch.render.scene import build_scene
from vvr_tpu_torch.tools import (bank_model, frame_digest, lane_use,
                                 profile_frame, profile_gather, sass_count)
from vvr_tpu_torch.utils.camera import Camera
from vvr_tpu_torch.world.faces import extract_merged_faces

# one intra-op thread: the suite runs six pytest workers on eight cores
torch.set_num_threads(1)


@pytest.mark.parametrize("intervals, total", [
    ([], 0.0),
    ([(0.0, 2.0)], 2.0),
    ([(0.0, 2.0), (1.0, 3.0)], 3.0),          # overlap counted once
    ([(5.0, 6.0), (0.0, 1.0)], 2.0),          # any order
    ([(0.0, 4.0), (1.0, 2.0)], 4.0),          # nested
    ([(0.0, 1.0), (1.0, 2.0), (3.0, 3.5)], 2.5),
])
def test_union_us(intervals, total):
    assert profile_frame.union_us(intervals) == total


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a host "
                    "without a CUDA device")
def test_profile_frame_needs_cuda(capsys):
    assert profile_frame.main([]) == 1
    assert "no CUDA device" in capsys.readouterr().err


def test_frame_digest_needs_cuda(capsys, monkeypatch):
    monkeypatch.setattr(sys, "path", list(sys.path))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert frame_digest.main([]) == 1
    assert "no CUDA device" in capsys.readouterr().err


@pytest.mark.parametrize("tool", [profile_gather], ids=["profile_gather"])
def test_measuring_tools_need_cuda(tool, capsys, monkeypatch):
    monkeypatch.setattr(sys, "path", list(sys.path))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tool.main([]) == 1
    assert "no CUDA device" in capsys.readouterr().err


def test_sass_count_reads_the_listing():
    """Per kernel: every instruction once, MUFU by kind, local loads and
    stores, calls, atomics that may reach device memory (not the shared
    ATOMS, nor the warp reduction REDUX), tensor-core instructions by
    opcode (HGMMA apart from the per-warp HMMA); other kernels are left
    out."""
    listing = """
        Function : _ZN12_GLOBAL__N_114vvr_sky_kernelEv
        /*0000*/                   LDC R1, c[0x0][0x28] ;   /* 0x0000 */
        /*0010*/                   MUFU.RSQ R5, R4 ;        /* 0x0000 */
        /*0020*/              @!P0 MUFU.EX2 R5, R4 ;        /* 0x0000 */
        /*0030*/               @P1 CALL.REL.NOINC 0x100 ;  /* 0x0000 */
        /*0040*/                   STL [R1], R2 ;           /* 0x0000 */
        /*0050*/                   LDL R3, [R1] ;           /* 0x0000 */
        /*0060*/                   ATOMS.MAX RZ, [R3], R4 ; /* 0x0000 */
        /*0070*/                   ATOMG.E.ADD.STRONG.GPU PT, R2, [R4.64], R5 ;
        /*0080*/               @P0 RED.E.ADD.STRONG.GPU [R4.64], R5 ;
        /*0090*/                   ATOM.E.MAX.STRONG.GPU PT, R2, [R4.64], R5 ;
        /*00a0*/                   REDUX.SUM UR4, R5 ;      /* 0x0000 */
        /*00b0*/                   HGMMA.64x8x16.F32.BF16 R24, R24, gdesc[UR4] ;
        /*00c0*/                   HGMMA.64x8x16.F32.BF16 R24, R28, gdesc[UR4] ;
        /*00d0*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;
        Function : _Z5otherv
        /*0000*/                   MUFU.RCP R5, R4 ;        /* 0x0000 */
        /*0010*/                   RED.E.ADD.STRONG.GPU [R4.64], R5 ;
        /*0020*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;
"""
    got = sass_count.count(listing, ["vvr_sky_kernel"])
    tensor = dict.fromkeys(sass_count.TENSOR_OPS, 0)
    tensor.update(HGMMA=2, HMMA=1)
    assert got == {"_ZN12_GLOBAL__N_114vvr_sky_kernelEv": {
        "instructions": 14, "mufu": {"EX2": 1, "RSQ": 1}, "local_loads": 1,
        "local_stores": 1, "calls": 1, "global_atomics": 3,
        "tensor": tensor}}
    ops = sass_count.opcodes(listing, ["vvr_sky_kernel"])
    assert list(ops) == ["_ZN12_GLOBAL__N_114vvr_sky_kernelEv"]
    assert sum(v for k, v in ops["_ZN12_GLOBAL__N_114vvr_sky_kernelEv"]
               .items() if k.split(".")[0] == "HGMMA") == 2


def test_sass_count_probe_fast_path():
    """A probe's fast path ends at its first unconditional EXIT (a
    predicated EXIT does not end it); an FFMA counts two float32
    operations, other F-class instructions one, conversions none."""
    listing = """
        Function : probe_1
        /*0000*/                   LDC R1, c[0x0][0x28] ;   /* 0x0000 */
        /*0010*/                   FFMA.SAT R0, R2, R3, 0.5 ;
        /*0020*/              @!P0 EXIT ;                   /* 0x0000 */
        /*0030*/                   MUFU.EX2 R5, R4 ;        /* 0x0000 */
        /*0040*/                   F2I.TRUNC R6, R5 ;       /* 0x0000 */
        /*0050*/                   FSETP.GT.AND P0, PT, R5, RZ, PT ;
        /*0060*/                   EXIT ;                   /* 0x0000 */
        /*0070*/                   FADD R5, R4, R3 ;        /* 0x0000 */
        Function : probe_0
        /*0000*/                   LDC R1, c[0x0][0x28] ;   /* 0x0000 */
        /*0010*/                   EXIT ;                   /* 0x0000 */
"""
    paths = sass_count.fast_path(listing)
    assert paths["probe_1"] == {"LDC": 1, "FFMA.SAT": 1, "EXIT": 1,
                                "MUFU.EX2": 1, "F2I.TRUNC": 1,
                                "FSETP.GT.AND": 1}
    assert paths["probe_0"] == {"LDC": 1}
    assert sass_count.fp32_ops(paths["probe_1"]) == 3
    assert "probe_8(" in sass_count.probe_source()


def test_frame_digest_hashes_the_bytes():
    """The digest is the SHA-256 of the tensor's bytes in row-major order,
    so a view with other strides hashes as its contiguous copy."""
    x = torch.arange(24, dtype=torch.float32).reshape(2, 3, 4)
    want = hashlib.sha256(np.ascontiguousarray(
        x.permute(2, 0, 1).numpy()).tobytes()).hexdigest()
    assert frame_digest.digest(x.permute(2, 0, 1)) == want
    assert frame_digest.digest(x) != want


def test_frame_digest_grid_digests():
    """A sun grid's digest is that of sun_grids' gBC for its sun and grid
    side, a sun of None being the default one (a few voxels of an 8^3
    world, so the plain build runs)."""
    occ = np.zeros((8, 8, 8), bool)
    occ[1:3, 2, 1:5] = True
    occ[4, 1:4, 3] = True
    faces = extract_merged_faces(occ).device_tuple("cpu")
    default = np.array([-0.28, 0.65, -0.71], np.float32)
    grids = {"a": (None, 16), "b": ((0.6, 0.05, 0.8), 9)}
    got = frame_digest.grid_digests(sunshadow, faces, 8, default, grids)
    assert sorted(got) == ["a", "b"]
    for name, (sun, grid) in grids.items():
        s = np.asarray(default if sun is None else sun, np.float32)
        gbc = sunshadow.sun_grids_plain(
            faces, *sunshadow.sun_basis(s / np.linalg.norm(s)), 8, grid)[0]
        assert (gbc > -3e38).any()
        assert got[name] == {"gbc": frame_digest.digest(gbc),
                             "shape": [grid * grid, 2]}
    assert set(frame_digest.GRIDS.values()) == {
        (sun, grid) for sun in (None, (0.6, 0.05, 0.8))
        for grid in (2048, 512)}


@pytest.mark.parametrize("tiled", [False, True], ids=["32x1", "8x4"])
def test_lane_use_counts_the_trips(tiled, tmp_path):
    """lane_use on a 96x64 view of the 64^3 world: every sub-step lands in
    one trip of one warp (it checks them against the counters itself), and
    the shares are fractions, the one with both bodies counted twice the
    smallest."""
    scene = build_scene(WorldConfig(depth=3), "cpu",
                        cache_path=tmp_path / "map.npz")
    cam = Camera.look_at([32, 28, 6], [32, 2, 45], fov=85)
    o, d = camera_rays(cam, 96, 64, "cpu")
    out = lane_use.lane_use(scene.jumpgrid, o, d, None,
                            lane_use.warps(96 * 64, 96, tiled), 2048)
    assert out["traced"] == 96 * 64
    assert 0 < out["old_trips_both_bodies"] < 1
    assert (0 < out["old_lane_use_both_counted"]
            < out["old_lane_use_one_body"] <= 1)
    assert 0 < out["new_lane_use"] <= 1
    assert out["warp_trips_new"] < out["warp_trips_old"]
    ref = trace_jump_plain(scene.jumpgrid, o, d, 2048)
    assert out["sub_steps_max"] == int(ref.iterations.max())


def test_lane_use_warps_cover_each_ray_once():
    for tiled in (False, True):
        w = lane_use.warps(33 * 67, 33, tiled)
        counts = torch.bincount(w)
        assert counts.sum() == 33 * 67 and counts.max() <= 32


# The shared-memory bank model of K6's row reads (tools/bank_model.py): one
# warp-step of 32 lanes, rows of a (rows, cols) table
@pytest.mark.parametrize("rows_read, cols, want", [
    ([5] * 32, 1, 1),                       # one word: a broadcast
    (list(range(32)), 1, 1),                # 32 distinct banks
    ([32 * i for i in range(32)], 1, 32),   # one bank, 32 words
    ([0] * 32, 2, 2),                       # one 8-byte row, two phases
    (list(range(32)), 2, 2),                # 16 rows a phase, 16 groups
    ([16 * i for i in range(32)], 2, 32),   # 16 rows a phase in one group
], ids=["one-word", "distinct-banks", "rows-32-apart", "one-8-byte-row",
        "consecutive-8-byte-rows", "8-byte-rows-16-apart"])
def test_bank_model_counts_wavefronts(rows_read, cols, want):
    assert bank_model.wavefronts(np.array(rows_read), cols) == want


def test_bank_model_16_byte_rows_take_four_phases():
    rng = np.random.default_rng(3)
    for rows_read in ([0] * 32, list(range(32)),
                      rng.integers(0, 1024, 32)):
        assert bank_model.wavefronts(np.array(rows_read), 4) >= 4


def _brute_force(rows_read, cols, order):
    """Wavefronts of one warp-step, lane by lane, phase by phase."""
    vw = bank_model.vector_words(cols)
    nv, per = cols // vw, 32 // vw
    total = 0
    for j in range(nv):
        for first in range(0, 32, per):
            groups = {}
            for lane in range(first, first + per):
                r = int(rows_read[lane])
                slot = {"row": j, "spread": (j + lane) % nv}[order]
                addr = r * nv + slot
                groups.setdefault(addr % per, set()).add(addr)
            total += max(len(a) for a in groups.values())
    return total


@pytest.mark.parametrize("cols", [1, 2, 3, 4, 8, 16])
def test_bank_model_matches_brute_force(cols):
    rng = np.random.default_rng(cols)
    rows_read = rng.integers(0, 64, (3, 64))
    nv = cols // bank_model.vector_words(cols)
    orders = [o for o in bank_model.ORDERS if o == "row" or nv > 1]
    for order in orders:
        want = sum(_brute_force(r[w:w + 32], cols, order)
                   for r in rows_read for w in (0, 32)) / 6
        assert bank_model.wavefronts(rows_read, cols, order) == want


def test_bank_model_spread_order_beats_row_order():
    """At pallas_tala's 1024x8 table (two 16-byte vectors a row), lanes that
    alternate their first vector take fewer wavefronts than row order, on
    the chain's own index stream from a seeded table."""
    rng = np.random.default_rng(0)
    table = rng.integers(0, 1 << 32, (1024, 8), dtype=np.uint32)
    stream = bank_model.chain_rows(table, rng.integers(0, 1024, 4096))
    assert stream.shape == (8, 4096)
    row = bank_model.wavefronts(stream, 8, "row")
    spread = bank_model.wavefronts(stream, 8, "spread")
    assert spread < 0.8 * row
    assert bank_model.floor_us(1.0, 1 << 21, 132, 1.98e9) == pytest.approx(
        8 * (1 << 21) / 32 / (132 * 1.98e9) * 1e6)


def test_bank_model_chain_rows_walks_the_plain_chain():
    rng = np.random.default_rng(5)
    table = rng.integers(0, 1 << 32, (1000, 3), dtype=np.uint32)
    idx = rng.integers(-5000, 5000, 257).astype(np.int32)
    stream = bank_model.chain_rows(table, idx)
    col0 = table[:, 0].view(np.int32).astype(np.int64)
    got = sum(col0[stream[s]] for s in range(8)) & 0xFFFFFFFF
    want = gather_chain_plain(torch.from_numpy(table),
                              torch.from_numpy(idx))
    np.testing.assert_array_equal(got, want.view(torch.int32).numpy()
                                  .astype(np.int64) & 0xFFFFFFFF)
