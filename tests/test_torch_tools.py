"""The port's measurement script: its interval arithmetic, and that it
refuses to run without a CUDA device (the CPU is never measured as the
card)."""

import hashlib
import sys

import numpy as np
import pytest
import torch

from vvr_tpu_torch.config import WorldConfig
from vvr_tpu_torch.ops.jump import trace_jump_plain
from vvr_tpu_torch.ops.raygen import camera_rays
from vvr_tpu_torch.render.scene import build_scene
from vvr_tpu_torch.tools import (frame_digest, lane_use, profile_frame,
                                 profile_gather, sass_count)
from vvr_tpu_torch.utils.camera import Camera

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
    stores, calls; other kernels are left out."""
    listing = """
        Function : _ZN12_GLOBAL__N_114vvr_sky_kernelEv
        /*0000*/                   LDC R1, c[0x0][0x28] ;   /* 0x0000 */
        /*0010*/                   MUFU.RSQ R5, R4 ;        /* 0x0000 */
        /*0020*/              @!P0 MUFU.EX2 R5, R4 ;        /* 0x0000 */
        /*0030*/               @P1 CALL.REL.NOINC 0x100 ;  /* 0x0000 */
        /*0040*/                   STL [R1], R2 ;           /* 0x0000 */
        /*0050*/                   LDL R3, [R1] ;           /* 0x0000 */
        Function : _Z5otherv
        /*0000*/                   MUFU.RCP R5, R4 ;        /* 0x0000 */
"""
    got = sass_count.count(listing, ["vvr_sky_kernel"])
    assert got == {"_ZN12_GLOBAL__N_114vvr_sky_kernelEv": {
        "instructions": 6, "mufu": {"EX2": 1, "RSQ": 1}, "local_loads": 1,
        "local_stores": 1, "calls": 1}}


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
