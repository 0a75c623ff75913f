"""The port's measurement script: its interval arithmetic, and that it
refuses to run without a CUDA device (the CPU is never measured as the
card)."""

import hashlib
import sys

import numpy as np
import pytest
import torch

from vvr_tpu_torch.tools import frame_digest, profile_frame


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


def test_frame_digest_hashes_the_bytes():
    """The digest is the SHA-256 of the tensor's bytes in row-major order,
    so a view with other strides hashes as its contiguous copy."""
    x = torch.arange(24, dtype=torch.float32).reshape(2, 3, 4)
    want = hashlib.sha256(np.ascontiguousarray(
        x.permute(2, 0, 1).numpy()).tobytes()).hexdigest()
    assert frame_digest.digest(x.permute(2, 0, 1)) == want
    assert frame_digest.digest(x) != want
