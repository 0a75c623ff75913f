"""kernels.launch, the one path by which every wrapper launches a CUDA
kernel, on the CPU: a stub binding stands for the built library, a stub stream
reader and a stub current device for torch's CUDA calls. It passes the
arguments in order with the current stream of the tensor's device last,
counts a launch only when the entry point returns 0, raises with the
kernel's name otherwise, and makes another device current (or raises)
before it launches there."""

import contextlib
import ctypes

import pytest
import torch

from vvr_tpu_torch import kernels

# one intra-op thread: the suite runs six pytest workers on eight cores
torch.set_num_threads(1)


class StubBinding:
    def error_string(self, err):
        return f"stub error {err}"


@pytest.fixture
def stub(monkeypatch):
    """A stub entry point for every kernel; returns (calls, codes): each
    call appends (name, args, current device), and codes[name] is what the
    stub returns."""
    state = {"current": 0}
    calls, codes = [], {}

    def entry(name):
        def fn(*args):
            calls.append((name, args, state["current"]))
            return codes.get(name, 0)
        return fn

    fns = {name: entry(name) for name in kernels.KERNELS}
    monkeypatch.setattr(kernels, "_entry_points", lambda: fns)
    monkeypatch.setattr(kernels, "_binding", StubBinding)
    # torch's CUDA stream reader and current device (absent from a CPU
    # build of torch)
    monkeypatch.setattr(torch._C, "_cuda_getDevice",
                        lambda: state["current"], raising=False)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: 7000 + index, raising=False)
    monkeypatch.setattr(kernels, "LAUNCHES",
                        {name: 0 for name in kernels.KERNELS})

    @contextlib.contextmanager
    def device(index):
        before, state["current"] = state["current"], index
        try:
            yield
        finally:
            state["current"] = before

    monkeypatch.setattr(torch.cuda, "device", device)
    return calls, codes


def test_arguments_in_order_with_the_stream_last(stub):
    calls, _ = stub
    kernels.launch("gather_rows", torch.device("cuda", 0), 11, 2, 3.5, 0)
    assert calls == [("gather_rows", (11, 2, 3.5, 0, 7000), 0)]


def test_a_zero_return_counts_one_launch(stub):
    kernels.launch("write_sky", torch.device("cuda", 0), 1, 2)
    kernels.launch("write_sky", torch.device("cuda", 0), 1, 2)
    assert kernels.LAUNCHES["write_sky"] == 2
    assert sum(kernels.LAUNCHES.values()) == 2


def test_a_nonzero_return_raises_and_is_not_counted(stub):
    _, codes = stub
    codes["jump_trace"] = 98
    with pytest.raises(RuntimeError, match=r"jump_trace: CUDA error 98: "
                                           r"stub error 98"):
        kernels.launch("jump_trace", torch.device("cuda", 0), 1)
    assert kernels.LAUNCHES["jump_trace"] == 0


def test_another_device_is_made_current_for_the_launch(stub):
    """The stream is read for the tensor's device, and the entry point runs
    with that device current; the caller's current device comes back."""
    calls, _ = stub
    kernels.launch("composite", torch.device("cuda", 1), 5)
    assert calls == [("composite", (5, 7001), 1)]
    assert torch._C._cuda_getDevice() == 0
    kernels.launch("composite", torch.device("cuda"), 6)  # the current one
    assert calls[-1] == ("composite", (6, 7000), 0)


def test_another_device_that_cannot_be_entered_raises(stub, monkeypatch):
    """Where the device cannot be made current, nothing is launched on the
    current one instead."""
    calls, _ = stub

    def refuse(index):
        raise RuntimeError(f"no device {index}")

    monkeypatch.setattr(torch.cuda, "device", refuse)
    with pytest.raises(RuntimeError, match="no device 1"):
        kernels.launch("bloom_pyramid", torch.device("cuda", 1), 5)
    assert calls == [] and kernels.LAUNCHES["bloom_pyramid"] == 0


def test_every_entry_point_takes_the_stream_last():
    for name, k in kernels.KERNELS.items():
        assert k.argtypes[-1] is ctypes.c_void_p, name
        assert k.symbol.startswith("vvr_"), name


def test_the_binding_has_a_launcher_per_kernel():
    """The generated CPython binding declares each entry point with its
    argument types, and its launcher for it takes exactly those arguments
    (the stream last) and converts each by its type."""
    src = kernels.binding_source()
    spell = {ctypes.c_void_p: ("void*", "as_ptr"),
             ctypes.c_int: ("int", "as_int"),
             ctypes.c_float: ("float", "as_float")}
    for name, k in kernels.KERNELS.items():
        c = [spell[t] for t in k.argtypes]
        assert (f'extern "C" int {k.symbol}({", ".join(t for t, _ in c)});'
                in src), name
        assert f"if (n != {len(c)})" in src.split(f"k_{name}(")[1], name
        conv = " || ".join(f"!{f}(a[{i}], &a{i})"
                           for i, (_, f) in enumerate(c))
        assert f"    if ({conv}) return nullptr;" in src, name
        assert f'{{"{name}", (PyCFunction)' in src, name
    assert f"PyInit_{kernels.MODULE}(void)" in src
