"""Build, load and launch the port's hand-written CUDA kernels.

Each csrc/*.cu is compiled by its own nvcc process, all started together,
and the objects are linked into one shared library with a plain C
interface, loaded with ctypes (no PyTorch headers, so the build takes
seconds). The library is built at first use into build/vvr_tpu_torch/ at
the repository root, named by a hash of the sources and flags, so an
edited source rebuilds and an unchanged one loads the cached file.

FMA contraction is off (-fmad=false): the block-colour hash and the DDA's
`floor(o + d*t)` must round exactly as the JAX package and the oracle do.
Fast math is never used.

Each C entry point launches on the stream it is given and returns
cudaGetLastError(); `launch` raises if that is not 0 and counts the launch
in LAUNCHES. Nothing here falls back to another path.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess

import torch

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = (pathlib.Path(__file__).resolve().parents[1] / "build"
             / "vvr_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC")
# each source's compile also reports its kernels' registers and spills,
# kept beside the library (ptxas_usage)
PTXAS_VERBOSE = ("-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


@dataclasses.dataclass(frozen=True)
class Kernel:
    symbol: str        # C entry point
    argtypes: tuple    # ctypes argument types, the stream last
    source: str        # file in the repository
    replaces: str      # JAX pass or Pallas kernel it ports, file:line
    path: str = "frame"  # the entry point that runs it: frame or gather


KERNELS = {
    "jump_trace": Kernel(
        "vvr_jump_trace", (_P, _I, _P, _P, _I, _P, _I, _I, _I) + (_P,) * 7
        + (_P,),
        "vvr_tpu_torch/csrc/jump_trace.cu", "vvr_tpu/ops/jump.py:289"),
    "shade_surface": Kernel(
        "vvr_shade_surface", (_P, _P, _P, _P, _P, _I, _F, _F, _F, _P, _P, _P),
        "vvr_tpu_torch/csrc/shade.cu", "vvr_tpu/render/frame.py:192"),
    "shade_pixel": Kernel(
        "vvr_shade_pixel",
        (_P, _P, _P, _P, _P, _P, _I, _I, _P, _I, _P, _I) + (_F,) * 6
        + (_P, _P),
        "vvr_tpu_torch/csrc/shade.cu", "vvr_tpu/render/frame.py:192"),
    "write_skybox": Kernel(
        "vvr_write_skybox", (_F, _F, _F, _I, _P, _P),
        "vvr_tpu_torch/csrc/sky.cu", "vvr_tpu/ops/sky.py:285"),
    "write_clouds": Kernel(
        "vvr_write_clouds", (_F, _F, _F, _F, _I, _P, _P),
        "vvr_tpu_torch/csrc/sky.cu", "vvr_tpu/ops/sky.py:193"),
    "bloom_pyramid": Kernel(
        "vvr_bloom_pyramid", (_P, _I, _I, _I, _P, _P),
        "vvr_tpu_torch/csrc/post.cu", "vvr_tpu/ops/post.py:146"),
    "composite": Kernel(
        "vvr_composite", (_P, _I, _I, _P, _I, _I, _F, _I, _P, _I, _I, _P),
        "vvr_tpu_torch/csrc/post.cu", "vvr_tpu/ops/post.py:205"),
    "raster_fragments": Kernel(
        "vvr_raster_fragments",
        (_P,) * 7 + (_I,) + (_F,) * 14 + (_I, _I) + (_P,) * 4 + (_P,),
        "vvr_tpu_torch/csrc/raster.cu", "vvr_tpu/ops/rastertrace.py:190"),
    "raster_resolve": Kernel(
        "vvr_raster_resolve",
        (_P, _P, _F, _F, _F, _I, _I, _I, _P, _P, _P, _P, _P),
        "vvr_tpu_torch/csrc/raster.cu", "vvr_tpu/ops/rastertrace.py:190"),
    "sun_grids": Kernel(
        "vvr_sun_grids", (_P,) * 8 + (_I,) + (_F,) * 12 + (_I, _P, _P, _P),
        "vvr_tpu_torch/csrc/sunshadow.cu", "vvr_tpu/ops/sunshadow.py:112"),
    "masked_shadow": Kernel(
        "vvr_masked_shadow",
        (_P, _I) + (_P,) * 7 + (_I,) + (_F,) * 9 + (_P, _I) + (_F,) * 4
        + (_I, _P, _P),
        "vvr_tpu_torch/csrc/sunshadow.cu", "vvr_tpu/ops/sunshadow.py:654"),
    "gather_chain": Kernel(
        "vvr_gather_chain", (_P, _I, _I, _P, _I, _P, _I, _P, _P),
        "vvr_tpu_torch/csrc/gather.cu",
        "tools/microbench_gather.py:92, tools/microbench_gather2.py:69",
        "gather"),
    "gather_chain_shared": Kernel(
        "vvr_gather_chain_shared", (_P, _I, _I, _P, _I, _P, _I, _P, _P),
        "vvr_tpu_torch/csrc/gather.cu", "tools/microbench_gather.py:133",
        "gather"),
    "gather_onehot": Kernel(
        "vvr_gather_onehot", (_P, _I, _I, _P, _I, _P, _I, _P, _P),
        "vvr_tpu_torch/csrc/gather.cu",
        "tools/microbench_gather.py:177, tools/microbench_gather2.py:112",
        "gather"),
    "gather_rows": Kernel(
        "vvr_gather_rows", (_P, _I, _I, _P, _I, _P, _P),
        "vvr_tpu_torch/csrc/gather.cu", "tools/microbench_gather.py:228",
        "gather"),
}

# launches of each kernel since the last reset_launches(); the wrappers
# count only here, at the launch
LAUNCHES = {name: 0 for name in KERNELS}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (pathlib.Path(cand) / "bin" / "nvcc").exists():
            return str(pathlib.Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (CUDA_HOME or /usr/local/cuda)")
    return found


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + PTXAS_VERBOSE).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libvvr_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds: list[list[str]]) -> list[str]:
    """Run the commands in parallel and return their outputs; raise with
    the output of each one that failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    errors, outs = [], []
    for cmd, proc in zip(cmds, procs):
        out, _ = proc.communicate()
        outs.append(out)
        if proc.returncode != 0:
            errors.append(f"nvcc failed ({proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{out}")
    if errors:
        raise RuntimeError("\n".join(errors))
    return outs


def build() -> pathlib.Path:
    """Compile csrc/*.cu into the shared library unless it is cached: one
    nvcc per source, all at once, then one link."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    nvcc = _nvcc()
    objs = []
    cmds = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        objs.append(obj)
        cmds.append([nvcc, *NVCC_FLAGS, *PTXAS_VERBOSE, f"-I{CSRC}", "-c",
                     "-o", str(obj), str(src)])
    try:
        report = _run_all(cmds)
        _ptxas_log(out).write_text("".join(report))
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                   *(str(o) for o in objs)]])
        tmp.replace(out)
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    return out


def _ptxas_log(lib: pathlib.Path) -> pathlib.Path:
    return lib.with_suffix(".ptxas.txt")


def ptxas_usage(part: str) -> list[tuple[str, int, int, int]]:
    """(mangled kernel name, registers, spill store bytes, spill load
    bytes; -1 where not reported) of each compiled kernel whose name
    contains `part`, from the `-Xptxas -v` report of this library's
    build."""
    out, name = [], None
    for line in _ptxas_log(library_path()).read_text().splitlines():
        if "Compiling entry function" in line:
            name, spills = line.split("'")[1], (-1, -1)
        elif name and "spill stores" in line:
            nums = [int(w) for w in line.replace(",", " ").split()
                    if w.isdigit()]
            spills = (nums[1], nums[2])
        elif name and "Used" in line and "registers" in line:
            regs = int(line.split("Used")[1].split()[0])
            if part in name:
                out.append((name, regs, *spills))
            name = None
    return out


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    for k in KERNELS.values():
        fn = getattr(lib, k.symbol)
        fn.argtypes = list(k.argtypes)
        fn.restype = ctypes.c_int
    lib.vvr_error_string.argtypes = [ctypes.c_int]
    lib.vvr_error_string.restype = ctypes.c_char_p
    return lib


def launch(name: str, device: torch.device, *args) -> None:
    """Launch kernel `name` on `device`'s current stream and count it;
    raises on a launch error. Pointer arguments are tensor.data_ptr() ints
    (0 for an absent optional input)."""
    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, KERNELS[name].symbol)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}: "
                           f"{lib.vvr_error_string(err).decode()}")
    LAUNCHES[name] += 1


def check_cuda(*tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor on one device
    (the kernels take raw pointers and index them densely)."""
    dev = tensors[0].device
    for t in tensors:
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"kernel input on {t.device}, expected {dev}")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")


def on_cuda(where) -> bool:
    """Dispatch rule of every wrapper, on a tensor's device or a device:
    CUDA launches the kernel, CPU runs the plain torch version, anything
    else raises."""
    dev = where.device if isinstance(where, torch.Tensor) \
        else torch.device(where)
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain path for device {dev}")
