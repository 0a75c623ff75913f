"""Build, load and launch the port's hand-written CUDA kernels.

Each csrc/*.cu is compiled by its own nvcc process, all started together,
and the objects are linked into one shared library with a plain C
interface (no PyTorch headers, so the build takes seconds). Beside them
the library holds a small CPython binding generated from KERNELS: one C
function per kernel that converts its Python numbers and calls the entry
point, so a launch costs one call from Python and no ctypes call frame.
The library is built at first use into build/vvr_tpu_torch/ at the
repository root, named by a hash of the sources, the binding, the flags
and the interpreter, so an edited source rebuilds and an unchanged one
loads the cached file; it is imported as the extension module
`vvr_launch`.

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
import importlib.util
import os
import pathlib
import shutil
import subprocess
import sysconfig

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
_U64, _D = ctypes.c_uint64, ctypes.c_double


@dataclasses.dataclass(frozen=True)
class Kernel:
    symbol: str        # C entry point
    argtypes: tuple    # its argument types (pointer, int, float, uint64,
    #                    double as ctypes types), the stream last
    source: str        # file in the repository
    replaces: str      # JAX pass or Pallas kernel it ports, file:line
    path: str = "frame"  # the entry point that runs it: frame, gather,
    #                      overlap (the overlap AO library) or setup


KERNELS = {
    "jump_trace": Kernel(
        "vvr_jump_trace", (_P, _I, _P, _P, _I, _P, _I, _I, _I) + (_P,) * 7
        + (_P,),
        "vvr_tpu_torch/csrc/trace.cu", "vvr_tpu/ops/jump.py:289"),
    "shade_surface": Kernel(
        "vvr_shade_surface",
        (_P, _P, _P, _P, _P, _I, _F, _F, _F, _I, _P, _P, _P),
        "vvr_tpu_torch/csrc/shade.cu", "vvr_tpu/render/frame.py:192"),
    "shade_pixel": Kernel(
        "vvr_shade_pixel",
        (_P, _P, _P, _P, _P, _P, _P, _I, _I, _P, _I, _P, _I) + (_F,) * 6
        + (_I, _P, _P),
        "vvr_tpu_torch/csrc/shade.cu", "vvr_tpu/render/frame.py:192"),
    "write_sky": Kernel(
        "vvr_write_sky", (_F, _F, _F, _F, _I, _I, _P, _P, _P),
        "vvr_tpu_torch/csrc/sky.cu",
        "vvr_tpu/ops/sky.py:285, vvr_tpu/ops/sky.py:193"),
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
        "vvr_sun_grids",
        (_P,) * 8 + (_I,) + (_F,) * 12 + (_I, _I, _I, _F, _F, _P, _P,
                                          _P),
        "vvr_tpu_torch/csrc/sunshadow.cu", "vvr_tpu/ops/sunshadow.py:112"),
    "masked_shadow": Kernel(
        "vvr_masked_shadow",
        (_P, _I) + (_P,) * 7 + (_I,) + (_F,) * 9 + (_P, _I) + (_F,) * 4
        + (_I, _P, _P),
        "vvr_tpu_torch/csrc/sunshadow.cu", "vvr_tpu/ops/sunshadow.py:654"),
    "generate_rays": Kernel(
        "vvr_generate_rays", (_F,) * 14 + (_I, _I, _P, _P, _P),
        "vvr_tpu_torch/csrc/raygen.cu", "vvr_tpu/ops/raygen.py:37"),
    "soft_shadow": Kernel(
        "vvr_soft_shadow",
        (_P, _I, _P, _P, _P, _P, _P, _I, _I, _F, _F, _F, _I, _I, _P, _I,
         _I) + (_F,) * 6 + (_P, _I, _F, _F, _F, _P, _P, _P),
        "vvr_tpu_torch/csrc/softshadow.cu", "vvr_tpu/render/frame.py:308"),
    "shade_bounce": Kernel(
        "vvr_shade_bounce",
        (_P, _I) + (_P,) * 9 + (_I, _P, _I, _P, _I) + (_F,) * 6
        + (_I, _P, _I, _P, _I, _I, _I, _I, _F) + (_P,) * 5 + (_P,),
        "vvr_tpu_torch/csrc/bounce.cu", "vvr_tpu/render/frame.py:192"),
    "paged_trace": Kernel(
        "vvr_paged_trace", (_P, _P, _I, _I, _P, _P, _I, _P, _I, _I, _I)
        + (_P,) * 7 + (_P,),
        "vvr_tpu_torch/csrc/trace.cu", "vvr_tpu/ops/paged.py:322"),
    # the paged grid's instantiations of the kernels that trace inline
    # (csrc/grid_view.cuh): the arguments of the jump-grid entry, with the
    # grid's (rows, size) replaced by (page table, pool, size, page edge)
    "masked_shadow_paged": Kernel(
        "vvr_masked_shadow_paged",
        (_P, _P, _I, _I) + (_P,) * 7 + (_I,) + (_F,) * 9 + (_P, _I)
        + (_F,) * 4 + (_I, _P, _P),
        "vvr_tpu_torch/csrc/sunshadow.cu",
        "vvr_tpu/ops/sunshadow.py:654, vvr_tpu/ops/paged.py:322"),
    "soft_shadow_paged": Kernel(
        "vvr_soft_shadow_paged",
        (_P, _P, _I, _I, _P, _P, _P, _P, _P, _I, _I, _F, _F, _F, _I, _I, _P,
         _I, _I) + (_F,) * 6 + (_P, _I, _F, _F, _F, _P, _P, _P),
        "vvr_tpu_torch/csrc/softshadow.cu",
        "vvr_tpu/render/frame.py:308, vvr_tpu/ops/paged.py:322"),
    "shade_bounce_paged": Kernel(
        "vvr_shade_bounce_paged",
        (_P, _P, _I, _I) + (_P,) * 9 + (_I, _P, _I, _P, _I) + (_F,) * 6
        + (_I, _P, _I, _P, _I, _I, _I, _I, _F) + (_P,) * 5 + (_P,),
        "vvr_tpu_torch/csrc/bounce.cu",
        "vvr_tpu/render/frame.py:192, vvr_tpu/ops/paged.py:322"),
    "pyramid_trace": Kernel(
        "vvr_pyramid_trace", (_P, _I, _I, _I, _P, _P, _I, _P, _I, _I, _I)
        + (_P,) * 7 + (_P,),
        "vvr_tpu_torch/csrc/trace.cu", "vvr_tpu/ops/traverse.py:406"),
    # the brick pyramid's instantiations of the kernels that trace inline:
    # the jump-grid entry's arguments with (rows, size) replaced by the
    # pyramid's (rows, size, depth)
    "masked_shadow_pyramid": Kernel(
        "vvr_masked_shadow_pyramid",
        (_P, _I, _I) + (_P,) * 7 + (_I,) + (_F,) * 9 + (_P, _I)
        + (_F,) * 4 + (_I, _P, _P),
        "vvr_tpu_torch/csrc/sunshadow.cu",
        "vvr_tpu/ops/sunshadow.py:654, vvr_tpu/ops/traverse.py:406"),
    "soft_shadow_pyramid": Kernel(
        "vvr_soft_shadow_pyramid",
        (_P, _I, _I, _P, _P, _P, _P, _P, _I, _I, _F, _F, _F, _I, _I, _P,
         _I, _I) + (_F,) * 6 + (_P, _I, _F, _F, _F, _P, _P, _P),
        "vvr_tpu_torch/csrc/softshadow.cu",
        "vvr_tpu/render/frame.py:308, vvr_tpu/ops/traverse.py:406"),
    "shade_bounce_pyramid": Kernel(
        "vvr_shade_bounce_pyramid",
        (_P, _I, _I) + (_P,) * 9 + (_I, _P, _I, _P, _I) + (_F,) * 6
        + (_I, _P, _I, _P, _I, _I, _I, _I, _F) + (_P,) * 5 + (_P,),
        "vvr_tpu_torch/csrc/bounce.cu",
        "vvr_tpu/render/frame.py:192, vvr_tpu/ops/traverse.py:406"),
    # the overlap AO library on the pyramid (ops/overlap.py); the frame's
    # overlap AO runs inside K15
    "overlap_density": Kernel(
        "vvr_overlap_density", (_P, _I, _I, _P, _P, _P, _I, _I, _F, _I, _F,
                                _P, _P),
        "vvr_tpu_torch/csrc/overlap.cu",
        "vvr_tpu/ops/overlap.py:62, :81, :117", "overlap"),
    # the debug heatmaps (render/frame.py)
    "debug_image": Kernel(
        "vvr_debug_image", (_P, _P, _P, _P, _P, _P, _I, _I, _P),
        "vvr_tpu_torch/csrc/debug.cu", "vvr_tpu/render/frame.py:701"),
    # the raster debug view (render/raster.py): the mesh's z-buffer, then
    # each pixel's fragment shadow or sky
    "raster_triangles": Kernel(
        "vvr_raster_triangles", (_P, _I, _P, _I, _P, _I, _P, _I)
        + (_F,) * 12 + (_I, _I, _P, _P, _P, _P),
        "vvr_tpu_torch/csrc/meshraster.cu",
        "vvr_tpu/render/raster.py:118, :234"),
    "shade_raster": Kernel(
        "vvr_shade_raster", (_P, _I, _P, _I, _P, _P, _I, _P, _P, _I, _I, _I,
                             _F, _F, _F, _P, _F, _F, _F, _P, _I, _P, _I, _P,
                             _P),
        "vvr_tpu_torch/csrc/meshraster.cu", "vvr_tpu/render/raster.py:262"),
    # the dynamic world's kernels (world/bricks.py, ops/sunshadow.py): the
    # update pass on one brick a frame, the sun grids' repair an edit
    "svt_update_brick": Kernel(
        "vvr_svt_update_brick", (_P, _I, _I, _I, _I, _I, _P, _P),
        "vvr_tpu_torch/csrc/svt.cu", "vvr_tpu/world/bricks.py:94"),
    "invalidate_texels": Kernel(
        "vvr_invalidate_texels", (_P, _I, _P, _I) + (_D,) * 10 + (_P, _P, _P),
        "vvr_tpu_torch/csrc/sunshadow.cu", "vvr_tpu/ops/sunshadow.py:460"),
    # setup from cold (world/generator.py): the terrain's height field
    "height_field": Kernel(
        "vvr_height_field", (_P, _I, _I, _I) + (_F,) * 6 + (_I,) + (_F,) * 3
        + (_P,),
        "vvr_tpu_torch/csrc/terrain.cu", "vvr_tpu/world/generator.py:29",
        "setup"),
    "gather_chain": Kernel(
        "vvr_gather_chain", (_P, _I, _I, _P, _I, _P, _I, _P, _U64, _P),
        "vvr_tpu_torch/csrc/gather.cu",
        "tools/microbench_gather.py:92, tools/microbench_gather2.py:69",
        "gather"),
    "gather_chain_shared": Kernel(
        "vvr_gather_chain_shared", (_P, _I, _I, _P, _I, _P, _I, _P, _U64,
                                    _P),
        "vvr_tpu_torch/csrc/gather.cu", "tools/microbench_gather.py:133",
        "gather"),
    "gather_onehot": Kernel(
        "vvr_gather_onehot",
        (_P, _I, _I, _P, _I, _P, _I, _P, _I, _I, _I, _U64, _P),
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


# the CPython binding's C spelling and converter of each argument type
_C_ARGS = {_P: ("void*", "as_ptr"), _I: ("int", "as_int"),
           _F: ("float", "as_float"), _D: ("double", "as_double"),
           _U64: ("unsigned long long", "as_u64")}
MODULE = "vvr_launch"
_BINDING_HEAD = """// generated by vvr_tpu_torch/kernels.py from KERNELS
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <climits>

static int as_ptr(PyObject* o, void** v) {
    *v = PyLong_AsVoidPtr(o);
    return !(*v == nullptr && PyErr_Occurred());
}
static int as_int(PyObject* o, int* v) {
    const long x = PyLong_AsLong(o);
    if (x == -1 && PyErr_Occurred()) return 0;
    if (x < INT_MIN || x > INT_MAX) {
        PyErr_SetString(PyExc_OverflowError,
                        "kernel argument outside the C int range");
        return 0;
    }
    *v = (int)x;
    return 1;
}
static int as_u64(PyObject* o, unsigned long long* v) {
    *v = PyLong_AsUnsignedLongLong(o);
    return !(*v == (unsigned long long)-1 && PyErr_Occurred());
}
static int as_float(PyObject* o, float* v) {
    const double x = PyFloat_AsDouble(o);
    if (x == -1.0 && PyErr_Occurred()) return 0;
    *v = (float)x;
    return 1;
}
static int as_double(PyObject* o, double* v) {
    *v = PyFloat_AsDouble(o);
    return !(*v == -1.0 && PyErr_Occurred());
}
extern "C" const char* vvr_error_string(int err);
static PyObject* error_string(PyObject*, PyObject* arg) {
    const long e = PyLong_AsLong(arg);
    if (e == -1 && PyErr_Occurred()) return nullptr;
    return PyUnicode_FromString(vvr_error_string((int)e));
}
"""


def binding_source() -> str:
    """C++ of the CPython binding: for each kernel a METH_FASTCALL function
    `name(*args, stream)` that converts each argument as its ctypes type
    would (a pointer from an int, a C int with a range check, a float, an
    unsigned 64-bit int, a double) and returns the entry point's error
    code."""
    out = [_BINDING_HEAD]
    table = []
    for name, k in KERNELS.items():
        spell = [_C_ARGS[t] for t in k.argtypes]
        n = len(spell)
        out.append(f'extern "C" int {k.symbol}('
                   f'{", ".join(c for c, _ in spell)});')
        out.append(f"static PyObject* k_{name}(PyObject*, "
                   "PyObject* const* a, Py_ssize_t n) {")
        out.append(f"    if (n != {n}) return PyErr_Format(PyExc_TypeError, "
                   f'"{name} takes {n} arguments (%zd given)", n);')
        out += [f"    {c} a{i};" for i, (c, _) in enumerate(spell)]
        conv = " || ".join(f"!{f}(a[{i}], &a{i})"
                           for i, (_, f) in enumerate(spell))
        out.append(f"    if ({conv}) return nullptr;")
        out.append(f"    return PyLong_FromLong({k.symbol}("
                   f'{", ".join(f"a{i}" for i in range(n))}));')
        out.append("}")
        table.append(f'    {{"{name}", (PyCFunction)(void (*)(void))k_{name}'
                     ", METH_FASTCALL, nullptr},")
    out.append("static PyMethodDef methods[] = {")
    out += table
    out.append('    {"error_string", error_string, METH_O, nullptr},')
    out.append("    {nullptr, nullptr, 0, nullptr}};")
    out.append("static struct PyModuleDef module_def = {"
               f'PyModuleDef_HEAD_INIT, "{MODULE}", nullptr, -1, methods}};')
    out.append(f"PyMODINIT_FUNC PyInit_{MODULE}(void) {{ "
               "return PyModule_Create(&module_def); }")
    return "\n".join(out) + "\n"


def _python_include() -> str:
    inc = sysconfig.get_paths()["include"]
    if not (pathlib.Path(inc) / "Python.h").exists():
        raise RuntimeError(f"Python.h not found under {inc}: the kernels' "
                           "launch binding needs the interpreter's headers")
    return inc


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + PTXAS_VERBOSE).encode())
    h.update(binding_source().encode())
    h.update(str(sysconfig.get_config_var("EXT_SUFFIX")).encode())
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
    """Compile csrc/*.cu and the binding into the shared library unless it
    is cached: one nvcc per source, all at once, then one link."""
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
    binding = BUILD_DIR / f"{tag}.binding.cpp"
    binding.write_text(binding_source())
    objs.append(binding.with_suffix(".o"))
    cmds.append([nvcc, *NVCC_FLAGS, f"-I{_python_include()}", "-c", "-o",
                 str(objs[-1]), str(binding)])
    try:
        report = _run_all(cmds)
        _ptxas_log(out).write_text("".join(report[:-1]))
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                   *(str(o) for o in objs)]])
        tmp.replace(out)
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
        binding.unlink(missing_ok=True)
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
def _binding():
    """The library, built if need be, imported as the extension module
    MODULE."""
    spec = importlib.util.spec_from_file_location(MODULE, build())
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@functools.cache
def _entry_points() -> dict:
    """Each kernel's launcher in the binding, looked up once: it takes the
    kernel's arguments and the stream as Python numbers, keeps the GIL (as
    PyTorch's own launches do: the entry points only enqueue work) and
    returns the entry point's error code."""
    module = _binding()
    return {name: getattr(module, name) for name in KERNELS}


def launch(name: str, device: torch.device, *args) -> None:
    """Launch kernel `name` on `device`'s current stream and count it;
    raises on a launch error. Pointer arguments are tensor.data_ptr() ints
    (0 for an absent optional input).

    The C entry point launches on the current device, so `device` is made
    current first where it is not (a launch with another device's
    pointers fails with a non-zero code, which raises). The stream is the
    device's current one as a raw cudaStream_t, read as Triton's launcher
    reads it (torch._C._cuda_getCurrentRawStream) without building a
    torch.cuda.Stream; it is read at every launch, never cached, since a
    profiler, a side stream or a CUDA graph capture changes it."""
    fn = _entry_points()[name]
    index = device.index
    current = torch._C._cuda_getDevice()
    if index is None or index == current:
        err = fn(*args, torch._C._cuda_getCurrentRawStream(current))
    else:
        with torch.cuda.device(index):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}: "
                           f"{_binding().error_string(err)}")
    LAUNCHES[name] += 1


def check_cuda(*tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor on one device
    (the kernels take raw pointers and index them densely)."""
    dev = tensors[0].get_device()   # -1 off the card
    for t in tensors:
        if t.get_device() != dev or dev < 0:
            raise ValueError(f"kernel input on {t.device}, expected one "
                             f"CUDA device")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")


def on_cuda(where) -> bool:
    """Dispatch rule of every wrapper, on a tensor's device or a device:
    CUDA launches the kernel, CPU runs the plain torch version, anything
    else raises."""
    if isinstance(where, torch.Tensor):
        if where.is_cuda:
            return True
        dev = where.device
    else:
        dev = torch.device(where)
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain path for device {dev}")
