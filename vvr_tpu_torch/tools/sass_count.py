"""Static instruction counts of the port's compiled kernels, from their
SASS, on the machine with the CUDA toolkit.

    python3 vvr_tpu_torch/tools/sass_count.py [--root DIR] [PART ...]
    python3 vvr_tpu_torch/tools/sass_count.py --probe [--root DIR]

Builds the library of the vvr_tpu_torch package found under DIR (default:
this checkout), disassembles it with the toolkit's cuobjdump, and prints
one JSON line per kernel whose mangled name contains one of the PARTs
(default: K3's and K8's kernels): its instructions in all, the
special-function (MUFU) instructions by kind, local-memory loads and
stores (LDL, STL), and calls (CALL: the slow paths of IEEE division and
square root). The counts are static: every instruction of the kernel's
code once, taken or not, so they bound the work of one thread's path
from above and say which MUFU kinds a source line becomes.

--probe compiles, with the package's flags, one small kernel per device
function that K3's texels call (PROBES: expf, sqrtf, the IEEE division,
powf at the two exponents K3 uses, and csrc/sky.cu's scaled_depth,
common.cuh's vvr_sdnoise2 and vvr_hash12) and prints each one's fast
path: the instructions before its first unconditional EXIT (the slow
paths of division and square root sit after it), less those of a probe
that only loads and stores. `fp32_ops` counts floating-point operations
as the float32 peak rate counts them: an FFMA two, every other F-class
instruction (FADD, FMUL, FMNMX, FSETP, FSEL, FRND, FCHK, ...) one.
It exits non-zero without nvcc's toolkit.
"""

from __future__ import annotations

import argparse
import collections
import json
import pathlib
import re
import subprocess
import sys

PARTS = ("rows_kernel", "skybox_kernel", "clouds_kernel", "vvr_sky_kernel")
_INSN = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)")


def count(sass: str, parts) -> dict[str, dict]:
    """{mangled kernel name: counts} for the kernels of `sass` (cuobjdump
    -sass output) whose name contains one of `parts`."""
    out, name, ops = {}, None, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            ops = (collections.Counter()
                   if any(p in name for p in parts) else None)
            if ops is not None:
                out[name] = ops
            continue
        m = _INSN.search(line) if ops is not None else None
        if m:
            ops[m.group(1)] += 1
    result = {}
    for name, ops in out.items():
        result[name] = {
            "instructions": sum(ops.values()),
            "mufu": {k.split(".", 1)[1]: v for k, v in sorted(ops.items())
                     if k.startswith("MUFU.")},
            "local_loads": sum(v for k, v in ops.items()
                               if k.startswith("LDL")),
            "local_stores": sum(v for k, v in ops.items()
                                if k.startswith("STL")),
            "calls": sum(v for k, v in ops.items() if k.startswith("CALL")),
        }
    return result


# one kernel per device function: a body that reads a[] and writes o[]
PROBES = {
    "base": "o[0] = a[0];",
    "expf": "o[0] = expf(a[0]);",
    "sqrtf": "o[0] = sqrtf(a[0]);",
    "division": "o[0] = a[0] / a[1];",
    "powf_1.5": "o[0] = powf(a[0], 1.5f);",
    "powf_4": "o[0] = powf(a[0], 4.0f);",
    "scaled_depth": "const V3 r = scaled_depth(v3(a[0], a[1], a[2]), "
                    "v3(a[3], a[4], a[5])); o[0] = r.x; o[1] = r.y; "
                    "o[2] = r.z;",
    "vvr_sdnoise2": "float v, gx, gy; vvr_sdnoise2(a[0], a[1], "
                    "__float_as_uint(a[2]), &v, &gx, &gy); o[0] = v; "
                    "o[1] = gx; o[2] = gy;",
    "vvr_hash12": "o[0] = vvr_hash12(a[0], a[1]);",
}


def probe_source() -> str:
    """C++ of the probes; it includes csrc/sky.cu for its device
    functions."""
    out = ['#include "sky.cu"']
    for i, body in enumerate(PROBES.values()):
        out.append(f'extern "C" __global__ void probe_{i}('
                   f"const float* __restrict__ a, float* __restrict__ o) "
                   f"{{ {body} }}")
    return "\n".join(out) + "\n"


def fast_path(sass: str) -> dict[str, collections.Counter]:
    """{mangled kernel name: opcode counts} of each kernel's instructions
    before its first unconditional EXIT."""
    out, ops = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            ops = out.setdefault(line.split("Function :")[1].strip(),
                                 collections.Counter())
            continue
        m = _INSN.search(line) if ops is not None else None
        if not m:
            continue
        if m.group(1) == "EXIT" and not re.search(r"\*/\s+@", line):
            ops = None
            continue
        ops[m.group(1)] += 1
    return out


def fp32_ops(ops: collections.Counter) -> int:
    """Floating-point operations: FFMA two, other F-class one."""
    return sum((2 if k.startswith("FFMA") else 1) * v
               for k, v in ops.items()
               if k[0] == "F" and not k.startswith(("F2", "FLO")))


def probe(kernels, nvcc: pathlib.Path) -> list[dict]:
    """Build the probes with the package's flags and count each one's fast
    path, less the base probe's."""
    out_dir = kernels.BUILD_DIR / "sass_probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "probe.cu"
    src.write_text(probe_source())
    cubin = out_dir / "probe.cubin"
    subprocess.run([str(nvcc), *kernels.NVCC_FLAGS, f"-I{kernels.CSRC}",
                    "-cubin", "-o", str(cubin), str(src)], check=True,
                   capture_output=True, text=True, timeout=600)
    sass = subprocess.run([str(nvcc.parent / "cuobjdump"), "-sass",
                           str(cubin)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    paths = fast_path(sass)
    by_index = {}
    for name, ops in paths.items():
        m = re.fullmatch(r"probe_(\d+)", name)
        if m:
            by_index[int(m.group(1))] = ops
    base = by_index[0]
    rows = []
    for i, name in enumerate(PROBES):
        if i == 0:
            continue
        ops = by_index[i] - base
        rows.append({"probe": name, "fp32_ops": fp32_ops(ops),
                     "instructions": sum(ops.values()),
                     "mufu": {k.split(".", 1)[1]: v
                              for k, v in sorted(ops.items())
                              if k.startswith("MUFU.")},
                     "opcodes": dict(sorted(ops.items()))})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", type=pathlib.Path,
                    default=pathlib.Path(__file__).resolve().parents[2],
                    help="the checkout whose vvr_tpu_torch is compiled")
    ap.add_argument("--probe", action="store_true",
                    help="count the fast path of K3's device functions")
    ap.add_argument("parts", nargs="*", default=list(PARTS))
    args = ap.parse_args(argv)
    root = args.root.resolve()
    sys.path.insert(0, str(root))
    from vvr_tpu_torch import kernels
    try:
        nvcc = pathlib.Path(kernels._nvcc())
    except RuntimeError as err:
        print(f"sass_count: {err}", file=sys.stderr)
        return 1
    if args.probe:
        print(f"fast paths of K3's device functions (the vvr_tpu_torch of "
              f"{root}), less a load and a store")
        for row in probe(kernels, nvcc):
            print(json.dumps(row))
        return 0
    lib = kernels.build()
    sass = subprocess.run([str(nvcc.parent / "cuobjdump"), "-sass",
                           str(lib)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    print(f"SASS of {lib.name} (the vvr_tpu_torch of {root})")
    for name, counts in count(sass, args.parts).items():
        print(json.dumps({"kernel": name, **counts}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
