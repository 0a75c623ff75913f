"""Device time of the gather kernels (K5-K8) beside torch.index_select, and
the host cost of K8's launch path piece by piece, on one NVIDIA GPU.

    python3 vvr_tpu_torch/tools/profile_gather.py [--root DIR] [--calls N]

It measures the vvr_tpu_torch package found under DIR (default: this
checkout), so one call can run it on an unpacked `git archive` of another
commit and on this one in turns. Prints, each from this run:

1. the registers and spills of K3's, K5's, K7's and K8's kernels
   (`-Xptxas -v`, from the library's build report);
2. K8 and torch.index_select at the two pallas_scalar shapes through the
   microbenchmark's own harness (microbench_gather.run: `ms` is CUDA
   events over back-to-back Python calls, so it carries the host's path),
   HARNESS_RUNS times;
3. device time per call from torch.profiler with CUDA activity only (and
   for K5 the bytes of the whole rows its chain fetches, 8 * lanes * row
   bytes, over that time: its rate through L1 and L2), a profiled window
   per experiment: K8 and index_select at both pallas_scalar shapes, and K5
   (pallas_take R32768xC16), K6 (pallas_vreg R1024) and K7 (pallas_onehot
   R4096xC2, u32) at the shapes of PERF.md's kernel table, and K7 at the
   other two one-hot shapes (R512xC16, R64xC2), CALLS calls each;
4. host microseconds per call (time.perf_counter_ns at a 64x2 table and
   32 indices, where device time is negligible; HOST_CALLS calls of each
   piece in ROUNDS rounds, the pieces in turns, and the median round) of
   the pieces of K8's path: the output's allocation (torch.empty with
   sizes as arguments, as the wrapper takes it, and idx.new_empty), the
   current device and raw stream reads, three data_ptr() reads,
   kernels.launch (the binding's call and the CUDA launch), and
   gather_rows whole (the checks are what it costs beyond the pieces),
   with index_select beside it.

It exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time

import torch

CALLS = 20            # launches per experiment in the profiled window
HOST_CALLS = 10_000   # calls per piece of the host path, over all rounds
ROUNDS = 5            # the pieces in turns, this many times; the median
HARNESS_RUNS = 3      # runs of the harness per pallas_scalar shape
SCALAR = ("pallas_scalar:R266305xC2", "pallas_scalar:R32768xC16")
# (experiment, kernel) rows of PERF.md's kernel table for K5-K7, and K7's
# other two shapes
OTHERS = (("pallas_take:R32768xC16", "gather_chain"),
          ("pallas_vreg:R1024", "gather_chain_shared"),
          ("pallas_onehot:R4096xC2", "gather_onehot"),
          ("pallas_onehot:R512xC16", "gather_onehot"),
          ("pallas_onehot:R64xC2", "gather_onehot"))
# K8's kernel in the profiler's trace (index_select's kernel depends on
# the shape: any name)
K8_NAME = "rows_kernel"
PTXAS_PARTS = ("rows_kernel", "skybox_kernel", "clouds_kernel",
               "vvr_sky_kernel", "chain_kernel", "onehot_kernel")


def host_us(fn, calls: int = HOST_CALLS) -> float:
    """Host microseconds per fn() over `calls` calls, after one warm-up
    call; the device is synchronized before the clock starts and after it
    stops."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter_ns()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter_ns()
    torch.cuda.synchronize()
    return (t1 - t0) / calls / 1e3


def device_window(plan, calls: int, tries: int = 3):
    """Run each (label, fn, name part) of `plan` `calls` times under
    torch.profiler (CUDA activity only), one profiled window per label,
    and return {label: device us per call}; each window must hold `calls`
    device kernels, each carrying its name part. The trace now and then
    misses a kernel event: such a window is run again, up to `tries`
    times, before it raises."""
    from torch.profiler import ProfilerActivity, profile
    out = {}
    for label, fn, part in plan:
        for attempt in range(tries):
            fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
            with tempfile.TemporaryDirectory() as tmp:
                path = pathlib.Path(tmp) / "trace.json"
                prof.export_chrome_trace(str(path))
                events = json.loads(path.read_text())["traceEvents"]
            kern = [e for e in events
                    if e.get("ph") == "X" and e.get("cat") == "kernel"]
            names = {e["name"] for e in kern}
            if len(kern) == calls and all(part in n for n in names):
                break
            if attempt == tries - 1:
                raise AssertionError(f"{label}: {len(kern)} device kernels "
                                     f"{sorted(names)}, expected {calls} "
                                     f"of '{part}'")
        out[label] = sum(e["dur"] for e in kern) / calls
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", type=pathlib.Path,
                    default=pathlib.Path(__file__).resolve().parents[2],
                    help="the checkout whose vvr_tpu_torch is measured")
    ap.add_argument("--calls", type=int, default=HOST_CALLS,
                    help="calls per piece of the host path")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_gather: no CUDA device", file=sys.stderr)
        return 1
    root = args.root.resolve()
    sys.path.insert(0, str(root))
    from vvr_tpu_torch import kernels
    from vvr_tpu_torch.ops import gather
    from vvr_tpu_torch.tools import microbench_gather as mb
    print(f"measuring the vvr_tpu_torch of {root}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
         "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"nvidia-smi (name, power limit, SM clock, max SM clock): {smi}")
    dev = torch.device("cuda", 0)
    kernels.build()

    # ---- 1. registers and spills
    for part in PTXAS_PARTS:
        for name, regs, st, ld in kernels.ptxas_usage(part):
            print(f"ptxas: {name}: {regs} registers, spill stores {st} B, "
                  f"spill loads {ld} B")

    # ---- 2. the microbenchmark's harness
    exps = {e.name: e for e in mb.EXPERIMENTS}
    for _ in range(HARNESS_RUNS):
        for name in SCALAR:
            line = mb.run(exps[name], 0, dev)
            print("harness " + json.dumps(
                {k: line[k] for k in ("name", "ms", "library_ms",
                                      "plain_ms", "bound_ms")}))

    # ---- 3. device time, one profiled window
    plan = []
    for name in SCALAR:
        table, idx = mb.make_inputs(exps[name], 0, dev)
        t32 = table.view(torch.int32)
        plan.append((f"K8 gather_rows {name}",
                     lambda t=table, i=idx: gather.gather_rows(t, i),
                     K8_NAME))
        plan.append((f"index_select {name}",
                     lambda t=t32, i=idx: torch.index_select(t, 0, i),
                     ""))
    row_bytes = {}
    for name, kernel in OTHERS:
        table, idx = mb.make_inputs(exps[name], 0, dev)
        arg = gather.u8_planes(table) if kernel == "gather_onehot" else table
        fn = getattr(gather, kernel)
        label = f"{kernel} {name}"
        plan.append((label, lambda f=fn, a=arg, i=idx: f(a, i), ""))
        if kernel == "gather_chain":
            row_bytes[label] = mb.CHAIN * idx.numel() * table[0].nbytes
    for label, us in device_window(plan, CALLS).items():
        extra = ""
        if label in row_bytes:   # the whole rows the chain fetches
            extra = (f"; rows fetched {row_bytes[label]} B, "
                     f"{row_bytes[label] / us / 1e6:.3f} TB/s")
        print(f"device {label}: {us:.3f} us per call{extra}")

    # ---- 4. host microseconds per piece of K8's path, a tiny shape
    gen = torch.Generator(device=dev).manual_seed(0)
    table = torch.randint(0, 1 << 30, (64, 2), generator=gen, device=dev,
                          dtype=torch.int32).view(torch.uint32)
    idx = torch.randint(0, 64, (32,), generator=gen, device=dev,
                        dtype=torch.int32)
    t32 = table.view(torch.int32)
    out = torch.empty((32, 2), dtype=torch.uint32, device=dev)
    cargs = (table.data_ptr(), 64, 2, idx.data_ptr(), 32, out.data_ptr())
    pieces = {
        "torch.empty, sizes as arguments (the output)": lambda: torch.empty(
            32, 2, dtype=torch.uint32, device=dev),
        "idx.new_empty, a size tuple": lambda: idx.new_empty(
            (32, 2), dtype=torch.uint32),
        "torch._C._cuda_getDevice()": torch._C._cuda_getDevice,
        "torch._C._cuda_getCurrentRawStream(index)":
            lambda: torch._C._cuda_getCurrentRawStream(0),
        "three data_ptr()": lambda: (table.data_ptr(), idx.data_ptr(),
                                     out.data_ptr()),
        "kernels.launch (launches K8)": lambda: kernels.launch(
            "gather_rows", dev, *cargs),
        "gather.gather_rows (whole)": lambda: gather.gather_rows(table, idx),
        "torch.index_select (whole)": lambda: torch.index_select(t32, 0, idx),
    }
    times = {label: [] for label in pieces}
    for _ in range(ROUNDS):
        for label, piece in pieces.items():
            times[label].append(host_us(piece, args.calls // ROUNDS))
    for label, us in times.items():
        print(f"host {label}: {statistics.median(us):.3f} us per call, "
              f"median of {ROUNDS} rounds of {args.calls // ROUNDS} "
              f"(rounds {' '.join(f'{u:.2f}' for u in us)})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
