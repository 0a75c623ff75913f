"""The gather microbenchmark on one NVIDIA GPU: the counterpart of
tools/microbench_gather.py and tools/microbench_gather2.py.

    python3 -m vvr_tpu_torch.tools.microbench_gather [--seed S]

Runs every experiment of the two reference main()s, each Pallas kernel's
shapes and each xla_chain shape, at N = 2^21 lanes and a chain of 8
dependent gathers, through K5-K8 (ops/gather.py), on inputs made from
numpy.random.default_rng(seed): tables of words in [0, 2^30) as the
reference's make_table draws them, starting indices in [0, rows).

Prints a header line (card, power limit, versions), then one JSON line per
experiment under the reference's own name, with:
  kernel        the port's wrapper that ran it;
  ns_per_elem   kernel time / (N * CHAIN), per lane per gather, as the
                reference defines it (microbench_gather.py:48-52); per single
                gather for pallas_scalar, which is not chained;
  ms_per_round  kernel time / CHAIN (pallas_scalar: the one round);
  ms            kernel time per call: mean of CUDA events over repeated
                launches, after a warm-up launch (the table then sits in L2
                where it fits, as in a traversal that reuses it);
  bound_ms      the least time the card could take, the larger of bytes
                (indices, outputs, the table once) over 3.35 TB/s and
                operations over the peak for their type; bound_by says which;
  plain_ms      the plain torch version, same inputs, same card;
  library_ms    for K8, torch.index_select(table, 0, idx), one PyTorch call
                computing the same rows; null elsewhere.
Experiments whose table fits in a block's shared memory (pallas_take
R4096xC2, pallas_tala R1024xC8) also run K6 and report it under "shared".
Every kernel's output is held bit for bit against its plain version on
the same inputs before it is timed; a difference raises.

pallas_onehot:R4096xC2 is in both reference main()s (u32 and i32 output);
both lines are printed, told apart by "reference" and "out_dtype".

It exits 1 without a CUDA device: the CPU is never measured as the card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys

import numpy as np
import torch

from vvr_tpu_torch.ops import gather

N = 1 << 21
CHAIN = gather.CHAIN
KERNEL_REPS = 20
HBM_BYTES_PER_S = 3.35e12       # H100 SXM, NVIDIA's data sheet
PEAK_OPS_PER_S = {"bf16_tensor": 989e12, "fp32": 67e12}
# integer work of one chain step per lane (add, xor, mod), counted at the
# 32-bit non-tensor rate
CHAIN_OPS = 3

G1, G2 = "tools/microbench_gather.py", "tools/microbench_gather2.py"


@dataclasses.dataclass(frozen=True)
class Experiment:
    name: str             # the reference's JSON name
    reference: str        # the reference function, file:line
    kernel: str           # the wrapper in ops/gather.py
    rows: int
    cols: int             # 0: pallas_vreg's 1-D table
    sort: bool = False    # sorted starting indices (xla_sorted)
    out_dtype: str = "uint32"
    shared: bool = False  # also run K6

    @property
    def lanes(self) -> int:
        return N // 64 if self.kernel == "gather_rows" else N


def _xla(rows, cols, ref, **kw):
    return Experiment(f"xla{'_sorted' if kw.get('sort') else ''}:"
                      f"R{rows}xC{cols}", ref, "gather_chain", rows, cols,
                      **kw)


# the two reference main()s, in their order (microbench_gather.py:278-295,
# microbench_gather2.py:160-173)
EXPERIMENTS = (
    *(_xla(r, c, f"{G1}:67") for r, c in (
        (266305, 2), (266305, 4), (266305, 16), (32768, 16), (32768, 8),
        (4096, 2), (4096, 8), (266305, 32))),
    _xla(266305, 2, f"{G1}:67", sort=True),
    Experiment("pallas_vreg:R1024", f"{G1}:133", "gather_chain_shared",
               1024, 0),
    Experiment("pallas_take:R4096xC2", f"{G1}:92", "gather_chain", 4096, 2,
               shared=True),
    Experiment("pallas_take:R266305xC2", f"{G1}:92", "gather_chain",
               266305, 2),
    Experiment("pallas_take:R32768xC16", f"{G1}:92", "gather_chain",
               32768, 16),
    Experiment("pallas_onehot:R4096xC2", f"{G1}:177", "gather_onehot",
               4096, 2),
    Experiment("pallas_onehot:R64xC2", f"{G1}:177", "gather_onehot", 64, 2),
    Experiment("pallas_scalar:R266305xC2", f"{G1}:228", "gather_rows",
               266305, 2),
    Experiment("pallas_scalar:R32768xC16", f"{G1}:228", "gather_rows",
               32768, 16),
    *(_xla(r, c, f"{G2}:49") for r, c in (
        (512, 16), (32768, 32), (4096, 64), (2097152, 16), (65536, 16),
        (131072, 16))),
    Experiment("pallas_tala:R32768xC16", f"{G2}:69", "gather_chain",
               32768, 16),
    Experiment("pallas_tala:R1024xC8", f"{G2}:69", "gather_chain", 1024, 8,
               shared=True),
    Experiment("pallas_onehot:R4096xC2", f"{G2}:112", "gather_onehot",
               4096, 2, out_dtype="int32"),
    Experiment("pallas_onehot:R512xC16", f"{G2}:112", "gather_onehot",
               512, 16, out_dtype="int32"),
)

PLAIN = {"gather_chain": gather.gather_chain_plain,
         "gather_chain_shared": gather.gather_chain_plain,
         "gather_onehot": gather.gather_onehot_plain,
         "gather_rows": gather.gather_rows_plain}


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over `reps` runs after one warm-up run
    (CUDA events on the current stream)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: float, ops: float, peak: str) -> tuple[float, str]:
    """(least time in ms, "bytes" or "operations"): the larger of nbytes
    over the memory rate and ops over the peak rate `peak`."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / PEAK_OPS_PER_S[peak] * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def gather_bound(kernel: str, table, idx, out) -> tuple[float, str]:
    """The bound of one call. Each input is read once: a chain makes 8N
    fetches, at least 8 per table row at every reference shape, so it
    touches all but about e^-8 of the rows and the whole table counts;
    K8's single gather needs only the distinct rows it reads."""
    io = idx.nbytes + out.nbytes
    n = idx.shape[0]
    if kernel == "gather_onehot":
        rows, cols4 = table.shape
        return bound_ms(io + table.nbytes, 2.0 * n * rows * cols4 * CHAIN,
                        "bf16_tensor")
    if kernel == "gather_rows":
        used = int(torch.unique(idx).numel()) * table[0].nbytes
        return bound_ms(io + used, 0.0, "fp32")
    return bound_ms(io + table.nbytes, float(n) * CHAIN * CHAIN_OPS, "fp32")


def make_inputs(exp: Experiment, seed: int, device):
    """(table uint32, idx int32) on `device`, from numpy's generator."""
    rng = np.random.default_rng(seed)
    shape = (exp.rows, exp.cols) if exp.cols else (exp.rows,)
    table = rng.integers(0, 1 << 30, shape, dtype=np.uint32)
    idx = rng.integers(0, exp.rows, exp.lanes, dtype=np.int32)
    if exp.sort:
        idx = np.sort(idx)
    return (torch.from_numpy(table).to(device),
            torch.from_numpy(idx).to(device))


def same_bits(a: torch.Tensor, b: torch.Tensor, what: str) -> None:
    if a.shape != b.shape or a.dtype != b.dtype or not torch.equal(
            a.view(torch.int32), b.view(torch.int32)):
        raise AssertionError(f"{what}: kernel and plain version differ")


def _timed(exp: Experiment, kernel: str, arg, idx, extra) -> dict:
    """Check `kernel` against its plain version, then time it."""
    kfn = getattr(gather, kernel)
    out = kfn(arg, idx, **extra)
    same_bits(out, PLAIN[kernel](arg, idx, **extra), f"{exp.name} {kernel}")
    ms = cuda_ms(lambda: kfn(arg, idx, **extra), KERNEL_REPS)
    per = exp.lanes if kernel == "gather_rows" else exp.lanes * CHAIN
    bms, by = gather_bound(kernel, arg, idx, out)
    return {"kernel": kernel, "ns_per_elem": ms * 1e6 / per,
            "ms_per_round": ms if kernel == "gather_rows" else ms / CHAIN,
            "ms": ms, "bound_ms": bms, "bound_by": by}


def run(exp: Experiment, seed: int, device) -> dict:
    """One experiment: its JSON line as a dict."""
    table, idx = make_inputs(exp, seed, device)
    extra = {}
    arg = table
    if exp.kernel == "gather_onehot":
        arg = gather.u8_planes(table)
        extra = {"out_dtype": getattr(torch, exp.out_dtype)}
    line = {"name": exp.name, "reference": exp.reference,
            "rows": exp.rows, "cols": exp.cols, "lanes": exp.lanes,
            **_timed(exp, exp.kernel, arg, idx, extra)}
    if exp.kernel == "gather_onehot":
        line["out_dtype"] = exp.out_dtype
    plain = PLAIN[exp.kernel]
    # the one-hot plain version runs 2^21 / chunk chunks of 8 products
    line["plain_ms"] = cuda_ms(lambda: plain(arg, idx, **extra),
                               1 if exp.kernel == "gather_onehot" else 3)
    line["library_ms"] = None
    if exp.kernel == "gather_rows":
        t32 = table.view(torch.int32)
        line["library_ms"] = cuda_ms(
            lambda: torch.index_select(t32, 0, idx), KERNEL_REPS)
    if exp.shared:
        line["shared"] = _timed(exp, "gather_chain_shared", table, idx, {})
    return line


def run_all(seed: int, device) -> list[dict]:
    """Every experiment in order, each line printed as it finishes."""
    lines = []
    for exp in EXPERIMENTS:
        line = run(exp, seed, device)
        print(json.dumps(line), flush=True)
        lines.append(line)
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("microbench_gather: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi, "torch": torch.__version__,
                      "cuda": torch.version.cuda, "lanes": N, "chain": CHAIN,
                      "seed": args.seed}), flush=True)
    run_all(args.seed, torch.device("cuda", 0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
