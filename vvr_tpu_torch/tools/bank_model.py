"""A model of the shared-memory bank wavefronts of K6's row reads
(csrc/gather.cu chain_shared_kernel), in numpy.

    python3 vvr_tpu_torch/tools/bank_model.py [--lanes N] [--seed S]

A warp's shared-memory load is served in phases, each in one or more
wavefronts (one a clock on an SM):

- a 4-byte load (LDS.32) in one phase of 32 lanes, over 32 banks;
- an 8-byte load (LDS.64) in two phases of 16 lanes, over 16 groups of two
  banks;
- a 16-byte load (LDS.128) in four phases of 8 lanes, over 8 groups of four
  banks.

In a phase, the bank group that the most distinct addresses hit sets the
number of wavefronts; lanes on one address are served together (a
broadcast). K6 reads a row of a (rows, cols) u32 table as vectors of 16, 8
or 4 bytes, the widest the row's width allows, one load instruction a
vector. `order` says which vector of its row a lane reads at the row's j-th
load:

- "row": vector j;
- "spread": vector (j + lane) mod NV, lane the lane's index in its warp
  (0-31) and NV the vectors a row.

The index stream is the chain's own (chain_rows: the rows each lane reads
at each of its 8 steps), 32 consecutive lanes a warp. The floor is the
total wavefronts over one wavefront a clock on each SM: what the banks
alone would take, before any latency or other instruction.

Run as a script, it prints the model's wavefronts a warp-step and the
floor at 132 SMs and 1.755 and 1.98 GHz for the K6 shapes of the gather
microbenchmark, on a chain over a table of random full-range words.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

ORDERS = ("row", "spread")
CHAIN = 8
CHUNK = 1 << 18   # phases a batch (keeps the counting arrays small)


def vector_words(cols: int) -> int:
    """Words a vector of K6's row reads: 4 where 4 | cols, 2 where cols is
    even, else 1 (a 1-D table reads one word a row)."""
    return 4 if cols % 4 == 0 else 2 if cols % 2 == 0 else 1


def phase_wavefronts(addr: np.ndarray, groups: int) -> np.ndarray:
    """(P, lanes) vector addresses, one row a phase -> (P,) wavefronts: the
    most distinct addresses that fall in one bank group (address mod
    groups)."""
    out = np.empty(addr.shape[0], np.int64)
    for a in range(0, addr.shape[0], CHUNK):
        s = np.sort(addr[a:a + CHUNK], axis=1)
        first = np.ones(s.shape, bool)
        first[:, 1:] = s[:, 1:] != s[:, :-1]
        key = (np.arange(s.shape[0])[:, None] * groups + s % groups)[first]
        counts = np.bincount(key, minlength=s.shape[0] * groups)
        out[a:a + CHUNK] = counts.reshape(s.shape[0], groups).max(axis=1)
    return out


def wavefronts(rows_read: np.ndarray, cols: int, order: str = "row"
               ) -> float:
    """Mean wavefronts a warp-step (all of a step's row loads of one warp)
    of K6 reading rows `rows_read` ((steps, lanes) or (lanes,), row
    indices in [0, rows)) of a u32 table with `cols` columns (1 for a 1-D
    table) in the vector order `order`. Lanes past the last full warp are
    left out."""
    if order not in ORDERS:
        raise ValueError(f"order must be one of {ORDERS}, not {order!r}")
    vw = vector_words(cols)
    nv = cols // vw
    r = np.asarray(rows_read, np.int64)
    r = r.reshape(-1, r.shape[-1])
    warps = r.shape[1] // 32
    r = r[:, :warps * 32].reshape(-1, 32)
    lanes = 32 // vw              # lanes a phase = bank groups
    lane = np.arange(32)
    total = 0
    for j in range(nv):
        slot = np.full(32, j) if order == "row" else (j + lane) % nv
        addr = r * nv + slot
        total += int(phase_wavefronts(addr.reshape(-1, lanes), lanes).sum())
    return total / r.shape[0]


def chain_rows(table: np.ndarray, idx: np.ndarray, steps: int = CHAIN
               ) -> np.ndarray:
    """(steps, lanes) rows the chain reads: from idx mod rows, then
    (int32(T[i, 0]) ^ i) mod rows (floor mods), as gather_chain_plain
    walks it."""
    col0 = np.asarray(table).reshape(table.shape[0], -1)[:, 0]
    word = col0.astype(np.uint32).view(np.int32).astype(np.int64)
    rows = table.shape[0]
    i = np.mod(np.asarray(idx, np.int64), rows)
    out = np.empty((steps, i.shape[0]), np.int64)
    for s in range(steps):
        out[s] = i
        i = np.mod(word[i] ^ i, rows)
    return out


def floor_us(per_warp_step: float, lanes: int, sms: int, hz: float,
             steps: int = CHAIN) -> float:
    """Microseconds the banks take at one wavefront a clock on each SM:
    per_warp_step wavefronts for each of steps * lanes / 32 warp-steps."""
    return per_warp_step * steps * lanes / 32 / (sms * hz) * 1e6


# K6's shapes in the gather microbenchmark: (experiment, rows, cols)
SHAPES = (("pallas_vreg:R1024", 1024, 1),
          ("pallas_take:R4096xC2", 4096, 2),
          ("pallas_tala:R1024xC8", 1024, 8))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--lanes", type=int, default=1 << 21)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    rng = np.random.default_rng(args.seed)
    for name, rows, cols in SHAPES:
        table = rng.integers(0, 1 << 32, (rows, cols), dtype=np.uint32)
        idx = rng.integers(0, rows, args.lanes, dtype=np.int64)
        stream = chain_rows(table, idx)
        nv = cols // vector_words(cols)
        for order in ORDERS if nv > 1 else ("row",):
            w = wavefronts(stream, cols, order)
            print(json.dumps({
                "shape": name, "order": order, "lanes": args.lanes,
                "wavefronts_per_warp_step": w,
                "floor_us_132_sms": [floor_us(w, args.lanes, 132, hz)
                                     for hz in (1.98e9, 1.755e9)]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
