"""Exposed-face extraction — the geometry input of the face rasterizer
(ops/rastertrace.py) and the sun-grid build (ops/sunshadow.py).

Counterpart of vvr_tpu/world/faces.py, the same host numpy code: every
first hit of a ray that starts in empty space lies on an exposed face, a
unit quad between a solid voxel and an empty neighbour (or the world
boundary). Coplanar faces merge into greedy rectangles.

Layout: struct-of-arrays over N faces
  vx, vy, vz : int32, the MIN-corner solid voxel
  axis       : int32 0/1/2, the face's perpendicular axis (x/y/z)
  sgn        : int32 0/1, 1 if the empty neighbour is at +axis
  eu, ev     : int32 extents along the face's in-plane axes (u, v):
               axis 0 -> (u=y, v=z), axis 1 -> (u=x, v=z),
               axis 2 -> (u=x, v=y)
  einfo      : int32 internal-v-edge flags (bit0: row v0-1 is fully
               covered by coplanar exposed faces over the rectangle's u
               span; bit1: row v0+ev), read by the sun-grid build
The face's plane coordinate along `axis` is v_axis + sgn.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# [z,y,x] array axis of each world axis x=0, y=1, z=2
_ARR_AX = {0: 2, 1: 1, 2: 0}
# [z,y,x] -> [w,v,u] transpose per axis: axis0 (u=y,v=z,w=x): (2,0,1);
# axis1 (u=x,v=z,w=y): (1,0,2); axis2 (u=x,v=y,w=z): (0,1,2)
_TRANSP = {0: (2, 0, 1), 1: (1, 0, 2), 2: (0, 1, 2)}
FIELDS = ("vx", "vy", "vz", "axis", "sgn", "eu", "ev", "einfo")


@dataclasses.dataclass
class FaceSet:
    """Axis-aligned face rectangles; unit faces have eu == ev == 1."""

    vx: np.ndarray
    vy: np.ndarray
    vz: np.ndarray
    axis: np.ndarray
    sgn: np.ndarray
    size: int
    eu: np.ndarray = None
    ev: np.ndarray = None
    einfo: np.ndarray = None

    def __post_init__(self):
        if self.eu is None:
            self.eu = np.ones(len(self.vx), np.int32)
        if self.ev is None:
            self.ev = np.ones(len(self.vx), np.int32)
        if self.einfo is None:
            self.einfo = np.zeros(len(self.vx), np.int32)

    def __len__(self):
        return len(self.vx)

    def device_tuple(self, device="cuda") -> tuple[torch.Tensor, ...]:
        """(vx, vy, vz, axis, sgn, eu, ev, einfo) as contiguous int32
        tensors on `device`."""
        return tuple(torch.from_numpy(np.ascontiguousarray(
            getattr(self, k), np.int32)).to(device) for k in FIELDS)


def _exposed_mask(occ: np.ndarray, axis: int, sgn: int) -> np.ndarray:
    """Exposed-face mask at solid-voxel positions for one (axis, sgn):
    solid, with an empty (or out-of-world) neighbour at -axis (sgn 0) or
    +axis (sgn 1)."""
    arr_ax = _ARR_AX[axis]
    nb = np.zeros_like(occ)
    sl_src = [slice(None)] * 3
    sl_dst = [slice(None)] * 3
    if sgn == 1:
        sl_src[arr_ax] = slice(1, None)
        sl_dst[arr_ax] = slice(0, -1)
    else:
        sl_src[arr_ax] = slice(0, -1)
        sl_dst[arr_ax] = slice(1, None)
    nb[tuple(sl_dst)] = occ[tuple(sl_src)]
    return occ & ~nb


def extract_faces(occ: np.ndarray) -> FaceSet:
    """All exposed unit faces of dense bool occupancy [z,y,x]; neighbours
    outside the world count as empty."""
    occ = np.asarray(occ, bool)
    parts = []
    for axis in (0, 1, 2):
        for sgn in (0, 1):
            z, y, x = np.nonzero(_exposed_mask(occ, axis, sgn))
            parts.append((x, y, z, np.full(len(x), axis, np.int32),
                          np.full(len(x), sgn, np.int32)))
    cols = [np.concatenate([p[k] for p in parts]).astype(np.int32)
            for k in range(5)]
    return FaceSet(*cols, occ.shape[0])


def _merge_layer_runs(mask_wvu: np.ndarray):
    """Greedy rectangle merge of a [w, v, u] bool mask: runs along u, then
    identical (w, u0, len) runs on consecutive v fuse. Returns
    (w, u0, v0, eu, ev) int32 arrays, ordered by (w, u0, len, v0)."""
    m = mask_wvu
    left = np.zeros_like(m)
    left[:, :, 1:] = m[:, :, :-1]
    right = np.zeros_like(m)
    right[:, :, :-1] = m[:, :, 1:]
    sw, sv, su = np.nonzero(m & ~left)     # run starts, (w, v, u) sorted
    eu_ = np.nonzero(m & ~right)[2]        # run ends, same order
    length = (eu_ - su + 1).astype(np.int64)
    order = np.lexsort((sv, length, su, sw))
    w, v, u0, ln = sw[order], sv[order], su[order], length[order]
    if len(w) == 0:
        z = np.zeros(0, np.int32)
        return z, z, z, z, z
    new = np.ones(len(w), bool)
    new[1:] = ((w[1:] != w[:-1]) | (u0[1:] != u0[:-1])
               | (ln[1:] != ln[:-1]) | (v[1:] != v[:-1] + 1))
    starts = np.nonzero(new)[0]
    counts = np.diff(np.append(starts, len(w)))
    return (w[starts].astype(np.int32), u0[starts].astype(np.int32),
            v[starts].astype(np.int32), ln[starts].astype(np.int32),
            counts.astype(np.int32))


def _v_edge_internal(mask_wvu: np.ndarray, w, u0, v0, eu, ev) -> np.ndarray:
    """Per-rectangle internal-v-edge flags (FaceSet.einfo), from row
    cumulative sums in chunks of 65,536 rectangles."""
    nv, nu = mask_wvu.shape[1:]
    flags = np.zeros(len(w), np.int32)
    for bit, voff in ((1, -1), (2, 0)):
        vq = v0 + (voff if voff < 0 else ev)
        idx = np.nonzero((vq >= 0) & (vq < nv))[0]
        for c0 in range(0, len(idx), 1 << 16):
            sel = idx[c0:c0 + (1 << 16)]
            rows = mask_wvu[w[sel], vq[sel], :]            # (C, nu) bool
            cs = np.zeros((len(sel), nu + 1), np.int32)
            np.cumsum(rows, axis=1, out=cs[:, 1:])
            k = np.arange(len(sel))
            cnt = cs[k, u0[sel] + eu[sel]] - cs[k, u0[sel]]
            flags[sel[cnt == eu[sel]]] |= bit
    return flags


def extract_merged_faces(occ: np.ndarray) -> FaceSet:
    """Exposed faces with coplanar greedy-rectangle merging, in the JAX
    package's order ((axis, sgn) blocks, then the merge order). The merged
    set covers exactly the geometry of extract_faces: the rasterizer's
    coverage test is a per-cell range test, so its per-pixel winners are
    the same."""
    occ = np.asarray(occ, bool)
    out = {k: [] for k in FIELDS}
    for axis in (0, 1, 2):
        for sgn in (0, 1):
            mask = _exposed_mask(occ, axis, sgn).transpose(_TRANSP[axis])
            w, u0, v0, eu, ev = _merge_layer_runs(mask)
            vxyz = {0: (w, u0, v0), 1: (u0, w, v0), 2: (u0, v0, w)}[axis]
            cols = (*vxyz, np.full(len(w), axis, np.int32),
                    np.full(len(w), sgn, np.int32), eu, ev,
                    _v_edge_internal(mask, w, u0, v0, eu, ev))
            for k, c in zip(FIELDS, cols):
                out[k].append(c)
    cat = {k: np.concatenate(v) for k, v in out.items()}
    return FaceSet(cat["vx"], cat["vy"], cat["vz"], cat["axis"],
                   cat["sgn"], occ.shape[0], cat["eu"], cat["ev"],
                   cat["einfo"])
