"""The raster debug view (debug_type 0) — kernels K22 `raster_triangles`
and K23 `shade_raster` (csrc/meshraster.cu).

Counterpart of vvr_tpu/render/raster.py `raster_debug_frame` (:302; the
reference's src/renderer.rs:694-771): the surface-nets world mesh
(world/mesher.py) is drawn with a z-buffer, and each covered pixel traces
a binary sun shadow through the brick pyramid from `world + 0.5 + sun *
0.1` (shaders/rasterized.slang:53-86: a hit renders WHITE, as the
reference does); an uncovered pixel takes the skybox and clouds along its
ray (shaders/sky_background.slang:31-52). In order:

  1. `clip_straddlers` (host numpy): each triangle straddling the near
     plane w = NEAR_W (w the view depth along the camera forward) adds 1-2
     triangles wholly in front, their new vertices lerped onto the plane,
     appended after the mesh's in straddler order. The original straddler
     stays drawable, as in the JAX frame (ROADMAP C3: copied); unlike the
     JAX frame (CLIP_CAP = 4096 at :57, :91-101), every straddler is
     clipped: the port has no fixed shapes (C3: not copied).
  2. K22 `raster_triangles` (`project_verts` :118 and `_raster_slab` :234
     with `_grid_pass` :147 and `_fullscreen_pass` :190): the vertices to
     screen space, then per pixel the least depth over the triangles
     covering its centre and the least triangle id among the fragments
     within 1e-6 of it (the resolve rule inside one JAX pass, :182-186).
     The JAX frame folds its passes and slabs by exact (depth, id) instead
     (:245-247, :346-348): the two differ only at a pixel holding two
     fragments of different passes within that band.
  3. the sky textures at the frame's own time (K3, one launch, no bucket
     cache: :350-354), and the camera's rays (K13)
  4. K23 `shade_raster` (`_shade_raster` :262): one thread a pixel
     intersects its ray with the winning triangle's plane, traces the
     shadow (K19's HDDA, the any masks, `traversal_max_steps` steps) or
     samples the sky; alpha 0
  5. K4 composite with bloom off (strength 0, a zero bloom mip: :296-299)

Rounding. Each formula rounds as the jitted JAX function does on the CPU
(checked against it on the three views of tests/test_torch_raster_debug.py
and on 120,000 random vertices under six cameras):
- `project_verts`: the XLA dot `vh @ (proj @ view).T` sums each row as
  (x m0 + y m1) + (z m2 + m3), no FMA; the screen transform is
  fma((ndc + 1) * 0.5, width, -0.5) (and fma((1 - ndc_y) * 0.5, height,
  -0.5)).
- the triangle's area is fma(bx - ax, cy - ay, -((by - ay) * (cx - ax)))
  in every pass; the edge functions e = p q - r s are rounded plainly in
  the 16-sample and the full-screen passes but as fma(-r, s, p q) in the
  128-sample pass, which takes the triangles wider than 16 pixels, the
  first BIG_CAP = 2048 of them in each 32,768-triangle slab, that fit in
  128. K22 gives each triangle that pass's rounding (`contract`): a flag
  computed from the JAX rule, not a pass of its own (the slab rank runs
  in the launch that scans the tile counts). One rounding for every
  triangle, plain or FMA, moves the z-buffer off the JAX one by a few
  ulps (tests/test_torch_raster_debug.py).
- `_shade_raster`: the cross product's components are fma(a, b, -(c d)),
  the norm's and the dot products' sums FMA chains, as XLA contracts them
  (checked on 200,000 random planes); o + d t is an FMA in every
  component, where XLA's CPU code contracts x and y only, and the start
  world + 0.5 + sun * 0.1 is plain. The rays (K13's, correctly rounded)
  differ from the jitted JAX rays in the last ulp anyway, so the frame is
  held to the JAX one within the goldens' bar. The sky sample blends as
  the other frames do.

Not ported (TPU machinery for static shapes, ROADMAP "Not to port"): the
K_SMALL / K_BIG sample grids, BIG_CAP's close-up queue, the 32,768-
triangle slabs, the full-screen `while_loop` and CLIP_CAP. A triangle's
fragments are the pixels of its bounding box whose centres it covers: a
centre outside the box lies half a pixel outside the triangle.
"""

from __future__ import annotations

import dataclasses
import typing

import numpy as np
import torch

from vvr_tpu_torch import kernels
from vvr_tpu_torch.config import RenderConfig
from vvr_tpu_torch.ops import post as post_ops
from vvr_tpu_torch.ops import sky as sky_ops
from vvr_tpu_torch.ops.rastertrace import BIN_MAX
from vvr_tpu_torch.ops.raygen import camera_rays
from vvr_tpu_torch.ops.traverse import check_pyramid, trace_pyramid_plain
from vvr_tpu_torch.utils.camera import Camera
from vvr_tpu_torch.utils.hash import _fma, sqrt32
from vvr_tpu_torch.world.mesher import VoxelMeshBuffers
from vvr_tpu_torch.world.pyramid import BrickPyramid

F32 = torch.float32
NO_TRI = np.iinfo(np.int32).max
NEAR_W = 0.5        # the reference's projection near plane (movement.rs:103)
# the JAX rasterizer's passes, read only to round each triangle as its
# pass does (module docstring)
K_SMALL = 16
K_BIG = 128
BIG_CAP = 2048
SLAB = 32768
# fragments a chunk of the plain rasterizer holds at once
PLAIN_CHUNK = 1 << 22


@dataclasses.dataclass
class RasterMesh:
    """The world mesh as the raster view draws it: the triangles in range
    order (a triangle's index is its id) on the host, for clipping, and on
    the device."""
    buffers: VoxelMeshBuffers
    verts_host: np.ndarray     # (V, 3) float32
    tris_host: np.ndarray      # (T, 3) int32
    verts: torch.Tensor        # (V, 3) float32 on the device
    tris: torch.Tensor         # (T, 3) int32 on the device

    @classmethod
    def upload(cls, buffers: VoxelMeshBuffers, device="cuda"):
        verts = np.ascontiguousarray(buffers.vertices, np.float32)
        tris = buffers.triangles()
        return cls(buffers, verts, tris,
                   torch.from_numpy(verts.reshape(-1, 3).copy()).to(device),
                   torch.from_numpy(tris.copy()).to(device))

    def nbytes(self) -> int:
        return self.verts.nbytes + self.tris.nbytes


# ---------------------------------------------------------------------------
# 1. near-plane clipping (host)
# ---------------------------------------------------------------------------

# the order of a straddler's corners, in front first, by its in-front mask
# (bit k: corner k): 1 in front (1, 2, 4) or 2 (3, 5, 6), each group in the
# triangle's own order
_CLIP_ORDER = np.array([[0, 1, 2], [0, 1, 2], [1, 0, 2], [0, 1, 2],
                        [2, 0, 1], [0, 2, 1], [1, 2, 0], [0, 1, 2]],
                       np.int64)


def clip_straddlers(verts: np.ndarray, tris: np.ndarray, pos, fwd):
    """Near-plane clipping of `_clip_straddlers` (vvr_tpu/render/raster.py
    :60), every straddler: (extra_verts (2S, 3) float32, extra_tris (X, 3)
    int32 indexing [verts | extra_verts]) for the S triangles with one or
    two corners in front of w = NEAR_W. A straddler with one corner a in
    front gives (a, p, q), p and q its edges' crossings toward the other
    two in order; one with corners a, b in front and c behind gives (a, b,
    p2), (a, p2, p1), p1 = a->c and p2 = b->c. Each crossing is a + ta (b'
    - a) with ta = (NEAR_W - w_a) / (w_b' - w_a), in float32 as the JAX
    function computes it."""
    verts = np.asarray(verts, np.float32)
    tris = np.asarray(tris, np.int32).reshape(-1, 3)
    if len(tris) == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)
    w = (verts - np.asarray(pos, np.float32)) @ np.asarray(fwd, np.float32)
    inw = (w > NEAR_W).view(np.uint8)
    # the in-front mask of each triangle's corners, bit k corner k (three
    # column gathers: a row sum over (T, 3) costs twice as much)
    code = inw[tris[:, 0]] | (inw[tris[:, 1]] << 1) | (inw[tris[:, 2]] << 2)
    stra = np.nonzero((code != 0) & (code != 7))[0]
    if len(stra) == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)
    code = code[stra]
    cnt = (code & 1) + ((code >> 1) & 1) + (code >> 2)
    p = np.take_along_axis(tris[stra].astype(np.int64), _CLIP_ORDER[code], 1)
    one = cnt == 1
    # the two crossings: one in front: p0->p1, p0->p2; two: p0->p2, p1->p2
    src = np.stack([p[:, 0], np.where(one, p[:, 0], p[:, 1])], 1)
    dst = np.stack([np.where(one, p[:, 1], p[:, 2]), p[:, 2]], 1)
    near = np.float32(NEAR_W)
    ta = (near - w[src]) / (w[dst] - w[src])
    ev = verts[src] + ta[..., None] * (verts[dst] - verts[src])
    base = len(verts) + 2 * np.arange(len(stra))
    p1, p2 = base, base + 1
    tri_one = np.stack([p[:, 0], p1, p2], 1)
    tri_two = np.stack([p[:, 0], p[:, 1], p2, p[:, 0], p2, p1], 1)
    n_out = np.where(one, 1, 2)
    first = np.cumsum(n_out) - n_out
    et = np.zeros((int(n_out.sum()), 3), np.int64)
    et[first[one]] = tri_one[one]
    et[first[~one]] = tri_two[~one, :3]
    et[first[~one] + 1] = tri_two[~one, 3:]
    return ev.reshape(-1, 3), et.astype(np.int32)


# ---------------------------------------------------------------------------
# 2. K22: projection and the z-buffer
# ---------------------------------------------------------------------------

def view_proj(camera: Camera, width: int, height: int) -> np.ndarray:
    """proj @ view (4, 4) float32, as XLA's dot computes it (the product
    of the two float32 matrices, whose zeros leave one product a term but
    for the unused depth row)."""
    view, proj = camera.matrices(width, height)
    return (proj @ view).astype(np.float32)


def _fma_s(a, b: float, c: float):
    """float32 fma(a, b, c) for a tensor a and float scalars b, c (one
    rounding: the float64 product is exact, see utils/hash.py _fma)."""
    return (a.double() * b + c).to(F32)


def project_verts(verts, m: np.ndarray, width: int, height: int):
    """(sx, sy, w) (V,) float32 of `project_verts` (vvr_tpu/render/raster.py
    :118) with m = view_proj(...): clip = (x m0 + y m1) + (z m2 + m3) per
    row, w clip's fourth (the view depth), screen coordinates with pixel
    (i, j)'s centre at (i, j). Plain torch on any device; on the card K22
    projects inside its launch."""
    x, y, z = verts[:, 0], verts[:, 1], verts[:, 2]
    mf = [[float(v) for v in row] for row in m]

    def row(j):
        return (x * mf[j][0] + y * mf[j][1]) + (z * mf[j][2] + mf[j][3])

    cx, cy, w = row(0), row(1), row(3)
    safe = torch.where(torch.abs(w) < 1e-6, 1e-6, w)
    sx = _fma_s((cx / safe + 1.0) * 0.5, float(width), -0.5)
    sy = _fma_s((1.0 - cy / safe) * 0.5, float(height), -0.5)
    return sx, sy, w


class TriSetup(typing.NamedTuple):
    """Per triangle (T,) tensors: its corners on the screen and their view
    depths, 1 / area (0 below 1e-9), whether it draws (every w > 1e-3
    and a non-zero area), its pixel box (floor of the least and ceil of
    the greatest corner, float32) and `contract`, whether the JAX
    128-sample pass draws it (module docstring)."""
    ax: torch.Tensor
    ay: torch.Tensor
    bx: torch.Tensor
    by: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    wa: torch.Tensor
    wb: torch.Tensor
    wc: torch.Tensor
    inv: torch.Tensor
    draws: torch.Tensor
    x0: torch.Tensor
    x1: torch.Tensor
    y0: torch.Tensor
    y1: torch.Tensor
    contract: torch.Tensor


def triangle_setup(sx, sy, w, tris) -> TriSetup:
    """The TriSetup of the triangles (T, 3) over projected vertices."""
    t = tris.shape[0]
    a, b, c = (tris[:, k].long() for k in range(3))
    ax, ay, bx, by, cx, cy = sx[a], sy[a], sx[b], sy[b], sx[c], sy[c]
    area = _fma(bx - ax, cy - ay, -((by - ay) * (cx - ax)))
    inv = torch.where(torch.abs(area) < 1e-9, 0.0,
                      1.0 / torch.where(area == 0, 1.0, area))
    wa, wb, wc = w[a], w[b], w[c]
    draws = (wa > 1e-3) & (wb > 1e-3) & (wc > 1e-3) & (inv != 0)
    x0 = torch.floor(torch.minimum(ax, torch.minimum(bx, cx)))
    x1 = torch.ceil(torch.maximum(ax, torch.maximum(bx, cx)))
    y0 = torch.floor(torch.minimum(ay, torch.minimum(by, cy)))
    y1 = torch.ceil(torch.maximum(ay, torch.maximum(by, cy)))
    big = ~((x1 - x0 <= K_SMALL) & (y1 - y0 <= K_SMALL))
    fits = (x1 - x0 <= K_BIG) & (y1 - y0 <= K_BIG)
    # rank of each big triangle among the big ones of its slab
    cum = torch.cumsum(big.to(torch.int64), 0)
    slab_end = torch.arange(t, device=sx.device) // SLAB * SLAB - 1
    before = torch.where(slab_end >= 0, cum[torch.clamp(slab_end, min=0)], 0)
    contract = big & fits & (cum - 1 - before < BIG_CAP)
    return TriSetup(ax, ay, bx, by, cx, cy, wa, wb, wc, inv, draws, x0, x1,
                    y0, y1, contract)


def raster_plan(s: TriSetup, width: int, height: int):
    """(ids, box widths, first fragments, count): the drawing triangles
    whose box meets the screen, their boxes' widths on the screen and
    the flat index of each one's first box fragment, and the fragments'
    count."""
    on = s.draws & (s.x1 >= 0) & (s.x0 <= width - 1) & (s.y1 >= 0) \
        & (s.y0 <= height - 1)
    ids = torch.nonzero(on)[:, 0]
    bw = (torch.clamp(s.x1, 0, width - 1) - torch.clamp(s.x0, 0, width - 1)
          + 1).long()[ids]
    bh = (torch.clamp(s.y1, 0, height - 1)
          - torch.clamp(s.y0, 0, height - 1) + 1).long()[ids]
    cnt = bw * bh
    return ids, bw, torch.cumsum(cnt, 0) - cnt, int(cnt.sum())


def covered_fragments(verts, tris, m: np.ndarray, width: int, height: int):
    """The covered fragments (pixel, triangle, depth) of the triangles'
    box pixels, in chunks of at most PLAIN_CHUNK box pixels, in triangle
    order: each a pixel centre the triangle covers (`_edge_cover`'s
    barycentrics, both windings, eps -1e-6), its perspective depth
    1 / max(l0/wa + l1/wb + l2/wc, 1e-9)."""
    s = triangle_setup(*project_verts(verts, m, width, height), tris)
    ids, bw, first, total = raster_plan(s, width, height)
    for lo in range(0, total, PLAIN_CHUNK):
        g = torch.arange(lo, min(lo + PLAIN_CHUNK, total), device=ids.device)
        k = torch.searchsorted(first, g, right=True) - 1
        local = g - first[k]
        ti = ids[k]
        row = local // bw[k]
        xi = torch.clamp(s.x0[ti], 0, width - 1).long() + local - row * bw[k]
        yi = torch.clamp(s.y0[ti], 0, height - 1).long() + row
        px = xi.to(F32) + 0.5
        py = yi.to(F32) + 0.5
        ax, ay, bx, by, cx, cy = (v[ti] for v in s[:6])
        con = s.contract[ti]

        def edge(p, q, r, t):
            return torch.where(con, _fma(-r, t, p * q), p * q - r * t)

        e0 = edge(cx - bx, py - by, cy - by, px - bx)
        e1 = edge(ax - cx, py - cy, ay - cy, px - cx)
        l0 = e0 * s.inv[ti]
        l1 = e1 * s.inv[ti]
        l2 = (1.0 - l0) - l1
        eps = -1e-6
        cover = (l0 >= eps) & (l1 >= eps) & (l2 >= eps)
        inv_w = (l0 / s.wa[ti] + l1 / s.wb[ti]) + l2 / s.wc[ti]
        depth = 1.0 / torch.clamp(inv_w, min=1e-9)
        yield (yi * width + xi)[cover], ti[cover], depth[cover]


def raster_triangles_plain(verts, tris, m: np.ndarray, width: int,
                           height: int):
    """Plain torch version of K22: (zbuf (H*W,) float32, inf where no
    triangle covers the pixel; winner (H*W,) int32, NO_TRI there): the
    least depth over the covering fragments, then the least triangle id
    among those with depth <= zbuf * (1 + 1e-6); the fragments twice
    (depth, then id)."""
    n = width * height
    zbuf = torch.full((n,), float("inf"), dtype=F32, device=verts.device)
    winner = torch.full((n,), NO_TRI, dtype=torch.int64, device=verts.device)
    for pix, _, depth in covered_fragments(verts, tris, m, width, height):
        zbuf.scatter_reduce_(0, pix, depth, "amin")
    for pix, ti, depth in covered_fragments(verts, tris, m, width, height):
        band = depth <= zbuf[pix] * (1.0 + 1e-6)
        winner.scatter_reduce_(0, pix[band], ti[band], "amin")
    return zbuf, winner.to(torch.int32)


def _check_mesh(verts, tris, extra_verts, extra_tris):
    for v in (verts, extra_verts):
        if v.dim() != 2 or v.shape[1] != 3 or v.dtype != F32:
            raise ValueError("vertices must be (V, 3) float32")
    for t in (tris, extra_tris):
        if t.dim() != 2 or t.shape[1] != 3 or t.dtype != torch.int32:
            raise ValueError("triangles must be (T, 3) int32")


def raster_triangles(verts, tris, m: np.ndarray, width: int, height: int,
                     extra_verts=None, extra_tris=None):
    """Z-buffer and winner (as `raster_triangles_plain`) of the triangles
    [tris | extra_tris] over the vertices [verts | extra_verts] (the
    clipped straddlers' come as the extras, so the mesh is not copied).
    CUDA: K22, one entry point (project, triangle setup, tile binning,
    then a CTA a 32x32 tile); CPU: the plain version."""
    dev = verts.device
    if extra_verts is None:
        extra_verts = torch.zeros((0, 3), dtype=F32, device=dev)
    if extra_tris is None:
        extra_tris = torch.zeros((0, 3), dtype=torch.int32, device=dev)
    _check_mesh(verts, tris, extra_verts, extra_tris)
    if not kernels.on_cuda(verts):
        return raster_triangles_plain(torch.cat([verts, extra_verts]),
                                      torch.cat([tris, extra_tris]), m,
                                      width, height)
    kernels.check_cuda(verts, tris, extra_verts, extra_tris)
    nv, ne = verts.shape[0], extra_verts.shape[0]
    nt, nx = tris.shape[0], extra_tris.shape[0]
    if width <= 0 or height <= 0:
        raise ValueError(f"image {width}x{height}")
    n_tiles = -(-width // 32) * -(-height // 32)
    words = raster_scratch_words(nv + ne, nt + nx, n_tiles)
    scratch = torch.empty(words, dtype=torch.int32, device=dev)
    zbuf = torch.empty(width * height, dtype=F32, device=dev)
    winner = torch.empty(width * height, dtype=torch.int32, device=dev)
    kernels.launch("raster_triangles", dev, verts.data_ptr(), nv,
                   extra_verts.data_ptr(), ne, tris.data_ptr(), nt,
                   extra_tris.data_ptr(), nx,
                   *(float(v) for v in np.asarray(m, np.float32)[[0, 1, 3]]
                     .ravel()),
                   width, height, scratch.data_ptr(), zbuf.data_ptr(),
                   winner.data_ptr())
    return zbuf, winner


def raster_scratch_words(n_verts: int, n_tris: int, n_tiles: int) -> int:
    """int32 words of K22's scratch (csrc/meshraster.cu
    vvr_raster_triangles): a 64-byte record a triangle, the tile binning's
    (csrc/tilebin.cuh: the tile counts then offsets and their total
    (int64), the tile fills, the big count, the big list, BIN_MAX list
    slots a triangle), sx, sy, w a vertex, and two mask words a 32
    triangles."""
    return (16 * n_tris + 2 * (n_tiles + 1) + n_tiles + 1 + n_tris
            + BIN_MAX * n_tris + 3 * n_verts + 2 * (-(-n_tris // 32)))


# ---------------------------------------------------------------------------
# 4. K23: the fragments' shadows and the sky
# ---------------------------------------------------------------------------

def _plane_hit(v0, v1, v2, o, d):
    """The ray o + d t's point on the plane of (v0, v1, v2) (:275-282):
    the geometric normal cross(v1 - v0, v2 - v0) normalized, t = n.(v0 -
    o) / n.d (|n.d| < 1e-9 taken as 1e-9)."""
    e1 = v1 - v0
    e2 = v2 - v0
    n = torch.stack([
        _fma(e1[:, 1], e2[:, 2], -(e1[:, 2] * e2[:, 1])),
        _fma(e1[:, 2], e2[:, 0], -(e1[:, 0] * e2[:, 2])),
        _fma(e1[:, 0], e2[:, 1], -(e1[:, 1] * e2[:, 0]))], 1)
    nn = sqrt32(_fma(n[:, 2], n[:, 2], _fma(n[:, 1], n[:, 1],
                                            n[:, 0] * n[:, 0])))
    n = n / torch.clamp(nn, min=1e-12)[:, None]
    denom = _fma(n[:, 2], d[:, 2], _fma(n[:, 1], d[:, 1], n[:, 0] * d[:, 0]))
    q = v0 - o
    num = _fma(n[:, 2], q[:, 2], _fma(n[:, 1], q[:, 1], n[:, 0] * q[:, 0]))
    tplane = num / torch.where(torch.abs(denom) < 1e-9, 1e-9, denom)
    return _fma(d, tplane[:, None].expand(-1, 3), o)


def shadow_starts(world, sun3):
    """(world + 0.5) + sun * 0.1 (:285), as XLA rounds it."""
    return (world + 0.5) + (sun3.to(world.device) * 0.1)[None, :]


def shadow_rays(winner, verts, tris, origin, d, sun3):
    """(starts (N, 3), covered (N,)): each covered pixel's shadow ray start
    world + 0.5 + sun * 0.1, world its ray's point on the winning
    triangle's plane (`_shade_raster` :268-285); the sun is the rays'
    direction."""
    n = winner.shape[0]
    t = tris.shape[0]
    o = torch.as_tensor(np.asarray(origin, np.float32),
                        device=winner.device).expand(n, 3)
    covered = winner != NO_TRI
    if t == 0:
        return o.clone(), covered
    tri = tris[torch.clamp(winner.long(), 0, t - 1)].long()
    v0, v1, v2 = (verts[tri[:, k]] for k in range(3))
    world = _plane_hit(v0, v1, v2, o, d)
    return shadow_starts(world, torch.as_tensor(sun3, dtype=F32)), covered


def shade_raster_plain(winner, verts, tris, pyr: BrickPyramid, origin, d,
                       sun3, skybox, clouds, max_steps: int, width: int,
                       height: int):
    """Plain torch version of K23: planar HDR (4, H, W), white where the
    winning fragment's shadow ray toward the sun hits the pyramid, black
    where it does not, the sky (skybox blended with the clouds) where no
    triangle won; alpha 0."""
    n = winner.shape[0]
    sun3 = torch.as_tensor(sun3, dtype=F32).reshape(-1)[:3]
    s_o, covered = shadow_rays(winner, verts, tris, origin, d, sun3)
    hit = trace_pyramid_plain(pyr, s_o, sun3.to(d.device), max_steps,
                              active=covered, stats=False,
                              use_full=False).hit
    dx, dy, dz = d.unbind(1)
    ox, oy, oz = (torch.full_like(dx, float(c))
                  for c in np.asarray(origin, np.float32))
    cl = sky_ops.sample_clouds(clouds, dx, dy, dz, ox, oy, oz)
    sb = sky_ops.sample_skybox(skybox, dx, dy, dz)
    frag = torch.where(hit, 1.0, 0.0)
    out = [torch.where(covered, frag, sb[:, c] + (cl[:, c] - sb[:, c])
                       * cl[:, 3]) for c in range(3)]
    out.append(torch.zeros(n, dtype=F32, device=winner.device))
    return torch.stack(out).reshape(4, height, width)


def shade_raster(winner, verts, tris, pyr: BrickPyramid, origin, d, sun3,
                 skybox, clouds, max_steps: int, width: int, height: int,
                 extra_verts=None, extra_tris=None):
    """Planar HDR of the raster view (as `shade_raster_plain`) for the
    winners over [tris | extra_tris] and [verts | extra_verts]; `origin`
    the camera's position (3,) on the host, `d` its (N, 3) ray directions
    (K13's).
    CUDA: K23, one thread a pixel; CPU: the plain version."""
    dev = winner.device
    if extra_verts is None:
        extra_verts = torch.zeros((0, 3), dtype=F32, device=dev)
    if extra_tris is None:
        extra_tris = torch.zeros((0, 3), dtype=torch.int32, device=dev)
    _check_mesh(verts, tris, extra_verts, extra_tris)
    n = width * height
    if winner.shape != (n,) or winner.dtype != torch.int32:
        raise ValueError(f"winner must be ({n},) int32")
    if d.shape != (n, 3) or d.dtype != F32:
        raise ValueError(f"ray directions must be ({n}, 3) float32")
    origin = np.asarray(origin, np.float32).reshape(3)
    sun3 = torch.as_tensor(sun3, dtype=F32).cpu().reshape(-1)[:3]
    if not kernels.on_cuda(winner):
        return shade_raster_plain(
            winner, torch.cat([verts, extra_verts]),
            torch.cat([tris, extra_tris]), pyr, origin, d, sun3, skybox,
            clouds, max_steps, width, height)
    check_pyramid(pyr)
    if clouds.data_ptr() % 16:
        raise ValueError("clouds must be 16-byte aligned (read as float4)")
    kernels.check_cuda(winner, verts, tris, extra_verts, extra_tris, d,
                       skybox, clouds, pyr.rows)
    out = torch.empty((4, height, width), dtype=F32, device=dev)
    kernels.launch("shade_raster", dev, winner.data_ptr(), n,
                   verts.data_ptr(), verts.shape[0], extra_verts.data_ptr(),
                   tris.data_ptr(), tris.shape[0], extra_tris.data_ptr(),
                   pyr.rows.data_ptr(), pyr.size, pyr.depth, max_steps,
                   *(float(c) for c in origin), d.data_ptr(),
                   *(float(c) for c in sun3), skybox.data_ptr(),
                   skybox.shape[1], clouds.data_ptr(), clouds.shape[0],
                   out.data_ptr())
    return out


# ---------------------------------------------------------------------------
# the frame
# ---------------------------------------------------------------------------

def raster_debug_frame(mesh: RasterMesh, pyr: BrickPyramid, camera: Camera,
                       sun, time: float, cfg: RenderConfig):
    """The debug_type 0 frame (module docstring) -> (H, W, 3) u8 on the
    mesh's device, and the planar HDR (4, rh, rw)."""
    h, w_img = cfg.render_height, cfg.render_width
    dev = mesh.verts.device
    m = view_proj(camera, w_img, h)
    _, _, fwd = camera.basis()
    ev, et = clip_straddlers(mesh.verts_host, mesh.tris_host,
                             camera.position, fwd)
    extra_v = torch.from_numpy(ev).to(dev)
    extra_t = torch.from_numpy(et).to(dev)
    _, winner = raster_triangles(mesh.verts, mesh.tris, m, w_img, h,
                                 extra_v, extra_t)
    sun3 = torch.as_tensor(np.asarray(sun, np.float32)).reshape(-1)[:3]
    skybox, clouds = sky_ops.write_sky(sun3, time, cfg.skybox_resolution,
                                       cfg.clouds_resolution, dev)
    _, d = camera_rays(camera, w_img, h, dev)
    hdr = shade_raster(winner, mesh.verts, mesh.tris, pyr, camera.position,
                       d, sun3, skybox, clouds, cfg.traversal_max_steps,
                       w_img, h, extra_v, extra_t)
    bloom2 = torch.zeros((4, max(h >> 2, 1), max(w_img >> 2, 1)),
                         dtype=F32, device=dev)
    img = post_ops.composite_p(hdr, bloom2, cfg.height, cfg.width, 0.0,
                               False)
    return img, hdr
