"""Chunk mesher — the raster debug view's geometry.

A numpy copy of vvr_tpu/world/mesher.py (the rebuild of
src/voxel/meshes.rs). The primary mesher is the reference's *surface-nets*
scheme (meshes.rs:87-161): pass 1 emits ONE vertex per sign-change cell (a
2x2x2 corner neighbourhood that is neither empty nor full) at the cell
center + 0.5; pass 2 emits quads across set/unset face transitions,
connecting the 4 cell vertices around the shared edge, with winding dir =
is_set XOR (axis == 1) selecting triangle order [0,1,2, 2,1,3] vs
[1,0,2, 1,2,3] (meshes.rs:72-73,152-156). Like the reference, quads are
only generated for interior positions [1, S-1)^3 per chunk (chunk borders
are left open), and vertex cells span [0, S-1)^3 of the chunk's own voxels
only. Vertex IDs are assigned in x-fastest cell order.

`mesh_voxels_blocky` is the per-exposed-face cube mesher the JAX package
keeps for OBJ export (its C++ twin in vvr_tpu/native is not ported: the
blocky scheme always runs this numpy version, which the JAX package's
tests hold equal to the C++ one). Chunk meshes are concatenated into
shared vertex/index buffers with per-chunk draw ranges
(`SingleChunkInBuffer`, meshes.rs:10-15,33-44). Meshing is host work, done
once per world; `Renderer.mesh` uploads the buffers to the device.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from vvr_tpu_torch.world.chunk import CHUNK_SIZE, Chunk, ChunkKind

# face order: +x -x +y -y +z -z (reference FACE_NORMALS, other.slang:50-57)
_NB = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0],
                [0, 0, 1], [0, 0, -1]], np.int32)

# the 4 vertex-cell offsets around a face transition, per axis
# (meshes.rs:166-173, quad_vertex_offsets_for_axis)
_QUAD_OFFS = (
    np.array([[0, 0, 0], [0, 1, 0], [0, 0, 1], [0, 1, 1]], np.int32),  # x
    np.array([[0, 0, 0], [1, 0, 0], [0, 0, 1], [1, 0, 1]], np.int32),  # y
    np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0]], np.int32),  # z
)
_QUAD_ORDER = np.array([0, 1, 2, 2, 1, 3], np.int64)            # meshes.rs:72
_QUAD_ORDER_OPP = np.array([1, 0, 2, 1, 2, 3], np.int64)        # meshes.rs:73


def mesh_chunk_surface_nets(vox: np.ndarray):
    """Surface-nets mesh of one chunk's bool voxels [z,y,x] (local coords).
    Returns (verts (V,3) f32 at sign-change cell centers + 0.5,
    indices (I,) u32 triangle list)."""
    v = np.asarray(vox, bool)
    s = v.shape[0]
    # pass 1: 8-corner occupancy count per cell in [0, s-1)^3
    cnt = np.zeros((s - 1, s - 1, s - 1), np.int8)
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                cnt += v[dz:dz + s - 1, dy:dy + s - 1, dx:dx + s - 1]
    has_vert = (cnt > 0) & (cnt < 8)
    # vertex ids in x-fastest order: transpose to [x,y,z] before ravel
    hv_x = has_vert.transpose(2, 1, 0)                  # [x,y,z]
    lookup = (np.cumsum(hv_x.ravel()) - 1).reshape(hv_x.shape)
    xx, yy, zz = np.nonzero(hv_x)
    verts = np.stack([xx, yy, zz], 1).astype(np.float32) + 0.5

    tris = []
    for axis in range(3):
        ax_zyx = 2 - axis                               # array axis for x/y/z
        sl_a = [slice(1, s - 1)] * 3
        sl_b = [slice(1, s - 1)] * 3
        sl_b[ax_zyx] = slice(2, s)
        a = v[tuple(sl_a)]                              # is_set(pos)
        b = v[tuple(sl_b)]                              # is_set(pos + e_axis)
        tz, ty, tx = np.nonzero(a != b)
        if len(tx) == 0:
            continue
        pos = np.stack([tx, ty, tz], 1).astype(np.int32) + 1  # (Q,3) x,y,z
        nextc = pos.copy()
        nextc[:, axis] += 1
        is_set = a[tz, ty, tx]
        # 4 vertex cells: offs + next_cell - 1 (meshes.rs:140)
        cells = nextc[:, None, :] - 1 + _QUAD_OFFS[axis][None, :, :]  # (Q,4,3)
        vid = lookup[cells[..., 0], cells[..., 1], cells[..., 2]]     # (Q,4)
        dir_ = is_set ^ (axis == 1)                    # meshes.rs:130
        order = np.where(dir_[:, None], _QUAD_ORDER[None, :],
                         _QUAD_ORDER_OPP[None, :])     # (Q,6)
        tris.append(np.take_along_axis(vid, order, axis=1).reshape(-1))
    if not tris:
        return verts.reshape(-1, 3), np.zeros(0, np.uint32)
    return verts, np.concatenate(tris).astype(np.uint32)


def mesh_voxels_blocky(vox: np.ndarray):
    """Blocky cube mesher: (verts (V,3) f32, indices (I,) u32), 4 verts +
    2 tris per exposed voxel face. Not the reference's surface-nets
    mesher; it exists for watertight OBJ export."""
    vox = np.asarray(vox, bool)
    n = vox.shape[0]
    p = np.pad(vox, 1)
    verts_out = []
    idx_out = []
    base = 0
    for f in range(6):
        dz, dy, dx = _NB[f][2], _NB[f][1], _NB[f][0]
        nb = p[1 + dz:1 + dz + n, 1 + dy:1 + dy + n, 1 + dx:1 + dx + n]
        zz, yy, xx = np.nonzero(vox & ~nb)
        if len(xx) == 0:
            continue
        axis = f // 2
        side = 1.0 if f % 2 == 0 else 0.0
        basep = np.stack([xx, yy, zz], 1).astype(np.float32)
        basep[:, axis] += side
        u, v = (axis + 1) % 3, (axis + 2) % 3
        corners = np.zeros((len(xx), 4, 3), np.float32)
        for k in range(4):
            c = basep.copy()
            if k in (1, 2):
                c[:, u] += 1.0
            if k >= 2:
                c[:, v] += 1.0
            corners[:, k] = c
        tri = np.array([0, 1, 2, 0, 2, 3] if f % 2 == 0 else
                       [0, 2, 1, 0, 3, 2], np.uint32)
        idx = (np.arange(len(xx), dtype=np.uint32)[:, None] * 4
               + base + tri[None, :]).reshape(-1)
        verts_out.append(corners.reshape(-1, 3))
        idx_out.append(idx)
        base += len(xx) * 4
    if not verts_out:
        return np.zeros((0, 3), np.float32), np.zeros(0, np.uint32)
    return np.concatenate(verts_out), np.concatenate(idx_out)


@dataclasses.dataclass
class ChunkDrawRange:
    """SingleChunkInBuffer (meshes.rs:10-15)."""
    chunk_position: np.ndarray
    first_index: int
    index_count: int
    vertex_offset: int


@dataclasses.dataclass
class VoxelMeshBuffers:
    """Concatenated world mesh (meshes.rs:23-44)."""
    vertices: np.ndarray   # (V, 3) f32 world-space
    indices: np.ndarray    # (I,) u32 (relative to each chunk's vertex_offset)
    ranges: list

    @classmethod
    def build(cls, chunks: list[Chunk], scheme: str = "surface_nets"):
        """scheme: 'surface_nets' (the raster view's mesher; only Partial
        chunks produce geometry, meshes.rs:77-80) or 'blocky' (cube faces,
        OBJ export; every non-empty chunk)."""
        if scheme not in ("surface_nets", "blocky"):
            raise ValueError(f"unknown mesh scheme {scheme!r}")
        all_v, all_i, ranges = [], [], []
        voff = ioff = 0
        for c in chunks:
            kind = c.kind
            if kind == ChunkKind.EMPTY or (scheme == "surface_nets"
                                           and kind != ChunkKind.PARTIAL):
                continue
            mesher = (mesh_chunk_surface_nets if scheme == "surface_nets"
                      else mesh_voxels_blocky)
            v, i = mesher(c.voxels)
            origin = (c.position.astype(np.float32) * CHUNK_SIZE)[None, :]
            all_v.append(v + origin)
            all_i.append(i)
            ranges.append(ChunkDrawRange(c.position.copy(), ioff, len(i),
                                         voff))
            voff += len(v)
            ioff += len(i)
        if not all_v:
            return cls(np.zeros((0, 3), np.float32), np.zeros(0, np.uint32),
                       [])
        return cls(np.concatenate(all_v), np.concatenate(all_i), ranges)

    def triangles(self) -> np.ndarray:
        """(T, 3) int32 vertex indices of every range's triangles, in range
        order (the raster view draws them in this order; a triangle's index
        here is its id)."""
        parts = [np.asarray(self.indices[r.first_index:r.first_index
                                         + r.index_count], np.int64)
                 + r.vertex_offset for r in self.ranges]
        if not parts:
            return np.zeros((0, 3), np.int32)
        return np.concatenate(parts).reshape(-1, 3).astype(np.int32)

    def export_obj(self, path):
        """Debug/preview export."""
        with open(path, "w") as f:
            for v in self.vertices:
                f.write(f"v {v[0]} {v[1]} {v[2]}\n")
            for r in self.ranges:
                tri = self.indices[r.first_index:r.first_index + r.index_count]
                for k in range(0, len(tri), 3):
                    a, b, c = (int(t) + r.vertex_offset + 1
                               for t in tri[k:k + 3])
                    f.write(f"f {a} {b} {c}\n")
