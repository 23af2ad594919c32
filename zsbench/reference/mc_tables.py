"""Marching-cubes case tables, generated programmatically at import time.

Instead of embedding the classic hand-written 256x16 triangle table, we derive
an equivalent table from first principles so its correctness is checkable:

  1. For each of the 256 inside/outside corner configurations, find the cube
     edges crossed by the isosurface.
  2. On every cube face, connect crossed boundary edges with isoline segments.
     Faces with four crossed edges are ambiguous; we resolve them by always
     separating the *inside* corners (each inside corner is cut off by a
     segment joining its two adjacent crossed edges) — the original
     Lorensen-Cline choice. Applying the same rule on both sides of a shared
     face makes adjacent cubes agree, so meshes are watertight across cubes.
  3. The segments form closed loops (every crossed edge borders exactly two
     faces, contributing exactly two segment endpoints); each loop is
     fan-triangulated.
  4. Loops are oriented so triangle normals point from inside (value >= iso)
     toward outside.

The resulting TRI_TABLE has the same shape/contract as the classic table:
TRI_TABLE[case] lists triangles as triples of edge indices, -1 padded.

Corner/edge numbering (Lorensen-Cline / PyMCubes convention):
  corners: 0=(0,0,0) 1=(1,0,0) 2=(1,1,0) 3=(0,1,0)
           4=(0,0,1) 5=(1,0,1) 6=(1,1,1) 7=(0,1,1)
  edges:   0:(0,1) 1:(1,2) 2:(2,3) 3:(3,0) 4:(4,5) 5:(5,6) 6:(6,7) 7:(7,4)
           8:(0,4) 9:(1,5) 10:(2,6) 11:(3,7)

Replaces the reference's PyMCubes dependency (utils/eval_3D.py:248-256).
A frozen copy of the repository's table generator (numpy only): the
benchmark's plain sampler imports nothing of the program.
"""

from __future__ import annotations

import numpy as np

CORNERS = np.array(
    [
        [0, 0, 0],
        [1, 0, 0],
        [1, 1, 0],
        [0, 1, 0],
        [0, 0, 1],
        [1, 0, 1],
        [1, 1, 1],
        [0, 1, 1],
    ],
    dtype=np.float32,
)

EDGES = np.array(
    [
        [0, 1], [1, 2], [2, 3], [3, 0],
        [4, 5], [5, 6], [6, 7], [7, 4],
        [0, 4], [1, 5], [2, 6], [3, 7],
    ],
    dtype=np.int32,
)

# faces as corner cycles, ordered counter-clockwise viewed from OUTSIDE the cube
FACES = [
    (0, 3, 2, 1),  # z = 0 (viewed from -z)
    (4, 5, 6, 7),  # z = 1 (viewed from +z)
    (0, 1, 5, 4),  # y = 0
    (2, 3, 7, 6),  # y = 1
    (1, 2, 6, 5),  # x = 1
    (3, 0, 4, 7),  # x = 0
]

_EDGE_OF = {}
for _ei, (_a, _b) in enumerate(EDGES):
    _EDGE_OF[(int(_a), int(_b))] = _ei
    _EDGE_OF[(int(_b), int(_a))] = _ei


def _face_segments(face, inside):
    """Isoline segments on one face, as ordered (edge_from, edge_to) pairs.

    Segments are oriented so the *inside* region lies to the LEFT when the
    face is viewed from outside the cube (faces are CCW-from-outside). This
    global convention makes traced loops wind CCW around the outside normal.
    """
    n = 4
    cuts = []
    for i in range(n):
        a, b = face[i], face[(i + 1) % n]
        if inside[a] != inside[b]:
            cuts.append((i, _EDGE_OF[(a, b)]))
    if not cuts:
        return []
    segs = []
    if len(cuts) == 2:
        (i0, e0), (i1, e1) = cuts
        # orient: walk the face cycle from the cut at i0; the corners strictly
        # after i0 up to i1 form one side. If that side is inside, then going
        # e0 -> e1 keeps inside on the left.
        side_inside = inside[face[(i0 + 1) % n]]
        segs.append((e0, e1) if side_inside else (e1, e0))
    elif len(cuts) == 4:
        # diagonal face: separate each inside corner with its own segment
        for c in range(n):
            if inside[face[c]]:
                e_prev = _EDGE_OF[(face[(c - 1) % n], face[c])]
                e_next = _EDGE_OF[(face[c], face[(c + 1) % n])]
                # inside corner to the left of (incoming -> outgoing)
                segs.append((e_prev, e_next))
    else:
        raise AssertionError("face can only have 0, 2, or 4 crossed edges")
    return segs


def _trace_loops(segments):
    """Chain oriented segments (from_edge -> to_edge) into closed loops."""
    nxt = {}
    for a, b in segments:
        assert a not in nxt, "edge with two outgoing segments"
        nxt[a] = b
    loops = []
    visited = set()
    for start in list(nxt):
        if start in visited:
            continue
        loop = [start]
        visited.add(start)
        cur = nxt[start]
        while cur != start:
            loop.append(cur)
            visited.add(cur)
            cur = nxt[cur]
        loops.append(loop)
    return loops


def _generate():
    max_tris = 0
    tri_lists = []
    for case in range(256):
        inside = [(case >> i) & 1 == 1 for i in range(8)]
        segments = []
        for face in FACES:
            segments.extend(_face_segments(face, inside))
        loops = _trace_loops(segments)
        tris = []
        for loop in loops:
            for i in range(1, len(loop) - 1):
                tris.append((loop[0], loop[i], loop[i + 1]))
        tri_lists.append(tris)
        max_tris = max(max_tris, len(tris))

    tri_table = np.full((256, max_tris, 3), -1, dtype=np.int32)
    n_tri = np.zeros((256,), dtype=np.int32)
    for case, tris in enumerate(tri_lists):
        n_tri[case] = len(tris)
        for t, tri in enumerate(tris):
            tri_table[case, t] = tri
    edge_table = np.zeros((256,), dtype=np.int32)
    for case in range(256):
        inside = [(case >> i) & 1 == 1 for i in range(8)]
        bits = 0
        for ei, (a, b) in enumerate(EDGES):
            if inside[a] != inside[b]:
                bits |= 1 << ei
        edge_table[case] = bits
    return tri_table, n_tri, edge_table, max_tris


TRI_TABLE, N_TRI, EDGE_TABLE, MAX_TRIS = _generate()

