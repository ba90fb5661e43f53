"""FLAME face-mesh container with dependency-free OBJ I/O.

The port's own copy of ``audio2face_tpu/utils/facemesh.py`` (pure numpy/scipy).

Capability parity with the reference ``FaceMesh`` (src/utils/facemesh.py:7-53),
which needed trimesh for ``.obj`` and psbody for ``.ply``. Here both formats
are parsed with pure numpy so the mesh path has zero native/third-party
dependencies (the FLAME template is 5,023 verts / 9,976 faces).
"""

from __future__ import annotations

import os

import numpy as np


def _check_mesh_array(arr: np.ndarray, what: str) -> None:
    if arr.ndim != 2 or arr.shape[1] != 3:
        raise ValueError(f"{what} must have shape (N, 3), got {arr.shape}")


def load_obj(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Minimal Wavefront OBJ parser: vertices + triangular faces.

    Handles `v x y z` and `f a b c` lines where face indices may carry
    `/vt/vn` suffixes and may be negative (relative). Polygons with more than
    3 vertices are fan-triangulated.
    """
    verts: list[tuple[float, float, float]] = []
    faces: list[tuple[int, int, int]] = []
    with open(path, "r") as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                verts.append((float(parts[1]), float(parts[2]), float(parts[3])))
            elif line.startswith("f "):
                idx = []
                for tok in line.split()[1:]:
                    i = int(tok.split("/")[0])
                    idx.append(i - 1 if i > 0 else len(verts) + i)
                for k in range(1, len(idx) - 1):
                    faces.append((idx[0], idx[k], idx[k + 1]))
    return (
        np.asarray(verts, dtype=np.float64),
        np.asarray(faces, dtype=np.int64),
    )


def save_obj(path: str, verts: np.ndarray, faces: np.ndarray) -> None:
    with open(path, "w") as f:
        for v in verts:
            f.write(f"v {v[0]:.8f} {v[1]:.8f} {v[2]:.8f}\n")
        for face in faces:
            f.write(f"f {face[0] + 1} {face[1] + 1} {face[2] + 1}\n")


def load_ply(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Minimal PLY parser (ascii and binary_little_endian) for vertex/face
    meshes, replacing the reference's psbody dependency
    (src/utils/facemesh.py:37-46, src/utils/convert_ply.py:8-22)."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path} is not a PLY file")
        fmt = None
        n_verts = n_faces = 0
        vert_props: list[tuple[str, str]] = []
        in_vertex = False
        while True:
            line = f.readline().strip()
            if line.startswith(b"format"):
                fmt = line.split()[1].decode()
            elif line.startswith(b"element vertex"):
                n_verts = int(line.split()[-1])
                in_vertex = True
            elif line.startswith(b"element face"):
                n_faces = int(line.split()[-1])
                in_vertex = False
            elif line.startswith(b"property") and in_vertex:
                parts = line.split()  # e.g. b"property float x"
                vert_props.append((parts[-1].decode(), parts[1].decode()))
            elif line == b"end_header":
                break

        np_types = {
            "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
            "uchar": "u1", "uint8": "u1", "char": "i1", "int8": "i1",
            "short": "i2", "int16": "i2", "ushort": "u2", "uint16": "u2",
            "int": "i4", "int32": "i4", "uint": "u4", "uint32": "u4",
        }
        if fmt == "ascii":
            verts = np.empty((n_verts, 3), dtype=np.float64)
            for i in range(n_verts):
                vals = f.readline().split()
                verts[i] = [float(v) for v in vals[:3]]
            faces = []
            for _ in range(n_faces):
                vals = [int(v) for v in f.readline().split()]
                idx = vals[1 : 1 + vals[0]]
                for k in range(1, len(idx) - 1):
                    faces.append((idx[0], idx[k], idx[k + 1]))
            return verts, np.asarray(faces, dtype=np.int64)
        elif fmt == "binary_little_endian":
            vert_dtype = np.dtype([(name, "<" + np_types[t]) for name, t in vert_props])
            raw = np.frombuffer(f.read(vert_dtype.itemsize * n_verts), dtype=vert_dtype)
            verts = np.stack([raw["x"], raw["y"], raw["z"]], axis=1).astype(np.float64)
            # face lists: assume uchar count + int32 indices (standard psbody/meshlab layout)
            faces = []
            for _ in range(n_faces):
                cnt = np.frombuffer(f.read(1), dtype=np.uint8)[0]
                idx = np.frombuffer(f.read(4 * cnt), dtype="<i4")
                for k in range(1, cnt - 1):
                    faces.append((idx[0], idx[k], idx[k + 1]))
            return verts, np.asarray(faces, dtype=np.int64)
        raise ValueError(f"Unsupported PLY format {fmt!r}")


def convert_ply_to_obj(ply_path: str, obj_path: str) -> None:
    """One-shot PLY→OBJ conversion (reference: src/utils/convert_ply.py:8-22)."""
    verts, faces = load_ply(ply_path)
    save_obj(obj_path, verts, faces)


class FaceMesh:
    """Vertices + faces container (reference: src/utils/facemesh.py:7-53)."""

    def __init__(self, verts, faces):
        verts = np.asarray(verts)
        faces = np.asarray(faces)
        _check_mesh_array(verts, "verts")
        _check_mesh_array(faces, "faces")
        self._verts = verts
        self._faces = faces

    @property
    def verts(self) -> np.ndarray:
        return self._verts

    def set_verts(self, verts) -> None:
        verts = np.asarray(verts)
        _check_mesh_array(verts, "verts")
        self._verts = verts

    @property
    def faces(self) -> np.ndarray:
        return self._faces

    @property
    def n_verts(self) -> int:
        return self._verts.shape[0]

    @property
    def n_faces(self) -> int:
        return self._faces.shape[0]

    @classmethod
    def load(cls, fname: str) -> "FaceMesh":
        if not os.path.exists(fname):
            raise FileNotFoundError(fname)
        if fname.endswith(".obj"):
            return cls(*load_obj(fname))
        if fname.endswith(".ply"):
            return cls(*load_ply(fname))
        raise ValueError(f"Unsupported mesh format: {fname}")

    def save(self, fname: str) -> None:
        if not fname.endswith(".obj"):
            raise ValueError("Only .obj export is supported")
        save_obj(fname, self._verts, self._faces)

    def copy(self) -> "FaceMesh":
        return FaceMesh(self._verts.copy(), self._faces.copy())

    def __repr__(self) -> str:
        return f"FaceMesh(n_verts={self.n_verts}, n_faces={self.n_faces})"
