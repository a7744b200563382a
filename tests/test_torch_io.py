"""The port's host inputs against the JAX package's: the OBJ loader
(analogs of tests/test_obj.py:16-50, on the same OBJ text), the PNG
writer (tests/test_formats.py:31), the BC6H decoder built from
native/bc6h.cpp by the port's own g++ build (tests/test_dds.py:26-91:
Pillow's decoder as the oracle and the spec's signed vectors), the DDS
cube-map reader and SSIM.  The asset tests skip without the reference's
assets, as the reference's do.  The reference's decoder is not called:
its loader may rebuild native/librtggx_native.so.
"""

import io
import struct

import numpy as np
import pytest
import torch

from raytracedggx_tpu.io import dds as j_dds
from raytracedggx_tpu.io.obj import load_obj as j_load_obj
from raytracedggx_tpu.io.png import tonemapped_u8 as j_tonemapped_u8
from raytracedggx_tpu.scene.mesh import ground_cube as j_ground_cube
from raytracedggx_tpu.scene.mesh import from_obj as j_from_obj
from raytracedggx_tpu.scene.scene import Scene as JScene
from raytracedggx_tpu.utils import ssim as j_ssim

from raytracedggx_tpu_torch.io import dds, native
from raytracedggx_tpu_torch.io.obj import load_obj
from raytracedggx_tpu_torch.io.png import tonemapped_u8, write_png
from raytracedggx_tpu_torch.scene import Scene
from raytracedggx_tpu_torch.scene.mesh import from_obj, ground_cube
from raytracedggx_tpu_torch.trace.env import sample_env
from raytracedggx_tpu_torch.utils import ssim
from test_dds import _bits_to_block, _make_dds_2d_bc6h, _spec_signed_half

pil = pytest.importorskip("PIL.Image")

OBJS = {
    "tri": "v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n",
    "quad": "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nf 1 2 3 4\n",
    "split": ("v 0 0 0\nv 1 0 0\nv 0 1 0\nv 1 1 0\nvn 0 0 1\nvn 0 0 -1\n"
              "f 1//1 2//1 3//1\nf 2//2 4//2 3//2\n"),
    "negative": ("v 0 0 0\nv 2 0 0\nv 2 2 1\nv 0 2 1\nvt 0 0\nvt 1 0\n"
                 "vt 1 1\nvn 0 0 1\nf -4/-3/-1 -3/-2/-1 -2/-1/-1 -1/1/1\n"),
    "texcoords": ("v 0 0 0\nv 1 0 0\nv 1 1 0\nvt 0 0\nvt 1 0\nvt 1 1\n"
                  "f 1/1 2/2 3/3\n"),
}


@pytest.mark.parametrize("name", sorted(OBJS))
def test_load_obj_matches_reference(tmp_path, name):
    path = tmp_path / f"{name}.obj"
    path.write_text(OBJS[name])
    got, want = load_obj(str(path)), j_load_obj(str(path))
    for field in ("positions", "normals", "indices", "aabb_min", "aabb_max"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert got.num_triangles == want.num_triangles


def test_obj_semantics(tmp_path):
    """tests/test_obj.py:16-50 on the port: DX handedness (z negated,
    the index buffer reversed), fan triangulation, vertex splits."""
    m = ground_cube()
    assert m.positions.shape == (24, 3) and m.num_triangles == 12
    assert np.allclose(np.linalg.norm(m.normals, axis=1), 1.0)
    for name in ("tri", "quad", "split"):
        (tmp_path / f"{name}.obj").write_text(OBJS[name])
    tri = load_obj(str(tmp_path / "tri.obj"))
    assert list(tri.indices) == [2, 1, 0]
    assert np.allclose(tri.normals, [[0, 0, -1]] * 3, atol=1e-6)
    assert list(load_obj(str(tmp_path / "quad.obj")).indices) == [
        3, 2, 0, 2, 1, 0]
    split = load_obj(str(tmp_path / "split.obj"))
    assert split.positions.shape[0] > 4 and split.indices.shape == (6,)
    used = np.unique(split.indices)
    assert np.allclose(np.linalg.norm(split.normals[used], axis=1), 1.0,
                       atol=1e-6)


def test_scene_create_matches_reference(tmp_path):
    """Scene.create / from_obj: the same meshes, materials, instances and
    world matrices as the reference's."""
    path = str(tmp_path / "quad.obj")
    with open(path, "w") as f:
        f.write(OBJS["quad"])
    extra = ((1.0, 2.0, 3.0, 0.5),)
    got = Scene.create(path, pos_scale=(0.0, 2.8, 0.0, 0.03),
                       extra_instances=extra)
    want = JScene.create(path, pos_scale=(0.0, 2.8, 0.0, 0.03),
                         extra_instances=extra)
    assert got.mesh_ids == want.mesh_ids == (0, 1, 1)
    for a, b in zip(got.meshes, want.meshes):
        for field in ("positions", "normals", "indices"):
            np.testing.assert_array_equal(getattr(a, field),
                                          getattr(b, field))
    np.testing.assert_array_equal(from_obj(path).indices,
                                  j_from_obj(path).indices)
    np.testing.assert_array_equal(ground_cube().indices,
                                  j_ground_cube().indices)
    np.testing.assert_array_equal(got.pos_scale, want.pos_scale)
    np.testing.assert_allclose(got.worlds(0.7).numpy(),
                               np.asarray(want.worlds(0.7)), atol=1e-6)
    np.testing.assert_array_equal(got.materials.rough_metals,
                                  want.materials.rough_metals)


def test_load_bunny(bunny_path):
    m = load_obj(bunny_path)
    assert m.positions.shape[0] == 34835
    assert m.indices.shape[0] == 69666 * 3
    assert np.allclose(np.linalg.norm(m.normals, axis=1), 1.0, atol=1e-4)
    assert m.aabb_min[1] >= -1.0


def test_png_writer_roundtrip(tmp_path):
    img = (np.random.default_rng(0).random((16, 24, 3)) * 255
           ).astype(np.uint8)
    path = tmp_path / "t.png"
    write_png(str(path), img)
    assert np.array_equal(np.asarray(pil.open(path)), img)
    rgba = np.random.default_rng(1).random((5, 7, 4)).astype(np.float32)
    write_png(str(path), rgba)
    assert np.array_equal(np.asarray(pil.open(path)), tonemapped_u8(rgba))


def test_tonemapped_u8_matches_reference(rng):
    hdr = (rng.random((9, 13, 3)) * 1.4 - 0.2).astype(np.float32)
    np.testing.assert_array_equal(tonemapped_u8(hdr), j_tonemapped_u8(hdr))


def test_native_build_is_the_ports(tmp_path):
    """The decoder library is built from native/bc6h.cpp into the port's
    build directory, named by the source's hash."""
    lib = native.library_path()
    assert native.get_lib() is native.get_lib()
    assert lib.exists() and lib.parent.name == "build"
    assert lib.parent.parent.name == "raytracedggx_tpu_torch"
    assert native.SOURCE.name == "bc6h.cpp" and native.SOURCE.exists()


def _fuzz_blocks(rng, mode_bits, nbits, n=128):
    blocks = rng.integers(0, 256, size=(n, 16), dtype=np.uint8).copy()
    mask = np.uint8((1 << nbits) - 1)
    blocks[:, 0] = ((blocks[:, 0] & np.uint8(0xFF ^ mask))
                    | np.uint8(mode_bits))
    return blocks


def _vs_pillow(blocks, is_signed):
    n = blocks.shape[0]
    mine = native.bc6h_decode(blocks, is_signed)
    img = mine.reshape(n, 4, 4, 3).transpose(1, 0, 2, 3).reshape(4, n * 4, 3)
    ref = np.asarray(pil.open(io.BytesIO(_make_dds_2d_bc6h(
        blocks, n * 4, 4, fmt=96 if is_signed else 95)))).astype(np.float32)
    cand = np.clip(np.round(np.clip(img, 0, 1) * 255), 0, 255)
    assert np.abs(cand - ref).max() <= 1


@pytest.mark.parametrize("mode_bits,nbits", [
    (0b00, 2), (0b01, 2), (0x02, 5), (0x06, 5), (0x0A, 5), (0x0E, 5),
    (0x12, 5), (0x16, 5), (0x1A, 5), (0x1E, 5), (0x03, 5), (0x07, 5),
    (0x0B, 5), (0x0F, 5)])
def test_bc6h_fuzz_vs_pillow(mode_bits, nbits, rng):
    """tests/test_dds.py:26-43: random blocks per mode against Pillow's
    independent BC6H decoder."""
    _vs_pillow(_fuzz_blocks(rng, mode_bits, nbits), False)


@pytest.mark.parametrize("mode_bits,nbits", [(0x1E, 5), (0x03, 5)])
def test_bc6h_signed_fuzz_vs_pillow(mode_bits, nbits, rng):
    """tests/test_dds.py:46-68: the signed non-transformed modes."""
    _vs_pillow(_fuzz_blocks(rng, mode_bits, nbits), True)


@pytest.mark.parametrize("w,d", [(-200, 100), (300, -50), (-800, -100),
                                 (1000, 200), (0, -256), (-1023, 255)])
def test_bc6h_signed_spec_vectors(w, d):
    """tests/test_dds.py:95-116: the transformed signed path (mode 12)."""
    bits = []

    def put(v, n):
        for i in range(n):
            bits.append((v >> i) & 1)

    put(0x07, 5)
    for _ in range(3):
        put(w & 0x3FF, 10)
    for _ in range(3):
        put(d & 0x1FF, 9)
        put((w >> 10) & 1, 1)
    put(0, 3)
    for _ in range(15):
        put(0xF, 4)
    e1 = (w + d) & 0x7FF
    e1 = e1 - 0x800 if e1 & 0x400 else e1
    out = native.bc6h_decode(_bits_to_block(bits)[None], True
                             ).reshape(4, 4, 3)
    np.testing.assert_allclose(out[0, 0], _spec_signed_half(w, 11), rtol=0)
    np.testing.assert_allclose(out[0, 1], _spec_signed_half(e1, 11), rtol=0)


def _cube_dds(path, mips):
    """A DX10 R32G32B32A32_FLOAT cube map with the given (6, S, S, 3)
    mips."""
    s = mips[0].shape[1]
    pf = struct.pack("<2I4s5I", 32, 0x4, b"DX10", 0, 0, 0, 0, 0)
    caps = struct.pack("<5I", 0x1000, 0x200, 0, 0, 0)
    header = (b"DDS " + struct.pack("<7I", 124, 0x1007, s, s, 0, 1,
                                    len(mips)) + b"\x00" * 44 + pf + caps)
    dx10 = struct.pack("<5I", 2, 3, 0x4, 1, 0)
    body = b"".join(np.concatenate([mips[m][f], np.ones_like(
        mips[m][f][..., :1])], -1).astype(np.float32).tobytes()
        for f in range(6) for m in range(len(mips)))
    with open(path, "wb") as fh:
        fh.write(header + dx10 + body)


def test_dds_cubemap_matches_reference(tmp_path, rng):
    """A float cube map with its mip chain: the port's reader gives the
    reference's mips, and its EnvMap the reference's packed tables."""
    mips = [rng.random((6, s, s, 3)).astype(np.float32) * 4
            for s in (8, 4, 2, 1)]
    path = str(tmp_path / "cube.dds")
    _cube_dds(path, mips)
    got, want = dds.load_dds_cubemap(path), j_dds.load_dds_cubemap(path)
    assert len(got) == len(want) == 4
    for a, b, m in zip(got, want, mips):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, m)
    env, j_env = dds.load_cubemap_env(path), j_dds.load_cubemap_env(path)
    assert env.num_mips == j_env.num_mips == 4
    assert env.sizes_host == (8, 4, 2, 1)
    for field in ("data", "offsets", "sizes", "quad", "tri"):
        np.testing.assert_array_equal(getattr(env, field).numpy(),
                                      np.asarray(getattr(j_env, field)))
    d = torch.tensor([[0.0, 1.0, 0.0], [1.0, 0.0, 0.0], [0.0, -1.0, 0.3]])
    out = sample_env(env, d, 0.0)
    assert torch.isfinite(out).all() and out.shape == (3, 3)


def test_load_rnl_probe(env_dds_path):
    mips = dds.load_dds_cubemap(env_dds_path)
    assert len(mips) == 9 and mips[0].shape == (6, 256, 256, 3)
    assert np.isfinite(mips[0]).all() and mips[0].max() > 2.0


def test_ssim_matches_reference(rng):
    a = rng.random((37, 53, 3))
    b = np.clip(a + rng.normal(0, 0.05, a.shape), 0, 1)
    for radius in (2, 5):
        assert ssim.ssim(a, b, radius) == j_ssim.ssim(a, b, radius)
    assert ssim.ssim(a, a) == pytest.approx(1.0)
    np.testing.assert_array_equal(ssim.luma(a), j_ssim.luma(a))
    np.testing.assert_array_equal(ssim.downsample(a, 4),
                                  j_ssim.downsample(a, 4))
