"""The port's file I/O against the JAX package on the CPU: OpenCV-YAML
settings and stage configs, camera and intrinsics text, TUM poses, PLY,
`.tsdf`, the on-disk dataset reader and exporter, and the native host
library's lookups.

Tolerances: none. Configs equal field by field; the writers (TUM poses,
camera intrinsics, PLY, `.tsdf`) write byte-identical files for the same
seeded arrays; loaders return equal arrays; the native neighbor tables and
lookups equal the numpy route and the JAX package's index for index.
"""

import dataclasses
import glob
import os
import struct

import jax  # noqa: F401  (the JAX package's modules below need it imported first)
import numpy as np
import pytest

from intrinsic3d_tpu import config as jconfig
from intrinsic3d_tpu.camera import Camera as JCamera
from intrinsic3d_tpu.camera import load_intrinsics_matrix as j_load_intrinsics_matrix
from intrinsic3d_tpu.grid.voxel_grid import VoxelGrid as JVoxelGrid
from intrinsic3d_tpu.io import golden_dataset as j_golden
from intrinsic3d_tpu.io.dataset import SensorI3D as JSensorI3D
from intrinsic3d_tpu.io.ply import load_ply as j_load_ply
from intrinsic3d_tpu.io.ply import save_ply as j_save_ply
from intrinsic3d_tpu.io.trajectory import load_poses as j_load_poses
from intrinsic3d_tpu.io.trajectory import save_poses as j_save_poses
from intrinsic3d_tpu.io.tsdf_io import load_tsdf as j_load_tsdf

from intrinsic3d_torch import config, native
from intrinsic3d_torch.camera import Camera, load_intrinsics_matrix
from intrinsic3d_torch.grid.voxel_grid import (
    EG_SDF_OFFSETS,
    NORMAL_OFFSETS,
    RING6_OFFSETS,
    VoxelGrid,
    find_indices,
    full_neighborhood_offsets,
)
from intrinsic3d_torch.io import golden_dataset
from intrinsic3d_torch.io.dataset import SensorI3D
from intrinsic3d_torch.io.ply import load_ply, save_ply
from intrinsic3d_torch.io.trajectory import load_poses, save_poses
from intrinsic3d_torch.io.tsdf_io import load_tsdf, save_tsdf

from torch_support import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAGES = ("SensorConfig", "KeyframesConfig", "FusionConfig", "RefinementConfig")


def _bytes(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


# ---------------------------------------------------------------------------
# Settings and stage configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("stage", STAGES)
def test_config_fields_and_defaults_match_jax(stage):
    """The port's dataclasses have JAX's field names, order and defaults."""
    got = [(f.name, f.default) for f in dataclasses.fields(getattr(config, stage))]
    want = [(f.name, f.default) for f in dataclasses.fields(getattr(jconfig, stage))]
    assert got == want


@pytest.fixture(scope="module")
def golden_ymls(tmp_path_factory):
    """The yml files `export_sphere_dataset` writes for each golden spec
    (written by the JAX package's exporter, configs only: no frames)."""
    out = []
    for name in ("default", "mid_scale", "full_scale"):  # the JAX package's specs
        spec = j_golden.GoldenSceneSpec() if name == "default" else getattr(j_golden.GoldenSceneSpec, name)()
        root = tmp_path_factory.mktemp(f"ymls_{name}")
        j_golden.export_sphere_dataset(str(root), dataclasses.replace(spec, num_frames=0))
        out += sorted(glob.glob(str(root / "*.yml")))
    return out


def _yml_paths(golden_ymls):
    return sorted(glob.glob(os.path.join(REPO, "data", "*.yml"))) + golden_ymls


def test_settings_of_every_yml_match_jax(golden_ymls):
    """Each yml of data/ and of the golden exporter parses to the same
    key/value store, and every stage config's `from_settings` of it equals
    JAX's field by field; `Settings.save` writes the same bytes."""
    paths = _yml_paths(golden_ymls)
    assert len(paths) == 4 + 3 * 4
    for path in paths:
        s, js = config.Settings.load(path), jconfig.Settings.load(path)
        assert s._values == js._values, path
        for stage in STAGES:
            got = dataclasses.asdict(getattr(config, stage).from_settings(s))
            want = dataclasses.asdict(getattr(jconfig, stage).from_settings(js))
            assert got == want, (path, stage)


def test_settings_save_and_accessors_match_jax(tmp_path):
    values = {"a": "1", "flag": "yes", "f": "2.5e-3", "s": "./x/y.txt", "neg": "-3", "empty": ""}
    s, js = config.Settings(values), jconfig.Settings(values)
    s.set("b", True)
    js.set("b", True)
    s.save(str(tmp_path / "port.yml"))
    js.save(str(tmp_path / "jax.yml"))
    assert _bytes(tmp_path / "port.yml") == _bytes(tmp_path / "jax.yml")
    for key in list(values) + ["b", "missing"]:
        assert s.get_str(key, "d") == js.get_str(key, "d")
        assert s.exists(key) == js.exists(key)
    for key in ("a", "neg", "f", "b", "empty", "missing"):
        assert s.get_int(key, 7) == js.get_int(key, 7)
        assert s.get_float(key, 0.5) == js.get_float(key, 0.5)
    for key in ("a", "flag", "b", "neg", "empty", "missing"):
        assert s.get_bool(key, True) == js.get_bool(key, True)
    assert config.resolve_relative("/d/sensor.yml", "./rgbd/") == jconfig.resolve_relative("/d/sensor.yml", "./rgbd/")


# ---------------------------------------------------------------------------
# Writers: byte-identical files
# ---------------------------------------------------------------------------


def _random_poses(rng, n):
    from intrinsic3d_torch.mathutil import pose_vec_to_matrix

    return [pose_vec_to_matrix(np.concatenate([rng.normal(0, 1.0, 3), rng.normal(0, 0.5, 3)])) for _ in range(n)]


def test_save_poses_byte_identical_and_loads_match(tmp_path):
    rng = np.random.default_rng(0)
    poses = _random_poses(rng, 9)
    # rotations that take each branch of the matrix → quaternion conversion
    for axis in range(3):
        R = -np.eye(3)
        R[axis, axis] = 1.0
        T = np.eye(4)
        T[:3, :3] = R
        T[:3, 3] = rng.normal(0, 1, 3)
        poses.append(T)
    ts = [float(i) * 0.5 for i in range(len(poses))]
    save_poses(str(tmp_path / "port.txt"), poses, ts)
    j_save_poses(str(tmp_path / "jax.txt"), poses, ts)
    assert _bytes(tmp_path / "port.txt") == _bytes(tmp_path / "jax.txt")
    got, gts = load_poses(str(tmp_path / "port.txt"))
    want, wts = j_load_poses(str(tmp_path / "port.txt"))
    assert gts == wts == ts
    np.testing.assert_array_equal(np.stack(got), np.stack(want))
    np.testing.assert_allclose(np.stack(got), np.stack(poses), atol=2e-6)


def test_camera_save_byte_identical_and_load_matches(tmp_path):
    dist = np.array([0.08, -0.04, 0.001, 0.1, -0.06], np.float32)
    cam = Camera.create(525.3, 524.9, 319.7, 239.2, 640, 480, dist)
    jcam = JCamera.create(525.3, 524.9, 319.7, 239.2, 640, 480, dist)
    cam.save(str(tmp_path / "port.txt"))
    jcam.save(str(tmp_path / "jax.txt"))
    assert _bytes(tmp_path / "port.txt") == _bytes(tmp_path / "jax.txt")
    # the engine's refined camera holds 0-dim tensors: the same file
    import torch

    tcam = dataclasses.replace(cam, fx=torch.tensor(cam.fx), cy=torch.tensor(cam.cy), dist=torch.as_tensor(dist))
    tcam.save(str(tmp_path / "tensors.txt"))
    assert _bytes(tmp_path / "tensors.txt") == _bytes(tmp_path / "jax.txt")
    got, want = Camera.load(str(tmp_path / "jax.txt")), JCamera.load(str(tmp_path / "jax.txt"))
    np.testing.assert_array_equal(got.matrix(), want.matrix())
    np.testing.assert_array_equal(got.dist, np.asarray(want.dist))
    assert (got.width, got.height) == (want.width, want.height) == (640, 480)


def test_intrinsics_matrix_loader_matches_jax(tmp_path):
    p = tmp_path / "colorIntrinsics.txt"
    p.write_text("525.5 0 319.25 0\n0 524.75 239.5 0\n0 0 1 0\n0 0 0 1\n")
    np.testing.assert_array_equal(load_intrinsics_matrix(str(p)), j_load_intrinsics_matrix(str(p)))


@pytest.mark.parametrize("with_colors", [False, True])
def test_save_ply_byte_identical_and_loads_match(tmp_path, with_colors):
    rng = np.random.default_rng(1)
    verts = rng.normal(0, 0.2, (57, 3)).astype(np.float32)
    faces = rng.integers(0, 57, (91, 3)).astype(np.int32)
    colors = rng.uniform(-20, 280, (57, 3)) if with_colors else None
    save_ply(str(tmp_path / "port.ply"), verts, faces, colors)
    j_save_ply(str(tmp_path / "jax.ply"), verts, faces, colors)
    assert _bytes(tmp_path / "port.ply") == _bytes(tmp_path / "jax.ply")
    got, want = load_ply(str(tmp_path / "port.ply")), j_load_ply(str(tmp_path / "port.ply"))
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        else:
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("first_byte", [0x0A, 0x0D])
def test_load_ply_body_starting_with_a_line_end_byte(tmp_path, first_byte):
    """A binary body whose first byte is 0x0a or 0x0d (here the first
    vertex's x) loads as written: only the header's own line terminator is
    skipped. (The JAX package's reader also drops a leading 0x0a of the
    body, misreading such a file.)"""
    rng = np.random.default_rng(2)
    verts = rng.normal(0, 0.2, (31, 3)).astype(np.float32)
    verts[0, 0] = np.frombuffer(bytes([first_byte, 0x00, 0x80, 0x3F]), "<f4")[0]
    faces = rng.integers(0, 31, (40, 3)).astype(np.int32)
    for colors in (None, rng.uniform(0, 255, (31, 3))):
        save_ply(str(tmp_path / "m.ply"), verts, faces, colors)
        v, f, c = load_ply(str(tmp_path / "m.ply"))
        np.testing.assert_array_equal(v, verts)
        np.testing.assert_array_equal(f, faces)
        if colors is not None:
            np.testing.assert_array_equal(c, np.clip(colors, 0, 255).astype(np.uint8))


def _random_grid(rng, sbr: bool, n=400, cls=VoxelGrid):
    coords = np.unique(rng.integers(-40, 40, (n, 3)), axis=0).astype(np.int32)
    rng.shuffle(coords)
    g = cls.from_coords(0.004, coords, sbr=sbr)
    g.sdf = rng.normal(0, 0.01, g.num_voxels).astype(np.float32)
    g.weight = rng.uniform(0, 20, g.num_voxels).astype(np.float32)
    g.color = rng.uniform(-10, 265, (g.num_voxels, 3)).astype(np.float32)
    g.integration_weight_sample = 7.0
    if sbr:
        g.albedo = rng.uniform(0, 1, g.num_voxels).astype(np.float32)
        g.sdf_refined = rng.normal(0, 0.01, g.num_voxels).astype(np.float32)
    return g


def _as_jax_grid(g: VoxelGrid) -> JVoxelGrid:
    return JVoxelGrid(**{f.name: getattr(g, f.name) for f in dataclasses.fields(VoxelGrid)})


@pytest.mark.parametrize("sbr", [False, True])
def test_voxel_grid_save_byte_identical_and_cross_loads(tmp_path, sbr):
    """`VoxelGrid.save` writes JAX's bytes; a JAX-written `.tsdf` loads in
    the port and a port-written one loads in JAX, to the same grid."""
    g = _random_grid(np.random.default_rng(2), sbr)
    g.save(str(tmp_path / "port.tsdf"))
    _as_jax_grid(g).save(str(tmp_path / "jax.tsdf"))
    assert _bytes(tmp_path / "port.tsdf") == _bytes(tmp_path / "jax.tsdf")
    # cross-loading both ways, against the writer's own reload
    port_of_jax = VoxelGrid.load(str(tmp_path / "jax.tsdf"))
    jax_of_port = JVoxelGrid.load(str(tmp_path / "port.tsdf"))
    names = ["coords", "keys", "sdf", "weight", "color", "voxel_size", "integration_weight_sample", "is_sbr"]
    names += ["albedo", "sdf_refined"] if sbr else []
    for name in names:
        np.testing.assert_array_equal(getattr(port_of_jax, name), getattr(jax_of_port, name), err_msg=name)
    np.testing.assert_array_equal(port_of_jax.color, np.clip(g.color, 0, 255).astype(np.uint8).astype(np.float32))
    np.testing.assert_array_equal(port_of_jax.sdf, g.sdf)
    vol, jvol = load_tsdf(str(tmp_path / "jax.tsdf")), j_load_tsdf(str(tmp_path / "jax.tsdf"))
    for f in dataclasses.fields(vol):
        a, b = getattr(vol, f.name), getattr(jvol, f.name)
        np.testing.assert_array_equal(a, b, err_msg=f.name)
    # the volume writer itself round-trips to the same bytes
    save_tsdf(str(tmp_path / "again.tsdf"), vol)
    assert _bytes(tmp_path / "again.tsdf") == _bytes(tmp_path / "jax.tsdf")


# ---------------------------------------------------------------------------
# .tsdf loader against literal reference records
# ---------------------------------------------------------------------------


def _header(voxel_size, truncation, weight_sample, n):
    # f32 voxel_size, f32 truncation, f32 integration_weight_sample,
    # u64 num_voxels, f32 max_load_factor (sparse_voxel_grid.cpp:487-497)
    return struct.pack("<3f", voxel_size, truncation, weight_sample) + struct.pack("<Qf", n, 0.6)


PLAIN_RECORDS = [
    ((-3, 7, 12), 0.0125, 4.5, (10, 200, 31)),
    ((0, 0, 0), -0.004, 1.0, (255, 0, 128)),
    ((100, -200, 5), 0.02, 0.0, (1, 2, 3)),
]
SBR_RECORDS = [
    ((5, -1, 9), 0.00625, 3.0, (9, 8, 7), 0.6, 0.0061),
    ((-50, 33, 2), -0.0199, 12.0, (100, 101, 102), 0.42, -0.02),
]


def test_tsdf_loader_reads_literal_plain_records(tmp_path):
    # Voxel: f32 sdf, f32 weight, u8 color[3], 1 pad byte → 12-byte struct;
    # record = int32[3] coords + struct = 24 bytes
    payload = b"".join(struct.pack("<3iff3Bx", *c, sdf, w, *col) for c, sdf, w, col in PLAIN_RECORDS)
    assert len(payload) == 24 * len(PLAIN_RECORDS)
    p = tmp_path / "plain.tsdf"
    p.write_bytes(_header(0.004, 0.02, 1.0, len(PLAIN_RECORDS)) + payload)

    vol = load_tsdf(str(p))
    assert not vol.is_sbr and vol.num_voxels == 3
    assert vol.voxel_size == np.float32(0.004) and vol.truncation == np.float32(0.02)
    np.testing.assert_array_equal(vol.coords, [r[0] for r in PLAIN_RECORDS])
    np.testing.assert_array_equal(vol.sdf, np.asarray([r[1] for r in PLAIN_RECORDS], np.float32))
    np.testing.assert_array_equal(vol.weight, np.asarray([r[2] for r in PLAIN_RECORDS], np.float32))
    np.testing.assert_array_equal(vol.color, [r[3] for r in PLAIN_RECORDS])
    # the grid loader re-sorts the records into key order
    g = VoxelGrid.load(str(p))
    assert np.all(np.diff(g.keys) > 0)
    for c, sdf, w, col in PLAIN_RECORDS:
        i = int(g.lookup(np.asarray(c)))
        assert (g.sdf[i], g.weight[i]) == (np.float32(sdf), np.float32(w))
        np.testing.assert_array_equal(g.color[i], col)


def test_tsdf_loader_reads_literal_sbr_records(tmp_path):
    # VoxelSBR (32-byte struct): f64 sdf @0, f32 weight @8, u8 color[3] @12,
    # 1 pad @15, f64 albedo @16, f64 sdf_refined @24; record offsets
    # 12/20/24/28/36, 44 B in all
    payload = b"".join(
        struct.pack("<3idf3Bxdd", *c, sdf, w, *col, alb, sdfr) for c, sdf, w, col, alb, sdfr in SBR_RECORDS
    )
    assert len(payload) == 44 * len(SBR_RECORDS)
    p = tmp_path / "sbr.tsdf"
    p.write_bytes(_header(0.002, 0.01, 2.0, len(SBR_RECORDS)) + payload)

    vol = load_tsdf(str(p))
    assert vol.is_sbr and vol.num_voxels == 2
    np.testing.assert_array_equal(vol.coords, [r[0] for r in SBR_RECORDS])
    np.testing.assert_array_equal(vol.sdf, np.asarray([r[1] for r in SBR_RECORDS], np.float64))
    np.testing.assert_array_equal(vol.weight, np.asarray([r[2] for r in SBR_RECORDS], np.float32))
    np.testing.assert_array_equal(vol.color, [r[3] for r in SBR_RECORDS])
    np.testing.assert_array_equal(vol.albedo, np.asarray([r[4] for r in SBR_RECORDS], np.float64))
    np.testing.assert_array_equal(vol.sdf_refined, np.asarray([r[5] for r in SBR_RECORDS], np.float64))
    g = VoxelGrid.load(str(p))
    assert g.is_sbr and g.integration_weight_sample == 2.0
    i = int(g.lookup(np.asarray(SBR_RECORDS[1][0])))
    assert (g.albedo[i], g.sdf_refined[i]) == (np.float32(0.42), np.float32(-0.02))


def test_tsdf_loader_explicit_sbr_flag(tmp_path):
    c, sdf, w, col, alb, sdfr = (1, 2, 3), 0.005, 1.0, (4, 5, 6), 0.55, 0.004
    p = tmp_path / "one.tsdf"
    p.write_bytes(_header(0.004, 0.02, 1.0, 1) + struct.pack("<3idf3Bxdd", *c, sdf, w, *col, alb, sdfr))
    vol_auto, vol_flag = load_tsdf(str(p)), load_tsdf(str(p), sbr=True)
    assert vol_auto.is_sbr and vol_flag.is_sbr
    assert float(vol_auto.albedo[0]) == float(vol_flag.albedo[0]) == 0.55


# ---------------------------------------------------------------------------
# The on-disk dataset: exporter and reader
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    spec = golden_dataset.GoldenSceneSpec(num_frames=4)
    port_root = tmp_path_factory.mktemp("port_dataset")
    jax_root = tmp_path_factory.mktemp("jax_dataset")
    golden_dataset.export_sphere_dataset(str(port_root), spec)
    j_golden.export_sphere_dataset(str(jax_root), j_golden.GoldenSceneSpec(num_frames=4))
    return str(port_root), str(jax_root)


def test_exporter_writes_the_jax_exporters_files(datasets):
    """Same spec, same bytes: frames (PNG), poses, intrinsics and configs."""
    port_root, jax_root = datasets
    rel = sorted(os.path.relpath(p, jax_root) for p in glob.glob(os.path.join(jax_root, "**", "*"), recursive=True)
                 if os.path.isfile(p))
    assert len(rel) == 4 + 2 + 3 * 4
    assert rel == sorted(os.path.relpath(p, port_root) for p in glob.glob(os.path.join(port_root, "**", "*"),
                                                                       recursive=True) if os.path.isfile(p))
    for r in rel:
        assert _bytes(os.path.join(port_root, r)) == _bytes(os.path.join(jax_root, r)), r


def test_sensor_reads_the_same_arrays_as_jax(datasets):
    port_root, _ = datasets
    cfg_path = os.path.join(port_root, "sensor.yml")
    scfg = config.SensorConfig.from_settings(config.Settings.load(cfg_path))
    jcfg = jconfig.SensorConfig.from_settings(jconfig.Settings.load(cfg_path))
    folder = config.resolve_relative(cfg_path, scfg.dataset)
    s, js = SensorI3D(folder, scfg), JSensorI3D(folder, jcfg)
    assert s.num_frames == js.num_frames == 4
    assert (s.depth_min, s.depth_max) == (js.depth_min, js.depth_max)
    for cam, jcam in ((s.color_cam, js.color_cam), (s.depth_cam, js.depth_cam)):
        np.testing.assert_array_equal(cam.matrix(), jcam.matrix())
        assert (cam.width, cam.height) == (jcam.width, jcam.height) == (160, 120)
        np.testing.assert_array_equal(cam.dist, np.asarray(jcam.dist))
    for i in range(s.num_frames):
        for name in ("depth", "color", "pose"):
            got, want = getattr(s, name)(i), getattr(js, name)(i)
            assert got.dtype == want.dtype, name
            np.testing.assert_array_equal(got, want, err_msg=f"{name}({i})")
    assert np.count_nonzero(s.depth(0)) > 1000
    # max_frames stops the scan early
    two = SensorI3D(folder, dataclasses.replace(scfg, max_frames=2))
    assert two.num_frames == 2


# ---------------------------------------------------------------------------
# Native host library
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def random_grid_pair():
    g = _random_grid(np.random.default_rng(3), sbr=False, n=3000)
    return g, _as_jax_grid(g)


@pytest.mark.parametrize(
    "offsets",
    [RING6_OFFSETS, NORMAL_OFFSETS, EG_SDF_OFFSETS, full_neighborhood_offsets(2)],
    ids=["ring6", "normal4", "eg_sdf10", "cube124"],
)
def test_native_neighbor_table_matches_numpy_and_jax(random_grid_pair, offsets):
    g, jg = random_grid_pair
    want = find_indices(g.keys, g.coords[:, None, :] + offsets[None, :, :])
    assert (want >= 0).any() and (want < 0).any()
    np.testing.assert_array_equal(native.neighbor_table(g.coords, offsets), want)
    np.testing.assert_array_equal(g.neighbor_table(offsets), want)
    np.testing.assert_array_equal(jg.neighbor_table(offsets), want)


def test_native_lookup_matches_numpy_and_jax(random_grid_pair):
    g, jg = random_grid_pair
    q = np.random.default_rng(4).integers(-45, 45, (7, 50, 3))
    want = find_indices(g.keys, q)
    assert want.shape == (7, 50) and (want >= 0).any() and (want < 0).any()
    np.testing.assert_array_equal(g.lookup(q), want)
    np.testing.assert_array_equal(jg.lookup(q), want)
    np.testing.assert_array_equal(native.find_indices(g.coords, q.reshape(-1, 3)), want.reshape(-1))
    np.testing.assert_array_equal(g.exists(g.coords), np.ones(g.num_voxels, bool))


def test_native_library_builds_outside_the_source_tree():
    assert native.LIB.parent.name == "intrinsic3d_torch" and native.LIB.parent.parent.name == "build"
    native.get_lib()
    assert native.LIB.exists()
    assert native.SRC.parent.name == "native"
