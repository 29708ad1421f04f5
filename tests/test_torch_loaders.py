"""The port's OBJ and glTF/GLB loaders (``scene/obj.py``,
``scene/gltf.py``) against the reference's: the reference's loader checks
on the port (``tests/test_loaders.py``), the tables each loaded scene
builds (flat and ``use_instancing``) byte for byte against the reference
loader's, the model files the smoke writes (exact float round trip), and
``cli render`` of an OBJ and a GLB."""

import os

import numpy as np
import pytest
import torch

import chip_smoke
from tests.torch_native import native_pair  # noqa: F401  (fixture)
from tests.test_loaders import MTL_TEXT, OBJ_TEXT, _make_glb, _textured_glb
from unity_webgpu_pathtracer_torch import cli as tcli
from unity_webgpu_pathtracer_torch.models import primitives as tprim
from unity_webgpu_pathtracer_torch.scene.gltf import load_gltf
from unity_webgpu_pathtracer_torch.scene.obj import load_obj, resolve_map_path
from unity_webgpu_pathtracer_torch.scene.scene import scene_to_numpy
from unity_webgpu_pathtracer_torch.utils import image as timage
from unity_webgpu_pathtracer_tpu.scene.gltf import load_gltf as jload_gltf
from unity_webgpu_pathtracer_tpu.scene.obj import load_obj as jload_obj

torch.set_num_threads(2)

FIELDS = ("wide16_nodes", "wide16_top", "attr_shade_c", "attr_shade_o", "materials",
          "texture_data", "lights", "inst_l2w", "inst_w2l", "inst_offsets", "tris",
          "tri_index", "attr_normals", "attr_tangents", "attr_uvs", "attr_material")


@pytest.fixture(autouse=True, scope="module")
def _bvh_cache_elsewhere(tmp_path_factory):
    """Build tables into a temporary cache, not the repository's."""
    mp = pytest.MonkeyPatch()
    mp.setenv("UWPT_BVH_CACHE_DIR", str(tmp_path_factory.mktemp("bvh_cache")))
    yield
    mp.undo()


def _same_tables(tscene, jscene):
    """The port's build of ``tscene`` equals the reference's of
    ``jscene`` on every table the port reads, byte for byte."""
    jsd = jscene._build_instanced_wide16() if jscene.instances else jscene.build("wide16")
    got = scene_to_numpy(tscene.build(device="cpu"))
    for f in FIELDS:
        w, g = np.asarray(getattr(jsd, f)), got[f]
        assert g.shape == w.shape and g.dtype.itemsize == w.dtype.itemsize, f
        assert g.tobytes() == w.tobytes(), f
    assert got["stack_levels"].shape == np.asarray(jsd.stack_levels).shape


def test_obj_loader(tmp_path):
    (tmp_path / "test.obj").write_text(OBJ_TEXT)
    (tmp_path / "test.mtl").write_text(MTL_TEXT)
    scene = load_obj(str(tmp_path / "test.obj"))
    assert len(scene.meshes) == 1
    mesh, _ = scene.meshes[0]
    assert mesh.triangle_count == 2          # quad fan-triangulated
    assert mesh.vertices.shape == (4, 3)
    assert np.allclose(mesh.normals, [0, 0, 1])
    mat = scene.materials[mesh.material_index]
    assert np.allclose(mat.base_color[:3], (0.8, 0.1, 0.1))
    assert abs(mat.ior - 1.45) < 1e-6
    assert scene.build(device="cpu").tris.shape[0] == 2
    _same_tables(scene, jload_obj(str(tmp_path / "test.obj")))


def test_glb_loader(tmp_path):
    path = str(tmp_path / "tri.glb")
    _make_glb(path)
    scene = load_gltf(path)
    assert len(scene.meshes) == 1
    mesh, transform = scene.meshes[0]
    assert mesh.triangle_count == 1
    np.testing.assert_allclose(transform[:3, 3], [1, 2, 3], atol=1e-6)
    mat = scene.materials[mesh.material_index]
    assert np.allclose(mat.base_color, (0.2, 0.4, 0.6, 1.0))
    assert mat.metallic == 0.3 and mat.roughness == 0.7
    assert scene.build(device="cpu").tris.shape[0] == 1
    _same_tables(scene, jload_gltf(path))


def test_glb_instancing_mode(tmp_path):
    path = str(tmp_path / "tri.glb")
    _make_glb(path)
    scene = load_gltf(path, use_instancing=True)
    assert len(scene.instances) == 1
    assert scene.build(device="cpu").inst_l2w.shape[0] == 1
    _same_tables(scene, jload_gltf(path, use_instancing=True))


def _textured_obj(tmp_path, mask: bool):
    """A two-group OBJ (quads, negative indices, backslash and
    case-mismatched map paths) with a PNG map_Kd and, with ``mask``, a
    PNG map_d alpha mask merged into its alpha."""
    tex_dir = tmp_path / "Textures"
    tex_dir.mkdir(exist_ok=True)
    rng = np.random.default_rng(2)
    timage.write_png(str(tex_dir / "kd.png"), rng.integers(0, 256, (8, 12, 3), np.uint8))
    timage.write_png(str(tex_dir / "mask.png"), rng.integers(0, 256, (8, 12, 3), np.uint8))
    (tmp_path / "m.mtl").write_text(
        "newmtl a\nKd 0.5 0.5 0.5\nmap_Kd textures\\kd.png\n"
        + ("map_d textures\\MASK.png\n" if mask else "")
        + "newmtl b\nKd 0.2 0.7 0.3\nd 0.5\nNs 100\n")
    (tmp_path / "m.obj").write_text(
        "mtllib m.mtl\nv 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nv 2 0 1\nv 2 1 1\n"
        "vt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\nvn 0 0 1\n"
        "usemtl a\nf 1/1/1 2/2/1 3/3/1 4/4/1\nusemtl b\nf -4/-3/-1 -2/-2/-1 -1/-1/-1 -3/-4/-1\n")
    return str(tmp_path / "m.obj")


@pytest.mark.parametrize("mask", [False, True])
def test_textured_obj_tables_match_reference(native_pair, tmp_path, mask):  # noqa: F811
    path = _textured_obj(tmp_path, mask)
    scene = load_obj(path)
    assert len(scene.textures) == 1 and len(scene.meshes) == 2
    assert scene.materials[0].alpha_mode == (2 if mask else 0)
    assert scene.materials[1].alpha_mode == 1
    assert resolve_map_path(str(tmp_path), "TEXTURES\\kd.png").endswith("kd.png")
    _same_tables(scene, jload_obj(path))


@pytest.mark.parametrize("instancing", [False, True])
def test_textured_glb_tables_match_reference(native_pair, tmp_path, instancing):  # noqa: F811
    rng = np.random.default_rng(4)
    png = timage.encode_png(rng.integers(0, 256, (16, 8, 4), np.uint8))
    path = _textured_glb(tmp_path, png, "image/png")
    scene = load_gltf(path, use_instancing=instancing)
    assert len(scene.textures) == 1
    _same_tables(scene, jload_gltf(path, use_instancing=instancing))


def test_glb_jpeg_matches_png_texture(tmp_path):
    """The same texture through JPEG (Pillow) and PNG agrees closely."""
    import io

    Image = pytest.importorskip("PIL.Image")
    img = Image.new("RGB", (32, 32), (30, 180, 60))
    jb = io.BytesIO()
    img.save(jb, format="JPEG", quality=98)
    pb = io.BytesIO()
    img.save(pb, format="PNG")
    s_j = load_gltf(_textured_glb(tmp_path, jb.getvalue(), "image/jpeg"))
    s_p = load_gltf(_textured_glb(tmp_path, pb.getvalue(), "image/png"))
    tj = np.asarray(s_j.textures[0], np.float32)
    tp = np.asarray(s_p.textures[0], np.float32)
    assert tj.shape[:2] == tp.shape[:2]
    assert np.abs(tj[..., :3].mean(axis=(0, 1)) - tp[..., :3].mean(axis=(0, 1))).max() < 3.0


def test_jpeg_without_pillow_keeps_the_factors(tmp_path, monkeypatch):
    """Without Pillow a JPEG texture is skipped with a warning and the
    material keeps its factor constants, as in the reference."""
    import builtins
    import io

    Image = pytest.importorskip("PIL.Image")
    jb = io.BytesIO()
    Image.new("RGB", (8, 8), (200, 40, 40)).save(jb, format="JPEG")
    path = _textured_glb(tmp_path, jb.getvalue(), "image/jpeg")
    real_import = builtins.__import__

    def no_pil(name, *a, **k):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("no Pillow")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    with pytest.warns(UserWarning, match="Pillow"):
        scene = load_gltf(path)
    assert scene.textures == [] and scene.materials[0].base_color_texture == -1


def test_glb_jpeg_texture_renders_textured(tmp_path):
    """A JPEG-textured GLB renders with the texture's colour through the
    port's megakernel (the reference's check, on wide16)."""
    import io

    from unity_webgpu_pathtracer_torch.config import RenderConfig
    from unity_webgpu_pathtracer_torch.render.camera import make_camera_params
    from unity_webgpu_pathtracer_torch.render.integrator import render_pass

    Image = pytest.importorskip("PIL.Image")
    jb = io.BytesIO()
    Image.new("RGB", (32, 32), (200, 40, 40)).save(jb, format="JPEG", quality=95)
    scene = load_gltf(_textured_glb(tmp_path, jb.getvalue(), "image/jpeg"))
    assert len(scene.textures) == 1, "JPEG image was not decoded"
    cfg = RenderConfig(width=32, height=32, samples_per_pass=4, max_bounces=1, sky_mode=1,
                       has_environment_texture=False, has_textures=True,
                       integrator="megakernel")
    params = make_camera_params(width=32, height=32, eye=(0.5, 0, 3.5), target=(0.5, 0, 0),
                                fov_y_deg=45.0, device="cpu")
    img = render_pass(scene.build(device="cpu"), cfg, params, 0).numpy().reshape(32, 32, 3) / 4
    center = img[12:20, 12:20].mean(axis=(0, 1))
    assert center[0] > 1.5 * center[1] and center[0] > 1.5 * center[2], center


def _heavy_glb(path):
    """The reference's heavy-asset GLB: sixteen sphere primitives and long
    thin strips (~20k triangles, uint32 indices, degenerate uvs), nested
    nodes."""
    import json
    import struct

    def sphere(n_stacks, n_slices, center, r):
        th = np.pi * np.arange(n_stacks + 1)[:, None] / n_stacks
        ph = 2 * np.pi * np.arange(n_slices)[None, :] / n_slices
        vs = np.stack([center[0] + r * np.sin(th) * np.cos(ph),
                       center[1] + r * np.cos(th) * np.ones_like(ph),
                       center[2] + r * np.sin(th) * np.sin(ph)], -1).reshape(-1, 3)
        a = (np.arange(n_stacks)[:, None] * n_slices + np.arange(n_slices)[None, :]).ravel()
        b = (np.arange(n_stacks)[:, None] * n_slices
             + (np.arange(n_slices)[None, :] + 1) % n_slices).ravel()
        c, d = a + n_slices, b + n_slices
        tris = np.concatenate([np.stack([a, b, c], -1), np.stack([b, d, c], -1)])
        return vs.astype(np.float32), tris.astype(np.uint32)

    prims = [sphere(16, 32, (gx * 1.2 - 1.8, 0.5, gz * 1.2 - 1.8), 0.45)
             for gx in range(4) for gz in range(4)]
    strip_v = np.asarray([[x, 0.0, z] for x in np.linspace(-3, 3, 200) for z in (-3.0, 3.0)],
                         np.float32)
    strip_t = np.asarray([[2 * i, 2 * i + 1, 2 * i + 2] for i in range(198)]
                         + [[2 * i + 1, 2 * i + 3, 2 * i + 2] for i in range(198)], np.uint32)
    prims.append((strip_v, strip_t))
    data, views, accessors, primitives = [], [], [], []

    def acc(arr, type_, comp):
        off = sum(len(b) for b in data)
        data.append(arr.tobytes() + b"\x00" * ((4 - arr.nbytes % 4) % 4))
        views.append({"buffer": 0, "byteOffset": off, "byteLength": arr.nbytes})
        accessors.append({"bufferView": len(views) - 1, "componentType": comp,
                          "count": len(arr), "type": type_})
        return len(accessors) - 1

    for v, t in prims:
        primitives.append({"attributes": {"POSITION": acc(v, "VEC3", 5126),
                                          "TEXCOORD_0": acc(np.zeros((len(v), 2), np.float32),
                                                            "VEC2", 5126)},
                           "indices": acc(t.reshape(-1), "SCALAR", 5125), "material": 0})
    blob = b"".join(data)
    gltf = {"asset": {"version": "2.0"}, "scene": 0, "scenes": [{"nodes": [0]}],
            "nodes": [{"children": [1]}, {"mesh": 0, "translation": [0, 0, 0]}],
            "meshes": [{"primitives": primitives}],
            "materials": [{"pbrMetallicRoughness": {"baseColorFactor": [0.6, 0.6, 0.7, 1],
                                                    "roughnessFactor": 0.6}}],
            "accessors": accessors, "bufferViews": views,
            "buffers": [{"byteLength": len(blob)}]}
    js = json.dumps(gltf).encode()
    js += b" " * ((4 - len(js) % 4) % 4)
    with open(path, "wb") as f:
        f.write(b"glTF" + struct.pack("<II", 2, 28 + len(js) + len(blob))
                + struct.pack("<II", len(js), 0x4E4F534A) + js
                + struct.pack("<II", len(blob), 0x004E4942) + blob)


def test_glb_heavy_asset_end_to_end(tmp_path):
    """The reference's heavy asset through the port's loader: tables equal
    the reference loader's, and the megakernel renders it (finite, the
    scene visible)."""
    from unity_webgpu_pathtracer_torch.config import RenderConfig
    from unity_webgpu_pathtracer_torch.render.camera import make_camera_params
    from unity_webgpu_pathtracer_torch.render.integrator import render_pass

    path = str(tmp_path / "heavy.glb")
    _heavy_glb(path)
    scene = load_gltf(path)
    assert len(scene.meshes) == 17 and scene.flatten().count > 16000
    _same_tables(scene, jload_gltf(path))
    cfg = RenderConfig(width=24, height=24, samples_per_pass=1, max_bounces=2, sky_mode=1,
                       has_environment_texture=False, integrator="megakernel")
    params = make_camera_params(width=24, height=24, eye=(4, 3, 4), target=(0, 0, 0),
                                fov_y_deg=50.0, device="cpu")
    img = render_pass(scene.build(device="cpu"), cfg, params, 0).numpy()
    assert np.isfinite(img).all() and (img.sum(-1) > 0).mean() > 0.5


def _grid_model():
    """A 3x3 grid of small spheres over a ground quad (two meshes with
    transforms), as one indexed world-space mesh."""
    from unity_webgpu_pathtracer_torch.scene.scene import Scene

    scene = Scene()
    sphere = tprim.uv_sphere(radius=0.4, stacks=6, slices=10)
    for i in range(3):
        for j in range(3):
            scene.add_mesh(sphere, tprim.transform_trs(translate=(i - 1.0, 0.4, j - 1.0),
                                                       rotate_y=0.3 * i))
    scene.add_mesh(tprim.quad(size=(5, 5)), tprim.transform_trs(translate=(0, 0, 0)))
    return scene, chip_smoke.model_of(scene)


@pytest.mark.parametrize("fmt", ["obj", "glb"])
def test_model_files_round_trip_exactly(tmp_path, fmt):
    """The smoke's writers: the loaded scene's flattened positions equal
    the written ones bit for bit, and its tables are the reference
    loader's."""
    scene, (pos, idx, nrm, uv) = _grid_model()
    path = str(tmp_path / f"grid.{fmt}")
    write = chip_smoke.write_obj_model if fmt == "obj" else chip_smoke.write_glb_model
    write(path, pos, idx, nrm, uv, chip_smoke.checker_texture(16))
    loaded = load_obj(path) if fmt == "obj" else load_gltf(path)
    assert len(loaded.textures) == 1
    got = loaded.flatten().positions
    assert got.tobytes() == pos[idx].tobytes() == scene.flatten().positions.tobytes()
    _same_tables(loaded, jload_obj(path) if fmt == "obj" else jload_gltf(path))


@pytest.mark.parametrize("fmt,integrator", [("obj", "megakernel"), ("glb", "wavefront"),
                                            ("glb", "fused")])
def test_cli_renders_model_files(tmp_path, capsys, fmt, integrator):
    _scene, (pos, idx, nrm, uv) = _grid_model()
    path = str(tmp_path / f"grid.{fmt}")
    write = chip_smoke.write_obj_model if fmt == "obj" else chip_smoke.write_glb_model
    write(path, pos, idx, nrm, uv, chip_smoke.checker_texture(16))
    out = str(tmp_path / "out.png")
    r = tcli.main(["render", path, "--size", "16", "--spp", "2", "--bounces", "2",
                   "--integrator", integrator, "--device", "cpu", "--out", out])
    assert os.path.exists(out) and capsys.readouterr().out.strip() == out
    img = timage.read_png(out)
    assert img.shape == (16, 16, 3) and img.max() > 0
    assert r.config.integrator == integrator and r.config.has_textures
    np.testing.assert_array_equal(img, r.image())
