"""The port's scene files, OBJ import and image codecs against the JAX
package's: files, bytes and scene documents, not rendered frames.

Mirrors tests/test_io.py's `test_scene_json_roundtrip`,
`test_reference_schema_fixture`, `test_obj_import`, `test_hdr_roundtrip`
and `test_png_writer`. Both packages must write the same JSON and the
same sidecar bytes for the same scene, and a file saved by one must load
in the other to an equal document.
"""

import json
import os

import numpy as np

import path_tracer_tpu.core.constants as jconst
import path_tracer_tpu.scene.model as jmodel
import path_tracer_tpu.scene.procedural as jproc
import path_tracer_tpu.scene.objload as jobj
import path_tracer_tpu.scene.serializer as jser
import path_tracer_tpu.utils.image as jimage
import path_tracer_tpu_torch.core.constants as tconst
import path_tracer_tpu_torch.scene.model as tmodel
import path_tracer_tpu_torch.scene.procedural as tproc
import path_tracer_tpu_torch.scene.objload as tobj
import path_tracer_tpu_torch.scene.serializer as tser
import path_tracer_tpu_torch.utils.image as timage
from path_tracer_tpu_torch.scene.compile import compile_scene

FIXTURE = os.path.join(os.path.dirname(__file__), 'fixtures',
                       'reference_scene', 'scene.json')


def roundtrip_scene(m, p, c):
    """tests/test_io.py's scene: the Cornell box plus every material type,
    a radiance texture as the sky and a mesh instance."""
    scene = p.make_cornell_scene()
    pos, nrm, uv, faces = p.torus(8, 4)
    mesh = scene.create_mesh(name='ring', positions=pos, normals=nrm, uvs=uv,
                             faces=faces)
    metal = scene.create_material(c.MATERIAL_TYPE_BASIC_METAL, name='chrome',
                                  base_color=np.asarray([0.9, 0.9, 0.95]),
                                  roughness=0.12)
    scene.create_material(c.MATERIAL_TYPE_BASIC_TRANSLUCENT, name='glass',
                          ior=1.52, abbe_number=41.0)
    scene.create_material(c.MATERIAL_TYPE_OPENPBR, name='coated')
    scene.create_entity(m.ENTITY_TYPE_MESH_INSTANCE, mesh=mesh, material=metal,
                        transform=m.Transform(position=[0, 0, 1.5]))
    sky = scene.create_texture(name='sky', type=c.TEXTURE_TYPE_RADIANCE,
                               pixels=p.gradient_sky_texture(32, 16))
    scene.root.skybox_texture = sky
    scene.root.skybox_brightness = 2.5
    return scene


def saved_files(directory):
    """{file name: bytes} of a directory a scene was saved to."""
    out = {}
    for name in sorted(os.listdir(directory)):
        with open(os.path.join(directory, name), 'rb') as f:
            out[name] = f.read()
    return out


def test_scene_json_roundtrip(tmp_path):
    """The port saves and reloads the scene as tests/test_io.py asks; the
    JAX package saves the same scene to the same files, byte for byte;
    and each package's file loads in the other to the same document."""
    scene = roundtrip_scene(tmodel, tproc, tconst)
    sky = scene.textures[0]
    path = os.path.join(tmp_path, 'port', 'scene.json')
    tser.save_scene(path, scene)
    loaded = tser.load_scene(path)

    assert len(loaded.materials) == len(scene.materials)
    assert len(loaded.meshes) == 1
    assert len(loaded.textures) == 1
    assert loaded.root.skybox_brightness == 2.5
    assert loaded.root.skybox_texture is loaded.textures[0]
    np.testing.assert_allclose(loaded.textures[0].pixels, sky.pixels, rtol=1e-6)
    chrome = [m for m in loaded.materials if m.name == 'chrome'][0]
    assert chrome.type == tconst.MATERIAL_TYPE_BASIC_METAL
    np.testing.assert_allclose(chrome.base_color, [0.9, 0.9, 0.95])
    assert abs(chrome.roughness - 0.12) < 1e-6
    ring = loaded.meshes[0]
    assert ring.positions.shape == (len(scene.meshes[0].positions), 3)
    assert ring.bvh is not None
    cams = [e for e in loaded.walk_entities()
            if e.type == tmodel.ENTITY_TYPE_CAMERA]
    assert len(cams) == 1
    assert abs(cams[0].pinhole.field_of_view_in_degrees - 60.0) < 1e-5
    np.testing.assert_allclose(
        compile_scene(scene, device='cpu').scene_bounds.numpy(),
        compile_scene(loaded, device='cpu').scene_bounds.numpy(), atol=1e-5)

    # The JAX package writes the same files for the same scene.
    jpath = os.path.join(tmp_path, 'jax', 'scene.json')
    jser.save_scene(jpath, roundtrip_scene(jmodel, jproc, jconst))
    port_files = saved_files(os.path.dirname(path))
    assert port_files == saved_files(os.path.dirname(jpath))
    assert sorted(port_files) == ['ring.mesh', 'scene.json', 'sky.texture']

    # Each package's file loads in either package to the same document:
    # saved again (colors now read back as float32), the files agree.
    for origin, src in (('port', path), ('jax', jpath)):
        again = {}
        for name, ser in (('port', tser), ('jax', jser)):
            out = os.path.join(tmp_path, f'{name}_from_{origin}', 'scene.json')
            ser.save_scene(out, ser.load_scene(src))
            again[name] = saved_files(os.path.dirname(out))
        assert again['port'] == again['jax'], origin


def test_reference_schema_fixture(tmp_path):
    """The checked-in file in the reference's own schema (never written by
    either package) loads in the port as in the JAX package, and renders
    a finite, non-black frame on the CPU."""
    scene = tser.load_scene(FIXTURE)
    assert [m.type for m in scene.materials] == [0, 1, 2]
    names = [e.name for e in scene.root.children]
    assert names == ['Plane', 'Metal Sphere', 'Glass Cube', 'Camera']
    cam = scene.root.children[3]
    assert cam.type == tmodel.ENTITY_TYPE_CAMERA
    assert cam.pinhole.field_of_view_in_degrees == 90.0
    assert cam.thin_lens.focal_length_in_mm == 20.0
    glass = scene.materials[2]
    assert glass.ior == 1.5 and glass.abbe_number == 35.0

    docs = {}
    for name, ser, loaded in (('port', tser, scene),
                              ('jax', jser, jser.load_scene(FIXTURE))):
        out = os.path.join(tmp_path, name, 'scene.json')
        ser.save_scene(out, loaded)
        with open(out) as f:
            docs[name] = json.load(f)
    assert docs['port'] == docs['jax']

    from path_tracer_tpu_torch.integrator.resolve import resolve
    from path_tracer_tpu_torch.integrator.wavefront import RenderConfig, render

    packed = compile_scene(scene, device='cpu')
    state = render(packed, RenderConfig(width=64, height=36), spp_rounds=8,
                   seed=0)
    image = resolve(state['accum'], 64, 36, lane=state['lane']).numpy()
    assert np.isfinite(image).all()
    assert image.max() > 0.0


OBJ = '''mtllib tri.mtl
o quad
usemtl red
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
vt 0 0
vt 1 0
vt 1 1
vt 0 1
f 1/1 2/2 3/3 4/4
o tri
usemtl blue
v 0 0 1
v 1 0 1
v 0 1 1.5
vn 0 0 1
f 5//1 6//1 7//1
'''


def test_obj_import(tmp_path):
    """A quad fan-triangulated with generated normals and a triangle with
    its own: the port builds the meshes, materials and prefab the JAX
    package builds, array for array."""
    obj = tmp_path / 'tri.obj'
    obj.write_text(OBJ)
    (tmp_path / 'tri.mtl').write_text(
        'newmtl red\nKd 0.8 0.1 0.1\nnewmtl blue\nKd 0.1 0.1 0.8\n')

    scene = tmodel.Scene()
    prefab = tobj.load_model_as_prefab(scene, str(obj))
    assert len(scene.meshes) == 2
    mesh = scene.meshes[0]
    assert len(mesh.faces) == 2
    assert len(mesh.positions) == 4
    np.testing.assert_allclose(mesh.normals, [[0, 0, 1]] * 4, atol=1e-5)
    assert len(scene.materials) == 2
    np.testing.assert_allclose(scene.materials[0].base_color, [0.8, 0.1, 0.1])
    assert prefab.entity.children[0].material is scene.materials[0]
    instance = scene.instantiate_prefab(prefab)
    assert instance.children[0].mesh.name == mesh.name

    jscene = jmodel.Scene()
    jprefab = jobj.load_model_as_prefab(jscene, str(obj))
    assert [m.name for m in scene.meshes] == [m.name for m in jscene.meshes]
    for tm, jm in zip(scene.meshes, jscene.meshes):
        for attr in ('positions', 'normals', 'uvs', 'faces'):
            np.testing.assert_array_equal(getattr(tm, attr), getattr(jm, attr))
    for tm, jm in zip(scene.materials, jscene.materials):
        assert (tm.name, tm.type) == (jm.name, jm.type)
        np.testing.assert_array_equal(tm.base_color, jm.base_color)
    assert ([c.name for c in prefab.entity.children]
            == [c.name for c in jprefab.entity.children])


def test_hdr_roundtrip(tmp_path):
    """save_hdr writes the JAX package's bytes; load_hdr reads them (and an
    adaptive-RLE file) to the JAX package's pixels."""
    img = tproc.gradient_sky_texture(64, 32)[:, :, :3]
    path = os.path.join(tmp_path, 'sky.hdr')
    timage.save_hdr(path, img)
    back = timage.load_hdr(path)
    assert back.shape == (32, 64, 4)
    np.testing.assert_allclose(back[..., :3], img, rtol=2e-2, atol=1e-4)
    jpath = os.path.join(tmp_path, 'sky_jax.hdr')
    jimage.save_hdr(jpath, img)
    with open(path, 'rb') as a, open(jpath, 'rb') as b:
        assert a.read() == b.read()
    np.testing.assert_array_equal(back, jimage.load_hdr(path))

    # An adaptive-RLE scanline file, as stb_image reads for the reference.
    width, height = 16, 2
    rle = os.path.join(tmp_path, 'rle.hdr')
    rows = b''
    for y in range(height):
        rows += bytes([2, 2, 0, width])
        for c in range(4):
            value = 128 + y if c < 3 else 129
            rows += bytes([128 + width, value])
    with open(rle, 'wb') as f:
        f.write(b'#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n')
        f.write(f'-Y {height} +X {width}\n'.encode() + rows)
    decoded = timage.load_hdr(rle)
    np.testing.assert_array_equal(decoded, jimage.load_hdr(rle))
    np.testing.assert_allclose(decoded[1, :, 0], (129 / 256.0) * 2.0)


def test_png_writer(tmp_path):
    """encode_png gives the JAX package's bytes for RGB and RGBA images;
    Pillow reads the file back to the 8-bit image."""
    rng = np.random.RandomState(0)
    img = rng.rand(16, 24, 3).astype(np.float32)
    path = os.path.join(tmp_path, 'out.png')
    timage.save_png(path, img)
    with open(path, 'rb') as f:
        assert f.read() == jimage.encode_png(img)
    rgba = rng.rand(5, 7, 4).astype(np.float32)
    assert timage.encode_png(rgba) == jimage.encode_png(rgba)
    from PIL import Image
    back = np.asarray(Image.open(path).convert('RGB'), np.float32) / 255.0
    np.testing.assert_allclose(back, img, atol=1 / 255.0 + 1e-3)
