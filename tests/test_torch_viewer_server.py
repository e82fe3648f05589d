"""The port's HTTP viewer and editor (viewer/server.py) on the CPU.

Mirrors tests/test_viewer_server.py, tests/test_editor_server.py and
tests/test_editor_errors.py with the port's Session at 64x36 on the CPU,
and holds the port's server to the JAX package's over HTTP: the same
editor requests give the same responses and the same /scene documents,
the edited scenes compile to equal tables, and every bad request gets the
same status and the same error text. The JAX server renders no frame.
"""

import json
import os
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import path_tracer_tpu.scene.compile as jcompile
from path_tracer_tpu.app import Session as JSession
from path_tracer_tpu.scene.procedural import make_default_scene as jdefault
from path_tracer_tpu.viewer.server import ViewerServer as JServer
import path_tracer_tpu_torch.scene.compile as tcompile
from path_tracer_tpu_torch.app import Session
from path_tracer_tpu_torch.scene.procedural import make_default_scene
from path_tracer_tpu_torch.utils.image import save_hdr, save_png
from path_tracer_tpu_torch.viewer.server import ViewerServer

from test_torch_compile import assert_fields_equal, jax_fields, port_fields

W, H = 64, 36


def _base(server):
    return f'http://127.0.0.1:{server.port}'


def _get(base, path):
    return json.loads(urllib.request.urlopen(base + path).read())


def _post_raw(base, path, data):
    req = urllib.request.Request(base + path, data=data, method='POST')
    try:
        resp = urllib.request.urlopen(req)
        return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b'{}')


def _post(base, path, body):
    status, payload = _post_raw(base, path, json.dumps(body).encode())
    if status != 200:
        raise AssertionError((path, status, payload))
    return payload


def _png(base, query='mode=render'):
    return urllib.request.urlopen(base + '/frame.png?' + query).read()


def _serve(session, server_class=ViewerServer):
    server = server_class(session, port=0)
    server.serve_background()
    return server


def test_viewer_server_end_to_end():
    session = Session(make_default_scene(), width=W, height=H, device='cpu')
    server = _serve(session)
    base = _base(server)
    try:
        page = urllib.request.urlopen(base + '/').read().decode()
        assert '<title>path_tracer_tpu_torch</title>' in page
        assert '/frame.png' in page and f'width="{W}"' in page

        png = _png(base)
        assert png[:8] == b'\x89PNG\r\n\x1a\n'
        frame0 = session.frame_index
        assert _png(base, 'mode=render&tonemap=3')[:8] == b'\x89PNG\r\n\x1a\n'
        assert session.frame_index == frame0 + 1  # progressive advance

        # Preview mode does not advance accumulation.
        assert _png(base, 'mode=2')[:8] == b'\x89PNG\r\n\x1a\n'
        assert session.frame_index == frame0 + 1

        status = _get(base, '/status')
        assert status['frame'] == session.frame_index and status['spp'] > 0

        # Camera move restarts accumulation on the next frame.
        pos0 = np.array(session.camera().transform.position, np.float32)
        _post(base, '/move', {'delta': [0, 0, -1]})
        assert not np.allclose(session.camera().transform.position, pos0)

        # Picking the plane at the bottom of the default scene.
        res = _post(base, '/pick', {'x': W // 2, 'y': H - 3})
        assert res['shape'] >= 0 and res['name'] == 'Plane'
        assert res['entity'] >= 0

        status, _ = _post_raw(base, '/entity/explode', b'{}')
        assert status == 404
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(base + '/nothing')
        assert err.value.code == 404
    finally:
        server.shutdown()


def test_editor_end_to_end(tmp_path):
    session = Session(make_default_scene(), width=W, height=H, device='cpu')
    server = _serve(session)
    base = _base(server)
    try:
        doc = _get(base, '/scene')
        assert doc['entities'][0]['type'] == 'root'
        plane = next(e for e in doc['entities'] if e['name'] == 'Plane')
        mat = plane['material']
        assert mat is not None

        # --- material edit changes the next frame -----------------------
        before = _png(base)
        _post(base, '/material/update',
              {'index': mat, 'field': 'base_color',
               'value': [0.9, 0.05, 0.05]})
        assert session.scene.dirty_flags != 0
        after = _png(base)          # triggers recompile + restart
        assert session.scene.dirty_flags == 0
        assert after != before
        got = _get(base, '/scene')['materials'][mat]['params']['base_color']
        np.testing.assert_allclose(got['value'], [0.9, 0.05, 0.05], atol=1e-6)

        # Unknown fields are rejected, not silently dropped.
        status, payload = _post_raw(base, '/material/update', json.dumps(
            {'index': mat, 'field': 'nope', 'value': 1}).encode())
        assert status == 400 and 'nope' in payload['error']

        # --- transform edit through the inspector -----------------------
        eid = plane['id']
        _post(base, '/entity/update',
              {'id': eid, 'transform': {'position': [0.0, 0.0, -0.25]}})
        _png(base)
        plane = next(e for e in _get(base, '/scene')['entities']
                     if e['id'] == eid)
        np.testing.assert_allclose(plane['transform']['position'],
                                   [0, 0, -0.25], atol=1e-6)

        # --- entity create + delete ------------------------------------
        created = _post(base, '/entity/create',
                        {'type': 'sphere', 'name': 'EditSphere'})
        _post(base, '/entity/update',
              {'id': created['id'], 'material': mat,
               'transform': {'position': [0.0, 0.0, 1.0]}})
        _png(base)
        doc = _get(base, '/scene')
        assert any(e['name'] == 'EditSphere' for e in doc['entities'])
        n_before = len(doc['entities'])
        _post(base, '/entity/delete', {'id': created['id']})
        assert len(_get(base, '/scene')['entities']) == n_before - 1

        # --- new material ------------------------------------------------
        res = _post(base, '/material/create', {'type': 'metal'})
        assert _get(base, '/scene')['materials'][res['index']]['type'] \
            == 'BasicMetal'

        # --- save -> open round-trips the edit --------------------------
        path = os.path.join(tmp_path, 'edited', 'scene.json')
        _post(base, '/scene/save', {'path': path})
        _post(base, '/scene/open', {'path': path})
        doc = _get(base, '/scene')
        assert [m for m in doc['materials']
                if np.allclose(m['params'].get('base_color', {}).get(
                    'value', [0, 0, 0]), [0.9, 0.05, 0.05], atol=1e-5)]
        assert _png(base)[:8] == b'\x89PNG\r\n\x1a\n'

        # --- New scene -------------------------------------------------
        _post(base, '/scene/new', {})
        assert _png(base)[:8] == b'\x89PNG\r\n\x1a\n'
    finally:
        server.shutdown()


def test_view_cli_needs_the_card_by_default():
    """`view` runs its Session on the card unless --device cpu: without
    one it raises before it serves anything."""
    from path_tracer_tpu_torch.__main__ import main
    if torch.cuda.is_available():
        pytest.skip('this machine has a CUDA device')
    with pytest.raises((RuntimeError, AssertionError), match='(?i)cuda'):
        main(['view', '--demo', 'cornell', '--port', '0', '--width', '32',
              '--height', '16'])


def _asset_files(tmp_path):
    png_path = os.path.join(tmp_path, 'check.png')
    save_png(png_path, np.tile(np.asarray(
        [[[0.8, 0.2, 0.2, 1.0]]], np.float32), (8, 8, 1)))
    hdr_path = os.path.join(tmp_path, 'sky.hdr')
    save_hdr(hdr_path, np.full((8, 16, 3), 0.5, np.float32))
    obj_path = os.path.join(tmp_path, 'tri.obj')
    with open(obj_path, 'w') as f:
        f.write('v 0 0 0\nv 1 0 0\nv 0 1 0\nvn 0 0 1\nf 1//1 2//1 3//1\n')
    return png_path, hdr_path, obj_path


def test_editor_assets_and_cameras(tmp_path):
    """Texture and prefab import, skybox, material texture, clone and
    delete, prefab instantiation, a second camera's thin-lens parameters
    and the render-camera switch; each edit reaches the next frame."""
    png_path, hdr_path, obj_path = _asset_files(tmp_path)
    session = Session(make_default_scene(), width=W, height=H, device='cpu')
    server = _serve(session)
    base = _base(server)
    try:
        t_png = _post(base, '/texture/import', {'path': png_path})
        t_hdr = _post(base, '/texture/import', {'path': hdr_path})
        assert _get(base, '/scene')['textures'][t_png['index']] == 'check.png'
        assert session.scene.textures[t_hdr['index']].type == 2  # radiance

        _post(base, '/skybox/set', {'index': t_hdr['index']})
        assert session.scene.dirty_flags != 0
        _png(base)
        assert _get(base, '/scene')['skybox'] == t_hdr['index']

        plane = next(e for e in _get(base, '/scene')['entities']
                     if e['name'] == 'Plane')
        mat = plane['material']
        _post(base, '/material/update',
              {'index': mat, 'field': 'base_texture',
               'value': t_png['index']})
        doc = _get(base, '/scene')
        assert doc['materials'][mat]['params']['base_texture']['value'] \
            == t_png['index']
        clone = _post(base, '/material/clone', {'index': mat})
        doc = _get(base, '/scene')
        assert doc['materials'][clone['index']]['name'].endswith('(copy)')
        n = len(doc['materials'])
        _post(base, '/material/delete', {'index': clone['index']})
        assert len(_get(base, '/scene')['materials']) == n - 1

        pf = _post(base, '/prefab/import', {'path': obj_path})
        doc = _get(base, '/scene')
        assert len(doc['prefabs']) == pf['index'] + 1
        n_ent = len(doc['entities'])
        inst = _post(base, '/prefab/instantiate', {'index': pf['index']})
        doc = _get(base, '/scene')
        assert len(doc['entities']) > n_ent
        assert any(e['id'] == inst['id'] for e in doc['entities'])
        _png(base)  # recompiles with the new mesh instance

        cam = _post(base, '/entity/create', {'type': 'camera'})
        _post(base, '/entity/update',
              {'id': cam['id'], 'camera_model': 1,
               'aperture_diameter_in_mm': 4.0, 'focus_distance': 2.5,
               'transform': {'position': [0.0, -3.0, 1.0]}})
        doc = _get(base, '/scene')
        c = next(e for e in doc['entities'] if e['id'] == cam['id'])
        assert c['camera']['model'] == 1
        assert abs(c['camera']['focus_distance'] - 2.5) < 1e-6
        assert doc['render_camera'] != cam['id']
        _post(base, '/entity/update', {'id': cam['id'], 'render_camera': True})
        _png(base)  # recompile picks up the new camera + model
        assert _get(base, '/scene')['render_camera'] == cam['id']
        assert session.config.camera_model == 1
    finally:
        server.shutdown()


def _edits(png_path, hdr_path, obj_path):
    """An editor session's requests: (path, body) in order."""
    return [
        ('/material/update', {'index': 0, 'field': 'base_color',
                              'value': [0.9, 0.05, 0.05]}),
        ('/entity/update', {'id': 1, 'name': 'Moved',
                            'transform': {'position': [0.1, 0.0, -0.25]}}),
        ('/entity/create', {'type': 'sphere', 'name': 'EditSphere'}),
        ('/material/create', {'type': 'metal', 'name': 'Steel'}),
        ('/material/create', {'type': 'translucent'}),
        ('/material/update', {'index': 1, 'field': 'roughness',
                              'value': 0.35}),
        ('/texture/import', {'path': png_path}),
        ('/texture/import', {'path': hdr_path}),
        ('/skybox/set', {'index': 1}),
        ('/material/update', {'index': 0, 'field': 'base_texture',
                              'value': 0}),
        ('/material/clone', {'index': 1}),
        ('/prefab/import', {'path': obj_path}),
        ('/prefab/instantiate', {'index': 0}),
        ('/entity/create', {'type': 'camera'}),
        ('/move', {'delta': [0.0, 0.2, 0.0], 'rotate': [0.0, 0.0, 0.1]}),
        ('/material/delete', {'index': 2}),
    ]


def test_editor_requests_match_jax(tmp_path):
    """The same editor requests to the port's server and to the JAX
    package's, each over its own package's default scene: equal
    responses and /scene documents after every request, and the edited
    scenes compile to equal tables."""
    files = _asset_files(tmp_path)
    servers = [_serve(Session(make_default_scene(), width=W, height=H,
                              device='cpu')),
               _serve(JSession(jdefault(), width=W, height=H), JServer)]
    bases = [_base(s) for s in servers]
    try:
        docs = [_get(b, '/scene') for b in bases]
        assert docs[0] == docs[1]
        for path, body in _edits(*files):
            replies = [_post(b, path, body) for b in bases]
            assert replies[0] == replies[1], path
            docs = [_get(b, '/scene') for b in bases]
            assert docs[0] == docs[1], path
        camera = next(e['id'] for e in docs[0]['entities']
                      if e['name'] == 'New camera')
        for b in bases:
            _post(b, '/entity/update', {'id': camera,
                                        'camera_model': 1,
                                        'focus_distance': 2.5,
                                        'render_camera': True})
        docs = [_get(b, '/scene') for b in bases]
        assert docs[0] == docs[1] and docs[0]['render_camera'] == camera
        assert len(docs[0]['prefabs']) == 1 and docs[0]['skybox'] == 1

        scenes = [s.session.scene for s in servers]
        for scene in scenes:
            scene.compile_generic = False
            scene.dirty_flags = 0xFFFFFFFF
        tp = tcompile.compile_scene(scenes[0], aspect_ratio=W / H,
                                    device='cpu')
        jp = jcompile.compile_scene(scenes[1], aspect_ratio=W / H)
        assert_fields_equal(port_fields(tp), jax_fields(jp))
        assert tp.host_camera_models == jp.host_camera_models
    finally:
        for s in servers:
            s.shutdown()


# -- bad requests: every one a clean 400 from both packages' servers ------

@pytest.fixture(scope='module')
def servers():
    """(port server, JAX server) over their packages' default scenes."""
    pair = (_serve(Session(make_default_scene(), width=W, height=H,
                           device='cpu')),
            _serve(JSession(jdefault(), width=W, height=H), JServer))
    yield pair
    for s in pair:
        s.shutdown()


def _alive(servers):
    """The port's session still serves the scene doc and a rendered
    frame; both servers' documents are still equal."""
    docs = [_get(_base(s), '/scene') for s in servers]
    assert docs[0]['entities'] and docs[0] == docs[1]
    assert _png(_base(servers[0]))[:4] == b'\x89PNG'


BAD_REQUESTS = [
    ('/pick', {}),                                   # missing x/y
    ('/pick', {'x': 'left', 'y': 0}),                # wrong type
    ('/entity/update', {'id': 99999}),               # unknown entity
    ('/entity/update', {'id': 'root'}),              # non-int id
    ('/entity/create', {'type': 'tetrahedron'}),     # unknown type
    ('/entity/create', {'type': 'mesh', 'mesh': 'no-such-mesh'}),
    ('/entity/create', {}),                          # missing type
    ('/entity/delete', {'id': 99999}),
    ('/material/update', {'index': 0, 'field': 'no_such_field',
                          'value': 1}),
    ('/material/update', {'index': 99, 'field': 'base_color',
                          'value': [1, 0, 0]}),      # out of range
    ('/material/update', {'index': -1, 'field': 'base_color',
                          'value': [1, 0, 0]}),      # negative wrap
    ('/material/update', {'index': 0, 'field': 'base_color',
                          'value': 'red'}),          # unparseable value
    ('/material/create', {'type': 'unobtainium'}),
    ('/material/clone', {'index': 42}),
    ('/material/delete', {'index': -2}),
    ('/texture/import', {'path': '/no/such/file.png'}),
    ('/texture/import', {}),                         # missing path
    ('/texture/delete', {'index': 7}),
    ('/skybox/set', {'index': 12}),
    ('/prefab/import', {'path': '/no/such/model.obj'}),
    ('/prefab/instantiate', {'index': 0}),           # no prefabs exist
    ('/mesh/delete', {'index': 0}),                  # no meshes exist
    ('/scene/open', {'path': '/no/such/scene.json'}),
    # save_scene creates missing directories by design; an unwritable
    # path is one whose "directory" is an existing file.
    ('/scene/save', {'path': '/dev/null/x/scene.json'}),
]


@pytest.mark.parametrize('endpoint,body', BAD_REQUESTS,
                         ids=[f'{e}#{i}' for i, (e, _) in
                              enumerate(BAD_REQUESTS)])
def test_bad_request_clean_400(servers, endpoint, body):
    replies = [_post_raw(_base(s), endpoint, json.dumps(body).encode())
               for s in servers]
    status, payload = replies[0]
    assert status == 400, (endpoint, status, payload)
    assert payload.get('error'), (endpoint, payload)
    assert replies[0] == replies[1], replies
    _alive(servers)


@pytest.mark.parametrize('data', [b'{"index": 0, "field": ',
                                  b'[1, 2, 3]'],
                         ids=['malformed', 'not_an_object'])
def test_bad_json_body(servers, data):
    replies = [_post_raw(_base(s), '/entity/update', data) for s in servers]
    assert replies[0][0] == 400 and 'error' in replies[0][1]
    assert replies[0] == replies[1]
    _alive(servers)


def test_unknown_endpoint_404(servers):
    replies = [_post_raw(_base(s), '/entity/explode', b'{"id": 0}')
               for s in servers]
    assert replies[0] == replies[1] == (404, {})
    _alive(servers)


def test_rejected_edit_left_scene_unchanged(servers):
    base = _base(servers[0])
    before = _get(base, '/scene')
    for s in servers:
        _post_raw(_base(s), '/material/update', json.dumps(
            {'index': -1, 'field': 'base_color', 'value': [9, 9, 9]}).encode())
        _post_raw(_base(s), '/entity/delete', b'{"id": 424242}')
    assert _get(base, '/scene') == before
    _alive(servers)


def test_good_edit_still_works_after_failures(servers):
    """After the failure sweep, a legitimate edit still flows through the
    dirty flags into the next frame."""
    session = servers[0].session
    plane = next(e for e in _get(_base(servers[0]), '/scene')['entities']
                 if e['name'] == 'Plane')
    for s in servers:
        _post(_base(s), '/material/update',
              {'index': plane['material'], 'field': 'base_color',
               'value': [0.2, 0.8, 0.2]})
    assert session.scene.dirty_flags != 0
    _alive(servers)
    assert session.scene.dirty_flags == 0
