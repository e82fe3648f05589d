"""path_tracer_tpu_torch.utils.debug and the CLI's `spectrum` and
`bvhdump` against the JAX package's, on the CPU.

The BVH functions read tables that both packages compile with the same
numpy code, so their statistics and dumps are equal as text. The
spectrum curve and its D65 round trip run through each package's own
float32 arithmetic: equal to 1e-5.
"""

import contextlib
import io
import re

import numpy as np
import pytest

import path_tracer_tpu.__main__ as jmain
import path_tracer_tpu.scene.compile as jcompile
import path_tracer_tpu.scene.procedural as jproc
import path_tracer_tpu.utils.debug as jdebug
import path_tracer_tpu_torch.__main__ as tmain
import path_tracer_tpu_torch.scene.compile as tcompile
import path_tracer_tpu_torch.scene.procedural as tproc
import path_tracer_tpu_torch.utils.debug as tdebug
from path_tracer_tpu_torch.utils.image import load_png

COLORS = [(0.2, 0.5, 0.8), (0.9, 0.1, 0.1), (0.5, 0.5, 0.5)]


@pytest.mark.parametrize('rgb', COLORS)
def test_spectrum_report_matches_jax(rgb):
    want = jdebug.spectrum_report(rgb)
    got = tdebug.spectrum_report(rgb, device='cpu')
    assert got['rgb'] == want['rgb'] and got['beta'] == want['beta']
    np.testing.assert_array_equal(got['lambda_nm'], want['lambda_nm'])
    for key in ('reflectance', 'observed_rgb'):
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-5)
    assert abs(got['roundtrip_error'] - want['roundtrip_error']) < 1e-5
    assert (tdebug.ascii_plot(got['lambda_nm'], got['reflectance'], label='x')
            == jdebug.ascii_plot(want['lambda_nm'], want['reflectance'],
                                 label='x'))


def test_spectrum_png_matches_jax(tmp_path):
    rgb = COLORS[0]
    jdebug.plot_spectrum_png(rgb, tmp_path / 'jax.png')
    tdebug.plot_spectrum_png(rgb, tmp_path / 'port.png', device='cpu')
    got, want = (load_png(str(tmp_path / f'{name}.png'))
                 for name in ('port', 'jax'))
    assert got.shape == (160, 256, 4)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('name', ['make_cornell_scene',
                                  'make_multi_mesh_scene'])
def test_bvh_statistics_and_dump_match_jax(name):
    """Statistics and the whole dump of the traversed BVH (the two-level
    table of a mesh scene; the empty flat table of an analytic one)."""
    jp = jcompile.compile_scene(getattr(jproc, name)())
    tp = tcompile.compile_scene(getattr(tproc, name)(), device='cpu')
    stats = tdebug.bvh_statistics(tp)
    assert stats == jdebug.bvh_statistics(jp)
    if name == 'make_multi_mesh_scene':
        assert stats['triangles'] > 50000 and stats['leaves'] > 1000
    texts = []
    for debug, packed in ((tdebug, tp), (jdebug, jp)):
        out = io.StringIO()
        debug.dump_wide_bvh(packed, file=out)
        texts.append(out.getvalue())
    assert texts[0] == texts[1]
    assert texts[0].startswith('node 0: axis=')


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(argv) == 0
    return out.getvalue()


def test_bvhdump_cli_matches_jax():
    """`bvhdump --demo viking --depth 2` prints what the JAX CLI prints."""
    argv = ['bvhdump', '--demo', 'viking', '--depth', '2']
    got = _run(tmain.main, argv + ['--device', 'cpu'])
    want = _run(jmain.main, argv)
    assert got == want
    assert "'triangles': 41546" in got and 'instance 0 -> mesh root' in got


def test_spectrum_cli_matches_jax(tmp_path):
    """`spectrum R G B --png F`: the plot and the coefficients as the JAX
    CLI prints them; the observed colour and its error to 1e-5."""
    png = tmp_path / 'plot.png'
    argv = ['spectrum', '0.2', '0.5', '0.8', '--png', str(png)]
    got = _run(tmain.main, argv + ['--device', 'cpu']).splitlines()
    want = _run(jmain.main, argv).splitlines()
    assert len(got) == len(want) and got[-1] == f'wrote {png}'
    number = re.compile(r'-?\d+\.\d+(?:e-?\d+)?')
    for a, b in zip(got, want):
        if a.startswith('observed under D65'):
            np.testing.assert_allclose(
                [float(x) for x in number.findall(a)],
                [float(x) for x in number.findall(b)], rtol=0, atol=1e-5)
        else:
            assert a == b
    assert load_png(str(png)).shape == (160, 256, 4)
