"""Every CUDA source of the port is bound and called, read from the sources.

The extension builds every file under path_tracer_tpu_torch/csrc/ in one
link, so a kernel whose launch function is declared in bindings.cpp but
defined nowhere (or the reverse) fails only when the card links it. This
reads the sources on the CPU: each `.cu` file defines an `extern "C"`
`*_launch` function; bindings.cpp declares it (itself or through a header
it includes), calls it from a binding function, and `m.def`s that
function under a name which a wrapper in ops/ or models/ calls as
`load().<name>(`; and bindings.cpp names no launch that no source
defines.
"""

import os
import re

import pytest

PACKAGE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       'path_tracer_tpu_torch')
CSRC = os.path.join(PACKAGE, 'csrc')
KERNEL_SOURCES = sorted(f for f in os.listdir(CSRC) if f.endswith('.cu'))

LAUNCH = re.compile(r'extern "C" \w+ (\w+_launch)\(([^)]*)\)\s*([;{])')
BINDING = re.compile(r'^(?:int|void) (\w+)\(', re.M)
M_DEF = re.compile(r'm\.def\("(\w+)", &(\w+),')


def _read(*parts):
    with open(os.path.join(*parts)) as f:
        return f.read()


def _launches(text, end):
    """Names of the `extern "C"` launch functions that `text` defines
    (end '{') or declares (end ';')."""
    return {m.group(1) for m in LAUNCH.finditer(text) if m.group(3) == end}


def _bindings():
    """(bindings.cpp's text, the launches it declares itself or through the
    headers of this directory it includes)."""
    text = _read(CSRC, 'bindings.cpp')
    declared = _launches(text, ';')
    for header in re.findall(r'#include "(\w+\.h)"', text):
        declared |= _launches(_read(CSRC, header), ';')
    return text, declared


def _wrapper_calls():
    """Every `load().<name>(` or `ext.<name>(` call in ops/ and models/."""
    calls = set()
    for sub in ('ops', 'models'):
        for name in os.listdir(os.path.join(PACKAGE, sub)):
            if name.endswith('.py'):
                calls |= set(re.findall(r'(?:load\(\)|\bext)\.(\w+)\(',
                                        _read(PACKAGE, sub, name)))
    return calls


@pytest.mark.parametrize('source', KERNEL_SOURCES)
def test_kernel_source_is_bound_and_called(source):
    """The source's launch is declared and called in bindings.cpp, the
    calling binding is `m.def`'d, and a wrapper calls it; no launch
    declared in bindings.cpp lacks a defining source."""
    defined = _launches(_read(CSRC, source), '{')
    assert len(defined) == 1, (source, defined)
    (launch,) = defined
    text, declared = _bindings()
    assert launch in declared, (source, launch)

    calls = [m.start() for m in re.finditer(
        rf'(?<!extern "C" int )(?<!extern "C" void )\b{launch}\(', text)]
    assert len(calls) == 1, (launch, len(calls))
    binding = [m.group(1) for m in BINDING.finditer(text[:calls[0]])][-1]
    names = [name for name, fn in M_DEF.findall(text) if fn == binding]
    assert len(names) == 1, (binding, names)
    assert names[0] in _wrapper_calls(), (source, names[0])

    every_source = set()
    for other in KERNEL_SOURCES:
        every_source |= _launches(_read(CSRC, other), '{')
    assert declared <= every_source, declared - every_source
