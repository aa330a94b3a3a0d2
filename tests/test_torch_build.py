"""The kernel library's C interface against its Python callers, on the CPU.
The library builds only on the card, so a wrapper left naming an entry that
no source exports, or an entry that no wrapper calls, would otherwise show
only there: each ``nnt_*`` entry a source of ``_build.SOURCES`` exports is
passed to ``_build.c_function`` somewhere in the package, and each name
passed there is exported by one of those sources.
"""
import os
import re

import pytest

from nope_nerf_tpu_torch import _build

_PKG = os.path.dirname(os.path.abspath(_build.__file__))
_ENTRY = re.compile(r'^(?:extern "C" )?int (nnt_\w+)\(', re.M)
_CALL = re.compile(r'\bc_function\(\s*"(nnt_\w+)"')


def _exported(source):
    with open(os.path.join(_build.CSRC_DIR, source)) as f:
        return set(_ENTRY.findall(f.read()))


def _called():
    """Every name the package passes to ``c_function``; each call names its
    entry with a string literal."""
    names = set()
    for root, _, files in os.walk(_PKG):
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(root, name)) as f:
                    text = f.read()
                calls = _CALL.findall(text)
                assert len(calls) == len(re.findall(r"\bc_function\(", text)) \
                    - len(re.findall(r"\bdef c_function\(", text)), name
                names.update(calls)
    return names


@pytest.mark.parametrize("source", _build.SOURCES)
def test_every_kernel_entry_has_a_caller(source):
    exported = _exported(source)
    assert exported, f"{source} exports no nnt_* entry"
    assert not exported - _called(), sorted(exported - _called())


def test_every_kernel_call_names_a_built_entry():
    built = set().union(*(_exported(s) for s in _build.SOURCES))
    called = _called()
    assert called and not called - built, sorted(called - built)
