"""The A/B tools' build specs (``tools/ab_common.py``) on the CPU: the module
imports without a card or ``nvcc``, and ``name=[source@]flags`` parses to
(name, source, flags)."""

import importlib.util
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location(
    "ab_common", REPO / "tools" / "ab_common.py")
ab_common = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ab_common)


@pytest.mark.parametrize("arg, want", [
    ("new=", ("new", None, [])),
    ("old=path/x.cu@-DNAME=1", ("old", "path/x.cu", ["-DNAME=1"])),
    ("parent=git:HEAD@", ("parent", "git:HEAD", [])),
    ("regs96=-maxrregcount=96 -DA=1", ("regs96", None,
                                       ["-maxrregcount=96", "-DA=1"])),
])
def test_parse_spec(arg, want):
    assert ab_common.parse_spec(arg) == want


@pytest.mark.parametrize("arg", ["new", "path/x.cu@-DNAME=1", "=-DA=1"])
def test_parse_spec_refuses_a_build_without_a_name(arg):
    with pytest.raises(ValueError, match="name=\\[source@\\]flags"):
        ab_common.parse_spec(arg)
