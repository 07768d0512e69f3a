"""The JAX package's test modules, read onto the port.

``ported("test_chaos")`` returns the module ``tests/test_chaos.py`` as it
would read had it been written for the port: its source with every
``karpenter_core_tpu`` rewritten to ``karpenter_core_tpu_torch`` (the rule
``tests/test_torch_layout.py::COPIED`` holds the verbatim copies to) and
every ``tests.<name>`` import read the same way. The module is compiled
from that text; the file on disk is only read. A port test module binds
the reference's test classes, functions and fixtures it wants from the
result, so the reference's own cases run against the port's copies.
"""
from __future__ import annotations

import importlib.abc
import importlib.util
import re
import sys
from pathlib import Path

TESTS = Path(__file__).resolve().parent
PREFIX = "torch_ported"


def rewrite(source: str) -> str:
    source = re.sub(r"\bkarpenter_core_tpu\b", "karpenter_core_tpu_torch",
                    source)
    return re.sub(r"\btests\.(\w+)", PREFIX + r".\1", source)


class _Finder(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    def find_spec(self, fullname, path, target=None):
        if fullname == PREFIX:
            return importlib.util.spec_from_loader(fullname, self,
                                                   is_package=True)
        if fullname.startswith(PREFIX + "."):
            return importlib.util.spec_from_loader(fullname, self)
        return None

    def create_module(self, spec):
        return None

    def exec_module(self, module):
        if module.__name__ == PREFIX:
            module.__path__ = []
            return
        name = module.__name__[len(PREFIX) + 1:]
        path = TESTS / f"{name}.py"
        module.__file__ = str(path)
        code = compile(rewrite(path.read_text()), str(path), "exec")
        exec(code, module.__dict__)


if not any(isinstance(f, _Finder) for f in sys.meta_path):
    sys.meta_path.insert(0, _Finder())


def ported(name: str):
    """``tests/<name>.py`` read onto the port (imported once)."""
    return importlib.import_module(f"{PREFIX}.{name}")
