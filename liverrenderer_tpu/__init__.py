"""The package's former import name, kept so that existing scripts run.

Importing it, or any module under it, returns the module of the same path
under `liverrenderer`: one module object answers to both names, so classes,
jit caches and registered pytrees are shared.
"""
import importlib
import importlib.abc
import importlib.util
import sys

import liverrenderer as _target

_PREFIX = __name__ + "."


class _AliasFinder(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    """Resolves `<old name>.x.y` to the already-importable `liverrenderer.x.y`."""

    def find_spec(self, fullname, path=None, target=None):
        if fullname.startswith(_PREFIX):
            return importlib.util.spec_from_loader(fullname, self)
        return None

    def create_module(self, spec):
        module = importlib.import_module(
            _target.__name__ + "." + spec.name[len(_PREFIX):])
        spec.loader_state = module.__spec__
        return module

    def exec_module(self, module):
        # the import system stamped the alias spec on the shared module
        module.__spec__ = module.__spec__.loader_state


sys.meta_path.insert(0, _AliasFinder())
sys.modules[__name__] = _target
