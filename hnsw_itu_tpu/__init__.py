"""Former import name of :mod:`hnsw_itu`, kept as an alias.

Every module under this name is the ``hnsw_itu`` module of the same name
(one copy, one set of classes), so existing imports keep working. The
command line is left to the normal import system, which finds
``hnsw_itu/cli.py`` under this name too, so ``python -m <this name>.cli``
runs it. Importing the alias warns.
"""

import importlib
import pkgutil
import sys
import warnings

import hnsw_itu

warnings.warn(f"{__name__} is now hnsw_itu; import hnsw_itu instead",
              FutureWarning, stacklevel=2)

for _info in pkgutil.walk_packages(hnsw_itu.__path__, "hnsw_itu."):
    if _info.name == "hnsw_itu.cli":
        continue
    sys.modules[__name__ + _info.name[len("hnsw_itu"):]] = (
        importlib.import_module(_info.name))
sys.modules[__name__] = hnsw_itu
