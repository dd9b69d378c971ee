"""Finding a piece of the benchmark by its name.

Data files are read under the checkout's root. A code piece
(``perfbench/<kind>/<name>.py``: a model builder, a reference, a driver, a
length distribution, a per-layer metric) is looked for under the root's
``perfbench/`` first and then beside this file, so that a piece that exists
only in another root (a test's temporary directory) is found the same way.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from typing import Optional

PACKAGE = Path(__file__).resolve().parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str, root: Optional[Path] = None):
    """``perfbench/<kind>/<name>.py`` as a module (names may hold dots)."""
    places = ([Path(root) / "perfbench"] if root is not None else []) + [PACKAGE]
    path = next((p / kind / f"{name}.py" for p in places if (p / kind / f"{name}.py").is_file()), None)
    if not NAME.match(name) or path is None:
        raise FileNotFoundError(f"no {kind} named {name!r} under {[str(p / kind) for p in places]}")
    tag = re.sub(r"[^A-Za-z0-9_]", "_", f"{path.parent.parent.parent.name}_{name}")
    spec = importlib.util.spec_from_file_location(f"perfbench_{kind}_{tag}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
