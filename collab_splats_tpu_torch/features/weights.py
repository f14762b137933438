"""Weight-file discovery for converted checkpoints (an own copy of the JAX
package's ``features/weights.py``: the same directories, so both packages
find the same files).

Converted ``.npz`` files (scripts/convert_weights.py) are searched in:
1. ``$COLLAB_SPLATS_WEIGHTS`` (colon-separated directories),
2. ``<repo>/weights/`` (the repository root, computed from this file),
3. ``~/.cache/collab_splats_tpu/weights/``.

The extractor registry switches from the offline stand-ins to real
CLIP/DINO features automatically when the matching file is found.
"""

from __future__ import annotations

import os
from typing import List, Optional


def weight_dirs() -> List[str]:
    dirs = []
    env = os.environ.get("COLLAB_SPLATS_WEIGHTS")
    if env:
        dirs += [d for d in env.split(":") if d]
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    dirs.append(os.path.join(repo_root, "weights"))
    dirs.append(os.path.join(
        os.environ.get("XDG_CACHE_HOME", os.path.expanduser("~/.cache")),
        "collab_splats_tpu", "weights",
    ))
    return dirs


def find_weights(filename: str) -> Optional[str]:
    for d in weight_dirs():
        path = os.path.join(d, filename)
        if os.path.isfile(path):
            return path
    return None
