"""Digests of a corpus tree, to hold the trees of the ``make_*`` tools
(``ssp_torch/cli/make_*.py``) against those of the JAX package's scripts:
a PNG by its decoded pixels (:func:`ssp_torch.data.imageio.decode_gray`;
its bytes are the writer's own), an npz by its arrays (numpy stamps the zip
with the time), any other file (JPEG, PPM, homographies, split lists) by its
bytes."""

from __future__ import annotations

import hashlib
from pathlib import Path
from typing import Dict

import numpy as np

from ssp_torch.data.imageio import decode_gray


def file_digest(path) -> str:
    """The SHA-256 of one file as the module docstring says."""
    path = Path(path)
    h = hashlib.sha256()
    if path.suffix == ".png":
        img = decode_gray(path)
        h.update(repr(img.shape).encode())
        h.update(img.tobytes())
    elif path.suffix == ".npz":
        with np.load(path) as z:
            for key in sorted(z.files):
                a = z[key]
                h.update(f"{key} {a.dtype.str} {a.shape}".encode())
                h.update(np.ascontiguousarray(a).tobytes())
    else:
        h.update(path.read_bytes())
    return h.hexdigest()


def tree_digests(root) -> Dict[str, str]:
    """{path relative to ``root``: digest} of every file under it."""
    root = Path(root)
    return {p.relative_to(root).as_posix(): file_digest(p)
            for p in sorted(root.rglob("*")) if p.is_file()}
