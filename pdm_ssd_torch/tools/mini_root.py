"""The root directory of a generated mini set: a generator deletes only what
a generator wrote.

Each mini-set tool (`make_mini_kitti`, `make_mini_nuscenes`,
`make_mini_waymo`, `make_mini_sets`) writes MARKER into the root it
generates. Asked to write into a root that exists, it replaces the root only
when it holds MARKER (a set generated before) or when `force` is set; an
empty directory is used as it is; any other directory or file raises, so
that a real dataset at the default root (`data/kitti`, ...) is never
deleted.
"""
from __future__ import annotations

import shutil
from pathlib import Path

MARKER = '.pdm_ssd_torch_mini_set'


def fresh_root(root, force: bool = False) -> Path:
    """Make `root` an empty directory holding MARKER, deleting what is there
    only when it holds MARKER or `force` is set; returns it."""
    root = Path(root)
    if root.is_dir() and not (root / MARKER).exists() and any(root.iterdir()) and not force:
        raise FileExistsError(f'{root} holds files that no mini-set generator wrote (it has no '
                              f'{MARKER}); pass --force to delete it and generate the set there')
    if root.exists() and not root.is_dir() and not force:
        raise FileExistsError(f'{root} is a file; pass --force to replace it with a mini set')
    if root.is_dir():
        shutil.rmtree(root)
    elif root.exists():
        root.unlink()
    root.mkdir(parents=True)
    (root / MARKER).write_text('written by a mini-set generator of pdm_ssd_torch: a later run '
                               'of one deletes this directory\n')
    return root
